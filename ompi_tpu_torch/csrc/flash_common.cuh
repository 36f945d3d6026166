// flash_common.cuh: what the flash attention kernels (flash_fwd.cu,
// flash_bwd.cu) share besides the Hopper machinery of hopper.cuh:
// constants, bf16 packing, the causal loop bound, the head dim dispatch and
// the shape gate.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

static constexpr int SEQ_MULTIPLE = 64;  // both sequence lengths divide by it
static constexpr float NEG_BIG = -1e30f;
static constexpr float LOG2E = 1.4426950408889634f;
static constexpr float LN2 = 0.6931471805599453f;

static __device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// `_tile_bounds` of the TPU kernels: the KV tiles a Q tile visits -- every
// one when fully attending, those up to the diagonal for the causal
// triangle, none otherwise
template <int TQ, int TK>
static __device__ __forceinline__ int kv_tile_end(int qi, int n_kv,
                                                  int keep_full,
                                                  int keep_tri) {
  const int tri_hi = (qi * TQ + TQ + TK - 1) / TK;
  return keep_full ? n_kv : (keep_tri ? min(tri_hi, n_kv) : 0);
}

// dispatch a template on the head dim (a multiple of 16, at most 128):
// the call, which names the head dim DD, is the variadic argument
#define FLASH_DISPATCH_D(D, ...) \
  switch (D) {                    \
    case 16: {                     \
      constexpr int DD = 16;        \
      return __VA_ARGS__;          \
    }                              \
    case 32: {                     \
      constexpr int DD = 32;        \
      return __VA_ARGS__;          \
    }                              \
    case 48: {                     \
      constexpr int DD = 48;        \
      return __VA_ARGS__;          \
    }                              \
    case 64: {                     \
      constexpr int DD = 64;        \
      return __VA_ARGS__;          \
    }                              \
    case 80: {                     \
      constexpr int DD = 80;        \
      return __VA_ARGS__;          \
    }                              \
    case 96: {                     \
      constexpr int DD = 96;        \
      return __VA_ARGS__;          \
    }                              \
    case 112: {                     \
      constexpr int DD = 112;        \
      return __VA_ARGS__;          \
    }                              \
    case 128: {                     \
      constexpr int DD = 128;        \
      return __VA_ARGS__;          \
    }                              \
  }                               \
  return (int)cudaErrorInvalidValue;

// the shapes every flash kernel takes: SEQ_MULTIPLE divides both sequence
// lengths and the head dim is a multiple of the 16-deep bf16 step, <= 128
static inline bool flash_shape_ok(int B, int H, int Tq, int Tk, int D) {
  return D % 16 == 0 && D >= 16 && D <= 128 && Tq % SEQ_MULTIPLE == 0 &&
         Tk % SEQ_MULTIPLE == 0 && B >= 1 && H >= 1 && Tq >= SEQ_MULTIPLE &&
         Tk >= SEQ_MULTIPLE;
}
