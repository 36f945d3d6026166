// flash_common.cuh: what the flash attention kernels (flash_fwd.cu,
// flash_bwd.cu) share: constants, bf16 packing, the loop bound, the head
// dim dispatch and the shape gate; and, for flash_dq, its 64-row tile
// sizes, the shared-memory row stride, the mma.sync m16n8k16 product and
// cp.async row staging (flash_fwd and flash_dkv use hopper.cuh instead).
//
// Fragment layout of mma.sync.m16n8k16 (bf16 in, f32 out), with g = lane/4
// the row group and t = lane%4 the thread in the group:
//   A (16x16, row-major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g,
//     2t+8..), a3 = (g+8, 2t+8..);
//   B (16x8, column-major): b0 = (rows 2t..2t+1, col g), b1 = (rows
//     2t+8..2t+9, col g);
//   C (16x8): c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1).
// So the C fragments of two neighbouring 8-column tiles are exactly the A
// fragment of one 16-deep step: a product's result feeds the next product
// without leaving registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

typedef __nv_bfloat16 bf16;

static constexpr int BQ = 64;  // Q rows of a tile
static constexpr int BK = 64;  // K/V rows of a tile
static constexpr int NTHREADS = (BQ / 16) * 32;  // 4 warps of 16 rows each
static constexpr float NEG_BIG = -1e30f;
static constexpr float LOG2E = 1.4426950408889634f;
static constexpr float LN2 = 0.6931471805599453f;

// shared-memory row stride: 8 bf16 of padding keep the fragment loads of
// the 8 row groups of a warp on distinct banks
template <int D>
struct Row {
  static constexpr int DP = D + 8;
  static constexpr size_t bytes = (size_t)DP * sizeof(bf16);
};

static __device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

static __device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

static __device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a . b for one 16x8x16 tile (A row-major 16x16, B col-major 16x8)
static __device__ __forceinline__ void mma_bf16(float (&d)[4],
                                                const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows r0..r0+15, depth columns c0..c0+15 of a bf16 tile of
// row stride DP in shared memory
template <int DP>
static __device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                              const bf16* tile, int r0,
                                              int c0, int g, int t) {
  const bf16* p = tile + (r0 + g) * DP + c0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * DP);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * DP + 8);
}

// B fragment (b0, b1) of X^T for the product A . X^T: X's rows n0..n0+7
// are B's columns, its columns c0..c0+15 the depth
template <int DP>
static __device__ __forceinline__ void load_bt(uint32_t& b0, uint32_t& b1,
                                               const bf16* tile, int n0,
                                               int c0, int g, int t) {
  const bf16* p = tile + (n0 + g) * DP + c0 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// B fragment (b0, b1) of X for the product A . X: X's rows k0..k0+15 are
// the depth, its columns n0..n0+7 B's columns
template <int DP>
static __device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                              const bf16* tile, int k0,
                                              int n0, int g, int t) {
  const bf16* c = tile + (k0 + 2 * t) * DP + n0 + g;
  b0 = pack_bf16(c[0], c[DP]);
  b1 = pack_bf16(c[8 * DP], c[9 * DP]);
}

static __device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows x D elements at src (row stride st) -> bf16 rows of stride DP at dst,
// 8 elements (16 bytes of bf16) per thread and step; bf16 sources go by
// cp.async, f32 sources are rounded to bf16 on the way (as the TPU kernels
// round their operands before the MXU dots)
template <int D, typename T>
static __device__ __forceinline__ void load_rows(bf16* dst, const T* src,
                                                 long long st, int rows,
                                                 int tid) {
  constexpr int CPR = D / 8;
  for (int i = tid; i < rows * CPR; i += NTHREADS) {
    const int r = i / CPR;
    const int c = (i - r * CPR) * 8;
    bf16* d = dst + r * Row<D>::DP + c;
    const T* s = src + r * st + c;
    if constexpr (std::is_same<T, bf16>::value) {
      cp_async16(d, s);
    } else {
      const float4 a = *reinterpret_cast<const float4*>(s);
      const float4 b = *reinterpret_cast<const float4*>(s + 4);
      uint4 u;
      u.x = pack_bf16(a.x, a.y);
      u.y = pack_bf16(a.z, a.w);
      u.z = pack_bf16(b.x, b.y);
      u.w = pack_bf16(b.z, b.w);
      *reinterpret_cast<uint4*>(d) = u;
    }
  }
}

// element strides of [B, T, H, D] ('bthd') or [B, H, T, D] ('bhtd')
struct Strides {
  long long sb, sh, st;
  Strides(int H, int T, int D, int layout_bthd)
      : sb((long long)H * T * D),
        sh(layout_bthd ? D : (long long)T * D),
        st(layout_bthd ? (long long)H * D : D) {}
};

// `_tile_bounds` of the TPU kernels: the KV tiles a Q tile visits -- every
// one when fully attending, those up to the diagonal for the causal
// triangle, none otherwise
template <int TQ = BQ, int TK = BK>
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

// the shapes every flash kernel takes: 64-row tiles divide both sequence
// lengths and the head dim is a multiple of the 16-deep bf16 step, <= 128
static inline bool flash_shape_ok(int B, int H, int Tq, int Tk, int D) {
  return D % 16 == 0 && D >= 16 && D <= 128 && Tq % BQ == 0 &&
         Tk % BK == 0 && B >= 1 && H >= 1 && Tq >= BQ && Tk >= BK;
}
