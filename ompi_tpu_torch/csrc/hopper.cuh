// hopper.cuh: the Hopper (sm_90a) machinery of the flash kernels
// (flash_fwd.cu, flash_dq and flash_dkv in flash_bwd.cu): mbarriers, named
// barriers and setmaxnreg for a producer warpgroup and its consumers, TMA
// tile loads, shared-memory matrix descriptors and warpgroup products
// (wgmma), the walk of a persistent block over its work tiles, and the
// host-side encoding of TMA tensor maps.
//
// Tiles are staged by TMA with 128-byte swizzle: a [rows x D] bf16 tile is
// kept as D/64 (rounded up) column chunks of [rows x 64], each row 128
// bytes, each chunk 1024-byte aligned. Columns past D are zero-filled by
// TMA's out-of-bounds fill, as are rows past the end of the sequence, so a
// head dim that is not a whole chunk and a ragged last tile need no code of
// their own in the products.
//
// Accumulator layout of wgmma m64nN (f32): warp w of the warpgroup holds
// rows 16w..16w+15; for 8-column block j, d[4j], d[4j+1] = (g,
// 8j+2t..8j+2t+1) and d[4j+2], d[4j+3] = (g+8, 8j+2t..), with g = lane/4
// and t = lane%4 (rows relative to the warp's first). A register A operand
// (m64k16, bf16 pairs) holds per warp a0 = (g, 2t..2t+1), a1 = (g+8,
// 2t..), a2 = (g, 2t+8..), a3 = (g+8, 2t+8..), so the accumulator blocks
// 2k and 2k+1, rounded to bf16, are the A operand of depth step k.
//
// Every kernel's block is a producer warpgroup, one thread of which
// issues every TMA load, and two consumer warpgroups that run the
// products; setmaxnreg moves registers from the first to the others
// (24 and 240 a thread, from 168 at entry).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------- mbarrier

static __device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte aligned byte of dynamic shared memory (128-byte
// swizzled tiles need 1024-byte aligned chunks; allocate 1024 bytes more)
static __device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// orders this thread's generic-proxy accesses to shared memory with the
// async proxy's: before TMA overwrites what the thread read
static __device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

static __device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
static __device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic to come
static __device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`. A
// wait that outlasts any real load (a lost transaction) traps, so a fault
// ends the kernel with an error instead of hanging the card.
static __device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1u << 26)) __trap();
  }
}

// one arrival of this thread (a consumer releasing a stage)
static __device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// the register budget of the calling warpgroup, moved between warpgroups
// (all four warps execute it): the producer gives registers up, the
// consumers take them. ptxas honours it only where the roles' code paths
// never join again.
template <int N>
static __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
static __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// named barriers (0 is __syncthreads'): `bar_sync` waits until `n` threads
// have arrived, counting the caller's warp; `bar_arrive` only arrives
static __device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

static __device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// -------------------------------------------------------------------- TMA

// one box of a 4-D tensor map into shared memory; completion is counted on
// `bar` in bytes
static __device__ __forceinline__ void tma_load_4d(void* dst,
                                                   const CUtensorMap* map,
                                                   uint64_t* bar, int c0,
                                                   int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the box of a make_tile_map map at column c, row t, head h, batch b
static __device__ __forceinline__ void tma_tile(void* dst,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int bthd,
                                                int c, int t, int h, int b) {
  if (bthd)
    tma_load_4d(dst, map, bar, c, h, t, b);
  else
    tma_load_4d(dst, map, bar, c, t, h, b);
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
static __device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                                 uint32_t bytes,
                                                 uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ------------------------------------------------------------------ wgmma

// descriptor of a bf16 operand in a 128-byte-swizzled chunk, as TMA wrote
// it. K-major (depth contiguous): the start advances 32 bytes per 16-deep
// step inside the 128-byte row, SBO = 1024 bytes between 8-row groups,
// LBO unused. MN-major (rows of the depth dimension, N contiguous): the
// start advances 16 rows (2048 bytes) per step, SBO = 1024 bytes between
// groups of 8 depth rows, LBO = the bytes between 64-column chunks.
static __device__ __forceinline__ uint64_t desc_sw128(const void* p,
                                                      uint32_t lbo) {
  const uint32_t a = smem_addr(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// the descriptor `bytes` further on (a 16-byte multiple inside the same
// shared-memory window: only the start address field moves)
static __device__ __forceinline__ uint64_t desc_at(uint64_t d, int bytes) {
  return d + (uint64_t)(bytes >> 4);
}

// `d` as if computed here: the compiler cannot hoist what derives from it
// out of the loop, so no descriptor of a tile stays live across the loop
static __device__ __forceinline__ uint64_t opaque(uint64_t d) {
  asm volatile("" : "+l"(d));
  return d;
}

// 2^x by the special function unit, flushing denormal results to zero
// (a probability below 2^-126 is 0 in bf16's rounding of P anyway)
static __device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

static __device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

static __device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
static __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pin the accumulator registers at this point of the program, so the
// compiler moves no read or write of them across a wgmma fence or wait
template <int N>
static __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
static __device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define HOPPER_D8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_R16(a, b, c, e, f, g, h, i, j, k, l, m, n, o, p, q)      \
  "%" #a ", %" #b ", %" #c ", %" #e ", %" #f ", %" #g ", %" #h ", %" #i \
  ", %" #j ", %" #k ", %" #l ", %" #m ", %" #n ", %" #o ", %" #p ", %" #q

// d (+)= A . B, m64nNk16, A and B from shared memory, both K-major;
// scale_d = 0 overwrites d
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      HOPPER_R16(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      HOPPER_R16(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15) ", "
      HOPPER_R16(16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
                 31)
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      HOPPER_R16(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15) ", "
      HOPPER_R16(16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
                 31) ", "
      HOPPER_R16(32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46,
                 47) ", "
      HOPPER_R16(48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62,
                 63)
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24),
        HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A . B, m64nNk16, A (bf16 pairs) from registers, B from shared
// memory MN-major (the transpose bit)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N is 64 or 128");
  if constexpr (N == 64) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      HOPPER_R16(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15) ", "
      HOPPER_R16(16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
                 31)
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      HOPPER_R16(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15) ", "
      HOPPER_R16(16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
                 31) ", "
      HOPPER_R16(32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46,
                 47) ", "
      HOPPER_R16(48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62,
                 63)
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24),
        HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
}

#undef HOPPER_D8
#undef HOPPER_R16

// ------------------------------------------------------- persistent blocks

// The work tiles of a persistent launch, numbered 0 .. total-1 in the
// order the kernel wants them done (the heaviest first). Block x takes one
// tile of each round of gridDim.x: position x in even rounds, gridDim.x -
// 1 - x in odd ones (a snake), so heavy and light tiles even out across
// blocks. The producer and the consumers of a block walk the same tiles.
struct Tiles {
  int total;
  // the tile of round r (total or more: none)
  __device__ int at(int r) const {
    const int p = (r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    return r * (int)gridDim.x + p;
  }
  // this block's first round after r with a tile, or -1
  __device__ int next(int r) const {
    for (++r; r * (int)gridDim.x < total; ++r)
      if (at(r) < total) return r;
    return -1;
  }
};

// ------------------------------------------------------------------- host

// devices whose facts below are looked up once; a higher ordinal looks
// them up on every launch
constexpr int CACHED_DEVICES = 64;

// blocks of a persistent launch on the current device `dev`: one per SM,
// at most one per work tile. The SM count is read once for each device.
static inline cudaError_t persistent_blocks(int dev, int tiles, int* blocks) {
  static int sm_count[CACHED_DEVICES];  // 0 until read
  int sms = dev < CACHED_DEVICES ? sm_count[dev] : 0;
  if (!sms) {
    const cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err) return err;
    if (dev < CACHED_DEVICES) sm_count[dev] = sms;
  }
  *blocks = tiles < sms ? tiles : sms;
  return cudaSuccess;
}

// raises Kernel's dynamic shared memory above the default 48 KB on the
// current device `dev`. The attribute belongs to the device, so it is set
// once for each device (two threads that race set it twice, which is
// harmless).
template <auto Kernel>
static cudaError_t configure_smem(int dev, size_t smem) {
  static bool done[CACHED_DEVICES];
  if (dev < CACHED_DEVICES && done[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (!err && dev < CACHED_DEVICES) done[dev] = true;
  return err;
}

// the driver's cuTensorMapEncodeTiled, found through the runtime, so the
// libraries need no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// the tensor map of a bf16 [B, T, H, D] ('bthd') or [B, H, T, D] ('bhtd')
// tensor with boxes of 64 columns (128 bytes a row) and `rows` rows of
// one (b, h). Dimensions go innermost first in order of stride:
// (D, T, H, B) for 'bhtd', (D, H, T, B) for 'bthd' (see tma_tile). Reads
// past D or T are zero-filled.
static inline cudaError_t make_tile_map(CUtensorMap* map, const void* base,
                                        int B, int H, int T, int D,
                                        int layout_bthd, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorSymbolNotFound;
  const cuuint64_t e = sizeof(__nv_bfloat16);
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4];
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  dims[0] = D;
  dims[3] = B;
  box[0] = 64;
  box[3] = 1;
  if (layout_bthd) {
    dims[1] = H, dims[2] = T;
    strides[0] = D * e, strides[1] = (cuuint64_t)H * D * e;
    box[1] = 1, box[2] = rows;
  } else {
    dims[1] = T, dims[2] = H;
    strides[0] = D * e, strides[1] = (cuuint64_t)T * D * e;
    box[1] = rows, box[2] = 1;
  }
  strides[2] = (cuuint64_t)T * H * D * e;
  const CUresult r =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
