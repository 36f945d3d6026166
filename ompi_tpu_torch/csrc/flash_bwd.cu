// flash_bwd.cu: the backward of flash attention for NVIDIA Hopper (sm_90a).
//
// Replaces: ompi_tpu/ops/flash_attention.py `_dq_kernel` and `_dkv_kernel`
// (both reached through `_bwd_call`'s pl.pallas_call), the TPU kernels
// behind the gradient of ring attention. Same contract: each re-scores its
// tiles from the saved q, k, v and lse (the flash recompute trade: O(T)
// residuals, no T x T matrix in device memory), with
//   p  = exp(sm_scale * q.k - lse),   dp = dO.v,   ds = p * (dp - delta),
//   dq = sm_scale * sum_k ds.k,   dk = sm_scale * sum_q ds.q,
//   dv = sum_q p.dO,
// where delta = rowsum(dO * O) - g_lse comes precomputed (it carries the
// lse cotangent). The ring block relation arrives as two ints (keep_full,
// keep_tri). flash_dq's KV loop stops at the forward's dynamic causal
// bound; flash_dkv's Q loop starts at the dynamic lower bound `lo_tri`
// (every Q tile when fully attending, none for the "none" block), so a
// "none" block writes exact zeros without visiting a tile.
//
// What bounds them on this card: at the model's shape (T=1024, D=128,
// causal) flash_dq does 6*D flops per visible (q, k) pair and flash_dkv
// 8*D, against q, k, v, dO (bf16) read and f32 gradients written once:
// 150 to 200 flops a byte, under the H100's ~295 flops/byte ridge, so the
// least time is the bytes' time. Both keep every intermediate (scores,
// probabilities, dS) in registers and stream the other side's tiles
// through shared memory once per tile they own.
//
// Design: one block of 4 warps per (b*h, 64-row tile); each warp owns 16
// rows of the tile it accumulates into, so neither kernel needs atomics
// and a run's result does not depend on scheduling.
// - flash_dq owns a Q tile: Q, dO, lse and delta of its rows stay in
//   registers; K/V tiles of 64 rows stream through shared memory,
//   double-buffered with cp.async. For each 16 KV columns it forms S = Q.K^T
//   and dP = dO.V^T (mma.sync m16n8k16, bf16 in, f32 accumulation), turns
//   them into dS, rounds dS to bf16 and feeds its C fragments straight in
//   as the A fragment of dq += dS.K.
// - flash_dkv owns a KV tile: K and V stay in shared memory and their A
//   fragments are reloaded at each use (with the dk and dv accumulators at
//   D=128 taking 128 registers a thread, holding them too would spill). Q
//   and dO tiles stream through shared memory with their lse and delta
//   (per column here, so staged beside them). It forms the transposed
//   tiles S^T = K.Q^T and dP^T = V.dO^T, 16 Q columns at a time, and feeds
//   P^T and dS^T (bf16) into dv += P^T.dO and dk += dS^T.Q. The causal
//   mask is transposed: key row r is kept for query column c when r <= c.
// As on the TPU, P and dS are rounded to bf16 before their products and
// f32 inputs are rounded to bf16 as they are staged. The heaviest causal
// tiles are scheduled first. No TMA, no wgmma and no warp specialisation
// yet: those are the next steps for speed.

#include "flash_common.cuh"

// shared memory of a block: Q and dO tiles and two (K, V) tile pairs
template <int D>
static constexpr size_t dq_smem() {
  return (size_t)(2 * BQ + 4 * BK) * Row<D>::bytes;
}

// shared memory of a block: K and V tiles, two (Q, dO) tile pairs and two
// (lse, delta) column pairs
template <int D>
static constexpr size_t dkv_smem() {
  return (size_t)(2 * BK + 4 * BQ) * Row<D>::bytes + 4 * BQ * sizeof(float);
}

template <int D, typename T>
__global__ void __launch_bounds__(NTHREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq,
                int H, int Tq, int Tk, long long q_sb, long long q_sh,
                long long q_st, long long k_sb, long long k_sh,
                long long k_st, int keep_full, int keep_tri, float sm_scale) {
  constexpr int DP = Row<D>::DP;
  constexpr int KSTEPS = D / 16;  // depth steps of Q.K^T and dO.V^T
  constexpr int NT_O = D / 8;     // 8-column tiles of dq
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [BQ][DP]
  bf16* sdO = sQ + BQ * DP;                  // [BQ][DP]
  bf16* sKV = sdO + BQ * DP;                 // 2 x (K [BK][DP], V [BK][DP])

  const int qi = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row group of the mma fragments
  const int t = lane & 3;   // thread in the group

  const long long q_off = b * q_sb + h * q_sh + (long long)qi * BQ * q_st;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * k_sb + h * k_sh;

  const int hi = kv_tile_end(qi, Tk / BK, keep_full, keep_tri);

  load_rows<D>(sQ, q + q_off, q_st, BQ, tid);
  load_rows<D>(sdO, dout + q_off, q_st, BQ, tid);
  if (hi > 0) {
    load_rows<D>(sKV, kb, k_st, BK, tid);
    load_rows<D>(sKV + BK * DP, vb, k_st, BK, tid);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[KSTEPS][4], df[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    load_a<DP>(qf[ks], sQ, warp * 16, ks * 16, g, t);
    load_a<DP>(df[ks], sdO, warp * 16, ks * 16, g, t);
  }

  // rows g and g+8 of this warp's 16: lse (log2 domain) and delta
  const int row0 = qi * BQ + warp * 16 + g;
  const float* lrow = lse + (long long)bh * Tq + row0;
  const float* drow = delta + (long long)bh * Tq + row0;
  const float lse2[2] = {lrow[0] * LOG2E, lrow[8] * LOG2E};
  const float dlt[2] = {drow[0], drow[8]};
  const float scale2 = sm_scale * LOG2E;

  float acc[NT_O][4];
#pragma unroll
  for (int nt = 0; nt < NT_O; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;

  for (int j = 0; j < hi; ++j) {
    bf16* sK = sKV + (j & 1) * 2 * BK * DP;
    const bf16* sV = sK + BK * DP;
    if (j + 1 < hi) {
      bf16* nK = sKV + ((j + 1) & 1) * 2 * BK * DP;
      const long long off = (long long)(j + 1) * BK * k_st;
      load_rows<D>(nK, kb + off, k_st, BK, tid);
      load_rows<D>(nK + BK * DP, vb + off, k_st, BK, tid);
    }
    cp_async_commit();

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // S and dP over KV columns kk*16 .. kk*16+15: two 8-column tiles
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
          uint32_t b0, b1;
          load_bt<DP>(b0, b1, sK, kk * 16 + n * 8, ks * 16, g, t);
          mma_bf16(s[n], qf[ks], b0, b1);
          load_bt<DP>(b0, b1, sV, kk * 16 + n * 8, ks * 16, g, t);
          mma_bf16(dp[n], df[ks], b0, b1);
        }
      }
      // dS, rounded to bf16: the C fragments of the two 8-column tiles are
      // the A fragment of the 16-deep step of dS.K
      uint32_t dsf[4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + (e >> 1) * 8;
          const int col = j * BK + kk * 16 + n * 8 + 2 * t + (e & 1);
          const float p = (keep_full || col <= row)
                              ? exp2f(s[n][e] * scale2 - lse2[e >> 1])
                              : 0.0f;
          ds[e] = p * (dp[n][e] - dlt[e >> 1]);
        }
        dsf[n * 2] = pack_bf16(ds[0], ds[1]);
        dsf[n * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT_O; ++nt) {
        uint32_t b0, b1;
        load_b<DP>(b0, b1, sK, kk * 16, nt * 8, g, t);
        mma_bf16(acc[nt], dsf, b0, b1);
      }
    }

    cp_async_wait_all();
    __syncthreads();  // tile j+1 landed; every warp is done with tile j
  }

  float* o0 = dq + q_off + (long long)(warp * 16 + g) * q_st + 2 * t;
  float* o1 = o0 + 8 * q_st;
#pragma unroll
  for (int nt = 0; nt < NT_O; ++nt) {
    *reinterpret_cast<float2*>(o0 + nt * 8) =
        make_float2(acc[nt][0] * sm_scale, acc[nt][1] * sm_scale);
    *reinterpret_cast<float2*>(o1 + nt * 8) =
        make_float2(acc[nt][2] * sm_scale, acc[nt][3] * sm_scale);
  }
}

// BQ lse values (scaled to the log2 domain) and BQ delta values of Q tile i
static __device__ __forceinline__ void load_cols(float* sL, float* sDl,
                                                 const float* lrow,
                                                 const float* drow, int i,
                                                 int tid) {
  if (tid < BQ) {
    sL[tid] = lrow[i * BQ + tid] * LOG2E;
    sDl[tid] = drow[i * BQ + tid];
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(NTHREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int H, int Tq, int Tk,
                 long long q_sb, long long q_sh, long long q_st,
                 long long k_sb, long long k_sh, long long k_st,
                 int keep_full, int keep_tri, float sm_scale) {
  constexpr int DP = Row<D>::DP;
  constexpr int KSTEPS = D / 16;  // depth steps of K.Q^T and V.dO^T
  constexpr int NT_O = D / 8;     // 8-column tiles of dk and dv
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);  // [BK][DP]
  bf16* sV = sK + BK * DP;                   // [BK][DP]
  bf16* sQD = sV + BK * DP;  // 2 x (Q [BQ][DP], dO [BQ][DP])
  float* sLD = reinterpret_cast<float*>(sQD + 4 * BQ * DP);  // 2 x (lse, delta)

  const int ki = blockIdx.x;  // the lowest KV tiles see the most Q tiles
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const long long k_off = b * k_sb + h * k_sh + (long long)ki * BK * k_st;
  const long long q_off = b * q_sb + h * q_sh;
  const float* lrow = lse + (long long)bh * Tq;
  const float* drow = delta + (long long)bh * Tq;

  // `lo_tri` of the TPU kernel: Q tiles wholly above the diagonal give
  // this KV tile nothing; the "none" block visits no Q tile
  const int n_q = Tq / BQ;
  const int lo = keep_full ? 0 : (keep_tri ? (ki * BK) / BQ : n_q);

  load_rows<D>(sK, k + k_off, k_st, BK, tid);
  load_rows<D>(sV, v + k_off, k_st, BK, tid);
  if (lo < n_q) {
    const long long off = q_off + (long long)lo * BQ * q_st;
    load_rows<D>(sQD, q + off, q_st, BQ, tid);
    load_rows<D>(sQD + BQ * DP, dout + off, q_st, BQ, tid);
    load_cols(sLD, sLD + BQ, lrow, drow, lo, tid);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  float dka[NT_O][4], dva[NT_O][4];
#pragma unroll
  for (int nt = 0; nt < NT_O; ++nt) {
    dka[nt][0] = dka[nt][1] = dka[nt][2] = dka[nt][3] = 0.0f;
    dva[nt][0] = dva[nt][1] = dva[nt][2] = dva[nt][3] = 0.0f;
  }
  const float scale2 = sm_scale * LOG2E;
  const int row0 = ki * BK + warp * 16 + g;  // key rows g and g+8

  for (int i = lo; i < n_q; ++i) {
    const int buf = (i - lo) & 1;
    const bf16* sQ = sQD + buf * 2 * BQ * DP;
    const bf16* sdO = sQ + BQ * DP;
    const float* sL = sLD + buf * 2 * BQ;
    const float* sDl = sL + BQ;
    if (i + 1 < n_q) {
      bf16* nQ = sQD + (buf ^ 1) * 2 * BQ * DP;
      float* nL = sLD + (buf ^ 1) * 2 * BQ;
      const long long off = q_off + (long long)(i + 1) * BQ * q_st;
      load_rows<D>(nQ, q + off, q_st, BQ, tid);
      load_rows<D>(nQ + BQ * DP, dout + off, q_st, BQ, tid);
      load_cols(nL, nL + BQ, lrow, drow, i + 1, tid);
    }
    cp_async_commit();

#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      // S^T and dP^T over Q columns kk*16 .. kk*16+15: two 8-column tiles
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.0f;
      }
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t a[4], b0, b1;
        load_a<DP>(a, sK, warp * 16, ks * 16, g, t);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          load_bt<DP>(b0, b1, sQ, kk * 16 + n * 8, ks * 16, g, t);
          mma_bf16(s[n], a, b0, b1);
        }
        load_a<DP>(a, sV, warp * 16, ks * 16, g, t);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          load_bt<DP>(b0, b1, sdO, kk * 16 + n * 8, ks * 16, g, t);
          mma_bf16(dp[n], a, b0, b1);
        }
      }
      // P^T and dS^T, rounded to bf16, as A fragments of one 16-deep step
      uint32_t pf[4], dsf[4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + (e >> 1) * 8;
          const int c = kk * 16 + n * 8 + 2 * t + (e & 1);
          p[e] = (keep_full || row <= i * BQ + c)
                     ? exp2f(s[n][e] * scale2 - sL[c])
                     : 0.0f;
          ds[e] = p[e] * (dp[n][e] - sDl[c]);
        }
        pf[n * 2] = pack_bf16(p[0], p[1]);
        pf[n * 2 + 1] = pack_bf16(p[2], p[3]);
        dsf[n * 2] = pack_bf16(ds[0], ds[1]);
        dsf[n * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT_O; ++nt) {
        uint32_t b0, b1;
        load_b<DP>(b0, b1, sdO, kk * 16, nt * 8, g, t);
        mma_bf16(dva[nt], pf, b0, b1);
        load_b<DP>(b0, b1, sQ, kk * 16, nt * 8, g, t);
        mma_bf16(dka[nt], dsf, b0, b1);
      }
    }

    cp_async_wait_all();
    __syncthreads();  // tile i+1 landed; every warp is done with tile i
  }

  const long long r_off = k_off + (long long)(warp * 16 + g) * k_st + 2 * t;
  float* k0 = dk + r_off;
  float* v0 = dv + r_off;
#pragma unroll
  for (int nt = 0; nt < NT_O; ++nt) {
    *reinterpret_cast<float2*>(k0 + nt * 8) =
        make_float2(dka[nt][0] * sm_scale, dka[nt][1] * sm_scale);
    *reinterpret_cast<float2*>(k0 + 8 * k_st + nt * 8) =
        make_float2(dka[nt][2] * sm_scale, dka[nt][3] * sm_scale);
    *reinterpret_cast<float2*>(v0 + nt * 8) =
        make_float2(dva[nt][0], dva[nt][1]);
    *reinterpret_cast<float2*>(v0 + 8 * k_st + nt * 8) =
        make_float2(dva[nt][2], dva[nt][3]);
  }
}

// the arguments both kernels take, as the C interface passes them
struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *delta;
  int B, H, Tq, Tk, layout_bthd, keep_full, keep_tri;
  float sm_scale;
  cudaStream_t stream;
};

template <int D, typename T>
static int launch_dq(const BwdArgs& a, void* dq) {
  const Strides qs(a.H, a.Tq, D, a.layout_bthd), ks(a.H, a.Tk, D,
                                                     a.layout_bthd);
  const size_t smem = dq_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.Tq / BQ, a.B * a.H);
  flash_dq_kernel<D, T><<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dq), a.H, a.Tq, a.Tk, qs.sb, qs.sh, qs.st, ks.sb,
      ks.sh, ks.st, a.keep_full, a.keep_tri, a.sm_scale);
  return (int)cudaGetLastError();
}

template <int D, typename T>
static int launch_dkv(const BwdArgs& a, void* dk, void* dv) {
  const Strides qs(a.H, a.Tq, D, a.layout_bthd), ks(a.H, a.Tk, D,
                                                     a.layout_bthd);
  const size_t smem = dkv_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.Tk / BK, a.B * a.H);
  flash_dkv_kernel<D, T><<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dk), static_cast<float*>(dv), a.H, a.Tq, a.Tk,
      qs.sb, qs.sh, qs.st, ks.sb, ks.sh, ks.st, a.keep_full, a.keep_tri,
      a.sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_dq(const BwdArgs& a, int D, void* dq) {
  FLASH_DISPATCH_D(D, launch_dq<DD, T>(a, dq))
}

template <typename T>
static int dispatch_dkv(const BwdArgs& a, int D, void* dk, void* dv) {
  FLASH_DISPATCH_D(D, launch_dkv<DD, T>(a, dk, dv))
}

// q [B,Tq,H,D] or [B,H,Tq,D], k/v the same with Tk, all of one dtype
// (in_bf16: bf16, else f32); dout like q in bf16; lse and delta [B,H,Tq]
// f32; all contiguous and 16-byte aligned. dq (like q), dk and dv (like k)
// are written in f32. Each returns a cudaError_t value (0 on a successful
// launch).
extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int B, int H, int Tq, int Tk, int D,
                        int layout_bthd, int in_bf16, int keep_full,
                        int keep_tri, float sm_scale, void* stream) {
  if (!flash_shape_ok(B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, dout, lse, delta, B, H, Tq, Tk, layout_bthd,
                  keep_full, keep_tri, sm_scale,
                  static_cast<cudaStream_t>(stream)};
  return in_bf16 ? dispatch_dq<bf16>(a, D, dq) : dispatch_dq<float>(a, D, dq);
}

extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse,
                         const void* delta, void* dk, void* dv, int B, int H,
                         int Tq, int Tk, int D, int layout_bthd, int in_bf16,
                         int keep_full, int keep_tri, float sm_scale,
                         void* stream) {
  if (!flash_shape_ok(B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, dout, lse, delta, B, H, Tq, Tk, layout_bthd,
                  keep_full, keep_tri, sm_scale,
                  static_cast<cudaStream_t>(stream)};
  return in_bf16 ? dispatch_dkv<bf16>(a, D, dk, dv)
                 : dispatch_dkv<float>(a, D, dk, dv);
}
