// flash_fwd.cu: forward flash attention for NVIDIA Hopper (sm_90a).
//
// Replaces: ompi_tpu/ops/flash_attention.py `_fwd_kernel` (reached through
// `_fwd_call`'s pl.pallas_call), the TPU kernel behind ring attention.
// Same contract: one Q-shard x KV-shard block pair of attention with an
// online softmax; normalized out (f32, in the input layout) and
// lse [B*H, Tq] (f32, -1e30 on rows that see no key); the ring block
// relation arrives as two ints (keep_full, keep_tri) in place of the TPU's
// SMEM scalars, and the KV-tile loop stops at the dynamic causal bound of
// `_tile_bounds`, so a "none" block visits no tile at all.
//
// What bounds it on this card: at the model's shape (T=1024, D=128, causal)
// the work is 2*BH*T^2*D flops against (3 bf16 inputs + 1 f32 output) bytes,
// about 200 flops a byte -- under the H100's ~295 flops/byte ridge, so the
// least time is the bytes' time. The kernel keeps every intermediate (scores,
// probabilities, the output accumulator) in registers, so it reads each
// input tile from device memory once per Q tile and writes out once.
//
// Design: one block of 4 warps per (b*h, 64-row Q tile); each warp owns 16
// Q rows and keeps its Q fragments in registers for the whole KV loop.
// K/V tiles of 64 rows are staged to shared memory as bf16, double-buffered
// (cp.async brings tile j+1 while tile j is computed; f32 inputs are
// rounded to bf16 on the way in, as the TPU kernel does before its MXU
// dots). S = Q.K^T and O += P.V are mma.sync m16n8k16 bf16 products with f32
// accumulation; the score fragments turn straight into the A operand of
// P.V, so P never leaves registers. P is rounded to bf16 before P.V, as on
// the TPU. The softmax runs in the log2 domain (exp2f on pre-scaled
// scores). The heaviest causal Q tiles are scheduled first. No TMA, no
// wgmma and no warp specialisation yet: those are the next steps for speed.

#include "flash_common.cuh"

// The fragment loads below stay written out rather than going through
// flash_common.cuh's load_a/load_bt/load_b: that form measured slower on
// the H100 (PERF.md, PR 2).

// shared memory of a block: the Q tile and two (K, V) tile pairs
template <int D>
static constexpr size_t fwd_smem() {
  return (size_t)(BQ + 4 * BK) * Row<D>::bytes;
}

template <int D, typename T>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int H, int Tq, int Tk,
                 long long q_sb, long long q_sh, long long q_st,
                 long long k_sb, long long k_sh, long long k_st,
                 int keep_full, int keep_tri, float sm_scale) {
  constexpr int DP = Row<D>::DP;
  constexpr int KSTEPS = D / 16;  // depth steps of Q.K^T
  constexpr int NT_S = BK / 8;    // 8-column tiles of S
  constexpr int NT_O = D / 8;     // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [BQ][DP]
  bf16* sKV = sQ + BQ * DP;                  // 2 x (K [BK][DP], V [BK][DP])

  const int qi = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row group of the mma fragments
  const int t = lane & 3;   // thread in the group

  const T* qb = q + b * q_sb + h * q_sh + (long long)qi * BQ * q_st;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * k_sb + h * k_sh;

  const int hi = kv_tile_end(qi, Tk / BK, keep_full, keep_tri);

  load_rows<D>(sQ, qb, q_st, BQ, tid);
  if (hi > 0) {
    load_rows<D>(sKV, kb, k_st, BK, tid);
    load_rows<D>(sKV + BK * DP, vb, k_st, BK, tid);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[KSTEPS][4];
  {
    const bf16* q0 = sQ + (warp * 16 + g) * DP + 2 * t;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      qf[ks][0] = ld32(q0 + ks * 16);
      qf[ks][1] = ld32(q0 + ks * 16 + 8 * DP);
      qf[ks][2] = ld32(q0 + ks * 16 + 8);
      qf[ks][3] = ld32(q0 + ks * 16 + 8 * DP + 8);
    }
  }

  float o[NT_O][4];
#pragma unroll
  for (int nt = 0; nt < NT_O; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.0f;
  // rows g and g+8 of this warp's 16: running max (log2 domain) and this
  // thread's share of the denominator
  float m[2] = {NEG_BIG, NEG_BIG};
  float l[2] = {0.0f, 0.0f};
  const float scale2 = sm_scale * LOG2E;
  const int row0 = qi * BQ + warp * 16 + g;

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

    float s[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
      const bf16* kp = sK + (nt * 8 + g) * DP + 2 * t;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        mma_bf16(s[nt], qf[ks], ld32(kp + ks * 16), ld32(kp + ks * 16 + 8));
    }

    float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8;
        const int col = j * BK + nt * 8 + 2 * t + (e & 1);
        float x = s[nt][e] * scale2;
        if (!keep_full && col > row) x = NEG_BIG;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }

    // masked entries hold NEG_BIG and underflow to exactly 0; every row of
    // a visited tile keeps at least one column (aligned 64x64 tiles). The
    // C fragments of S tiles 2kk and 2kk+1 are the A fragment of P's
    // 16-column step kk.
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      const float p0 = exp2f(s[nt][0] - m[0]);
      const float p1 = exp2f(s[nt][1] - m[0]);
      const float p2 = exp2f(s[nt][2] - m[1]);
      const float p3 = exp2f(s[nt][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[nt >> 1][(nt & 1) * 2] = pack_bf16(p0, p1);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const bf16* vp = sV + (kk * 16 + 2 * t) * DP + g;
#pragma unroll
      for (int nt = 0; nt < NT_O; ++nt) {
        const bf16* c = vp + nt * 8;
        mma_bf16(o[nt], pf[kk], pack_bf16(c[0], c[DP]),
                 pack_bf16(c[8 * DP], c[9 * DP]));
      }
    }

    cp_async_wait_all();
    __syncthreads();  // tile j+1 landed; every warp is done with tile j
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float d0 = fmaxf(l[0], 1e-30f);
  const float d1 = fmaxf(l[1], 1e-30f);
  float* o0 = out + b * q_sb + h * q_sh + (long long)row0 * q_st + 2 * t;
  float* o1 = o0 + 8 * q_st;
#pragma unroll
  for (int nt = 0; nt < NT_O; ++nt) {
    *reinterpret_cast<float2*>(o0 + nt * 8) =
        make_float2(o[nt][0] / d0, o[nt][1] / d0);
    *reinterpret_cast<float2*>(o1 + nt * 8) =
        make_float2(o[nt][2] / d1, o[nt][3] / d1);
  }
  if (t == 0) {
    float* lp = lse + (long long)bh * Tq + row0;
    lp[0] = l[0] > 0.0f ? m[0] * LN2 + logf(l[0]) : NEG_BIG;
    lp[8] = l[1] > 0.0f ? m[1] * LN2 + logf(l[1]) : NEG_BIG;
  }
}

template <int D, typename T>
static int launch(const void* q, const void* k, const void* v, void* out,
                  void* lse, int B, int H, int Tq, int Tk, int layout_bthd,
                  int keep_full, int keep_tri, float sm_scale,
                  cudaStream_t stream) {
  // out shares q's layout
  const Strides qs(H, Tq, D, layout_bthd), ks(H, Tk, D, layout_bthd);
  const size_t smem = fwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Tq / BQ, B * H);
  flash_fwd_kernel<D, T><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), H, Tq, Tk, qs.sb, qs.sh, qs.st, ks.sb, ks.sh,
      ks.st, keep_full, keep_tri, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_d(const void* q, const void* k, const void* v, void* out,
                    void* lse, int B, int H, int Tq, int Tk, int D,
                    int layout_bthd, int keep_full, int keep_tri,
                    float sm_scale, cudaStream_t s) {
  FLASH_DISPATCH_D(D, launch<DD, T>(q, k, v, out, lse, B, H, Tq, Tk,
                                    layout_bthd, keep_full, keep_tri,
                                    sm_scale, s))
}

// q [B,Tq,H,D] or [B,H,Tq,D], k/v the same with Tk, all contiguous, 16-byte
// aligned and of one dtype (in_bf16: bf16, else f32); out like q in f32;
// lse [B,H,Tq] f32. Returns a cudaError_t value (0 on a successful launch).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int H, int Tq, int Tk,
                         int D, int layout_bthd, int in_bf16, int keep_full,
                         int keep_tri, float sm_scale, void* stream) {
  if (!flash_shape_ok(B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return launch_d<bf16>(q, k, v, out, lse, B, H, Tq, Tk, D, layout_bthd,
                          keep_full, keep_tri, sm_scale, s);
  return launch_d<float>(q, k, v, out, lse, B, H, Tq, Tk, D, layout_bthd,
                         keep_full, keep_tri, sm_scale, s);
}
