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
// Design (hopper.cuh holds the machinery). Each kernel is a persistent
// block per SM that walks over work tiles, each of which it owns whole, so
// neither needs atomics and a run's result does not depend on scheduling.
// A block is a producer warpgroup (setmaxnreg down to 24 registers), one
// thread of which issues every TMA load (128-byte swizzle) into a ring of
// stages with "full" and "empty" mbarriers, and two consumer warpgroups
// (setmaxnreg up to 240) whose gradient accumulators stay in registers
// and go out from there. Each consumer arrives on every stage's empty
// barrier, whether or not the causal mask left it anything to do. f32
// inputs are rounded to bf16 by the wrapper (TMA cannot convert).
// - flash_dq: work tiles (b*h, 128-row Q tile), head by head and in each
//   head the heaviest causal Q tile first, so the blocks at work at one
//   time share the K and V of a few heads in L2. The producer loads Q and
//   dO of each work tile, and its 64-row K and V tiles through a ring of
//   four stages; each consumer owns 64 Q rows, reads their lse and delta
//   (per row) once a work tile, and per K/V tile issues S = Q.K^T and
//   dP = dO.V^T (wgmma m64n64k16, both operands K-major in shared memory),
//   forms dS in registers and rounds it to bf16 as the A operand of
//   dq += dS.K (wgmma m64n{64,128}k16, K through the transpose bit). The
//   scores of tile j go out before the dq product of tile j-1, so dS of
//   tile j is formed while that product runs. The causal mask is applied
//   only on tiles that cross the diagonal.
// - flash_dkv: work tiles (b*h, 128-row KV tile), the lowest KV tiles
//   (which see the most Q tiles) first. The producer loads K and V of each
//   work tile, and its 64-row Q and dO tiles, with their lse and delta
//   (per column here) by bulk copy beside them, through a ring of three
//   stages; each consumer owns 64 key rows. Per Q tile, in two halves of
//   32 columns (so only one half's scores live beside the dK and dV
//   accumulators): the transposed tiles S^T = K.Q^T and dP^T = V.dO^T by
//   wgmma m64n32k16 with both operands in shared memory (K-major), P^T and
//   dS^T in bf16 registers as the A operand of dV += P^T.dO and
//   dK += dS^T.Q (wgmma m64n{64,128}k16, dO and Q through the transpose
//   bit). Each half's scores are issued before the gradient products of
//   the half before it, across Q tiles too. The causal mask is transposed
//   (key row r is kept for query column c when r <= c) and applied only on
//   tiles that cross the diagonal.
// As on the TPU, P and dS are rounded to bf16 before their products.

#include "flash_common.cuh"
#include "hopper.cuh"

using namespace hopper;

namespace dq {

constexpr int QB = 128;         // Q rows of a work tile, 64 per consumer
constexpr int KB = 64;          // K/V rows of a streamed tile
constexpr int NSTAGE = 4;       // K/V ring depth
constexpr int CONSUMERS = 256;  // two consumer warpgroups
constexpr int THREADS = 384;    // and the producer warpgroup

template <int D>
struct Dq {
  static constexpr int NC = (D + 63) / 64;   // 64-column chunks
  static constexpr int CQ = QB * 128;        // bytes of a Q/dO chunk
  static constexpr int CK = KB * 128;        // bytes of a K/V chunk
  static constexpr int STAGE = 2 * NC * CK;  // K then V
  static constexpr int BARS = 2 * NC * CQ + NSTAGE * STAGE;
  // Q/dO's full and empty barriers, then each stage's
  static constexpr size_t smem = BARS + 8 * (2 + 2 * NSTAGE) + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap mq,
                const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv,
                const __grid_constant__ CUtensorMap mdo,
                float* __restrict__ out, const float* __restrict__ lse,
                const float* __restrict__ delta, int BH, int H, int Tq,
                int Tk, int bthd, int keep_full, int keep_tri,
                float sm_scale) {
  using L = Dq<D>;
  constexpr int NC = L::NC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sdO = sQ + NC * L::CQ;
  uint8_t* sKV = sdO + NC * L::CQ;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sQ + L::BARS);
  uint64_t* qempty = qfull + 1;
  uint64_t* full = qempty + 1;
  uint64_t* empty = full + NSTAGE;

  const int n_q = (Tq + QB - 1) / QB;
  const int n_kv = Tk / KB;
  // Work tile w is Q tile n_q - 1 - w % n_q of (b*h) w / n_q: the Q tiles
  // of one head go together, the heaviest causal one first
  const Tiles tiles{BH * n_q};
  const int tid = threadIdx.x;

  // a consumer warp's lane 0 arrives once it is done with a stage or Q/dO
  if (tid == 0) {
    mbar_init(qfull, 1);
    mbar_init(qempty, CONSUMERS / 32);
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer; its path never joins the others'
    setmaxnreg_dec<24>();
    if (tid != CONSUMERS) return;
    int it = 0, n = 0;  // K/V tiles and Q/dO tiles loaded so far
    for (int r = tiles.next(-1); r >= 0; r = tiles.next(r)) {
      const int w = tiles.at(r);
      const int qi = n_q - 1 - w % n_q, bh = w / n_q;
      const int b = bh / H, h = bh - b * H;
      const int hi = kv_tile_end<QB, KB>(qi, n_kv, keep_full, keep_tri);
      for (int j = 0; j < hi; ++j, ++it) {
        const int s = it % NSTAGE;
        uint8_t* sK = sKV + s * L::STAGE;
        mbar_wait(empty + s, ((it / NSTAGE) & 1) ^ 1);
        mbar_expect_tx(full + s, L::STAGE);
        for (int c = 0; c < NC; ++c) {
          tma_tile(sK + c * L::CK, &mk, full + s, bthd, c * 64, j * KB, h,
                   b);
          tma_tile(sK + (NC + c) * L::CK, &mv, full + s, bthd, c * 64,
                   j * KB, h, b);
        }
        if (j == 0) {  // Q and dO, once the last scores of the previous tile
          mbar_wait(qempty, (n & 1) ^ 1);
          mbar_expect_tx(qfull, 2 * NC * L::CQ);
          for (int c = 0; c < NC; ++c) {
            tma_tile(sQ + c * L::CQ, &mq, qfull, bthd, c * 64, qi * QB, h,
                     b);
            tma_tile(sdO + c * L::CQ, &mdo, qfull, bthd, c * 64, qi * QB, h,
                     b);
          }
          ++n;
        }
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int cw = tid >> 7;  // consumer warpgroup: Q rows cw*64 ..
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row group of the fragments
  const int t = lane & 3;   // thread in the group
  const float scale2 = sm_scale * LOG2E;
  auto stage = [&](int i) { return sKV + (i % NSTAGE) * L::STAGE; };
  // this warp is done with a stage of the ring, or with Q and dO (only
  // wgmma read them, so no proxy fence)
  auto release = [&](uint64_t* bar) {
    if (lane == 0) mbar_arrive(bar);
  };

  int it = 0, n = 0;  // as the producer counts them
  for (int r = tiles.next(-1); r >= 0; r = tiles.next(r)) {
    const int w = tiles.at(r);
    const int qi = n_q - 1 - w % n_q, bh = w / n_q;
    const int b = bh / H, h = bh - b * H;
    const int hi = kv_tile_end<QB, KB>(qi, n_kv, keep_full, keep_tri);
    const int wg_row = qi * QB + cw * 64;  // first Q row of this consumer
    const int row0 = wg_row + warp * 16 + g;  // and row0 + 8

    float acc[NC * 32];  // 8-column block j of dq is acc[4j .. 4j+3]
#pragma unroll
    for (int i = 0; i < NC * 32; ++i) acc[i] = 0.0f;

    if (hi > 0) {
      // lse (log2 domain) and delta of rows row0 and row0 + 8; a ragged
      // last Q tile's rows past Tq (this consumer's 64 rows all lie past
      // it) read nothing and write nothing
      float lse2[2] = {0.0f, 0.0f}, dlt[2] = {0.0f, 0.0f};
      if (wg_row < Tq) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const long long at = (long long)bh * Tq + row0 + q * 8;
          lse2[q] = lse[at] * LOG2E;
          dlt[q] = delta[at];
        }
      }
      float s[KB / 2], dp[KB / 2];  // S and dP of a K/V tile, then dS in dp
      uint32_t dsf[KB / 16][4];     // dS in bf16

      // S = Q.K^T and dP = dO.V^T of K/V tile `i` of the ring over the
      // head dim, 16 deep per product (the first overwrites); all four
      // operands K-major
      auto issue_scores = [&](int i) {
        const uint64_t dQ = opaque(desc_sw128(sQ + cw * 64 * 128, 16));
        const uint64_t dO = opaque(desc_sw128(sdO + cw * 64 * 128, 16));
        const uint64_t dK = opaque(desc_sw128(stage(i), 16));
        const uint64_t dV = opaque(desc_sw128(stage(i) + NC * L::CK, 16));
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const int oq = (ks >> 2) * L::CQ + (ks & 3) * 32;
          const int ok = (ks >> 2) * L::CK + (ks & 3) * 32;
          wgmma_ss<KB>(s, desc_at(dQ, oq), desc_at(dK, ok), ks != 0);
          wgmma_ss<KB>(dp, desc_at(dO, oq), desc_at(dV, ok), ks != 0);
        }
      };
      // dq += dS.K of K/V tile `i`: K's rows are the depth, its columns
      // (contiguous) N
      auto issue_dq = [&](int i) {
        const uint64_t dKt = opaque(desc_sw128(stage(i), L::CK));
#pragma unroll
        for (int kk = 0; kk < KB / 16; ++kk)
          wgmma_rs<NC * 64>(acc, dsf[kk], desc_at(dKt, kk * 2048), 1);
      };
      // dS = P * (dP - delta) of the tile's j-th K/V tile, in f32 over dp;
      // masked entries have p exactly 0. Only tiles that cross the
      // diagonal need the mask.
      auto to_ds = [&](int j) {
        const bool mask = !keep_full && j * KB + KB - 1 > wg_row;
#pragma unroll
        for (int i = 0; i < KB / 2; ++i) {
          const int q = (i >> 1) & 1;
          float p = exp2_approx(fmaf(s[i], scale2, -lse2[q]));
          if (mask && j * KB + (i >> 2) * 8 + 2 * t + (i & 1) > row0 + q * 8)
            p = 0.0f;
          dp[i] = p * (dp[i] - dlt[q]);
        }
      };
      // dS rounded to bf16 (as on the TPU): accumulator blocks 2kk and
      // 2kk+1 are the A operand of depth step kk of dS.K
      auto to_dsf = [&]() {
#pragma unroll
        for (int n8 = 0; n8 < KB / 8; ++n8) {
          dsf[n8 >> 1][(n8 & 1) * 2] = pack_bf16(dp[4 * n8], dp[4 * n8 + 1]);
          dsf[n8 >> 1][(n8 & 1) * 2 + 1] =
              pack_bf16(dp[4 * n8 + 2], dp[4 * n8 + 3]);
        }
      };
      auto wait_kv = [&](int i) {
        mbar_wait(full + i % NSTAGE, (i / NSTAGE) & 1);
      };

      // The scores of K/V tile j go out together with dq += dS.K of tile
      // j-1; once the scores are done, dS of tile j is formed while that
      // product runs. A stage is released when its dq product is done, Q
      // and dO after the last scores.
      mbar_wait(qfull, n & 1);
      wait_kv(it);
      wgmma_fence();
      issue_scores(it);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if (hi == 1) release(qempty);
      to_ds(0);
      to_dsf();
      for (int j = 1; j < hi; ++j) {
        const int i = it + j;
        wait_kv(i);
        wgmma_fence();
        issue_scores(i);
        wgmma_commit();
        issue_dq(i - 1);
        wgmma_commit();
        wgmma_wait<1>();  // the scores of tile j
        fence_regs(s);
        fence_regs(dp);
        if (j == hi - 1) release(qempty);
        to_ds(j);
        wgmma_wait<0>();  // dq += dS.K of tile j-1
        fence_regs(acc);
        fence_regs(dsf);
        release(empty + (i - 1) % NSTAGE);
        to_dsf();
      }
      wgmma_fence();
      issue_dq(it + hi - 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(dsf);
      release(empty + (it + hi - 1) % NSTAGE);
      it += hi;
      ++n;
    }

    // dq straight from registers, scaled by sm_scale; rows past Tq are not
    // written
    if (wg_row < Tq) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int row = row0 + q * 8;
        float* orow = out + (bthd ? ((long long)b * Tq + row) * H + h
                                  : (long long)bh * Tq + row) *
                                D;
#pragma unroll
        for (int n8 = 0; n8 < D / 8; ++n8)
          *reinterpret_cast<float2*>(orow + n8 * 8 + 2 * t) =
              make_float2(acc[4 * n8 + 2 * q] * sm_scale,
                          acc[4 * n8 + 2 * q + 1] * sm_scale);
      }
    }
  }
}

}  // namespace dq

namespace dkv {

constexpr int KBK = 128;        // key rows of a work tile, 64 per consumer
constexpr int KBQ = 64;         // Q/dO rows of a streamed tile
constexpr int NSTAGE = 3;       // Q/dO ring depth
constexpr int CONSUMERS = 256;  // two consumer warpgroups
constexpr int THREADS = 384;    // and the producer warpgroup

template <int D>
struct Dkv {
  static constexpr int NC = (D + 63) / 64;  // 64-column chunks
  static constexpr int CK = KBK * 128;      // bytes of a K/V chunk
  static constexpr int CQ = KBQ * 128;      // bytes of a Q/dO chunk
  // a stage: Q, dO, then KBQ lse and KBQ delta values in a 1024-byte slot
  static constexpr int STAGE = 2 * NC * CQ + 1024;
  static constexpr int TX = 2 * NC * CQ + 2 * KBQ * (int)sizeof(float);
  static constexpr int BARS = 2 * NC * CK + NSTAGE * STAGE;
  // K/V's full and empty barriers, then each stage's
  static constexpr size_t smem = BARS + 8 * (2 + 2 * NSTAGE) + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv,
                 const __grid_constant__ CUtensorMap mdo,
                 float* __restrict__ dk, float* __restrict__ dv,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, int BH, int H, int Tq,
                 int Tk, int bthd, int keep_full, int keep_tri,
                 float sm_scale) {
  using L = Dkv<D>;
  constexpr int NC = L::NC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);
  uint8_t* sV = sK + NC * L::CK;
  uint8_t* sQD = sV + NC * L::CK;
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(sK + L::BARS);
  uint64_t* kvempty = kvfull + 1;
  uint64_t* full = kvempty + 1;
  uint64_t* empty = full + NSTAGE;

  const int n_q = Tq / KBQ;
  const int n_k = (Tk + KBK - 1) / KBK;
  // the lowest KV tiles, which see the most Q tiles, first: work tile w is
  // KV tile w / BH of (b*h) w % BH
  const Tiles tiles{BH * n_k};
  // `lo_tri` of the TPU kernel: Q tiles wholly above the diagonal give KV
  // tile ki nothing; the "none" block visits no Q tile
  auto q_lo = [&](int ki) {
    return keep_full ? 0 : (keep_tri ? min((ki * KBK) / KBQ, n_q) : n_q);
  };
  const int tid = threadIdx.x;

  // a consumer warp's lane 0 arrives once it is done with a stage or K/V
  if (tid == 0) {
    mbar_init(kvfull, 1);
    mbar_init(kvempty, CONSUMERS / 32);
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer; its path never joins the others'
    setmaxnreg_dec<24>();
    if (tid != CONSUMERS) return;
    int it = 0, n = 0;  // Q/dO tiles and K/V tiles loaded so far
    for (int r = tiles.next(-1); r >= 0; r = tiles.next(r)) {
      const int w = tiles.at(r);
      const int ki = w / BH, bh = w % BH;
      const int b = bh / H, h = bh - b * H;
      const float* lrow = lse + (long long)bh * Tq;
      const float* drow = delta + (long long)bh * Tq;
      const int lo = q_lo(ki);
      for (int i = lo; i < n_q; ++i, ++it) {
        // Q and dO of tile i into its stage, with its lse and delta
        const int s = it % NSTAGE;
        uint8_t* sQ = sQD + s * L::STAGE;
        float* sL = reinterpret_cast<float*>(sQ + 2 * NC * L::CQ);
        mbar_wait(empty + s, ((it / NSTAGE) & 1) ^ 1);
        mbar_expect_tx(full + s, L::TX);
        for (int c = 0; c < NC; ++c) {
          tma_tile(sQ + c * L::CQ, &mq, full + s, bthd, c * 64, i * KBQ, h,
                   b);
          tma_tile(sQ + (NC + c) * L::CQ, &mdo, full + s, bthd, c * 64,
                   i * KBQ, h, b);
        }
        bulk_load(sL, lrow + i * KBQ, KBQ * sizeof(float), full + s);
        bulk_load(sL + KBQ, drow + i * KBQ, KBQ * sizeof(float), full + s);
        if (i == lo) {  // K and V, once the consumers' last scores are done
          mbar_wait(kvempty, (n & 1) ^ 1);
          mbar_expect_tx(kvfull, 2 * NC * L::CK);
          for (int c = 0; c < NC; ++c) {
            tma_tile(sK + c * L::CK, &mk, kvfull, bthd, c * 64, ki * KBK, h,
                     b);
            tma_tile(sV + c * L::CK, &mv, kvfull, bthd, c * 64, ki * KBK, h,
                     b);
          }
          ++n;
        }
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int cw = tid >> 7;  // consumer warpgroup: key rows cw*64 ..
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float scale2 = sm_scale * LOG2E;
  const uint8_t* ka = sK + cw * 64 * 128;  // this consumer's 64 key rows
  const uint8_t* va = sV + cw * 64 * 128;
  // this warp is done with a stage of the ring (its lse and delta were
  // read by plain loads, before TMA overwrites them), or with K and V
  auto release = [&](uint64_t* bar) {
    fence_async_smem();
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  int it = 0, n = 0;  // as the producer counts them
  for (int r = tiles.next(-1); r >= 0; r = tiles.next(r)) {
    const int w = tiles.at(r);
    const int ki = w / BH, bh = w % BH;
    const int b = bh / H, h = bh - b * H;
    const int lo = q_lo(ki);
    const int row0 = ki * KBK + cw * 64 + warp * 16 + g;  // and row0 + 8
    const int wg_last = ki * KBK + cw * 64 + 63;  // last key row of consumer

    // 8-column block j of dK and dV is dka/dva[4j .. 4j+3]
    float dka[NC * 32], dva[NC * 32];
#pragma unroll
    for (int i = 0; i < NC * 32; ++i) dka[i] = dva[i] = 0.0f;

    // descriptors of this consumer's K and V rows, K-major for the scores
    const uint64_t dK = opaque(desc_sw128(ka, 16));
    const uint64_t dV = opaque(desc_sw128(va, 16));
    float st[16], dpt[16];  // S^T and dP^T of one half of a Q tile
    // P^T and dS^T of the first and the second half, bf16
    uint32_t pf0[2][4], dsf0[2][4], pf1[2][4], dsf1[2][4];

    // The Q tile goes in two halves of 32 columns, so the scores of only
    // one half live beside the dK and dV accumulators. Per half: S^T =
    // K.Q^T and dP^T = V.dO^T (64 key rows x 32 Q columns; the first
    // product of each overwrites it), with Q and dO K-major; then P^T and
    // dS^T in bf16, whose accumulator blocks 2kk and 2kk+1 are the A
    // operand of depth step kk of dV += P^T.dO and dK += dS^T.Q, with dO and
    // Q MN-major (their rows are the depth). `k` counts the ring's tiles.
    auto stage = [&](int k) { return sQD + (k % NSTAGE) * L::STAGE; };
    auto issue_scores = [&](int k, int hq) {
      const uint64_t dQ = opaque(desc_sw128(stage(k), 16));
      const uint64_t dO = opaque(desc_sw128(stage(k) + NC * L::CQ, 16));
#pragma unroll
      for (int ks = 0; ks < NC * 4; ++ks) {
        const int ok = (ks >> 2) * L::CK + (ks & 3) * 32;
        const int oq = (ks >> 2) * L::CQ + (ks & 3) * 32 + hq * 32 * 128;
        wgmma_ss<32>(st, desc_at(dK, ok), desc_at(dQ, oq), ks != 0);
        wgmma_ss<32>(dpt, desc_at(dV, ok), desc_at(dO, oq), ks != 0);
      }
    };
    auto issue_grads = [&](int k, int hq, const uint32_t(&pf)[2][4],
                           const uint32_t(&dsf)[2][4]) {
      const uint64_t dQt = opaque(desc_sw128(stage(k), L::CQ));
      const uint64_t dOt = opaque(desc_sw128(stage(k) + NC * L::CQ, L::CQ));
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int off = (hq * 2 + kk) * 2048;
        wgmma_rs<NC * 64>(dva, pf[kk], desc_at(dOt, off), 1);
        wgmma_rs<NC * 64>(dka, dsf[kk], desc_at(dQt, off), 1);
      }
    };
    // lse and delta are per column (Q row). The causal mask is transposed:
    // key row r is kept for Q column c when r <= c; only Q tiles that
    // cross the diagonal need it.
    auto to_frags = [&](int k, int i, int hq, uint32_t(&pf)[2][4],
                        uint32_t(&dsf)[2][4]) {
      const float* sL =
          reinterpret_cast<const float*>(stage(k) + 2 * NC * L::CQ);
      const float* sDl = sL + KBQ;
      const bool mask = !keep_full && wg_last > i * KBQ;
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8) {
        const int cl = hq * 32 + n8 * 8 + 2 * t;  // Q column in the tile
        const float2 lv = *reinterpret_cast<const float2*>(sL + cl);
        const float2 dl = *reinterpret_cast<const float2*>(sDl + cl);
        const float l2[2] = {lv.x * LOG2E, lv.y * LOG2E};
        const float dlt[2] = {dl.x, dl.y};
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2_approx(fmaf(st[4 * n8 + e], scale2, -l2[e & 1]));
          if (mask && row0 + (e >> 1) * 8 > i * KBQ + cl + (e & 1))
            p[e] = 0.0f;
          ds[e] = p[e] * (dpt[4 * n8 + e] - dlt[e & 1]);
        }
        pf[n8 >> 1][(n8 & 1) * 2] = pack_bf16(p[0], p[1]);
        pf[n8 >> 1][(n8 & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
        dsf[n8 >> 1][(n8 & 1) * 2] = pack_bf16(ds[0], ds[1]);
        dsf[n8 >> 1][(n8 & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
    };

    // A software pipeline over the Q tiles: each half's scores go before
    // the gradient products of the half before it (the second half's of
    // the previous Q tile, or the first half's of this one), so P^T and
    // dS^T of a half are formed while those products run. A stage is
    // released once its second half's gradient products are done.
    auto first_half = [&](int k, int i) {  // its scores waited for
      fence_regs(st);
      fence_regs(dpt);
      fence_regs(pf0);
      fence_regs(dsf0);
      to_frags(k, i, 0, pf0, dsf0);
    };
    auto second_half = [&](int k, int i) {  // scores, then P^T and dS^T
      wgmma_fence();
      issue_scores(k, 1);
      wgmma_commit();
      issue_grads(k, 0, pf0, dsf0);
      wgmma_commit();
      wgmma_wait<1>();  // the scores, and the previous Q tile's products
      fence_regs(st);
      fence_regs(dpt);
      fence_regs(pf1);
      fence_regs(dsf1);
      if (i > lo) release(empty + (k - 1) % NSTAGE);
      if (i == n_q - 1) release(kvempty);
      to_frags(k, i, 1, pf1, dsf1);
    };
    if (lo < n_q) {
      mbar_wait(kvfull, n & 1);
      mbar_wait(full + it % NSTAGE, (it / NSTAGE) & 1);
      wgmma_fence();
      issue_scores(it, 0);
      wgmma_commit();
      wgmma_wait<0>();
      first_half(it, lo);
      for (int i = lo; i < n_q - 1; ++i, ++it) {
        second_half(it, i);
        mbar_wait(full + (it + 1) % NSTAGE, ((it + 1) / NSTAGE) & 1);
        wgmma_fence();
        issue_scores(it + 1, 0);
        wgmma_commit();
        issue_grads(it, 1, pf1, dsf1);
        wgmma_commit();
        wgmma_wait<1>();  // the scores, and Q tile i's first half
        first_half(it + 1, i + 1);
      }
      second_half(it, n_q - 1);
      wgmma_fence();
      issue_grads(it, 1, pf1, dsf1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dka);
      fence_regs(dva);
      fence_regs(pf0);
      fence_regs(dsf0);
      fence_regs(pf1);
      fence_regs(dsf1);
      release(empty + it % NSTAGE);
      ++it;
      ++n;
    }

    // dK and dV straight from registers; key rows past Tk (a ragged last
    // KV tile: this consumer's 64 rows all lie past it) hold no gradient
    if (ki * KBK + cw * 64 < Tk) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int row = row0 + q * 8;
        const long long off =
            (bthd ? ((long long)b * Tk + row) * H + h
                  : (long long)bh * Tk + row) *
            D;
#pragma unroll
        for (int n8 = 0; n8 < D / 8; ++n8) {
          const int e = 4 * n8 + 2 * q;
          *reinterpret_cast<float2*>(dk + off + n8 * 8 + 2 * t) =
              make_float2(dka[e] * sm_scale, dka[e + 1] * sm_scale);
          *reinterpret_cast<float2*>(dv + off + n8 * 8 + 2 * t) =
              make_float2(dva[e], dva[e + 1]);
        }
      }
    }
  }
}

}  // namespace dkv

// the arguments both kernels take, as the C interface passes them
struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *delta;
  int B, H, Tq, Tk, layout_bthd, keep_full, keep_tri;
  float sm_scale;
  cudaStream_t stream;
};

template <int D>
static int launch_dq(const BwdArgs& a, void* out) {
  using namespace dq;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err;
  const int bthd = a.layout_bthd, BH = a.B * a.H;
  int dev, blocks;
  if ((err = cudaGetDevice(&dev)) ||
      (err = configure_smem<flash_dq_kernel<D>>(dev, Dq<D>::smem)) ||
      (err = make_tile_map(&mq, a.q, a.B, a.H, a.Tq, D, bthd, QB)) ||
      (err = make_tile_map(&mk, a.k, a.B, a.H, a.Tk, D, bthd, KB)) ||
      (err = make_tile_map(&mv, a.v, a.B, a.H, a.Tk, D, bthd, KB)) ||
      (err = make_tile_map(&mdo, a.dout, a.B, a.H, a.Tq, D, bthd, QB)) ||
      (err = persistent_blocks(dev, BH * ((a.Tq + QB - 1) / QB), &blocks)))
    return (int)err;
  flash_dq_kernel<D><<<blocks, THREADS, Dq<D>::smem, a.stream>>>(
      mq, mk, mv, mdo, static_cast<float*>(out),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      BH, a.H, a.Tq, a.Tk, bthd, a.keep_full, a.keep_tri, a.sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_dkv(const BwdArgs& a, void* dk, void* dv) {
  using namespace dkv;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err;
  const int bthd = a.layout_bthd, BH = a.B * a.H;
  int dev, blocks;
  if ((err = cudaGetDevice(&dev)) ||
      (err = configure_smem<flash_dkv_kernel<D>>(dev, Dkv<D>::smem)) ||
      (err = make_tile_map(&mq, a.q, a.B, a.H, a.Tq, D, bthd, KBQ)) ||
      (err = make_tile_map(&mk, a.k, a.B, a.H, a.Tk, D, bthd, KBK)) ||
      (err = make_tile_map(&mv, a.v, a.B, a.H, a.Tk, D, bthd, KBK)) ||
      (err = make_tile_map(&mdo, a.dout, a.B, a.H, a.Tq, D, bthd, KBQ)) ||
      (err = persistent_blocks(dev, BH * ((a.Tk + KBK - 1) / KBK),
                               &blocks)))
    return (int)err;
  flash_dkv_kernel<D><<<blocks, THREADS, Dkv<D>::smem, a.stream>>>(
      mq, mk, mv, mdo, static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      BH, a.H, a.Tq, a.Tk, bthd, a.keep_full, a.keep_tri, a.sm_scale);
  return (int)cudaGetLastError();
}

static int dispatch_dq(const BwdArgs& a, int D, void* out) {
  FLASH_DISPATCH_D(D, launch_dq<DD>(a, out))
}

static int dispatch_dkv(const BwdArgs& a, int D, void* dk, void* dv) {
  FLASH_DISPATCH_D(D, launch_dkv<DD>(a, dk, dv))
}

// q [B,Tq,H,D] or [B,H,Tq,D], k/v the same with Tk, dout like q, all bf16
// (in_bf16 must be 1: the wrapper rounds f32 inputs to bf16 first); lse
// and delta [B,H,Tq] f32; all contiguous and 16-byte aligned. dq (like q),
// dk and dv (like k) are written in f32. Each returns a cudaError_t value
// (0 on a successful launch).
extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int B, int H, int Tq, int Tk, int D,
                        int layout_bthd, int in_bf16, int keep_full,
                        int keep_tri, float sm_scale, void* stream) {
  if (!flash_shape_ok(B, H, Tq, Tk, D) || !in_bf16)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, dout, lse, delta, B, H, Tq, Tk, layout_bthd,
                  keep_full, keep_tri, sm_scale,
                  static_cast<cudaStream_t>(stream)};
  return dispatch_dq(a, D, dq);
}

extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse,
                         const void* delta, void* dk, void* dv, int B, int H,
                         int Tq, int Tk, int D, int layout_bthd, int in_bf16,
                         int keep_full, int keep_tri, float sm_scale,
                         void* stream) {
  if (!flash_shape_ok(B, H, Tq, Tk, D) || !in_bf16)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, dout, lse, delta, B, H, Tq, Tk, layout_bthd,
                  keep_full, keep_tri, sm_scale,
                  static_cast<cudaStream_t>(stream)};
  return dispatch_dkv(a, D, dk, dv);
}
