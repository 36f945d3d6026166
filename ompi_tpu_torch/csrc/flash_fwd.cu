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
// least time is the bytes' time. Every intermediate (scores, probabilities,
// the output accumulator) stays in registers; each work tile reads its Q
// tile once and the K/V tiles it needs once, and writes out once.
//
// Design (hopper.cuh holds the machinery): a persistent block per SM walks
// over work tiles (b*h, 128-row Q tile), head by head and in each head the
// heaviest causal Q tile first.
// A block is three warpgroups:
// - a producer (setmaxnreg down to 24 registers), one thread of which
//   loads by TMA with 128-byte swizzle the Q tile of each work tile and its
//   128-row K and V tiles, through a ring of three stages. K and V of a
//   stage, and Q, each have a "full" and an "empty" mbarrier, so K is
//   refilled as soon as its S is done and V as soon as its P.V is, and the
//   next work tile's tiles load while this one's last products and stores
//   run.
// - two consumers of 64 Q rows each (setmaxnreg up to 240). Per KV tile:
//   S = Q.K^T by wgmma m64n128k16 with both operands in shared memory
//   (K-major); the online softmax on the accumulator registers in the log2
//   domain, masking only the tiles that cross the diagonal or the end of
//   the keys; P rounded to bf16 in registers (as on the TPU) as the A
//   operand of O += P.V, wgmma m64n{64,128}k16 with V from shared memory
//   through the transpose bit. The consumers take turns to issue their
//   products (named barriers), S of tile j with O += P.V of tile j-1, so
//   one's softmax runs under the other's products. They write out and lse
//   straight from registers.
// Every row of a visited tile keeps at least one key (tiles visited in
// order from tile 0, whose first key every row keeps), so a masked score
// of -1e30 underflows to exactly 0 with no second mask. f32 inputs are
// rounded to bf16 by the wrapper before the launch (TMA cannot convert).

#include "flash_common.cuh"
#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int FBQ = 128;        // Q rows of a work tile, 64 per consumer
constexpr int FBK = 128;        // K/V rows of a tile
constexpr int NSTAGE = 3;       // K/V ring depth
constexpr int CONSUMERS = 256;  // two consumer warpgroups
constexpr int THREADS = 384;    // and the producer warpgroup

template <int D>
struct Fwd {
  static constexpr int NC = (D + 63) / 64;  // 64-column chunks
  static constexpr int CQ = FBQ * 128;      // bytes of a Q chunk
  static constexpr int CK = FBK * 128;      // bytes of a K/V chunk
  static constexpr int STAGE = 2 * NC * CK;  // K then V
  static constexpr int BARS = NC * CQ + NSTAGE * STAGE;
  // Q's full and empty barriers, then each stage's for K and for V
  static constexpr size_t smem = BARS + 8 * (2 + 4 * NSTAGE) + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv,
                 float* __restrict__ out, float* __restrict__ lse, int BH,
                 int H, int Tq, int Tk, int bthd, int keep_full,
                 int keep_tri, float sm_scale) {
  using L = Fwd<D>;
  constexpr int NC = L::NC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sKV = sQ + NC * L::CQ;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sQ + L::BARS);
  uint64_t* qempty = qfull + 1;
  // K and V of a stage each have their own pair, so each is refilled as
  // soon as its own product is done
  uint64_t* kfull = qempty + 1;
  uint64_t* vfull = kfull + NSTAGE;
  uint64_t* kempty = vfull + NSTAGE;
  uint64_t* vempty = kempty + NSTAGE;

  const int n_q = (Tq + FBQ - 1) / FBQ;
  const int n_kv = (Tk + FBK - 1) / FBK;
  // Work tile w is Q tile n_q - 1 - w % n_q of (b*h) w / n_q: the Q tiles
  // of one head go together, the heaviest causal one first. So the blocks
  // at work at one time share the K and V of a few heads, which stay in
  // L2 while out streams past them.
  const Tiles tiles{BH * n_q};
  const int tid = threadIdx.x;

  // a consumer warp's lane 0 arrives once it is done with a stage or Q
  if (tid == 0) {
    mbar_init(qfull, 1);
    mbar_init(qempty, CONSUMERS / 32);
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(kfull + s, 1);
      mbar_init(vfull + s, 1);
      mbar_init(kempty + s, CONSUMERS / 32);
      mbar_init(vempty + s, CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer; its path never joins the others'
    setmaxnreg_dec<24>();
    if (tid != CONSUMERS) return;
    int it = 0, n = 0;  // K/V tiles and Q tiles loaded so far
    for (int r = tiles.next(-1); r >= 0; r = tiles.next(r)) {
      const int w = tiles.at(r);
      const int qi = n_q - 1 - w % n_q, bh = w / n_q;
      const int b = bh / H, h = bh - b * H;
      const int hi = kv_tile_end<FBQ, FBK>(qi, n_kv, keep_full, keep_tri);
      for (int j = 0; j < hi; ++j, ++it) {
        const int s = it % NSTAGE, ph = ((it / NSTAGE) & 1) ^ 1;
        uint8_t* sK = sKV + s * L::STAGE;
        uint8_t* sV = sK + NC * L::CK;
        mbar_wait(kempty + s, ph);
        mbar_expect_tx(kfull + s, NC * L::CK);
        for (int c = 0; c < NC; ++c)
          tma_tile(sK + c * L::CK, &mk, kfull + s, bthd, c * 64, j * FBK, h,
                   b);
        if (j == 0) {  // Q, once the consumers' last S of the previous tile
          mbar_wait(qempty, (n & 1) ^ 1);
          mbar_expect_tx(qfull, NC * L::CQ);
          for (int c = 0; c < NC; ++c)
            tma_tile(sQ + c * L::CQ, &mq, qfull, bthd, c * 64, qi * FBQ, h, b);
          ++n;
        }
        mbar_wait(vempty + s, ph);
        mbar_expect_tx(vfull + s, NC * L::CK);
        for (int c = 0; c < NC; ++c)
          tma_tile(sV + c * L::CK, &mv, vfull + s, bthd, c * 64, j * FBK, h,
                   b);
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
  // the consumers take turns to issue their products (named barriers 1
  // and 2), consumer 0 first; a turn ends by letting the other go
  const int my_turn = 1 + cw, next_turn = 2 - cw;
  if (cw == 1 && (keep_full || keep_tri)) bar_arrive(next_turn, CONSUMERS);

  int it = 0, n = 0;  // as the producer counts them
  for (int r = tiles.next(-1); r >= 0;) {
    const int w = tiles.at(r);
    r = tiles.next(r);
    const int qi = n_q - 1 - w % n_q, bh = w / n_q;
    const int b = bh / H, h = bh - b * H;
    const int hi = kv_tile_end<FBQ, FBK>(qi, n_kv, keep_full, keep_tri);
    const int row0 = qi * FBQ + cw * 64 + warp * 16 + g;  // and row0 + 8
    const int wg_row = qi * FBQ + cw * 64;  // first Q row of this consumer

    float o[NC * 32];  // 8-column block j of O is o[4j .. 4j+3]
#pragma unroll
    for (int i = 0; i < NC * 32; ++i) o[i] = 0.0f;
    // rows g and g+8 of this warp's 16: running max (log2 domain) and this
    // thread's share of the denominator
    float m[2] = {NEG_BIG, NEG_BIG};
    float l[2] = {0.0f, 0.0f};
    uint32_t pf[FBK / 16][4];  // P of the previous tile, bf16
    float sc[FBK / 2];         // S of the current tile, then its P in f32
    float alpha[2];            // the rescale of O for the current tile

    // S = Q.K^T of K/V tile `i` of the ring, over the head dim, 16 deep per
    // product (the first overwrites sc); Q and K both K-major
    auto issue_s = [&](int i) {
      const uint64_t dQ = opaque(desc_sw128(sQ + cw * 64 * 128, 16));
      const uint64_t dK =
          opaque(desc_sw128(sKV + (i % NSTAGE) * L::STAGE, 16));
#pragma unroll
      for (int ks = 0; ks < NC * 4; ++ks) {
        const int off = (ks & 3) * 32;  // 16 columns into the chunk
        wgmma_ss<FBK>(sc, desc_at(dQ, (ks >> 2) * L::CQ + off),
                      desc_at(dK, (ks >> 2) * L::CK + off), ks != 0);
      }
    };
    // O += P.V of K/V tile `i` of the ring: V's rows are the depth, its
    // columns (contiguous) N
    auto issue_pv = [&](int i) {
      const uint64_t dV = opaque(
          desc_sw128(sKV + (i % NSTAGE) * L::STAGE + NC * L::CK, L::CK));
#pragma unroll
      for (int kk = 0; kk < FBK / 16; ++kk)
        wgmma_rs<NC * 64>(o, pf[kk], desc_at(dV, kk * 2048), 1);
    };
    // the online softmax of tile j on the raw scores (the max is taken
    // before scaling, sm_scale > 0): sc becomes P in f32 and alpha the
    // rescale of O. Only tiles that cross the diagonal or the end of the
    // keys need a mask.
    auto softmax = [&](int j) {
      if (j * FBK + FBK > Tk || (!keep_full && j * FBK + FBK - 1 > wg_row)) {
#pragma unroll
        for (int i = 0; i < FBK / 2; ++i) {
          const int col = j * FBK + (i >> 2) * 8 + 2 * t + (i & 1);
          const int row = row0 + ((i >> 1) & 1) * 8;
          if (col >= Tk || (!keep_full && col > row)) sc[i] = NEG_BIG;
        }
      }
      float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
      for (int i = 0; i < FBK / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        mx[q] = fmaxf(mx[q], __shfl_xor_sync(0xffffffffu, mx[q], 1));
        mx[q] = fmaxf(mx[q], __shfl_xor_sync(0xffffffffu, mx[q], 2));
        const float m_new = fmaxf(m[q], mx[q] * scale2);
        alpha[q] = exp2_approx(m[q] - m_new);
        m[q] = m_new;
        l[q] *= alpha[q];
      }
#pragma unroll
      for (int i = 0; i < FBK / 2; ++i) {
        sc[i] = exp2_approx(fmaf(sc[i], scale2, -m[(i >> 1) & 1]));
        l[(i >> 1) & 1] += sc[i];
      }
    };
    // O rescaled, and P in bf16 (as on the TPU): accumulator blocks 2kk and
    // 2kk+1 are the A operand of depth step kk of P.V
    auto to_pf = [&]() {
#pragma unroll
      for (int i = 0; i < NC * 32; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int n8 = 0; n8 < FBK / 8; ++n8) {
        pf[n8 >> 1][(n8 & 1) * 2] = pack_bf16(sc[4 * n8], sc[4 * n8 + 1]);
        pf[n8 >> 1][(n8 & 1) * 2 + 1] =
            pack_bf16(sc[4 * n8 + 2], sc[4 * n8 + 3]);
      }
    };
    // this warp is done with stage `i` of the ring, or with Q
    auto release = [&](uint64_t* bar) {
      if (lane == 0) mbar_arrive(bar);
    };

    // A turn issues S of tile j together with O += P.V of tile j-1; K of
    // tile j and V of tile j-1 are released once those are done, and Q
    // after the last S.
    auto wait_k = [&](int i) {
      mbar_wait(kfull + i % NSTAGE, (i / NSTAGE) & 1);
    };
    auto wait_v = [&](int i) {
      mbar_wait(vfull + i % NSTAGE, (i / NSTAGE) & 1);
    };
    if (hi > 0) {
      mbar_wait(qfull, n & 1);
      wait_k(it);
      bar_sync(my_turn, CONSUMERS);
      wgmma_fence();
      issue_s(it);
      wgmma_commit();
      bar_arrive(next_turn, CONSUMERS);
      wgmma_wait<0>();
      fence_regs(sc);
      release(kempty + it % NSTAGE);
      if (hi == 1) release(qempty);
      softmax(0);
      to_pf();

      for (int j = 1; j < hi; ++j) {
        const int i = it + j;
        wait_k(i);
        wait_v(i - 1);
        bar_sync(my_turn, CONSUMERS);
        wgmma_fence();
        issue_s(i);
        wgmma_commit();
        issue_pv(i - 1);
        wgmma_commit();
        bar_arrive(next_turn, CONSUMERS);
        // both done: P of tile j-1 needs no registers during the softmax
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(o);
        fence_regs(pf);
        release(kempty + i % NSTAGE);
        release(vempty + (i - 1) % NSTAGE);
        if (j == hi - 1) release(qempty);
        softmax(j);
        to_pf();
      }

      wait_v(it + hi - 1);
      bar_sync(my_turn, CONSUMERS);
      wgmma_fence();
      issue_pv(it + hi - 1);
      wgmma_commit();
      // the last turn of the launch lets no one go: consumer 0's last turn
      // comes first, consumer 1's ends the sequence
      if (cw == 0 || r >= 0) bar_arrive(next_turn, CONSUMERS);
      wgmma_wait<0>();
      fence_regs(o);
      release(vempty + (it + hi - 1) % NSTAGE);
      it += hi;
      ++n;
    }

    // out and lse straight from registers; rows past Tq (a ragged last Q
    // tile: this consumer's 64 rows all lie past it) are not written
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      l[q] += __shfl_xor_sync(0xffffffffu, l[q], 1);
      l[q] += __shfl_xor_sync(0xffffffffu, l[q], 2);
    }
    if (wg_row < Tq) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int row = row0 + q * 8;
        const float inv = 1.0f / fmaxf(l[q], 1e-30f);
        if (t == 0)
          lse[(long long)bh * Tq + row] =
              l[q] > 0.0f ? m[q] * LN2 + logf(l[q]) : NEG_BIG;
        float* orow = out + (bthd ? ((long long)b * Tq + row) * H + h
                                  : (long long)bh * Tq + row) *
                                D;
#pragma unroll
        for (int n8 = 0; n8 < D / 8; ++n8)
          *reinterpret_cast<float2*>(orow + n8 * 8 + 2 * t) =
              make_float2(o[4 * n8 + 2 * q] * inv,
                          o[4 * n8 + 2 * q + 1] * inv);
      }
    }
  }
}

template <int D>
static int launch(const void* q, const void* k, const void* v, void* out,
                  void* lse, int B, int H, int Tq, int Tk, int layout_bthd,
                  int keep_full, int keep_tri, float sm_scale,
                  cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  int dev, blocks;
  if ((err = cudaGetDevice(&dev)) ||
      (err = configure_smem<flash_fwd_kernel<D>>(dev, Fwd<D>::smem)) ||
      (err = make_tile_map(&mq, q, B, H, Tq, D, layout_bthd, FBQ)) ||
      (err = make_tile_map(&mk, k, B, H, Tk, D, layout_bthd, FBK)) ||
      (err = make_tile_map(&mv, v, B, H, Tk, D, layout_bthd, FBK)) ||
      (err = persistent_blocks(dev, B * H * ((Tq + FBQ - 1) / FBQ),
                               &blocks)))
    return (int)err;
  flash_fwd_kernel<D><<<blocks, THREADS, Fwd<D>::smem, stream>>>(
      mq, mk, mv, static_cast<float*>(out), static_cast<float*>(lse), B * H,
      H, Tq, Tk, layout_bthd, keep_full, keep_tri, sm_scale);
  return (int)cudaGetLastError();
}

static int launch_d(const void* q, const void* k, const void* v, void* out,
                    void* lse, int B, int H, int Tq, int Tk, int D,
                    int layout_bthd, int keep_full, int keep_tri,
                    float sm_scale, cudaStream_t s) {
  FLASH_DISPATCH_D(D, launch<DD>(q, k, v, out, lse, B, H, Tq, Tk,
                                 layout_bthd, keep_full, keep_tri, sm_scale,
                                 s))
}

}  // namespace

// q [B,Tq,H,D] or [B,H,Tq,D], k/v the same with Tk, all contiguous, 16-byte
// aligned and bf16 (in_bf16 must be 1: the wrapper rounds f32 inputs to
// bf16 first); out like q in f32; lse [B,H,Tq] f32. Returns a cudaError_t
// value (0 on a successful launch).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int H, int Tq, int Tk,
                         int D, int layout_bthd, int in_bf16, int keep_full,
                         int keep_tri, float sm_scale, void* stream) {
  if (!flash_shape_ok(B, H, Tq, Tk, D) || !in_bf16)
    return (int)cudaErrorInvalidValue;
  return launch_d(q, k, v, out, lse, B, H, Tq, Tk, D, layout_bthd, keep_full,
                  keep_tri, sm_scale, static_cast<cudaStream_t>(stream));
}
