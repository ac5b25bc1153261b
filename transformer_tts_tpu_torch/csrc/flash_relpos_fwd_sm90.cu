// Relative-position flash-attention forward redesigned for Hopper (sm_90a):
// bf16, prefix key mask, optional attention-prob dropout -- K4 (rate 0,
// conformer FastSpeech 2 synthesis) and K4-d (rate > 0, its training).
//
// Replaces the TPU kernel `_fwd_kernel` (transformer_tts_tpu/ops/
// flash_relpos.py:212) driven by `_relpos_fwd` (:268, the call at :285),
// dropout at :253-255. fp32 stays on the simple kernel,
// flash_relpos_fwd.cu; ops/flash_relpos picks one by
// flash_attention.select_design.
//
// What it computes is flash_relpos_fwd.cu's, per batch-head bh = b*H + h
// and query row i < T:
//   s[j]   = (q_u[i] . k[j] + bd[i, j]) * sm_scale   for keys j < k_len[b]
//   o[i]   = sum_j softmax(s)[j] * keep(i, j) * v[j]  (bf16)
//   o32[i] = the same in fp32 over the unrounded probabilities (when
//            asked for: the training forward's)
//   lse[i] = max_j s[j] + log(sum_j exp(s[j] - max))  (fp32)
// with bd = rel_shift(q_v P^T), P = p[h]. Put m = j - i + T - 1 and
// E = [P; 0; P], an (H, 2T+1, d) table the wrapper builds once per call:
//   bd[i, j] = qsel(i, m) . E[m],  qsel = q_v[i] for m <= T-1 (j <= i),
//                                  qsel = q_v[i+1] for m >= T+1 (j >= i+2),
// and E[T] = 0 gives the j = i+1 zero (flash_relpos.py:17-23). A row with
// no valid key gives o = 0 and lse = -1e30; keep is `keep_bit`
// (flash_common.cuh), the normaliser sums before dropout, and P times the
// keep scale is cast to bf16 before P.V, as the TPU kernel does. o32 is
// for the backward's delta = rowsum(dO * o32) (flash_relpos_bwd_sm90.cu):
// P goes into it as two bf16 parts, hi = bf16(P) and lo = bf16(P - hi),
// the lo product into an accumulator of its own. A delta from the bf16 o
// misses sum_j P dP by ~2^-9 of |dO||o|, so dS = P (dP - delta) no longer
// sums to 0 over a row; that adds a term along K's mean to dq_u and along
// q_u's to dK's sum over the keys, directions softmax gives no gradient,
// which Adam moves by lr a step all the same, and the conformer's bf16
// training diverged (its logits grew until the backward's recomputed P
// broke, by step ~400 on egs/synthetic_overfit.py's corpus). o32 holds
// delta to ~2^-16, and o stays bit for bit the TPU kernel's rounding.
// With a null o32 (no gradient to take: synthesis, eval) the FP32 = false
// instance skips the lo part, its product and the fp32 write.
// Deterministic: a second call on the same inputs and seed gives the same
// bits.
//
// Bound on the card: 6*H*T*sum_b(k_len[b])*d operations (q_u.K^T, the bias
// product and P.V over the valid keys) against q_u, q_v, k, v, o and P
// moved once: the tensor cores bound it at the conformer's shapes. The
// design does 10 units of work per tile where the function needs 6: the
// window of E a 64 x 64 tile needs is 127 rows, so the bias product is 64
// x 128, and with o32 P.V is taken twice, for its lo part. The simple
// kernel (one 4-warp WMMA block per SM, S, the bias product and O through
// shared memory) ran at 1/113 of the bound.
//
// Design (flash_fwd_sm90.cu's shape, with the same helpers,
// flash_sm90.cuh):
//   * a CTA per (128 query rows, bh): warpgroup 0 the producer, warpgroups
//     1 and 2 the consumers, 64 rows each;
//   * TMA loads Q_u, Q_v and Q_vs (q_v's box at row q0 + 1: the shifted
//     copy of `qvs_ref`, row T zero-filled) once; then K and V in a ring of
//     STAGES stages of BK keys, and E in a ring of E_SLOTS slices of 64
//     rows. The window of the tile (q0w, k0) is E[m0 .. m0+127), m0 =
//     k0 - q0w + T - 64; the two warpgroups' windows (q0w = q0, q0 + 64)
//     are three slices, and the next key tile's share two of them, so each
//     key tile brings one new slice. Slice n holds E[T - q0 - 128 + 64n ..
//     +64), rows outside the table zero-filled by TMA; warpgroup w reads
//     slices kt + lam and kt + lam + 1 on key tile kt, lam = 1 - w;
//   * a slice is read on two consecutive key tiles, so it is not released
//     with its K/V stage: each consumer warp arrives on its empty barrier
//     (8 arrivals) after the last tile it reads it on (release_range), and
//     on the slices it never reads (slice 0 for the first consumer
//     warpgroup, the last one for the second) after it has waited for them
//     to land, so a phase never counts an arrival meant for the slice
//     loaded next into that slot;
//   * A = Qsel E_win^T, 64 x 128 fp32, is two wgmma m64n64k16 of one
//     64-row slice each; each half takes one Qsel: Q_v where its rows of E
//     are <= T-1 (k0 - q0w + 64h <= 0), else Q_vs -- the mixed tile k0 =
//     q0w needs Q_v in half 0 and Q_vs in half 1, no select per element;
//   * the skew S[r][c] += A[r][c - r + 63] moves each row by its own
//     amount, which a register fragment cannot do. Each thread writes the
//     elements of its A fragment that fall in the band, A[r][w] with
//     0 <= w + r - 63 < 64, to band[r][w + r - 63] in shared memory (fp32,
//     row stride BAND_LD = 72), then reads band[r][c] back in its S
//     fragment's layout. The read is one float2 per column pair: a warp's
//     fragment load (8 rows x 4 column pairs) is two half-warp wavefronts
//     on distinct banks, since 72 = 8 mod 32. The skewed 4-byte writes meet
//     at most two to a bank: no linear stride avoids that, as the 32
//     writes of a warp (8 rows x 4 even columns) would need an odd row
//     step s whose multiples 0..7 s, each plus 0, 2, 4, 6, cover Z_32,
//     and the even ones cannot. The band is the only shared-memory round
//     trip; 64 x 64 fp32 = 16 KB of it per warpgroup, not the whole A;
//   * S = Q_u K^T, the online softmax, dropout and O += P V as in K1-d-90:
//     in registers, exp2 with the scale folded in, P the A operand of the
//     P.V wgmma, O in registers, and P's lo part the A operand of a second
//     P.V into an accumulator of its own; the epilogue writes O / l (bf16),
//     (O + O_lo) / l (fp32) and lse.
//
// Shared memory at d = 96: Q_u, Q_v, Q_vs 3 x 24 KB, K/V 2 stages x 24 KB,
// E 4 slices x 12 KB, the band 2 x 18 KB: 209,000 bytes of the 232,448 a
// block may have (Geom's static_assert).

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::hash_head;
using flash::keep_bit;
using namespace sm90;

constexpr int BQ = 128;          // query rows per CTA
constexpr int WG_ROWS = 64;      // query rows per consumer warpgroup
constexpr int BK = 64;           // keys per tile
constexpr int SLICE = 64;        // rows of E per slice
// a tile's window is two slices, and the warpgroups' windows one apart
static_assert(BK == SLICE && WG_ROWS == SLICE, "the window needs 64-row "
              "tiles, warpgroups and slices");
constexpr int STAGES = 2;
constexpr int E_SLOTS = 4;
constexpr int BAND_LD = 72;      // fp32 row stride of the band, 8 mod 32
constexpr int NTHREADS = 384;    // producer warpgroup + 2 consumers
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D> struct Geom {
  static constexpr int CHUNKS = D / CHUNK_COLS;
  static constexpr int Q_WG = CHUNKS * WG_ROWS * ROW_BYTES;   // one wg's Q
  static constexpr int KV_TILE = CHUNKS * BK * ROW_BYTES;     // K or V tile
  static constexpr int SLICE_BYTES = CHUNKS * SLICE * ROW_BYTES;
  static constexpr int BAND = WG_ROWS * BAND_LD * 4;
  static constexpr int OFF_QV = 2 * Q_WG;
  static constexpr int OFF_QVS = 4 * Q_WG;
  static constexpr int OFF_K = 6 * Q_WG;
  static constexpr int OFF_V = OFF_K + STAGES * KV_TILE;
  static constexpr int OFF_E = OFF_V + STAGES * KV_TILE;
  static constexpr int OFF_BAND = OFF_E + E_SLOTS * SLICE_BYTES;
  static constexpr int OFF_BAR = OFF_BAND + 2 * BAND;
  static constexpr int BYTES = OFF_BAR + (1 + 2 * STAGES + 2 * E_SLOTS) * 8;
  static constexpr int ALLOC = BYTES + 1024;        // room to align to 1024
  static_assert(ALLOC <= 232448, "more shared memory than a block may have");
  static_assert(BAND % 1024 == 0 && SLICE_BYTES % 1024 == 0,
                "tiles start on 1024-byte boundaries");
};

// The slices warpgroup w releases at the end of key tile t of n_tiles (it
// reads slices t + lam and t + lam + 1, lam = 1 - w): the one it reads for
// the last time, t + lam; on the first tile also the slices below it,
// which it never reads; on the last tile every slice up to n_tiles + 1,
// the last one loaded.
__device__ __forceinline__ void release_range(int t, int n_tiles, int lam,
                                              int& lo, int& hi) {
  lo = t == 0 ? 0 : t + lam;
  hi = t == n_tiles - 1 ? n_tiles + 1 : t + lam;
}

template <int D, bool FP32>
__global__ void __launch_bounds__(NTHREADS, 1)
relpos_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_qu,
                       const __grid_constant__ CUtensorMap tm_qv,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_e,
                       const int32_t* __restrict__ k_len,
                       bf16* __restrict__ o, float* __restrict__ o32,
                       float* __restrict__ lse, int H,
                       int T, float scale_log2, int dropout,
                       uint32_t threshold, float keep_scale, uint32_t seed,
                       int head_offset, int heads_total) {
  using G = Geom<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQu = smem;
  uint8_t* sQv = smem + G::OFF_QV;
  uint8_t* sQvs = smem + G::OFF_QVS;
  uint8_t* sK = smem + G::OFF_K;
  uint8_t* sV = smem + G::OFF_V;
  uint8_t* sE = smem + G::OFF_E;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;
  uint64_t* e_full = empty + STAGES;
  uint64_t* e_empty = e_full + E_SLOTS;

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const uint32_t hbh = hash_head(bh, H, head_offset, heads_total);
  int klen = k_len[bh / H];
  klen = klen < 0 ? 0 : (klen > T ? T : klen);
  const int n_tiles = (klen + BK - 1) / BK;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);          // one arrival per consumer warp
    }
    for (int s = 0; s < E_SLOTS; ++s) {
      mbar_init(&e_full[s], 1);
      mbar_init(&e_empty[s], 8);        // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {                        // the producer
    reg_dealloc<40>();
    if (tid == 0) {
      mbar_arrive_expect_tx(q_full, 6 * G::Q_WG);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < G::CHUNKS; ++c) {
          const int off = w * G::Q_WG + c * WG_ROWS * ROW_BYTES;
          const int row = q0 + w * WG_ROWS;
          tma_load_3d(sQu + off, &tm_qu, q_full, c * CHUNK_COLS, row, bh);
          tma_load_3d(sQv + off, &tm_qv, q_full, c * CHUNK_COLS, row, bh);
          tma_load_3d(sQvs + off, &tm_qv, q_full, c * CHUNK_COLS, row + 1,
                      bh);
        }
      const int e_row0 = T - q0 - 2 * SLICE;     // slice 0's first row
      int next = 0;                              // the next slice to load
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % STAGES, n = kt / STAGES;
        if (n > 0) mbar_wait(&empty[s], (n - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * G::KV_TILE);
        for (int c = 0; c < G::CHUNKS; ++c) {
          const int off = s * G::KV_TILE + c * BK * ROW_BYTES;
          tma_load_3d(sK + off, &tm_k, &full[s], c * CHUNK_COLS, kt * BK, bh);
          tma_load_3d(sV + off, &tm_v, &full[s], c * CHUNK_COLS, kt * BK, bh);
        }
        for (; next <= kt + 2; ++next) {         // tile kt reads up to kt+2
          const int slot = next % E_SLOTS, ne = next / E_SLOTS;
          if (ne > 0) mbar_wait(&e_empty[slot], (ne - 1) & 1);
          mbar_arrive_expect_tx(&e_full[slot], G::SLICE_BYTES);
          for (int c = 0; c < G::CHUNKS; ++c)
            tma_load_3d(sE + slot * G::SLICE_BYTES + c * SLICE * ROW_BYTES,
                        &tm_e, &e_full[slot], c * CHUNK_COLS,
                        e_row0 + next * SLICE, bh % H);
        }
      }
    }
    return;
  }

  reg_alloc<232>();
  const int w = wg - 1;
  const int lam = 1 - w;
  const int warp = tid / 32, lane = tid % 32;
  const int rloc = warp * 16 + lane / 4;           // and rloc + 8
  const int row0 = q0 + w * WG_ROWS + rloc;        // global, and row0 + 8
  const int quad_col = 2 * (lane % 4);
  const uint8_t* qu_base = sQu + w * G::Q_WG;
  const uint8_t* qv_base = sQv + w * G::Q_WG;
  const uint8_t* qvs_base = sQvs + w * G::Q_WG;
  float* band = reinterpret_cast<float*>(smem + G::OFF_BAND + w * G::BAND);

  float acc_o[D / 2], acc_lo[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_o[i] = acc_lo[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};      // running max, log2 units
  float l[2] = {0.f, 0.f};              // this thread's share of the sum

  mbar_wait(q_full, 0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int s = kt % STAGES, n = kt / STAGES;
    const int k0 = kt * BK;
    const int delta = k0 - (q0 + w * WG_ROWS);
    const uint8_t* k_tile = sK + s * G::KV_TILE;
    const uint8_t* v_tile = sV + s * G::KV_TILE;
    mbar_wait(&full[s], n & 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int sl = kt + lam + h;
      mbar_wait(&e_full[sl % E_SLOTS], (sl / E_SLOTS) & 1);
    }

    // A = Qsel E_win^T, one slice per half, and S = Q_u K^T
    float acc_a[2][SLICE / 2], acc_s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      acc_s[i] = acc_a[0][i] = acc_a[1][i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint8_t* qsel = delta + h * SLICE > 0 ? qvs_base : qv_base;
      const uint8_t* e_slice =
          sE + ((kt + lam + h) % E_SLOTS) * G::SLICE_BYTES;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 2, half = (kk % 2) * 32;
        WgmmaSS<64, 0, 0>::mma(
            acc_a[h], desc(qsel + c * WG_ROWS * ROW_BYTES + half, 16, 512),
            desc(e_slice + c * SLICE * ROW_BYTES + half, 16, 512), kk > 0);
      }
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / 2, half = (kk % 2) * 32;
      WgmmaSS<64, 0, 0>::mma(
          acc_s, desc(qu_base + c * WG_ROWS * ROW_BYTES + half, 16, 512),
          desc(k_tile + c * BK * ROW_BYTES + half, 16, 512), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_a[0]);
    fence_regs(acc_a[1]);
    fence_regs(acc_s);

    // the skew: A[r][w] to band[r][w + r - 63] where that is a column of
    // the tile; the previous tile's reads of the band are done first
    named_sync(1 + w, 128);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < SLICE / 2; ++i) {
        const int r = rloc + 8 * ((i / 2) % 2);
        const int c = h * SLICE + 8 * (i / 4) + quad_col + (i % 2) + r - 63;
        if (c >= 0 && c < BK) band[r * BAND_LD + c] = acc_a[h][i];
      }
    named_sync(1 + w, 128);
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const int r = rloc + 8 * ((i / 2) % 2);
      const float2 b = *reinterpret_cast<const float2*>(
          band + r * BAND_LD + 8 * (i / 4) + quad_col);
      acc_s[i] += b.x;
      acc_s[i + 1] += b.y;
    }

    // the online softmax over this tile, rows row0 and row0 + 8, keys
    // below k_len
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int col = k0 + 8 * (i / 4) + quad_col + (i % 2);
      const float x = acc_s[i] * scale_log2;
      acc_s[i] = col < klen ? x : NEG_INF;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], acc_s[i]);
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
    uint32_t frag[BK / 16][4], frag_lo[BK / 16][4];
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const int h = (i / 2) % 2;
      const int col = k0 + 8 * (i / 4) + quad_col;
      float p[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[e] = col + e < klen ? exp2f(acc_s[i + e] - m[h]) : 0.f;
        l[h] += p[e];
        if (dropout)
          p[e] = keep_bit(seed, hbh, (uint32_t)(row0 + 8 * h),
                          (uint32_t)(col + e), threshold)
                     ? p[e] * keep_scale : 0.f;
      }
      frag[i / 8][(i % 8) / 2] = pack_bf16(p[0], p[1]);
      if constexpr (FP32)
        frag_lo[i / 8][(i % 8) / 2] =
            pack_bf16(p[0] - __bfloat162float(__float2bfloat16_rn(p[0])),
                      p[1] - __bfloat162float(__float2bfloat16_rn(p[1])));
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      acc_o[i] *= alpha[(i / 2) % 2];
      if constexpr (FP32) acc_lo[i] *= alpha[(i / 2) % 2];
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      WgmmaRS<D, 1>::mma(acc_o, frag[kk],
                         desc(v_tile + kk * 16 * ROW_BYTES, BK * ROW_BYTES,
                              512), 1);
    if constexpr (FP32) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        WgmmaRS<D, 1>::mma(acc_lo, frag_lo[kk],
                           desc(v_tile + kk * 16 * ROW_BYTES,
                                BK * ROW_BYTES, 512), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_o);
    fence_regs(frag);
    if constexpr (FP32) {
      fence_regs(acc_lo);
      fence_regs(frag_lo);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);

    // the slices this warpgroup is done with; one it never read is waited
    // for first, so its arrival lands in that slice's phase
    int lo, hi;
    release_range(kt, n_tiles, lam, lo, hi);
    for (int sl = lo; sl <= hi; ++sl) {
      mbar_wait(&e_full[sl % E_SLOTS], (sl / E_SLOTS) & 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(&e_empty[sl % E_SLOTS]);
    }
  }

  // epilogue: o = acc / l in bf16, o32 = (acc + acc_lo) / l (FP32), lse =
  // (m + log2 l) ln 2
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const size_t base = (size_t)bh * T;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= T) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
    bf16* orow = o + (base + row) * D + quad_col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float a = acc_o[4 * j + 2 * h], b = acc_o[4 * j + 2 * h + 1];
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(a * inv, b * inv);
      if constexpr (FP32)
        *reinterpret_cast<float2*>(o32 + (base + row) * D + quad_col +
                                   8 * j) =
            make_float2((a + acc_lo[4 * j + 2 * h]) * inv,
                        (b + acc_lo[4 * j + 2 * h + 1]) * inv);
    }
    if (lane % 4 == 0)
      lse[base + row] = l[h] > 0.f ? (m[h] + log2f(l[h])) * LN2 : NEG_INF;
  }
}

template <int D, bool FP32>
int launch(const void* q_u, const void* q_v, const void* k, const void* v,
           const void* e, const int32_t* k_len, void* o, float* o32,
           float* lse, int B,
           int H, int T, float sm_scale, int dropout, uint32_t threshold,
           float keep_scale, uint32_t seed, int head_offset, int heads_total,
           cudaStream_t stream) {
  using G = Geom<D>;
  CUtensorMap tm_qu, tm_qv, tm_k, tm_v, tm_e;
  CUresult r = make_map(&tm_qu, q_u, D, T, B * H, WG_ROWS);
  if (r == CUDA_SUCCESS) r = make_map(&tm_qv, q_v, D, T, B * H, WG_ROWS);
  if (r == CUDA_SUCCESS) r = make_map(&tm_k, k, D, T, B * H, BK);
  if (r == CUDA_SUCCESS) r = make_map(&tm_v, v, D, T, B * H, BK);
  if (r == CUDA_SUCCESS) r = make_map(&tm_e, e, D, 2 * T + 1, H, SLICE);
  if (r != CUDA_SUCCESS) return MAP_ERROR + (int)r;
  cudaError_t err = cudaFuncSetAttribute(
      relpos_fwd_sm90_kernel<D, FP32>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::ALLOC);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, B * H);
  relpos_fwd_sm90_kernel<D, FP32><<<grid, NTHREADS, G::ALLOC, stream>>>(
      tm_qu, tm_qv, tm_k, tm_v, tm_e, k_len, static_cast<bf16*>(o), o32, lse,
      H, T, sm_scale * LOG2E, dropout, threshold, keep_scale, seed, head_offset,
      heads_total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q_u, q_v, k, v (B,H,T,d), e (H,2T+1,d) = [P; 0; P], o like q_u,
// o32 (B,H,T,d) fp32 or null (not written), lse (B,H,T) fp32, k_len (B,)
// int32, all contiguous on the device with 16-byte aligned bases; d in
// {64, 96}. dropout != 0 turns on the keep
// mask (K4-d) with `threshold` (int(rate * 2^32)), `keep_scale`
// (1/(1 - rate) in fp32) and `seed` (the int32 seed's bits); it hashes the
// batch-head b*heads_total + head_offset + h (flash_common.cuh
// `hash_head`). Returns the
// cudaError_t of the launch (0 = success), or MAP_ERROR + the CUresult of
// a tensor map that could not be encoded.
int flash_relpos_fwd_sm90(const void* q_u, const void* q_v, const void* k,
                          const void* v, const void* e, const void* k_len,
                          void* o, void* o32, void* lse, int B, int H,
                          int T, int d,
                          float sm_scale, int dropout, unsigned int threshold,
                          float keep_scale, unsigned int seed,
                          int head_offset, int heads_total, void* stream) {
  if (T <= 0 || B * H > 65535) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto kl = static_cast<const int32_t*>(k_len);
  auto l = static_cast<float*>(lse);
  auto o2 = static_cast<float*>(o32);
  auto run = o2 ? (d == 64 ? launch<64, true> : launch<96, true>)
                : (d == 64 ? launch<64, false> : launch<96, false>);
  if (d != 64 && d != 96) return (int)cudaErrorInvalidValue;
  return run(q_u, q_v, k, v, e, kl, o, o2, l, B, H, T, sm_scale, dropout,
             threshold, keep_scale, seed, head_offset, heads_total, s);
}

}  // extern "C"
