// Relative-position flash-attention backward redesigned for Hopper
// (sm_90a): K5, the gradient of K4 / K4-d (flash_relpos_fwd_sm90.cu), bf16,
// as one fused kernel.
//
// Replaces the TPU kernels `_fused_bwd_kernel` (transformer_tts_tpu/ops/
// flash_relpos.py:510, call :636), `_dq_kernel` (:360, call :679) and
// `_dkdv_kernel` (:431, call :709) driven by `_relpos_bwd` (:597), whose
// dP comes back through `_dp_from_big` (:807-820). fp32 stays on the simple
// pair, flash_relpos_bwd.cu.
//
// What it computes, per batch-head bh = b*H + h, from the forward's lse and
// delta = rowsum(dO * O) (fp32, a torch reduction as for K2):
//   P[i][j]  = exp(s[i][j] - lse[i])   for keys j < k_len[b], rows i < T
//   dP[i][j] = (dO[i] . v[j]) * keep(i, j)
//   dS       = P (dP - delta[i]) * sm_scale
//   dq_u = dS K,  dk = dS^T q_u,  dv = (P keep)^T dO
// and through the bias bd[i][j] = qsel(i, m) . E[m] (m = j - i + T - 1,
// E = [P; 0; P], qsel q_v[i] for m <= T-1 and q_v[i+1] for m >= T+1;
// flash_relpos_fwd_sm90.cu):
//   dq_v[i]     += dS[i][j] E[m]   (m <= T-1)
//   dq_v[i + 1] += dS[i][j] E[m]   (m >= T+1)
//   dE[m]       += dS[i][j] qsel(i, m)
// with dE summed over the batch; the wrapper folds it into dP = dE[:T] +
// dE[T+1:]. dS and P keep are cast to bf16 before their products, as the
// TPU kernels do; keep is the forward's hash (`keep_bit`). dk and dv are
// exactly 0 for keys at or past k_len[b] (P is 0 there, and a CTA whose
// keys all lie there writes zeros and stops).
//
// dq_u, dq_v and dE are summed with fp32 atomics into zeroed accumulators
// (dE one (H, 2T+1, d) buffer that all of the batch adds into: it beat a
// (B, H, 2T+1, d) buffer summed by torch on the card, PERF.md's dE A/B),
// so their last bits vary from run to run; dk and dv do not (one CTA owns
// each key row's sums).
//
// Bound on the card: 16*H*d operations per attended (row, key) pair --
// q_u.K^T, the bias product, dO.V^T, dv, dk, dq_u, dq_v and dP, each
// 2*d -- against q_u, q_v, k, v, dO, P, lse and delta read once and the
// gradients written once: the tensor cores bound it at the train step's
// (16, 4, 1024, 96). This design does 22*H*d (the bias product, dq_v and
// dP each over the 128-row window of a 64 x 64 tile). The simple pair
// rebuilt the score and the bias in each of its two kernels, kept every
// accumulator in shared memory and added dP by 16-byte atomics from every
// block.
//
// Design (flash_bwd_sm90.cu's shape, with its helpers, flash_sm90.cuh):
//   * a CTA per (BKC = 128 keys, bh): warpgroup 0 the producer, warpgroups
//     1 and 2 the consumers, 64 keys each; K and V loaded once, then a loop
//     over 64-row q tiles whose Q_u, Q_v, Q_vs (q_v's box one row down, row
//     T zero-filled) and dO come by TMA in a ring of STAGES stages, lse
//     and delta copied by the producer warp's 32 threads;
//   * E in a ring of E_SLOTS 64-row slices: the window of (q tile q0, the
//     keys kw0 of warpgroup w) is E[kw0 - q0 + T - 64 ..+128), so a q tile
//     needs three slices for the two warpgroups and the next q tile shares
//     two of them (the windows slide down). Slice n holds E[k0 + T + 64 -
//     64n ..+64); warpgroup w reads slices it + lam and it + lam + 1 on q
//     tile it, lam = 1 - w, and releases them as the forward does
//     (release_range): each warp after its last read, a slice it never
//     reads after waiting for it to land;
//   * per tile and consumer, first the bias: A = Qsel E_win^T (rows the q
//     rows, two wgmma m64n64k16 of one slice each, each half with one
//     Qsel as in the forward) goes to a band in shared memory transposed,
//     band[c][r] = A[r][c - r + 63] (fp32, stride 72, so the read below is
//     conflict-free float2 pairs); then S^T = K Q_u^T and dP^T = V dO^T by
//     wgmma as in K2-90, S^T += band; P^T, the keep mask and dS^T in
//     registers; dV += (P keep)^T dO and dK += dS^T Q_u by wgmma with A
//     in registers, dK and dV in registers all along;
//   * dS^T to shared memory (bf16, swizzled) and dq_u partial = dS K, added
//     into dq_u's accumulator with 8-byte atomics, as K2-90 does;
//   * the adjoint of the skew: dS scattered into window coordinates, dA[r]
//     [c - r + 63] = dS[r][c], a 64 x 128 bf16 tile in the 64-byte swizzle
//     (zeroed first: half of it lies off the band). Then dq_v partial =
//     dA E_win (dA K-major, E MN-major), one product over both halves when
//     they take the same Qsel, else one per half; its rows go to dq_v row
//     q0 + r, or q0 + r + 1 for the Q_vs half -- the atomics land one row
//     down, and the wrapper adds no shifted copy. And dE_win = dA^T Qsel
//     per half (dA MN-major, Qsel MN-major), added into dE rows m0 .. m0 +
//     127 inside [0, 2T+1) with 8-byte atomics. The band, dS^T and dA take
//     turns in one buffer of each warpgroup;
//   * registers: dK and dV hold 2 x d/2 fp32 a thread; the bias window
//     never lives in registers beyond its own product's accumulator.
//
// Shared memory at d = 96: K and V 2 x 24 KB, the q-tile stages 2 x 48
// KB, E 3 slices x 12 KB, the two warpgroups' buffers 2 x 18 KB, lse and
// delta 1 KB: 222,296 bytes of the 232,448 a block may have (the
// static_assert); a fourth slice would not fit, so the next slice is
// loaded once the q tile before last is done with its slot.

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::hash_head;
using flash::keep_bit;
using namespace sm90;

constexpr int BKC = 128;         // keys per CTA
constexpr int WG_KEYS = 64;      // keys per consumer warpgroup
constexpr int BQ = 64;           // query rows per tile
constexpr int SLICE = 64;        // rows of E per slice
constexpr int WIN = 2 * SLICE;   // rows of a tile's window
static_assert(BQ == SLICE && WG_KEYS == SLICE, "the window needs 64-row "
              "tiles, warpgroups and slices");
constexpr int STAGES = 2;
constexpr int E_SLOTS = 3;
constexpr int BAND_LD = 72;      // fp32 row stride of the band, 8 mod 32
constexpr int NTHREADS = 384;
constexpr float LOG2E = 1.4426950408889634f;

template <int D> struct Geom {
  static constexpr int CHUNKS = D / CHUNK_COLS;
  static constexpr int KV = CHUNKS * BKC * ROW_BYTES;         // K or V
  static constexpr int TILE = CHUNKS * BQ * ROW_BYTES;        // a q tile
  static constexpr int SLICE_BYTES = CHUNKS * SLICE * ROW_BYTES;
  static constexpr int BAND = WG_KEYS * BAND_LD * 4;          // fp32 band
  static constexpr int DA = BQ * WIN * 2;                     // bf16 dA
  static constexpr int SCR = BAND > DA ? BAND : DA;           // per wg
  static constexpr int OFF_V = KV;
  static constexpr int OFF_Q = 2 * KV;        // stage s: Q_u, Q_v, Q_vs, dO
  static constexpr int OFF_E = OFF_Q + STAGES * 4 * TILE;
  static constexpr int OFF_SCR = OFF_E + E_SLOTS * SLICE_BYTES;
  static constexpr int OFF_ROWS = OFF_SCR + 2 * SCR;          // lse, delta
  static constexpr int OFF_BAR = OFF_ROWS + STAGES * 2 * BQ * 4;
  static constexpr int BYTES =
      OFF_BAR + (1 + 2 * STAGES + 2 * E_SLOTS) * 8;
  static constexpr int ALLOC = BYTES + 1024;
  static_assert(ALLOC <= 232448, "more shared memory than a block may have");
  static_assert(SCR % 1024 == 0 && SLICE_BYTES % 1024 == 0,
                "tiles start on 1024-byte boundaries");
};

// as flash_relpos_fwd_sm90.cu: the slices a warpgroup releases at the end
// of q tile t of n_qt
__device__ __forceinline__ void release_range(int t, int n_qt, int lam,
                                              int& lo, int& hi) {
  lo = t == 0 ? 0 : t + lam;
  hi = t == n_qt - 1 ? n_qt + 1 : t + lam;
}

template <int D>
__device__ __forceinline__ void add_rows(float* acc_base, size_t row_stride,
                                         int row, int rows, int quad_col,
                                         const float (&acc)[D / 2], int h) {
  if (row < 0 || row >= rows) return;
  float* dst = acc_base + (size_t)row * row_stride + quad_col;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    atomicAdd(reinterpret_cast<float2*>(dst + 8 * j),
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
relpos_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_qu,
                       const __grid_constant__ CUtensorMap tm_qv,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_e,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const int32_t* __restrict__ k_len,
                       float* __restrict__ dqu_acc,
                       float* __restrict__ dqv_acc,
                       float* __restrict__ de_acc, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int H, int T, float sm_scale,
                       int dropout, uint32_t threshold, float keep_scale,
                       uint32_t seed, int head_offset, int heads_total) {
  using G = Geom<D>;
  const int k0 = blockIdx.x * BKC;
  const int bh = blockIdx.y;
  const uint32_t hbh = hash_head(bh, H, head_offset, heads_total);
  int klen = k_len[bh / H];
  klen = klen < 0 ? 0 : (klen > T ? T : klen);
  const size_t kv_base = (size_t)bh * T;

  if (k0 >= klen) {                     // no valid key: dk = dv = 0
    const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
    for (int idx = threadIdx.x; idx < BKC * D / 2; idx += NTHREADS) {
      const int r = idx / (D / 2), c = 2 * (idx % (D / 2));
      if (k0 + r < T) {
        const size_t at = (kv_base + k0 + r) * D + c;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) = zero;
        *reinterpret_cast<__nv_bfloat162*>(dv + at) = zero;
      }
    }
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = smem;
  uint8_t* sV = smem + G::OFF_V;
  uint8_t* sQ = smem + G::OFF_Q;
  uint8_t* sE = smem + G::OFF_E;
  float* sRows = reinterpret_cast<float*>(smem + G::OFF_ROWS);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  uint64_t* e_full = empty + STAGES;
  uint64_t* e_empty = e_full + E_SLOTS;

  const int n_qt = (T + BQ - 1) / BQ;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);          // the producer warp's 32 threads
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
    if (tid >= 32) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * G::KV);
      for (int c = 0; c < G::CHUNKS; ++c)
        for (int half = 0; half < 2; ++half) {
          const int off = c * BKC * ROW_BYTES + half * WG_KEYS * ROW_BYTES;
          tma_load_3d(sK + off, &tm_k, kv_full, c * CHUNK_COLS,
                      k0 + half * WG_KEYS, bh);
          tma_load_3d(sV + off, &tm_v, kv_full, c * CHUNK_COLS,
                      k0 + half * WG_KEYS, bh);
        }
    }
    const int e_top = k0 + T + SLICE;   // slice n's first row: e_top - 64n
    int next = 0;                       // the next slice to load
    for (int it = 0; it < n_qt; ++it) {
      const int s = it % STAGES, n = it / STAGES;
      if (n > 0) mbar_wait(&empty[s], (n - 1) & 1);
      float* rows = sRows + s * 2 * BQ;
      for (int r = lane; r < BQ; r += 32) {
        const int row = it * BQ + r;
        const bool in = row < T;
        rows[r] = in ? lse[kv_base + row] * LOG2E : 0.f;
        rows[BQ + r] = in ? delta[kv_base + row] : 0.f;
      }
      if (lane == 0) {
        uint8_t* st = sQ + s * 4 * G::TILE;
        mbar_arrive_expect_tx(&full[s], 4 * G::TILE);
        for (int c = 0; c < G::CHUNKS; ++c) {
          const int off = c * BQ * ROW_BYTES;
          const int row = it * BQ;
          tma_load_3d(st + off, &tm_qu, &full[s], c * CHUNK_COLS, row, bh);
          tma_load_3d(st + G::TILE + off, &tm_qv, &full[s], c * CHUNK_COLS,
                      row, bh);
          tma_load_3d(st + 2 * G::TILE + off, &tm_qv, &full[s],
                      c * CHUNK_COLS, row + 1, bh);
          tma_load_3d(st + 3 * G::TILE + off, &tm_do, &full[s],
                      c * CHUNK_COLS, row, bh);
        }
        for (; next <= it + 2; ++next) {         // tile it reads up to it+2
          const int slot = next % E_SLOTS, ne = next / E_SLOTS;
          if (ne > 0) mbar_wait(&e_empty[slot], (ne - 1) & 1);
          mbar_arrive_expect_tx(&e_full[slot], G::SLICE_BYTES);
          for (int c = 0; c < G::CHUNKS; ++c)
            tma_load_3d(sE + slot * G::SLICE_BYTES + c * SLICE * ROW_BYTES,
                        &tm_e, &e_full[slot], c * CHUNK_COLS,
                        e_top - next * SLICE, bh % H);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  reg_alloc<232>();
  const int w = wg - 1;
  const int lam = 1 - w;
  const int warp = tid / 32;
  const int frow = warp * 16 + lane / 4;           // fragment row (and +8)
  const int kw0 = k0 + w * WG_KEYS;
  const int key0 = kw0 + frow;                     // and key0 + 8
  const int quad_col = 2 * (lane % 4);
  const uint8_t* k_wg = sK + w * WG_KEYS * ROW_BYTES;
  const uint8_t* v_wg = sV + w * WG_KEYS * ROW_BYTES;
  uint8_t* scr = smem + G::OFF_SCR + w * G::SCR;
  float* band = reinterpret_cast<float*>(scr);
  const float scale_log2 = sm_scale * LOG2E;
  float* de_plane = de_acc + (size_t)(bh % H) * (2 * T + 1) * D;

  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_qt; ++it) {
    const int s = it % STAGES, n = it / STAGES;
    const int q0 = it * BQ;
    const int dlt = kw0 - q0;           // this tile's k0 - q0
    const uint8_t* qu_tile = sQ + s * 4 * G::TILE;
    const uint8_t* qv_tile = qu_tile + G::TILE;
    const uint8_t* qvs_tile = qu_tile + 2 * G::TILE;
    const uint8_t* do_tile = qu_tile + 3 * G::TILE;
    const float* rows = sRows + s * 2 * BQ;
    // half h of the window: slice it + lam + 1 - h, and its Qsel
    const uint8_t* e_half[2];
    const uint8_t* qsel[2];
    int sel[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int sl = it + lam + 1 - h;
      e_half[h] = sE + (sl % E_SLOTS) * G::SLICE_BYTES;
      sel[h] = dlt + h * SLICE > 0;
      qsel[h] = sel[h] ? qvs_tile : qv_tile;
    }
    mbar_wait(&full[s], n & 1);

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int sl = it + lam + 1 - h;
      mbar_wait(&e_full[sl % E_SLOTS], (sl / E_SLOTS) & 1);
    }
    // A = Qsel E_win^T (rows the q rows), one slice per half
    {
      float acc_a[2][SLICE / 2];
#pragma unroll
      for (int i = 0; i < SLICE / 2; ++i) acc_a[0][i] = acc_a[1][i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int c = kk / 2, half = (kk % 2) * 32;
          WgmmaSS<64, 0, 0>::mma(
              acc_a[h], desc(qsel[h] + c * BQ * ROW_BYTES + half, 16, 512),
              desc(e_half[h] + c * SLICE * ROW_BYTES + half, 16, 512),
              kk > 0);
        }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_a[0]);
      fence_regs(acc_a[1]);
      // band[c][r] = A[r][c - r + 63]; the buffer's last use (the
      // previous tile's dA products) is done in every warp first
      named_sync(1 + w, 128);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < SLICE / 2; ++i) {
          const int r = frow + 8 * ((i / 2) % 2);
          const int c =
              h * SLICE + 8 * (i / 4) + quad_col + (i % 2) + r - 63;
          if (c >= 0 && c < WG_KEYS) band[c * BAND_LD + r] = acc_a[h][i];
        }
      named_sync(1 + w, 128);
    }

    // S^T = K Q_u^T and dP^T = V dO^T: rows keys, columns q rows
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / 2, half = (kk % 2) * 32;
      WgmmaSS<64, 0, 0>::mma(
          st, desc(k_wg + c * BKC * ROW_BYTES + half, 16, 512),
          desc(qu_tile + c * BQ * ROW_BYTES + half, 16, 512), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / 2, half = (kk % 2) * 32;
      WgmmaSS<64, 0, 0>::mma(
          dpt, desc(v_wg + c * BKC * ROW_BYTES + half, 16, 512),
          desc(do_tile + c * BQ * ROW_BYTES + half, 16, 512), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    // S^T += the bias, then P^T
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int kr = frow + 8 * ((i / 2) % 2);
      const float2 b = *reinterpret_cast<const float2*>(
          band + kr * BAND_LD + 8 * (i / 4) + quad_col);
      st[i] += b.x;
      st[i + 1] += b.y;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = key0 + 8 * ((i / 2) % 2);
      const int qc = 8 * (i / 4) + quad_col + (i % 2);
      st[i] = key < klen && q0 + qc < T
                  ? exp2f(st[i] * scale_log2 - rows[qc]) : 0.f;
    }
    wgmma_wait<0>();
    fence_regs(dpt);
    uint32_t frag_p[4][4], frag_ds[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int key = key0 + 8 * ((i / 2) % 2);
      float pk[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = 8 * (i / 4) + quad_col + (i % 2) + e;
        float dp = dpt[i + e];
        pk[e] = st[i + e];
        if (dropout) {
          const float keep =
              keep_bit(seed, hbh, (uint32_t)(q0 + qc),
                       (uint32_t)key, threshold) ? keep_scale : 0.f;
          dp *= keep;
          pk[e] *= keep;
        }
        ds[e] = st[i + e] * (dp - rows[BQ + qc]) * sm_scale;
      }
      frag_p[i / 8][(i % 8) / 2] = pack_bf16(pk[0], pk[1]);
      frag_ds[i / 8][(i % 8) / 2] = pack_bf16(ds[0], ds[1]);
    }

    // dV += (P keep)^T dO, dK += dS^T Q_u: B MN-major, 16 q rows a step
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      WgmmaRS<D, 1>::mma(acc_dv, frag_p[kk],
                         desc(do_tile + kk * 16 * ROW_BYTES,
                              BQ * ROW_BYTES, 512), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      WgmmaRS<D, 1>::mma(acc_dk, frag_ds[kk],
                         desc(qu_tile + kk * 16 * ROW_BYTES,
                              BQ * ROW_BYTES, 512), 1);
    wgmma_commit();

    // dS^T to the buffer as [q chunk][key][32 q], swizzled, once every
    // warp has read its band
    named_sync(1 + w, 128);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int kr = frow + 8 * ((i / 2) % 2);
      const int qc = 8 * (i / 4) + quad_col;
      *reinterpret_cast<uint32_t*>(scr +
                                   swizzled_offset(WG_KEYS, kr, qc)) =
          frag_ds[i / 8][(i % 8) / 2];
    }
    fence_proxy_async();
    named_sync(1 + w, 128);

    // dq_u partial = dS K: A = dS (q rows x keys), B = K, both MN-major
    {
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_KEYS / 16; ++kk)
        WgmmaSS<D, 1, 1>::mma(
            acc, desc(scr + kk * 16 * ROW_BYTES, WG_KEYS * ROW_BYTES, 512),
            desc(k_wg + kk * 16 * ROW_BYTES, BKC * ROW_BYTES, 512),
            kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
      fence_regs(acc);
      fence_regs(frag_p);
      fence_regs(frag_ds);
      float* dq_plane = dqu_acc + kv_base * D;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        add_rows<D>(dq_plane, D, q0 + frow + 8 * h, T, quad_col, acc, h);
    }

    // dA[r][c - r + 63] = dS[r][c] (64 q rows x 128 window columns, bf16,
    // [w chunk][row][32 w] swizzled), zero off the band
    named_sync(1 + w, 128);           // the dq_u product has read dS^T
    {
      uint4* z = reinterpret_cast<uint4*>(scr);
#pragma unroll
      for (int j = 0; j < G::DA / 16 / 128; ++j)
        z[tid + 128 * j] = make_uint4(0u, 0u, 0u, 0u);
    }
    named_sync(1 + w, 128);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int kr = frow + 8 * ((i / 2) % 2);
      const uint32_t pair = frag_ds[i / 8][(i % 8) / 2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = 8 * (i / 4) + quad_col + e;
        const uint16_t bits = (uint16_t)(e ? pair >> 16 : pair & 0xFFFFu);
        *reinterpret_cast<uint16_t*>(
            scr + swizzled_offset(BQ, qc, kr - qc + 63)) = bits;
      }
    }
    fence_proxy_async();
    named_sync(1 + w, 128);

    // dq_v partial = dA E_win, a half at a time into one accumulator: on
    // the mixed tile (the halves take different queries) half 0 is added
    // before half 1 overwrites it, else the two are summed; the Q_vs
    // half's rows belong to q_v one row down. Every product is issued
    // whatever the case, so no wgmma sits in a branch.
    {
      const bool mixed = sel[0] != sel[1];
      float* dq_plane = dqv_acc + kv_base * D;
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < SLICE / 16; ++kk) {
          const int kg = h * (SLICE / 16) + kk;
          WgmmaSS<D, 0, 1>::mma(
              acc,
              desc(scr + (kg / 2) * BQ * ROW_BYTES + (kg % 2) * 32, 16,
                   512),
              desc(e_half[h] + kk * 16 * ROW_BYTES, SLICE * ROW_BYTES,
                   512),
              kk > 0 || (h == 1 && !mixed));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        if (h == 1 || mixed) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            add_rows<D>(dq_plane, D, q0 + frow + 8 * hh + sel[h], T,
                        quad_col, acc, hh);
        }
      }
    }

    // dE_win = dA^T Qsel per half: A = dA^T (window rows x q rows) and
    // B = Qsel (q rows x d), both MN-major
    const int m0 = dlt + T - 64;     // the window's first row of E
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        WgmmaSS<D, 1, 1>::mma(
            acc,
            desc(scr + 2 * h * BQ * ROW_BYTES + kk * 16 * ROW_BYTES,
                 BQ * ROW_BYTES, 512),
            desc(qsel[h] + kk * 16 * ROW_BYTES, BQ * ROW_BYTES, 512),
            kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        add_rows<D>(de_plane, D, m0 + h * SLICE + frow + 8 * hh,
                    2 * T + 1, quad_col, acc, hh);
    }

    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    int lo, hi;
    release_range(it, n_qt, lam, lo, hi);
    for (int sl = lo; sl <= hi; ++sl) {
      mbar_wait(&e_full[sl % E_SLOTS], (sl / E_SLOTS) & 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(&e_empty[sl % E_SLOTS]);
    }
  }

  // dK and dV rows key0, key0 + 8 in bf16
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= T) continue;
    const size_t at = (kv_base + key) * D + quad_col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
          __floats2bfloat162_rn(acc_dk[4 * j + 2 * h],
                                acc_dk[4 * j + 2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
          __floats2bfloat162_rn(acc_dv[4 * j + 2 * h],
                                acc_dv[4 * j + 2 * h + 1]);
    }
  }
}

template <int D>
int launch(const void* q_u, const void* q_v, const void* k, const void* v,
           const void* e, const void* dout, const float* lse,
           const float* delta, const int32_t* k_len, float* dqu_acc,
           float* dqv_acc, float* de_acc, void* dk, void* dv, int B, int H,
           int T, float sm_scale, int dropout, uint32_t threshold,
           float keep_scale, uint32_t seed, int head_offset, int heads_total,
           cudaStream_t stream) {
  using G = Geom<D>;
  CUtensorMap tm_qu, tm_qv, tm_k, tm_v, tm_do, tm_e;
  CUresult r = make_map(&tm_qu, q_u, D, T, B * H, BQ);
  if (r == CUDA_SUCCESS) r = make_map(&tm_qv, q_v, D, T, B * H, BQ);
  if (r == CUDA_SUCCESS) r = make_map(&tm_do, dout, D, T, B * H, BQ);
  if (r == CUDA_SUCCESS) r = make_map(&tm_k, k, D, T, B * H, WG_KEYS);
  if (r == CUDA_SUCCESS) r = make_map(&tm_v, v, D, T, B * H, WG_KEYS);
  if (r == CUDA_SUCCESS) r = make_map(&tm_e, e, D, 2 * T + 1, H, SLICE);
  if (r != CUDA_SUCCESS) return MAP_ERROR + (int)r;
  cudaError_t err = cudaFuncSetAttribute(
      relpos_bwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::ALLOC);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BKC - 1) / BKC, B * H);
  relpos_bwd_sm90_kernel<D><<<grid, NTHREADS, G::ALLOC, stream>>>(
      tm_qu, tm_qv, tm_k, tm_v, tm_do, tm_e, lse, delta, k_len, dqu_acc,
      dqv_acc, de_acc, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, T,
      sm_scale, dropout, threshold, keep_scale, seed, head_offset,
      heads_total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q_u, q_v, k, v, dout (B,H,T,d) and e (H,2T+1,d) = [P; 0; P], fp32
// lse and delta (B,H,T), int32 k_len (B,), all contiguous on the device
// with 16-byte aligned bases; d in {64, 96}. dqu_acc and dqv_acc (B,H,T,d)
// fp32 and de_acc (H,2T+1,d) fp32 must hold zeros: the kernel adds into
// them. dk, dv like k,
// written whole. Dropout and head arguments as flash_relpos_fwd_sm90's. Returns the
// cudaError_t of the launch (0 = success), or MAP_ERROR + the CUresult of a
// map that could not be encoded.
int flash_relpos_bwd_sm90(const void* q_u, const void* q_v, const void* k,
                          const void* v, const void* e, const void* dout,
                          const void* lse, const void* delta,
                          const void* k_len, void* dqu_acc, void* dqv_acc,
                          void* de_acc, void* dk, void* dv, int B, int H,
                          int T, int d, float sm_scale, int dropout,
                          unsigned int threshold, float keep_scale,
                          unsigned int seed, int head_offset,
                          int heads_total, void* stream) {
  if (T <= 0 || B * H > 65535) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto l = static_cast<const float*>(lse);
  auto dl = static_cast<const float*>(delta);
  auto kl = static_cast<const int32_t*>(k_len);
  auto aqu = static_cast<float*>(dqu_acc);
  auto aqv = static_cast<float*>(dqv_acc);
  auto ae = static_cast<float*>(de_acc);
  if (d == 64)
    return launch<64>(q_u, q_v, k, v, e, dout, l, dl, kl, aqu, aqv, ae, dk,
                      dv, B, H, T, sm_scale, dropout, threshold,
                      keep_scale, seed, head_offset, heads_total, s);
  if (d == 96)
    return launch<96>(q_u, q_v, k, v, e, dout, l, dl, kl, aqu, aqv, ae, dk,
                      dv, B, H, T, sm_scale, dropout, threshold,
                      keep_scale, seed, head_offset, heads_total, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
