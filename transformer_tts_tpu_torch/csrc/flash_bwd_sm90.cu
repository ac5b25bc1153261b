// Flash-attention backward redesigned for Hopper (sm_90a): bf16, prefix key
// mask, optional causal mask, optional additive bias, optional
// attention-prob dropout -- K2, the backward of FastSpeech 2 training;
// with `causal` K3's, the backward of the AR model's training; with a
// bias K6's, which also writes dbias -- as one fused kernel.
//
// Replaces the TPU kernels `_dq_kernel` (transformer_tts_tpu/ops/
// flash_attention.py:266) and `_dkdv_kernel` (:344) driven by `_flash_bwd`
// (:417, calls :479, :520), non-causal and causal (the predicates
// :307-310 and :380-383, the block skips :329-335 and :406-407), and with
// `has_bias` (:277-281 with dbias :323-334, :349-353 and :374-375; the
// VJP `_flash_b` :585-614, non-causal only). fp32 stays on the simple pair
// of kernels, flash_attention_bwd.cu; ops/flash_attention.select_design
// picks one.
//
// What it computes is flash_attention_bwd.cu's, per batch-head bh, from the
// forward's lse and delta = rowsum(dO * O) (fp32, the torch reduction
// `bwd_delta`, as `_flash_bwd` leaves it to XLA):
//   P[r][c]  = exp((q[r].k[c] [+ bias[r][c]]) * sm_scale - lse[r])
//                                   for keys c < k_len[b] [and c <= r]
//   dP[r][c] = (dO[r] . v[c]) * keep(r, c)
//   dS[r][c] = P (dP - delta[r]) * sm_scale
//   dq = dS K,  dk = dS^T Q,  dv = (P keep)^T dO  [, dbias = dS]
// with dS and P*keep cast to bf16 before their products, as the TPU kernels
// do; dbias is that bf16 dS, the gradient of the pre-scale logits. keep(r,
// c) is the forward's hash (`keep_bit`, flash_common.cuh), rebuilt from
// the global coordinates, never stored. dk and dv are exactly 0 for keys
// at or past k_len[b] (with causal also for keys no row reaches, c >=
// T_q); query rows at or past T_q are masked. dbias is written whole,
// every element once: dS, exactly 0 for keys at or past k_len[b].
//
// dq is summed over key blocks with fp32 atomic adds into a zeroed
// (B,H,T_q,d) accumulator, which the wrapper casts to bf16: its order of
// summation changes from run to run, so dq is not deterministic in its last
// bits. dk, dv and dbias are (one CTA owns each key row's sums, and each
// (q tile, key) pair of dbias belongs to one CTA and one iteration: no
// atomics).
//
// Bound on the card: 10*B*H*(attended pairs)*d operations (five products)
// against Q, K, V, dO, dQ, dK and dV moved once -- ~300 operations a byte
// at the train step's (16, 4, 1024, 96), so the tensor cores bound it;
// causal at the AR step's T = 511 half the pairs, and the bytes do. With
// a bias the bytes do: at the conformer step's (16, 4, 1024, 96) with
// sum(k_len) = 12,951 the operations are 10*4*1024*12,951*96 =
// 50,925,404,160 (0.0515 ms), the bytes 328,917,056 (0.0982 ms): the bias
// read over the valid keys 106,094,592, dbias written whole 134,217,728,
// Q, K, V and dO 50,331,648, dq, dk and dv in bf16 37,748,736, lse and
// delta 524,288, k_len 64. The
// simple pair ran seven products per tile pair (each kernel rebuilt S and
// dP), loaded one element per thread synchronously, kept every
// accumulator in shared memory and stored P^T and dS^T with 4-way bank
// conflicts.
//
// Design:
//   * a CTA per (BK = 128 keys, bh): warpgroup 0 the producer, warpgroups
//     1 and 2 the consumers, 64 keys each. A CTA whose keys all lie at or
//     past k_len[b] writes zeros and stops;
//   * TMA loads: K and V once; then a loop over 64-row q tiles, Q and dO
//     double-buffered by TMA (64-byte swizzle, d/32 chunks), lse (times
//     log2 e) and delta for the tile's rows copied by the producer warp's
//     32 threads, which arrive on the stage's full barrier beside the TMA;
//   * per tile and consumer: S^T = K Q^T and dP^T = V dO^T by wgmma
//     m64n64k16 from shared memory (both K-major), so P^T and dS^T come
//     out with the keys as rows, which is how the next two products take
//     them; P, the keep mask and dS in registers; dV += (P keep)^T dO and
//     dK += dS^T Q by wgmma m64n{d}k16 with A in registers and dO, Q
//     MN-major from shared memory; dK and dV stay in registers;
//   * dS^T goes once to shared memory (swizzled, conflict-free 4-byte
//     stores), then dQ_partial = dS K by wgmma with both operands
//     MN-major, added into the fp32 accumulator with 8-byte atomics: five
//     products per tile pair instead of seven;
//   * bias (HAS_BIAS, a template flag: K2 and K3 compile without it):
//     each q tile's (64 rows x 128 keys) bias, two TMA boxes of 64 keys
//     (8 KB each, 128-byte swizzle), comes with its Q/dO stage on the
//     same full barrier. The accumulator holds S^T (keys as rows), so
//     each thread reads its bias transposed with ldmatrix.x4.trans, four
//     per tile, free of bank conflicts, and adds it before the scale.
//     dbias is q-major in memory: each warpgroup writes its bf16 dS
//     fragments transposed with stmatrix.x4.trans into a (64 q x 64 keys)
//     staging tile in the same swizzle, and one thread stores it with a
//     TMA store, clipped at T_q and T_k; the tile is rewritten only after
//     that store has read it (cp.async.bulk.wait_group.read). A CTA whose
//     keys all lie at or past k_len writes its T_q x 128 slab of dbias as
//     zeros with 16-byte stores. The bias needs T_k % 8 == 0 (TMA's row
//     stride); select_design sends other T_k to the simple pair. No
//     wgmma sits in a branch: the bias code is compile-time;
//   * causal: the q-tile loop starts at the tile holding row k0 (rows
//     before it see none of the CTA's keys). A warpgroup's 64 keys start
//     on a tile boundary, so its first tile is its diagonal tile, the only
//     one that needs c <= r; the second warpgroup's diagonal is one tile
//     later, and it waits for that first tile and releases it unread, so
//     every stage's empty barrier still counts its 8 warps per phase. A
//     CTA whose keys all lie at or past T_q writes zeros and stops. The
//     grid runs (bh, key block) in that order: the first key blocks, which
//     meet the most q tiles, start first.

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::keep_bit;
using namespace sm90;

constexpr int BKC = 128;         // keys per CTA
constexpr int WG_KEYS = 64;      // keys per consumer warpgroup
constexpr int BQ = 64;           // query rows per tile
// The causal mask is applied on a warpgroup's diagonal tile only: right
// while each warpgroup's keys start and end on one query tile's boundaries.
static_assert(BQ == WG_KEYS, "the causal mask needs BQ == WG_KEYS");
constexpr int STAGES = 2;
constexpr int NTHREADS = 384;
constexpr float LOG2E = 1.4426950408889634f;

// a bias tile row is one warpgroup's 64 bf16 keys: one 128-byte swizzle row
static_assert(WG_KEYS * 2 == 128, "the bias tiles need 128-byte rows");

// Shared memory at d = 96: K and V 24,576 each, Q and dO 2 x 12,288 each,
// dS^T 2 x 8,192, lse and delta 1,024, and with the bias its two stages of
// two 8,192-byte halves (32,768) and the two dbias staging tiles (16,384),
// barriers 40: 164,904 bytes, 1,024 more to align (115,752 without the
// bias).
template <int D, bool HAS_BIAS> struct Geom {
  static constexpr int CHUNKS = D / CHUNK_COLS;
  static constexpr int KV = CHUNKS * BKC * ROW_BYTES;         // K or V
  static constexpr int TILE = CHUNKS * BQ * ROW_BYTES;        // Q or dO tile
  static constexpr int DS = 2 * WG_KEYS * ROW_BYTES;          // one wg's dS^T
  // one wg's (64 q x 64 keys) bf16 bias tile, or its dbias staging tile
  static constexpr int BIAS_HALF = HAS_BIAS ? BQ * WG_KEYS * 2 : 0;
  static constexpr int OFF_V = KV;
  static constexpr int OFF_Q = 2 * KV;
  static constexpr int OFF_DO = OFF_Q + STAGES * TILE;
  static constexpr int OFF_DS = OFF_DO + STAGES * TILE;
  static constexpr int OFF_BIAS = OFF_DS + 2 * DS;            // [stage][wg]
  static constexpr int OFF_DB = OFF_BIAS + STAGES * 2 * BIAS_HALF;  // [wg]
  static constexpr int OFF_ROWS = OFF_DB + 2 * BIAS_HALF;     // lse, delta
  static constexpr int OFF_BAR = OFF_ROWS + STAGES * 2 * BQ * 4;
  static constexpr int BYTES = OFF_BAR + (1 + 2 * STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;
  static_assert(OFF_BIAS % 1024 == 0, "a swizzle period per bias row group");
};

template <int D, bool CAUSAL, bool HAS_BIAS>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_bias,
                      const __grid_constant__ CUtensorMap tm_dbias,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int32_t* __restrict__ k_len,
                      float* __restrict__ dq_acc, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, bf16* __restrict__ dbias,
                      int H, int T_q, int T_k, float sm_scale, int dropout,
                      uint32_t threshold, float keep_scale, uint32_t seed) {
  using G = Geom<D, HAS_BIAS>;
  // causal: grid (bh, key block), so the longest CTAs start first
  const int k0 = (CAUSAL ? (int)blockIdx.y : (int)blockIdx.x) * BKC;
  const int bh = CAUSAL ? (int)blockIdx.x : (int)blockIdx.y;
  int klen = k_len[bh / H];
  klen = klen < 0 ? 0 : (klen > T_k ? T_k : klen);
  const size_t kv_base = (size_t)bh * T_k;

  // no valid key, or (causal) no row that reaches one: dk = dv = 0
  if (k0 >= klen || (CAUSAL && k0 >= T_q)) {
    const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
    for (int idx = threadIdx.x; idx < BKC * D / 2; idx += NTHREADS) {
      const int r = idx / (D / 2), c = 2 * (idx % (D / 2));
      if (k0 + r < T_k) {
        const size_t at = (kv_base + k0 + r) * D + c;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) = zero;
        *reinterpret_cast<__nv_bfloat162*>(dv + at) = zero;
      }
    }
    if constexpr (HAS_BIAS) {   // dbias[:, k0 .. k0+127] = 0, 8 keys a store
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      bf16* plane = dbias + (size_t)bh * T_q * T_k;
      for (int idx = threadIdx.x; idx < T_q * (BKC / 8); idx += NTHREADS) {
        const int r = idx / (BKC / 8), c = k0 + 8 * (idx % (BKC / 8));
        if (c < T_k)
          *reinterpret_cast<uint4*>(plane + (size_t)r * T_k + c) = z;
      }
    }
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = smem;
  uint8_t* sV = smem + G::OFF_V;
  uint8_t* sQ = smem + G::OFF_Q;
  uint8_t* sDO = smem + G::OFF_DO;
  uint8_t* sDS = smem + G::OFF_DS;
  uint8_t* sBias = smem + G::OFF_BIAS;
  uint8_t* sDB = smem + G::OFF_DB;
  float* sRows = reinterpret_cast<float*>(smem + G::OFF_ROWS);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int n_qt = (T_q + BQ - 1) / BQ;
  const int it0 = CAUSAL ? k0 / BQ : 0;   // the q tile holding row k0
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);          // the producer warp's 32 threads
      mbar_init(&empty[s], 8);          // one arrival per consumer warp
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
    for (int it = it0; it < n_qt; ++it) {
      const int s = (it - it0) % STAGES, n = (it - it0) / STAGES;
      if (n > 0) mbar_wait(&empty[s], (n - 1) & 1);
      float* rows = sRows + s * 2 * BQ;
      for (int r = lane; r < BQ; r += 32) {
        const int row = it * BQ + r;
        const bool in = row < T_q;
        rows[r] = in ? lse[(size_t)bh * T_q + row] * LOG2E : 0.f;
        rows[BQ + r] = in ? delta[(size_t)bh * T_q + row] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * G::TILE + 2 * G::BIAS_HALF);
        for (int c = 0; c < G::CHUNKS; ++c) {
          const int off = s * G::TILE + c * BQ * ROW_BYTES;
          tma_load_3d(sQ + off, &tm_q, &full[s], c * CHUNK_COLS, it * BQ,
                      bh);
          tma_load_3d(sDO + off, &tm_do, &full[s], c * CHUNK_COLS, it * BQ,
                      bh);
        }
        if constexpr (HAS_BIAS)   // bias[it*BQ .. +63][k0 + 64 half .. +63]
          for (int half = 0; half < 2; ++half)
            tma_load_3d(sBias + (2 * s + half) * G::BIAS_HALF, &tm_bias,
                        &full[s], k0 + half * WG_KEYS, it * BQ, bh);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  reg_alloc<232>();
  const int w = wg - 1;
  const int warp = tid / 32;
  const int key_row = warp * 16 + lane / 4;        // in the wg's 64 keys
  const int key0 = k0 + w * WG_KEYS + key_row;     // and key0 + 8
  const int quad_col = 2 * (lane % 4);
  const uint8_t* k_wg = sK + w * WG_KEYS * ROW_BYTES;
  const uint8_t* v_wg = sV + w * WG_KEYS * ROW_BYTES;
  uint8_t* ds_wg = sDS + w * G::DS;
  uint8_t* db_wg = sDB + w * G::BIAS_HALF;
  const float scale_log2 = sm_scale * LOG2E;
  // the (q row, key chunk) of the 16-byte row this lane addresses for
  // ldmatrix/stmatrix.x4.trans in a (64 q x 64 keys) bias or dbias tile:
  // matrix lane/8 of step kk covers q rows 16kk + 8(lane/16) .. +7 and
  // keys 16 warp + 8((lane/8)%2) .. +7, which register (lane/8) of a
  // 16-q-row step of S^T's fragment holds
  const int bias_q = 8 * (lane / 16) + lane % 8;
  const int bias_col = (2 * warp + (lane / 8) % 2) * 8;

  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  // causal: this wg's first q tile is its diagonal tile, the one holding
  // row k0 + 64 w; the CTA's tiles before it are released unread
  const int first = CAUSAL ? (k0 + w * WG_KEYS) / BQ : 0;
  mbar_wait(kv_full, 0);
  for (int it = it0; it < first && it < n_qt; ++it) {
    const int s = (it - it0) % STAGES;
    mbar_wait(&full[s], ((it - it0) / STAGES) & 1);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  for (int it = first; it < n_qt; ++it) {
    const int s = (it - it0) % STAGES, n = (it - it0) / STAGES;
    const int q0 = it * BQ;
    const bool diag = CAUSAL && it == first;
    const uint8_t* q_tile = sQ + s * G::TILE;
    const uint8_t* do_tile = sDO + s * G::TILE;
    const float* rows = sRows + s * 2 * BQ;
    mbar_wait(&full[s], n & 1);

    // S^T = K Q^T and dP^T = V dO^T: rows keys, columns q rows
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / 2, half = (kk % 2) * 32;
      WgmmaSS<64, 0, 0>::mma(
          st, desc(k_wg + c * BKC * ROW_BYTES + half, 16, 512),
          desc(q_tile + c * BQ * ROW_BYTES + half, 16, 512), kk > 0);
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
    // the bias of S^T's fragment: register r of bias_frag[kk] holds st
    // elements 8kk + 2r and 8kk + 2r + 1
    uint32_t bias_frag[HAS_BIAS ? BQ / 16 : 1][4];
    if constexpr (HAS_BIAS) {
      const uint8_t* b_tile = sBias + (2 * s + w) * G::BIAS_HALF;
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        ldsm_x4_trans(bias_frag[kk],
                      b_tile + swizzled128_offset(16 * kk + bias_q,
                                                  bias_col));
    }
    wgmma_wait<1>();
    fence_regs(st);

    // P^T, then (P keep)^T and dS^T as bf16 A fragments
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = key0 + 8 * ((i / 2) % 2);
      const int qc = 8 * (i / 4) + quad_col + (i % 2);
      float x = st[i];
      if constexpr (HAS_BIAS) {
        const uint32_t pair = bias_frag[i / 8][(i % 8) / 2];
        x += i % 2 ? bf16_hi(pair) : bf16_lo(pair);
      }
      st[i] = key < klen && q0 + qc < T_q && (!diag || key <= q0 + qc)
                  ? exp2f(x * scale_log2 - rows[qc]) : 0.f;
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
          const float keep = keep_bit(seed, (uint32_t)bh, (uint32_t)(q0 + qc),
                                      (uint32_t)key, threshold)
                                 ? keep_scale : 0.f;
          dp *= keep;
          pk[e] *= keep;
        }
        ds[e] = st[i + e] * (dp - rows[BQ + qc]) * sm_scale;
      }
      frag_p[i / 8][(i % 8) / 2] = pack_bf16(pk[0], pk[1]);
      frag_ds[i / 8][(i % 8) / 2] = pack_bf16(ds[0], ds[1]);
    }

    // dV += (P keep)^T dO, dK += dS^T Q: B MN-major, 16 q rows a step
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      WgmmaRS<D, 1>::mma(acc_dv, frag_p[kk],
                         desc(do_tile + kk * 16 * ROW_BYTES, BQ * ROW_BYTES,
                              512), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      WgmmaRS<D, 1>::mma(acc_dk, frag_ds[kk],
                         desc(q_tile + kk * 16 * ROW_BYTES, BQ * ROW_BYTES,
                              512), 1);
    wgmma_commit();

    // dS^T to shared memory as [q chunk][key][32 q], swizzled; the
    // previous tile's dQ product has finished reading it in every warp
    // (and with the bias the previous tile's dbias store its staging)
    if constexpr (HAS_BIAS) {
      if (tid == 0) bulk_wait_read();
    }
    named_sync(1 + w, 128);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int kr = key_row + 8 * ((i / 2) % 2);
      const int qc = 8 * (i / 4) + quad_col;
      *reinterpret_cast<uint32_t*>(ds_wg + swizzled_offset(WG_KEYS, kr, qc)) =
          frag_ds[i / 8][(i % 8) / 2];
    }
    if constexpr (HAS_BIAS) {   // dS, q-major, for dbias
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        stsm_x4_trans(db_wg + swizzled128_offset(16 * kk + bias_q, bias_col),
                      frag_ds[kk]);
    }
    fence_proxy_async();
    named_sync(1 + w, 128);
    if constexpr (HAS_BIAS) {   // dbias[q0 .. q0+63][this wg's 64 keys]
      if (tid == 0) {
        tma_store_3d(&tm_dbias, db_wg, k0 + w * WG_KEYS, q0, bh);
        bulk_commit();
      }
    }

    // dQ_partial = dS K over this wg's 64 keys: A = dS (q rows x keys) and
    // B = K (keys x d), both MN-major, 16 keys a step
    float acc_dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_dq[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_KEYS / 16; ++kk)
      WgmmaSS<D, 1, 1>::mma(
          acc_dq, desc(ds_wg + kk * 16 * ROW_BYTES, WG_KEYS * ROW_BYTES, 512),
          desc(k_wg + kk * 16 * ROW_BYTES, BKC * ROW_BYTES, 512), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    fence_regs(acc_dq);
    fence_regs(frag_p);
    fence_regs(frag_ds);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);

    // rows of dq: 16*warp + lane/4 (+ 8) of the tile
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + warp * 16 + lane / 4 + 8 * h;
      if (row >= T_q) continue;
      float* dst = dq_acc + ((size_t)bh * T_q + row) * D + quad_col;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        atomicAdd(reinterpret_cast<float2*>(dst + 8 * j),
                  make_float2(acc_dq[4 * j + 2 * h],
                              acc_dq[4 * j + 2 * h + 1]));
    }
  }

  if constexpr (HAS_BIAS) {
    if (tid == 0) bulk_wait();   // the last dbias store, before the exit
  }

  // dK and dV rows key0, key0 + 8 in bf16
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= T_k) continue;
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

template <int D, bool CAUSAL, bool HAS_BIAS>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* dout, const float* lse, const float* delta,
           const int32_t* k_len, float* dq_acc, void* dk, void* dv,
           void* dbias, int B, int H, int T_q, int T_k, float sm_scale,
           int dropout, uint32_t threshold, float keep_scale, uint32_t seed,
           cudaStream_t stream) {
  using G = Geom<D, HAS_BIAS>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_bias{}, tm_dbias{};
  CUresult r = make_map(&tm_q, q, D, T_q, B * H, BQ);
  if (r == CUDA_SUCCESS) r = make_map(&tm_do, dout, D, T_q, B * H, BQ);
  if (r == CUDA_SUCCESS) r = make_map(&tm_k, k, D, T_k, B * H, WG_KEYS);
  if (r == CUDA_SUCCESS) r = make_map(&tm_v, v, D, T_k, B * H, WG_KEYS);
  if (HAS_BIAS && r == CUDA_SUCCESS)
    r = make_plane_map(&tm_bias, bias, T_k, T_q, B * H, BQ);
  if (HAS_BIAS && r == CUDA_SUCCESS)
    r = make_plane_map(&tm_dbias, dbias, T_k, T_q, B * H, BQ);
  if (r != CUDA_SUCCESS) return MAP_ERROR + (int)r;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_sm90_kernel<D, CAUSAL, HAS_BIAS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::ALLOC);
  if (err != cudaSuccess) return (int)err;
  const int k_blocks = (T_k + BKC - 1) / BKC;
  if (CAUSAL && k_blocks > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid = CAUSAL ? dim3(B * H, k_blocks) : dim3(k_blocks, B * H);
  flash_bwd_sm90_kernel<D, CAUSAL, HAS_BIAS>
      <<<grid, NTHREADS, G::ALLOC, stream>>>(
          tm_q, tm_k, tm_v, tm_do, tm_bias, tm_dbias, lse, delta, k_len,
          dq_acc, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
          static_cast<bf16*>(dbias), H, T_q, T_k, sm_scale, dropout,
          threshold, keep_scale, seed);
  return (int)cudaGetLastError();
}

// the instance for a mode: the bias is non-causal only (as in the JAX
// package) and needs T_k % 8 == 0 (its TMA maps' row stride)
template <int D>
int launch_mode(const void* q, const void* k, const void* v,
                const void* bias, const void* dout, const float* lse,
                const float* delta, const int32_t* k_len, float* dq_acc,
                void* dk, void* dv, void* dbias, int B, int H, int T_q,
                int T_k, float sm_scale, int dropout, uint32_t threshold,
                float keep_scale, uint32_t seed, int causal,
                cudaStream_t s) {
  if (bias != nullptr) {
    if (causal || dbias == nullptr || T_k % 8 != 0)
      return (int)cudaErrorInvalidValue;
    return launch<D, false, true>(q, k, v, bias, dout, lse, delta, k_len,
                                  dq_acc, dk, dv, dbias, B, H, T_q, T_k,
                                  sm_scale, dropout, threshold, keep_scale,
                                  seed, s);
  }
  return causal
      ? launch<D, true, false>(q, k, v, bias, dout, lse, delta, k_len, dq_acc,
                               dk, dv, dbias, B, H, T_q, T_k, sm_scale,
                               dropout, threshold, keep_scale, seed, s)
      : launch<D, false, false>(q, k, v, bias, dout, lse, delta, k_len,
                                dq_acc, dk, dv, dbias, B, H, T_q, T_k,
                                sm_scale, dropout, threshold, keep_scale,
                                seed, s);
}

}  // namespace

extern "C" {

// bf16 q, dout (B,H,T_q,d), k/v (B,H,T_k,d), fp32 lse and delta (B,H,T_q),
// int32 k_len (B,), all contiguous on the device with 16-byte aligned
// bases; d in {64, 96}. dq_acc (B,H,T_q,d) fp32 must hold zeros: the
// kernel adds dq into it. dk, dv like k, written whole. bias, nullable:
// (B,H,T_q,T_k) bf16 as flash_fwd_sm90's, with dbias like it, written
// whole. Dropout and causal arguments as flash_fwd_sm90's. Returns the
// cudaError_t of the launch (0 = success), or MAP_ERROR + the CUresult
// of a map that could not be encoded.
int flash_bwd_sm90(const void* q, const void* k, const void* v,
                   const void* bias, const void* dout, const void* lse,
                   const void* delta, const void* k_len, void* dq_acc,
                   void* dk, void* dv, void* dbias, int B, int H, int T_q,
                   int T_k, int d, float sm_scale, int dropout,
                   unsigned int threshold, float keep_scale,
                   unsigned int seed, int causal, void* stream) {
  if (T_q <= 0 || T_k <= 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto l = static_cast<const float*>(lse);
  auto dl = static_cast<const float*>(delta);
  auto kl = static_cast<const int32_t*>(k_len);
  auto acc = static_cast<float*>(dq_acc);
  if (d == 64)
    return launch_mode<64>(q, k, v, bias, dout, l, dl, kl, acc, dk, dv,
                           dbias, B, H, T_q, T_k, sm_scale, dropout,
                           threshold, keep_scale, seed, causal, s);
  if (d == 96)
    return launch_mode<96>(q, k, v, bias, dout, l, dl, kl, acc, dk, dv,
                           dbias, B, H, T_q, T_k, sm_scale, dropout,
                           threshold, keep_scale, seed, causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
