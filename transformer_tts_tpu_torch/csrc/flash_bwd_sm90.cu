// Flash-attention backward redesigned for Hopper (sm_90a): bf16, prefix key
// mask, optional causal mask, optional attention-prob dropout, no bias --
// K2, the backward of FastSpeech 2 training, and with `causal` K3's, the
// backward of the AR model's training, as one fused kernel.
//
// Replaces the TPU kernels `_dq_kernel` (transformer_tts_tpu/ops/
// flash_attention.py:266) and `_dkdv_kernel` (:344) driven by `_flash_bwd`
// (:417, calls :479, :520), non-causal and causal (the predicates
// :307-310 and :380-383, the block skips :329-335 and :406-407). The
// other modes (fp32, bias K6) stay on the simple pair of kernels,
// flash_attention_bwd.cu; ops/flash_attention.select_design picks one.
//
// What it computes is flash_attention_bwd.cu's, per batch-head bh, from the
// forward's lse and delta = rowsum(dO * O) (fp32, the torch reduction
// `bwd_delta`, as `_flash_bwd` leaves it to XLA):
//   P[r][c]  = exp(q[r].k[c] * sm_scale - lse[r])
//                                   for keys c < k_len[b] [and c <= r]
//   dP[r][c] = (dO[r] . v[c]) * keep(r, c)
//   dS[r][c] = P (dP - delta[r]) * sm_scale
//   dq = dS K,  dk = dS^T Q,  dv = (P keep)^T dO
// with dS and P*keep cast to bf16 before their products, as the TPU kernels
// do. keep(r, c) is the forward's hash (`keep_bit`, flash_common.cuh),
// rebuilt from the global coordinates, never stored. dk and dv are exactly
// 0 for keys at or past k_len[b] (with causal also for keys no row
// reaches, c >= T_q); query rows at or past T_q are masked.
//
// dq is summed over key blocks with fp32 atomic adds into a zeroed
// (B,H,T_q,d) accumulator, which the wrapper casts to bf16: its order of
// summation changes from run to run, so dq is not deterministic in its last
// bits. dk and dv are (one CTA owns each key row's sums).
//
// Bound on the card: 10*B*H*(attended pairs)*d operations (five products)
// against Q, K, V, dO, dQ, dK and dV moved once -- ~300 operations a byte
// at the train step's (16, 4, 1024, 96), so the tensor cores bound it;
// causal at the AR step's T = 511 half the pairs, and the bytes do. The
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

template <int D> struct Geom {
  static constexpr int CHUNKS = D / CHUNK_COLS;
  static constexpr int KV = CHUNKS * BKC * ROW_BYTES;         // K or V
  static constexpr int TILE = CHUNKS * BQ * ROW_BYTES;        // Q or dO tile
  static constexpr int DS = 2 * WG_KEYS * ROW_BYTES;          // one wg's dS^T
  static constexpr int OFF_V = KV;
  static constexpr int OFF_Q = 2 * KV;
  static constexpr int OFF_DO = OFF_Q + STAGES * TILE;
  static constexpr int OFF_DS = OFF_DO + STAGES * TILE;
  static constexpr int OFF_ROWS = OFF_DS + 2 * DS;            // lse, delta
  static constexpr int OFF_BAR = OFF_ROWS + STAGES * 2 * BQ * 4;
  static constexpr int BYTES = OFF_BAR + (1 + 2 * STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int32_t* __restrict__ k_len,
                      float* __restrict__ dq_acc, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int H, int T_q, int T_k,
                      float sm_scale, int dropout, uint32_t threshold,
                      float keep_scale, uint32_t seed) {
  using G = Geom<D>;
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
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = smem;
  uint8_t* sV = smem + G::OFF_V;
  uint8_t* sQ = smem + G::OFF_Q;
  uint8_t* sDO = smem + G::OFF_DO;
  uint8_t* sDS = smem + G::OFF_DS;
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
        mbar_arrive_expect_tx(&full[s], 2 * G::TILE);
        for (int c = 0; c < G::CHUNKS; ++c) {
          const int off = s * G::TILE + c * BQ * ROW_BYTES;
          tma_load_3d(sQ + off, &tm_q, &full[s], c * CHUNK_COLS, it * BQ,
                      bh);
          tma_load_3d(sDO + off, &tm_do, &full[s], c * CHUNK_COLS, it * BQ,
                      bh);
        }
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
  const float scale_log2 = sm_scale * LOG2E;

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
    wgmma_wait<1>();
    fence_regs(st);

    // P^T, then (P keep)^T and dS^T as bf16 A fragments
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = key0 + 8 * ((i / 2) % 2);
      const int qc = 8 * (i / 4) + quad_col + (i % 2);
      st[i] = key < klen && q0 + qc < T_q && (!diag || key <= q0 + qc)
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
    named_sync(1 + w, 128);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int kr = key_row + 8 * ((i / 2) % 2);
      const int qc = 8 * (i / 4) + quad_col;
      *reinterpret_cast<uint32_t*>(ds_wg + swizzled_offset(WG_KEYS, kr, qc)) =
          frag_ds[i / 8][(i % 8) / 2];
    }
    fence_proxy_async();
    named_sync(1 + w, 128);

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

template <int D, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, const int32_t* k_len,
           float* dq_acc, void* dk, void* dv, int B, int H, int T_q, int T_k,
           float sm_scale, int dropout, uint32_t threshold, float keep_scale,
           uint32_t seed, cudaStream_t stream) {
  using G = Geom<D>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  CUresult r = make_map(&tm_q, q, D, T_q, B * H, BQ);
  if (r == CUDA_SUCCESS) r = make_map(&tm_do, dout, D, T_q, B * H, BQ);
  if (r == CUDA_SUCCESS) r = make_map(&tm_k, k, D, T_k, B * H, WG_KEYS);
  if (r == CUDA_SUCCESS) r = make_map(&tm_v, v, D, T_k, B * H, WG_KEYS);
  if (r != CUDA_SUCCESS) return MAP_ERROR + (int)r;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_sm90_kernel<D, CAUSAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::ALLOC);
  if (err != cudaSuccess) return (int)err;
  const int k_blocks = (T_k + BKC - 1) / BKC;
  if (CAUSAL && k_blocks > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid = CAUSAL ? dim3(B * H, k_blocks) : dim3(k_blocks, B * H);
  flash_bwd_sm90_kernel<D, CAUSAL><<<grid, NTHREADS, G::ALLOC, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta, k_len, dq_acc,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, T_q, T_k, sm_scale,
      dropout, threshold, keep_scale, seed);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q, dout (B,H,T_q,d), k/v (B,H,T_k,d), fp32 lse and delta (B,H,T_q),
// int32 k_len (B,), all contiguous on the device with 16-byte aligned
// bases; d in {64, 96}. dq_acc (B,H,T_q,d) fp32 must hold zeros: the
// kernel adds dq into it. dk, dv like k, written whole. Dropout and
// causal arguments as flash_fwd_sm90's. Returns the cudaError_t of the
// launch (0 = success), or MAP_ERROR + the CUresult of a map that could
// not be encoded.
int flash_bwd_sm90(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   const void* k_len, void* dq_acc, void* dk, void* dv,
                   int B, int H, int T_q, int T_k, int d, float sm_scale,
                   int dropout, unsigned int threshold, float keep_scale,
                   unsigned int seed, int causal, void* stream) {
  if (T_q <= 0 || T_k <= 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto l = static_cast<const float*>(lse);
  auto dl = static_cast<const float*>(delta);
  auto kl = static_cast<const int32_t*>(k_len);
  auto acc = static_cast<float*>(dq_acc);
  if (d == 64)
    return causal
        ? launch<64, true>(q, k, v, dout, l, dl, kl, acc, dk, dv, B, H, T_q,
                           T_k, sm_scale, dropout, threshold, keep_scale,
                           seed, s)
        : launch<64, false>(q, k, v, dout, l, dl, kl, acc, dk, dv, B, H,
                            T_q, T_k, sm_scale, dropout, threshold,
                            keep_scale, seed, s);
  if (d == 96)
    return causal
        ? launch<96, true>(q, k, v, dout, l, dl, kl, acc, dk, dv, B, H, T_q,
                           T_k, sm_scale, dropout, threshold, keep_scale,
                           seed, s)
        : launch<96, false>(q, k, v, dout, l, dl, kl, acc, dk, dv, B, H,
                            T_q, T_k, sm_scale, dropout, threshold,
                            keep_scale, seed, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
