// Flash-attention forward redesigned for Hopper (sm_90a): bf16, prefix key
// mask, optional causal mask, optional attention-prob dropout, no bias --
// K1 (rate 0, FastSpeech 2 synthesis), K1-d (rate > 0, its training), and
// with `causal` K3-f (rate 0, the AR model's eval forward) and K3-d (its
// training).
//
// Replaces the TPU kernel `_fwd_kernel` (transformer_tts_tpu/ops/
// flash_attention.py:90) driven by `_flash_fwd` (:230), non-causal and
// causal (the predicate :139-142, the block skip :161-165). The other
// modes (fp32, bias K6) stay on the simple kernel, flash_attention_fwd.cu;
// ops/flash_attention.select_design picks one by an explicit rule.
//
// What it computes is flash_attention_fwd.cu's, per batch-head bh = b*H + h
// and query row r:
//   s[c]   = q[r] . k[c] * sm_scale     for keys c < k_len[b] [and c <= r]
//   o[r]   = sum_c softmax(s)[c] * keep(r, c) * v[c]        (bf16)
//   lse[r] = max_c s[c] + log(sum_c exp(s[c] - max))        (fp32)
// Keys c >= k_len[b] are excluded exactly; with `causal` also keys c > r,
// in global, top-left-aligned indices (T_q != T_k allowed). The softmax
// normaliser sums the probabilities before dropout; the unnormalised,
// running-max-relative P times the keep scale is cast to bf16 before P.V,
// as the TPU kernel does; a row with no valid key gives o = 0 and lse =
// -1e30. keep(r, c) is `keep_bit` of flash_common.cuh (the one copy of
// `_keep_mask`'s hash). Deterministic: a second call on the same inputs
// and seed gives the same bits.
//
// Bound on the card: 4*B*H*(attended pairs)*d operations against Q, K, V
// and O moved once -- at d = 96 and T ~ 1000 some 200-500 operations a
// byte, so the tensor cores bound it (0.018 ms at the B=8 / 2048-frame
// synthesis input); causal at the AR step's T = 511 half the pairs, and
// the bytes bound it. The simple kernel ran at ~2 % of that: one element
// per thread per load, synchronous, every intermediate through shared
// memory, WMMA.
//
// Design:
//   * a CTA per (128 query rows, bh): warpgroup 0 is the producer (one
//     thread starts every load, setmaxnreg gives its registers away),
//     warpgroups 1 and 2 the consumers, 64 query rows each;
//   * TMA loads: the Q tile once, then K and V in a ring of STAGES stages
//     of BK keys, one full and one empty mbarrier per stage; tiles at or
//     past k_len[b] are never loaded. Tiles are 64-byte swizzled
//     (flash_sm90.cuh), d/32 chunks of 32 columns: d = 96 takes three
//     chunks, with no padding to 128;
//   * S = Q K^T by wgmma m64n64k16 from shared memory (both K-major), the
//     fp32 accumulator in registers;
//   * the online softmax in registers, exp2 with the scale folded in: a
//     row lives in the four threads of a quad, whose max goes over two
//     shuffles; the key mask and keep_bit apply per element from its
//     global (bh, row, column); the row sum stays per thread until the end;
//   * O += P V by wgmma m64n{d}k16 with P as the A operand in registers
//     (the S accumulator's fragment is the A fragment) and V from shared
//     memory with the transpose bit (V is key-major); O stays in
//     registers (48 a thread at d = 96);
//   * causal: a warpgroup's 64 rows start on a tile boundary, so its key
//     tiles end at its diagonal tile, the only one that needs c <= r. The
//     CTA loads the tiles of its second warpgroup (one more than the
//     first's, or as many where k_len or T_q ends first); the first
//     warpgroup waits for each tile past its diagonal and releases it
//     unread, so every stage's empty barrier still counts its 8 warps per
//     phase. The grid runs (bh, q block) with the q blocks in reverse: the
//     longest CTAs start first and the short ones fill the last wave;
//   * epilogue: O / l in bf16 and lse in fp32 from registers, rows past
//     T_q masked.

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::keep_bit;
using namespace sm90;

constexpr int BQ = 128;          // query rows per CTA
constexpr int WG_ROWS = 64;      // query rows per consumer warpgroup
constexpr int BK = 64;           // keys per tile
// The causal mask is applied on a warpgroup's diagonal tile only: right
// while each warpgroup's rows start and end on one key tile's boundaries.
static_assert(BK == WG_ROWS, "the causal mask needs BK == WG_ROWS");
constexpr int STAGES = 3;
constexpr int NTHREADS = 384;    // producer warpgroup + 2 consumers
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D> struct Geom {
  static constexpr int CHUNKS = D / CHUNK_COLS;
  static constexpr int Q_WG = CHUNKS * WG_ROWS * ROW_BYTES;   // one wg's Q
  static constexpr int KV_TILE = CHUNKS * BK * ROW_BYTES;     // K or V tile
  static constexpr int OFF_K = 2 * Q_WG;
  static constexpr int OFF_V = OFF_K + STAGES * KV_TILE;
  static constexpr int OFF_BAR = OFF_V + STAGES * KV_TILE;
  static constexpr int BYTES = OFF_BAR + (1 + 2 * STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;        // room to align to 1024
};

// key tiles of consumer warpgroup w (0 or 1) of the CTA at query row q0:
// every tile below k_len; with CAUSAL only up to its diagonal tile (its 64
// rows start on a tile boundary) and no further than the tile of row
// T_q - 1. The CTA loads warpgroup 1's count, the larger.
template <bool CAUSAL>
__device__ __forceinline__ int wg_tiles(int w, int q0, int T_q, int klen) {
  const int n = (klen + BK - 1) / BK;
  if (!CAUSAL) return n;
  const int rows_end = min(q0 + (w + 1) * WG_ROWS, T_q);
  return min(n, (rows_end + BK - 1) / BK);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const int32_t* __restrict__ k_len,
                      bf16* __restrict__ o, float* __restrict__ lse, int H,
                      int T_q, int T_k, float scale_log2, int dropout,
                      uint32_t threshold, float keep_scale, uint32_t seed) {
  using G = Geom<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;
  uint8_t* sK = smem + G::OFF_K;
  uint8_t* sV = smem + G::OFF_V;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + G::OFF_BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  // causal: grid (bh, q block), the last q block (the most key tiles) first
  const int q0 =
      (CAUSAL ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.x) * BQ;
  const int bh = CAUSAL ? (int)blockIdx.x : (int)blockIdx.y;
  int klen = k_len[bh / H];
  klen = klen < 0 ? 0 : (klen > T_k ? T_k : klen);
  const int n_tiles = wg_tiles<CAUSAL>(1, q0, T_q, klen);
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);          // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {                        // the producer
    reg_dealloc<40>();
    if (tid == 0) {
      mbar_arrive_expect_tx(q_full, 2 * G::Q_WG);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < G::CHUNKS; ++c)
          tma_load_3d(sQ + w * G::Q_WG + c * WG_ROWS * ROW_BYTES, &tm_q,
                      q_full, c * CHUNK_COLS, q0 + w * WG_ROWS, bh);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % STAGES, n = kt / STAGES;
        if (n > 0) mbar_wait(&empty[s], (n - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * G::KV_TILE);
        for (int c = 0; c < G::CHUNKS; ++c) {
          const int off = s * G::KV_TILE + c * BK * ROW_BYTES;
          tma_load_3d(sK + off, &tm_k, &full[s], c * CHUNK_COLS, kt * BK, bh);
          tma_load_3d(sV + off, &tm_v, &full[s], c * CHUNK_COLS, kt * BK, bh);
        }
      }
    }
    return;
  }

  reg_alloc<232>();
  const int w = wg - 1;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = q0 + w * WG_ROWS + warp * 16 + lane / 4;  // and row0 + 8
  const int quad_col = 2 * (lane % 4);
  const uint8_t* q_base = sQ + w * G::Q_WG;
  const int my_tiles = wg_tiles<CAUSAL>(w, q0, T_q, klen);
  const int diag = (q0 + w * WG_ROWS) / BK;   // the tile of this wg's rows

  float acc_o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};      // running max, log2 units
  float l[2] = {0.f, 0.f};              // this thread's share of the sum

  mbar_wait(q_full, 0);
  for (int kt = 0; kt < my_tiles; ++kt) {
    const int s = kt % STAGES, n = kt / STAGES;
    const uint8_t* k_tile = sK + s * G::KV_TILE;
    const uint8_t* v_tile = sV + s * G::KV_TILE;
    mbar_wait(&full[s], n & 1);

    float acc_s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) acc_s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / 2, half = (kk % 2) * 32;
      WgmmaSS<64, 0, 0>::mma(
          acc_s, desc(q_base + c * WG_ROWS * ROW_BYTES + half, 16, 512),
          desc(k_tile + c * BK * ROW_BYTES + half, 16, 512), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_s);

    // the online softmax over this tile, rows row0 and row0 + 8, which
    // see the keys below lim[0] and lim[1]: k_len, and on the diagonal
    // tile with CAUSAL also c <= row
    const int k0 = kt * BK;
    int lim[2] = {klen, klen};
    if (CAUSAL && kt == diag) {
      lim[0] = min(klen, row0 + 1);
      lim[1] = min(klen, row0 + 9);
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int col = k0 + 8 * (i / 4) + quad_col + (i % 2);
      const float x = acc_s[i] * scale_log2;
      acc_s[i] = col < lim[(i / 2) % 2] ? x : NEG_INF;
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
    uint32_t frag[BK / 16][4];
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const int h = (i / 2) % 2;
      const int col = k0 + 8 * (i / 4) + quad_col;
      float p[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[e] = col + e < lim[h] ? exp2f(acc_s[i + e] - m[h]) : 0.f;
        l[h] += p[e];
        if (dropout)
          p[e] = keep_bit(seed, (uint32_t)bh, (uint32_t)(row0 + 8 * h),
                          (uint32_t)(col + e), threshold)
                     ? p[e] * keep_scale : 0.f;
      }
      frag[i / 8][(i % 8) / 2] = pack_bf16(p[0], p[1]);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_o[i] *= alpha[(i / 2) % 2];

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      WgmmaRS<D, 1>::mma(acc_o, frag[kk],
                         desc(v_tile + kk * 16 * ROW_BYTES, BK * ROW_BYTES,
                              512), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_o);
    fence_regs(frag);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  // causal: the tiles the CTA loads past this wg's diagonal (at most one),
  // released unread once loaded, so each empty barrier's phase completes
  for (int kt = my_tiles; kt < n_tiles; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // epilogue: o = acc / l in bf16, lse = (m + log2 l) ln 2
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const size_t base = (size_t)bh * T_q;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= T_q) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
    bf16* orow = o + (base + row) * D + quad_col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc_o[4 * j + 2 * h] * inv,
                                acc_o[4 * j + 2 * h + 1] * inv);
    if (lane % 4 == 0)
      lse[base + row] = l[h] > 0.f ? (m[h] + log2f(l[h])) * LN2 : NEG_INF;
  }
}

template <int D, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, const int32_t* k_len,
           void* o, float* lse, int B, int H, int T_q, int T_k,
           float sm_scale, int dropout, uint32_t threshold, float keep_scale,
           uint32_t seed, cudaStream_t stream) {
  using G = Geom<D>;
  CUtensorMap tm_q, tm_k, tm_v;
  CUresult r = make_map(&tm_q, q, D, T_q, B * H, WG_ROWS);
  if (r == CUDA_SUCCESS) r = make_map(&tm_k, k, D, T_k, B * H, BK);
  if (r == CUDA_SUCCESS) r = make_map(&tm_v, v, D, T_k, B * H, BK);
  if (r != CUDA_SUCCESS) return MAP_ERROR + (int)r;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<D, CAUSAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::ALLOC);
  if (err != cudaSuccess) return (int)err;
  const int q_blocks = (T_q + BQ - 1) / BQ;
  if (CAUSAL && q_blocks > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid = CAUSAL ? dim3(B * H, q_blocks) : dim3(q_blocks, B * H);
  flash_fwd_sm90_kernel<D, CAUSAL><<<grid, NTHREADS, G::ALLOC, stream>>>(
      tm_q, tm_k, tm_v, k_len, static_cast<bf16*>(o), lse, H, T_q, T_k,
      sm_scale * LOG2E, dropout, threshold, keep_scale, seed);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q (B,H,T_q,d), k/v (B,H,T_k,d), o like q, lse (B,H,T_q) fp32, k_len
// (B,) int32, all contiguous on the device with 16-byte aligned bases;
// d in {64, 96}. dropout != 0 turns on the keep mask with `threshold`
// (int(rate * 2^32)), `keep_scale` (1/(1 - rate) in fp32) and `seed` (the
// int32 seed's bits). causal != 0 also masks keys past the query row.
// Returns the cudaError_t of the launch (0 = success), or MAP_ERROR + the
// CUresult of a tensor map that could not be encoded.
int flash_fwd_sm90(const void* q, const void* k, const void* v,
                   const void* k_len, void* o, void* lse, int B, int H,
                   int T_q, int T_k, int d, float sm_scale, int dropout,
                   unsigned int threshold, float keep_scale,
                   unsigned int seed, int causal, void* stream) {
  if (T_q <= 0 || T_k <= 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto kl = static_cast<const int32_t*>(k_len);
  auto l = static_cast<float*>(lse);
  if (d == 64)
    return causal
        ? launch<64, true>(q, k, v, kl, o, l, B, H, T_q, T_k, sm_scale,
                           dropout, threshold, keep_scale, seed, s)
        : launch<64, false>(q, k, v, kl, o, l, B, H, T_q, T_k, sm_scale,
                            dropout, threshold, keep_scale, seed, s);
  if (d == 96)
    return causal
        ? launch<96, true>(q, k, v, kl, o, l, B, H, T_q, T_k, sm_scale,
                           dropout, threshold, keep_scale, seed, s)
        : launch<96, false>(q, k, v, kl, o, l, B, H, T_q, T_k, sm_scale,
                            dropout, threshold, keep_scale, seed, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
