// Flash-attention forward redesigned for Hopper (sm_90a): bf16, prefix key
// mask, optional causal mask, optional additive bias, optional
// attention-prob dropout -- K1 (rate 0, FastSpeech 2 synthesis), K1-d
// (rate > 0, its training); with `causal` K3-f (rate 0, the AR model's
// eval forward) and K3-d (its training); with a bias K6 (rate 0) and K6-d.
//
// Replaces the TPU kernel `_fwd_kernel` (transformer_tts_tpu/ops/
// flash_attention.py:90) driven by `_flash_fwd` (:230), non-causal and
// causal (the predicate :139-142, the block skip :161-165), and with
// `has_bias` (:101-106, :132-134; `flash_attention_with_bias` :655-677,
// non-causal only). fp32 stays on the simple kernel,
// flash_attention_fwd.cu; ops/flash_attention.select_design picks one by
// an explicit rule.
//
// What it computes is flash_attention_fwd.cu's, per batch-head bh = b*H + h
// and query row r:
//   s[c]   = (q[r] . k[c] [+ bias[r][c]]) * sm_scale
//                                       for keys c < k_len[b] [and c <= r]
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
// the bytes bound it. With a bias the bytes bound it too: the bias read
// over the valid keys, 2*H*T_q*sum(k_len) bytes, is 106 MB of the 157 MB
// at the conformer step's (16, 4, 1024, 96), sum(k_len) = 12,951 -- 0.0468
// ms against 0.0206 ms of operations. The simple kernel ran at 1-3 % of
// these bounds: one element per thread per load, synchronous, every
// intermediate through shared memory, WMMA.
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
//   * bias (HAS_BIAS, a template flag: K1 and K3 compile without it): the
//     (128 rows x 64 keys) bias tile, 16 KB, comes by TMA with its K/V
//     stage, on the same full barrier, in the 128-byte swizzle
//     (flash_sm90.cuh); each thread takes its own elements of S's
//     fragment -- rows row0 and row0 + 8, two adjacent keys per quad
//     thread -- with four ldmatrix.x4 per tile, free of bank conflicts,
//     and adds them to S in fp32 before the scale. The bias's row stride
//     must be a multiple of 16 bytes for TMA (T_k % 8 == 0):
//     select_design sends other T_k to the simple kernel;
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

// a bias tile row is BK bf16 keys: one 128-byte swizzle row
static_assert(BK * 2 == 128, "the bias tile needs 128-byte rows");

// Shared memory at d = 96: Q 24,576 + K and V 3 x 12,288 each + (with the
// bias) 3 x 16,384 + barriers = 147,512 bytes, 1,024 more to align.
template <int D, bool HAS_BIAS> struct Geom {
  static constexpr int CHUNKS = D / CHUNK_COLS;
  static constexpr int Q_WG = CHUNKS * WG_ROWS * ROW_BYTES;   // one wg's Q
  static constexpr int KV_TILE = CHUNKS * BK * ROW_BYTES;     // K or V tile
  static constexpr int BIAS_TILE = HAS_BIAS ? BQ * BK * 2 : 0;
  static constexpr int OFF_K = 2 * Q_WG;
  static constexpr int OFF_V = OFF_K + STAGES * KV_TILE;
  static constexpr int OFF_BIAS = OFF_V + STAGES * KV_TILE;
  static constexpr int OFF_BAR = OFF_BIAS + STAGES * BIAS_TILE;
  static constexpr int BYTES = OFF_BAR + (1 + 2 * STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;        // room to align to 1024
  static_assert(OFF_BIAS % 1024 == 0, "a swizzle period per bias row group");
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

template <int D, bool CAUSAL, bool HAS_BIAS>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_bias,
                      const int32_t* __restrict__ k_len,
                      bf16* __restrict__ o, float* __restrict__ lse, int H,
                      int T_q, int T_k, float scale_log2, int dropout,
                      uint32_t threshold, float keep_scale, uint32_t seed) {
  using G = Geom<D, HAS_BIAS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;
  uint8_t* sK = smem + G::OFF_K;
  uint8_t* sV = smem + G::OFF_V;
  uint8_t* sBias = smem + G::OFF_BIAS;
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
        mbar_arrive_expect_tx(&full[s], 2 * G::KV_TILE + G::BIAS_TILE);
        for (int c = 0; c < G::CHUNKS; ++c) {
          const int off = s * G::KV_TILE + c * BK * ROW_BYTES;
          tma_load_3d(sK + off, &tm_k, &full[s], c * CHUNK_COLS, kt * BK, bh);
          tma_load_3d(sV + off, &tm_v, &full[s], c * CHUNK_COLS, kt * BK, bh);
        }
        if constexpr (HAS_BIAS)    // bias[q0 .. q0+127][kt*BK .. +63]
          tma_load_3d(sBias + s * G::BIAS_TILE, &tm_bias, &full[s], kt * BK,
                      q0, bh);
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
  // the bias row whose 16-byte piece this lane addresses for ldmatrix:
  // matrix lane/8 holds rows +8*((lane/8)%2) and key chunk +(lane/16)
  const int bias_row = w * WG_ROWS + warp * 16 + 8 * ((lane / 8) % 2) +
                       lane % 8;

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
    // the bias of S's fragment: register r of bias_frag[kk] holds acc_s
    // elements 8kk + 2r and 8kk + 2r + 1 (rows row0 + 8(r%2), keys
    // 16kk + 8(r/2) + quad_col and the next)
    uint32_t bias_frag[HAS_BIAS ? BK / 16 : 1][4];
    if constexpr (HAS_BIAS) {
      const uint8_t* b_tile = sBias + s * G::BIAS_TILE;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        ldsm_x4(bias_frag[kk],
                b_tile + swizzled128_offset(bias_row,
                                            (2 * kk + lane / 16) * 8));
    }
    wgmma_wait<0>();
    fence_regs(acc_s);
    if constexpr (HAS_BIAS) {
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const uint32_t pair = bias_frag[i / 8][(i % 8) / 2];
        acc_s[i] += bf16_lo(pair);
        acc_s[i + 1] += bf16_hi(pair);
      }
    }

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

template <int D, bool CAUSAL, bool HAS_BIAS>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const int32_t* k_len, void* o, float* lse, int B, int H, int T_q,
           int T_k, float sm_scale, int dropout, uint32_t threshold,
           float keep_scale, uint32_t seed, cudaStream_t stream) {
  using G = Geom<D, HAS_BIAS>;
  CUtensorMap tm_q, tm_k, tm_v, tm_bias{};
  CUresult r = make_map(&tm_q, q, D, T_q, B * H, WG_ROWS);
  if (r == CUDA_SUCCESS) r = make_map(&tm_k, k, D, T_k, B * H, BK);
  if (r == CUDA_SUCCESS) r = make_map(&tm_v, v, D, T_k, B * H, BK);
  if (HAS_BIAS && r == CUDA_SUCCESS)
    r = make_plane_map(&tm_bias, bias, T_k, T_q, B * H, BQ);
  if (r != CUDA_SUCCESS) return MAP_ERROR + (int)r;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<D, CAUSAL, HAS_BIAS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::ALLOC);
  if (err != cudaSuccess) return (int)err;
  const int q_blocks = (T_q + BQ - 1) / BQ;
  if (CAUSAL && q_blocks > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid = CAUSAL ? dim3(B * H, q_blocks) : dim3(q_blocks, B * H);
  flash_fwd_sm90_kernel<D, CAUSAL, HAS_BIAS>
      <<<grid, NTHREADS, G::ALLOC, stream>>>(
          tm_q, tm_k, tm_v, tm_bias, k_len, static_cast<bf16*>(o), lse, H,
          T_q, T_k, sm_scale * LOG2E, dropout, threshold, keep_scale, seed);
  return (int)cudaGetLastError();
}

// the instance for a mode: the bias is non-causal only (as in the JAX
// package) and needs T_k % 8 == 0 (its TMA map's row stride)
template <int D>
int launch_mode(const void* q, const void* k, const void* v,
                const void* bias, const int32_t* k_len, void* o, float* lse,
                int B, int H, int T_q, int T_k, float sm_scale, int dropout,
                uint32_t threshold, float keep_scale, uint32_t seed,
                int causal, cudaStream_t s) {
  if (bias != nullptr) {
    if (causal || T_k % 8 != 0) return (int)cudaErrorInvalidValue;
    return launch<D, false, true>(q, k, v, bias, k_len, o, lse, B, H, T_q,
                                  T_k, sm_scale, dropout, threshold,
                                  keep_scale, seed, s);
  }
  return causal
      ? launch<D, true, false>(q, k, v, bias, k_len, o, lse, B, H, T_q, T_k,
                               sm_scale, dropout, threshold, keep_scale,
                               seed, s)
      : launch<D, false, false>(q, k, v, bias, k_len, o, lse, B, H, T_q, T_k,
                                sm_scale, dropout, threshold, keep_scale,
                                seed, s);
}

}  // namespace

extern "C" {

// bf16 q (B,H,T_q,d), k/v (B,H,T_k,d), o like q, lse (B,H,T_q) fp32, k_len
// (B,) int32, all contiguous on the device with 16-byte aligned bases;
// d in {64, 96}. bias, nullable: (B,H,T_q,T_k) bf16 added to q.k before
// the scale, non-causal only, T_k % 8 == 0. dropout != 0 turns on the
// keep mask with `threshold` (int(rate * 2^32)), `keep_scale` (1/(1 -
// rate) in fp32) and `seed` (the int32 seed's bits). causal != 0 also
// masks keys past the query row. Returns the cudaError_t of the launch
// (0 = success), or MAP_ERROR + the CUresult of a tensor map that could
// not be encoded.
int flash_fwd_sm90(const void* q, const void* k, const void* v,
                   const void* bias, const void* k_len, void* o, void* lse,
                   int B, int H, int T_q, int T_k, int d, float sm_scale,
                   int dropout, unsigned int threshold, float keep_scale,
                   unsigned int seed, int causal, void* stream) {
  if (T_q <= 0 || T_k <= 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto kl = static_cast<const int32_t*>(k_len);
  auto l = static_cast<float*>(lse);
  if (d == 64)
    return launch_mode<64>(q, k, v, bias, kl, o, l, B, H, T_q, T_k,
                           sm_scale, dropout, threshold, keep_scale, seed,
                           causal, s);
  if (d == 96)
    return launch_mode<96>(q, k, v, bias, kl, o, l, B, H, T_q, T_k,
                           sm_scale, dropout, threshold, keep_scale, seed,
                           causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
