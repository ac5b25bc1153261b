// Flash-attention forward for Hopper (sm_90a): prefix key mask, optionally
// causal, optionally with an additive bias.
//
// Replaces the TPU kernel `_fwd_kernel` driven by `_flash_fwd`
// (transformer_tts_tpu/ops/flash_attention.py:90-263): without a bias K1
// (no dropout, the path FastSpeech 2 synthesis runs), K1-d (attention-prob
// dropout, the path its training runs) and, with `causal`, K3's forward
// (the AR Transformer-TTS decoder's masked self-attention in training:
// K3-d with dropout, K3-f without); with a bias, K6 and K6-d (`has_bias`,
// :101-106 and :132-134, called at :230 with the bias spec :224-227; the
// public op `flash_attention_with_bias`, :655-677, non-causal).
//
// What it computes, per batch-head bh = b*H + h and query row r:
//   s[c]   = (q[r] . k[c] + bias[r][c]) * sm_scale   for keys c < k_len[b]
//                                             (and c <= r when causal)
//   o[r]   = sum_c softmax(s)[c] * keep(r, c) * v[c]   (input dtype)
//   lse[r] = max_c s[c] + log(sum_c exp(s[c] - max))   (fp32)
// bias (B,H,T_q,T_k) in the inputs' dtype is added in fp32 BEFORE the
// scale, as the TPU kernel and the reference's (ac + bd) / sqrt(d_k) do;
// without one it is 0. Keys c >= k_len[b] are excluded exactly. A row with
// no valid key gives o = 0 and lse = -1e30 + log(1), as the TPU kernel
// does.
//
// Dropout (`_keep_mask`, :59-87): keep(r, c) is 1/(1 - rate) or 0 from a
// murmur3 fmix32 hash of seed + bh*0x9E3779B9 + r*0x85EBCA6B +
// c*0xC2B2AE35 (global positions, uint32 arithmetic), kept iff the hash is
// >= int(rate * 2^32). The softmax normaliser sums the probabilities before
// dropout; only the numerator's P is dropped, and in bf16 P times the keep
// scale is cast to bf16 before P.V as without dropout. With dropout off the
// kernel takes the K1 code path unchanged.
//
// Causal (K3): the mask is c <= r in global, top-left-aligned indices (row
// r of q against key c of k, T_q != T_k allowed), as the TPU kernel's
// `col <= row`; each row compares its own global index q0 + row. The key
// tile loop stops after the tile holding key q0 + BQ - 1, the TPU kernel's
// block skip (:161-165); tiles past it hold no key any row of the block
// sees. A padded query row (r >= k_len) still sees every valid key.
//
// Bound on the card: 4*B*H*T_q*T_k*d operations against Q, K, V and O read
// or written once (causal: 4*H*d per valid (row, key) pair, about half).
// At the synthesis shapes (d = 96, T = 768..2048) that is ~1 byte per
// 200..500 operations in bf16, so the tensor cores bound it. K6 also reads
// the bias over the valid keys, T_q*k_len elements per batch-head, which
// outweighs Q, K, V and O together at T = 1024 and d = 96: bytes bound K6.
//
// Design (simple first version; wgmma, TMA and warp specialisation come
// later):
//   * one 128-thread block per (64-row q tile, bh); a loop over 64-row k
//     tiles takes the place of the TPU kernel's sequential k grid axis;
//   * the q tile, each k/v tile, the score tile S, the probability tile P
//     and the fp32 output accumulator live in shared memory;
//   * the two products, the tile loads and the dropout hash come from
//     flash_common.cuh, shared with the backward: WMMA for bf16 (P cast to
//     bf16 before P.V like the TPU kernel), FMAs for fp32 so the result
//     matches the fp32 reference to rounding;
//   * K6 adds each bias tile into S in shared memory right after Q K^T
//     (`add_bias`: 16-byte loads where aligned, each bias element read
//     once), so the softmax pass is K1's;
//   * running max, running sum and accumulator are fp32; k tiles at or past
//     k_len are skipped since they contribute nothing (nor is their bias
//     read); the ragged edges in T_q, T_k and d are masked in the loads and
//     stores, with no padding copies in device memory.

#include "flash_common.cuh"

namespace {

using flash::add_bias;
using flash::from_float;
using flash::hash_head;
using flash::keep_bit;
using flash::load_tile;
using flash::NTHREADS;
using flash::Products;
using flash::round_up;

constexpr int BQ = flash::BT;   // query rows per block
constexpr int BK = flash::BT;   // keys per k tile
constexpr float NEG_INF = -1e30f;

// Shared-memory geometry, identical on host and device.
//   dp   : depth padded for the products (16 for WMMA, 1 for FMAs)
//   ld_in: row stride of the q/k/v tiles (elements of T)
//   ld_s : row stride of the fp32 S tile, reused for the P.V tile
//   ld_p : row stride of the P tile (elements of T)
//   ld_o : row stride of the fp32 accumulator
template <typename T> struct Geom {
  int dp, ld_in, ld_s, ld_p, ld_o;
  size_t off_k, off_v, off_s, off_p, off_o, off_stats, bytes;
  __host__ __device__ explicit Geom(int d) {
    const bool wmma = sizeof(T) == 2;
    dp = wmma ? round_up(d, 16) : d;
    // WMMA wants a stride that is a multiple of 8 (16-bit) or 4 (fp32);
    // the FMA path wants an odd stride so that rows fall in other banks.
    ld_in = wmma ? dp + 8 : d + 1;
    int s_cols = dp > BK ? dp : BK;
    ld_s = wmma ? s_cols + 4 : s_cols + 1;
    ld_p = wmma ? BK + 8 : BK + 1;
    ld_o = d + 1;
    size_t in_bytes = round_up(BQ * ld_in * (int)sizeof(T), 128);
    off_k = in_bytes;
    off_v = off_k + in_bytes;
    off_s = off_v + in_bytes;
    off_p = off_s + round_up(BQ * ld_s * 4, 128);
    off_o = off_p + round_up(BQ * ld_p * (int)sizeof(T), 128);
    off_stats = off_o + round_up(BQ * ld_o * 4, 128);
    bytes = off_stats + 3 * BQ * 4;
  }
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ bias,
                 const int32_t* __restrict__ k_len,
                 T* __restrict__ o, float* __restrict__ lse, int H, int T_q,
                 int T_k, int d, float sm_scale, int dropout,
                 uint32_t threshold, float keep_scale, uint32_t seed,
                 int causal, int head_offset, int heads_total) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Geom<T> g(d);
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = reinterpret_cast<T*>(smem + g.off_k);
  T* sV = reinterpret_cast<T*>(smem + g.off_v);
  float* sS = reinterpret_cast<float*>(smem + g.off_s);
  T* sP = reinterpret_cast<T*>(smem + g.off_p);
  float* sO = reinterpret_cast<float*>(smem + g.off_o);
  float* sM = reinterpret_cast<float*>(smem + g.off_stats);
  float* sL = sM + BQ;
  float* sAlpha = sL + BQ;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const uint32_t hbh = hash_head(bh, H, head_offset, heads_total);
  int klen = k_len[bh / H];
  klen = klen < 0 ? 0 : (klen > T_k ? T_k : klen);

  const T* qb = q + (size_t)bh * T_q * d;
  const T* kb = k + (size_t)bh * T_k * d;
  const T* vb = v + (size_t)bh * T_k * d;
  const T* bb = bias ? bias + (size_t)bh * T_q * T_k : nullptr;

  load_tile(sQ, g.ld_in, qb, q0, T_q, d, g.dp);
  for (int idx = tid; idx < BQ * d; idx += NTHREADS) {
    const int r = idx / d, c = idx - r * d;
    sO[r * g.ld_o + c] = 0.f;
  }
  if (tid < BQ) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }

  // softmax ownership: two threads per row, 32 columns each
  const int srow = tid >> 1;
  const int shalf = tid & 1;

  int n_tiles = (klen + BK - 1) / BK;
  if (causal) {  // the last tile holding a key that row q0 + BQ - 1 sees
    const int diag = (q0 + BQ - 1) / BK + 1;
    n_tiles = n_tiles < diag ? n_tiles : diag;
  }
  // global row of this thread's softmax row: the causal bound is per row
  const int grow = q0 + srow;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's readers of sK/sV/sS are done
    load_tile(sK, g.ld_in, kb, k0, T_k, d, g.dp);
    load_tile(sV, g.ld_in, vb, k0, T_k, d, g.dp);
    __syncthreads();

    Products<T>::abt(sQ, g.ld_in, sK, g.ld_in, sS, g.ld_s, d);   // S = Q K^T
    __syncthreads();
    if (bb) {  // K6: S += bias tile, before the scale
      add_bias(sS, g.ld_s, bb, q0, T_q, k0, T_k);
      __syncthreads();
    }

    // online-softmax update of row srow over columns shalf*32 .. +31
    {
      float* srow_s = sS + srow * g.ld_s + shalf * 32;
      const int cbase = k0 + shalf * 32;
      float tmax = NEG_INF;
      for (int c = 0; c < 32; ++c) {
        const float s = srow_s[c] * sm_scale;
        const int col = cbase + c;
        if (col < klen && (!causal || col <= grow)) tmax = fmaxf(tmax, s);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      const float m_prev = sM[srow];
      const float m_new = fmaxf(m_prev, tmax);
      float sum = 0.f;
      T* prow = sP + srow * g.ld_p + shalf * 32;
      for (int c = 0; c < 32; ++c) {
        const float s = srow_s[c] * sm_scale;
        const int col = cbase + c;
        const bool valid = col < klen && (!causal || col <= grow);
        const float p = valid ? expf(s - m_new) : 0.f;
        sum += p;
        if (dropout) {
          const bool kept = keep_bit(seed, hbh, (uint32_t)grow,
                                     (uint32_t)col, threshold);
          prow[c] = from_float<T>(kept ? p * keep_scale : 0.f);
        } else {
          prow[c] = from_float<T>(p);
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float alpha = expf(m_prev - m_new);
      __syncwarp();
      if (shalf == 0) {
        sM[srow] = m_new;
        sL[srow] = alpha * sL[srow] + sum;
        sAlpha[srow] = alpha;
      }
    }
    __syncthreads();

    Products<T>::ab(sP, g.ld_p, sV, g.ld_in, sS, g.ld_s, d, false);  // P V
    __syncthreads();

    for (int idx = tid; idx < BQ * d; idx += NTHREADS) {
      const int r = idx / d, c = idx - r * d;
      sO[r * g.ld_o + c] = sAlpha[r] * sO[r * g.ld_o + c] + sS[r * g.ld_s + c];
    }
  }
  __syncthreads();

  T* ob = o + (size_t)bh * T_q * d;
  for (int idx = tid; idx < BQ * d; idx += NTHREADS) {
    const int r = idx / d, c = idx - r * d;
    if (q0 + r < T_q) {
      const float l = sL[r];
      const float safe_l = l > 0.f ? l : 1.f;
      ob[(size_t)(q0 + r) * d + c] = from_float<T>(sO[r * g.ld_o + c] / safe_l);
    }
  }
  if (tid < BQ && q0 + tid < T_q) {
    const float l = sL[tid];
    const float safe_l = l > 0.f ? l : 1.f;
    lse[(size_t)bh * T_q + q0 + tid] = sM[tid] + logf(safe_l);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const int32_t* k_len, void* o, float* lse, int B, int H, int T_q,
           int T_k, int d, float sm_scale, int dropout, uint32_t threshold,
           float keep_scale, uint32_t seed, int causal, int head_offset,
           int heads_total, cudaStream_t stream) {
  const Geom<T> g(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)g.bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_q + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T><<<grid, NTHREADS, g.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(bias), k_len,
      static_cast<T*>(o), lse, H, T_q, T_k, d, sm_scale, dropout, threshold,
      keep_scale, seed, causal, head_offset, heads_total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q (B,H,T_q,d), k/v (B,H,T_k,d),
// o like q, lse (B,H,T_q) fp32, k_len (B,) int32, all contiguous on the
// device. dropout != 0 turns on the keep mask with `threshold`
// (int(rate * 2^32)), `keep_scale` (1/(1 - rate) in fp32) and `seed` (the
// int32 seed's bits). causal != 0 masks keys past the query row (K3).
// bias is null (K1, K1-d, K3) or a contiguous (B,H,T_q,T_k) additive term
// in q's dtype, added before sm_scale (K6, K6-d). The keep mask hashes the
// batch-head b*heads_total + head_offset + h (flash_common.cuh
// `hash_head`): 0 and H for the whole tensor, a rank's first head and the
// model's heads under tensor parallelism.
// Returns the cudaError_t of the launch (0 = success).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* bias, const void* k_len, void* o,
                        void* lse, int B, int H, int T_q, int T_k, int d,
                        float sm_scale, int dropout, unsigned int threshold,
                        float keep_scale, unsigned int seed, int causal,
                        int head_offset, int heads_total, int dtype,
                        void* stream) {
  if (d <= 0 || d > 128 || d % 8 != 0 || T_q <= 0 || T_k <= 0)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto kl = static_cast<const int32_t*>(k_len);
  auto l = static_cast<float*>(lse);
  if (dtype == 0)
    return launch<float>(q, k, v, bias, kl, o, l, B, H, T_q, T_k, d,
                         sm_scale, dropout, threshold, keep_scale, seed,
                         causal, head_offset, heads_total, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, bias, kl, o, l, B, H, T_q, T_k, d,
                                 sm_scale, dropout, threshold, keep_scale,
                                 seed, causal, head_offset, heads_total, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
