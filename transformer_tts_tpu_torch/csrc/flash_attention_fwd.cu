// Flash-attention forward for Hopper (sm_90a): non-causal, prefix key mask.
//
// Replaces the TPU kernel `_fwd_kernel` driven by `_flash_fwd`
// (transformer_tts_tpu/ops/flash_attention.py:90-263) with causal=False,
// no bias and no dropout: the path FastSpeech 2 synthesis runs.
//
// What it computes, per batch-head bh = b*H + h and query row r:
//   s[c]   = (q[r] . k[c]) * sm_scale         for keys c < k_len[b]
//   o[r]   = sum_c softmax(s)[c] * v[c]        (input dtype)
//   lse[r] = max_c s[c] + log(sum_c exp(s[c] - max))   (fp32)
// Keys c >= k_len[b] are excluded exactly. A row with no valid key gives
// o = 0 and lse = -1e30 + log(1), as the TPU kernel does.
//
// Bound on the card: 4*B*H*T_q*T_k*d operations against Q, K, V and O read
// or written once. At the synthesis shapes (d = 96, T = 768..2048) that is
// ~1 byte per 200..500 operations in bf16, so the tensor cores bound it.
//
// Design (simple first version; wgmma, TMA and warp specialisation come
// later):
//   * one 128-thread block per (64-row q tile, bh); a loop over 64-row k
//     tiles takes the place of the TPU kernel's sequential k grid axis;
//   * the q tile, each k/v tile, the score tile S, the probability tile P
//     and the fp32 output accumulator live in shared memory;
//   * the two products are specialised by type: bf16 runs them on the
//     tensor cores through WMMA (bf16 in, fp32 accumulate, P cast to bf16
//     before P.V like the TPU kernel); fp32 runs them as plain FMAs in fp32
//     so the result matches the fp32 reference to rounding;
//   * running max, running sum and accumulator are fp32; k tiles at or past
//     k_len are skipped since they contribute nothing; the ragged edges in
//     T_q, T_k and d are masked in the loads and stores, with no padding
//     copies in device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per k tile
constexpr int NTHREADS = 128;   // 4 warps; warp w owns q rows 16w..16w+15
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

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

// S[BQ][BK] = Q K^T and O_tile[BQ][d] = P V, specialised by type.
template <typename T> struct Products;

template <> struct Products<float> {
  // thread t: rows 4*(t/8)..+3, columns (t%8) + 8*j
  __device__ static void qk(const float* sQ, const float* sK, float* sS,
                            const Geom<float>& g, int d) {
    const int t = threadIdx.x;
    const int r0 = (t >> 3) * 4, c0 = t & 7;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int kk = 0; kk < d; ++kk) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(r0 + i) * g.ld_in + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = sK[(c0 + 8 * j) * g.ld_in + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(qv[i], kv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sS[(r0 + i) * g.ld_s + c0 + 8 * j] = acc[i][j];
  }

  // thread t: rows 4*(t/8)..+3, columns (t%8) + 8*j for j < d/8 (d <= 128)
  __device__ static void pv(const float* sP, const float* sV, float* sT,
                            const Geom<float>& g, int d) {
    const int t = threadIdx.x;
    const int r0 = (t >> 3) * 4, c0 = t & 7;
    const int nj = d >> 3;
    float acc[4][16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(r0 + i) * g.ld_p + c];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (j < nj) {
          float vv = sV[c * g.ld_in + c0 + 8 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (j < nj) sT[(r0 + i) * g.ld_s + c0 + 8 * j] = acc[i][j];
  }
};

template <> struct Products<__nv_bfloat16> {
  using bf16 = __nv_bfloat16;
  // warp w: S rows 16w..16w+15, all BK columns
  __device__ static void qk(const bf16* sQ, const bf16* sK, float* sS,
                            const Geom<bf16>& g, int /*d*/) {
    using namespace nvcuda;
    const int w = threadIdx.x >> 5;
    for (int nb = 0; nb < BK / 16; ++nb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kb = 0; kb < g.dp / 16; ++kb) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, sQ + 16 * w * g.ld_in + 16 * kb, g.ld_in);
        // B[k][n] = K[n][k]: K stored row-major is B column-major
        wmma::load_matrix_sync(b, sK + 16 * nb * g.ld_in + 16 * kb, g.ld_in);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sS + 16 * w * g.ld_s + 16 * nb, acc, g.ld_s,
                              wmma::mem_row_major);
    }
  }

  // warp w: O_tile rows 16w..16w+15, dp columns
  __device__ static void pv(const bf16* sP, const bf16* sV, float* sT,
                            const Geom<bf16>& g, int /*d*/) {
    using namespace nvcuda;
    const int w = threadIdx.x >> 5;
    for (int nb = 0; nb < g.dp / 16; ++nb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kb = 0; kb < BK / 16; ++kb) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, sP + 16 * w * g.ld_p + 16 * kb, g.ld_p);
        wmma::load_matrix_sync(b, sV + 16 * kb * g.ld_in + 16 * nb, g.ld_in);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sT + 16 * w * g.ld_s + 16 * nb, acc, g.ld_s,
                              wmma::mem_row_major);
    }
  }
};

// rows [row0, row0+BQ) x columns [0, width) of a (rows_valid, d) matrix into
// shared memory; zero past rows_valid and past d
template <typename T>
__device__ void load_tile(T* dst, int ld, const T* src, int row0,
                          int rows_valid, int d, int width) {
  for (int idx = threadIdx.x; idx < BQ * width; idx += NTHREADS) {
    const int r = idx / width, c = idx - r * width;
    const int row = row0 + r;
    T val = from_float<T>(0.f);
    if (row < rows_valid && c < d) val = src[(size_t)row * d + c];
    dst[r * ld + c] = val;
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int32_t* __restrict__ k_len,
                 T* __restrict__ o, float* __restrict__ lse, int H, int T_q,
                 int T_k, int d, float sm_scale) {
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
  int klen = k_len[bh / H];
  klen = klen < 0 ? 0 : (klen > T_k ? T_k : klen);

  const T* qb = q + (size_t)bh * T_q * d;
  const T* kb = k + (size_t)bh * T_k * d;
  const T* vb = v + (size_t)bh * T_k * d;

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

  const int n_tiles = (klen + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's readers of sK/sV/sS are done
    load_tile(sK, g.ld_in, kb, k0, T_k, d, g.dp);
    load_tile(sV, g.ld_in, vb, k0, T_k, d, g.dp);
    __syncthreads();

    Products<T>::qk(sQ, sK, sS, g, d);
    __syncthreads();

    // online-softmax update of row srow over columns shalf*32 .. +31
    {
      float* srow_s = sS + srow * g.ld_s + shalf * 32;
      const int cbase = k0 + shalf * 32;
      float tmax = NEG_INF;
      for (int c = 0; c < 32; ++c) {
        const float s = srow_s[c] * sm_scale;
        if (cbase + c < klen) tmax = fmaxf(tmax, s);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      const float m_prev = sM[srow];
      const float m_new = fmaxf(m_prev, tmax);
      float sum = 0.f;
      T* prow = sP + srow * g.ld_p + shalf * 32;
      for (int c = 0; c < 32; ++c) {
        const float s = srow_s[c] * sm_scale;
        const float p = (cbase + c < klen) ? expf(s - m_new) : 0.f;
        sum += p;
        prow[c] = from_float<T>(p);
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

    Products<T>::pv(sP, sV, sS, g, d);
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
int launch(const void* q, const void* k, const void* v, const int32_t* k_len,
           void* o, float* lse, int B, int H, int T_q, int T_k, int d,
           float sm_scale, cudaStream_t stream) {
  const Geom<T> g(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)g.bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_q + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T><<<grid, NTHREADS, g.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), k_len, static_cast<T*>(o), lse, H, T_q, T_k,
      d, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q (B,H,T_q,d), k/v (B,H,T_k,d),
// o like q, lse (B,H,T_q) fp32, k_len (B,) int32, all contiguous on the
// device. Returns the cudaError_t of the launch (0 = success).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* k_len, void* o, void* lse, int B, int H,
                        int T_q, int T_k, int d, float sm_scale, int dtype,
                        void* stream) {
  if (d <= 0 || d > 128 || d % 8 != 0 || T_q <= 0 || T_k <= 0)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto kl = static_cast<const int32_t*>(k_len);
  auto l = static_cast<float*>(lse);
  if (dtype == 0)
    return launch<float>(q, k, v, kl, o, l, B, H, T_q, T_k, d, sm_scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, kl, o, l, B, H, T_q, T_k, d,
                                 sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
