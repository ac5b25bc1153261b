// Relative-position flash-attention forward for Hopper (sm_90a): the
// conformer's Transformer-XL self-attention with a prefix key mask.
//
// Replaces the TPU kernel `_fwd_kernel` driven by `_relpos_fwd`
// (transformer_tts_tpu/ops/flash_relpos.py:212-322): K4 without dropout
// (the path conformer FastSpeech 2 synthesis runs) and K4-d with the
// attention-prob dropout of :253-255 (the path its training runs).
//
// What it computes, per batch-head bh = b*H + h and query row i < T:
//   s[j]   = (q_u[i] . k[j] + bd[i, j]) * sm_scale   for keys j < k_len[b]
//   o[i]   = sum_j softmax(s)[j] * v[j]               (input dtype)
//   lse[i] = max_j s[j] + log(sum_j exp(s[j] - max))  (fp32)
// where bd = rel_shift(q_v P^T) with P = p[h] (T, d), shared over the
// batch. rel_shift gives, for each (i, j) (flash_relpos.py:17-23):
//   bd[i, j] = q_v[i]   . P[T-1-(i-j)]   j <= i
//            = 0                         j == i+1
//            = q_v[i+1] . P[j-i-2]       j >= i+2
// A row with no valid key gives o = 0 and lse = -1e30, as K1 does.
//
// Dropout (K4-d): o[i] = sum_j softmax(s)[j] * keep(i, j) * v[j], with
// keep the `_keep_mask` hash of K1-d (`keep_bit` of flash_common.cuh) at
// bh = b*H + h and the global (row, key), 1/(1 - rate) or 0. The
// normaliser sums the probabilities before dropout; only the numerator's
// probability tile is dropped, after the row sum and before P.V. With
// dropout off the kernel takes K4's code path unchanged.
//
// Bound on the card: 6*H*T*sum_b(k_len[b])*d operations (q_u.K^T, the bias
// product and P.V over the valid keys) against q_u, q_v, k, v, o and P
// moved once; at the synthesis shapes (d = 96, T = 768..2048) the tensor
// cores bound it.
//
// Design (simple first version, K1's structure; wgmma, TMA and warp
// specialisation come later):
//   * one 128-thread block per (64-row q tile, bh), a loop over 64-key
//     tiles; tiles at or past k_len are skipped;
//   * the bias of a (q0, k0) tile: in both branches bd[r][c] is
//     qrow[r] . P[base + (c - r + BQ - 1)], for a per-branch base and the
//     q_v row q0 + r (branch 1) or q0 + r + 1 (branch 2). So the block
//     loads the BQ + BK - 1 consecutive P rows from base on (zeros outside
//     [0, T)), computes A = Q_v P_window^T (BQ x 128, fp32) into shared
//     memory and reads it along the skew, A[r][c - r + BQ - 1]. That read
//     takes the place of the TPU kernel's strided rotate and its 4-copy
//     padded table. The q_v tile holds BQ + 1 rows, so branch 2 reads it
//     one row down and needs no shifted copy of q_v;
//   * a branch that no element of the tile uses is skipped: tiles wholly
//     before the diagonal need only branch 1, tiles wholly after it only
//     branch 2. The branches run one after the other in one P-window
//     buffer (which holds the K tile before them) and one A buffer
//     (which holds the probability tile after them);
//   * products as in K1: WMMA bf16 with fp32 accumulation for bf16, FMAs
//     in fp32 for fp32 (no TF32, so fp32 holds 1e-4 against the plain
//     version); running max, sum and accumulator in fp32.

#include "flash_common.cuh"

namespace {

using flash::from_float;
using flash::hash_head;
using flash::keep_bit;
using flash::round_up;

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per k tile
constexpr int WP = BQ + BK;     // P-window rows (BQ + BK - 1 used)
constexpr int NTHREADS = 128;   // 4 warps; warp w owns q rows 16w..16w+15
constexpr float NEG_INF = -1e30f;

// Shared-memory geometry, identical on host and device.
//   dp   : depth padded for the products (16 for WMMA, 1 for FMAs)
//   ld_in: row stride of the q/k/v/P tiles (elements of T); for WMMA a
//          multiple of 16, so that the q_v tile read one row down keeps
//          the 32-byte alignment WMMA loads need
//   ld_s : row stride of the fp32 S tile, reused for the P.V tile
//   ld_a : row stride of the fp32 bias product A (BQ x WP)
//   ld_p : row stride of the probability tile (elements of T), kept in
//          the A buffer once the bias is added
//   ld_o : row stride of the fp32 accumulator
template <typename T> struct Geom {
  int dp, ld_in, ld_s, ld_a, ld_p, ld_o;
  size_t off_qv, off_kp, off_v, off_s, off_a, off_o, off_stats, bytes;
  __host__ __device__ explicit Geom(int d) {
    const bool wmma = sizeof(T) == 2;
    dp = wmma ? round_up(d, 16) : d;
    ld_in = wmma ? round_up(dp + 8, 16) : d + 1;
    const int s_cols = dp > BK ? dp : BK;
    ld_s = wmma ? s_cols + 4 : s_cols + 1;
    ld_a = wmma ? WP + 4 : WP + 1;
    ld_p = wmma ? BK + 8 : BK + 1;
    ld_o = d + 1;
    const int sz = (int)sizeof(T);
    off_qv = round_up(BQ * ld_in * sz, 128);
    off_kp = off_qv + round_up((BQ + 1) * ld_in * sz, 128);
    off_v = off_kp + round_up(WP * ld_in * sz, 128);
    off_s = off_v + round_up(BK * ld_in * sz, 128);
    off_a = off_s + round_up(BQ * ld_s * 4, 128);
    off_o = off_a + round_up(BQ * ld_a * 4, 128);
    off_stats = off_o + round_up(BQ * ld_o * 4, 128);
    bytes = off_stats + 3 * BQ * 4;
  }
};

// C[BQ][N] = A[BQ][d] B[N][d]^T and C[BQ][d] = P[BQ][BK] V[BK][d],
// specialised by type.
template <typename T> struct Products;

template <> struct Products<float> {
  // thread t: rows 4*(t/8)..+3, columns (t%8) + 8*j
  template <int N>
  __device__ static void abt(const float* A, const float* B, float* C,
                             int ld_in, int ldc, int d) {
    const int t = threadIdx.x;
    const int r0 = (t >> 3) * 4, c0 = t & 7;
    float acc[4][N / 8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < N / 8; ++j) acc[i][j] = 0.f;
    for (int kk = 0; kk < d; ++kk) {
      float av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = A[(r0 + i) * ld_in + kk];
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const float bv = B[(c0 + 8 * j) * ld_in + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(av[i], bv, acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
        C[(r0 + i) * ldc + c0 + 8 * j] = acc[i][j];
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
          const float vv = sV[c * g.ld_in + c0 + 8 * j];
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
  // warp w: C rows 16w..16w+15, all N columns; d is padded to dp
  template <int N>
  __device__ static void abt(const bf16* A, const bf16* B, float* C,
                             int ld_in, int ldc, int dp) {
    using namespace nvcuda;
    const int w = threadIdx.x >> 5;
    for (int nb = 0; nb < N / 16; ++nb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kb = 0; kb < dp / 16; ++kb) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, A + 16 * w * ld_in + 16 * kb, ld_in);
        // B^T[k][n] = B[n][k]: B stored row-major is B^T column-major
        wmma::load_matrix_sync(b, B + 16 * nb * ld_in + 16 * kb, ld_in);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(C + 16 * w * ldc + 16 * nb, acc, ldc,
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

// rows [row0, row0 + rows) x columns [0, width) of a (T, d) matrix into
// shared memory; zero for rows outside [0, T) and columns past d
template <typename T>
__device__ void load_rows(T* dst, int ld, const T* src, int row0, int rows,
                          int T_len, int d, int width) {
  for (int idx = threadIdx.x; idx < rows * width; idx += NTHREADS) {
    const int r = idx / width, c = idx - r * width;
    const int row = row0 + r;
    T val = from_float<T>(0.f);
    if (row >= 0 && row < T_len && c < d) val = src[(size_t)row * d + c];
    dst[r * ld + c] = val;
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
relpos_fwd_kernel(const T* __restrict__ q_u, const T* __restrict__ q_v,
                  const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ p, const int32_t* __restrict__ k_len,
                  T* __restrict__ o, float* __restrict__ lse, int H,
                  int T_len, int d, float sm_scale, int dropout,
                  uint32_t threshold, float keep_scale, uint32_t seed,
                  int head_offset, int heads_total) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Geom<T> g(d);
  T* sQu = reinterpret_cast<T*>(smem);
  T* sQv = reinterpret_cast<T*>(smem + g.off_qv);
  T* sKP = reinterpret_cast<T*>(smem + g.off_kp);   // K tile, then P window
  T* sV = reinterpret_cast<T*>(smem + g.off_v);
  float* sS = reinterpret_cast<float*>(smem + g.off_s);
  float* sA = reinterpret_cast<float*>(smem + g.off_a);
  T* sP = reinterpret_cast<T*>(smem + g.off_a);     // after the bias is used
  float* sO = reinterpret_cast<float*>(smem + g.off_o);
  float* sM = reinterpret_cast<float*>(smem + g.off_stats);
  float* sL = sM + BQ;
  float* sAlpha = sL + BQ;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const uint32_t hbh = hash_head(bh, H, head_offset, heads_total);
  int klen = k_len[bh / H];
  klen = klen < 0 ? 0 : (klen > T_len ? T_len : klen);

  const size_t plane = (size_t)T_len * d;
  const T* qub = q_u + bh * plane;
  const T* qvb = q_v + bh * plane;
  const T* kb = k + bh * plane;
  const T* vb = v + bh * plane;
  const T* pb = p + (bh % H) * plane;

  load_rows(sQu, g.ld_in, qub, q0, BQ, T_len, d, g.dp);
  load_rows(sQv, g.ld_in, qvb, q0, BQ + 1, T_len, d, g.dp);
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
    __syncthreads();  // previous tile's readers of sKP/sV/sS/sA are done
    load_rows(sKP, g.ld_in, kb, k0, BK, T_len, d, g.dp);
    load_rows(sV, g.ld_in, vb, k0, BK, T_len, d, g.dp);
    __syncthreads();

    Products<T>::template abt<BK>(sQu, sKP, sS, g.ld_in, g.ld_s, g.dp);

    // branch 1 (j <= i): rows q0 + r of q_v, P[T - BQ + k0 - q0 + w];
    // branch 2 (j >= i + 2): rows q0 + r + 1, P[k0 - q0 - BQ - 1 + w]
    for (int br = 0; br < 2; ++br) {
      const bool used = br == 0 ? k0 <= q0 + BQ - 1 : k0 + BK - 1 >= q0 + 2;
      if (!used) continue;
      const int base = br == 0 ? T_len - BQ + k0 - q0 : k0 - q0 - BQ - 1;
      __syncthreads();  // readers of sKP (K or the last window) are done
      load_rows(sKP, g.ld_in, pb, base, WP, T_len, d, g.dp);
      __syncthreads();
      Products<T>::template abt<WP>(sQv + br * g.ld_in, sKP, sA, g.ld_in,
                                    g.ld_a, g.dp);
      __syncthreads();
      for (int idx = tid; idx < BQ * BK; idx += NTHREADS) {
        const int r = idx / BK, c = idx - r * BK;
        const int rel = (k0 + c) - (q0 + r);        // j - i
        if (br == 0 ? rel <= 0 : rel >= 2)
          sS[r * g.ld_s + c] += sA[r * g.ld_a + c - r + BQ - 1];
      }
    }
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
        const float pr = (cbase + c < klen) ? expf(s - m_new) : 0.f;
        sum += pr;
        if (dropout) {
          const bool kept = keep_bit(seed, hbh, (uint32_t)(q0 + srow),
                                     (uint32_t)(cbase + c), threshold);
          prow[c] = from_float<T>(kept ? pr * keep_scale : 0.f);
        } else {
          prow[c] = from_float<T>(pr);
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

    Products<T>::pv(sP, sV, sS, g, d);
    __syncthreads();

    for (int idx = tid; idx < BQ * d; idx += NTHREADS) {
      const int r = idx / d, c = idx - r * d;
      sO[r * g.ld_o + c] = sAlpha[r] * sO[r * g.ld_o + c] + sS[r * g.ld_s + c];
    }
  }
  __syncthreads();

  T* ob = o + bh * plane;
  for (int idx = tid; idx < BQ * d; idx += NTHREADS) {
    const int r = idx / d, c = idx - r * d;
    if (q0 + r < T_len) {
      const float l = sL[r];
      const float safe_l = l > 0.f ? l : 1.f;
      ob[(size_t)(q0 + r) * d + c] = from_float<T>(sO[r * g.ld_o + c] / safe_l);
    }
  }
  if (tid < BQ && q0 + tid < T_len) {
    const float l = sL[tid];
    const float safe_l = l > 0.f ? l : 1.f;
    lse[(size_t)bh * T_len + q0 + tid] = sM[tid] + logf(safe_l);
  }
}

template <typename T>
int launch(const void* q_u, const void* q_v, const void* k, const void* v,
           const void* p, const int32_t* k_len, void* o, float* lse, int B,
           int H, int T_len, int d, float sm_scale, int dropout,
           uint32_t threshold, float keep_scale, uint32_t seed,
           int head_offset, int heads_total, cudaStream_t stream) {
  const Geom<T> g(d);
  cudaError_t err = cudaFuncSetAttribute(
      relpos_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)g.bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + BQ - 1) / BQ, B * H);
  relpos_fwd_kernel<T><<<grid, NTHREADS, g.bytes, stream>>>(
      static_cast<const T*>(q_u), static_cast<const T*>(q_v),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(p), k_len, static_cast<T*>(o), lse, H, T_len, d,
      sm_scale, dropout, threshold, keep_scale, seed, head_offset,
      heads_total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q_u, q_v, k, v, o (B,H,T,d), p (H,T,d),
// lse (B,H,T) fp32, k_len (B,) int32, all contiguous on the device.
// dropout != 0 turns on the keep mask (K4-d) with `threshold`
// (int(rate * 2^32)), `keep_scale` (1/(1 - rate) in fp32) and `seed` (the
// int32 seed's bits), and the hash's `head_offset` and `heads_total`, as
// flash_attention_fwd takes them. Returns the
// cudaError_t of the launch (0 = success); a launch that needs more shared
// memory than a block may have (fp32 with d > 104) is refused
// with the error of cudaFuncSetAttribute.
int flash_relpos_fwd(const void* q_u, const void* q_v, const void* k,
                     const void* v, const void* p, const void* k_len, void* o,
                     void* lse, int B, int H, int T_len, int d, float sm_scale,
                     int dropout, unsigned int threshold, float keep_scale,
                     unsigned int seed, int head_offset, int heads_total,
                     int dtype, void* stream) {
  if (d <= 0 || d > 128 || d % 8 != 0 || T_len <= 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto kl = static_cast<const int32_t*>(k_len);
  auto l = static_cast<float*>(lse);
  if (dtype == 0)
    return launch<float>(q_u, q_v, k, v, p, kl, o, l, B, H, T_len, d,
                         sm_scale, dropout, threshold, keep_scale, seed,
                         head_offset, heads_total, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q_u, q_v, k, v, p, kl, o, l, B, H, T_len, d,
                                 sm_scale, dropout, threshold, keep_scale,
                                 seed, head_offset, heads_total, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
