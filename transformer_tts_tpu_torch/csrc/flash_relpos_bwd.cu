// Relative-position flash-attention backward for Hopper (sm_90a): K5, the
// gradient of K4 / K4-d (flash_relpos_fwd.cu).
//
// Replaces the TPU kernels `_fused_bwd_kernel` (:510), `_dq_kernel` (:360)
// and `_dkdv_kernel` (:431) driven by `_relpos_bwd`
// (transformer_tts_tpu/ops/flash_relpos.py:597-751): the backward that
// conformer FastSpeech 2 training runs through every decoder self-
// attention. The TPU takes the fused form when one k block covers T (a
// TPU block choice); here it is two kernels in the FlashAttention-2 shape
// of K2 (flash_attention_bwd.cu).
//
// What it computes, per batch-head bh = b*H + h, from the forward's lse and
// delta = rowsum(dO * O) (fp32, a torch reduction as for K2):
//   s[i][j]  = (q_u[i] . k[j] + bd[i][j]) * sm_scale, keys j < k_len[b]
//   P        = exp(s - lse[i]),  dPa = (dO[i] . v[j]) * keep(i, j)
//   dS       = P (dPa - delta[i]) * sm_scale
//   dq_u = dS K,  dk = dS^T q_u,  dv = (P keep)^T dO
// and, through the bias bd = rel_shift(q_v P^T) with its three branches
//   bd[i][j] = q_v[i] . P[T-1-(i-j)] (j <= i), 0 (j == i+1),
//              q_v[i+1] . P[j-i-2]   (j >= i+2),
//   dq_v[i]   += sum_{j <= i}   dS[i][j] P[T-1-(i-j)]
//   dq_vs[i]  += sum_{j >= i+2} dS[i][j] P[j-i-2]   (belongs to q_v[i+1])
//   dP[T-1-(i-j)] += dS[i][j] q_v[i],   dP[j-i-2] += dS[i][j] q_v[i+1]
// with dP summed over the batch. dS and P keep are cast to the input dtype
// before their products, as the TPU kernels do; keep is `keep_bit` of
// flash_common.cuh, the forward's hash, rebuilt here. dq_v and dq_vs are
// written in fp32 and the wrapper adds dq_vs one row down.
//
// Bound on the card, per attended (row, key) pair: the dq kernel does five
// products (q_u.K^T, the bias q_v.P^T, dO.V^T, dS.K and dA.P), 10*H*d
// operations; the dk/dv/dP kernel six (q_u.K^T, q_v.P^T, dO.V^T, the dv
// and dk products and dA^T.q_v), 12*H*d; against q_u, q_v, k, v, dO, P,
// lse, delta read once and the gradients written once. At the train
// step's shapes (d = 96, T = 1024) the tensor cores bound both.
//
// Design (simple first version; wgmma, TMA and register accumulators come
// later):
//   * the dq kernel: one 128-thread block per (32-row q tile, bh), a loop
//     over the 64-key tiles below k_len[b]; the dk/dv/dP kernel: one block
//     per (64-key tile, bh), a loop over every 32-row q tile. A block of
//     the second whose keys all lie past k_len[b] writes zero dk and dv.
//   * the score tile is rebuilt as K4 builds it: per branch the WP = 96
//     consecutive P rows of the tile's window, A = Q_v P_win^T, and the
//     skewed read A[r][c - r + BQ - 1]; the q_v tile holds BQ + 1 rows, so
//     branch 2 reads it one row down.
//   * the bias's gradient goes back through the same skew: per branch the
//     masked dS is written into dA[r][c - r + BQ - 1] (each row as a whole,
//     zeros where no key maps), then dq_v (dq_vs) += dA P_win and
//     dP_win = dA^T Q_v. dP_win's rows inside [0, T) are added to an fp32
//     (H, T, d) buffer with 16-byte atomicAdds (4 floats, sm_90) straight
//     from each product tile, so the batch sum needs no second pass and no
//     (B, H, T, d) buffer (the order of the atomics, and so dP's last
//     bits, vary from run to run).
//   * bf16 tiles move from device memory in 16-byte chunks; the first
//     version's 2-byte loads held both kernels back (PERF.md, PR 6).
//   * 32-row q tiles keep the fp32 dk/dv/dP kernel at d = 96 inside the
//     227 KB of shared memory a block may have (~212 KB; bf16 ~158 KB).
//   * products: WMMA (bf16 in, fp32 accumulate) for bf16, blocked FMAs in
//     fp32 for fp32 (no TF32, so fp32 matches the plain version to
//     rounding); accumulators in shared memory.

#include "flash_common.cuh"

namespace {

using flash::from_float;
using flash::keep_bit;
using flash::round_up;

constexpr int BQ = 32;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int WP = BQ + BK;     // P-window rows (BQ + BK - 1 used)
constexpr int NTHREADS = 128;   // 4 warps
constexpr int NWARPS = NTHREADS / 32;

struct Dropout {
  int on;
  uint32_t threshold;
  float keep_scale;
  uint32_t seed;
};

// Tile products, specialised by type. op(A) is A (M x K, row stride lda)
// or, with TA, A stored K x M; op(B) is B (K x N) or, with TB, B stored
// N x K. C is fp32.
//   store      C  = op(A) op(B)
//   accumulate C += op(A) op(B)
//   each       epi(m, n, float4 of columns n..n+3) once per 4 elements
//              of op(A) op(B), n a multiple of 4
template <typename T> struct Mm;

template <> struct Mm<float> {
  // thread t owns the 4 x 4 blocks t, t + 128, ... of C and hands each of
  // their rows to epi(m, n0, float4); M, N multiples of 4
  template <bool TA, bool TB, typename Epi>
  __device__ static void run(const float* A, int lda, const float* B,
                             int ldb, int M, int N, int K, Epi epi) {
    const int nt = N >> 2;
    const int tiles = (M >> 2) * nt;
    for (int t = threadIdx.x; t < tiles; t += NTHREADS) {
      const int m0 = (t / nt) * 4, n0 = (t % nt) * 4;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k = 0; k < K; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = TA ? A[k * lda + m0 + i] : A[(m0 + i) * lda + k];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = TB ? B[(n0 + j) * ldb + k] : B[k * ldb + n0 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        epi(m0 + i, n0,
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    }
  }

  template <bool TA, bool TB>
  __device__ static void store(const float* A, int lda, const float* B,
                               int ldb, float* C, int ldc, int M, int N,
                               int K) {
    run<TA, TB>(A, lda, B, ldb, M, N, K, [&](int m, int n, float4 x) {
      float* c = C + m * ldc + n;
      c[0] = x.x;
      c[1] = x.y;
      c[2] = x.z;
      c[3] = x.w;
    });
  }

  template <bool TA, bool TB>
  __device__ static void accumulate(const float* A, int lda, const float* B,
                                    int ldb, float* C, int ldc, int M, int N,
                                    int K) {
    run<TA, TB>(A, lda, B, ldb, M, N, K, [&](int m, int n, float4 x) {
      float* c = C + m * ldc + n;
      c[0] += x.x;
      c[1] += x.y;
      c[2] += x.z;
      c[3] += x.w;
    });
  }

  template <bool TA, bool TB, typename Epi>
  __device__ static void each(const float* A, int lda, const float* B,
                              int ldb, int M, int N, int K, float* /*stage*/,
                              Epi epi) {
    run<TA, TB>(A, lda, B, ldb, M, N, K, epi);
  }
};

template <> struct Mm<__nv_bfloat16> {
  using bf16 = __nv_bfloat16;
  using Acc = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16,
                                     float>;

  // acc += op(A) op(B) over the 16 x 16 output tile (mb, nb); K a
  // multiple of 16
  template <bool TA, bool TB>
  __device__ static void tile(Acc& acc, const bf16* A, int lda,
                              const bf16* B, int ldb, int mb, int nb, int K) {
    using namespace nvcuda;
    for (int kb = 0; kb < K / 16; ++kb) {
      if constexpr (TA) {
        // op(A)[m][k] = A[k][m]: A stored row-major is op(A) column-major
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
        wmma::load_matrix_sync(a, A + 16 * kb * lda + 16 * mb, lda);
        if constexpr (TB) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(b, B + 16 * nb * ldb + 16 * kb, ldb);
          wmma::mma_sync(acc, a, b, acc);
        } else {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, B + 16 * kb * ldb + 16 * nb, ldb);
          wmma::mma_sync(acc, a, b, acc);
        }
      } else {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, A + 16 * mb * lda + 16 * kb, lda);
        if constexpr (TB) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(b, B + 16 * nb * ldb + 16 * kb, ldb);
          wmma::mma_sync(acc, a, b, acc);
        } else {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, B + 16 * kb * ldb + 16 * nb, ldb);
          wmma::mma_sync(acc, a, b, acc);
        }
      }
    }
  }

  // warp w owns the output tiles w, w + 4, ...; M, N multiples of 16
  template <bool TA, bool TB>
  __device__ static void store(const bf16* A, int lda, const bf16* B,
                               int ldb, float* C, int ldc, int M, int N,
                               int K) {
    using namespace nvcuda;
    const int nt = N / 16;
    for (int t = threadIdx.x >> 5; t < (M / 16) * nt; t += NWARPS) {
      const int mb = t / nt, nb = t % nt;
      Acc acc;
      wmma::fill_fragment(acc, 0.f);
      tile<TA, TB>(acc, A, lda, B, ldb, mb, nb, K);
      wmma::store_matrix_sync(C + 16 * mb * ldc + 16 * nb, acc, ldc,
                              wmma::mem_row_major);
    }
  }

  template <bool TA, bool TB>
  __device__ static void accumulate(const bf16* A, int lda, const bf16* B,
                                    int ldb, float* C, int ldc, int M, int N,
                                    int K) {
    using namespace nvcuda;
    const int nt = N / 16;
    for (int t = threadIdx.x >> 5; t < (M / 16) * nt; t += NWARPS) {
      const int mb = t / nt, nb = t % nt;
      float* c = C + 16 * mb * ldc + 16 * nb;
      Acc acc;
      wmma::load_matrix_sync(acc, c, ldc, wmma::mem_row_major);
      tile<TA, TB>(acc, A, lda, B, ldb, mb, nb, K);
      wmma::store_matrix_sync(c, acc, ldc, wmma::mem_row_major);
    }
  }

  // each warp stages its 16 x 16 tile in its own 256 floats of `stage`
  template <bool TA, bool TB, typename Epi>
  __device__ static void each(const bf16* A, int lda, const bf16* B, int ldb,
                              int M, int N, int K, float* stage, Epi epi) {
    using namespace nvcuda;
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* st = stage + 256 * w;
    const int nt = N / 16;
    for (int t = w; t < (M / 16) * nt; t += NWARPS) {
      const int mb = t / nt, nb = t % nt;
      Acc acc;
      wmma::fill_fragment(acc, 0.f);
      tile<TA, TB>(acc, A, lda, B, ldb, mb, nb, K);
      wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = 4 * lane; e < 256; e += 128)
        epi(16 * mb + (e >> 4), 16 * nb + (e & 15),
            make_float4(st[e], st[e + 1], st[e + 2], st[e + 3]));
      __syncwarp();
    }
  }
};

// the next 128-byte-aligned region of `bytes` at `off`
__host__ __device__ inline size_t take(size_t& off, size_t bytes) {
  const size_t o = off;
  off += (bytes + 127) / 128 * 128;
  return o;
}

// Shared-memory geometry, identical on host and device.
//   dp   : depth padded for the products (16 for WMMA, 1 for FMAs)
//   ld_in: row stride of the q/k/v/dO/P tiles (elements of T); for WMMA a
//          multiple of 16, so that the q_v tile read one row down keeps
//          the 32-byte alignment WMMA loads need
//   ld_s : the fp32 score tile (BQ x BK)
//   ld_a : the fp32 bias product A (BQ x WP), which also holds dO V^T
//   ld_da: dA (BQ x WP, elements of T), in the A buffer
//   ld_p : dS and P keep (BQ x BK, elements of T)
//   ld_o : the fp32 accumulators
// The dq kernel holds q_u, q_v (+1 row), dO, K and the P window (which
// takes V in turn), S, A, dS and three BQ-row accumulators (dq_u, dq_v,
// dq_vs). The dk/dv/dP kernel holds K and V for the block, the same
// q-side tiles, S, A, P keep, dS, two BK-row accumulators (dk, dv) and,
// for WMMA, a 16 x 16 staging tile per warp for dP's atomics.
template <typename T> struct Geom {
  int dp, ld_in, ld_s, ld_a, ld_da, ld_p, ld_o;
  size_t off_qu, off_qv, off_do, off_k, off_v, off_pw, off_s, off_a, off_pk,
      off_ds, off_acc[3], off_stage, off_stats, bytes;
  __host__ __device__ Geom(int d, bool dkdv) {
    const bool wmma = sizeof(T) == 2;
    const int sz = (int)sizeof(T);
    dp = wmma ? round_up(d, 16) : d;
    ld_in = wmma ? round_up(dp + 8, 16) : d + 1;
    ld_s = wmma ? BK + 4 : BK + 1;
    ld_a = wmma ? WP + 4 : WP + 1;
    ld_da = wmma ? WP + 8 : WP + 1;
    ld_p = wmma ? BK + 8 : BK + 1;
    ld_o = wmma ? dp + 4 : d + 1;
    size_t off = 0;
    off_k = take(off, (size_t)BK * ld_in * sz);
    off_v = dkdv ? take(off, (size_t)BK * ld_in * sz) : 0;
    off_qu = take(off, (size_t)BQ * ld_in * sz);
    off_qv = take(off, (size_t)(BQ + 1) * ld_in * sz);
    off_do = take(off, (size_t)BQ * ld_in * sz);
    off_pw = take(off, (size_t)WP * ld_in * sz);
    off_s = take(off, (size_t)BQ * ld_s * 4);
    off_a = take(off, (size_t)BQ * ld_a * 4);
    off_pk = dkdv ? take(off, (size_t)BQ * ld_p * sz) : 0;
    off_ds = take(off, (size_t)BQ * ld_p * sz);
    const int acc_rows = dkdv ? BK : BQ;
    for (int i = 0; i < 3; ++i)
      off_acc[i] =
          (i < 2 || !dkdv) ? take(off, (size_t)acc_rows * ld_o * 4) : 0;
    off_stage = (dkdv && wmma) ? take(off, (size_t)NWARPS * 256 * 4) : 0;
    off_stats = take(off, (size_t)2 * BQ * 4);
    bytes = off;
  }
};

// rows [row0, row0 + rows) x columns [0, width) of a (T, d) matrix into
// shared memory; zero for rows outside [0, T) and columns past d. bf16
// moves 16-byte chunks of 8 elements: d % 8 == 0, the planes start on
// 16-byte boundaries and ld_in is a multiple of 16, so every chunk is
// aligned and lies wholly inside or wholly past d. fp32 (odd ld_in)
// moves single elements.
template <typename T>
__device__ void load_rows(T* dst, int ld, const T* src, int row0, int rows,
                          int T_len, int d, int width) {
  if constexpr (sizeof(T) == 2) {
    const int chunks = width / 8;
    for (int idx = threadIdx.x; idx < rows * chunks; idx += NTHREADS) {
      const int r = idx / chunks, c = (idx - r * chunks) * 8;
      const int row = row0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row >= 0 && row < T_len && c < d)
        val = *reinterpret_cast<const uint4*>(src + (size_t)row * d + c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * width; idx += NTHREADS) {
      const int r = idx / width, c = idx - r * width;
      const int row = row0 + r;
      T val = from_float<T>(0.f);
      if (row >= 0 && row < T_len && c < d) val = src[(size_t)row * d + c];
      dst[r * ld + c] = val;
    }
  }
}

// dst[0..3] += x, one 16-byte atomic on Hopper (dst 16-byte aligned)
__device__ __forceinline__ void atomic_add4(float* dst, float4 x) {
#if __CUDA_ARCH__ >= 900
  atomicAdd(reinterpret_cast<float4*>(dst), x);
#else
  atomicAdd(dst, x.x);
  atomicAdd(dst + 1, x.y);
  atomicAdd(dst + 2, x.z);
  atomicAdd(dst + 3, x.w);
#endif
}

__device__ void zero_fp32(float* dst, int n) {
  for (int idx = threadIdx.x; idx < n; idx += NTHREADS) dst[idx] = 0.f;
}

// lse and delta of q rows [q0, q0 + BQ) into shared memory (0 past T)
__device__ void load_stats(float* s_lse, float* s_delta, const float* lse,
                           const float* delta, size_t base, int q0,
                           int T_len) {
  if (threadIdx.x < BQ) {
    const int row = q0 + threadIdx.x;
    s_lse[threadIdx.x] = row < T_len ? lse[base + row] : 0.f;
    s_delta[threadIdx.x] = row < T_len ? delta[base + row] : 0.f;
  }
}

// branch 0 (j <= i) or 1 (j >= i + 2) touches the (q0, k0) tile
__device__ __forceinline__ bool branch_used(int br, int q0, int k0) {
  return br == 0 ? k0 <= q0 + BQ - 1 : k0 + BK - 1 >= q0 + 2;
}

// first P row of the branch's window: row w of the window is
// P[base + w], read by tile element (r, c) at w = c - r + BQ - 1
__device__ __forceinline__ int window_base(int br, int q0, int k0,
                                           int T_len) {
  return br == 0 ? T_len - BQ + k0 - q0 : k0 - q0 - BQ - 1;
}

__device__ __forceinline__ bool in_branch(int br, int rel) {
  return br == 0 ? rel <= 0 : rel >= 2;
}

// sS = q_u K^T + rel_shift(q_v P^T) on the (q0, k0) tile, unscaled, as K4
// builds it: per used branch a P window into sPw, A = Q_v P_win^T into sA
// and the skewed read. Ends with a barrier.
template <typename T>
__device__ void score_tile(const Geom<T>& g, const T* sQu, const T* sQv,
                           const T* sK, T* sPw, float* sS, float* sA,
                           const T* pb, int q0, int k0, int T_len, int d) {
  Mm<T>::template store<false, true>(sQu, g.ld_in, sK, g.ld_in, sS, g.ld_s,
                                     BQ, BK, g.dp);
  for (int br = 0; br < 2; ++br) {
    if (!branch_used(br, q0, k0)) continue;
    __syncthreads();  // readers of sPw and sA, writers of sS are done
    load_rows(sPw, g.ld_in, pb, window_base(br, q0, k0, T_len), WP, T_len,
              d, g.dp);
    __syncthreads();
    Mm<T>::template store<false, true>(sQv + br * g.ld_in, g.ld_in, sPw,
                                       g.ld_in, sA, g.ld_a, BQ, WP, g.dp);
    __syncthreads();
    for (int idx = threadIdx.x; idx < BQ * BK; idx += NTHREADS) {
      const int r = idx / BK, c = idx - r * BK;
      if (in_branch(br, (k0 + c) - (q0 + r)))
        sS[r * g.ld_s + c] += sA[r * g.ld_a + c - r + BQ - 1];
    }
  }
  __syncthreads();
}

// dA of branch br in sDA: dA[r][w] = dS[r][w + r - BQ + 1] where that key
// lies in the tile and the branch, else 0 (every element written)
template <typename T>
__device__ void scatter_ds(const Geom<T>& g, const T* sDS, T* sDA, int br,
                           int q0, int k0) {
  for (int idx = threadIdx.x; idx < BQ * WP; idx += NTHREADS) {
    const int r = idx / WP, w = idx - r * WP;
    const int c = w + r - BQ + 1;
    T val = from_float<T>(0.f);
    if (c >= 0 && c < BK && in_branch(br, (k0 + c) - (q0 + r)))
      val = sDS[r * g.ld_p + c];
    sDA[r * g.ld_da + w] = val;
  }
}

// dS (and P keep) of the tile from the score tile sS and dO V^T in sA
template <typename T>
__device__ void ds_tile(const Geom<T>& g, const float* sS, const float* sA,
                        const float* sLse, const float* sDelta, T* sDS,
                        T* sPK, int bh, int q0, int k0, int T_len, int klen,
                        float sm_scale, const Dropout& drop) {
  for (int idx = threadIdx.x; idx < BQ * BK; idx += NTHREADS) {
    const int r = idx / BK, c = idx - r * BK;
    const int row = q0 + r, col = k0 + c;
    float ds = 0.f, pk = 0.f;
    if (row < T_len && col < klen) {
      const float p = expf(sS[r * g.ld_s + c] * sm_scale - sLse[r]);
      float dpa = sA[r * g.ld_a + c];
      pk = p;
      if (drop.on) {
        const bool kept = keep_bit(drop.seed, (uint32_t)bh, (uint32_t)row,
                                   (uint32_t)col, drop.threshold);
        pk = kept ? p * drop.keep_scale : 0.f;
        dpa = kept ? dpa * drop.keep_scale : 0.f;
      }
      ds = p * (dpa - sDelta[r]) * sm_scale;
    }
    sDS[r * g.ld_p + c] = from_float<T>(ds);
    if (sPK != nullptr) sPK[r * g.ld_p + c] = from_float<T>(pk);
  }
}

struct Inputs {
  const void *q_u, *q_v, *k, *v, *p, *dout;
  const float *lse, *delta;
  const int32_t* k_len;
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
relpos_bwd_dq_kernel(Inputs in, T* __restrict__ dq_u,
                     float* __restrict__ dq_v, float* __restrict__ dq_vs,
                     int H, int T_len, int d, float sm_scale, Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Geom<T> g(d, false);
  T* sQu = reinterpret_cast<T*>(smem + g.off_qu);
  T* sQv = reinterpret_cast<T*>(smem + g.off_qv);
  T* sDO = reinterpret_cast<T*>(smem + g.off_do);
  T* sK = reinterpret_cast<T*>(smem + g.off_k);
  T* sPw = reinterpret_cast<T*>(smem + g.off_pw);   // P windows, and V
  float* sS = reinterpret_cast<float*>(smem + g.off_s);
  float* sA = reinterpret_cast<float*>(smem + g.off_a);
  T* sDA = reinterpret_cast<T*>(smem + g.off_a);    // after dO V^T is used
  T* sDS = reinterpret_cast<T*>(smem + g.off_ds);
  float* sAcc[3];
  for (int i = 0; i < 3; ++i)
    sAcc[i] = reinterpret_cast<float*>(smem + g.off_acc[i]);
  float* sLse = reinterpret_cast<float*>(smem + g.off_stats);
  float* sDelta = sLse + BQ;

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  int klen = in.k_len[bh / H];
  klen = klen < 0 ? 0 : (klen > T_len ? T_len : klen);

  const size_t plane = (size_t)T_len * d;
  const T* qub = static_cast<const T*>(in.q_u) + bh * plane;
  const T* qvb = static_cast<const T*>(in.q_v) + bh * plane;
  const T* kb = static_cast<const T*>(in.k) + bh * plane;
  const T* vb = static_cast<const T*>(in.v) + bh * plane;
  const T* dob = static_cast<const T*>(in.dout) + bh * plane;
  const T* pb = static_cast<const T*>(in.p) + (bh % H) * plane;

  load_rows(sQu, g.ld_in, qub, q0, BQ, T_len, d, g.dp);
  load_rows(sQv, g.ld_in, qvb, q0, BQ + 1, T_len, d, g.dp);
  load_rows(sDO, g.ld_in, dob, q0, BQ, T_len, d, g.dp);
  for (int i = 0; i < 3; ++i) zero_fp32(sAcc[i], BQ * g.ld_o);
  load_stats(sLse, sDelta, in.lse, in.delta, (size_t)bh * T_len, q0, T_len);

  const int n_tiles = (klen + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's readers of sK/sPw/sA/sDS are done
    load_rows(sK, g.ld_in, kb, k0, BK, T_len, d, g.dp);
    __syncthreads();
    score_tile(g, sQu, sQv, sK, sPw, sS, sA, pb, q0, k0, T_len, d);

    load_rows(sPw, g.ld_in, vb, k0, BK, T_len, d, g.dp);
    __syncthreads();
    Mm<T>::template store<false, true>(sDO, g.ld_in, sPw, g.ld_in, sA,
                                       g.ld_a, BQ, BK, g.dp);   // dO V^T
    __syncthreads();
    ds_tile(g, sS, sA, sLse, sDelta, sDS, static_cast<T*>(nullptr), bh, q0,
            k0, T_len, klen, sm_scale, drop);
    __syncthreads();
    Mm<T>::template accumulate<false, false>(sDS, g.ld_p, sK, g.ld_in,
                                             sAcc[0], g.ld_o, BQ, g.dp, BK);
    for (int br = 0; br < 2; ++br) {
      if (!branch_used(br, q0, k0)) continue;
      __syncthreads();  // readers of sPw and sA are done
      load_rows(sPw, g.ld_in, pb, window_base(br, q0, k0, T_len), WP, T_len,
                d, g.dp);
      scatter_ds(g, sDS, sDA, br, q0, k0);
      __syncthreads();
      Mm<T>::template accumulate<false, false>(sDA, g.ld_da, sPw, g.ld_in,
                                               sAcc[1 + br], g.ld_o, BQ,
                                               g.dp, WP);
    }
  }
  __syncthreads();

  T* dqb = dq_u + bh * plane;
  float* dvb = dq_v + bh * plane;
  float* dvsb = dq_vs + bh * plane;
  for (int idx = threadIdx.x; idx < BQ * d; idx += NTHREADS) {
    const int r = idx / d, c = idx - r * d;
    if (q0 + r < T_len) {
      const size_t o = (size_t)(q0 + r) * d + c;
      dqb[o] = from_float<T>(sAcc[0][r * g.ld_o + c]);
      dvb[o] = sAcc[1][r * g.ld_o + c];
      dvsb[o] = sAcc[2][r * g.ld_o + c];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
relpos_bwd_dkdv_kernel(Inputs in, T* __restrict__ dk, T* __restrict__ dv,
                       float* __restrict__ dp, int H, int T_len, int d,
                       float sm_scale, Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Geom<T> g(d, true);
  T* sK = reinterpret_cast<T*>(smem + g.off_k);
  T* sV = reinterpret_cast<T*>(smem + g.off_v);
  T* sQu = reinterpret_cast<T*>(smem + g.off_qu);
  T* sQv = reinterpret_cast<T*>(smem + g.off_qv);
  T* sDO = reinterpret_cast<T*>(smem + g.off_do);
  T* sPw = reinterpret_cast<T*>(smem + g.off_pw);
  float* sS = reinterpret_cast<float*>(smem + g.off_s);
  float* sA = reinterpret_cast<float*>(smem + g.off_a);
  T* sDA = reinterpret_cast<T*>(smem + g.off_a);
  T* sPK = reinterpret_cast<T*>(smem + g.off_pk);
  T* sDS = reinterpret_cast<T*>(smem + g.off_ds);
  float* sDK = reinterpret_cast<float*>(smem + g.off_acc[0]);
  float* sDV = reinterpret_cast<float*>(smem + g.off_acc[1]);
  float* stage = reinterpret_cast<float*>(smem + g.off_stage);
  float* sLse = reinterpret_cast<float*>(smem + g.off_stats);
  float* sDelta = sLse + BQ;

  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y;
  const int h = bh % H;
  int klen = in.k_len[bh / H];
  klen = klen < 0 ? 0 : (klen > T_len ? T_len : klen);

  const size_t plane = (size_t)T_len * d;
  T* dkb = dk + bh * plane;
  T* dvb = dv + bh * plane;
  if (k0 >= klen) {  // every key of the block is masked: dk = dv = 0
    for (int idx = threadIdx.x; idx < BK * d; idx += NTHREADS) {
      const int r = idx / d, c = idx - r * d;
      if (k0 + r < T_len) {
        dkb[(size_t)(k0 + r) * d + c] = from_float<T>(0.f);
        dvb[(size_t)(k0 + r) * d + c] = from_float<T>(0.f);
      }
    }
    return;
  }

  const T* qub = static_cast<const T*>(in.q_u) + bh * plane;
  const T* qvb = static_cast<const T*>(in.q_v) + bh * plane;
  const T* dob = static_cast<const T*>(in.dout) + bh * plane;
  const T* pb = static_cast<const T*>(in.p) + h * plane;
  float* dpb = dp + h * plane;

  load_rows(sK, g.ld_in, static_cast<const T*>(in.k) + bh * plane, k0, BK,
            T_len, d, g.dp);
  load_rows(sV, g.ld_in, static_cast<const T*>(in.v) + bh * plane, k0, BK,
            T_len, d, g.dp);
  zero_fp32(sDK, BK * g.ld_o);
  zero_fp32(sDV, BK * g.ld_o);

  const int n_tiles = (T_len + BQ - 1) / BQ;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // previous tile's readers of the q-side tiles are done
    load_rows(sQu, g.ld_in, qub, q0, BQ, T_len, d, g.dp);
    load_rows(sQv, g.ld_in, qvb, q0, BQ + 1, T_len, d, g.dp);
    load_rows(sDO, g.ld_in, dob, q0, BQ, T_len, d, g.dp);
    load_stats(sLse, sDelta, in.lse, in.delta, (size_t)bh * T_len, q0,
               T_len);
    __syncthreads();
    score_tile(g, sQu, sQv, sK, sPw, sS, sA, pb, q0, k0, T_len, d);

    Mm<T>::template store<false, true>(sDO, g.ld_in, sV, g.ld_in, sA,
                                       g.ld_a, BQ, BK, g.dp);   // dO V^T
    __syncthreads();
    ds_tile(g, sS, sA, sLse, sDelta, sDS, sPK, bh, q0, k0, T_len, klen,
            sm_scale, drop);
    __syncthreads();
    // dv += (P keep)^T dO, dk += dS^T q_u
    Mm<T>::template accumulate<true, false>(sPK, g.ld_p, sDO, g.ld_in, sDV,
                                            g.ld_o, BK, g.dp, BQ);
    Mm<T>::template accumulate<true, false>(sDS, g.ld_p, sQu, g.ld_in, sDK,
                                            g.ld_o, BK, g.dp, BQ);
    for (int br = 0; br < 2; ++br) {
      if (!branch_used(br, q0, k0)) continue;
      const int base = window_base(br, q0, k0, T_len);
      __syncthreads();  // readers of sA (dO V^T, the last dA) are done
      scatter_ds(g, sDS, sDA, br, q0, k0);
      __syncthreads();
      // dP_win = dA^T Q_v (branch 2: q_v one row down), rows inside [0, T)
      Mm<T>::template each<true, false>(
          sDA, g.ld_da, sQv + br * g.ld_in, g.ld_in, WP, g.dp, BQ, stage,
          [&](int m, int n, float4 x) {
            // n % 4 == 0 and d % 8 == 0: the 4 columns lie inside d or
            // past it together, and start on a 16-byte boundary
            const int row = base + m;
            if (n < d && row >= 0 && row < T_len &&
                (x.x != 0.f || x.y != 0.f || x.z != 0.f || x.w != 0.f))
              atomic_add4(dpb + (size_t)row * d + n, x);
          });
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BK * d; idx += NTHREADS) {
    const int r = idx / d, c = idx - r * d;
    if (k0 + r < T_len) {
      dkb[(size_t)(k0 + r) * d + c] = from_float<T>(sDK[r * g.ld_o + c]);
      dvb[(size_t)(k0 + r) * d + c] = from_float<T>(sDV[r * g.ld_o + c]);
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int launch_dq(const Inputs& in, void* dq_u, void* dq_v, void* dq_vs, int B,
              int H, int T_len, int d, float sm_scale, Dropout drop,
              cudaStream_t stream) {
  const Geom<T> g(d, false);
  int err = set_smem(relpos_bwd_dq_kernel<T>, g.bytes);
  if (err != 0) return err;
  dim3 grid((T_len + BQ - 1) / BQ, B * H);
  relpos_bwd_dq_kernel<T><<<grid, NTHREADS, g.bytes, stream>>>(
      in, static_cast<T*>(dq_u), static_cast<float*>(dq_v),
      static_cast<float*>(dq_vs), H, T_len, d, sm_scale, drop);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkdv(const Inputs& in, void* dk, void* dv, void* dp, int B, int H,
                int T_len, int d, float sm_scale, Dropout drop,
                cudaStream_t stream) {
  const Geom<T> g(d, true);
  int err = set_smem(relpos_bwd_dkdv_kernel<T>, g.bytes);
  if (err != 0) return err;
  dim3 grid((T_len + BK - 1) / BK, B * H);
  relpos_bwd_dkdv_kernel<T><<<grid, NTHREADS, g.bytes, stream>>>(
      in, static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(dp),
      H, T_len, d, sm_scale, drop);
  return (int)cudaGetLastError();
}

bool bad_sizes(int B, int H, int T_len, int d) {
  return d <= 0 || d > 128 || d % 8 != 0 || T_len <= 0 || B * H > 65535;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q_u, q_v, k, v, dout (B,H,T,d) and
// p (H,T,d) of that dtype; lse and delta (B,H,T) fp32; k_len (B,) int32;
// all contiguous on the device. dq_u is like q_u; dq_v and dq_vs (the
// share of q_v's shifted copy, row i for q_v row i + 1) are fp32 like q_u;
// dk and dv like k; dp is an fp32 (H,T,d) buffer that the caller zeroes
// and the kernel adds the batch's dP into. dropout != 0 turns on the keep
// mask with `threshold` (int(rate * 2^32)), `keep_scale` (1/(1 - rate) in
// fp32) and `seed` (the int32 seed's bits), the forward's values. Each
// returns the cudaError_t of its launch (0 = success), including a refusal
// of the shared memory it needs.
int flash_relpos_bwd_dq(const void* q_u, const void* q_v, const void* k,
                        const void* v, const void* p, const void* dout,
                        const void* lse, const void* delta,
                        const void* k_len, void* dq_u, void* dq_v,
                        void* dq_vs, int B, int H, int T_len, int d,
                        float sm_scale, int dropout, unsigned int threshold,
                        float keep_scale, unsigned int seed, int dtype,
                        void* stream) {
  if (bad_sizes(B, H, T_len, d)) return (int)cudaErrorInvalidValue;
  const Inputs in{q_u, q_v, k, v, p, dout,
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta),
                  static_cast<const int32_t*>(k_len)};
  const Dropout drop{dropout, threshold, keep_scale, seed};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dq<float>(in, dq_u, dq_v, dq_vs, B, H, T_len, d, sm_scale,
                            drop, s);
  if (dtype == 1)
    return launch_dq<__nv_bfloat16>(in, dq_u, dq_v, dq_vs, B, H, T_len, d,
                                    sm_scale, drop, s);
  return (int)cudaErrorInvalidValue;
}

int flash_relpos_bwd_dkdv(const void* q_u, const void* q_v, const void* k,
                          const void* v, const void* p, const void* dout,
                          const void* lse, const void* delta,
                          const void* k_len, void* dk, void* dv, void* dp,
                          int B, int H, int T_len, int d, float sm_scale,
                          int dropout, unsigned int threshold,
                          float keep_scale, unsigned int seed, int dtype,
                          void* stream) {
  if (bad_sizes(B, H, T_len, d)) return (int)cudaErrorInvalidValue;
  const Inputs in{q_u, q_v, k, v, p, dout,
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta),
                  static_cast<const int32_t*>(k_len)};
  const Dropout drop{dropout, threshold, keep_scale, seed};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dkdv<float>(in, dk, dv, dp, B, H, T_len, d, sm_scale, drop,
                              s);
  if (dtype == 1)
    return launch_dkdv<__nv_bfloat16>(in, dk, dv, dp, B, H, T_len, d,
                                      sm_scale, drop, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
