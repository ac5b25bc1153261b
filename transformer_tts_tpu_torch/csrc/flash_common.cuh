// Device helpers shared by the flash-attention forward (K1, K1-d, K6,
// flash_attention_fwd.cu) and backward (K2, K6's, flash_attention_bwd.cu):
// the tile size, conversions, tile loads, the two tile products, the
// additive bias's tile load and the dbias tile store, and the dropout
// hash. The backward rebuilds the forward's keep mask, so both must take
// `keep_bit` from here; ops/flash_attention.keep_bits is its plain
// version, held to JAX's `_keep_mask` by the tests.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace flash {

constexpr int BT = 64;          // rows of every tile (q rows and keys)
constexpr int NTHREADS = 128;   // 4 warps; warp w owns tile rows 16w..16w+15

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float
to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// K6's additive bias: S[r][c] += bias[row0 + r][col0 + c] over the BT x BT
// fp32 score tile in shared memory (row stride lds), for rows < rows_valid
// and columns < cols_valid of the (rows_valid, cols_valid) bias plane; the
// rest of the tile is left as it is (the key mask or the row bound takes
// it out). Each element is read once. Where cols_valid is a multiple of
// the 16-byte vector (8 bf16, 4 fp32) and the plane starts on a 16-byte
// boundary, a thread moves 16 bytes at a time, neighbouring threads on
// neighbouring chunks of a row; every chunk then lies wholly inside or
// wholly past the plane's edge. Otherwise it moves single elements.
template <typename T>
__device__ void add_bias(float* S, int lds, const T* bias, int row0,
                         int rows_valid, int col0, int cols_valid) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = cols_valid % VEC == 0 &&
                   (reinterpret_cast<uintptr_t>(bias) & 15) == 0;
  if (vec) {
    constexpr int CHUNKS = BT / VEC;
    for (int idx = threadIdx.x; idx < BT * CHUNKS; idx += NTHREADS) {
      const int r = idx / CHUNKS, c = (idx - r * CHUNKS) * VEC;
      const int row = row0 + r, col = col0 + c;
      if (row < rows_valid && col < cols_valid) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            bias + (size_t)row * cols_valid + col);
        const T* x = reinterpret_cast<const T*>(&raw);
        float* s = S + r * lds + c;
#pragma unroll
        for (int e = 0; e < VEC; ++e) s[e] += to_float<T>(x[e]);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < BT * BT; idx += NTHREADS) {
      const int r = idx / BT, c = idx - r * BT;
      const int row = row0 + r, col = col0 + c;
      if (row < rows_valid && col < cols_valid)
        S[r * lds + c] += to_float<T>(bias[(size_t)row * cols_valid + col]);
    }
  }
}

// The dbias tile: dst[row0 + r][col0 + c] = src[r][c] (src a BT x BT tile
// in shared memory, row stride lds; zeros when src is null) for rows <
// rows_valid and columns < cols_valid of the (rows_valid, cols_valid)
// plane, with 16-byte stores under the same rule as add_bias.
template <typename T>
__device__ void store_bias_tile(T* dst, const T* src, int lds, int row0,
                                int rows_valid, int col0, int cols_valid) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = cols_valid % VEC == 0 &&
                   (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
  if (vec) {
    constexpr int CHUNKS = BT / VEC;
    for (int idx = threadIdx.x; idx < BT * CHUNKS; idx += NTHREADS) {
      const int r = idx / CHUNKS, c = (idx - r * CHUNKS) * VEC;
      const int row = row0 + r, col = col0 + c;
      if (row < rows_valid && col < cols_valid) {
        uint4 raw;
        T* x = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          x[e] = src ? src[r * lds + c + e] : from_float<T>(0.f);
        *reinterpret_cast<uint4*>(dst + (size_t)row * cols_valid + col) = raw;
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < BT * BT; idx += NTHREADS) {
      const int r = idx / BT, c = idx - r * BT;
      const int row = row0 + r, col = col0 + c;
      if (row < rows_valid && col < cols_valid)
        dst[(size_t)row * cols_valid + col] =
            src ? src[r * lds + c] : from_float<T>(0.f);
    }
  }
}

// The keep bit of `_keep_mask` (transformer_tts_tpu/ops/flash_attention.py
// :59-87) at global (bh, row, col): murmur3 fmix32 of seed + bh*0x9E3779B9
// + row*0x85EBCA6B + col*0xC2B2AE35 in uint32 arithmetic, kept iff the hash
// is >= threshold = int(rate * 2^32).
__device__ __forceinline__ bool keep_bit(uint32_t seed, uint32_t bh,
                                         uint32_t row, uint32_t col,
                                         uint32_t threshold) {
  uint32_t x = seed + bh * 0x9E3779B9u + row * 0x85EBCA6Bu +
               col * 0xC2B2AE35u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= threshold;
}

// The batch-head that `keep_bit` hashes for the local batch-head bh of a
// tensor of H heads that holds heads [head_offset, head_offset + H) of
// heads_total (a rank's heads under tensor parallelism): the global
// b*heads_total + head_offset + h, so every rank draws its slice of the
// unsharded mask. With head_offset 0 and heads_total H it is bh. Only the
// hash reads it; every address keeps the local bh.
__device__ __forceinline__ uint32_t hash_head(int bh, int H, int head_offset,
                                              int heads_total) {
  return (uint32_t)((bh / H) * heads_total + head_offset + bh % H);
}

// rows [row0, row0+BT) x columns [0, width) of a (rows_valid, d) matrix into
// shared memory; zero past rows_valid and past d
template <typename T>
__device__ void load_tile(T* dst, int ld, const T* src, int row0,
                          int rows_valid, int d, int width) {
  for (int idx = threadIdx.x; idx < BT * width; idx += NTHREADS) {
    const int r = idx / width, c = idx - r * width;
    const int row = row0 + r;
    T val = from_float<T>(0.f);
    if (row < rows_valid && c < d) val = src[(size_t)row * d + c];
    dst[r * ld + c] = val;
  }
}

// C[64][64] = A[64][d] B[64][d]^T, and C[64][d] = A[64][64] B[64][d] (plus
// C when `accumulate`), specialised by type: A, B in shared memory in T, C
// in fp32. bf16 runs on the tensor cores through WMMA (bf16 in, fp32
// accumulate, depth padded to 16 with zeros); fp32 runs plain FMAs, so the
// result matches an fp32 reference to rounding.
template <typename T> struct Products;

template <> struct Products<float> {
  // thread t: rows 4*(t/8)..+3, columns (t%8) + 8*j
  __device__ static void abt(const float* A, int lda, const float* B,
                             int ldb, float* C, int ldc, int d) {
    const int t = threadIdx.x;
    const int r0 = (t >> 3) * 4, c0 = t & 7;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int kk = 0; kk < d; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = A[(r0 + i) * lda + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = B[(c0 + 8 * j) * ldb + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) C[(r0 + i) * ldc + c0 + 8 * j] = acc[i][j];
  }

  // thread t: rows 4*(t/8)..+3, columns (t%8) + 8*j for j < d/8 (d <= 128)
  __device__ static void ab(const float* A, int lda, const float* B,
                            int ldb, float* C, int ldc, int d,
                            bool accumulate) {
    const int t = threadIdx.x;
    const int r0 = (t >> 3) * 4, c0 = t & 7;
    const int nj = d >> 3;
    float acc[4][16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        acc[i][j] = (accumulate && j < nj) ? C[(r0 + i) * ldc + c0 + 8 * j]
                                           : 0.f;
    for (int c = 0; c < BT; ++c) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = A[(r0 + i) * lda + c];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (j < nj) {
          const float b = B[c * ldb + c0 + 8 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (j < nj) C[(r0 + i) * ldc + c0 + 8 * j] = acc[i][j];
  }
};

template <> struct Products<__nv_bfloat16> {
  using bf16 = __nv_bfloat16;
  // warp w: C rows 16w..16w+15, all 64 columns
  __device__ static void abt(const bf16* A, int lda, const bf16* B, int ldb,
                             float* C, int ldc, int d) {
    using namespace nvcuda;
    const int w = threadIdx.x >> 5;
    const int dp = round_up(d, 16);
    for (int nb = 0; nb < BT / 16; ++nb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kb = 0; kb < dp / 16; ++kb) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, A + 16 * w * lda + 16 * kb, lda);
        // B^T[k][n] = B[n][k]: B stored row-major is B^T column-major
        wmma::load_matrix_sync(b, B + 16 * nb * ldb + 16 * kb, ldb);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(C + 16 * w * ldc + 16 * nb, acc, ldc,
                              wmma::mem_row_major);
    }
  }

  // warp w: C rows 16w..16w+15, round_up(d, 16) columns
  __device__ static void ab(const bf16* A, int lda, const bf16* B, int ldb,
                            float* C, int ldc, int d, bool accumulate) {
    using namespace nvcuda;
    const int w = threadIdx.x >> 5;
    const int dp = round_up(d, 16);
    for (int nb = 0; nb < dp / 16; ++nb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* c = C + 16 * w * ldc + 16 * nb;
      if (accumulate)
        wmma::load_matrix_sync(acc, c, ldc, wmma::mem_row_major);
      else
        wmma::fill_fragment(acc, 0.f);
      for (int kb = 0; kb < BT / 16; ++kb) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, A + 16 * w * lda + 16 * kb, lda);
        wmma::load_matrix_sync(b, B + 16 * kb * ldb + 16 * nb, ldb);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(c, acc, ldc, wmma::mem_row_major);
    }
  }
};

}  // namespace flash
