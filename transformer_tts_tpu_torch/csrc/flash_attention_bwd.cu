// Flash-attention backward for Hopper (sm_90a): prefix key mask, optional
// attention-prob dropout, non-causal (K2) or causal (K3), optionally with
// an additive bias and its gradient (K6).
//
// Replaces the TPU kernels `_dq_kernel` and `_dkdv_kernel` driven by
// `_flash_bwd` (transformer_tts_tpu/ops/flash_attention.py:266-550): without
// a bias, with causal=False the backward of FastSpeech 2 training (K2), with
// causal=True that of the AR Transformer-TTS decoder's masked
// self-attention (K3); with a bias, K6's backward (`has_bias`: the dq
// kernel's :277-281, :301-302 and :323-334, called at :479; the dk/dv
// kernel's :349-353 and :374-375, called at :520), the VJP `_flash_b` of
// `flash_attention_with_bias` (:585-614, non-causal).
//
// What it computes, per batch-head bh = b*H + h, from the forward's lse and
// delta = rowsum(dO * O) (fp32, computed by the caller as `_flash_bwd` does):
//   P[r][c]  = exp((q[r].k[c] + bias[r][c]) * sm_scale - lse[r])
//                                                   for keys c < k_len[b]
//   dP[r][c] = (dO[r] . v[c]) * keep(r, c)
//   dS[r][c] = P (dP - delta[r]) * sm_scale
//   dq = dS K,  dk = dS^T Q,  dv = (P keep)^T dO,  dbias = dS
// with dS and P*keep cast to the input dtype before their products, as the
// TPU kernels do (bias 0 without one). dbias is the gradient of the
// pre-scale logits, dS in fp32 cast to the bias's dtype (q's): the dq
// kernel writes it tile by tile beside dq. It is exactly 0 at every key
// at or past k_len[b] (P is 0 there), on every row of a batch row with
// k_len = 0, and on every tile the key loop skips: the dq kernel writes
// those tiles' zeros itself after its loop, so the wrapper allocates dbias
// uninitialised and no other kernel touches it. keep(r, c) is the
// forward's `_keep_mask` hash (1/(1-rate) or 0), rebuilt here from the
// global coordinates, never stored. Rows with no valid key (lse = -1e30)
// give P = 0 through the key mask; dk and dv are exactly 0 for keys at or
// past k_len[b]. No atomics: each output row is written by one block, so
// the gradients are deterministic.
//
// Causal (K3): P, dP and dS exist only for c <= r (global, top-left-aligned
// indices, each row its own q0 + r). The dq kernel stops its key-tile loop
// after the tile holding key q0 + BT - 1 (the TPU kernel's skip at
// :329-335); the dk/dv kernel starts its q-tile loop at the tile holding
// row k0, k0 / BT (BQ = BK = BT), the first that sees any of its keys
// (:406-407) -- starting one later would drop the diagonal tile.
//
// Bound on the card: 10*B*H*T_q*k_len*d operations (five products) against
// Q, K, V, O, dO, dQ, dK and dV moved once; at the decoder's training shapes
// (d = 96, T ~ 1024) that is ~1 byte per 300 operations in bf16, so the
// tensor cores bound it. K6 adds the bias read by both kernels over the
// valid keys and the whole dbias written once: at T = 1024, d = 96 those
// two planes outweigh every other byte, and bytes bound K6's backward.
//
// Design (simple first version; wgmma, TMA and register-resident
// accumulators come later):
//   * the dq kernel: one 128-thread block per (64 q rows, bh), a loop over
//     the 64-key tiles below k_len[b]; per tile S = Q K^T and dP = dO V^T
//     into shared memory, dS elementwise, then dq += dS K;
//   * the dk/dv kernel: one block per (64 keys, bh), a loop over the
//     64-row q tiles (from k0 / BT when causal); per tile S and dP, then
//     (P keep)^T and dS^T written
//     transposed into shared memory, dv += (P keep)^T dO and dk += dS^T Q.
//     A block whose keys all lie at or past k_len[b] writes zeros;
//   * K6: both kernels add the bias tile into S in shared memory right
//     after Q K^T (`add_bias`, 16-byte loads where aligned), as the
//     forward does; the dq kernel stores each dS tile (already in the
//     input dtype for the dS K product) to dbias with 16-byte stores
//     (`store_bias_tile`), then zeros for the tiles past its loop;
//   * the products, the tile loads and the dropout hash are K1's, from
//     flash_common.cuh: WMMA (bf16 in, fp32 accumulate) for bf16 and FMAs
//     in fp32 for fp32, so fp32 matches the fp32 reference to rounding; the
//     fp32 accumulators live in shared memory; the ragged edges in T_q, T_k
//     and d are masked in the loads and stores, with no padding copies in
//     device memory.

#include "flash_common.cuh"

namespace {

using flash::add_bias;
using flash::BT;
using flash::from_float;
using flash::hash_head;
using flash::keep_bit;
using flash::load_tile;
using flash::NTHREADS;
using flash::Products;
using flash::round_up;
using flash::store_bias_tile;

// Shared-memory geometry, identical on host and device.
//   dp   : depth padded for the products (16 for WMMA, 1 for FMAs)
//   ld_in: row stride of the four 64 x d input tiles (elements of T)
//   ld_s : row stride of the two fp32 64 x 64 tiles (S and dP)
//   ld_p : row stride of the 64 x 64 tiles in T (dS, and P keep in dk/dv)
//   ld_o : row stride of the fp32 64 x dp accumulators
// n_p and n_acc are 1 for the dq kernel and 2 for the dk/dv kernel.
template <typename T> struct Geom {
  int dp, ld_in, ld_s, ld_p, ld_o;
  size_t off_in[4], off_s, off_dp, off_p[2], off_acc[2], off_stats, bytes;
  __host__ __device__ Geom(int d, int n_p, int n_acc) {
    const bool wmma = sizeof(T) == 2;
    dp = wmma ? round_up(d, 16) : d;
    // WMMA wants a stride that is a multiple of 8 (16-bit) or 4 (fp32);
    // the FMA path wants an odd stride so that rows fall in other banks.
    ld_in = wmma ? dp + 8 : d + 1;
    ld_s = wmma ? BT + 4 : BT + 1;
    ld_p = wmma ? BT + 8 : BT + 1;
    ld_o = wmma ? dp + 4 : d + 1;
    const size_t in_bytes = round_up(BT * ld_in * (int)sizeof(T), 128);
    const size_t s_bytes = round_up(BT * ld_s * 4, 128);
    const size_t p_bytes = round_up(BT * ld_p * (int)sizeof(T), 128);
    const size_t acc_bytes = round_up(BT * ld_o * 4, 128);
    size_t off = 0;
    for (int i = 0; i < 4; ++i, off += in_bytes) off_in[i] = off;
    off_s = off;
    off += s_bytes;
    off_dp = off;
    off += s_bytes;
    for (int i = 0; i < 2; ++i) {
      off_p[i] = off;
      if (i < n_p) off += p_bytes;
    }
    for (int i = 0; i < 2; ++i) {
      off_acc[i] = off;
      if (i < n_acc) off += acc_bytes;
    }
    off_stats = off;
    bytes = off + 2 * BT * 4;
  }
};

__device__ void zero_fp32(float* dst, int n) {
  for (int idx = threadIdx.x; idx < n; idx += NTHREADS) dst[idx] = 0.f;
}

// lse and delta of q rows [q0, q0+BT) into shared memory (0 past T_q)
__device__ void load_stats(float* s_lse, float* s_delta, const float* lse,
                           const float* delta, size_t base, int q0,
                           int T_q) {
  if (threadIdx.x < BT) {
    const int row = q0 + threadIdx.x;
    s_lse[threadIdx.x] = row < T_q ? lse[base + row] : 0.f;
    s_delta[threadIdx.x] = row < T_q ? delta[base + row] : 0.f;
  }
}

// rows [row0, row0+BT) of a (rows_valid, d) output from an fp32 tile
template <typename T>
__device__ void store_tile(T* dst, const float* src, int ld, int row0,
                           int rows_valid, int d) {
  for (int idx = threadIdx.x; idx < BT * d; idx += NTHREADS) {
    const int r = idx / d, c = idx - r * d;
    if (row0 + r < rows_valid)
      dst[(size_t)(row0 + r) * d + c] = from_float<T>(src[r * ld + c]);
  }
}

struct Dropout {
  int on;
  uint32_t threshold;
  float keep_scale;
  uint32_t seed;
  int head_offset;   // the hash's batch-head: flash_common.cuh hash_head
  int heads_total;
};

// key `col` counts for query `row` (global indices)
__device__ __forceinline__ bool attends(int row, int col, int klen,
                                        int causal) {
  return col < klen && (!causal || col <= row);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ bias,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int32_t* __restrict__ k_len, T* __restrict__ dq,
                    T* __restrict__ dbias, int H, int T_q, int T_k, int d,
                    float sm_scale,
                    Dropout drop, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Geom<T> g(d, 1, 1);
  T* sQ = reinterpret_cast<T*>(smem + g.off_in[0]);
  T* sDO = reinterpret_cast<T*>(smem + g.off_in[1]);
  T* sK = reinterpret_cast<T*>(smem + g.off_in[2]);
  T* sV = reinterpret_cast<T*>(smem + g.off_in[3]);
  float* sS = reinterpret_cast<float*>(smem + g.off_s);
  float* sDP = reinterpret_cast<float*>(smem + g.off_dp);
  T* sDS = reinterpret_cast<T*>(smem + g.off_p[0]);
  float* sAcc = reinterpret_cast<float*>(smem + g.off_acc[0]);
  float* sLse = reinterpret_cast<float*>(smem + g.off_stats);
  float* sDelta = sLse + BT;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BT;
  const int bh = blockIdx.y;
  const uint32_t hbh = hash_head(bh, H, drop.head_offset, drop.heads_total);
  int klen = k_len[bh / H];
  klen = klen < 0 ? 0 : (klen > T_k ? T_k : klen);

  const size_t qbase = (size_t)bh * T_q * d, kbase = (size_t)bh * T_k * d;
  const size_t bbase = (size_t)bh * T_q * T_k;
  const T* bb = bias ? bias + bbase : nullptr;
  T* dbb = dbias ? dbias + bbase : nullptr;
  load_tile(sQ, g.ld_in, q + qbase, q0, T_q, d, g.dp);
  load_tile(sDO, g.ld_in, dout + qbase, q0, T_q, d, g.dp);
  zero_fp32(sAcc, BT * g.ld_o);
  load_stats(sLse, sDelta, lse, delta, (size_t)bh * T_q, q0, T_q);

  int n_tiles = (klen + BT - 1) / BT;
  if (causal) {  // the last tile holding a key that row q0 + BT - 1 sees
    const int diag = (q0 + BT - 1) / BT + 1;
    n_tiles = n_tiles < diag ? n_tiles : diag;
  }
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // previous tile's readers of sK/sV/sDS are done
    load_tile(sK, g.ld_in, k + kbase, k0, T_k, d, g.dp);
    load_tile(sV, g.ld_in, v + kbase, k0, T_k, d, g.dp);
    __syncthreads();

    Products<T>::abt(sQ, g.ld_in, sK, g.ld_in, sS, g.ld_s, d);
    Products<T>::abt(sDO, g.ld_in, sV, g.ld_in, sDP, g.ld_s, d);
    __syncthreads();
    if (bb) {  // K6: S += bias tile, before the scale
      add_bias(sS, g.ld_s, bb, q0, T_q, k0, T_k);
      __syncthreads();
    }

    for (int idx = tid; idx < BT * BT; idx += NTHREADS) {
      const int r = idx / BT, c = idx - r * BT;
      float ds = 0.f;
      if (q0 + r < T_q && attends(q0 + r, k0 + c, klen, causal)) {
        const float p = expf(sS[r * g.ld_s + c] * sm_scale - sLse[r]);
        float dp = sDP[r * g.ld_s + c];
        if (drop.on)
          dp = keep_bit(drop.seed, hbh, (uint32_t)(q0 + r),
                        (uint32_t)(k0 + c), drop.threshold)
                   ? dp * drop.keep_scale
                   : 0.f;
        ds = p * (dp - sDelta[r]) * sm_scale;
      }
      sDS[r * g.ld_p + c] = from_float<T>(ds);
    }
    __syncthreads();

    // dbias = dS: both this store and the product only read sDS
    if (dbb) store_bias_tile(dbb, sDS, g.ld_p, q0, T_q, k0, T_k);
    Products<T>::ab(sDS, g.ld_p, sK, g.ld_in, sAcc, g.ld_o, d, true);
  }
  // the tiles the loop skipped (past k_len, or past the diagonal when
  // causal) get dbias = 0; a batch row with k_len = 0 skips them all
  if (dbb)
    for (int kt = n_tiles; kt * BT < T_k; ++kt)
      store_bias_tile(dbb, static_cast<const T*>(nullptr), 0, q0, T_q,
                      kt * BT, T_k);
  __syncthreads();
  store_tile(dq + qbase, sAcc, g.ld_o, q0, T_q, d);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ bias,
                      const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int32_t* __restrict__ k_len, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int T_q, int T_k, int d,
                      float sm_scale, Dropout drop, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Geom<T> g(d, 2, 2);
  T* sK = reinterpret_cast<T*>(smem + g.off_in[0]);
  T* sV = reinterpret_cast<T*>(smem + g.off_in[1]);
  T* sQ = reinterpret_cast<T*>(smem + g.off_in[2]);
  T* sDO = reinterpret_cast<T*>(smem + g.off_in[3]);
  float* sS = reinterpret_cast<float*>(smem + g.off_s);
  float* sDP = reinterpret_cast<float*>(smem + g.off_dp);
  T* sPT = reinterpret_cast<T*>(smem + g.off_p[0]);    // (P keep)^T
  T* sDST = reinterpret_cast<T*>(smem + g.off_p[1]);   // dS^T
  float* sDK = reinterpret_cast<float*>(smem + g.off_acc[0]);
  float* sDV = reinterpret_cast<float*>(smem + g.off_acc[1]);
  float* sLse = reinterpret_cast<float*>(smem + g.off_stats);
  float* sDelta = sLse + BT;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BT;
  const int bh = blockIdx.y;
  const uint32_t hbh = hash_head(bh, H, drop.head_offset, drop.heads_total);
  int klen = k_len[bh / H];
  klen = klen < 0 ? 0 : (klen > T_k ? T_k : klen);

  const size_t qbase = (size_t)bh * T_q * d, kbase = (size_t)bh * T_k * d;
  const T* bb = bias ? bias + (size_t)bh * T_q * T_k : nullptr;
  if (k0 >= klen) {  // every key of the tile is masked: dk = dv = 0
    for (int idx = tid; idx < BT * d; idx += NTHREADS) {
      const int r = idx / d, c = idx - r * d;
      if (k0 + r < T_k) {
        dk[kbase + (size_t)(k0 + r) * d + c] = from_float<T>(0.f);
        dv[kbase + (size_t)(k0 + r) * d + c] = from_float<T>(0.f);
      }
    }
    return;
  }

  load_tile(sK, g.ld_in, k + kbase, k0, T_k, d, g.dp);
  load_tile(sV, g.ld_in, v + kbase, k0, T_k, d, g.dp);
  zero_fp32(sDK, BT * g.ld_o);
  zero_fp32(sDV, BT * g.ld_o);

  const int n_tiles = (T_q + BT - 1) / BT;
  // causal: the first q tile holding a row >= k0 (rows below see no key
  // of this block); k0 is a multiple of BT, so that tile starts at k0
  const int qt0 = causal ? k0 / BT : 0;
  for (int qt = qt0; qt < n_tiles; ++qt) {
    const int q0 = qt * BT;
    __syncthreads();  // previous tile's readers of sQ/sDO/sPT/sDST are done
    load_tile(sQ, g.ld_in, q + qbase, q0, T_q, d, g.dp);
    load_tile(sDO, g.ld_in, dout + qbase, q0, T_q, d, g.dp);
    load_stats(sLse, sDelta, lse, delta, (size_t)bh * T_q, q0, T_q);
    __syncthreads();

    // S[q row][key] and dP[q row][key]
    Products<T>::abt(sQ, g.ld_in, sK, g.ld_in, sS, g.ld_s, d);
    Products<T>::abt(sDO, g.ld_in, sV, g.ld_in, sDP, g.ld_s, d);
    __syncthreads();
    if (bb) {  // K6: S += bias tile (rows q0.., keys k0..), before the scale
      add_bias(sS, g.ld_s, bb, q0, T_q, k0, T_k);
      __syncthreads();
    }

    for (int idx = tid; idx < BT * BT; idx += NTHREADS) {
      const int r = idx / BT, c = idx - r * BT;   // q row r, key c
      float pk = 0.f, ds = 0.f;
      if (q0 + r < T_q && attends(q0 + r, k0 + c, klen, causal)) {
        const float p = expf(sS[r * g.ld_s + c] * sm_scale - sLse[r]);
        float dp = sDP[r * g.ld_s + c];
        pk = p;
        if (drop.on) {
          const bool kept = keep_bit(drop.seed, hbh,
                                     (uint32_t)(q0 + r), (uint32_t)(k0 + c),
                                     drop.threshold);
          pk = kept ? p * drop.keep_scale : 0.f;
          dp = kept ? dp * drop.keep_scale : 0.f;
        }
        ds = p * (dp - sDelta[r]) * sm_scale;
      }
      sPT[c * g.ld_p + r] = from_float<T>(pk);
      sDST[c * g.ld_p + r] = from_float<T>(ds);
    }
    __syncthreads();

    Products<T>::ab(sPT, g.ld_p, sDO, g.ld_in, sDV, g.ld_o, d, true);
    Products<T>::ab(sDST, g.ld_p, sQ, g.ld_in, sDK, g.ld_o, d, true);
  }
  __syncthreads();
  store_tile(dk + kbase, sDK, g.ld_o, k0, T_k, d);
  store_tile(dv + kbase, sDV, g.ld_o, k0, T_k, d);
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* bias,
              const void* dout, const float* lse, const float* delta,
              const int32_t* k_len, void* dq, void* dbias, int B, int H,
              int T_q, int T_k, int d,
              float sm_scale, Dropout drop, int causal, cudaStream_t stream) {
  const Geom<T> g(d, 1, 1);
  int err = set_smem(flash_bwd_dq_kernel<T>, g.bytes);
  if (err != 0) return err;
  dim3 grid((T_q + BT - 1) / BT, B * H);
  flash_bwd_dq_kernel<T><<<grid, NTHREADS, g.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(bias),
      static_cast<const T*>(dout), lse, delta, k_len, static_cast<T*>(dq),
      static_cast<T*>(dbias), H, T_q, T_k, d, sm_scale, drop, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* bias, const void* dout, const float* lse,
                const float* delta,
                const int32_t* k_len, void* dk, void* dv, int B, int H,
                int T_q, int T_k, int d, float sm_scale, Dropout drop,
                int causal, cudaStream_t stream) {
  const Geom<T> g(d, 2, 2);
  int err = set_smem(flash_bwd_dkdv_kernel<T>, g.bytes);
  if (err != 0) return err;
  dim3 grid((T_k + BT - 1) / BT, B * H);
  flash_bwd_dkdv_kernel<T><<<grid, NTHREADS, g.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(bias),
      static_cast<const T*>(dout), lse, delta, k_len, static_cast<T*>(dk),
      static_cast<T*>(dv), H, T_q, T_k, d, sm_scale, drop, causal);
  return (int)cudaGetLastError();
}

bool bad_sizes(int d, int T_q, int T_k) {
  return d <= 0 || d > 128 || d % 8 != 0 || T_q <= 0 || T_k <= 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q/dout (B,H,T_q,d), k/v (B,H,T_k,d),
// lse and delta (B,H,T_q) fp32, k_len (B,) int32, dq like q, dk/dv like k,
// all contiguous on the device. dropout != 0 turns on the keep mask with
// `threshold` (int(rate * 2^32)), `keep_scale` (1/(1 - rate) in fp32) and
// `seed` (the int32 seed's bits), the forward's values; causal != 0 is K3
// (keys past the query row masked), as in the forward. bias is null (K2,
// K3) or the forward's (B,H,T_q,T_k) additive term in q's dtype (K6);
// dbias, null or like bias, receives dS. Each returns the cudaError_t of
// its launch (0 = success), including a refusal of the shared memory it
// needs. head_offset and heads_total set the hash's batch-head, as in the
// forward (0 and H for the whole tensor).
int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const void* bias, const void* dout,
                           const void* lse, const void* delta,
                           const void* k_len, void* dq, void* dbias, int B,
                           int H, int T_q, int T_k, int d,
                           float sm_scale, int dropout,
                           unsigned int threshold, float keep_scale,
                           unsigned int seed, int causal, int head_offset,
                           int heads_total, int dtype, void* stream) {
  if (bad_sizes(d, T_q, T_k)) return (int)cudaErrorInvalidValue;
  const Dropout drop{dropout, threshold, keep_scale, seed, head_offset,
                     heads_total};
  auto s = static_cast<cudaStream_t>(stream);
  auto l = static_cast<const float*>(lse);
  auto dl = static_cast<const float*>(delta);
  auto kl = static_cast<const int32_t*>(k_len);
  if (dtype == 0)
    return launch_dq<float>(q, k, v, bias, dout, l, dl, kl, dq, dbias, B, H,
                            T_q, T_k, d, sm_scale, drop, causal, s);
  if (dtype == 1)
    return launch_dq<__nv_bfloat16>(q, k, v, bias, dout, l, dl, kl, dq,
                                    dbias, B, H, T_q, T_k, d, sm_scale, drop,
                                    causal, s);
  return (int)cudaErrorInvalidValue;
}

int flash_attention_bwd_dkdv(const void* q, const void* k, const void* v,
                             const void* bias, const void* dout,
                             const void* lse,
                             const void* delta, const void* k_len, void* dk,
                             void* dv, int B, int H, int T_q, int T_k, int d,
                             float sm_scale, int dropout,
                             unsigned int threshold, float keep_scale,
                             unsigned int seed, int causal, int head_offset,
                             int heads_total, int dtype, void* stream) {
  if (bad_sizes(d, T_q, T_k)) return (int)cudaErrorInvalidValue;
  const Dropout drop{dropout, threshold, keep_scale, seed, head_offset,
                     heads_total};
  auto s = static_cast<cudaStream_t>(stream);
  auto l = static_cast<const float*>(lse);
  auto dl = static_cast<const float*>(delta);
  auto kl = static_cast<const int32_t*>(k_len);
  if (dtype == 0)
    return launch_dkdv<float>(q, k, v, bias, dout, l, dl, kl, dk, dv, B, H,
                              T_q, T_k, d, sm_scale, drop, causal, s);
  if (dtype == 1)
    return launch_dkdv<__nv_bfloat16>(q, k, v, bias, dout, l, dl, kl, dk, dv,
                                      B, H, T_q, T_k, d, sm_scale, drop,
                                      causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
