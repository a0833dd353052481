// Flash-attention backward under a frame mask (DART, full or frame-causal),
// for sm_90a.
//
// Replaces the backward of the JAX package's splash-attention kernels
//   autoregressive_diffusion_tpu/ops/flash_attention.py::dart_attention
//   (:177, splash dq and dkv kernels over DartMask :32-67) and
//   ::full_attention (:224, FullMask), and, through the entry point
//   ad_flash_attention_sp_bwd, of the sequence-parallel ::dart_attention_sp
//   (:326) and ::causal_frame_attention_sp (:336): from the Sq local query
//   rows of one seq rank, dq for those rows and the rank's partial dk, dv
//   over all Sk gathered key rows (the caller reduce-scatters them over the
//   ranks, as autodiff of the JAX package's all_gather does).
//
// Given pre-scaled q, k, v, the forward's o and lse, and dO, with
// P = exp(q k^T - lse) under the mask (csrc/flash_tile.cuh: frame_visible):
//   delta_i = sum_c dO_ic o_ic
//   dS = P o (dP - delta),  dP = dO v^T
//   dq = dS k,  dk = dS^T q,  dv = P^T dO
// All sums are fp32; dq, dk, dv are written in the input type.
//
// What bounds it on the H100: at the gym shapes a DART layer is 6 GFLOP on
// 33.5 MB (10 us, bytes) on the bf16 tensor cores, a full frame layer 10.7
// GFLOP on 67 MB (20 us, bytes). With plain fp32 FMAs fed from shared memory
// the kernels are bound by the shared-memory loads behind each FMA, and the
// logits are recomputed twice (once for dk/dv, once for dq).
// What the design does about it: the FlashAttention-2 split, three launches
// on one stream and no atomics, so results repeat bit for bit:
//   flash_attn_delta_kernel: delta, one row per four lanes;
//   flash_attn_dkv_kernel:  one block per (batch*head, 64-key tile) keeps
//     its dk and dv in registers and walks only the query tiles that can see
//     it (frame indices alone), recomputing P and dS per tile; a key tile
//     no local query sees gets zeros;
//   flash_attn_dq_kernel:   one block per (batch*head, 64-row query tile)
//     walks the key tiles it sees, as the forward does.
// Nothing of size (S, S) reaches device memory. Tensor-core tiles are later
// work.
#include "flash_tile.cuh"

namespace adflash {
namespace {

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_attn_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                        float* __restrict__ delta, long long rows) {
  const long long row = (long long)blockIdx.x * (NT / 4) + (threadIdx.x >> 2);
  const int sub = threadIdx.x & 3;
  float s = 0.f;
  if (row < rows) {
    const size_t b = (size_t)row * D;
    for (int c = sub; c < D; c += 4) s += to_f(o[b + c]) * to_f(dout[b + c]);
  }
  s = row_sum(s);
  if (row < rows && sub == 0) delta[row] = s;
}

template <typename T, int D, bool SHARD>
__global__ void __launch_bounds__(NT)
flash_attn_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk_sharded, Mask mk) {
  const int Sk = SHARD ? Sk_sharded : Sq;
  constexpr int LD = D + 1;
  constexpr int LP = BQ + 1;
  constexpr int QPT = BQ / 4;  // queries scored per thread
  constexpr int DPT = D / 4;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sO = sQ + BQ * LD;  // dO
  float* sP = sO + BQ * LD;  // P, key-major
  float* sS = sP + BK * LP;  // dS, key-major
  float* sL = sS + BK * LP;  // lse of the query tile
  float* sD = sL + BQ;       // delta of the query tile

  const int n_kt = (Sk + BK - 1) / BK;
  const int bh = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x % n_kt) * BK;
  const size_t qbase = (size_t)bh * Sq * D;
  const size_t kbase = (size_t)bh * Sk * D;
  const int tid = threadIdx.x;
  const int r = tid >> 2;  // key row of the tile
  const int sub = tid & 3;
  const int gk = k0 + r;
  const int k_last = min(k0 + BK, Sk) - 1;

  load_tile<T, D>(sK, k + kbase, k0, Sk);
  load_tile<T, D>(sV, v + kbase, k0, Sk);

  float adk[DPT], adv[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) adk[d] = adv[d] = 0.f;

  const int n_qt = (Sq + BQ - 1) / BQ;
  for (int t = 0; t < n_qt; ++t) {
    const int q0 = t * BQ;
    if (!tile_visible<SHARD>(mk, q0, min(q0 + BQ, Sq) - 1, k0, k_last)) continue;
    __syncthreads();  // the previous tile's reads are done
    load_tile<T, D>(sQ, q + qbase, q0, Sq);
    load_tile<T, D>(sO, dout + qbase, q0, Sq);
    if (tid < BQ) {
      const int g = q0 + tid;
      sL[tid] = g < Sq ? lse[(size_t)bh * Sq + g] : 0.f;
      sD[tid] = g < Sq ? delta[(size_t)bh * Sq + g] : 0.f;
    }
    __syncthreads();

    float s[QPT], dp[QPT];
#pragma unroll
    for (int ii = 0; ii < QPT; ++ii) s[ii] = dp[ii] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float kv = sK[r * LD + c];
      const float vv = sV[r * LD + c];
#pragma unroll
      for (int ii = 0; ii < QPT; ++ii) {
        s[ii] += kv * sQ[(sub + 4 * ii) * LD + c];
        dp[ii] += vv * sO[(sub + 4 * ii) * LD + c];
      }
    }
#pragma unroll
    for (int ii = 0; ii < QPT; ++ii) {
      const int i = sub + 4 * ii;
      const int g = q0 + i;
      const bool ok = g < Sq && gk < Sk && token_visible<SHARD>(mk, g, gk);
      const float p = ok ? expf(s[ii] - sL[i]) : 0.f;
      sP[r * LP + i] = p;
      sS[r * LP + i] = p * (dp[ii] - sD[i]);
    }
    __syncwarp();  // the key row's P and dS come from the same four lanes
    for (int i = 0; i < BQ; ++i) {
      const float p = sP[r * LP + i];
      const float ds = sS[r * LP + i];
#pragma unroll
      for (int d = 0; d < DPT; ++d) {
        adv[d] += p * sO[i * LD + sub + 4 * d];
        adk[d] += ds * sQ[i * LD + sub + 4 * d];
      }
    }
  }
  if (gk < Sk) {
#pragma unroll
    for (int d = 0; d < DPT; ++d) {
      const size_t at = kbase + (size_t)gk * D + sub + 4 * d;
      dk[at] = from_f<T>(adk[d]);
      dv[at] = from_f<T>(adv[d]);
    }
  }
}

template <typename T, int D, bool SHARD>
__global__ void __launch_bounds__(NT)
flash_attn_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dq, int Sq, int Sk_sharded, Mask mk) {
  const int Sk = SHARD ? Sk_sharded : Sq;
  constexpr int LD = D + 1;
  constexpr int LP = BK + 1;
  constexpr int KPT = BK / 4;
  constexpr int DPT = D / 4;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + BQ * LD;  // dO
  float* sK = sO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sS = sV + BK * LD;  // dS, query-major

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * BQ;
  const size_t qbase = (size_t)bh * Sq * D;
  const size_t kbase = (size_t)bh * Sk * D;
  const int tid = threadIdx.x;
  const int r = tid >> 2;  // query row of the tile
  const int sub = tid & 3;
  const int gq = q0 + r;
  const int q_last = min(q0 + BQ, Sq) - 1;

  load_tile<T, D>(sQ, q + qbase, q0, Sq);
  load_tile<T, D>(sO, dout + qbase, q0, Sq);
  const float my_lse = gq < Sq ? lse[(size_t)bh * Sq + gq] : 0.f;
  const float my_delta = gq < Sq ? delta[(size_t)bh * Sq + gq] : 0.f;

  float acc[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) acc[d] = 0.f;

  const int n_kt = (Sk + BK - 1) / BK;
  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * BK;
    if (!tile_visible<SHARD>(mk, q0, q_last, k0, min(k0 + BK, Sk) - 1)) continue;
    __syncthreads();
    load_tile<T, D>(sK, k + kbase, k0, Sk);
    load_tile<T, D>(sV, v + kbase, k0, Sk);
    __syncthreads();

    float s[KPT], dp[KPT];
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) s[jj] = dp[jj] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float qv = sQ[r * LD + c];
      const float ov = sO[r * LD + c];
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) {
        s[jj] += qv * sK[(sub + 4 * jj) * LD + c];
        dp[jj] += ov * sV[(sub + 4 * jj) * LD + c];
      }
    }
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int j = sub + 4 * jj;
      const int g = k0 + j;
      const bool ok = g < Sk && gq < Sq && token_visible<SHARD>(mk, gq, g);
      sS[r * LP + j] = ok ? expf(s[jj] - my_lse) * (dp[jj] - my_delta) : 0.f;
    }
    __syncwarp();  // the row's dS comes from the same four lanes
    for (int j = 0; j < BK; ++j) {
      const float ds = sS[r * LP + j];
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[d] += ds * sK[j * LD + sub + 4 * d];
    }
  }
  if (gq < Sq) {
#pragma unroll
    for (int d = 0; d < DPT; ++d)
      dq[qbase + (size_t)gq * D + sub + 4 * d] = from_f<T>(acc[d]);
  }
}

template <typename T, int D, bool SHARD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const float* lse, const void* dout, float* delta, void* dq, void* dk,
                   void* dv, int BH, int Sq, int Sk, Mask mk, cudaStream_t stream) {
  const T* Q = static_cast<const T*>(q);
  const T* K = static_cast<const T*>(k);
  const T* V = static_cast<const T*>(v);
  const T* dO = static_cast<const T*>(dout);
  const size_t tile = (size_t)64 * (D + 1);
  const size_t smem_dkv = sizeof(float) * (4 * tile + 2 * (size_t)BK * (BQ + 1) + 2 * BQ);
  const size_t smem_dq = sizeof(float) * (4 * tile + (size_t)BQ * (BK + 1));
  static bool dkv_ok = false, dq_ok = false;
  cudaError_t e = allow_smem(flash_attn_dkv_kernel<T, D, SHARD>, smem_dkv, dkv_ok);
  if (e != cudaSuccess) return e;
  e = allow_smem(flash_attn_dq_kernel<T, D, SHARD>, smem_dq, dq_ok);
  if (e != cudaSuccess) return e;

  const long long rows = (long long)BH * Sq;
  const long long q_tiles = (long long)BH * ((Sq + BQ - 1) / BQ);
  const long long k_tiles = (long long)BH * ((Sk + BK - 1) / BK);
  if (q_tiles > 0x7fffffffLL || k_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_attn_delta_kernel<T, D><<<(unsigned)((rows + NT / 4 - 1) / (NT / 4)), NT, 0, stream>>>(
      static_cast<const T*>(o), dO, delta, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_attn_dkv_kernel<T, D, SHARD><<<(unsigned)k_tiles, NT, smem_dkv, stream>>>(
      Q, K, V, dO, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, mk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_attn_dq_kernel<T, D, SHARD><<<(unsigned)q_tiles, NT, smem_dq, stream>>>(
      Q, K, V, dO, lse, delta, static_cast<T*>(dq), Sq, Sk, mk);
  return cudaGetLastError();
}

template <typename T, bool SHARD>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* o,
                       const float* lse, const void* dout, float* delta, void* dq, void* dk,
                       void* dv, int BH, int Sq, int Sk, int D, Mask mk, cudaStream_t s) {
#define AD_LAUNCH(DD) \
  launch<T, DD, SHARD>(q, k, v, o, lse, dout, delta, dq, dk, dv, BH, Sq, Sk, mk, s)
  switch (D) {
    case 16: return AD_LAUNCH(16);
    case 32: return AD_LAUNCH(32);
    case 64: return AD_LAUNCH(64);
    case 128: return AD_LAUNCH(128);
    default: return cudaErrorInvalidValue;
  }
#undef AD_LAUNCH
}

template <bool SHARD>
cudaError_t dispatch_t(const void* q, const void* k, const void* v, const void* o,
                       const float* lse, const void* dout, float* delta, void* dq, void* dk,
                       void* dv, int BH, int Sq, int Sk, int D, Mask mk, int dtype,
                       cudaStream_t s) {
  if (dtype == 0)
    return dispatch_d<float, SHARD>(q, k, v, o, lse, dout, delta, dq, dk, dv, BH, Sq, Sk, D, mk,
                                    s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16, SHARD>(q, k, v, o, lse, dout, delta, dq, dk, dv, BH, Sq,
                                            Sk, D, mk, s);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o,
                     const void* lse, const void* dout, void* delta, void* dq, void* dk,
                     void* dv, int BH, int Sq, int Sk, int D, int kind, int n_frames, int hw,
                     int sp_rank, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Mask mk;
  if (BH <= 0 || !make_mask(kind, Sq, Sk, n_frames, hw, sp_rank, &mk)) return cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (sp_rank < 0)
    return dispatch_t<false>(q, k, v, o, l, dout, dl, dq, dk, dv, BH, Sq, Sk, D, mk, dtype, s);
  return dispatch_t<true>(q, k, v, o, l, dout, dl, dq, dk, dv, BH, Sq, Sk, D, mk, dtype, s);
}

}  // namespace
}  // namespace adflash

extern "C" {

// delta: (BH, S) fp32 scratch. kind: 0 = DART (S = 2 * n_frames * hw),
// 1 = full, 2 = frame-causal (S = n_frames * hw). dtype: 0 = float32,
// 1 = bfloat16. Returns a cudaError_t code.
int ad_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                           const void* lse, const void* dout, void* delta, void* dq,
                           void* dk, void* dv, int BH, int S, int D, int kind, int n_frames,
                           int hw, int dtype, void* stream) {
  return (int)adflash::dispatch(q, k, v, o, lse, dout, delta, dq, dk, dv, BH, S, S, D, kind,
                                n_frames, hw, -1, dtype, stream);
}

// Sequence parallel (layouts as ad_flash_attention_sp_fwd): q, o, lse, dO,
// delta and dq hold the Sq rows of seq rank sp_rank; k, v, dk and dv the
// Sk = sp * Sq gathered rows, dk and dv being this rank's partial sums.
int ad_flash_attention_sp_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* lse, const void* dout, void* delta, void* dq,
                              void* dk, void* dv, int BH, int Sq, int Sk, int D, int kind,
                              int n_frames, int hw, int sp_rank, int dtype, void* stream) {
  if (sp_rank < 0) return (int)cudaErrorInvalidValue;
  return (int)adflash::dispatch(q, k, v, o, lse, dout, delta, dq, dk, dv, BH, Sq, Sk, D, kind,
                                n_frames, hw, sp_rank, dtype, stream);
}

const char* ad_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
