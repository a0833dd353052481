// Flash-attention forward under a frame mask (DART, full or frame-causal),
// for sm_90a.
//
// Replaces the forward of the JAX package's splash-attention kernels
//   autoregressive_diffusion_tpu/ops/flash_attention.py::dart_attention
//   (:177, DartMask :32-67) and ::full_attention (:224, FullMask), and,
//   through the entry point ad_flash_attention_sp_fwd, of the
//   sequence-parallel ::dart_attention_sp (:326) and
//   ::causal_frame_attention_sp (:336): the Sq rows of one seq rank against
//   the Sk = sp * Sq all-gathered keys, each frame index mapped to its
//   global frame (csrc/flash_tile.cuh: shard_frame) before the mask rule.
//
// Computes, for each (batch*head, query row i) over the key tokens j that
// the mask lets row i see (csrc/flash_tile.cuh: frame_visible):
//   o_i = sum_j softmax_j(q_i . k_j) v_j,   lse_i = log sum_j exp(q_i . k_j)
// q arrives pre-scaled by 1/sqrt(d) in the input type (fp32 or bf16); the
// logits, the online softmax and the sums are fp32; o is written in the
// input type and lse in fp32, for the backward.
//
// What bounds it on the H100: at the gym shapes a DART layer (8 x 4 heads,
// S = 1024, d = 64, 72 of 256 frame pairs visible) is 2.4 GFLOP on 16.8 MB,
// a full frame layer (128 x 2 heads, S = 256) 4.3 GFLOP on 33.5 MB: both
// are bound by bytes (5 and 10 us) on the bf16 tensor cores. With plain
// fp32 FMAs fed from shared memory the kernel is bound instead by the
// shared-memory loads behind each FMA.
// What the design does about it: the (S, S) logits never reach device
// memory; one block per (batch*head, 64-row query tile) walks the 64-token
// K/V tiles and skips, from frame indices alone, every tile the mask rules
// out, so a DART layer does 72/256 of the dense work (under sp = 2 rank
// 0's 512 rows see 20 of their 128 tile pairs, rank 1's 52); inside a
// visible tile the predicate is evaluated per token (hw need not be a
// multiple of 64, and a tile of the rank-major gathered keys can straddle a
// clean/noisy boundary), and the ragged tails of Sq and Sk are masked. The
// sequence-parallel entry point runs instantiations with the frame map
// (SHARD = true), the one-rank entry points instantiations without it, so
// the map costs the one-rank kernels no registers. Tensor-core tiles
// (mma.sync / wgmma) are later work.
#include "flash_tile.cuh"

namespace adflash {
namespace {

template <typename T, int D, bool SHARD>
__global__ void __launch_bounds__(NT)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                      int Sq, int Sk_sharded, Mask mk) {
  const int Sk = SHARD ? Sk_sharded : Sq;
  constexpr int LD = D + 1;
  constexpr int LP = BK + 1;
  constexpr int KPT = BK / 4;  // keys scored per thread
  constexpr int DPT = D / 4;   // output dims per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * BQ;
  const size_t qbase = (size_t)bh * Sq * D;
  const size_t kbase = (size_t)bh * Sk * D;
  const int tid = threadIdx.x;
  const int r = tid >> 2;   // query row of the tile
  const int sub = tid & 3;  // quarter of the row's keys / dims
  const int gq = q0 + r;
  const int q_last = min(q0 + BQ, Sq) - 1;

  load_tile<T, D>(sQ, q + qbase, q0, Sq);

  float acc[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  const int n_kt = (Sk + BK - 1) / BK;
  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * BK;
    if (!tile_visible<SHARD>(mk, q0, q_last, k0, min(k0 + BK, Sk) - 1)) continue;
    __syncthreads();  // the previous tile's sK / sV / sP reads are done
    load_tile<T, D>(sK, k + kbase, k0, Sk);
    load_tile<T, D>(sV, v + kbase, k0, Sk);
    __syncthreads();

    float sc[KPT];
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) sc[jj] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float qv = sQ[r * LD + c];
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) sc[jj] += qv * sK[(sub + 4 * jj) * LD + c];
    }
    float tmax = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int g = k0 + sub + 4 * jj;
      if (!(g < Sk && gq < Sq && token_visible<SHARD>(mk, gq, g))) sc[jj] = -INFINITY;
      tmax = fmaxf(tmax, sc[jj]);
    }
    const float m_new = fmaxf(m, row_max(tmax));
    const bool none = (m_new == -INFINITY);  // nothing visible to the row yet
    const float alpha = none ? 1.f : expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const float p = none ? 0.f : expf(sc[jj] - m_new);
      sP[r * LP + sub + 4 * jj] = p;
      psum += p;
    }
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[d] *= alpha;
    __syncwarp();  // the row's P values come from the same four lanes
    for (int j = 0; j < BK; ++j) {
      const float p = sP[r * LP + j];
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[d] += p * sV[j * LD + sub + 4 * d];
    }
  }
  l = row_sum(l);
  if (gq < Sq) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int d = 0; d < DPT; ++d)
      o[qbase + (size_t)gq * D + sub + 4 * d] = from_f<T>(acc[d] * inv);
    if (sub == 0) lse[(size_t)bh * Sq + gq] = l > 0.f ? m + logf(l) : -INFINITY;
  }
}

template <typename T, int D, bool SHARD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                   int Sq, int Sk, Mask mk, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)((BQ + 2 * BK) * (D + 1) + BQ * (BK + 1));
  static bool configured = false;
  cudaError_t e = allow_smem(flash_attn_fwd_kernel<T, D, SHARD>, smem, configured);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)BH * ((Sq + BQ - 1) / BQ);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_attn_fwd_kernel<T, D, SHARD><<<(unsigned)blocks, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Sq, Sk, mk);
  return cudaGetLastError();
}

template <typename T, bool SHARD>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, float* lse,
                       int BH, int Sq, int Sk, int D, Mask mk, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16, SHARD>(q, k, v, o, lse, BH, Sq, Sk, mk, s);
    case 32: return launch<T, 32, SHARD>(q, k, v, o, lse, BH, Sq, Sk, mk, s);
    case 64: return launch<T, 64, SHARD>(q, k, v, o, lse, BH, Sq, Sk, mk, s);
    case 128: return launch<T, 128, SHARD>(q, k, v, o, lse, BH, Sq, Sk, mk, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool SHARD>
cudaError_t dispatch_t(const void* q, const void* k, const void* v, void* o, float* lse,
                       int BH, int Sq, int Sk, int D, Mask mk, int dtype, cudaStream_t s) {
  if (dtype == 0) return dispatch_d<float, SHARD>(q, k, v, o, lse, BH, Sq, Sk, D, mk, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16, SHARD>(q, k, v, o, lse, BH, Sq, Sk, D, mk, s);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
                     int BH, int Sq, int Sk, int D, int kind, int n_frames, int hw,
                     int sp_rank, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Mask mk;
  if (BH <= 0 || !make_mask(kind, Sq, Sk, n_frames, hw, sp_rank, &mk)) return cudaErrorInvalidValue;
  float* l = static_cast<float*>(lse);
  if (sp_rank < 0) return dispatch_t<false>(q, k, v, o, l, BH, Sq, Sk, D, mk, dtype, s);
  return dispatch_t<true>(q, k, v, o, l, BH, Sq, Sk, D, mk, dtype, s);
}

}  // namespace
}  // namespace adflash

extern "C" {

// kind: 0 = DART (S = 2 * n_frames * hw), 1 = full, 2 = frame-causal
// (S = n_frames * hw). dtype: 0 = float32, 1 = bfloat16. Returns a
// cudaError_t code (0 = success).
int ad_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                           int BH, int S, int D, int kind, int n_frames, int hw, int dtype,
                           void* stream) {
  return (int)adflash::dispatch(q, k, v, o, lse, BH, S, S, D, kind, n_frames, hw, -1, dtype,
                                stream);
}

// Sequence parallel: q, o, lse hold the Sq rows of seq rank sp_rank, k and v
// the Sk = sp * Sq rows gathered from all sp ranks, rank-major. kind 0 =
// DART (each rank's rows are its local concat of Sq / (2 hw) clean frames
// and the same frames noisy, n_frames = T of the whole clip), 2 =
// frame-causal (a contiguous run of Sq / hw frames).
int ad_flash_attention_sp_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int BH, int Sq, int Sk, int D, int kind, int n_frames, int hw,
                              int sp_rank, int dtype, void* stream) {
  if (sp_rank < 0) return (int)cudaErrorInvalidValue;
  return (int)adflash::dispatch(q, k, v, o, lse, BH, Sq, Sk, D, kind, n_frames, hw, sp_rank,
                                dtype, stream);
}

const char* ad_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
