// Flash-attention forward under a frame mask (DART or full), for sm_90a.
//
// Replaces the forward of the JAX package's splash-attention kernels
//   autoregressive_diffusion_tpu/ops/flash_attention.py::dart_attention
//   (:177, DartMask :32-67) and ::full_attention (:224, FullMask).
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
// out, so a DART layer does 72/256 of the dense work; inside a tile that is
// only partly visible (hw not a multiple of 64) the predicate is evaluated
// per token, and the ragged tail of S is masked. Tensor-core tiles
// (mma.sync / wgmma) are later work.
#include "flash_tile.cuh"

namespace adflash {
namespace {

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                      int S, Mask mk) {
  constexpr int LD = D + 1;
  constexpr int LP = BK + 1;
  constexpr int KPT = BK / 4;  // keys scored per thread
  constexpr int DPT = D / 4;   // output dims per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;

  const int n_qt = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * BQ;
  const size_t base = (size_t)bh * S * D;
  const int tid = threadIdx.x;
  const int r = tid >> 2;   // query row of the tile
  const int sub = tid & 3;  // quarter of the row's keys / dims
  const int gq = q0 + r;
  const int q_last = min(q0 + BQ, S) - 1;

  load_tile<T, D>(sQ, q + base, q0, S);

  float acc[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  const int n_kt = (S + BK - 1) / BK;
  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * BK;
    if (!tile_visible(mk, q0, q_last, k0, min(k0 + BK, S) - 1)) continue;
    __syncthreads();  // the previous tile's sK / sV / sP reads are done
    load_tile<T, D>(sK, k + base, k0, S);
    load_tile<T, D>(sV, v + base, k0, S);
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
      if (!(g < S && gq < S && token_visible(mk, gq, g))) sc[jj] = -INFINITY;
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
  if (gq < S) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int d = 0; d < DPT; ++d)
      o[base + (size_t)gq * D + sub + 4 * d] = from_f<T>(acc[d] * inv);
    if (sub == 0) lse[(size_t)bh * S + gq] = l > 0.f ? m + logf(l) : -INFINITY;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                   int S, Mask mk, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)((BQ + 2 * BK) * (D + 1) + BQ * (BK + 1));
  static bool configured = false;
  cudaError_t e = allow_smem(flash_attn_fwd_kernel<T, D>, smem, configured);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)BH * ((S + BQ - 1) / BQ);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_attn_fwd_kernel<T, D><<<(unsigned)blocks, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, S, mk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, float* lse,
                       int BH, int S, int D, Mask mk, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, lse, BH, S, mk, s);
    case 32: return launch<T, 32>(q, k, v, o, lse, BH, S, mk, s);
    case 64: return launch<T, 64>(q, k, v, o, lse, BH, S, mk, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, BH, S, mk, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace adflash

extern "C" {

// kind: 0 = DART (S = 2 * n_frames * hw), 1 = full. dtype: 0 = float32,
// 1 = bfloat16. Returns a cudaError_t code (0 = success).
int ad_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                           int BH, int S, int D, int kind, int n_frames, int hw, int dtype,
                           void* stream) {
  using namespace adflash;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || S <= 0 || hw <= 0 || (kind != 0 && kind != 1)) return (int)cudaErrorInvalidValue;
  if (kind == 0 && S != 2 * n_frames * hw) return (int)cudaErrorInvalidValue;
  const Mask mk{kind, n_frames, hw};
  float* l = static_cast<float*>(lse);
  if (dtype == 0) return (int)dispatch_d<float>(q, k, v, o, l, BH, S, D, mk, s);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, l, BH, S, D, mk, s);
  return (int)cudaErrorInvalidValue;
}

const char* ad_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
