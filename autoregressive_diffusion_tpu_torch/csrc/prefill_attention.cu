// Frame-masked prefill attention over the ring KV cache, fp32, for sm_90a.
//
// Replaces, in fp32, the JAX package's splash-attention prefill kernels:
//   autoregressive_diffusion_tpu/ops/flash_attention.py::prefill_cache_attention
//   (:201, PrefillMask :96-138) and ::causal_frame_attention (:184). The
//   causal case is the ring case with offset = 0 and f_total = t_new.
//
// Computes, for each (batch*head, query row i):
//   o_i = sum_j softmax_j(q_i . k_j) v_j   over the key tokens j whose ring
//   slot s = j / hw is visible to the query frame f = i / hw:
//   0 <= p(s) <= offset + f, with p(s) = end-1 - ((end-1-s) mod f_total),
//   end = offset + t_new (the slot's absolute frame after the write).
// q arrives pre-scaled by 1/sqrt(d); everything is fp32.
//
// bf16, the model body's type on the serving path, runs the tensor-core
// flash forward instead (csrc/flash_attention_fwd.cu, entry point
// ad_flash_attention_ring_fwd, mask RingMask in csrc/flash_tile.cuh): fp32
// callers (the fp32 models and comparisons) are held to fp32 roundoff,
// which only these SIMT loops meet. The type alone picks the kernel.
//
// What bounds it on the H100: at the rollout's shapes (4 heads, d = 64,
// 64 tokens a frame, 8 query frames, a 64-slot ring of which at most
// 8-12 slots hold frames) the work is ~0.15 GFLOP and ~1 MB, a bound of
// well under a microsecond: the kernel is bound by its launch and by how
// few blocks it has, not by bytes or operations.
// What the design does about it: one block per (batch*head, 64-row query
// tile) -- one frame at 8x8 -- that loops over 64-token K/V tiles and skips,
// from frame indices alone, every tile the mask rules out (56 of the 64
// ring slots at the first prefill), so the cost follows the frames written,
// not the ring's capacity. K and V tiles are staged in shared memory;
// products are plain fp32 FMAs.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // key tokens per tile
constexpr int NT = 256;  // threads: 4 per query row

// Absolute frame held by ring slot s once frames [0, end) were written.
__device__ __forceinline__ int slot_pos(int s, int end, int f_total) {
  int r = (end - 1 - s) % f_total;
  if (r < 0) r += f_total;
  return end - 1 - r;
}

template <int D>
__global__ void __launch_bounds__(NT)
prefill_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk,
                    int hw, int t_new, int f_total, int offset) {
  constexpr int LD = D + 1;   // padded rows: conflict-free column reads
  constexpr int LP = BK + 1;
  constexpr int KPT = BK / 4;  // keys scored per thread
  constexpr int DPT = D / 4;   // output dims per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const float* qb = q + (size_t)bh * Sq * D;
  const float* kb = k + (size_t)bh * Sk * D;
  const float* vb = v + (size_t)bh * Sk * D;
  float* ob = o + (size_t)bh * Sq * D;
  const int tid = threadIdx.x;
  const int r = tid >> 2;   // query row of the tile
  const int sub = tid & 3;  // quarter of the row's keys / dims
  const int gq = q0 + r;

  for (int i = tid; i < BQ * D; i += NT) {
    const int rr = i / D, c = i % D;
    const int g = q0 + rr;
    sQ[rr * LD + c] = g < Sq ? qb[(size_t)g * D + c] : 0.f;
  }
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int qpos_hi = offset + q_last / hw;  // newest query frame of the tile
  const int my_qpos = offset + (gq < Sq ? gq : q_last) / hw;
  const int end = offset + t_new;

  float acc[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  const int n_tiles = (Sk + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    const int k_last = min(k0 + BK, Sk) - 1;
    // Skip the tile when no slot in it is visible to the tile's newest
    // query frame (visibility only grows with the query frame). The test
    // depends on blockIdx and t alone, so the whole block agrees.
    bool any = false;
    for (int s = k0 / hw; s <= k_last / hw && !any; ++s) {
      const int p = slot_pos(s, end, f_total);
      any = p >= 0 && p <= qpos_hi;
    }
    if (!any) continue;
    __syncthreads();  // the previous tile's sK / sV / sP reads are done
    for (int i = tid; i < BK * D; i += NT) {
      const int rr = i / D, c = i % D;
      const int g = k0 + rr;
      float kv = 0.f, vv = 0.f;
      if (g < Sk) {
        kv = kb[(size_t)g * D + c];
        vv = vb[(size_t)g * D + c];
      }
      sK[rr * LD + c] = kv;
      sV[rr * LD + c] = vv;
    }
    __syncthreads();

    float sc[KPT];
    bool vis[KPT];
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int g = k0 + sub + 4 * jj;
      bool ok = false;
      if (g < Sk && gq < Sq) {
        const int p = slot_pos(g / hw, end, f_total);
        ok = p >= 0 && p <= my_qpos;
      }
      vis[jj] = ok;
      sc[jj] = 0.f;
    }
    for (int c = 0; c < D; ++c) {
      const float qv = sQ[r * LD + c];
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) sc[jj] += qv * sK[(sub + 4 * jj) * LD + c];
    }
    float tmax = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      if (!vis[jj]) sc[jj] = -INFINITY;
      tmax = fmaxf(tmax, sc[jj]);
    }
    // the row's four threads are neighbouring lanes of one warp
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
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
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (gq < Sq) {
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < DPT; ++d)
      ob[(size_t)gq * D + sub + 4 * d] = acc[d] * inv;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int BH,
                   int Sq, int Sk, int hw, int t_new, int f_total, int offset,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(prefill_attn_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, BH);
  prefill_attn_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Sq, Sk, hw, t_new, f_total, offset);
  return cudaGetLastError();
}

cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, int BH,
                       int Sq, int Sk, int D, int hw, int t_new, int f_total,
                       int offset, cudaStream_t s) {
  switch (D) {
    case 16: return launch<16>(q, k, v, o, BH, Sq, Sk, hw, t_new, f_total, offset, s);
    case 32: return launch<32>(q, k, v, o, BH, Sq, Sk, hw, t_new, f_total, offset, s);
    case 64: return launch<64>(q, k, v, o, BH, Sq, Sk, hw, t_new, f_total, offset, s);
    case 128: return launch<128>(q, k, v, o, BH, Sq, Sk, hw, t_new, f_total, offset, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// fp32 only. Returns a cudaError_t code (0 = success).
int ad_prefill_attention(const void* q, const void* k, const void* v, void* o, int BH,
                         int Sq, int Sk, int D, int hw, int t_new, int f_total,
                         int offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || Sq <= 0 || Sk <= 0 || hw <= 0 || f_total <= 0) return (int)cudaErrorInvalidValue;
  return (int)dispatch_d(q, k, v, o, BH, Sq, Sk, D, hw, t_new, f_total, offset, s);
}

const char* ad_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
