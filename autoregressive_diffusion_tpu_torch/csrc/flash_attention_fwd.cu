// Flash-attention forward under a frame mask (DART, full or frame-causal)
// or the ring-cache prefill mask, for sm_90a.
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
// are bound by bytes (5 and 10 us) on the bf16 tensor cores (989 TFLOP/s
// dense, 3.35 TB/s).
// What the design does about it: the (S, S) logits never reach device
// memory; one block per (batch*head, 64-row query tile) walks the 64-token
// K/V tiles and skips, from frame indices alone, every tile the mask rules
// out, so a DART layer does 72/256 of the dense work (under sp = 2 rank
// 0's 512 rows see 20 of their 128 tile pairs, rank 1's 52); the predicate
// is evaluated per token only in tiles the frame test passes in part (hw
// need not be a multiple of 64, and a tile of the rank-major gathered keys
// can straddle a clean/noisy boundary), and the ragged tails of Sq and Sk
// are masked. The sequence-parallel entry point runs instantiations with
// the frame map (SHARD = true), the one-rank entry points instantiations
// without it, so the map costs the one-rank kernels no registers.
//
// bf16 (the model body's type, in training and serving), on the tensor
// cores: one warpgroup of 128 threads per query tile. TMA brings the Q
// tile once and streams the visible K/V tiles through a ring of NSTAGE
// stages in shared memory (swizzled boxes, mbarrier completion), so the
// next tile's copy overlaps this tile's products. S = Q K^T is a wgmma
// m64n64k16 from shared memory; the mask and the online softmax run on the
// fp32 accumulator fragments in registers (a row's max and sum within the
// quad of lanes that hold it); P becomes bf16 A fragments in registers and
// O += P V is a wgmma with V as an MN-major operand in shared memory. No
// trip through shared memory for S or P. What bounds it now is the serial
// chain of a block (product, softmax on the CUDA cores, product, barrier)
// and the softmax's per-element work at d = 64; overlapping one tile's
// softmax with the next tile's product (warp specialisation) is later work.
// fp32 keeps the SIMT loops of fp32 FMAs: its callers (the small fp32
// models, the fp32 comparisons) are held to 8 roundoff steps over S terms,
// which no bf16 or TF32 tensor-core product meets. The type alone picks
// the path.
//
// The ring-cache prefill (entry point ad_flash_attention_ring_fwd, bf16
// only) replaces ::prefill_cache_attention (:201, PrefillMask :96-138) and,
// with offset 0 and f_total = t_new, ::causal_frame_attention (:184): the
// same tensor-core kernel under RingMask (csrc/flash_tile.cuh), t_new * hw
// query rows against the ring's f_total * hw keys, no lse. At the rollout's
// shapes it is 0.15 GFLOP on about 1 MB, far under a microsecond of bytes,
// with only 8-32 query tiles: the bound is the serial walk over a tile's
// key tiles (up to 64 in a wrapped ring). So a query tile's visible key
// tiles are found in O(1) (ring_tiles, no scan) and split over a cluster
// of up to 8 blocks, whose leader merges the partial (m, l, o) from
// distributed shared memory in rank order; the ring streams 4 stages.
#include <cooperative_groups.h>

#include "flash_tile.cuh"

namespace cg = cooperative_groups;

namespace adflash {
namespace {

// fp32: SIMT, four lanes to a query row.
template <int D, bool SHARD>
__global__ void __launch_bounds__(NT)
flash_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
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

  load_tile<D>(sQ, q + qbase, q0, Sq);

  float acc[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  const int n_kt = (Sk + BK - 1) / BK;
  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * BK;
    if (!tile_visible<SHARD>(mk, q0, q_last, k0, min(k0 + BK, Sk) - 1)) continue;
    __syncthreads();  // the previous tile's sK / sV / sP reads are done
    load_tile<D>(sK, k + kbase, k0, Sk);
    load_tile<D>(sV, v + kbase, k0, Sk);
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
      o[qbase + (size_t)gq * D + sub + 4 * d] = acc[d] * inv;
    if (sub == 0) lse[(size_t)bh * Sq + gq] = l > 0.f ? m + logf(l) : -INFINITY;
  }
}


// bf16: tensor cores, one warpgroup to a 64-row query tile. M is Mask
// (DART, full, causal; SHARD: sequence parallel) or RingMask (the ring-cache
// prefill: Sq != Sk, no lse).
template <int D, bool SHARD, class M = Mask>
__global__ void __launch_bounds__(TC_NT)
flash_attn_fwd_tc(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                  float* __restrict__ lse, int Sq, int Sk_sharded, M mk) {
  using TT = TcTile<D>;
  constexpr bool RING = std::is_same<M, RingMask>::value;
  constexpr int NS = RING ? RING_NSTAGE : NSTAGE;
  const int Sk = (SHARD || RING) ? Sk_sharded : Sq;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar[NS + 1];  // the ring's stages, then Q
  uint8_t* sQ = align_1k(smem_raw);
  uint8_t* sKV = sQ + TT::BYTES;  // stage s: K at sKV + 2 s BYTES, V after it

  const int n_qt = (Sq + BQ - 1) / BQ;
  int tile_id = blockIdx.x, rank = 0;  // RING: clusters of mk.split blocks share a query tile
  if constexpr (RING) {
    tile_id = blockIdx.x / mk.split;
    rank = blockIdx.x - tile_id * mk.split;
  }
  const int bh = tile_id / n_qt;
  const int q0 = (tile_id % n_qt) * BQ;
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int n_kt = (Sk + BK - 1) / BK;
  const int tid = threadIdx.x;
  int lo1 = 0, hi1 = -1, lo2 = 0, hi2 = -1;  // RING: the block's key tiles
  if constexpr (RING) ring_tiles(mk, q_last, rank, lo1, hi1, lo2, hi2);
  auto next_visible = [&](int t) {
    if constexpr (RING) {
      return t <= hi1 ? max(t, lo1) : t <= hi2 ? max(t, lo2) : n_kt;
    } else {
      while (t < n_kt && !tile_visible<SHARD>(mk, q0, q_last, t * BK, min(t * BK + BK, Sk) - 1))
        ++t;
      return t;
    }
  };
  auto load_stage = [&](int stage, int t) {
    uint8_t* dst = sKV + 2 * stage * TT::BYTES;
    sm90::mbar_arrive_expect_tx(&bar[stage], 2 * TT::BYTES);
    tma_tile<D>(dst, &tk, &bar[stage], t * BK, bh);
    tma_tile<D>(dst + TT::BYTES, &tv, &bar[stage], t * BK, bh);
  };

  if (tid == 0) {
    for (int s = 0; s <= NS; ++s) sm90::mbar_init(&bar[s], 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();  // the barriers
  const int t_first = next_visible(0);
  int t_next = t_first;  // the next tile to copy (thread 0 copies)
  if (tid == 0) {
    sm90::mbar_arrive_expect_tx(&bar[NS], TT::BYTES);
    tma_tile<D>(sQ, &tq, &bar[NS], q0, bh);
    for (int s = 0; s < NS && t_next < n_kt; ++s) {
      load_stage(s, t_next);
      t_next = next_visible(t_next + 1);
    }
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m2[2] = {-INFINITY, -INFINITY};  // running row max, log2 units
  float l[2] = {0.f, 0.f};               // the thread's part of the row sum
  const uint32_t dQ = TT::klo(sm90::smem_u32(sQ));
  const uint32_t dK = TT::klo(sm90::smem_u32(sKV));
  const uint32_t dV = TT::mnlo(sm90::smem_u32(sKV + TT::BYTES));
  sm90::mbar_wait(&bar[NS], 0);

  int it = 0;
  for (int t = t_first; t < n_kt; t = next_visible(t + 1), ++it) {
    const int stage = it % NS;
    const uint32_t so = TT::tiles(2 * stage);
    sm90::mbar_wait(&bar[stage], (it / NS) & 1);

    float sc[32];
    sm90::wgmma_fence();
    gemm_abt<D>(sc, dQ, dK + so);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(sc);

    const int k0 = t * BK;
    if (!(k0 + BK <= Sk && tile_whole<SHARD>(mk, q0, q_last, k0, k0 + BK - 1))) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int gq = q0 + frag_row(i), gk = k0 + frag_col(i);
        if (!(gk < Sk && gq < Sq && token_visible<SHARD>(mk, gq, gk))) sc[i] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2], base[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m2[h], row_max(mx[h]) * LOG2E);
      base[h] = m_new == -INFINITY ? 0.f : m_new;  // a row that sees nothing yet: p = 0
      alpha[h] = ex2(m2[h] - base[h]);
      m2[h] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      sc[i] = ex2(fmaf(sc[i], LOG2E, -base[h]));
      psum[h] += sc[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + psum[h];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    uint32_t pa[16];
    to_a_frags(sc, pa);

    sm90::fence_regs(acc);
    sm90::wgmma_fence();
    gemm_pb<D>(acc, pa, dV + so);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(acc);

    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && t_next < n_kt) {
      load_stage(stage, t_next);
      t_next = next_visible(t_next + 1);
    }
  }

  if constexpr (RING) {
    if (mk.split > 1) {
      // The leader merges its partners' (m, l, o) in rank order; each
      // thread holds the same rows and columns in every block.
      cg::cluster_group cluster = cg::this_cluster();
      float* part = reinterpret_cast<float*>(sKV);  // [D / 2 + 4][TC_NT]
      __syncthreads();  // no warp reads the ring any more
      if (rank != 0) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) part[i * TC_NT + tid] = acc[i];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          part[(D / 2 + h) * TC_NT + tid] = m2[h];
          part[(D / 2 + 2 + h) * TC_NT + tid] = l[h];
        }
      }
      cluster.sync();
      if (rank == 0) {
        for (int r = 1; r < mk.split; ++r) {
          const float* rp = cluster.map_shared_rank(part, r);
          float a[2], b[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float mr = rp[(D / 2 + h) * TC_NT + tid];
            const float m_new = fmaxf(m2[h], mr);
            const float base = m_new == -INFINITY ? 0.f : m_new;
            a[h] = ex2(m2[h] - base);
            b[h] = ex2(mr - base);
            l[h] = l[h] * a[h] + rp[(D / 2 + 2 + h) * TC_NT + tid] * b[h];
            m2[h] = m_new;
          }
#pragma unroll
          for (int i = 0; i < D / 2; ++i)
            acc[i] = acc[i] * a[(i >> 1) & 1] + rp[i * TC_NT + tid] * b[(i >> 1) & 1];
        }
      }
      cluster.sync();  // the partners' shared memory stays until the leader has read it
      if (rank != 0) return;
    }
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = row_sum(l[h]);
    inv[h] = l[h] > 0.f ? 1.f / l[h] : 0.f;
  }
  const size_t qbase = (size_t)bh * Sq;
  store_rows<D>(o + qbase * D, acc, q0, Sq, inv);
  if constexpr (RING) return;
  if ((tid & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = q0 + frag_row(2 * h);
      if (g < Sq) lse[qbase + g] = l[h] > 0.f ? (m2[h] + log2f(l[h])) * LN2 : -INFINITY;
    }
  }
}

template <int D, bool SHARD>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                        int Sq, int Sk, Mask mk, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)((BQ + 2 * BK) * (D + 1) + BQ * (BK + 1));
  static bool configured = false;
  cudaError_t e = allow_smem(flash_attn_fwd_kernel<D, SHARD>, smem, configured);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)BH * ((Sq + BQ - 1) / BQ);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_attn_fwd_kernel<D, SHARD><<<(unsigned)blocks, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, Sq, Sk, mk);
  return cudaGetLastError();
}

template <int D, bool SHARD, class M = Mask>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                      int Sq, int Sk, M mk, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!tile_map<D>(&tq, q, Sq, BH) || !tile_map<D>(&tk, k, Sk, BH) ||
      !tile_map<D>(&tv, v, Sk, BH))
    return cudaErrorInvalidValue;
  constexpr bool RING = std::is_same<M, RingMask>::value;
  const size_t smem =
      1024 + (size_t)(1 + 2 * (RING ? RING_NSTAGE : NSTAGE)) * TcTile<D>::BYTES;
  static bool configured = false;
  cudaError_t e = allow_smem(flash_attn_fwd_tc<D, SHARD, M>, smem, configured);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)BH * ((Sq + BQ - 1) / BQ);
  if constexpr (RING) {  // a cluster of mk.split blocks to each query tile
    if (blocks * mk.split > 0x7fffffffLL) return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(blocks * mk.split), 1, 1);
    cfg.blockDim = dim3(TC_NT, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = mk.split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, flash_attn_fwd_tc<D, SHARD, M>, tq, tk, tv,
                           static_cast<__nv_bfloat16*>(o), lse, Sq, Sk, mk);
    if (e != cudaSuccess) return e;
  } else {
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    flash_attn_fwd_tc<D, SHARD, M><<<(unsigned)blocks, TC_NT, smem, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, Sq, Sk, mk);
  }
  return cudaGetLastError();
}

// fp32 to the SIMT kernel, bf16 to the tensor-core kernel, by type alone.
template <bool SHARD>
cudaError_t dispatch_t(const void* q, const void* k, const void* v, void* o, float* lse,
                       int BH, int Sq, int Sk, int D, Mask mk, int dtype, cudaStream_t s) {
#define AD_CASE(DD)                                                                   \
  case DD:                                                                            \
    return dtype == 0 ? launch_simt<DD, SHARD>(q, k, v, o, lse, BH, Sq, Sk, mk, s)  \
                      : launch_tc<DD, SHARD>(q, k, v, o, lse, BH, Sq, Sk, mk, s);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (D) {
    AD_CASE(16)
    AD_CASE(32)
    AD_CASE(64)
    AD_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef AD_CASE
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

cudaError_t dispatch_ring(const void* q, const void* k, const void* v, void* o, int BH, int Sq,
                          int Sk, int D, int hw, int t_new, int f_total, int offset,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || hw <= 0 || t_new <= 0 || f_total <= 0 || offset < 0 || Sq != t_new * hw ||
      Sk != f_total * hw)
    return cudaErrorInvalidValue;
  // Split a query tile's key tiles over a cluster when its blocks would
  // leave most SMs idle: up to 264 blocks (two an SM), at least 3 tiles a
  // block (the newest query frame sees min(end, f_total) slots).
  const int end = offset + t_new;
  const int v_tiles = ((end < f_total ? end : f_total) * hw + BK - 1) / BK + 1;
  const int q_tiles = BH * ((Sq + BQ - 1) / BQ);
  int split = 264 / q_tiles < v_tiles / 3 ? 264 / q_tiles : v_tiles / 3;
  split = split < 1 ? 1 : split > 8 ? 8 : split;
  const RingMask rm{hw, f_total, offset, end, make_fastdiv(hw), make_fastdiv(f_total), split};
  switch (D) {
    case 16: return launch_tc<16, false>(q, k, v, o, nullptr, BH, Sq, Sk, rm, s);
    case 32: return launch_tc<32, false>(q, k, v, o, nullptr, BH, Sq, Sk, rm, s);
    case 64: return launch_tc<64, false>(q, k, v, o, nullptr, BH, Sq, Sk, rm, s);
    case 128: return launch_tc<128, false>(q, k, v, o, nullptr, BH, Sq, Sk, rm, s);
    default: return cudaErrorInvalidValue;
  }
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

// Ring-cache prefill attention, bf16 (fp32 runs the SIMT kernel of
// csrc/prefill_attention.cu): q and o hold Sq = t_new * hw rows, k and v the
// Sk = f_total * hw rows of the ring; the mask is RingMask
// (csrc/flash_tile.cuh). No lse is written.
int ad_flash_attention_ring_fwd(const void* q, const void* k, const void* v, void* o, int BH,
                                int Sq, int Sk, int D, int hw, int t_new, int f_total,
                                int offset, void* stream) {
  return (int)adflash::dispatch_ring(q, k, v, o, BH, Sq, Sk, D, hw, t_new, f_total, offset,
                                     stream);
}

const char* ad_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
