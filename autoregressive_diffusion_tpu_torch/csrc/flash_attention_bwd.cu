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
// GFLOP on 67 MB (20 us, bytes).
// What the design does about it: the FlashAttention-2 split, three launches
// on one stream and no atomics, so results repeat bit for bit:
//   flash_attn_delta_kernel: delta, one row per four lanes (bytes);
//   dK/dV kernel: one block per (batch*head, 64-key tile) keeps its dk and
//     dv in registers and walks only the query tiles that can see it (frame
//     indices alone), recomputing P and dS per tile; a key tile no local
//     query sees gets zeros;
//   dQ kernel: one block per (batch*head, 64-row query tile) walks the key
//     tiles it sees, as the forward does.
// Nothing of size (S, S) reaches device memory.
//
// bf16 (the model body's type) runs on the tensor cores, one warpgroup of
// 128 threads a block. The dK/dV kernel loads its K and V tiles once by
// TMA and streams the visible Q/dO tiles through a ring of NSTAGE stages
// (mbarrier completion), the query tile's lse and delta staged beside
// them in shared memory; S^T = K Q^T and dP^T = V dO^T are wgmma products
// from shared memory, P^T and dS^T are formed on the fp32 accumulator
// fragments in registers and become bf16 A fragments of dV += P^T dO and
// dK += dS^T Q (dO and Q as MN-major operands of the same tiles). The dQ
// kernel loads Q and dO once, streams K/V through the same ring, and runs
// S = Q K^T, dP = dO V^T, dS in registers, dQ += dS K. The per-token mask
// runs only in tiles the frame test passes in part, as a pass of its own
// before the exponentials.
// fp32 keeps the SIMT loops of fp32 FMAs, for the fp32 comparisons' bound
// of 8 roundoff steps over S terms, which no bf16 or TF32 tensor-core
// product meets; the type alone picks the path.
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

// fp32: SIMT, four lanes to a key row.
template <int D, bool SHARD>
__global__ void __launch_bounds__(NT)
flash_attn_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk_sharded,
                      Mask mk) {
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

  load_tile<D>(sK, k + kbase, k0, Sk);
  load_tile<D>(sV, v + kbase, k0, Sk);

  float adk[DPT], adv[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) adk[d] = adv[d] = 0.f;

  const int n_qt = (Sq + BQ - 1) / BQ;
  for (int t = 0; t < n_qt; ++t) {
    const int q0 = t * BQ;
    if (!tile_visible<SHARD>(mk, q0, min(q0 + BQ, Sq) - 1, k0, k_last)) continue;
    __syncthreads();  // the previous tile's reads are done
    load_tile<D>(sQ, q + qbase, q0, Sq);
    load_tile<D>(sO, dout + qbase, q0, Sq);
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
      dk[at] = adk[d];
      dv[at] = adv[d];
    }
  }
}

// fp32: SIMT, four lanes to a query row.
template <int D, bool SHARD>
__global__ void __launch_bounds__(NT)
flash_attn_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq, int Sq, int Sk_sharded, Mask mk) {
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

  load_tile<D>(sQ, q + qbase, q0, Sq);
  load_tile<D>(sO, dout + qbase, q0, Sq);
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
    load_tile<D>(sK, k + kbase, k0, Sk);
    load_tile<D>(sV, v + kbase, k0, Sk);
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
      dq[qbase + (size_t)gq * D + sub + 4 * d] = acc[d];
  }
}


// bf16: tensor cores, one warpgroup to a 64-key tile.
template <int D, bool SHARD>
__global__ void __launch_bounds__(TC_NT)
flash_attn_dkv_tc(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq,
                  int Sk_sharded, Mask mk) {
  using TT = TcTile<D>;
  const int Sk = SHARD ? Sk_sharded : Sq;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar[NSTAGE + 1];  // the ring's stages, then K/V
  __shared__ float sL[NSTAGE][BQ];  // lse of the query tile, log2 units
  __shared__ float sD[NSTAGE][BQ];  // delta of the query tile
  uint8_t* sK = align_1k(smem_raw);
  uint8_t* sV = sK + TT::BYTES;
  uint8_t* sQO = sV + TT::BYTES;  // stage s: Q at sQO + 2 s BYTES, dO after it

  const int n_kt = (Sk + BK - 1) / BK;
  const int bh = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x % n_kt) * BK;
  const int k_last = min(k0 + BK, Sk) - 1;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int tid = threadIdx.x;
  const size_t rbase = (size_t)bh * Sq;
  auto next_visible = [&](int t) {
    while (t < n_qt && !tile_visible<SHARD>(mk, t * BQ, min(t * BQ + BQ, Sq) - 1, k0, k_last))
      ++t;
    return t;
  };
  // Threads 0-63 stage query tile t's lse and delta and arrive; thread 0's
  // arrival also announces the TMA bytes of its Q and dO.
  auto load_stage = [&](int stage, int t) {
    if (tid >= BQ) return;
    const int g = t * BQ + tid;
    const float lg = g < Sq ? lse[rbase + g] : 0.f;
    sL[stage][tid] = lg == -INFINITY ? 0.f : lg * LOG2E;  // (a row that sees nothing)
    sD[stage][tid] = g < Sq ? delta[rbase + g] : 0.f;
    if (tid == 0) {
      uint8_t* dst = sQO + 2 * stage * TT::BYTES;
      sm90::mbar_arrive_expect_tx(&bar[stage], 2 * TT::BYTES);
      tma_tile<D>(dst, &tq, &bar[stage], t * BQ, bh);
      tma_tile<D>(dst + TT::BYTES, &tdo, &bar[stage], t * BQ, bh);
    } else {
      sm90::mbar_arrive(&bar[stage]);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < NSTAGE; ++s) sm90::mbar_init(&bar[s], BQ);
    sm90::mbar_init(&bar[NSTAGE], 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();  // the barriers
  if (tid == 0) {
    sm90::mbar_arrive_expect_tx(&bar[NSTAGE], 2 * TT::BYTES);
    tma_tile<D>(sK, &tk, &bar[NSTAGE], k0, bh);
    tma_tile<D>(sV, &tv, &bar[NSTAGE], k0, bh);
  }
  const int t_first = next_visible(0);
  int t_next = t_first;  // block-uniform: every thread keeps it
  for (int s = 0; s < NSTAGE && t_next < n_qt; ++s) {
    load_stage(s, t_next);
    t_next = next_visible(t_next + 1);
  }

  float adk[D / 2], adv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adk[i] = adv[i] = 0.f;
  const uint32_t dK = TT::klo(sm90::smem_u32(sK)), dV = TT::klo(sm90::smem_u32(sV));
  const uint32_t aQO = sm90::smem_u32(sQO);
  const uint32_t dQk = TT::klo(aQO), dOk = TT::klo(aQO + TT::BYTES);
  const uint32_t dQm = TT::mnlo(aQO), dOm = TT::mnlo(aQO + TT::BYTES);
  sm90::mbar_wait(&bar[NSTAGE], 0);

  int it = 0;
  for (int t = t_first; t < n_qt; t = next_visible(t + 1), ++it) {
    const int stage = it % NSTAGE;
    const uint32_t so = TT::tiles(2 * stage);
    sm90::mbar_wait(&bar[stage], (it / NSTAGE) & 1);

    float st[32], dpt[32];  // S^T and dP^T: key rows, query columns
    sm90::wgmma_fence();
    gemm_abt<D>(st, dK, dQk + so);
    gemm_abt<D>(dpt, dV, dOk + so);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);

    const int q0 = t * BQ;
    if (!(q0 + BQ <= Sq && k0 + BK <= Sk &&
          tile_whole<SHARD>(mk, q0, q0 + BQ - 1, k0, k0 + BK - 1))) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int gq = q0 + frag_col(i), gk = k0 + frag_row(i);
        if (!(gq < Sq && gk < Sk && token_visible<SHARD>(mk, gq, gk))) st[i] = -INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = frag_col(i);
      st[i] = ex2(fmaf(st[i], LOG2E, -sL[stage][c]));
      dpt[i] = st[i] * (dpt[i] - sD[stage][c]);
    }
    uint32_t pa[16], dsa[16];
    to_a_frags(st, pa);
    to_a_frags(dpt, dsa);

    sm90::fence_regs(adv);
    sm90::fence_regs(adk);
    sm90::wgmma_fence();
    gemm_pb<D>(adv, pa, dOm + so);
    gemm_pb<D>(adk, dsa, dQm + so);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(adv);
    sm90::fence_regs(adk);

    __syncthreads();  // every warp is done with this stage
    if (t_next < n_qt) {
      load_stage(stage, t_next);
      t_next = next_visible(t_next + 1);
    }
  }
  const float one[2] = {1.f, 1.f};
  const size_t kbase = (size_t)bh * Sk * D;
  store_rows<D>(dk + kbase, adk, k0, Sk, one);
  store_rows<D>(dv + kbase, adv, k0, Sk, one);
}

// bf16: tensor cores, one warpgroup to a 64-row query tile.
template <int D, bool SHARD>
__global__ void __launch_bounds__(TC_NT)
flash_attn_dq_tc(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int Sq, int Sk_sharded, Mask mk) {
  using TT = TcTile<D>;
  const int Sk = SHARD ? Sk_sharded : Sq;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar[NSTAGE + 1];  // the ring's stages, then Q/dO
  uint8_t* sQ = align_1k(smem_raw);
  uint8_t* sO = sQ + TT::BYTES;   // dO
  uint8_t* sKV = sO + TT::BYTES;  // stage s: K at sKV + 2 s BYTES, V after it

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * BQ;
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int n_kt = (Sk + BK - 1) / BK;
  const int tid = threadIdx.x;
  auto next_visible = [&](int t) {
    while (t < n_kt && !tile_visible<SHARD>(mk, q0, q_last, t * BK, min(t * BK + BK, Sk) - 1))
      ++t;
    return t;
  };
  auto load_stage = [&](int stage, int t) {
    uint8_t* dst = sKV + 2 * stage * TT::BYTES;
    sm90::mbar_arrive_expect_tx(&bar[stage], 2 * TT::BYTES);
    tma_tile<D>(dst, &tk, &bar[stage], t * BK, bh);
    tma_tile<D>(dst + TT::BYTES, &tv, &bar[stage], t * BK, bh);
  };

  if (tid == 0) {
    for (int s = 0; s <= NSTAGE; ++s) sm90::mbar_init(&bar[s], 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();  // the barriers
  const int t_first = next_visible(0);
  int t_next = t_first;  // the next tile to copy (thread 0 copies)
  if (tid == 0) {
    sm90::mbar_arrive_expect_tx(&bar[NSTAGE], 2 * TT::BYTES);
    tma_tile<D>(sQ, &tq, &bar[NSTAGE], q0, bh);
    tma_tile<D>(sO, &tdo, &bar[NSTAGE], q0, bh);
    for (int s = 0; s < NSTAGE && t_next < n_kt; ++s) {
      load_stage(s, t_next);
      t_next = next_visible(t_next + 1);
    }
  }

  const size_t rbase = (size_t)bh * Sq;
  float my_lse[2], my_delta[2];  // the thread's two rows; lse in log2 units
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g = q0 + frag_row(2 * h);
    const float lg = g < Sq ? lse[rbase + g] : 0.f;
    my_lse[h] = lg == -INFINITY ? 0.f : lg * LOG2E;  // (a row that sees nothing)
    my_delta[h] = g < Sq ? delta[rbase + g] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint32_t dQ = TT::klo(sm90::smem_u32(sQ)), dO = TT::klo(sm90::smem_u32(sO));
  const uint32_t aKV = sm90::smem_u32(sKV);
  const uint32_t dKk = TT::klo(aKV), dVk = TT::klo(aKV + TT::BYTES);
  const uint32_t dKm = TT::mnlo(aKV);
  sm90::mbar_wait(&bar[NSTAGE], 0);

  int it = 0;
  for (int t = t_first; t < n_kt; t = next_visible(t + 1), ++it) {
    const int stage = it % NSTAGE;
    const uint32_t so = TT::tiles(2 * stage);
    sm90::mbar_wait(&bar[stage], (it / NSTAGE) & 1);

    float sc[32], dp[32];
    sm90::wgmma_fence();
    gemm_abt<D>(sc, dQ, dKk + so);
    gemm_abt<D>(dp, dO, dVk + so);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);

    const int k0 = t * BK;
    if (!(q0 + BQ <= Sq && k0 + BK <= Sk &&
          tile_whole<SHARD>(mk, q0, q0 + BQ - 1, k0, k0 + BK - 1))) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int gq = q0 + frag_row(i), gk = k0 + frag_col(i);
        if (!(gq < Sq && gk < Sk && token_visible<SHARD>(mk, gq, gk))) sc[i] = -INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      dp[i] = ex2(fmaf(sc[i], LOG2E, -my_lse[h])) * (dp[i] - my_delta[h]);
    }
    uint32_t dsa[16];
    to_a_frags(dp, dsa);

    sm90::fence_regs(acc);
    sm90::wgmma_fence();
    gemm_pb<D>(acc, dsa, dKm + so);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(acc);

    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && t_next < n_kt) {
      load_stage(stage, t_next);
      t_next = next_visible(t_next + 1);
    }
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq + rbase * D, acc, q0, Sq, one);
}

template <int D, bool SHARD>
cudaError_t launch_simt(const void* q, const void* k, const void* v, const void* o,
                        const float* lse, const void* dout, float* delta, void* dq, void* dk,
                        void* dv, int BH, int Sq, int Sk, Mask mk, cudaStream_t stream) {
  const float* Q = static_cast<const float*>(q);
  const float* K = static_cast<const float*>(k);
  const float* V = static_cast<const float*>(v);
  const float* dO = static_cast<const float*>(dout);
  const size_t tile = (size_t)64 * (D + 1);
  const size_t smem_dkv = sizeof(float) * (4 * tile + 2 * (size_t)BK * (BQ + 1) + 2 * BQ);
  const size_t smem_dq = sizeof(float) * (4 * tile + (size_t)BQ * (BK + 1));
  static bool dkv_ok = false, dq_ok = false;
  cudaError_t e = allow_smem(flash_attn_dkv_kernel<D, SHARD>, smem_dkv, dkv_ok);
  if (e != cudaSuccess) return e;
  e = allow_smem(flash_attn_dq_kernel<D, SHARD>, smem_dq, dq_ok);
  if (e != cudaSuccess) return e;

  const long long rows = (long long)BH * Sq;
  const long long q_tiles = (long long)BH * ((Sq + BQ - 1) / BQ);
  const long long k_tiles = (long long)BH * ((Sk + BK - 1) / BK);
  if (q_tiles > 0x7fffffffLL || k_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned delta_blocks = (unsigned)((rows + NT / 4 - 1) / (NT / 4));
  flash_attn_delta_kernel<float, D><<<delta_blocks, NT, 0, stream>>>(
      static_cast<const float*>(o), dO, delta, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_attn_dkv_kernel<D, SHARD><<<(unsigned)k_tiles, NT, smem_dkv, stream>>>(
      Q, K, V, dO, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), Sq, Sk, mk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_attn_dq_kernel<D, SHARD><<<(unsigned)q_tiles, NT, smem_dq, stream>>>(
      Q, K, V, dO, lse, delta, static_cast<float*>(dq), Sq, Sk, mk);
  return cudaGetLastError();
}

template <int D, bool SHARD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* o,
                      const float* lse, const void* dout, float* delta, void* dq, void* dk,
                      void* dv, int BH, int Sq, int Sk, Mask mk, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!tile_map<D>(&tq, q, Sq, BH) || !tile_map<D>(&tk, k, Sk, BH) ||
      !tile_map<D>(&tv, v, Sk, BH) || !tile_map<D>(&tdo, dout, Sq, BH))
    return cudaErrorInvalidValue;
  const size_t smem = 1024 + (size_t)(2 + 2 * NSTAGE) * TcTile<D>::BYTES;
  static bool dkv_ok = false, dq_ok = false;
  cudaError_t e = allow_smem(flash_attn_dkv_tc<D, SHARD>, smem, dkv_ok);
  if (e != cudaSuccess) return e;
  e = allow_smem(flash_attn_dq_tc<D, SHARD>, smem, dq_ok);
  if (e != cudaSuccess) return e;

  using BF = __nv_bfloat16;
  const long long rows = (long long)BH * Sq;
  const long long q_tiles = (long long)BH * ((Sq + BQ - 1) / BQ);
  const long long k_tiles = (long long)BH * ((Sk + BK - 1) / BK);
  if (q_tiles > 0x7fffffffLL || k_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_attn_delta_kernel<BF, D><<<(unsigned)((rows + NT / 4 - 1) / (NT / 4)), NT, 0, stream>>>(
      static_cast<const BF*>(o), static_cast<const BF*>(dout), delta, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_attn_dkv_tc<D, SHARD><<<(unsigned)k_tiles, TC_NT, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<BF*>(dk), static_cast<BF*>(dv), Sq, Sk, mk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_attn_dq_tc<D, SHARD><<<(unsigned)q_tiles, TC_NT, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<BF*>(dq), Sq, Sk, mk);
  return cudaGetLastError();
}

// fp32 to the SIMT kernels, bf16 to the tensor-core kernels, by type alone.
template <bool SHARD>
cudaError_t dispatch_t(const void* q, const void* k, const void* v, const void* o,
                       const float* lse, const void* dout, float* delta, void* dq, void* dk,
                       void* dv, int BH, int Sq, int Sk, int D, Mask mk, int dtype,
                       cudaStream_t s) {
#define AD_CASE(DD)                                                                      \
  case DD:                                                                               \
    return dtype == 0 ? launch_simt<DD, SHARD>(q, k, v, o, lse, dout, delta, dq, dk, dv, \
                                                 BH, Sq, Sk, mk, s)                      \
                      : launch_tc<DD, SHARD>(q, k, v, o, lse, dout, delta, dq, dk, dv, BH, \
                                             Sq, Sk, mk, s);
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
