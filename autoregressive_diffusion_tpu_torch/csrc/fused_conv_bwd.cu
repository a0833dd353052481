// Train-mode fused gated causal conv, backward, for sm_90a.
//
// Replaces the JAX package's Pallas backward kernel
//   autoregressive_diffusion_tpu/ops/fused_conv.py::_fused_bwd
//   (:879, pallas_call :957, body _bwd_kernel :516)
// on torch's channels-last layouts (see fused_conv_fwd.cu for the forward
// function). From gout (B, F, H, W, Co) it returns
//   dx (B, F, H, W, C), dw2 (3, 3, C, Co), dw3 (2, 3, 3, C, Co),
//   dcvec (B, F, C), dgates (B, F).
// With g the gate of a frame and r = rsqrt((1-g)^2 + g^2):
//   dy2d[f] = gout[f] * (1 - g[f]) * r[f]
//   dctx[t] = gout[t] * g[t] * r[t] + gout[T+t] * g[T+t] * r[T+t]
//   da[f]   = convT(dy2d[f], w2)
//             + (clean f = t only) convT(dctx[t+1], w3[1]) + convT(dctx[t+2], w3[0])
//   dz = da * mp_silu'(x * cvec),  dx = dz * cvec,  dcvec = sum_pixels dz * x
//   dw2[tap]    = sum a[f](p + tap) * dy2d[f](p)
//   dw3[k][tap] = sum h[t+k](p + tap) * dctx[t](p),  h = [ones, ones, a_clean...]
//                 (the ones frames carry no dx but do reach dw3)
//   dgates[f]   = sum gout * (diff * r - out * (2g - 1) * r^2)
// a is recomputed from x as in the forward pass (fp32 transform, rounded to
// the working type): it is not saved, so the forward keeps no residual of
// its size. diff = ctx - y2d and out are the forward pass's residual and
// result.
//
// What bounds it on the H100: twice the forward's operations (one
// transposed convolution and one weight-gradient product per forward
// convolution) over about the same bytes, so operations.
// Why not the TPU kernel's shape: that one walks the frames of a batch row
// backwards in order on one core, carrying pending context gradients and the
// weight-gradient sums in VMEM across grid steps. Blocks here run in no
// order and share nothing, so the work is split by output, and the weight
// gradients are summed in shares of the pixel tiles with a fixed-order
// finalize. No atomics: every result is the same from run to run.
//
// bf16 (the training path's type), on the tensor cores (conv_tc.cuh):
//   1. conv_bwd_prologue:      a into the padded buffer abuf, as the forward;
//   2. conv_bwd_grad_prologue: dy2d and dctx into padded bf16 buffers. This
//      rounds them to bf16, where the fp32 path forms them in fp32 inside
//      its tile loop: a rounding the plain version does not have, held to
//      the bf16 tolerance by chip_smoke.py. It reads gout once for all of
//      its uses, so it also sums dgates over its pixel chunk;
//   3. conv_bwd_pack_w:        w2, w3[0], w3[1] flipped and transposed;
//   4. conv_bwd_dx_tc:         da as the forward's implicit GEMM over
//      (dy2d | dctx[t+1], dctx[t+2]) and the packed weights, then dx and
//      the per-tile partial sums of dcvec (fixed order, no atomics);
//   5. conv_bwd_dw_tc:         the weight gradients as a GEMM with M = 32
//      input channels (x 9 taps), N = 32 or 64 outputs, K = pixels: A is
//      the halo of abuf read transposed by ldmatrix.trans (a tap is again
//      only an address), B the tile of dy2d or dctx; each block sums a
//      strided share of the (frame, pixel tile) units and writes its
//      partial sum;
//   then dcv_finalize (dcvec, and dgates from the chunk partials) and
//   dw_finalize below, shared with fp32.
// fp32 keeps the SIMT kernels: its callers are held to fp32 roundoff. The
// type alone picks the path:
//   1. transpose_w:  flipped, transposed copies of w2, w3 for the convT;
//   2. dx_kernel:    da by the forward's tile loop on (dy2d | dctx, wT),
//                    then dx, and per-tile partial sums of dcvec;
//   3. dcv_finalize: sums the per-tile partials (fixed order);
//   4. dw_kernel:    each block owns a 16 x 32 (c, co) tile of one weight for
//                    all 9 taps and a strided share of the pixel tiles, and
//                    writes its partial sum;
//   5. dw_finalize:  sums the partials in a fixed order and casts;
//   6. dgates_kernel: one block a frame.
// dy2d and dctx are never stored on that path: every consumer forms them in
// fp32 from gout and the gates while it stages its tile.
#include "conv_tc.cuh"

namespace {
using namespace adconv;

// The gated output gradient read by the transposed convs and the weight
// gradients: g0 * s0 (+ g1 * s1), in fp32.
template <typename T>
struct GradLoad {
  const T* g0;
  float s0;
  const T* g1;  // nullptr: one term
  float s1;
  int W, Co;
  __device__ __forceinline__ float operator()(int y, int x, int co) const {
    const size_t i = ((size_t)y * W + x) * Co + co;
    float v = to_f(g0[i]) * s0;
    if (g1 != nullptr) v += to_f(g1[i]) * s1;
    return v;
  }
};

__device__ __forceinline__ float gate_r(float g) {
  return rsqrtf((1.f - g) * (1.f - g) + g * g);
}

// dy2d of global frame f (= b * F + index in the row)
template <typename T>
__device__ __forceinline__ GradLoad<T> dy2d_load(const T* gout, const float* gates, int f,
                                                 size_t oframe, int W, int Co, int with_ctx) {
  float s = 1.f;
  if (with_ctx) {
    const float g = gates[f];
    s = (1.f - g) * gate_r(g);
  }
  return GradLoad<T>{gout + f * oframe, s, nullptr, 0.f, W, Co};
}

// dctx of time t in batch row b
template <typename T>
__device__ __forceinline__ GradLoad<T> dctx_load(const T* gout, const float* gates, int b, int t,
                                                 int F, size_t oframe, int W, int Co) {
  const int fc = b * F + t, fn = fc + F / 2;
  const float gc = gates[fc], gn = gates[fn];
  return GradLoad<T>{gout + fc * oframe, gc * gate_r(gc), gout + fn * oframe, gn * gate_r(gn),
                     W, Co};
}

// ---------------------------------------------------------------------------
// 1. wT[k][tap][co][c] = w_k[8 - tap][c][co]; k = 0: w2, k = 1, 2: w3[0], w3[1]
template <typename T>
__global__ void transpose_w_kernel(const T* __restrict__ w2, const T* __restrict__ w3,
                                   T* __restrict__ wT, int C, int Co, int nk) {
  const size_t per = (size_t)9 * C * Co;
  const size_t n = per * nk;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int k = (int)(i / per);
    const size_t rem = i % per;
    const int tap = (int)(rem / ((size_t)C * Co));
    const int co = (int)((rem / C) % Co), c = (int)(rem % C);
    const T* src = (k == 0) ? w2 : w3 + (size_t)(k - 1) * per;
    wT[i] = src[((size_t)(8 - tap) * C + c) * Co + co];
  }
}

// ---------------------------------------------------------------------------
// 2. da -> dx and the per-tile partial sums of dcvec
template <typename T>
__device__ __forceinline__ void dx_epilogue(const float acc[4][4], const T* __restrict__ x,
                                            const T* __restrict__ cvec, T* __restrict__ dx,
                                            float* __restrict__ dcv_part, TileSmem& sm, int f,
                                            int H, int W, int C, int ty0, int tx0, int c0,
                                            int silu_in, int ntiles) {
  const int cg = threadIdx.x & 7, pg = threadIdx.x >> 3;
  const size_t frame = (size_t)H * W * C;
  float cs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int y = ty0 + pg / TS + 2 * i, xq = tx0 + pg % TS;
    if (y >= H || xq >= W) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + cg * 4 + j;
      if (c >= C) continue;
      const size_t idx = f * frame + ((size_t)y * W + xq) * C + c;
      const float xv = to_f(x[idx]);
      const float cv = cvec ? to_f(cvec[(size_t)f * C + c]) : 1.f;
      float dz = acc[i][j];
      if (silu_in) dz *= mp_dsilu(xv * cv);
      if (dx != nullptr) dx[idx] = from_f<T>(dz * cv);
      cs[j] += dz * xv;
    }
  }
  if (dcv_part != nullptr) {
    float* red = &sm.in[0][0];  // 16 x 32 floats of the idle input tile
    __syncthreads();            // the last chunk's reads are done
#pragma unroll
    for (int j = 0; j < 4; ++j) red[pg * CO_T + cg * 4 + j] = cs[j];
    __syncthreads();
    if (threadIdx.x < CO_T && c0 + threadIdx.x < C) {
      float s = 0.f;
      for (int p = 0; p < 16; ++p) s += red[p * CO_T + threadIdx.x];
      dcv_part[((size_t)f * ntiles + blockIdx.x) * C + c0 + threadIdx.x] = s;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(CNT)
dx_kernel(const T* __restrict__ x, const T* __restrict__ cvec, const float* __restrict__ gates,
          const T* __restrict__ gout, const T* __restrict__ wT, T* __restrict__ dx,
          float* __restrict__ dcv_part, int F, int H, int W, int C, int Co, int silu_in,
          int with_ctx) {
  __shared__ TileSmem sm;
  const int tiles_x = (W + TS - 1) / TS;
  const int ntiles = gridDim.x;
  const int ty0 = (blockIdx.x / tiles_x) * TS, tx0 = (blockIdx.x % tiles_x) * TS;
  const int c0 = blockIdx.y * CO_T;
  const size_t oframe = (size_t)H * W * Co, wsz = (size_t)9 * C * Co;
  float acc[4][4];

  if (!with_ctx) {
    const int f = blockIdx.z;
    zero_tile(acc);
    conv_tile<T>(dy2d_load<T>(gout, gates, f, oframe, W, Co, 0), wT, sm, acc, H, W, Co, C, ty0,
                 tx0, c0);
    dx_epilogue<T>(acc, x, cvec, dx, dcv_part, sm, f, H, W, C, ty0, tx0, c0, silu_in, ntiles);
    return;
  }
  const int T_half = F / 2;
  const int b = blockIdx.z / T_half, t = blockIdx.z % T_half;
  const int fc = b * F + t, fn = fc + T_half;
  // the noisy frame feeds its own 2D conv only
  zero_tile(acc);
  conv_tile<T>(dy2d_load<T>(gout, gates, fn, oframe, W, Co, 1), wT, sm, acc, H, W, Co, C, ty0,
               tx0, c0);
  dx_epilogue<T>(acc, x, cvec, dx, dcv_part, sm, fn, H, W, C, ty0, tx0, c0, silu_in, ntiles);
  // the clean frame t also feeds ctx[t+1] through w3[1] and ctx[t+2] through w3[0]
  zero_tile(acc);
  conv_tile<T>(dy2d_load<T>(gout, gates, fc, oframe, W, Co, 1), wT, sm, acc, H, W, Co, C, ty0,
               tx0, c0);
  if (t + 1 < T_half)
    conv_tile<T>(dctx_load<T>(gout, gates, b, t + 1, F, oframe, W, Co), wT + 2 * wsz, sm, acc, H,
                 W, Co, C, ty0, tx0, c0);
  if (t + 2 < T_half)
    conv_tile<T>(dctx_load<T>(gout, gates, b, t + 2, F, oframe, W, Co), wT + wsz, sm, acc, H, W,
                 Co, C, ty0, tx0, c0);
  dx_epilogue<T>(acc, x, cvec, dx, dcv_part, sm, fc, H, W, C, ty0, tx0, c0, silu_in, ntiles);
}

// 3. dcvec[f][c] = sum over tiles of the partials
template <typename T>
__global__ void dcv_finalize_kernel(const float* __restrict__ part, T* __restrict__ dcvec,
                                    int n_fc_frames, int ntiles, int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_fc_frames * C) return;
  const int f = i / C, c = i % C;
  float s = 0.f;
#pragma unroll 8
  for (int tl = 0; tl < ntiles; ++tl) s += part[((size_t)f * ntiles + tl) * C + c];
  dcvec[i] = from_f<T>(s);
}

// ---------------------------------------------------------------------------
// 4. weight gradients: block (c/co tile, share s of S, kind); kind 0 = w2,
// 1 = w3[0] (frame t-2), 2 = w3[1] (frame t-1).
template <typename T>
__global__ void __launch_bounds__(CNT)
dw_kernel(const T* __restrict__ x, const T* __restrict__ cvec, const float* __restrict__ gates,
          const T* __restrict__ gout, float* __restrict__ part, int B, int F, int H, int W,
          int C, int Co, int silu_in, int with_ctx) {
  __shared__ float s_a[HALO * HALO][KC + 1];
  __shared__ __align__(16) float s_dy[TS * TS][CO_T];
  const int tid = threadIdx.x;
  const int ci = tid & 15, cg = tid >> 4;
  const int cotiles = (Co + CO_T - 1) / CO_T;
  const int c0 = (blockIdx.x / cotiles) * KC, co0 = (blockIdx.x % cotiles) * CO_T;
  const int S = gridDim.y, kind = blockIdx.z;
  const int tiles_x = (W + TS - 1) / TS;
  const int ntiles = tiles_x * ((H + TS - 1) / TS);
  const int T_half = F / 2;
  const size_t frame = (size_t)H * W * C, oframe = (size_t)H * W * Co;
  const int units = (kind == 0 ? B * F : B * T_half) * ntiles;

  float acc[9][4];
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;

  for (int u = blockIdx.y; u < units; u += S) {
    const int tile = u % ntiles, fr = u / ntiles;
    const int ty0 = (tile / tiles_x) * TS, tx0 = (tile % tiles_x) * TS;
    ActLoad<T> la{nullptr, nullptr, W, C, silu_in};
    GradLoad<T> ld;
    if (kind == 0) {
      la.frame = x + fr * frame;
      la.cv = cvec ? cvec + (size_t)fr * C : nullptr;
      ld = dy2d_load<T>(gout, gates, fr, oframe, W, Co, with_ctx);
    } else {
      const int b = fr / T_half, t = fr % T_half;
      const int tp = t - 2 + (kind - 1);
      if (tp >= 0) {
        la.frame = x + (size_t)(b * F + tp) * frame;
        la.cv = cvec ? cvec + (size_t)(b * F + tp) * C : nullptr;
      }
      ld = dctx_load<T>(gout, gates, b, t, F, oframe, W, Co);
    }
    __syncthreads();  // the previous unit's reads are done
    for (int i = tid; i < HALO * HALO * KC; i += CNT) {
      const int hp = i / KC, k = i % KC;
      const int y = ty0 - 1 + hp / HALO, xq = tx0 - 1 + hp % HALO, c = c0 + k;
      float val = 0.f;
      if (y >= 0 && y < H && xq >= 0 && xq < W && c < C) val = la(y, xq, c);
      s_a[hp][k] = val;
    }
    for (int i = tid; i < TS * TS * CO_T; i += CNT) {
      const int p = i / CO_T, k = i % CO_T;
      const int y = ty0 + p / TS, xq = tx0 + p % TS, co = co0 + k;
      float val = 0.f;
      if (y < H && xq < W && co < Co) val = ld(y, xq, co);
      s_dy[p][k] = val;
    }
    __syncthreads();
#pragma unroll 2
    for (int p = 0; p < TS * TS; ++p) {
      const int py = p / TS, px = p % TS;
      const float4 d = *reinterpret_cast<const float4*>(&s_dy[p][cg * 4]);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float a = s_a[(py + tap / 3) * HALO + px + tap % 3][ci];
        acc[tap][0] += a * d.x;
        acc[tap][1] += a * d.y;
        acc[tap][2] += a * d.z;
        acc[tap][3] += a * d.w;
      }
    }
  }
  const int c = c0 + ci;
  if (c < C) {
    float* dst = part + ((size_t)kind * S + blockIdx.y) * 9 * C * Co;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = co0 + cg * 4 + j;
        if (co < Co) dst[((size_t)tap * C + c) * Co + co] = acc[tap][j];
      }
  }
}

// 5. dw = sum over the S shares, cast to the weights' type
template <typename T>
__global__ void dw_finalize_kernel(const float* __restrict__ part, T* __restrict__ dw2,
                                   T* __restrict__ dw3, int S, int C, int Co, int kinds) {
  const size_t per = (size_t)9 * C * Co;
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (i >= per * kinds) return;
  const int kind = (int)(i / per);
  const size_t e = i % per;
  float s = 0.f;
#pragma unroll 8  // the loads in flight together, the sum in order
  for (int k = 0; k < S; ++k) s += part[((size_t)kind * S + k) * per + e];
  if (kind == 0)
    dw2[e] = from_f<T>(s);
  else
    dw3[(size_t)(kind - 1) * per + e] = from_f<T>(s);
}

// ---------------------------------------------------------------------------
// 6. dgates[f] = sum gout * (diff * r - out * (2g - 1) * r^2)
template <typename T>
__global__ void __launch_bounds__(256)
dgates_kernel(const T* __restrict__ gout, const T* __restrict__ diff, const T* __restrict__ out,
              const float* __restrict__ gates, float* __restrict__ dgates, size_t n) {
  __shared__ float red[8];
  const int f = blockIdx.x;
  const float g = gates[f], r = gate_r(g);
  const float ka = r, kb = (2.f * g - 1.f) * r * r;
  const T* go = gout + f * n;
  const T* df = diff + f * n;
  const T* ou = out + f * n;
  float s = 0.f;
  for (size_t i = threadIdx.x; i < n; i += 256)
    s += to_f(go[i]) * (to_f(df[i]) * ka - to_f(ou[i]) * kb);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
    for (int k = 0; k < 8; ++k) tot += red[k];
    dgates[f] = tot;
  }
}


constexpr int GP_THREADS = 256;          // the bf16 grad prologue's block
constexpr int GP_ITEMS = 4 * GP_THREADS;  // and its 8-channel groups of pixels

inline size_t align256(size_t b) { return (b + 255) / 256 * 256; }

inline unsigned grid_for(long long n, int threads) {
  const long long g = (n + threads - 1) / threads;
  return (unsigned)(g < 8192 ? (g > 0 ? g : 1) : 8192);
}

// Scratch of a backward call, 256-byte aligned pieces in this order.
// fp32: wT (nk, 9, Co, C), dcv_part (B * F, ntiles, C) fp32, dw_part
// (nk, S, 9, C, Co) fp32. bf16: abuf (B, F + nones, H, W, Cp), dy2d
// (B, F, H, W, Cop), dctx (B, T, H, W, Cop), wp (nk, 9, Cop, Np_x), dg_part
// (B * F, gp_chunks) fp32, then dcv_part and dw_part as for fp32.
struct Layout {
  int nk, ntiles, S;
  int Cp, Cop, nones, nco_x, Np_x, nco_w, n_ct, n_nt, gp_chunks;  // bf16 only
  size_t abuf, dy2d, dctx, wp, dg, dcv, dwp, bytes;                // byte offsets
};

// min(want, most, 256), at least 1
inline int clamp_shares(int most, int want) {
  int s = want < most ? want : most;
  s = s < 256 ? s : 256;
  return s > 1 ? s : 1;
}

inline Layout layout(int B, int F, int H, int W, int C, int Co, int with_ctx, int dtype) {
  using adconv::tc::nco_for;
  using adconv::tc::round_up;
  Layout l = {};
  l.nk = with_ctx ? 3 : 1;
  l.ntiles = ((H + TS - 1) / TS) * ((W + TS - 1) / TS);
  const int units = B * (with_ctx ? F / 2 : F) * l.ntiles;  // of each weight's sum (dw3's)
  const size_t hw = (size_t)H * W;
  size_t off = 0;
  if (dtype == 0) {
    // 16 x 32 (c, co) blocks of 128 threads: enough to fill the card several times over
    const int blocks = ((C + KC - 1) / KC) * ((Co + CO_T - 1) / CO_T) * l.nk;
    l.S = clamp_shares(units, (1056 + blocks - 1) / blocks);
    l.wp = off;
    off += align256((size_t)l.nk * 9 * C * Co * sizeof(float));
  } else {
    l.Cp = round_up(C, 16);
    l.Cop = round_up(Co, 16);
    l.nones = with_ctx ? 2 : 0;
    l.nco_x = nco_for(C);
    l.Np_x = round_up(C, l.nco_x);
    l.nco_w = nco_for(Co);
    l.n_ct = (l.Cp + 31) / 32;
    l.n_nt = (Co + l.nco_w - 1) / l.nco_w;
    // 32 x NCO (c, co) blocks: about two waves of two blocks an SM, and at
    // least 16 (frame, tile) units a share, so that the partial sums (S
    // times the weights' size, written and read once) stay a small part of
    // the traffic
    const int blocks = l.n_ct * l.n_nt * l.nk;
    l.S = clamp_shares(units / 16, (528 + blocks - 1) / blocks);
    l.abuf = off;
    off += align256((size_t)B * (F + l.nones) * hw * l.Cp * 2);
    l.dy2d = off;
    off += align256((size_t)B * F * hw * l.Cop * 2);
    l.dctx = off;
    off += align256(with_ctx ? (size_t)B * (F / 2) * hw * l.Cop * 2 : 0);
    l.wp = off;
    off += align256((size_t)l.nk * 9 * l.Cop * l.Np_x * 2);
    l.gp_chunks = (H * W * (l.Cop / 8) + GP_ITEMS - 1) / GP_ITEMS;
    l.dg = off;
    off += align256((size_t)B * F * l.gp_chunks * sizeof(float));
  }
  l.dcv = off;
  off += align256((size_t)B * F * l.ntiles * C * sizeof(float));
  l.dwp = off;
  off += align256((size_t)l.nk * l.S * 9 * C * Co * sizeof(float));
  l.bytes = off;
  return l;
}

// dcvec from its per-tile partials and dw2, dw3 from their shares, each
// summed in a fixed order and cast to the weights' type.
template <typename T>
cudaError_t finalize(const Layout& l, void* dw2, void* dw3, void* dcvec, float* dcv_part,
                     float* dw_part, int B, int F, int C, int Co, cudaStream_t s) {
  cudaError_t e;
  if (dcvec != nullptr) {
    const int n = B * F * C;
    dcv_finalize_kernel<T><<<(n + 255) / 256, 256, 0, s>>>(dcv_part, static_cast<T*>(dcvec),
                                                           B * F, l.ntiles, C);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  const size_t nwo = (size_t)9 * C * Co * l.nk;
  dw_finalize_kernel<T><<<(unsigned)((nwo + 255) / 256), 256, 0, s>>>(
      dw_part, static_cast<T*>(dw2), static_cast<T*>(dw3), l.S, C, Co, l.nk);
  return cudaGetLastError();
}

cudaError_t run_simt(const void* x, const void* w2, const void* w3, const void* cvec,
                     const float* gates, const void* gout, const void* diff, const void* out,
                     void* dx, void* dw2, void* dw3, void* dcvec, float* dgates, void* scratch,
                     int B, int F, int H, int W, int C, int Co, int silu_in, int with_ctx,
                     cudaStream_t s) {
  using T = float;
  const Layout l = layout(B, F, H, W, C, Co, with_ctx, 0);
  uint8_t* sc = static_cast<uint8_t*>(scratch);
  T* wT = reinterpret_cast<T*>(sc + l.wp);
  float* dcv_part = reinterpret_cast<float*>(sc + l.dcv);
  float* dw_part = reinterpret_cast<float*>(sc + l.dwp);
  const T* xs = static_cast<const T*>(x);
  const T* cvs = static_cast<const T*>(cvec);
  const T* gos = static_cast<const T*>(gout);
  cudaError_t e;

  if (dx != nullptr || cvec != nullptr) {
    const size_t nw = (size_t)9 * C * Co * l.nk;
    transpose_w_kernel<T><<<(unsigned)((nw + 255) / 256 < 1024 ? (nw + 255) / 256 : 1024), 256, 0,
                            s>>>(static_cast<const T*>(w2), static_cast<const T*>(w3), wT, C, Co,
                                 l.nk);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    dim3 grid(l.ntiles, (C + CO_T - 1) / CO_T, with_ctx ? B * (F / 2) : B * F);
    dx_kernel<T><<<grid, CNT, 0, s>>>(xs, cvs, gates, gos, wT, static_cast<T*>(dx),
                                      cvec ? dcv_part : nullptr, F, H, W, C, Co, silu_in,
                                      with_ctx);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  dim3 wgrid(((C + KC - 1) / KC) * ((Co + CO_T - 1) / CO_T), l.S, l.nk);
  dw_kernel<T><<<wgrid, CNT, 0, s>>>(xs, cvs, gates, gos, dw_part, B, F, H, W, C, Co, silu_in,
                                     with_ctx);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = finalize<T>(l, dw2, dw3, dcvec, dcv_part, dw_part, B, F, C, Co, s)) != cudaSuccess)
    return e;
  if (with_ctx) {
    dgates_kernel<T><<<B * F, 256, 0, s>>>(gos, static_cast<const T*>(diff),
                                           static_cast<const T*>(out), gates, dgates,
                                           (size_t)H * W * Co);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

// ===========================================================================
// bf16: tensor cores
namespace tcb {
using namespace adconv::tc;

__global__ void __launch_bounds__(256)
conv_bwd_prologue(const bf16* __restrict__ x, const bf16* __restrict__ cvec,
                  bf16* __restrict__ abuf, int B, int F, int HW, int C, int Cp, int nones,
                  int silu, int vec) {
  act_prologue(x, cvec, abuf, B, F, HW, C, Cp, nones, silu, vec);
}

// dy2d, dctx and the per-chunk partial sums of dgates. Block (pixel chunk,
// batch row x t) with the context branch: GP_ITEMS groups of 8 channels of
// the chunk's pixels, each read from gout of the clean frame t and the noisy
// frame T + t (and diff and out, the forward's residual and result), written
// as dy2d of both frames and dctx[t]; each frame's partial sum of
// gout * (diff * r - out * (2g - 1) * r^2) over the chunk goes to
// dg_part[frame][chunk] (summed in a fixed order: threads, warps, then the
// chunks by the finalize). Without it, block (pixel chunk, frame): dy2d = gout.
__global__ void __launch_bounds__(GP_THREADS)
conv_bwd_grad_prologue(const bf16* __restrict__ gout, const bf16* __restrict__ diff,
                       const bf16* __restrict__ out, const float* __restrict__ gates,
                       bf16* __restrict__ dy2d, bf16* __restrict__ dctx,
                       float* __restrict__ dg_part, int F, int HW, int Co, int Cop,
                       int with_ctx, int vec) {
  __shared__ float red[2][GP_THREADS / 32];
  const int n8 = Cop / 8, chunk = blockIdx.x, nchunks = gridDim.x;
  const int per_row = with_ctx ? F / 2 : F;
  const int bt = blockIdx.y, b = bt / per_row, t = bt % per_row;
  const long long fc = (long long)b * F + t, fn = fc + per_row;
  const int i0 = chunk * GP_ITEMS, i1 = min(i0 + GP_ITEMS, HW * n8);
  if (!with_ctx) {
    for (int i = i0 + threadIdx.x; i < i1; i += GP_THREADS) {
      const int pix = i / n8, g = i % n8;
      float v[8];
      load8(gout + (fc * HW + pix) * Co, 8 * g, Co, vec, v);
      *reinterpret_cast<uint4*>(dy2d + (fc * HW + pix) * Cop + 8 * g) = pack8(v);
    }
    return;
  }
  const float g_c = gates[fc], g_n = gates[fn];
  const float r_c = gate_r(g_c), r_n = gate_r(g_n);
  const float sc = (1.f - g_c) * r_c, sn = (1.f - g_n) * r_n, kc = g_c * r_c, kn = g_n * r_n;
  const float qc = (2.f * g_c - 1.f) * r_c * r_c, qn = (2.f * g_n - 1.f) * r_n * r_n;
  float part_c = 0.f, part_n = 0.f;
  for (int i = i0 + threadIdx.x; i < i1; i += GP_THREADS) {
    const int pix = i / n8, g = i % n8;
    const long long oc = (fc * HW + pix) * Co, on = (fn * HW + pix) * Co;
    float vc[8], vn[8], dc[8], dn[8], uc[8], un[8];
    load8(gout + oc, 8 * g, Co, vec, vc);
    load8(gout + on, 8 * g, Co, vec, vn);
    load8(diff + oc, 8 * g, Co, vec, dc);
    load8(diff + on, 8 * g, Co, vec, dn);
    load8(out + oc, 8 * g, Co, vec, uc);
    load8(out + on, 8 * g, Co, vec, un);
    float yc[8], yn[8], xc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      yc[e] = vc[e] * sc;
      yn[e] = vn[e] * sn;
      xc[e] = vc[e] * kc + vn[e] * kn;
      part_c += vc[e] * (dc[e] * r_c - uc[e] * qc);
      part_n += vn[e] * (dn[e] * r_n - un[e] * qn);
    }
    *reinterpret_cast<uint4*>(dy2d + (fc * HW + pix) * Cop + 8 * g) = pack8(yc);
    *reinterpret_cast<uint4*>(dy2d + (fn * HW + pix) * Cop + 8 * g) = pack8(yn);
    *reinterpret_cast<uint4*>(dctx + ((long long)bt * HW + pix) * Cop + 8 * g) = pack8(xc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    part_c += __shfl_xor_sync(0xffffffffu, part_c, off);
    part_n += __shfl_xor_sync(0xffffffffu, part_n, off);
  }
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = part_c;
    red[1][threadIdx.x >> 5] = part_n;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    float tot = 0.f;
    for (int k = 0; k < GP_THREADS / 32; ++k) tot += red[threadIdx.x][k];
    dg_part[(threadIdx.x == 0 ? fc : fn) * nchunks + chunk] = tot;
  }
}

__global__ void __launch_bounds__(256)
conv_bwd_pack_w(const bf16* __restrict__ w2, const bf16* __restrict__ w3, bf16* __restrict__ wp,
                int nk, int C, int Co, int Kp, int Np) {
  pack_weights(w2, w3, wp, nk, C, Co, Kp, Np, 1);
}

struct DxArgs {
  const bf16* dy2d;  // (B, F, H, W, Cop)
  const bf16* dctx;  // (B, T, H, W, Cop)
  const bf16* wp;    // (nk, 9, Cop, Np): slot 0 w2, 1 w3[0], 2 w3[1], flipped and transposed
  const bf16* x;
  const bf16* cvec;
  bf16* dx;          // may be null
  float* dcv_part;   // (B * F, ntiles, C), null without cvec
  int B, F, H, W, C, Cop, Np, with_ctx, silu, tiles_x;
};

// Block (pixel tile, input-channel tile, MT batch rows x frame j of the row).
template <int NCO>
__global__ void __launch_bounds__(NTH * CONV_MT) conv_bwd_dx_tc(const __grid_constant__ DxArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int MT = CONV_MT, NI = ConvCfg<NCO, MT>::NI;
  const int H = a.H, W = a.W, C = a.C, F = a.F, T = F / 2;
  const int tile = blockIdx.x, ty0 = (tile / a.tiles_x) * 8, tx0 = (tile % a.tiles_x) * 8;
  const int c0 = blockIdx.y * NCO, j = blockIdx.z % F;
  const int b0 = (blockIdx.z / F) * MT, n_sb = min(MT, a.B - b0);
  const long long fsz = (long long)H * W * a.Cop, slot = (long long)9 * a.Cop * a.Np;
  const bf16* wb = a.wp + c0;
  Term terms[3];
  int n_terms = 1;
  terms[0] = Term{a.dy2d + ((long long)b0 * F + j) * fsz, wb, 0, F * fsz};
  if (a.with_ctx) {
    const bf16* row = a.dctx + (long long)b0 * T * fsz;
    if (j + 1 < T)  // clean frame t is h[t+2]: ctx[t+1] read it through w3[1]
      terms[n_terms++] = Term{row + (j + 1) * fsz, wb + 2 * slot, 0, T * fsz};
    if (j + 2 < T)  // and ctx[t+2] through w3[0]
      terms[n_terms++] = Term{row + (j + 2) * fsz, wb + slot, 0, T * fsz};
  }
  ConvPlan<NCO, MT> plan;
  plan.init(H, W, a.Cop, a.Np, ty0, tx0);
  float acc[2][NI][4];
  zero_acc(acc);
  conv_main_loop<NCO, MT, 1>(smem, plan, terms, n_terms, a.Cop / KCH, a.Np, n_sb, acc, acc, acc);

  // da -> dz -> dx; element (mi, ni, 2 h + e) at tile row 4 wm + 2 mi + h,
  // column lane / 4, channel c0 + NCO/2 wn + 8 ni + 2 (lane % 4) + e
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sb = warp >> 2, wm = warp & 1, wn = (warp >> 1) & 1;
  const bool live = sb < n_sb;
  const long long f = (long long)(b0 + sb) * F + j;
  const size_t xframe = (size_t)H * W * C;
  float cvv[NI][2], cs[NI][2];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + (NCO / 2) * wn + 8 * ni + 2 * (lane & 3) + e;
      cvv[ni][e] = (live && a.cvec != nullptr && c < C) ? to_f(a.cvec[f * C + c]) : 1.f;
      cs[ni][e] = 0.f;
    }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int py = ty0 + 4 * wm + 2 * mi + h, px = tx0 + (lane >> 2);
      if (!live || py >= H || px >= W) continue;
      const size_t pix = f * xframe + ((size_t)py * W + px) * C;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + (NCO / 2) * wn + 8 * ni + 2 * (lane & 3) + e;
          if (c >= C) continue;
          const float xv = to_f(a.x[pix + c]);
          float dz = acc[mi][ni][2 * h + e];
          if (a.silu) dz *= mp_dsilu(xv * cvv[ni][e]);
          if (a.dx != nullptr) a.dx[pix + c] = __float2bfloat16(dz * cvv[ni][e]);
          cs[ni][e] += dz * xv;
        }
    }
  if (a.dcv_part == nullptr) return;
  // dcvec partial of the tile: over the 8 columns (lanes of one lane % 4),
  // then the two warps of a channel range, in a fixed order
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        cs[ni][e] += __shfl_xor_sync(0xffffffffu, cs[ni][e], off);
  float* red = reinterpret_cast<float*>(smem);  // [MT][2 wm][NCO]; the stages are idle
  __syncthreads();                               // every warp is done with them
  if (lane < 4) {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        red[(2 * sb + wm) * NCO + (NCO / 2) * wn + 8 * ni + 2 * lane + e] = cs[ni][e];
  }
  __syncthreads();
  const int q = threadIdx.x % NCO, qs = threadIdx.x / NCO, c = c0 + q;
  if (qs < n_sb && c < C)
    a.dcv_part[(((long long)(b0 + qs) * F + j) * gridDim.x + tile) * C + c] =
        red[2 * qs * NCO + q] + red[(2 * qs + 1) * NCO + q];
}

struct DwArgs {
  const bf16* abuf;  // (B, F + nones, H, W, Cp)
  const bf16* dy2d;  // (B, F, H, W, Cop)
  const bf16* dctx;  // (B, T, H, W, Cop)
  float* part;       // (nk, S, 9, C, Co)
  int B, F, H, W, C, Co, Cp, Cop, nones, tiles_x, ntiles, n_ct;
};

// Block (32-channel tile x output tile, share, kind): kind 0 = w2 over every
// frame's (a[f], dy2d[f]), 1 = w3[0] over (h[t], dctx[t]), 2 = w3[1] over
// (h[t+1], dctx[t]); the share's units are (frame, pixel tile) u = share,
// share + S, ...
template <int NCO>
__global__ void __launch_bounds__(NTH) conv_bwd_dw_tc(const __grid_constant__ DwArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  using Cf = DwCfg<NCO>;
  constexpr int NJ = Cf::NJ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wc = warp & 1, wn = warp >> 1;
  const int c0 = (blockIdx.x % a.n_ct) * 32, co0 = (blockIdx.x / a.n_ct) * NCO;
  const int share = blockIdx.y, S = gridDim.y, kind = blockIdx.z;
  const int H = a.H, W = a.W, F = a.F, Cp = a.Cp, Cop = a.Cop;
  const int per_row = kind == 0 ? F : F / 2, Fb = F + a.nones;
  const int units = a.B * per_row * a.ntiles;
  const size_t fa = (size_t)H * W * Cp, fd = (size_t)H * W * Cop;
  const bf16* dbase = kind == 0 ? a.dy2d : a.dctx;

  auto load = [&](int s, int u) {
    const int tile = u % a.ntiles, fr = u / a.ntiles;
    const int ty0 = (tile / a.tiles_x) * 8, tx0 = (tile % a.tiles_x) * 8;
    const int b = fr / per_row, j = fr - b * per_row;
    const int fb = kind == 0 ? a.nones + j : j + kind - 1;
    const bf16* asrc = a.abuf + ((size_t)b * Fb + fb) * fa;
    const bf16* dsrc = dbase + (size_t)fr * fd;
    const uint32_t base = smem_u32(smem + s * Cf::STAGE);
#pragma unroll
    for (int m = 0; m < 4; ++m) {  // 400 halo pieces: 4 planes x 100 pixels
      const int i = tid + NTH * m;
      if (i >= 4 * HP) continue;
      const int plane = i / HP, hp = i - plane * HP;
      const int gy = ty0 - 1 + hp / 10, gx = tx0 - 1 + hp % 10, c = c0 + 8 * plane;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cp;
      cp_async_16(base + i * 16, ok ? asrc + ((size_t)gy * W + gx) * Cp + c : asrc, ok ? 16 : 0);
    }
#pragma unroll
    for (int m = 0; m < Cf::B_PT; ++m) {  // 64 pixels x NCO / 8 gradient pieces
      const int i = tid + NTH * m, p = i / (NCO / 8), q = i % (NCO / 8);
      const int py = ty0 + p / 8, px = tx0 + p % 8, co = co0 + 8 * q;
      const bool ok = py < H && px < W && co < Cop;
      cp_async_16(base + Cf::A_BYTES + (uint32_t)(p * Cf::BROW + 8 * q) * 2,
                  ok ? dsrc + ((size_t)py * W + px) * Cop + co : dsrc, ok ? 16 : 0);
    }
  };

  float acc[9][NJ][4];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[tap][j][e] = 0.f;
  const int n = share < units ? (units - share + S - 1) / S : 0;
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < n) load(s, share + s * S);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // stage i has landed; every warp is done with stage i - 1
    const int nx = i + NSTAGE - 1;
    if (nx < n) load(nx % NSTAGE, share + nx * S);
    cp_async_commit();
    dw_stage<NCO>(smem + (i % NSTAGE) * Cf::STAGE, acc, wc, wn);
  }
  cp_async_wait<0>();

  // element (tap, j, 2 h + e): channel c0 + 16 wc + lane / 4 + 8 h, output
  // co0 + NCO/2 wn + 8 j + 2 (lane % 4) + e
  const int C = a.C, Co = a.Co;
  float* dst = a.part + ((size_t)kind * S + share) * 9 * C * Co;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + 16 * wc + (lane >> 2) + 8 * h;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = co0 + (NCO / 2) * wn + 8 * j + 2 * (lane & 3) + e;
        if (co >= Co) continue;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) dst[((size_t)tap * C + c) * Co + co] = acc[tap][j][2 * h + e];
      }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done = true;
  return e;
}

template <int NCO>
cudaError_t launch_dx(const DxArgs& a, dim3 grid, cudaStream_t s) {
  using Cf = ConvCfg<NCO, CONV_MT>;
  static bool done = false;  // one attribute call per instantiation
  cudaError_t e = allow_smem(conv_bwd_dx_tc<NCO>, Cf::SMEM, done);
  if (e != cudaSuccess) return e;
  conv_bwd_dx_tc<NCO><<<grid, Cf::NT, Cf::SMEM, s>>>(a);
  return cudaGetLastError();
}

template <int NCO>
cudaError_t launch_dw(const DwArgs& a, dim3 grid, cudaStream_t s) {
  static bool done = false;
  cudaError_t e = allow_smem(conv_bwd_dw_tc<NCO>, DwCfg<NCO>::SMEM, done);
  if (e != cudaSuccess) return e;
  conv_bwd_dw_tc<NCO><<<grid, NTH, DwCfg<NCO>::SMEM, s>>>(a);
  return cudaGetLastError();
}

cudaError_t run_tc(const void* x, const void* w2, const void* w3, const void* cvec,
                   const float* gates, const void* gout, const void* diff, const void* out,
                   void* dx, void* dw2, void* dw3, void* dcvec, float* dgates, void* scratch,
                   int B, int F, int H, int W, int C, int Co, int silu_in, int with_ctx,
                   cudaStream_t s) {
  const Layout l = layout(B, F, H, W, C, Co, with_ctx, 1);
  uint8_t* sc = static_cast<uint8_t*>(scratch);
  bf16* abuf = reinterpret_cast<bf16*>(sc + l.abuf);
  bf16* dy2d = reinterpret_cast<bf16*>(sc + l.dy2d);
  bf16* dctx = reinterpret_cast<bf16*>(sc + l.dctx);
  bf16* wp = reinterpret_cast<bf16*>(sc + l.wp);
  float* dcv_part = reinterpret_cast<float*>(sc + l.dcv);
  float* dw_part = reinterpret_cast<float*>(sc + l.dwp);
  const bf16* xs = static_cast<const bf16*>(x);
  const bf16* cvs = static_cast<const bf16*>(cvec);
  const bf16* gos = static_cast<const bf16*>(gout);
  const int HW = H * W, tiles_x = (W + 7) / 8;
  cudaError_t e;

  const long long n_act = (long long)B * (F + l.nones) * HW * (l.Cp / 8);
  const long long n_w = (long long)l.nk * 9 * l.Cop * l.Np_x;
  if (n_act >= (1ll << 31) || n_w >= (1ll << 31)) return cudaErrorInvalidValue;  // 32-bit indices
  conv_bwd_prologue<<<grid_for(n_act, 256), 256, 0, s>>>(xs, cvs, abuf, B, F, HW, C, l.Cp,
                                                         l.nones, silu_in, vec8(C, x, cvec));
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  float* dg_part = reinterpret_cast<float*>(sc + l.dg);
  conv_bwd_grad_prologue<<<dim3(l.gp_chunks, B * (with_ctx ? F / 2 : F)), GP_THREADS, 0, s>>>(
      gos, static_cast<const bf16*>(diff), static_cast<const bf16*>(out), gates, dy2d, dctx,
      dg_part, F, HW, Co, l.Cop, with_ctx, vec8(Co, gout, diff, out));
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  if (dx != nullptr || cvec != nullptr) {
    conv_bwd_pack_w<<<grid_for(n_w, 256), 256, 0, s>>>(static_cast<const bf16*>(w2),
                                                       static_cast<const bf16*>(w3), wp, l.nk, C,
                                                       Co, l.Cop, l.Np_x);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    DxArgs a;
    a.dy2d = dy2d;
    a.dctx = dctx;
    a.wp = wp;
    a.x = xs;
    a.cvec = cvs;
    a.dx = static_cast<bf16*>(dx);
    a.dcv_part = cvec ? dcv_part : nullptr;
    a.B = B, a.F = F, a.H = H, a.W = W, a.C = C, a.Cop = l.Cop, a.Np = l.Np_x;
    a.with_ctx = with_ctx, a.silu = silu_in, a.tiles_x = tiles_x;
    dim3 grid(l.ntiles, l.Np_x / l.nco_x, (B + CONV_MT - 1) / CONV_MT * F);
    e = l.nco_x == 64 ? launch_dx<64>(a, grid, s) : launch_dx<32>(a, grid, s);
    if (e != cudaSuccess) return e;
  }

  DwArgs d;
  d.abuf = abuf;
  d.dy2d = dy2d;
  d.dctx = dctx;
  d.part = dw_part;
  d.B = B, d.F = F, d.H = H, d.W = W, d.C = C, d.Co = Co, d.Cp = l.Cp, d.Cop = l.Cop;
  d.nones = l.nones, d.tiles_x = tiles_x, d.ntiles = l.ntiles, d.n_ct = l.n_ct;
  dim3 wgrid(l.n_ct * l.n_nt, l.S, l.nk);
  e = l.nco_w == 64 ? launch_dw<64>(d, wgrid, s) : launch_dw<32>(d, wgrid, s);
  if (e != cudaSuccess) return e;
  if ((e = finalize<bf16>(l, dw2, dw3, dcvec, dcv_part, dw_part, B, F, C, Co, s)) != cudaSuccess)
    return e;
  if (with_ctx) {  // dgates from the grad prologue's chunk partials, in chunk order
    dcv_finalize_kernel<float><<<(B * F + 255) / 256, 256, 0, s>>>(dg_part, dgates, B * F,
                                                                   l.gp_chunks, 1);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

}  // namespace tcb
}  // namespace

extern "C" {

// Bytes of scratch ad_fused_conv_bwd needs.
long long ad_fused_conv_bwd_scratch(int B, int F, int H, int W, int C, int Co, int with_ctx,
                                    int dtype) {
  return (long long)layout(B, F, H, W, C, Co, with_ctx, dtype).bytes;
}

// dtype: 0 = float32 (SIMT kernels), 1 = bfloat16 (tensor cores). Inputs as
// in ad_fused_conv_fwd, plus gout and the forward's diff and out (both
// unread when with_ctx = 0). Outputs: dx (may be null: not wanted), dw2, dw3
// and dgates (unwritten when with_ctx = 0), dcvec (written iff cvec is
// given). scratch: ad_fused_conv_bwd_scratch bytes, 256-byte aligned,
// uninitialised. Returns a cudaError_t code (0 = success).
int ad_fused_conv_bwd(const void* x, const void* w2, const void* w3, const void* cvec,
                      const float* gates, const void* gout, const void* diff, const void* out,
                      void* dx, void* dw2, void* dw3, void* dcvec, float* dgates, void* scratch,
                      int B, int F, int H, int W, int C, int Co, int silu_in, int with_ctx,
                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || F <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0) return (int)cudaErrorInvalidValue;
  if (with_ctx && (F % 2 != 0 || w3 == nullptr || gates == nullptr || diff == nullptr ||
                   out == nullptr || dw3 == nullptr || dgates == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * F > 65535) return (int)cudaErrorInvalidValue;  // grid.z
  if (scratch == nullptr || (reinterpret_cast<uintptr_t>(scratch) & 255) != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)run_simt(x, w2, w3, cvec, gates, gout, diff, out, dx, dw2, dw3, dcvec, dgates,
                         scratch, B, F, H, W, C, Co, silu_in, with_ctx, s);
  if (dtype == 1)
    return (int)tcb::run_tc(x, w2, w3, cvec, gates, gout, diff, out, dx, dw2, dw3, dcvec, dgates,
                            scratch, B, F, H, W, C, Co, silu_in, with_ctx, s);
  return (int)cudaErrorInvalidValue;
}

const char* ad_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
