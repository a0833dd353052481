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
// dy2d and dctx are never stored: every consumer forms them in fp32 from
// gout and the gates while it stages its tile. a is recomputed from x as in
// the forward pass (fp32 transform, rounded to the working type). diff =
// ctx - y2d and out are the forward pass's residual and result.
//
// What bounds it on the H100: twice the forward's operations (one
// transposed convolution and one weight-gradient product per forward
// convolution) over about the same bytes, so operations; plain fp32 FMAs
// in this first version, no tensor cores.
// Why not the TPU kernel's shape: that one walks the frames of a batch row
// backwards in order on one core, carrying pending context gradients and the
// weight-gradient sums in VMEM across grid steps. Blocks here run in no
// order and share nothing, so the work is split by output:
//   1. transpose_w:  flipped, transposed copies of w2, w3 for the convT;
//   2. dx_kernel:    da by the forward's tile loop on (dy2d | dctx, wT),
//                    then dx, and per-tile partial sums of dcvec;
//   3. dcv_finalize: sums the per-tile partials (fixed order);
//   4. dw_kernel:    each block owns a 16 x 32 (c, co) tile of one weight for
//                    all 9 taps and a strided share of the pixel tiles, and
//                    writes its partial sum;
//   5. dw_finalize:  sums the partials in a fixed order and casts;
//   6. dgates_kernel: one block a frame.
// No atomics: every result is the same from run to run.
#include "conv_tile.cuh"

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

template <typename T>
cudaError_t run(const void* x, const void* w2, const void* w3, const void* cvec,
                const float* gates, const void* gout, const void* diff, const void* out,
                void* dx, void* dw2, void* dw3, void* dcvec, float* dgates, void* wT,
                float* dcv_part, float* dw_part, int B, int F, int H, int W, int C, int Co,
                int silu_in, int with_ctx, int S, cudaStream_t s) {
  const int kinds = with_ctx ? 3 : 1;
  const int ntiles = ((H + TS - 1) / TS) * ((W + TS - 1) / TS);
  const T* xs = static_cast<const T*>(x);
  const T* cvs = static_cast<const T*>(cvec);
  const T* gos = static_cast<const T*>(gout);
  cudaError_t e;

  if (dx != nullptr || cvec != nullptr) {
    const size_t nw = (size_t)9 * C * Co * kinds;
    transpose_w_kernel<T><<<(unsigned)((nw + 255) / 256 < 1024 ? (nw + 255) / 256 : 1024), 256, 0,
                            s>>>(static_cast<const T*>(w2), static_cast<const T*>(w3),
                                 static_cast<T*>(wT), C, Co, kinds);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    dim3 grid(ntiles, (C + CO_T - 1) / CO_T, with_ctx ? B * (F / 2) : B * F);
    dx_kernel<T><<<grid, CNT, 0, s>>>(xs, cvs, gates, gos, static_cast<const T*>(wT),
                                      static_cast<T*>(dx), cvec ? dcv_part : nullptr, F, H, W,
                                      C, Co, silu_in, with_ctx);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if (cvec != nullptr) {
      const int n = B * F * C;
      dcv_finalize_kernel<T><<<(n + 255) / 256, 256, 0, s>>>(dcv_part, static_cast<T*>(dcvec),
                                                             B * F, ntiles, C);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
  }

  dim3 wgrid(((C + KC - 1) / KC) * ((Co + CO_T - 1) / CO_T), S, kinds);
  dw_kernel<T><<<wgrid, CNT, 0, s>>>(xs, cvs, gates, gos, dw_part, B, F, H, W, C, Co, silu_in,
                                     with_ctx);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t nwo = (size_t)9 * C * Co * kinds;
  dw_finalize_kernel<T><<<(unsigned)((nwo + 255) / 256), 256, 0, s>>>(
      dw_part, static_cast<T*>(dw2), static_cast<T*>(dw3), S, C, Co, kinds);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  if (with_ctx) {
    dgates_kernel<T><<<B * F, 256, 0, s>>>(gos, static_cast<const T*>(diff),
                                           static_cast<const T*>(out), gates, dgates,
                                           (size_t)H * W * Co);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Inputs as in ad_fused_conv_fwd, plus
// gout and the forward's diff and out (both unread when with_ctx = 0).
// Outputs: dx (may be null: not wanted), dw2, dw3 and dgates (unwritten when
// with_ctx = 0), dcvec (written iff cvec is given). Scratch, uninitialised:
//   wT       (kinds * 9 * C * Co) of the working type, kinds = with_ctx ? 3 : 1
//   dcv_part (B * F * ntiles * C) fp32, ntiles = ceil(H/8) * ceil(W/8); with cvec
//   dw_part  (kinds * S * 9 * C * Co) fp32; S >= 1 is the number of shares the
//            pixel tiles are dealt into for the weight gradients.
// Returns a cudaError_t code (0 = success).
int ad_fused_conv_bwd(const void* x, const void* w2, const void* w3, const void* cvec,
                      const float* gates, const void* gout, const void* diff, const void* out,
                      void* dx, void* dw2, void* dw3, void* dcvec, float* dgates, void* wT,
                      float* dcv_part, float* dw_part, int B, int F, int H, int W, int C,
                      int Co, int silu_in, int with_ctx, int S, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || F <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || S <= 0 || S > 65535)
    return (int)cudaErrorInvalidValue;
  if (with_ctx && (F % 2 != 0 || w3 == nullptr || gates == nullptr || diff == nullptr ||
                   out == nullptr || dw3 == nullptr || dgates == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * F > 65535) return (int)cudaErrorInvalidValue;  // grid.z
  if (dtype == 0)
    return (int)run<float>(x, w2, w3, cvec, gates, gout, diff, out, dx, dw2, dw3, dcvec, dgates,
                           wT, dcv_part, dw_part, B, F, H, W, C, Co, silu_in, with_ctx, S, s);
  if (dtype == 1)
    return (int)run<__nv_bfloat16>(x, w2, w3, cvec, gates, gout, diff, out, dx, dw2, dw3, dcvec,
                                   dgates, wT, dcv_part, dw_part, B, F, H, W, C, Co, silu_in,
                                   with_ctx, S, s);
  return (int)cudaErrorInvalidValue;
}

const char* ad_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
