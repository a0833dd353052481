// Train-mode fused gated causal conv, forward, for sm_90a.
//
// Replaces the JAX package's Pallas forward kernel
//   autoregressive_diffusion_tpu/ops/fused_conv.py::fused_gated_conv
//   (_fused_fwd_impl :801, pallas_call :830, body _fwd_kernel :358)
// on torch's channels-last layouts. x (B, F, H, W, C) is the DART concat
// (clean frames [0, T), noisy frames [T, 2T), F = 2T) when with_ctx, or F
// independent frames otherwise:
//   a       = mp_silu(x * cvec)          (each factor optional; fp32, then
//                                         rounded to the working type)
//   y2d[f]  = conv3x3(a[f], w2)
//   ctx[t]  = conv3x3(h[t], w3[0]) + conv3x3(h[t+1], w3[1]),
//             h = [ones, ones, a_clean[0], ..., a_clean[T-2]]
//   out[f]  = (y2d[f] + (ctx[f mod T] - y2d[f]) * g[f]) * rsqrt((1-g)^2 + g^2)
// and, for the backward pass, diff[f] = ctx[f mod T] - y2d[f] (the gate
// gradient needs it; the TPU kernel saves y2d and ctx instead). Without
// with_ctx, out = y2d and nothing else is written. Sums are fp32.
//
// What bounds it on the H100: 72*T*H*W*C*Co operations a batch row against
// (C + 2*Co) elements a pixel, several hundred operations a byte at the
// model's widths, so operations (1.61 TFLOP of products a DART step of the
// gym model: 1.63 ms at 989 TFLOP/s).
// Why not the TPU kernel's shape: that one walks T in order on one core and
// carries a ring of transformed clean frames in VMEM from step to step.
// Blocks here run in no order, so each block takes one (batch row, time t,
// pixel tile, output channels), reads the two past clean frames itself,
// computes ctx[t] once and serves both the clean frame t and the noisy
// frame T+t with it: four frame convolutions for two output frames.
//
// bf16 (the training path's type), on the tensor cores, three launches:
//   1. conv_fwd_prologue: a into the padded buffer abuf (B, F + 2, H, W, Cp)
//      behind two ones frames, so ctx[t] reads buffer frames t and t + 1
//      and the clip start needs no special case (conv_tc.cuh);
//   2. conv_fwd_pack_w: w2, w3[0], w3[1] padded to (3, 9, Cp, Np);
//   3. conv_fwd_tc: the implicit GEMM (M = an 8x8 pixel tile, N = 32 or 64
//      outputs, K = source frame x 16-channel chunk x 9 taps) on mma.sync
//      m16n8k16, fed by a 4-stage cp.async ring (conv_tc.cuh says why not
//      wgmma), with three fp32 accumulators (clean y2d, noisy y2d, the
//      shared ctx) and the gate blend as its epilogue.
// The prologue is timed under its own name, so that a later change can
// fold it into the staging. Scratch: abuf and the packed weights, from
// ad_fused_conv_fwd_scratch.
// fp32 keeps the SIMT kernel (fused_conv_fwd_kernel: an 8x8-pixel x
// 32-channel tile of plain fp32 FMAs, conv_tile.cuh): its callers are held
// to fp32 roundoff, which no bf16 product meets. The type alone picks the
// path.
#include "conv_tc.cuh"

namespace {
using namespace adconv;

template <typename T>
__global__ void __launch_bounds__(CNT)
fused_conv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w2,
                      const T* __restrict__ w3, const T* __restrict__ cvec,
                      const float* __restrict__ gates, T* __restrict__ out,
                      T* __restrict__ diff, int F, int H, int W, int C, int Co, int silu_in,
                      int with_ctx) {
  __shared__ TileSmem sm;
  const int tiles_x = (W + TS - 1) / TS;
  const int ty0 = (blockIdx.x / tiles_x) * TS, tx0 = (blockIdx.x % tiles_x) * TS;
  const int co0 = blockIdx.y * CO_T;
  const int cg = threadIdx.x & 7, pg = threadIdx.x >> 3;
  const size_t frame = (size_t)H * W * C, oframe = (size_t)H * W * Co;

  if (!with_ctx) {
    const int bf = blockIdx.z;  // b * F + f
    float acc[4][4];
    zero_tile(acc);
    ActLoad<T> ld{x + bf * frame, cvec ? cvec + (size_t)bf * C : nullptr, W, C, silu_in};
    conv_tile<T>(ld, w2, sm, acc, H, W, C, Co, ty0, tx0, co0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int y = ty0 + pg / TS + 2 * i, xq = tx0 + pg % TS;
      if (y >= H || xq >= W) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int oc = co0 + cg * 4 + j;
        if (oc < Co) out[bf * oframe + ((size_t)y * W + xq) * Co + oc] = from_f<T>(acc[i][j]);
      }
    }
    return;
  }

  const int T_half = F / 2;
  const int b = blockIdx.z / T_half, t = blockIdx.z % T_half;
  const int fc = b * F + t, fn = fc + T_half;  // clean and noisy frame
  float acc_c[4][4], acc_n[4][4], acc_x[4][4];
  zero_tile(acc_c);
  zero_tile(acc_n);
  zero_tile(acc_x);
  {
    ActLoad<T> ld{x + fc * frame, cvec ? cvec + (size_t)fc * C : nullptr, W, C, silu_in};
    conv_tile<T>(ld, w2, sm, acc_c, H, W, C, Co, ty0, tx0, co0);
  }
  {
    ActLoad<T> ld{x + fn * frame, cvec ? cvec + (size_t)fn * C : nullptr, W, C, silu_in};
    conv_tile<T>(ld, w2, sm, acc_n, H, W, C, Co, ty0, tx0, co0);
  }
  for (int k = 0; k < 2; ++k) {  // w3[k] takes clean frame t - 2 + k
    const int tp = t - 2 + k;
    ActLoad<T> ld{nullptr, nullptr, W, C, silu_in};
    if (tp >= 0) {
      ld.frame = x + (size_t)(b * F + tp) * frame;
      ld.cv = cvec ? cvec + (size_t)(b * F + tp) * C : nullptr;
    }
    conv_tile<T>(ld, w3 + (size_t)k * 9 * C * Co, sm, acc_x, H, W, C, Co, ty0, tx0, co0);
  }

  const float g_c = gates[fc], g_n = gates[fn];
  const float r_c = rsqrtf((1.f - g_c) * (1.f - g_c) + g_c * g_c);
  const float r_n = rsqrtf((1.f - g_n) * (1.f - g_n) + g_n * g_n);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int y = ty0 + pg / TS + 2 * i, xq = tx0 + pg % TS;
    if (y >= H || xq >= W) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int oc = co0 + cg * 4 + j;
      if (oc >= Co) continue;
      const size_t pix = ((size_t)y * W + xq) * Co + oc;
      const float d_c = acc_x[i][j] - acc_c[i][j], d_n = acc_x[i][j] - acc_n[i][j];
      out[fc * oframe + pix] = from_f<T>((acc_c[i][j] + d_c * g_c) * r_c);
      out[fn * oframe + pix] = from_f<T>((acc_n[i][j] + d_n * g_n) * r_n);
      if (diff != nullptr) {
        diff[fc * oframe + pix] = from_f<T>(d_c);
        diff[fn * oframe + pix] = from_f<T>(d_n);
      }
    }
  }
}


template <typename T>
cudaError_t run_simt(const void* x, const void* w2, const void* w3, const void* cvec,
                     const float* gates, void* out, void* diff, int B, int F, int H, int W, int C,
                     int Co, int silu_in, int with_ctx, cudaStream_t s) {
  const int frames = with_ctx ? B * (F / 2) : B * F;
  dim3 grid(((H + TS - 1) / TS) * ((W + TS - 1) / TS), (Co + CO_T - 1) / CO_T, frames);
  fused_conv_fwd_kernel<T><<<grid, CNT, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w2), static_cast<const T*>(w3),
      static_cast<const T*>(cvec), gates, static_cast<T*>(out), static_cast<T*>(diff), F, H, W,
      C, Co, silu_in, with_ctx);
  return cudaGetLastError();
}

// ===========================================================================
// bf16: tensor cores
namespace tcf {
using namespace adconv::tc;

__global__ void __launch_bounds__(256)
conv_fwd_prologue(const bf16* __restrict__ x, const bf16* __restrict__ cvec,
                  bf16* __restrict__ abuf, int B, int F, int HW, int C, int Cp, int nones,
                  int silu, int vec) {
  act_prologue(x, cvec, abuf, B, F, HW, C, Cp, nones, silu, vec);
}

__global__ void __launch_bounds__(256)
conv_fwd_pack_w(const bf16* __restrict__ w2, const bf16* __restrict__ w3, bf16* __restrict__ wp,
                int nk, int C, int Co, int Kp, int Np) {
  pack_weights(w2, w3, wp, nk, C, Co, Kp, Np, 0);
}

struct FwdArgs {
  const bf16* abuf;  // (B, F + nones, H, W, Cp)
  const bf16* wp;    // (nk, 9, Cp, Np)
  const float* gates;
  bf16* out;
  bf16* diff;  // may be null
  int B, F, H, W, Co, Cp, Np, tiles_x;
};

// out[pixel row][col], [col + 1] from two fp32 values (pairs where Co is even)
__device__ __forceinline__ void store2(bf16* row, int col, int Co, float v0, float v1) {
  if ((Co & 1) == 0 && col + 1 < Co) {
    *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (col < Co) row[col] = __float2bfloat16(v0);
    if (col + 1 < Co) row[col + 1] = __float2bfloat16(v1);
  }
}

// Block (pixel tile, output tile, MT batch rows x j): j = t with the context
// branch (clean frame t, noisy frame T + t), j = the frame without it.
template <int NCO, bool CTX>
__global__ void __launch_bounds__(NTH * CONV_MT) conv_fwd_tc(const __grid_constant__ FwdArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int MT = CONV_MT, NI = ConvCfg<NCO, MT>::NI;
  const int H = a.H, W = a.W, Co = a.Co, F = a.F;
  const int ty0 = (blockIdx.x / a.tiles_x) * 8, tx0 = (blockIdx.x % a.tiles_x) * 8;
  const int co0 = blockIdx.y * NCO;
  const int per_row = CTX ? F / 2 : F, j = blockIdx.z % per_row;
  const int b0 = (blockIdx.z / per_row) * MT, n_sb = min(MT, a.B - b0);
  const size_t fsz = (size_t)H * W * a.Cp, slot = (size_t)9 * a.Cp * a.Np;
  const long long rstride = (long long)(CTX ? F + 2 : F) * fsz;  // a batch row of abuf
  const bf16* row = a.abuf + b0 * rstride;  // buffer frame k of the row: h[k] with CTX
  const bf16* wb = a.wp + co0;
  Term terms[4];
  int n_terms = 1;
  if (CTX) {
    const int T = per_row;
    terms[0] = Term{row + (size_t)(2 + j) * fsz, wb, 0, rstride};          // clean frame t
    terms[1] = Term{row + (size_t)(2 + T + j) * fsz, wb, 1, rstride};      // noisy frame T + t
    terms[2] = Term{row + (size_t)j * fsz, wb + slot, 2, rstride};         // h[t] by w3[0]
    terms[3] = Term{row + (size_t)(j + 1) * fsz, wb + 2 * slot, 2, rstride};  // h[t+1], w3[1]
    n_terms = 4;
  } else {
    terms[0] = Term{row + (size_t)j * fsz, wb, 0, rstride};
  }
  ConvPlan<NCO, MT> plan;
  plan.init(H, W, a.Cp, a.Np, ty0, tx0);
  float acc_c[2][NI][4], acc_n[2][NI][4], acc_x[2][NI][4];
  zero_acc(acc_c);
  if (CTX) {
    zero_acc(acc_n);
    zero_acc(acc_x);
    conv_main_loop<NCO, MT, 3>(smem, plan, terms, n_terms, a.Cp / KCH, a.Np, n_sb, acc_c, acc_n,
                               acc_x);
  } else {
    conv_main_loop<NCO, MT, 1>(smem, plan, terms, n_terms, a.Cp / KCH, a.Np, n_sb, acc_c, acc_c,
                               acc_c);
  }

  // accumulator element 2 h + e of m16 tile mi, n8 tile ni: tile row
  // 4 wm + 2 mi + h, column lane / 4, output co0 + NCO/2 wn + 8 ni + 2 (lane % 4) + e
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sb = warp >> 2, wm = warp & 1, wn = (warp >> 1) & 1;
  if (sb >= n_sb) return;
  const int b = b0 + sb;
  const long long fc = (long long)b * F + j, fn = fc + per_row;
  const size_t oframe = (size_t)H * W * Co;
  float gc = 0.f, rc = 1.f, gn = 0.f, rn = 1.f;
  if (CTX) {
    gc = a.gates[fc];
    gn = a.gates[fn];
    rc = rsqrtf((1.f - gc) * (1.f - gc) + gc * gc);
    rn = rsqrtf((1.f - gn) * (1.f - gn) + gn * gn);
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int py = ty0 + 4 * wm + 2 * mi + h, px = tx0 + (lane >> 2);
      if (py >= H || px >= W) continue;
      const size_t pix = ((size_t)py * W + px) * Co;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int col = co0 + (NCO / 2) * wn + 8 * ni + 2 * (lane & 3);
        const float c0v = acc_c[mi][ni][2 * h], c1v = acc_c[mi][ni][2 * h + 1];
        if (!CTX) {
          store2(a.out + fc * oframe + pix, col, Co, c0v, c1v);
          continue;
        }
        const float n0v = acc_n[mi][ni][2 * h], n1v = acc_n[mi][ni][2 * h + 1];
        const float x0 = acc_x[mi][ni][2 * h], x1 = acc_x[mi][ni][2 * h + 1];
        const float dc0 = x0 - c0v, dc1 = x1 - c1v, dn0 = x0 - n0v, dn1 = x1 - n1v;
        store2(a.out + fc * oframe + pix, col, Co, (c0v + dc0 * gc) * rc, (c1v + dc1 * gc) * rc);
        store2(a.out + fn * oframe + pix, col, Co, (n0v + dn0 * gn) * rn, (n1v + dn1 * gn) * rn);
        if (a.diff != nullptr) {
          store2(a.diff + fc * oframe + pix, col, Co, dc0, dc1);
          store2(a.diff + fn * oframe + pix, col, Co, dn0, dn1);
        }
      }
    }
}

// Scratch layout: abuf, then the packed weights, each 256-byte aligned.
struct Layout {
  int Cp, nco, Np, nones, nk;
  size_t abuf_elems, wp_off, bytes;
};

inline size_t align256(size_t b) { return (b + 255) / 256 * 256; }

inline Layout layout(int B, int F, int H, int W, int C, int Co, int with_ctx) {
  Layout l;
  l.Cp = round_up(C, KCH);
  l.nco = nco_for(Co);
  l.Np = round_up(Co, l.nco);
  l.nones = with_ctx ? 2 : 0;
  l.nk = with_ctx ? 3 : 1;
  l.abuf_elems = (size_t)B * (F + l.nones) * H * W * l.Cp;
  l.wp_off = align256(l.abuf_elems * 2);
  l.bytes = l.wp_off + align256((size_t)l.nk * 9 * l.Cp * l.Np * 2);
  return l;
}

inline unsigned grid_for(long long n, int threads) {
  const long long g = (n + threads - 1) / threads;
  return (unsigned)(g < 8192 ? (g > 0 ? g : 1) : 8192);
}

template <int NCO, bool CTX>
cudaError_t launch_tc(const FwdArgs& a, dim3 grid, cudaStream_t s) {
  using Cf = ConvCfg<NCO, CONV_MT>;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(conv_fwd_tc<NCO, CTX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Cf::SMEM);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  conv_fwd_tc<NCO, CTX><<<grid, Cf::NT, Cf::SMEM, s>>>(a);
  return cudaGetLastError();
}

cudaError_t run_tc(const void* x, const void* w2, const void* w3, const void* cvec,
                   const float* gates, void* out, void* diff, void* scratch, int B, int F, int H,
                   int W, int C, int Co, int silu_in, int with_ctx, cudaStream_t s) {
  const Layout l = layout(B, F, H, W, C, Co, with_ctx);
  bf16* abuf = static_cast<bf16*>(scratch);
  bf16* wp = reinterpret_cast<bf16*>(static_cast<uint8_t*>(scratch) + l.wp_off);
  const int HW = H * W;
  const long long n_pro = (long long)B * (F + l.nones) * HW * (l.Cp / 8);
  const long long n_w = (long long)l.nk * 9 * l.Cp * l.Np;
  if (n_pro >= (1ll << 31) || n_w >= (1ll << 31)) return cudaErrorInvalidValue;  // 32-bit indices
  conv_fwd_prologue<<<grid_for(n_pro, 256), 256, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(cvec), abuf, B, F, HW, C, l.Cp,
      l.nones, silu_in, vec8(C, x, cvec));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  conv_fwd_pack_w<<<grid_for(n_w, 256), 256, 0, s>>>(static_cast<const bf16*>(w2),
                                                     static_cast<const bf16*>(w3), wp, l.nk, C,
                                                     Co, l.Cp, l.Np);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  FwdArgs a;
  a.abuf = abuf;
  a.wp = wp;
  a.gates = gates;
  a.out = static_cast<bf16*>(out);
  a.diff = static_cast<bf16*>(diff);
  a.B = B, a.F = F, a.H = H, a.W = W, a.Co = Co, a.Cp = l.Cp, a.Np = l.Np;
  a.tiles_x = (W + 7) / 8;
  const int row_blocks = (B + CONV_MT - 1) / CONV_MT;
  dim3 grid(a.tiles_x * ((H + 7) / 8), l.Np / l.nco, row_blocks * (with_ctx ? F / 2 : F));
  if (l.nco == 64)
    return with_ctx ? launch_tc<64, true>(a, grid, s) : launch_tc<64, false>(a, grid, s);
  return with_ctx ? launch_tc<32, true>(a, grid, s) : launch_tc<32, false>(a, grid, s);
}

}  // namespace tcf
}  // namespace

extern "C" {

// Bytes of scratch ad_fused_conv_fwd needs (0 for float32).
long long ad_fused_conv_fwd_scratch(int B, int F, int H, int W, int C, int Co, int with_ctx,
                                    int dtype) {
  if (dtype != 1) return 0;
  return (long long)tcf::layout(B, F, H, W, C, Co, with_ctx).bytes;
}

// dtype: 0 = float32 (SIMT kernel), 1 = bfloat16 (tensor cores). cvec may
// be null; w3, gates and diff may be null when with_ctx = 0; diff may be
// null when no gradient is wanted. scratch: ad_fused_conv_fwd_scratch bytes,
// 256-byte aligned, uninitialised (unread for float32). Returns a
// cudaError_t code (0 = success).
int ad_fused_conv_fwd(const void* x, const void* w2, const void* w3, const void* cvec,
                      const float* gates, void* out, void* diff, void* scratch, int B, int F,
                      int H, int W, int C, int Co, int silu_in, int with_ctx, int dtype,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || F <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0) return (int)cudaErrorInvalidValue;
  if (with_ctx && (F % 2 != 0 || w3 == nullptr || gates == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long frames = with_ctx ? (long long)B * (F / 2) : (long long)B * F;
  if (frames > 65535) return (int)cudaErrorInvalidValue;  // grid.z
  if (dtype == 0)
    return (int)run_simt<float>(x, w2, w3, cvec, gates, out, diff, B, F, H, W, C, Co, silu_in,
                                with_ctx, s);
  if (dtype == 1) {
    if (scratch == nullptr || (reinterpret_cast<uintptr_t>(scratch) & 255) != 0)
      return (int)cudaErrorInvalidValue;
    return (int)tcf::run_tc(x, w2, w3, cvec, gates, out, diff, scratch, B, F, H, W, C, Co,
                            silu_in, with_ctx, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* ad_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
