// Fused attention-free decode Block (one T=1 cached step), for sm_90a.
//
// Replaces the JAX package's Pallas decode kernel
//   autoregressive_diffusion_tpu/ops/fused_conv.py::fused_decode_block
//   (:1130, _decode_kernel :1069) and computes what it computes, on torch's
//   channels-last layouts (x (B,H,W,Cin), rings (B,2,H,W,C), weights HWIO):
//     enc: h = pixel_norm(x @ wsk | x), res = h      dec: h = x, res = x @ wsk | x
//     t0 = mp_silu(h)
//     y  = conv3x3(t0, w20) [blended with ctx0 = conv3x3(a0[0], w30[0]) +
//          conv3x3(a0[1], w30[1]) by the gate g0]
//     t1 = mp_silu(y * cv)
//     y  = conv3x3(t1, w21) [blended with ctx1 from a1, w31 by g1]
//     out = clip(mp_sum(res, y, res_t))
//   and emits t0 and t1 for the caller's ring update. Convolutions take t0,
//   t1, the rings and the weights in the working type and sum in fp32, as
//   the TPU kernel's dots do; the skip product and pixel norm are fp32.
//
// What bounds it on the H100: a Block is 0.11-1.8 GFLOP on 0.6-8 MB (the
// 17 Blocks of a gym denoiser call: 12.6 GFLOP, 52.7 MB, a bound of about
// 17 us set by bytes at 3.35 TB/s), far less than the card can keep busy:
// each Block is bound by the latency of its launches and of its serial
// reductions, not by bytes or operations.
// Why not one program per batch row, as on the TPU: the TPU kernel holds a
// whole frame in VMEM, but t1 at 64x64x32 fp32 is 512 KB, more than a
// block's 227 KB of shared memory, and conv1 needs t1's 3x3 neighbourhood
// across the frame. So space is split across blocks and the Block runs as
// three launches on one stream.
//
// bf16 (the serving path's type), on the tensor cores, three launches:
//   1. the per-pixel prologue (skip, norm, silu -> t0 and an fp32 residual)
//      beside the two context convolutions ctx0 = conv(a0, w30) and ctx1 =
//      conv(a1, w31), which read only the rings and are two thirds of the
//      operations: they leave the critical path and land as fp32 (ctx);
//   2. conv0 over t0 (9 C0 of reduction), + ctx0, gate, * cv, silu -> t1;
//   3. conv1 over t1 (9 Co), + ctx1, gate, residual, clip -> y.
// A convolution is an implicit GEMM, M = the 64 pixels of an 8x8 tile, N =
// 32 output channels, K = 9 taps x C a frame, on mma.sync m16n8k16 (bf16 in,
// fp32 sums): a stage holds 16 channels of the 10x10 halo as [2 planes of 8
// channels][100 pixels][8 channels], so a tap (dy, dx) only moves the start
// of the 8 pixels a row that ldmatrix reads (128 contiguous bytes, no bank
// conflicts), and the weights as [9 taps][16 channels][32 + 8 pad outputs]
// (80-byte rows: ldmatrix.trans without conflicts). ldmatrix and mma.sync
// read every tap in place at any C, where a wgmma descriptor would have to
// hold the halo's two strides and a 64-pixel M per warpgroup. cp.async
// fills a ring of four stages, so copies overlap the products. The
// reduction (frames x 16-channel chunks) is split over the S blocks of a
// thread-block cluster when an output tile alone would leave the card
// idle (S chosen so a launch has up to 264 blocks and each block at least
// four chunks of the longest reduction); the leader adds its partners' fp32 partial tiles from
// distributed shared memory in rank order and runs the epilogue, so the
// results repeat bit for bit, with no atomics.
// fp32 keeps the SIMT kernels (a per-pixel prologue, then two conv launches
// that stage halo tiles and weights in shared memory and sum plain fp32
// FMAs): its callers are held to fp32 roundoff, which no bf16 product
// meets. The type alone picks the path.
//
// Channel limits. Both paths stage a pixel's Cin inputs as fp32 in shared
// memory for the prologue's skip product, so Cin <= MAX_CIN (1024: 32 KB
// for the SIMT prologue's 8 warps, under the 48 KB a launch gets without
// opting in; 3 pixels a warp in the tensor-core stage ring). C0 and Co
// have no limit of their own: the convolutions loop over 16-channel
// chunks and output tiles of 32, and the prologue keeps the enc flavor's
// unnormalised h in the fp32 residual buffer until the pixel norm, so no
// register array a lane holds bounds them. The dec flavor's C0 == Cin is
// then <= 1024. Beyond that only the grid bounds a launch (65535 rows of
// blocks).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// mp_silu in fp32: sigmoid(z) * z / 0.596
__device__ __forceinline__ float mp_silu(float z) {
  return z / (1.f + expf(-z)) * (1.f / 0.596f);
}

// ---------------------------------------------------------------------------
// Prologue, one warp for np <= PRO_PIX neighbouring pixels p0 .. at once:
// the pixels' inputs in xs (np x Cin floats), each lane a channel at a time
// for all np pixels, so every skip weight read serves np pixels. enc: h =
// x @ wsk | x over C0 == Co channels, pixel norm, res = h; dec: res = x @
// wsk | x. t0 = mp_silu(h). The unnormalised h of the enc flavor goes
// through res, which the lane that wrote it reads back after the norm.
constexpr int PRO_PIX = 4;
constexpr int MAX_CIN = 1024;  // input channels of a pixel staged in shared memory

template <typename T>
__device__ __forceinline__ void prologue_group(const T* __restrict__ x, const T* __restrict__ wsk,
                                               T* __restrict__ t0, float* __restrict__ res,
                                               float* xs, int p0, int np, int Cin, int C0,
                                               int Co, int enc, int has_skip) {
  const int lane = threadIdx.x & 31;
  __syncwarp();  // the warp's previous pixels are done with xs
  for (int q = 0; q < np; ++q)
    for (int c = lane; c < Cin; c += 32) xs[q * Cin + c] = to_f(x[(size_t)(p0 + q) * Cin + c]);
  __syncwarp();
  float ss[PRO_PIX] = {};
  const int C = enc ? C0 : Co;  // channels of h (enc) or of the residual (dec)
  for (int c = lane; c < C; c += 32) {
    float h[PRO_PIX] = {};
    if (has_skip) {
#pragma unroll 8
      for (int ci = 0; ci < Cin; ++ci) {  // 8 weight reads in flight
        const float w = to_f(wsk[(size_t)ci * Co + c]);
#pragma unroll
        for (int q = 0; q < PRO_PIX; ++q)
          if (q < np) h[q] += xs[q * Cin + ci] * w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < PRO_PIX; ++q)
        if (q < np) h[q] = xs[q * Cin + c];
    }
#pragma unroll
    for (int q = 0; q < PRO_PIX; ++q)
      if (q < np) {
        ss[q] += h[q] * h[q];
        res[(size_t)(p0 + q) * Co + c] = h[q];
      }
  }
  if (enc) {
#pragma unroll
    for (int q = 0; q < PRO_PIX; ++q) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ss[q] += __shfl_xor_sync(0xffffffffu, ss[q], off);
      ss[q] = 1e-4f + sqrtf(ss[q] + 1e-24f) * (1.f / sqrtf((float)C0));
    }
    for (int c = lane; c < C0; c += 32)
#pragma unroll
      for (int q = 0; q < PRO_PIX; ++q)
        if (q < np) {
          const size_t k = (size_t)(p0 + q) * Co + c;
          const float hn = res[k] / ss[q];
          res[k] = hn;
          t0[(size_t)(p0 + q) * C0 + c] = from_f<T>(mp_silu(hn));
        }
  } else {
    for (int q = 0; q < np; ++q)
      for (int c = lane; c < C0; c += 32)
        t0[(size_t)(p0 + q) * C0 + c] = from_f<T>(mp_silu(xs[q * Cin + c]));
  }
}

// ===========================================================================
// fp32: SIMT kernels.
constexpr int PRO_WARPS = 8;
static_assert(PRO_WARPS * MAX_CIN * sizeof(float) <= 48 * 1024,
              "the SIMT prologue's staging fits the shared memory of a launch without opt-in");

// One warp a pixel (np = 1): at fp32 more blocks beat reusing skip weights.
__global__ void __launch_bounds__(PRO_WARPS * 32)
decode_prologue_kernel(const float* __restrict__ x, const float* __restrict__ wsk,
                       float* __restrict__ t0, float* __restrict__ res, int P, int Cin,
                       int C0, int Co, int enc, int has_skip) {
  extern __shared__ float xs_all[];
  const int warp = threadIdx.x >> 5;
  const int p = blockIdx.x * PRO_WARPS + warp;
  if (p >= P) return;  // whole warps leave; only __syncwarp below
  prologue_group<float>(x, wsk, t0, res, xs_all + warp * Cin, p, 1, Cin, C0, Co, enc, has_skip);
}

// Gated causal 3x3 conv over (this frame, ring frame t-2, ring frame t-1).
constexpr int TS = 8;          // 8x8 pixel tile
constexpr int HALO = TS + 2;   // with the 1-pixel halo
constexpr int CO_T = 32;       // output channels per block
constexpr int KC = 16;         // input channels staged at a time
constexpr int CNT = 128;       // threads: 16 pixel groups x 8 channel groups

// Adds one input frame's 3x3 conv over all C input channels into part.
__device__ __forceinline__ void conv_frame(const float* __restrict__ src,
                                           const float* __restrict__ wsrc,
                                           float (*s_in)[KC + 1], float (*s_w)[KC][CO_T],
                                           float part[4][4], int H, int W, int C, int Co,
                                           int ty0, int tx0, int co0, int pg, int cg) {
  const int tid = threadIdx.x;
  for (int c0 = 0; c0 < C; c0 += KC) {
    __syncthreads();  // the previous chunk's reads are done
    for (int i = tid; i < HALO * HALO * KC; i += CNT) {
      const int hp = i / KC, ci = i % KC;
      const int y = ty0 - 1 + hp / HALO, xq = tx0 - 1 + hp % HALO, c = c0 + ci;
      float val = 0.f;  // zero spatial padding
      if (y >= 0 && y < H && xq >= 0 && xq < W && c < C) val = src[((size_t)y * W + xq) * C + c];
      s_in[hp][ci] = val;
    }
    for (int i = tid; i < 9 * KC * CO_T; i += CNT) {
      const int tap = i / (KC * CO_T), rem = i % (KC * CO_T);
      const int ci = rem / CO_T, co = rem % CO_T;
      const int c = c0 + ci, oc = co0 + co;
      s_w[tap][ci][co] = (c < C && oc < Co) ? wsrc[((size_t)tap * C + c) * Co + oc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll 4
      for (int ci = 0; ci < KC; ++ci) {
        const float4 wv = *reinterpret_cast<const float4*>(&s_w[tap][ci][cg * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int py = pg / TS + 2 * i, px = pg % TS;
          const float a = s_in[(py + dy) * HALO + px + dx][ci];
          part[i][0] += a * wv.x;
          part[i][1] += a * wv.y;
          part[i][2] += a * wv.z;
          part[i][3] += a * wv.w;
        }
      }
    }
  }
}

// LAST = false: conv0 epilogue -> t1 = mp_silu(y * cv).
// LAST = true:  conv1 epilogue -> out = clip(mp_sum(res, y, res_t)).
template <bool LAST>
__global__ void __launch_bounds__(CNT)
decode_conv_kernel(const float* __restrict__ cur, const float* __restrict__ ring,
                   const float* __restrict__ w2, const float* __restrict__ w3,
                   const float* __restrict__ gates, int gate_idx, const float* __restrict__ cv,
                   const float* __restrict__ res, float* __restrict__ out, int H, int W, int C,
                   int Co, int with_ctx, float res_t, float res_s, float clip, int has_clip) {
  __shared__ float s_in[HALO * HALO][KC + 1];
  __shared__ __align__(16) float s_w[9][KC][CO_T];
  const int tiles_x = (W + TS - 1) / TS;
  const int ty0 = (blockIdx.x / tiles_x) * TS, tx0 = (blockIdx.x % tiles_x) * TS;
  const int co0 = blockIdx.y * CO_T;
  const int b = blockIdx.z;
  const int cg = threadIdx.x & 7;   // output channels co0 + 4*cg .. +3
  const int pg = threadIdx.x >> 3;  // pixels pg + 16*i of the tile

  float a2d[4][4], actx[4][4], part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a2d[i][j] = actx[i][j] = 0.f;

  const size_t frame = (size_t)H * W * C;
  conv_frame(cur + b * frame, w2, s_in, s_w, a2d, H, W, C, Co, ty0, tx0, co0, pg, cg);
  if (with_ctx) {
    for (int f = 0; f < 2; ++f) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
      conv_frame(ring + ((size_t)b * 2 + f) * frame, w3 + (size_t)f * 9 * C * Co, s_in, s_w,
                 part, H, W, C, Co, ty0, tx0, co0, pg, cg);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) actx[i][j] += part[i][j];
    }
  }

  const float g = gates[b * 2 + gate_idx];
  const float gs = rsqrtf((1.f - g) * (1.f - g) + g * g);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int y = ty0 + pg / TS + 2 * i, xq = tx0 + pg % TS;
    if (y >= H || xq >= W) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int oc = co0 + cg * 4 + j;
      if (oc >= Co) continue;
      float yv = a2d[i][j];
      if (with_ctx) yv = (yv + (actx[i][j] - yv) * g) * gs;
      const size_t idx = (((size_t)b * H + y) * W + xq) * Co + oc;
      if (!LAST) {
        out[idx] = mp_silu(yv * cv[(size_t)b * Co + oc]);
      } else {
        const float r = res[idx];
        float val = (r + (yv - r) * res_t) * res_s;
        if (has_clip) val = fminf(fmaxf(val, -clip), clip);
        out[idx] = val;
      }
    }
  }
}

cudaError_t run_simt(const void* x, const void* a0, const void* a1, const void* wsk,
                     const void* w20, const void* w30, const void* w21, const void* w31,
                     const void* cv, const float* gates, void* y, void* t0, void* t1, float* res,
                     int B, int H, int W, int Cin, int C0, int Co, int enc, int has_skip,
                     int with_ctx, float res_t, float clip, int has_clip, cudaStream_t s) {
  using F = const float*;
  const int P = B * H * W;
  const size_t pro_smem = sizeof(float) * (size_t)PRO_WARPS * Cin;
  decode_prologue_kernel<<<(P + PRO_WARPS - 1) / PRO_WARPS, PRO_WARPS * 32, pro_smem, s>>>(
      F(x), F(wsk), static_cast<float*>(t0), res, P, Cin, C0, Co, enc, has_skip);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const float res_s = 1.f / sqrtf((1.f - res_t) * (1.f - res_t) + res_t * res_t);
  dim3 grid(((H + TS - 1) / TS) * ((W + TS - 1) / TS), (Co + CO_T - 1) / CO_T, B);
  decode_conv_kernel<false><<<grid, CNT, 0, s>>>(
      F(t0), F(a0), F(w20), F(w30), gates, 0, F(cv), nullptr, static_cast<float*>(t1), H, W,
      C0, Co, with_ctx, res_t, res_s, clip, has_clip);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  decode_conv_kernel<true><<<grid, CNT, 0, s>>>(
      F(t1), F(a1), F(w21), F(w31), gates, 1, nullptr, res, static_cast<float*>(y), H, W, Co,
      Co, with_ctx, res_t, res_s, clip, has_clip);
  return cudaGetLastError();
}

// ===========================================================================
// bf16: tensor cores (mma.sync m16n8k16), three launches.
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int NTH = 128;           // threads: 4 warps, 2 (pixels) x 2 (channels)
constexpr int NCO = 32;            // output channels of a block (N)
constexpr int KCH = 16;            // input channels of a stage (one k16 step a tap)
constexpr int NSTAGE = 4;          // cp.async ring
constexpr int HP = 100;            // pixels of the 10x10 halo
constexpr int WROW = NCO + 8;      // elements of a weight row: 80 bytes
constexpr int HALO_BYTES = 2 * HP * 16;
constexpr int W_BYTES = 9 * KCH * WROW * 2;
constexpr int STAGE_BYTES = HALO_BYTES + W_BYTES;
constexpr int SMEM = NSTAGE * STAGE_BYTES;  // 58,880 bytes: three blocks an SM
constexpr int MAX_SPLIT = 8;       // portable cluster size
constexpr int TARGET_BLOCKS = 264; // two blocks on each of the 132 SMs
constexpr int MIN_CHUNKS = 4;      // of a split rank
static_assert(SMEM >= 4 * MAX_CIN * 4 * 3, "the prologue's 4 warps x 3 pixels x MAX_CIN floats");
static_assert(4 * 4 * NTH * 4 <= SMEM, "the partial tiles of a cluster reduction");

// One convolution summed into an output tile: nf frames of (B, nf, H, W, C)
// against weights (nf, 3, 3, C, Co).
struct Job {
  const bf16* src;
  const bf16* w;
  int C;
  int nf;
  int vec;  // 16-byte copies: C and Co multiples of 8, src and w 16-byte aligned
};

struct Args {
  const bf16* x;
  const bf16* wsk;
  const bf16* cv;
  const float* gates;
  bf16* t0;
  bf16* t1;
  bf16* y;
  float* res;  // (B, H, W, Co) fp32 residual
  float* ctx;  // (2, B, H, W, Co) fp32 ctx0, ctx1
  int B, H, W, Cin, C0, Co;
  int enc, has_skip, with_ctx, has_clip;
  float res_t, res_s, clip;
  int tiles_x, tiles, nco;  // 8x8 tiles a row and a frame; output-channel tiles
  Job job[2];
  int conv_rows;            // grid rows of conv blocks: jobs * B * tiles * nco (jobs: the
                            // launch's convolutions, 0 or 2 in launch 1, else 1)
  int pro_rows;             // grid rows of prologue blocks after them (launch 1)
  int pro_ppw;              // prologue pixels a warp takes at once
  int split;                // cluster size: blocks that share an output tile's reduction
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 fp32.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The first min(n, 8) bf16 values at g, then zeros, as 16 bytes (the
// copies of a stage whose channels are no multiple of 8, or unaligned).
__device__ __forceinline__ uint4 gather8(const bf16* g, int n) {
  const uint16_t* h = reinterpret_cast<const uint16_t*>(g);
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < n) v[e >> 1] |= (uint32_t)h[e] << (16 * (e & 1));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// A thread's share of the copies that fill a stage, worked out once a block
// (the addresses of a chunk differ only by its frame and its first
// channel): up to 2 of the 200 16-byte pieces of the 10x10 halo (2 planes
// of 8 channels x 100 pixels of the 8x8 tile at (ty0, tx0), zeros outside
// the frame: the conv's zero padding) and up to 5 of the 576 pieces of the
// 9 x 16 x 32 weight slab of output channels co0 ..
struct CopyPlan {
  long long h_off[2];  // halo: element offset in the frame (pixel, channel 8 plane), -1: none
  int h_plane[2];
  int w_off[5];        // weights: element offset (tap, k, co) in a frame's (3, 3, C, Co), -1: none
  int w_k[5];
  int w_n[5];          // output channels of the piece that exist (8 or fewer)
  uint32_t h_dst[2];   // stage offsets; halo pieces past 200 and weight pieces past 576
  uint32_t w_dst[5];   // are not this thread's (h_dst >= HALO_BYTES, w_dst = ~0)

  __device__ void init(int H, int W, int C, int Co, int ty0, int tx0, int co0) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int i = threadIdx.x + m * NTH, plane = i / HP, hp = i - plane * HP;
      const int gy = ty0 - 1 + hp / 10, gx = tx0 - 1 + hp % 10;
      const bool in = i < 2 * HP && gy >= 0 && gy < H && gx >= 0 && gx < W;
      h_off[m] = in ? ((long long)gy * W + gx) * C + 8 * plane : -1;
      h_plane[m] = plane;
      h_dst[m] = (uint32_t)i * 16;
    }
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      const int i = threadIdx.x + m * NTH, q = i & 3, row = i >> 2;  // row = tap * 16 + k
      const int tap = row / KCH, k = row - tap * KCH, co = co0 + 8 * q;
      const bool in = i < 9 * KCH * (NCO / 8) && co < Co;
      w_off[m] = in ? (tap * C + k) * Co + co : -1;
      w_k[m] = k;
      w_n[m] = Co - co;
      w_dst[m] = i < 9 * KCH * (NCO / 8) ? HALO_BYTES + (uint32_t)(row * WROW + 8 * q) * 2 : ~0u;
    }
  }

  // Copy chunk c0 .. c0 + 15 of input channels: frame f's pixels at src,
  // its weights at w (both offset to the frame; w also by c0 rows).
  __device__ void copy(uint8_t* stage, const bf16* src, const bf16* w, int C, int c0,
                       int vec) const {
    const uint32_t base = smem_u32(stage);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (h_dst[m] >= HALO_BYTES) continue;
      const int c = c0 + 8 * h_plane[m];
      const bool ok = h_off[m] >= 0 && c < C;
      const bf16* g = src + (ok ? h_off[m] + c0 : 0);
      if (vec) cp_async_16(base + h_dst[m], g, ok ? 16 : 0);  // 0 bytes read: 16 zeros
      else *reinterpret_cast<uint4*>(stage + h_dst[m]) = gather8(g, ok ? C - c : 0);
    }
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      if (w_dst[m] == ~0u) continue;
      const bool ok = w_off[m] >= 0 && c0 + w_k[m] < C;
      const bf16* g = w + (ok ? w_off[m] : 0);
      if (vec) cp_async_16(base + w_dst[m], g, ok ? 16 : 0);
      else *reinterpret_cast<uint4*>(stage + w_dst[m]) = gather8(g, ok ? w_n[m] : 0);
    }
  }
};

// acc += the stage's 9 taps x 16 channels for the warp's 32 pixels (tile
// rows 4 wm .. 4 wm + 3, two m16 tiles) and 16 output channels (16 wn ..,
// two n8 tiles).
__device__ __forceinline__ void mma_stage(const uint8_t* stage, float (&acc)[2][2][4], int wm,
                                          int wn) {
  const int lane = threadIdx.x & 31;
  const uint32_t halo = smem_u32(stage), wts = halo + HALO_BYTES;
  // ldmatrix rows: A matrices (pixel rows 0-7 | 8-15) x (channels 0-7 | 8-15);
  // B matrices (channels 0-7 | 8-15) x (outputs 0-7 | 8-15), transposed
  const int a_row = (lane >> 3) & 1, a_plane = lane >> 4, a_px = lane & 7;
  const int b_k = (lane & 7) + 8 * ((lane >> 3) & 1), b_n = 16 * wn + 8 * (lane >> 4);
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    uint32_t af[2][4], bfr[4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int hpix = (4 * wm + 2 * mi + a_row + dy) * 10 + a_px + dx;
      ldsm_x4(af[mi], halo + (uint32_t)(a_plane * HP + hpix) * 16);
    }
    ldsm_x4_t(bfr, wts + (uint32_t)((tap * KCH + b_k) * WROW + b_n) * 2);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      mma16816(acc[mi][0], af[mi], bfr[0], bfr[1]);
      mma16816(acc[mi][1], af[mi], bfr[2], bfr[3]);
    }
  }
}

// STEP 0: the prologue and the context convs (fp32 into ctx); 1: conv0,
// then t1 = mp_silu(blend(y, ctx0) * cv); 2: conv1, then y = clip(mp_sum(res,
// blend(y, ctx1), res_t)). Grid (split, conv_rows + pro_rows), clusters of
// split blocks along x.
template <int STEP>
__global__ void __launch_bounds__(NTH) decode_block_tc(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int row = blockIdx.y;
  if (STEP == 0 && row >= a.conv_rows) {
    const int P = a.B * a.H * a.W, ppw = a.pro_ppw;
    const int stride = a.pro_rows * a.split * 4 * ppw;
    float* xs = reinterpret_cast<float*>(smem) + warp * ppw * a.Cin;
    for (int p = (((row - a.conv_rows) * a.split + blockIdx.x) * 4 + warp) * ppw; p < P;
         p += stride)
      prologue_group<bf16>(a.x, a.wsk, a.t0, a.res, xs, p, min(ppw, P - p), a.Cin, a.C0, a.Co,
                           a.enc, a.has_skip);
    return;
  }
  const int B = a.B, H = a.H, W = a.W, Co = a.Co, split = a.split;
  const int tiles = a.tiles, nco = a.nco;
  const int per_job = B * tiles * nco;
  const int j = row / per_job;
  row -= j * per_job;
  const int b = row / (tiles * nco);
  row -= b * tiles * nco;
  const int tile = row / nco, co0 = (row - tile * nco) * NCO;
  const int ty0 = (tile / a.tiles_x) * 8, tx0 = (tile % a.tiles_x) * 8;
  const bf16* const src = a.job[j].src;
  const bf16* const wts = a.job[j].w;
  const int C = a.job[j].C, nf = a.job[j].nf, vec = a.job[j].vec;
  const int nc = (C + KCH - 1) / KCH, U = nf * nc;
  const int rank = blockIdx.x;  // the cluster spans x: rank = blockIdx.x
  const int u0 = rank * U / split, n = (rank + 1) * U / split - u0;
  const int wm = warp & 1, wn = warp >> 1;  // the warp's pixel rows and output channels
  const size_t frame = (size_t)H * W * C, wframe = (size_t)9 * C * Co;

  CopyPlan plan;
  plan.init(H, W, C, Co, ty0, tx0, co0);
  auto load = [&](int s, int u) {
    const int f = u / nc, c0 = (u - f * nc) * KCH;
    plan.copy(smem + s * STAGE_BYTES, src + (size_t)(b * nf + f) * frame,
              wts + f * wframe + (size_t)c0 * Co, C, c0, vec);
  };

  // The epilogue's elements: accumulator element 2 h + e of m16 tile mi, n8
  // tile ni sits at tile row 4 wm + 2 mi + h, column lane / 4, output
  // channel co0 + 16 wn + 8 ni + 2 (lane % 4) + e. Its inputs (the context
  // sums, the residual, cv) are read before the reduction, so their
  // latency hides behind it (by the leader only, under a split).
  const size_t hw = (size_t)H * W, plane = (size_t)B * hw * Co;
  size_t idx[2][2];
  bool row_ok[2][2], col_ok[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int py = ty0 + 4 * wm + 2 * mi + h, px = tx0 + (lane >> 2);
      row_ok[mi][h] = py < H && px < W;
      idx[mi][h] = ((size_t)b * hw + (size_t)py * W + px) * Co;
    }
  int cols[2][2];
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      cols[ni][e] = co0 + 16 * wn + 8 * ni + 2 * (lane & 3) + e;
      col_ok[ni][e] = cols[ni][e] < Co;
    }
  const bool lead = rank == 0;
  const float* __restrict__ ctx = a.ctx + (STEP > 0 ? STEP - 1 : 0) * plane;
  const float* __restrict__ res = a.res;
  const int with_ctx = a.with_ctx;
  float side[2][2][2][2], rsd[2][2][2][2], cvf[2][2];
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      cvf[ni][e] = STEP == 1 && lead && col_ok[ni][e]
                       ? __bfloat162float(a.cv[(size_t)b * Co + cols[ni][e]]) : 0.f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = row_ok[mi][h] && col_ok[ni][e];
          const size_t k = idx[mi][h] + cols[ni][e];
          side[mi][h][ni][e] = STEP > 0 && ok && lead && with_ctx ? ctx[k] : 0.f;
          rsd[mi][h][ni][e] = STEP == 2 && ok && lead ? res[k] : 0.f;
        }
  float acc[2][2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < n) load(s, u0 + s);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // stage i has landed; every warp is done with stage i - 1
    const int nx = i + NSTAGE - 1;
    if (nx < n) load(nx % NSTAGE, u0 + nx);
    cp_async_commit();
    mma_stage(smem + (i % NSTAGE) * STAGE_BYTES, acc, wm, wn);
  }
  cp_async_wait<0>();

  if (split > 1) {
    // The ranks' partial tiles, summed by the leader in rank order.
    cg::cluster_group cluster = cg::this_cluster();
    __syncthreads();  // every warp is done with the stages
    float4* part = reinterpret_cast<float4*>(smem);
    if (rank != 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        part[q * NTH + threadIdx.x] = make_float4(acc[q >> 1][q & 1][0], acc[q >> 1][q & 1][1],
                                                  acc[q >> 1][q & 1][2], acc[q >> 1][q & 1][3]);
    }
    cluster.sync();
    if (rank == 0) {
      for (int r = 1; r < split; ++r) {
        const float4* rp = cluster.map_shared_rank(part, r);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 v = rp[q * NTH + threadIdx.x];
          float* d = acc[q >> 1][q & 1];
          d[0] += v.x;
          d[1] += v.y;
          d[2] += v.z;
          d[3] += v.w;
        }
      }
    }
    cluster.sync();  // the partners' shared memory stays until the leader has read it
    if (rank != 0) return;
  }

  if (STEP == 0) {
    float* __restrict__ out_ctx = a.ctx + j * plane;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (row_ok[mi][h] && col_ok[ni][e])
              out_ctx[idx[mi][h] + cols[ni][e]] = acc[mi][ni][2 * h + e];
    return;
  }
  const float g = a.gates[b * 2 + STEP - 1];
  const float gs = rsqrtf((1.f - g) * (1.f - g) + g * g);
  const float res_t = a.res_t, res_s = a.res_s, clip = a.clip;
  const int has_clip = a.has_clip;
  bf16* __restrict__ out = STEP == 1 ? a.t1 : a.y;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (!(row_ok[mi][h] && col_ok[ni][e])) continue;
          float yv = acc[mi][ni][2 * h + e];
          if (with_ctx) yv = (yv + (side[mi][h][ni][e] - yv) * g) * gs;
          float val;
          if (STEP == 1) {
            val = mp_silu(yv * cvf[ni][e]);
          } else {
            const float rv = rsd[mi][h][ni][e];
            val = (rv + (yv - rv) * res_t) * res_s;
            if (has_clip) val = fminf(fmaxf(val, -clip), clip);
          }
          out[idx[mi][h] + cols[ni][e]] = __float2bfloat16(val);
        }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

Job make_job(const void* src, const void* w, int C, int Co, int nf) {
  return Job{static_cast<const bf16*>(src), static_cast<const bf16*>(w), C, nf,
             (int)(C % 8 == 0 && Co % 8 == 0 && aligned16(src) && aligned16(w))};
}

// Blocks that share one output tile's reduction: enough for about
// TARGET_BLOCKS blocks a launch, at least MIN_CHUNKS chunks a block of the
// longest reduction.
int choose_split(int rows, int chunks) {
  int s = TARGET_BLOCKS / (rows > 0 ? rows : 1);
  s = s < chunks / MIN_CHUNKS ? s : chunks / MIN_CHUNKS;
  s = s < MAX_SPLIT ? s : MAX_SPLIT;
  return s > 1 ? s : 1;
}

template <int STEP>
cudaError_t launch(Args a, int n_jobs, cudaStream_t s) {
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(decode_block_tc<STEP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  a.conv_rows = n_jobs * a.B * a.tiles * a.nco;
  int chunks = 0;  // of the longest reduction (a rank of a shorter one may get none)
  for (int j = 0; j < n_jobs; ++j) {
    const int u = a.job[j].nf * ((a.job[j].C + KCH - 1) / KCH);
    chunks = u > chunks ? u : chunks;
  }
  a.split = n_jobs ? choose_split(a.conv_rows, chunks) : 1;
  const int P = a.B * a.H * a.W;
  a.pro_ppw = SMEM / (4 * 4 * a.Cin) < PRO_PIX ? SMEM / (4 * 4 * a.Cin) : PRO_PIX;
  const int pro_block = a.split * 4 * a.pro_ppw;  // pixels a grid row of prologue blocks takes
  a.pro_rows = STEP == 0 ? (P + pro_block - 1) / pro_block : 0;
  const int rows = a.conv_rows + a.pro_rows;
  if (rows > 65535) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.split, rows, 1);
  cfg.blockDim = dim3(NTH, 1, 1);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, decode_block_tc<STEP>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace tc

cudaError_t run_tc(const void* x, const void* a0, const void* a1, const void* wsk,
                   const void* w20, const void* w30, const void* w21, const void* w31,
                   const void* cv, const float* gates, void* y, void* t0, void* t1, float* res,
                   float* ctx, int B, int H, int W, int Cin, int C0, int Co, int enc,
                   int has_skip, int with_ctx, float res_t, float clip, int has_clip,
                   cudaStream_t s) {
  using tc::bf16;
  tc::Args a = {};
  a.x = static_cast<const bf16*>(x);
  a.wsk = static_cast<const bf16*>(wsk);
  a.cv = static_cast<const bf16*>(cv);
  a.gates = gates;
  a.t0 = static_cast<bf16*>(t0);
  a.t1 = static_cast<bf16*>(t1);
  a.y = static_cast<bf16*>(y);
  a.res = res;
  a.ctx = ctx;
  a.B = B, a.H = H, a.W = W, a.Cin = Cin, a.C0 = C0, a.Co = Co;
  a.enc = enc, a.has_skip = has_skip, a.with_ctx = with_ctx, a.has_clip = has_clip;
  a.res_t = res_t;
  a.res_s = 1.f / sqrtf((1.f - res_t) * (1.f - res_t) + res_t * res_t);
  a.clip = clip;
  a.tiles_x = (W + 7) / 8;
  a.tiles = a.tiles_x * ((H + 7) / 8);
  a.nco = (Co + tc::NCO - 1) / tc::NCO;
  if (with_ctx) {
    a.job[0] = tc::make_job(a0, w30, C0, Co, 2);
    a.job[1] = tc::make_job(a1, w31, Co, Co, 2);
  }
  cudaError_t e = tc::launch<0>(a, with_ctx ? 2 : 0, s);
  if (e != cudaSuccess) return e;
  a.job[0] = tc::make_job(t0, w20, C0, Co, 1);
  e = tc::launch<1>(a, 1, s);
  if (e != cudaSuccess) return e;
  a.job[0] = tc::make_job(t1, w21, Co, Co, 1);
  return tc::launch<2>(a, 1, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (SIMT kernels), 1 = bfloat16 (tensor cores). Pointers
// a0, a1, w30, w31 may be null when with_ctx = 0, wsk when has_skip = 0.
// res is fp32 scratch (B,H,W,Co); ctx fp32 scratch (2,B,H,W,Co), used by
// bf16 with_ctx only (null otherwise). Returns a cudaError_t code (0 =
// success).
int ad_decode_block(const void* x, const void* a0, const void* a1, const void* wsk,
                    const void* w20, const void* w30, const void* w21, const void* w31,
                    const void* cv, const float* gates, void* y, void* t0, void* t1,
                    float* res, float* ctx, int B, int H, int W, int Cin, int C0, int Co,
                    int enc, int has_skip, int with_ctx, float res_t, float clip, int has_clip,
                    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || C0 <= 0 || Co <= 0 || Cin > MAX_CIN)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)run_simt(x, a0, a1, wsk, w20, w30, w21, w31, cv, gates, y, t0, t1, res, B, H,
                         W, Cin, C0, Co, enc, has_skip, with_ctx, res_t, clip, has_clip, s);
  if (dtype == 1) {
    if (with_ctx && ctx == nullptr) return (int)cudaErrorInvalidValue;
    return (int)run_tc(x, a0, a1, wsk, w20, w30, w21, w31, cv, gates, y, t0, t1, res, ctx, B,
                       H, W, Cin, C0, Co, enc, has_skip, with_ctx, res_t, clip, has_clip, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* ad_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
