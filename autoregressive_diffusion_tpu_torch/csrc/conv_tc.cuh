// The bf16 tensor-core pieces of the train-mode fused gated conv
// (fused_conv_fwd.cu, fused_conv_bwd.cu): the elementwise prologues that
// make every product a plain 3x3 convolution over aligned bf16 buffers, the
// weight packing, and the implicit-GEMM tile on mma.sync fed by cp.async.
//
// Buffers (all channels-last, bf16, channel counts padded to 16 with zeros):
//   abuf (B, Fb, H, W, Cp), Fb = F + nones: the transformed activations
//        a = round(mp_silu(x * cvec)), after `nones` ones frames (2 with the
//        context branch, else 0). Buffer frame t of a batch row is then
//        h[t] = [ones, ones, a_clean[0], ...][t], and a[f] is frame f + nones.
//   dy2d (B, F, H, W, Cop), dctx (B, T, H, W, Cop): the gated output
//        gradients of the backward pass, rounded to bf16 (a rounding the
//        fp32 path does not have: there they are formed in fp32 inside the
//        tile loop).
//   packed weights (nk, 9, Kp, Np): weight k of a call, padded with zeros to
//        Kp input channels (a multiple of 16) and Np outputs (a multiple of
//        the block's output tile); for the transposed convolution of dx the
//        taps are flipped and the channel axes swapped.
//
// The tile is decode_block.cu's bf16 tile, widened: M = the 64 pixels of an
// 8x8 tile, N = NCO (32 or 64) output channels, K = (source frame, 16-channel
// chunk, 9 taps). A stage holds the chunk's 10x10 halo as [2 planes of 8
// channels][100 pixels][8 channels], so tap (dy, dx) only moves where
// ldmatrix reads the 8 pixels of a tile row (128 contiguous bytes, no bank
// conflicts), and the weights as [9 taps][16 channels][NCO + 8 pad outputs]
// (80- or 144-byte rows: ldmatrix.trans without conflicts). Four warps hold
// 32 pixels x NCO/2 outputs each. A block runs CONV_MT = 2 batch rows (sub-
// blocks of four warps) at the same tile and frame, which share every
// weight stage: the weights are most of a stage's bytes (20.7 of 23.9 KB
// at NCO = 64). cp.async fills a ring of NSTAGE stages.
// Why mma.sync and not wgmma (the design's stated fallback; wgmma was not
// tried): the forward, dx and dw products all read this one halo layout,
// and with ldmatrix (.trans for dw) every tap is only an address at any M
// split. A wgmma operand in shared memory would need no-swizzle
// descriptors over the halo's two strides (160-byte rows, 1600-byte
// planes) for each of the 9 taps, K-major for the forward and MN-major for
// dw, and a proxy fence after every cp.async stage; this port has no
// compiler off the card, and the mma.sync tile was proven on this layout
// by decode_block.cu. The kernels run at 15-17% of the bf16 bound on the
// H100 (PERF.md section 6); a wgmma tile is the next step for them.
#pragma once
#include "conv_tile.cuh"

namespace adconv {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int NTH = 128;                 // threads: 4 warps
constexpr int KCH = 16;                  // input channels of a stage (one k16 step a tap)
constexpr int NSTAGE = 4;                // cp.async ring
constexpr int HP = 100;                  // pixels of the 10x10 halo
constexpr int HALO_BYTES = 2 * HP * 16;  // 16 channels of the halo

constexpr int CONV_MT = 2;                // batch rows (sub-blocks) of a forward / dx block

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Output channels of a block for N outputs: 64 when more than 32, else 32.
__host__ __device__ constexpr int nco_for(int n) { return n > 32 ? 64 : 32; }

// The forward / dx tile: MT sub-blocks (batch rows) of 4 warps each share
// every weight stage, so a stage's weights serve MT times the products.
template <int NCO, int MT>
struct ConvCfg {
  static constexpr int NT = NTH * MT;                   // threads
  static constexpr int WROW = NCO + 8;                  // elements of a staged weight row
  static constexpr int W_BYTES = 9 * KCH * WROW * 2;
  static constexpr int HALOS = MT * HALO_BYTES;         // the sub-blocks' halos, then the weights
  static constexpr int STAGE = HALOS + W_BYTES;
  static constexpr int SMEM = NSTAGE * STAGE;
  static constexpr int NI = NCO / 16;                   // n8 tiles of a warp
  static constexpr int W_PIECES = 9 * KCH * (NCO / 8);  // 16-byte copies of the weight slab
  static constexpr int W_PT = (W_PIECES + NT - 1) / NT;
  static constexpr int H_PT = (2 * HP * MT + NT - 1) / NT;
};

template <int NCO>
struct DwCfg {  // the weight-gradient tile: 32 input channels x NCO outputs x 9 taps
  static constexpr int A_BYTES = 4 * HP * 16;  // 32 channels of the halo
  static constexpr int BROW = NCO + 8;         // elements of a staged gradient row
  static constexpr int B_BYTES = 64 * BROW * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int SMEM = NSTAGE * STAGE;  // 46,080 (32) or 62,464 (64) bytes
  static constexpr int NJ = NCO / 16;          // n8 tiles of a warp
  static constexpr int B_PT = 64 * (NCO / 8) / NTH;
};

// ---- PTX: cp.async, ldmatrix, mma.sync

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared; bytes = 0 reads nothing and writes zeros
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

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---- prologues (one thread: 8 channels of one pixel, one 16-byte store)

// 8 bf16 (the first in the low half of u.x) as fp32: a bf16 is the high
// half of its fp32 value
__device__ __forceinline__ void unpack8(uint4 u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
}

// Channels c0 .. c0 + 7 of a pixel row p of n channels, zeros past n: one
// 16-byte load where vec (n a multiple of 8, p 16-byte aligned).
__device__ __forceinline__ void load8(const bf16* p, int c0, int n, int vec, float (&v)[8]) {
  if (vec) {
    if (c0 < n) {
      unpack8(*reinterpret_cast<const uint4*>(p + c0), v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = c0 + e < n ? to_f(p[c0 + e]) : 0.f;
}

// Whether every pointer is 16-byte aligned and n a multiple of 8 (null pointers pass).
inline int vec8(int n, const void* a, const void* b = nullptr, const void* c = nullptr) {
  auto al = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  return n % 8 == 0 && al(a) && al(b) && al(c);
}

// abuf: n8 = Cp / 8 groups a pixel, HW pixels a frame, Fb frames a batch row
// (the host keeps B * Fb * HW * n8 below 2^31).
__device__ __forceinline__ void act_prologue(const bf16* __restrict__ x,
                                             const bf16* __restrict__ cvec, bf16* __restrict__ abuf,
                                             int B, int F, int HW, int C, int Cp, int nones,
                                             int silu, int vec) {
  const int n8 = Cp / 8, Fb = F + nones, total = B * Fb * HW * n8;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int g = i % n8, pf = i / n8;  // pf = (b * Fb + fb) * HW + pixel
    const int pix = pf % HW, bf = pf / HW, b = bf / Fb, fb = bf - b * Fb;
    float v[8];
    if (fb < nones) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 8 * g + e < C ? 1.f : 0.f;
    } else {
      const long long f = (long long)b * F + (fb - nones);
      load8(x + (f * HW + pix) * C, 8 * g, C, vec, v);
      if (cvec != nullptr) {
        float cv[8];
        load8(cvec + f * C, 8 * g, C, vec, cv);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] *= cv[e];
      }
      if (silu) {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = mp_silu(v[e]);  // mp_silu(0) = 0: padding stays 0
      }
    }
    *reinterpret_cast<uint4*>(abuf + (size_t)i * 8) = pack8(v);
  }
}

// Packed weights of nk slots: wp[k][tap][kk][n], kk < Kp, n < Np (fewer
// than 2^31 elements). transpose = 0: w_k[tap][kk][n] over (Cin = C,
// Cout = Co); transpose = 1: w_k[8 - tap][n][kk] (the dx convolution: kk
// runs over Co, n over C). Slot k is w2 (k = 0) or w3[k - 1].
__device__ __forceinline__ void pack_weights(const bf16* __restrict__ w2,
                                             const bf16* __restrict__ w3, bf16* __restrict__ wp,
                                             int nk, int C, int Co, int Kp, int Np,
                                             int transpose) {
  const int total = nk * 9 * Kp * Np;
  const size_t per = (size_t)9 * C * Co;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int n = i % Np, r = i / Np;
    const int kk = r % Kp, tk = r / Kp, tap = tk % 9, k = tk / 9;
    const bf16* w = k == 0 ? w2 : w3 + (size_t)(k - 1) * per;
    bf16 v = __float2bfloat16(0.f);
    if (!transpose && kk < C && n < Co) v = w[(tap * C + kk) * Co + n];
    if (transpose && kk < Co && n < C) v = w[((8 - tap) * C + n) * Co + kk];
    wp[i] = v;
  }
}

// ---- the forward / dx tile

// One source of a block's reduction: a (H, W, Cs) frame of a padded buffer
// (sub-block 0's; sub-block k's is `stride` elements further) against
// packed weight slot `w` (offset to the block's outputs), summed into
// accumulator `acc` (0-2).
struct Term {
  const bf16* src;
  const bf16* w;
  int acc;
  long long stride;
};

// A thread's share of the copies that fill a stage, worked out once a
// block: up to H_PT of the MT x 200 16-byte pieces of the sub-blocks' 10x10
// halos (zeros outside the frame: the conv's zero padding) and up to W_PT
// pieces of the 9 x 16 x NCO weight slab.
template <int NCO, int MT>
struct ConvPlan {
  using Cf = ConvCfg<NCO, MT>;
  long long h_off[Cf::H_PT];  // element offset in a frame (pixel, 8-channel plane); -1: outside
  int h_sb[Cf::H_PT];         // the piece's sub-block
  uint32_t h_dst[Cf::H_PT];   // >= HALOS: not this thread's
  int w_off[Cf::W_PT];        // element offset in a slot's (9, Cs, Np) slab at chunk 0
  uint32_t w_dst[Cf::W_PT];   // ~0u: not this thread's

  // Cs: channels of a source pixel, which are the packed weights' input rows
  __device__ void init(int H, int W, int Cs, int Np, int ty0, int tx0) {
#pragma unroll
    for (int m = 0; m < Cf::H_PT; ++m) {
      const int i = threadIdx.x + m * Cf::NT, sb = i / (2 * HP), j = i - sb * 2 * HP;
      const int plane = j / HP, hp = j - plane * HP;
      const int gy = ty0 - 1 + hp / 10, gx = tx0 - 1 + hp % 10;
      const bool in = i < 2 * HP * MT && gy >= 0 && gy < H && gx >= 0 && gx < W;
      h_off[m] = in ? ((long long)gy * W + gx) * Cs + 8 * plane : -1;
      h_sb[m] = sb;
      h_dst[m] = (uint32_t)i * 16;
    }
#pragma unroll
    for (int m = 0; m < Cf::W_PT; ++m) {
      const int i = threadIdx.x + m * Cf::NT, q = i % (NCO / 8), row = i / (NCO / 8);
      const int tap = row / KCH, k = row - tap * KCH;  // row = tap * 16 + k
      const bool mine = i < Cf::W_PIECES;
      w_off[m] = mine ? (tap * Cs + k) * Np + 8 * q : 0;
      w_dst[m] = mine ? Cf::HALOS + (uint32_t)(row * Cf::WROW + 8 * q) * 2 : ~0u;
    }
  }

  // chunk c0 of term t for the first n_sb sub-blocks (the others read zeros)
  __device__ void copy(uint8_t* stage, const Term& t, int Np, int c0, int n_sb) const {
    const uint32_t base = smem_u32(stage);
#pragma unroll
    for (int m = 0; m < Cf::H_PT; ++m) {
      if (h_dst[m] >= Cf::HALOS) continue;
      const bool ok = h_off[m] >= 0 && h_sb[m] < n_sb;
      cp_async_16(base + h_dst[m], ok ? t.src + h_sb[m] * t.stride + h_off[m] + c0 : t.src,
                  ok ? 16 : 0);
    }
    const bf16* wc = t.w + (size_t)c0 * Np;
#pragma unroll
    for (int m = 0; m < Cf::W_PT; ++m)
      if (w_dst[m] != ~0u) cp_async_16(base + w_dst[m], wc + w_off[m], 16);
  }
};

// acc += the stage's 9 taps x 16 channels for the warp's 32 pixels (tile
// rows 4 wm .. 4 wm + 3 of sub-block sb's tile, two m16 tiles) and NCO / 2
// outputs (NI n8 tiles).
template <int NCO, int MT>
__device__ __forceinline__ void mma_stage(const uint8_t* stage,
                                          float (&acc)[2][ConvCfg<NCO, MT>::NI][4], int wm,
                                          int wn, int sb) {
  using Cf = ConvCfg<NCO, MT>;
  const int lane = threadIdx.x & 31;
  const uint32_t halo = smem_u32(stage) + sb * HALO_BYTES, wts = smem_u32(stage) + Cf::HALOS;
  // ldmatrix rows: A matrices (pixel rows 0-7 | 8-15) x (channels 0-7 | 8-15);
  // B matrices (channels 0-7 | 8-15) x (outputs 0-7 | 8-15), transposed
  const int a_row = (lane >> 3) & 1, a_plane = lane >> 4, a_px = lane & 7;
  const int b_k = (lane & 7) + 8 * ((lane >> 3) & 1), b_n = (NCO / 2) * wn + 8 * (lane >> 4);
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    uint32_t af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int hpix = (4 * wm + 2 * mi + a_row + dy) * 10 + a_px + dx;
      ldsm_x4(af[mi], halo + (uint32_t)(a_plane * HP + hpix) * 16);
    }
#pragma unroll
    for (int j = 0; j < Cf::NI / 2; ++j) {
      uint32_t bfr[4];
      ldsm_x4_t(bfr, wts + (uint32_t)((tap * KCH + b_k) * Cf::WROW + b_n + 16 * j) * 2);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma16816(acc[mi][2 * j], af[mi], bfr[0], bfr[1]);
        mma16816(acc[mi][2 * j + 1], af[mi], bfr[2], bfr[3]);
      }
    }
  }
}

template <int NI>
__device__ __forceinline__ void zero_acc(float (&acc)[2][NI][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

// The main loop: n_terms x nc chunks through the cp.async ring, each chunk's
// products into accumulator a0 (acc 0), a1 (acc 1) or a2 (acc 2) of the
// warp's sub-block (warps 4 sb .. 4 sb + 3). NACC is the number of
// accumulators the caller holds (1 or 3).
template <int NCO, int MT, int NACC>
__device__ __forceinline__ void conv_main_loop(uint8_t* smem, const ConvPlan<NCO, MT>& plan,
                                               const Term* terms, int n_terms, int nc, int Np,
                                               int n_sb,
                                               float (&a0)[2][ConvCfg<NCO, MT>::NI][4],
                                               float (&a1)[2][ConvCfg<NCO, MT>::NI][4],
                                               float (&a2)[2][ConvCfg<NCO, MT>::NI][4]) {
  using Cf = ConvCfg<NCO, MT>;
  const int warp = threadIdx.x >> 5, sb = warp >> 2, wm = warp & 1, wn = (warp >> 1) & 1;
  const int n = n_terms * nc;
  auto load = [&](int s, int u) {
    const int t = u / nc, c0 = (u - t * nc) * KCH;
    plan.copy(smem + s * Cf::STAGE, terms[t], Np, c0, n_sb);
  };
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < n) load(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // stage i has landed; every warp is done with stage i - 1
    const int nx = i + NSTAGE - 1;
    if (nx < n) load(nx % NSTAGE, nx);
    cp_async_commit();
    const uint8_t* st = smem + (i % NSTAGE) * Cf::STAGE;
    const int which = NACC == 1 ? 0 : terms[i / nc].acc;
    if (which == 0)
      mma_stage<NCO, MT>(st, a0, wm, wn, sb);
    else if (NACC > 1 && which == 1)
      mma_stage<NCO, MT>(st, a1, wm, wn, sb);
    else if (NACC > 1)
      mma_stage<NCO, MT>(st, a2, wm, wn, sb);
  }
  cp_async_wait<0>();
}

// ---- the weight-gradient tile

// acc[tap] += the stage's halo (32 channels, shifted by the tap) transposed
// times the stage's 64 x NCO gradient tile, for the warp's 16 channels
// (16 wc ..) and NCO / 2 outputs (NJ n8 tiles); K = the tile's 64 pixels,
// four k16 steps of two tile rows each.
template <int NCO>
__device__ __forceinline__ void dw_stage(const uint8_t* stage,
                                         float (&acc)[9][DwCfg<NCO>::NJ][4], int wc, int wn) {
  using Cf = DwCfg<NCO>;
  const int lane = threadIdx.x & 31;
  const uint32_t halo = smem_u32(stage), grad = halo + Cf::A_BYTES;
  // A (channels x pixels) by ldmatrix.trans of [pixel][8 channels] rows:
  // matrices (channels 0-7 | 8-15) x (tile row 2s | 2s + 1)
  const int a_plane = 2 * wc + ((lane >> 3) & 1), a_dr = lane >> 4, a_px = lane & 7;
  // B (pixels x outputs) by ldmatrix.trans of [pixel][NCO + 8] rows
  const int b_p = (lane & 7) + 8 * ((lane >> 3) & 1), b_n = (NCO / 2) * wn + 8 * (lane >> 4);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    uint32_t bfr[Cf::NJ / 2][4];
#pragma unroll
    for (int j = 0; j < Cf::NJ / 2; ++j)
      ldsm_x4_t(bfr[j], grad + (uint32_t)((16 * s + b_p) * Cf::BROW + b_n + 16 * j) * 2);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      uint32_t af[4];
      const int hpix = (2 * s + a_dr + dy) * 10 + a_px + dx;
      ldsm_x4_t(af, halo + (uint32_t)(a_plane * HP + hpix) * 16);
#pragma unroll
      for (int j = 0; j < Cf::NJ / 2; ++j) {
        mma16816(acc[tap][2 * j], af, bfr[j][0], bfr[j][1]);
        mma16816(acc[tap][2 * j + 1], af, bfr[j][2], bfr[j][3]);
      }
    }
  }
}

}  // namespace tc
}  // namespace adconv
