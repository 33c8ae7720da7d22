// The int8 W8A8 GEGLU + causal-conv feed-forward sublayer of the DDIM
// denoiser's transformer, and the tiled GEMM it is built from. Included by
// int8_ff.cu (the FF sublayer alone, ffpipe_layer) and fused_layer.cu (a
// whole layer, whose attention half reuses the GEMM in bf16).
//
// The FF sublayer replaces the FF half of
// diffnorm_tpu/ops/pallas_block.py:_layer_kernel and all of
// diffnorm_tpu/ops/pallas_ffpipe.py:_ffpipe_kernel / _ffpipe_kernel2:
//     h  = normFiLM(x)                                  f32
//     q2 = int8(h), a2 per token
//     g  = bf16(gelu(q2 Wx * a2 * sx + bx) * (q2 Wg * a2 * sg + bg))
//     q3 = int8(g), a3 per token
//     y  = sum_i (shift_i(q3) Wc_i) * shift_i(a3) * sc_i + bc   (k = 3 taps,
//          each tap its own int32 sum: the taps' token scales differ)
//     y  = bf16(y) for fused_layer; stays f32 for ffpipe_layer
//     q4 = int8(y), a4 per token
//     out = x + bf16(q4 Wf * a4 * sf + bf)
//
// Bound on an H100: operations. At B64 x T128, C=512, P=1408 the three int8
// products are 132.9 G int8 ops, 67 us at 1979 TOP/s dense; the bytes
// (8.1 MB of int8 weights, the activation in and out) are ~3 us.
//
// Design: the TPU kernel ran one grid step per batch row with every weight
// resident in VMEM (10 MB, far past 227 KB of shared memory). Here the
// sublayer is six launches over the B*T tokens: a one-warp-per-token
// norm + quantize prologue, the proj_in GEMM with the GEGLU in its epilogue,
// a one-warp-per-token requantize, the conv GEMM (the causal shift applied
// while the A tile is loaded, zero rows before t = 0 of each sequence), a
// requantize, and the proj_out GEMM with bias and residual in its epilogue.
// The GEMMs run int8 mma.sync (m16n8k32, exact int32 sums) on fragments read
// with ldmatrix from a 3-stage cp.async ring of 128-byte K steps; each warp
// computes a 32 x 32 tile, a block (128 * rows) x 64 with 8 * rows warps.
// `rows` of ffpipe_layer is that factor: at T = 128 one block's M tile spans
// `rows` batch rows. Every output element is computed by the same arithmetic
// whatever the tile, so rows 1 and 2 agree bit for bit. Each thread's copy
// addresses are set up once per block, not per stage (PERF.md: what the
// stage depth and the tile shape did to the conv GEMM).
//
// Rounding follows the JAX kernels: scales are max|v| / 127 by division,
// floored at 1e-12; codes are round-half-even of v / scale (__fdiv_rn,
// __float2int_rn); every epilogue product and sum is rounded on its own
// (__fmul_rn / __fadd_rn), because a contracted FMA rounds once where the
// reference rounds twice and flips codes downstream. Build without
// --use_fast_math.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

namespace ff {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills instead of reading when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16 x 32 int8, row) * b (32 x 8 int8, col), exact int32 sums
__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 16 bf16, row) * b (16 x 8 bf16, col), f32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// jax.nn.gelu(approximate=True): x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3))))
__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(inner))));
}

// the per-token int8 scale: max(amax / 127, 1e-12)
__device__ __forceinline__ float act_scale(float amax) {
  return fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
}

__device__ __forceinline__ uint32_t pack4(const float (&v)[8], int j0, float a) {
  uint32_t r = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    r |= (static_cast<uint32_t>(__float2int_rn(__fdiv_rn(v[j0 + j], a))) & 0xffu) << (8 * j);
  return r;
}

// ------------------------------------------------ norm + FiLM (+ quantize)

// One warp per token: y = x * (sqrt(C) / max(||x||, 1e-12)) * gamma + beta in
// f32 (pallas_block.py:_norm_film). kQuant: write int8(y) and its per-token
// scale; else write bf16(y). film [B, 2C] f32 (gamma ++ beta), row / T
// picks the batch row. C % 8 == 0.
template <bool kQuant>
__global__ void __launch_bounds__(256)
norm_film_kernel(const bf16* __restrict__ x, const float* __restrict__ film,
                 int8_t* __restrict__ q, float* __restrict__ scale_out,
                 bf16* __restrict__ y_out, int M, int T, int C, float sqrt_c) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= M) return;
  const bf16* xr = x + static_cast<size_t>(row) * C;
  const float* gamma = film + static_cast<size_t>(row / T) * 2 * C;
  const float* beta = gamma + C;

  float ss = 0.f;
  for (int c = lane * 8; c < C; c += 256) {
    float v[8];
    load8(xr + c, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) ss = __fadd_rn(ss, __fmul_rn(v[j], v[j]));
  }
  const float inv = __fdiv_rn(sqrt_c, fmaxf(__fsqrt_rn(warp_sum(ss)), 1e-12f));

  auto film_row = [&](int c, float (&v)[8]) {
    float g[8], b[8];
    load8(xr + c, v);
    load8(gamma + c, g);
    load8(beta + c, b);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __fadd_rn(__fmul_rn(__fmul_rn(v[j], inv), g[j]), b[j]);
  };

  if (!kQuant) {
    for (int c = lane * 8; c < C; c += 256) {
      float v[8];
      film_row(c, v);
      uint4 packed;
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      *reinterpret_cast<uint4*>(y_out + static_cast<size_t>(row) * C + c) = packed;
    }
    return;
  }
  float amax = 0.f;
  for (int c = lane * 8; c < C; c += 256) {
    float v[8];
    film_row(c, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
  }
  const float a = act_scale(warp_max(amax));
  for (int c = lane * 8; c < C; c += 256) {
    float v[8];
    film_row(c, v);  // recomputed: the same f32 operations give the same y
    *reinterpret_cast<uint2*>(q + static_cast<size_t>(row) * C + c) =
        make_uint2(pack4(v, 0, a), pack4(v, 4, a));
  }
  if (lane == 0) scale_out[row] = a;
}

// One warp per token: q = int8(v), scale = max|v| / 127 over the row of P.
template <typename In>
__global__ void __launch_bounds__(256)
requant_kernel(const In* __restrict__ in, int8_t* __restrict__ q,
               float* __restrict__ scale_out, int M, int P) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= M) return;
  const In* r = in + static_cast<size_t>(row) * P;
  float amax = 0.f;
  for (int c = lane * 8; c < P; c += 256) {
    float v[8];
    load8(r + c, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
  }
  const float a = act_scale(warp_max(amax));
  for (int c = lane * 8; c < P; c += 256) {
    float v[8];
    load8(r + c, v);
    *reinterpret_cast<uint2*>(q + static_cast<size_t>(row) * P + c) =
        make_uint2(pack4(v, 0, a), pack4(v, 4, a));
  }
  if (lane == 0) scale_out[row] = a;
}

// ------------------------------------------------------------------ GEMM

// What a GEMM's epilogue does with its [M, N] tile of sums.
enum Mode {
  kGeglu = 0,      // int8; two B (x and gate halves): bf16 gelu(gate) * x
  kConv = 1,       // int8; `taps` causal taps, per-tap scales: y (+ bias)
  kOut = 2,        // int8; + bias, then + residual in bf16
  kBf16Store = 3,  // bf16; store bf16(sum)
  kBf16Resid = 4,  // bf16; residual + bf16(sum), in bf16
};

struct GemmArgs {
  const void* a;          // [M, K] int8 codes or bf16, K contiguous
  const float* a_scale;   // [M] per-token scales (int8 modes)
  const void* b0;         // [N, K] ([taps, N, K] for kConv), K contiguous
  const void* b1;         // kGeglu: the gate half [N, K]
  const float* w_scale0;  // [N] ([taps, N] for kConv)
  const float* w_scale1;  // kGeglu: gate scales [N]
  const float* bias0;     // [N]
  const float* bias1;     // kGeglu: gate bias [N]
  const bf16* resid;      // [M, N] (kOut, kBf16Resid)
  void* out;              // [M, N] bf16, or f32 for kConv without rounding
  int M, N, K, T, taps, round_bf16;
};

constexpr int BN = 64;         // output columns per block
constexpr int BKB = 128;       // bytes of K per pipeline stage
constexpr int LDS = BKB + 16;  // padded smem row (144 B): ldmatrix is conflict-free
constexpr int kStages = 3;
constexpr int kCpr = BKB / 16; // 16-byte copies per smem row
constexpr int kWarpsN = 2;     // warp tile 32 x 32: 2 x 4 mma tiles
constexpr int kMi = 2, kNi = 4;

template <int kMode>
struct ModeTraits {
  static constexpr bool kInt8 = kMode <= kOut;
  static constexpr int kNB = kMode == kGeglu ? 2 : 1;  // B matrices
  static constexpr int kElem = kInt8 ? 1 : 2;          // bytes per A/B element
};

// kRows 1: a 128 x 64 block tile, 8 warps; kRows 2: 256 x 64, 16 warps
template <int kMode, int kRows>
constexpr int gemm_smem_bytes() {
  return kStages * (128 * kRows + ModeTraits<kMode>::kNB * BN) * LDS;
}

template <int kMode, int kRows>
__global__ void __launch_bounds__(256 * kRows, kRows == 1 ? 2 : 1)  // <= 128 registers
gemm_kernel(const GemmArgs p) {
  typedef ModeTraits<kMode> Tr;
  typedef typename std::conditional<Tr::kInt8, int, float>::type Acc;
  constexpr int BM = 128 * kRows;
  constexpr int kThreads = 256 * kRows;
  constexpr int kATile = BM * LDS, kBTile = BN * LDS;
  constexpr int kStageBytes = kATile + Tr::kNB * kBTile;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int Kb = p.K * Tr::kElem;  // bytes per row, a multiple of 16
  const int nk = (Kb + BKB - 1) / BKB;
  const unsigned char* A = static_cast<const unsigned char*>(p.a);

  // live taps tap_first .. taps-1; tap i reads row t - (taps - 1 - i)
  int tap_first = 0;
  const int taps = kMode == kConv ? p.taps : 1;
  if constexpr (kMode == kConv)
    while (taps - 1 - tap_first >= p.T) ++tap_first;
  const int n_iter = nk * (taps - tap_first);

  // The thread's 16-byte copies of each stage, set up once: the smem row
  // tid / kCpr + j * kRowStep of the A and B tiles, at one column. A copy's
  // source is its row offset (M * Kb < 2^31, checked at launch) plus the
  // stage's K offset, minus the tap's shift in rows.
  constexpr int kRowStep = kThreads / kCpr;
  constexpr int kACopies = BM / kRowStep, kBCopies = BN / kRowStep;
  static_assert(kThreads % kCpr == 0 && BM % kRowStep == 0 && BN % kRowStep == 0,
                "whole rows per thread");
  const int col = (tid % kCpr) * 16;
  int a_off[kACopies], a_t[kACopies];  // row offset; t within the sequence, -1 past M
  int b_off[kBCopies];                 // row offset, -1 past N
#pragma unroll
  for (int j = 0; j < kACopies; ++j) {
    const int m = m0 + tid / kCpr + j * kRowStep;
    a_off[j] = m * Kb + col;
    a_t[j] = m < p.M ? m % p.T : -1;
  }
#pragma unroll
  for (int j = 0; j < kBCopies; ++j) {
    const int n = n0 + tid / kCpr + j * kRowStep;
    b_off[j] = n < p.N ? n * Kb + col : -1;
  }

  int ld_tap = tap_first, ld_kb = 0;  // the next stage to load
  auto load_stage = [&](int stage) {
    const int shift = kMode == kConv ? taps - 1 - ld_tap : 0;
    const bool k_ok = ld_kb + col < Kb;  // zeros past K
    unsigned char* sa = smem + stage * kStageBytes + (tid / kCpr) * LDS + col;
#pragma unroll
    for (int j = 0; j < kACopies; ++j) {
      const bool ok = k_ok && a_t[j] >= shift;
      cp_async16(sa + j * kRowStep * LDS, ok ? A + (a_off[j] - shift * Kb + ld_kb) : A, ok);
    }
#pragma unroll
    for (int nb = 0; nb < Tr::kNB; ++nb) {
      const unsigned char* B = static_cast<const unsigned char*>(nb == 0 ? p.b0 : p.b1) +
                               static_cast<size_t>(ld_tap) * p.N * Kb + ld_kb;
      unsigned char* sb = sa + kATile + nb * kBTile;
#pragma unroll
      for (int j = 0; j < kBCopies; ++j) {
        const bool ok = k_ok && b_off[j] >= 0;
        cp_async16(sb + j * kRowStep * LDS, ok ? B + b_off[j] : B, ok);
      }
    }
    ld_kb += BKB;
    if (ld_kb >= Kb) {
      ld_kb = 0;
      ++ld_tap;
    }
  };

  Acc acc[Tr::kNB][kMi][kNi][4];
  float yf[kMi][kNi][4];  // kConv: the f32 sum over taps
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        yf[mi][ni][e] = 0.f;
#pragma unroll
        for (int nb = 0; nb < Tr::kNB; ++nb) acc[nb][mi][ni][e] = 0;
      }

  const int g = lane / 4, q = lane % 4;

  // fold tap `tap`'s int32 sums into yf with its shifted token scale and its
  // tap scale, as the reference does: y + (float(acc) * a[t - shift]) * s
  auto fold_tap = [&](int tap) {
    if constexpr (kMode == kConv) {
      const int shift = taps - 1 - tap;
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = m0 + wm * 32 + mi * 16 + g + half * 8;
          // a row shifted in before t = 0 has code 0 and scale 1
          const float am = (m < p.M && m % p.T >= shift) ? p.a_scale[m - shift] : 1.f;
#pragma unroll
          for (int ni = 0; ni < kNi; ++ni) {
            const int n = n0 + wn * 32 + ni * 8 + 2 * q;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float ws =
                  n + e < p.N ? p.w_scale0[static_cast<size_t>(tap) * p.N + n + e] : 0.f;
              Acc& sum = acc[0][mi][ni][2 * half + e];
              float& y = yf[mi][ni][2 * half + e];
              y = __fadd_rn(y, __fmul_rn(__fmul_rn(__int2float_rn(sum), am), ws));
              sum = 0;
            }
          }
        }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_iter) load_stage(s);
    cp_async_commit();
  }
  int k_step = 0, tap = tap_first;  // the stage being computed
  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `it` has landed; stage it-1 is free to refill
    if (it + kStages - 1 < n_iter) load_stage((it + kStages - 1) % kStages);
    cp_async_commit();
    const unsigned char* sa = smem + (it % kStages) * kStageBytes;
#pragma unroll
    for (int ks = 0; ks < BKB / 32; ++ks) {  // 32 bytes: one mma depth
      uint32_t af[kMi][4];
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi)
        ldmatrix_x4(af[mi], sa + (wm * 32 + mi * 16 + lane % 16) * LDS + ks * 32 + (lane / 16) * 16);
#pragma unroll
      for (int nb = 0; nb < Tr::kNB; ++nb) {
        const unsigned char* sb = sa + kATile + nb * kBTile;
#pragma unroll
        for (int nj = 0; nj < kNi / 2; ++nj) {
          uint32_t bfr[4];
          ldmatrix_x4(bfr, sb + (wn * 32 + nj * 16 + lane % 8 + (lane / 16) * 8) * LDS +
                               ks * 32 + ((lane / 8) % 2) * 16);
#pragma unroll
          for (int mi = 0; mi < kMi; ++mi) {
            mma(acc[nb][mi][2 * nj], af[mi], bfr[0], bfr[1]);
            mma(acc[nb][mi][2 * nj + 1], af[mi], bfr[2], bfr[3]);
          }
        }
      }
    }
    if (++k_step == nk) {
      fold_tap(tap++);
      k_step = 0;
    }
  }
  cp_async_wait<0>();

  // epilogue: the thread holds rows g, g+8 and columns 2q, 2q+1 of each
  // 16 x 8 tile
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 32 + mi * 16 + g + half * 8;
      if (m >= p.M) continue;
      float am = 1.f;
      if constexpr (Tr::kInt8 && kMode != kConv) am = p.a_scale[m];
      const size_t row = static_cast<size_t>(m) * p.N;
#pragma unroll
      for (int ni = 0; ni < kNi; ++ni) {
        const int n = n0 + wn * 32 + ni * 8 + 2 * q;
        if (n >= p.N) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const Acc s0 = acc[0][mi][ni][2 * half + e];
          if constexpr (kMode == kGeglu) {
            const Acc s1 = acc[1][mi][ni][2 * half + e];
            const float hx = __fadd_rn(
                __fmul_rn(__fmul_rn(__int2float_rn(s0), am), p.w_scale0[n + e]), p.bias0[n + e]);
            const float hg = __fadd_rn(
                __fmul_rn(__fmul_rn(__int2float_rn(s1), am), p.w_scale1[n + e]), p.bias1[n + e]);
            v[e] = __fmul_rn(gelu_tanh(hg), hx);
          } else if constexpr (kMode == kConv) {
            v[e] = __fadd_rn(yf[mi][ni][2 * half + e], p.bias0[n + e]);
          } else if constexpr (kMode == kOut) {
            const float o = __fadd_rn(
                __fmul_rn(__fmul_rn(__int2float_rn(s0), am), p.w_scale0[n + e]), p.bias0[n + e]);
            v[e] = __fadd_rn(__bfloat162float(p.resid[row + n + e]),
                             __bfloat162float(__float2bfloat16_rn(o)));
          } else if constexpr (kMode == kBf16Resid) {
            v[e] = __fadd_rn(__bfloat162float(p.resid[row + n + e]),
                             __bfloat162float(__float2bfloat16_rn(s0)));
          } else {
            v[e] = s0;
          }
        }
        if (kMode == kConv && !p.round_bf16)
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + row + n) = make_float2(v[0], v[1]);
        else
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) + row + n) =
              __floats2bfloat162_rn(v[0], v[1]);
      }
    }
}

template <int kMode, int kRows>
cudaError_t launch_gemm(const GemmArgs& args, cudaStream_t st) {
  constexpr int bytes = gemm_smem_bytes<kMode, kRows>();
  const long long kb = static_cast<long long>(args.K) * ModeTraits<kMode>::kElem;
  if (kb % 16 != 0 || (args.M + 128LL * kRows) * kb >= (1LL << 31) ||
      (args.N + static_cast<long long>(BN)) * kb >= (1LL << 31))
    return cudaErrorInvalidValue;  // the kernel's 32-bit row offsets
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<kMode, kRows>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((args.M + 128 * kRows - 1) / (128 * kRows), (args.N + BN - 1) / BN);
  gemm_kernel<kMode, kRows><<<grid, 256 * kRows, bytes, st>>>(args);
  return cudaGetLastError();
}

// ------------------------------------------------------ the FF sublayer

struct FFWeights {
  const int8_t *wxq, *wgq, *wcq, *wfq;  // [P, C], [P, C], [3, P, P], [C, P]: [out, in]
  const float *wxs, *wgs, *wcs, *wfs;   // [P], [P], [3, P], [C]
  const float *bx, *bg, *bc, *bf;       // [P], [P], [P], [C]
};

struct FFScratch {
  int8_t* q;  // [M, max(C, P)] codes
  float* a;   // [M] per-token scales
  bf16* g;    // [M, P] GEGLU output
  void* y;    // [M, P] conv output: bf16 when round_y, else f32
};

template <int kRows>
cudaError_t launch_ff_rows(const bf16* x, const float* film, const FFWeights& w,
                           const FFScratch& s, bf16* out, int B, int T, int C, int P,
                           bool round_y, cudaStream_t st) {
  const int M = B * T;
  const dim3 warps_grid((M + 7) / 8);
  norm_film_kernel<true><<<warps_grid, 256, 0, st>>>(x, film, s.q, s.a, nullptr, M, T, C,
                                                      static_cast<float>(sqrt(static_cast<double>(C))));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  GemmArgs a = {};
  a.M = M; a.T = T; a.taps = 1;
  a.a = s.q; a.a_scale = s.a;
  a.b0 = w.wxq; a.b1 = w.wgq; a.w_scale0 = w.wxs; a.w_scale1 = w.wgs;
  a.bias0 = w.bx; a.bias1 = w.bg; a.out = s.g; a.N = P; a.K = C;
  if ((err = launch_gemm<kGeglu, kRows>(a, st)) != cudaSuccess) return err;

  requant_kernel<bf16><<<warps_grid, 256, 0, st>>>(s.g, s.q, s.a, M, P);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  GemmArgs c = {};
  c.M = M; c.T = T; c.taps = 3; c.round_bf16 = round_y;
  c.a = s.q; c.a_scale = s.a; c.b0 = w.wcq; c.w_scale0 = w.wcs; c.bias0 = w.bc;
  c.out = s.y; c.N = P; c.K = P;
  if ((err = launch_gemm<kConv, kRows>(c, st)) != cudaSuccess) return err;

  if (round_y)
    requant_kernel<bf16><<<warps_grid, 256, 0, st>>>(static_cast<const bf16*>(s.y), s.q, s.a, M, P);
  else
    requant_kernel<float><<<warps_grid, 256, 0, st>>>(static_cast<const float*>(s.y), s.q, s.a, M, P);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  GemmArgs o = {};
  o.M = M; o.T = T; o.taps = 1;
  o.a = s.q; o.a_scale = s.a; o.b0 = w.wfq; o.w_scale0 = w.wfs; o.bias0 = w.bf;
  o.resid = x; o.out = out; o.N = C; o.K = P;
  return launch_gemm<kOut, kRows>(o, st);
}

// out = x + FF(normFiLM(x)); rows 1 or 2 selects the GEMMs' M tile (128 or
// 256 tokens). Needs C % 64 == 0 and P % 64 == 0.
inline cudaError_t launch_ff(const bf16* x, const float* film, const FFWeights& w,
                             const FFScratch& s, bf16* out, int B, int T, int C, int P,
                             bool round_y, int rows, cudaStream_t st) {
  if (B <= 0 || T <= 0 || C <= 0 || P <= 0 || C % 64 != 0 || P % 64 != 0 ||
      (rows != 1 && rows != 2))
    return cudaErrorInvalidValue;
  return rows == 2 ? launch_ff_rows<2>(x, film, w, s, out, B, T, C, P, round_y, st)
                   : launch_ff_rows<1>(x, film, w, s, out, B, T, C, P, round_y, st);
}

}  // namespace ff
