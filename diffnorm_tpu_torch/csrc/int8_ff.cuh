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
// a one-warp-per-token requantize, the conv GEMM, a requantize, and the
// proj_out GEMM with bias and residual in its epilogue. The GEMMs are one
// Hopper kernel (gemm_kernel below): a producer warp feeding a ring of
// TMA-loaded, 128B-swizzled stages to two consumer warpgroups on wgmma
// (int8 m64nNk32 with exact int32 sums; the bf16 modes of fused_layer.cu
// m64nNk16 with f32 sums). `rows` of ffpipe_layer is the M tile's factor:
// a block takes `rows` 128-token M tiles and 128 / rows columns. Every
// output element is computed by the same arithmetic whatever the tile, so
// rows 1 and 2 agree bit for bit.
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

#include "hopper.cuh"

namespace ff {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------- helpers

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
// scale; else write bf16(y). film [B, 2C] f32 or bf16 (gamma ++ beta),
// row / T picks the batch row. C % 8 == 0.
template <bool kQuant, typename Film>
__global__ void __launch_bounds__(256)
norm_film_kernel(const bf16* __restrict__ x, const Film* __restrict__ film,
                 int8_t* __restrict__ q, float* __restrict__ scale_out,
                 bf16* __restrict__ y_out, int M, int T, int C, float sqrt_c) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= M) return;
  const bf16* xr = x + static_cast<size_t>(row) * C;
  const Film* gamma = film + static_cast<size_t>(row / T) * 2 * C;
  const Film* beta = gamma + C;

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

// norm_film_kernel over M tokens, film f32 or (film_bf16) bf16
template <bool kQuant>
cudaError_t launch_norm_film(const bf16* x, const void* film, bool film_bf16, int8_t* q,
                             float* scale_out, bf16* y_out, int M, int T, int C,
                             cudaStream_t st) {
  const float sqrt_c = static_cast<float>(sqrt(static_cast<double>(C)));
  if (film_bf16)
    norm_film_kernel<kQuant, bf16><<<(M + 7) / 8, 256, 0, st>>>(
        x, static_cast<const bf16*>(film), q, scale_out, y_out, M, T, C, sqrt_c);
  else
    norm_film_kernel<kQuant, float><<<(M + 7) / 8, 256, 0, st>>>(
        x, static_cast<const float*>(film), q, scale_out, y_out, M, T, C, sqrt_c);
  return cudaGetLastError();
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
  int M, N, K, taps, round_bf16;
  int Bseq, Tseq;         // A's M rows as Bseq sequences of Tseq (M = Bseq * Tseq):
                          // an M tile never crosses a sequence; kConv shifts within one
};

constexpr int kBM = 128;           // rows of an M tile: two consumer warpgroups x 64
constexpr int kRowBytes = 128;     // K bytes per pipeline stage: one 128B-swizzled row
constexpr int kGemmThreads = 384;  // warpgroups 0, 1 consume; warpgroup 2 produces

template <int kMode>
struct ModeTraits {
  static constexpr bool kInt8 = kMode <= kOut;
  static constexpr int kNB = kMode == kGeglu ? 2 : 1;  // B matrices
  static constexpr int kElem = kInt8 ? 1 : 2;          // bytes per A/B element
};

// kRows 128-row M tiles per block (the `rows` of ffpipe_layer) and
// 128 / kRows columns, so a thread's accumulators hold 64 registers either way
template <int kMode, int kRows>
struct GemmCfg {
  static constexpr int kBN = 128 / kRows;
  static constexpr int kAcc = kBN / 2;  // accumulator registers per 64 x kBN wgmma tile
  static constexpr int kATile = kRows * kBM * kRowBytes;
  static constexpr int kBTile = kBN * kRowBytes;
  static constexpr int kStageBytes = kATile + ModeTraits<kMode>::kNB * kBTile;
  static constexpr int kFit = 200 * 1024 / kStageBytes;
  static constexpr int kStages = kFit < 4 ? 4 : kFit > 8 ? 8 : kFit;
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + alignment
};

// one k-step (32 bytes of K) of a 64-row tile, by the accumulator's type and width
__device__ __forceinline__ void wgmma_step(int (&d)[64], uint64_t a, uint64_t b, int sd) {
  hopper::wgmma_s8_n128(d, a, b, sd);
}
__device__ __forceinline__ void wgmma_step(int (&d)[32], uint64_t a, uint64_t b, int sd) {
  hopper::wgmma_s8_n64(d, a, b, sd);
}
__device__ __forceinline__ void wgmma_step(float (&d)[64], uint64_t a, uint64_t b, int sd) {
  hopper::wgmma_bf16_n128(d, a, b, sd);
}
__device__ __forceinline__ void wgmma_step(float (&d)[32], uint64_t a, uint64_t b, int sd) {
  hopper::wgmma_bf16_n64(d, a, b, sd);
}

// a block tile: kRows M tiles of 128 rows, and kBN columns from n0
template <int kRows>
struct BlockTile {
  int tb[kRows], tt[kRows];  // each M tile's (sequence, first row)
  bool live[kRows];          // an M tile past the last repeats it, stores nothing
  int n0;

  __device__ __forceinline__ BlockTile(int tile, int n_tiles_n, int tiles_per_seq, int n_mtiles,
                                       int bn) {
    const int mg = tile / n_tiles_n;
    n0 = (tile % n_tiles_n) * bn;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int mt = mg * kRows + j;
      live[j] = mt < n_mtiles;
      const int m = live[j] ? mt : n_mtiles - 1;
      tb[j] = m / tiles_per_seq;
      tt[j] = (m % tiles_per_seq) * kBM;
    }
  }
};

// A block tile is kRows M tiles x kBN columns. The grid is persistent: at
// most one block per SM, each walking the block tiles i, i + grid, ... .
// Warpgroup 2 is the producer: one thread keeps TMA loads in flight through
// a ring of kStages mbarrier-guarded stages, each 128 bytes of K of the A
// tiles and the B tile(s), all 128B-swizzled; it runs on into the next
// block tile while the consumers finish the last one, so the next tile's
// loads overlap this tile's epilogue. Warpgroups 0 and 1 take rows 0-63 and
// 64-127 of each M tile: per stage 4 wgmma k-steps (int8 m64nNk32 with exact
// int32 sums, bf16 m64nNk16 with f32 sums) from shared memory, one group
// kept in flight, releasing a stage once the group that read it is done.
// The conv (design (a)): A is read as [Bseq, Tseq, K] and an M tile is 128
// rows of one sequence; tap i loads its A tile at row t0 - shift_i, and
// TMA's zero fill gives the causal shift's zero rows before t = 0 (and past
// the sequence's end). The taps run one after another, each into the same
// int32 accumulators (overwritten at the tap's first k-step), and each is
// folded into the f32 sum in tap order, as fold_tap always did: one A tile
// per tap and stage, no halo, and no second set of int32 accumulators,
// which at 64 + 64 registers a thread leaves room for the f32 sum.
template <int kMode, int kRows>
__global__ void __launch_bounds__(kGemmThreads, 1)
gemm_kernel(__grid_constant__ const CUtensorMap tm_a, __grid_constant__ const CUtensorMap tm_b0,
            __grid_constant__ const CUtensorMap tm_b1, const GemmArgs p) {
  typedef ModeTraits<kMode> Tr;
  typedef GemmCfg<kMode, kRows> Cfg;
  typedef BlockTile<kRows> Tile;
  typedef typename std::conditional<Tr::kInt8, int, float>::type Acc;
  constexpr int kS = Cfg::kStages, kBN = Cfg::kBN, kAcc = Cfg::kAcc;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kS], empty[kS];
  unsigned char* smem = hopper::align1024(smem_raw);

  const int tiles_per_seq = (p.Tseq + kBM - 1) / kBM;
  const int n_mtiles = p.Bseq * tiles_per_seq;
  const int n_tiles_n = (p.N + kBN - 1) / kBN;
  const int n_tiles = (n_mtiles + kRows - 1) / kRows * n_tiles_n;
  const int nk = (p.K * Tr::kElem + kRowBytes - 1) / kRowBytes;
  // live taps tap_first .. taps-1; tap i reads row t - (taps - 1 - i)
  const int taps = kMode == kConv ? p.taps : 1;
  int tap_first = 0;
  if constexpr (kMode == kConv)
    while (taps - 1 - tap_first >= p.Tseq) ++tap_first;
  const int n_iter = nk * (taps - tap_first);  // stages per block tile

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int g_it = 0;  // stages loaded so far, over all of the block's tiles
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const Tile bt(tile, n_tiles_n, tiles_per_seq, n_mtiles, kBN);
        for (int it = 0; it < n_iter; ++it, ++g_it) {
          const int s = g_it % kS;
          const int tap = tap_first + it / nk;
          const int shift = kMode == kConv ? taps - 1 - tap : 0;
          const int kc = (it % nk) * (kRowBytes / Tr::kElem);  // K coordinate, elements
          hopper::mbar_wait(&empty[s], ((g_it / kS) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&full[s], Cfg::kStageBytes);
          unsigned char* st = smem + s * Cfg::kStageBytes;
#pragma unroll
          for (int j = 0; j < kRows; ++j)
            hopper::tma_load_3d(st + j * kBM * kRowBytes, &tm_a, &full[s], kc,
                                bt.tt[j] - shift, bt.tb[j]);
          hopper::tma_load_3d(st + Cfg::kATile, &tm_b0, &full[s], kc, bt.n0, tap);
          if constexpr (Tr::kNB == 2)
            hopper::tma_load_3d(st + Cfg::kATile + Cfg::kBTile, &tm_b1, &full[s], kc, bt.n0, 0);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128, lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, q = lane % 4;
    // accumulator element i of a 64-row tile: row 16 warp + g + 8 (i % 4 / 2)
    // of the warpgroup's 64, column 8 (i / 4) + 2 q + i % 2
    Acc acc[Tr::kNB][kRows][kAcc];
    float yf[kRows][kMode == kConv ? kAcc : 1];  // kConv: the f32 sum over taps
    // the block tile's per-column scales and biases, staged in shared memory
    // (double-buffered by tile, one barrier per tile): kGeglu wxs, bx, wgs,
    // bg; kConv the taps' scales, then bc; kOut wfs, bf
    constexpr int kParams = kMode == kGeglu || kMode == kConv ? 4 : kMode == kOut ? 2 : 1;
    __shared__ float params[2][kParams][kBN];
    int g_it = 0;  // stages consumed so far, over all of the block's tiles
    for (int tile = blockIdx.x, parity = 0; tile < n_tiles; tile += gridDim.x, parity ^= 1) {
      const Tile bt(tile, n_tiles_n, tiles_per_seq, n_mtiles, kBN);
#pragma unroll
      for (int j = 0; j < kRows; ++j)
#pragma unroll
        for (int i = 0; i < (kMode == kConv ? kAcc : 1); ++i) yf[j][i] = 0.f;
      float(&prm)[kParams][kBN] = params[parity];
      if constexpr (Tr::kInt8) {
        for (int c = threadIdx.x; c < kParams * kBN; c += 256) {
          const int which = c / kBN, n = bt.n0 + c % kBN;
          const float* src = which == kParams - 1 && kMode == kConv ? p.bias0
                             : kMode == kConv ? p.w_scale0 + static_cast<size_t>(which) * p.N
                             : which == 0 ? p.w_scale0 : which == 1 ? p.bias0
                             : which == 2 ? p.w_scale1 : p.bias1;
          prm[which][c % kBN] = n < p.N && (kMode != kConv || which < taps ||
                                             which == kParams - 1) ? src[n] : 0.f;
        }
        // the 256 consumer threads: every one is done with the buffer's
        // last tile (two tiles back) and sees this one's parameters
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
      }

      // fold tap `tap`'s int32 sums into yf with its shifted token scale and
      // its tap scale, as the reference does: y + (float(acc) * a[t - shift]) * s
      auto fold_tap = [&](int tap) {
        if constexpr (kMode == kConv) {
          const int shift = taps - 1 - tap;
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            float am[2];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int t = bt.tt[j] + wg * 64 + warp * 16 + g + half * 8;
              // a row shifted in before t = 0 has code 0 and scale 1
              am[half] = (t < p.Tseq && t >= shift)
                             ? p.a_scale[static_cast<size_t>(bt.tb[j]) * p.Tseq + t - shift]
                             : 1.f;
            }
#pragma unroll
            for (int i = 0; i < kAcc; ++i) {
              const float ws = prm[tap][8 * (i / 4) + 2 * q + (i & 1)];
              const float y = __fmul_rn(__int2float_rn(acc[0][j][i]), am[(i / 2) & 1]);
              yf[j][i] = __fadd_rn(yf[j][i], __fmul_rn(y, ws));
            }
          }
        }
      };

      int held = -1;  // the stage the group in flight reads
      for (int it = 0; it < n_iter; ++it, ++g_it) {
        const int s = g_it % kS, kb = it % nk;
        hopper::mbar_wait(&full[s], (g_it / kS) & 1);
        const unsigned char* st = smem + s * Cfg::kStageBytes;
        hopper::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            const uint64_t da = hopper::desc_sw128(st + (j * kBM + wg * 64) * kRowBytes + ks * 32);
#pragma unroll
            for (int nb = 0; nb < Tr::kNB; ++nb)
              wgmma_step(acc[nb][j], da,
                         hopper::desc_sw128(st + Cfg::kATile + nb * Cfg::kBTile + ks * 32),
                         kb > 0 || ks > 0);
          }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // the previous stage's group is done
        if (held >= 0 && tid == 0) hopper::mbar_arrive(&empty[held]);
        held = s;
        if (kb == nk - 1) {  // the product's, or the tap's, last stage
          hopper::wgmma_wait<0>();
          if (tid == 0) hopper::mbar_arrive(&empty[held]);
          held = -1;
#pragma unroll
          for (int nb = 0; nb < Tr::kNB; ++nb)
#pragma unroll
            for (int j = 0; j < kRows; ++j) hopper::fence_operand(acc[nb][j]);
          fold_tap(tap_first + it / nk);
        }
      }

      // epilogue: the thread holds rows g, g + 8 of its warp's 16 and
      // columns 2q, 2q + 1 of each 8. Outside kGeglu a row's values are all
      // computed before any is stored: the compiler cannot move a load of the
      // residual above a store to `out` (they might alias). kGeglu, whose
      // epilogue holds the most registers, stores as it goes.
#pragma unroll
      for (int j = 0; j < kRows; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = bt.tt[j] + wg * 64 + warp * 16 + g + half * 8;
          if (!bt.live[j] || t >= p.Tseq) continue;
          const int m = bt.tb[j] * p.Tseq + t;
          float am = 1.f;
          if constexpr (Tr::kInt8 && kMode != kConv) am = p.a_scale[m];
          const size_t row = static_cast<size_t>(m) * p.N;
          float v[kBN / 4] = {};  // columns 8 ni + 2q + e at v[2 ni + e]
          auto store = [&](int ni) {
            const int n = bt.n0 + ni * 8 + 2 * q;
            if (n >= p.N) return;
            if (kMode == kConv && !p.round_bf16)
              *reinterpret_cast<float2*>(static_cast<float*>(p.out) + row + n) =
                  make_float2(v[2 * ni], v[2 * ni + 1]);
            else
              *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) + row + n) =
                  __floats2bfloat162_rn(v[2 * ni], v[2 * ni + 1]);
          };
#pragma unroll
          for (int ni = 0; ni < kBN / 8; ++ni) {
            const int n = bt.n0 + ni * 8 + 2 * q;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * ni + 2 * half + e, c = ni * 8 + 2 * q + e;
              const Acc s0 = acc[0][j][i];
              float& out = v[2 * ni + e];
              if (n >= p.N) continue;
              if constexpr (kMode == kGeglu) {
                const Acc s1 = acc[Tr::kNB - 1][j][i];
                const float hx = __fadd_rn(
                    __fmul_rn(__fmul_rn(__int2float_rn(s0), am), prm[0][c]), prm[1][c]);
                const float hg = __fadd_rn(
                    __fmul_rn(__fmul_rn(__int2float_rn(s1), am), prm[2][c]), prm[3][c]);
                out = __fmul_rn(gelu_tanh(hg), hx);
              } else if constexpr (kMode == kConv) {
                out = __fadd_rn(yf[j][i], prm[kParams - 1][c]);
              } else if constexpr (kMode == kOut) {
                const float o = __fadd_rn(
                    __fmul_rn(__fmul_rn(__int2float_rn(s0), am), prm[0][c]), prm[1][c]);
                out = __fadd_rn(__bfloat162float(p.resid[row + n + e]),
                                __bfloat162float(__float2bfloat16_rn(o)));
              } else if constexpr (kMode == kBf16Resid) {
                out = __fadd_rn(__bfloat162float(p.resid[row + n + e]),
                                __bfloat162float(__float2bfloat16_rn(s0)));
              } else {
                out = s0;
              }
            }
            if constexpr (kMode == kGeglu) store(ni);
          }
          if constexpr (kMode != kGeglu) {
#pragma unroll
            for (int ni = 0; ni < kBN / 8; ++ni) store(ni);
          }
        }
    }
  }
}

template <int kMode, int kRows>
cudaError_t launch_gemm(const GemmArgs& args, cudaStream_t st) {
  typedef ModeTraits<kMode> Tr;
  typedef GemmCfg<kMode, kRows> Cfg;
  const uint64_t kb = static_cast<uint64_t>(args.K) * Tr::kElem;  // bytes per row
  const int taps = kMode == kConv ? args.taps : 1;
  if (kb % 16 != 0 || args.Bseq <= 0 || args.Tseq <= 0 ||
      static_cast<long long>(args.Bseq) * args.Tseq != args.M || taps < 1 || taps > 3)
    return cudaErrorInvalidValue;  // kConv stages at most 3 tap scales
  const CUtensorMapDataType type =
      Tr::kInt8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint32_t box0 = kRowBytes / Tr::kElem;
  CUtensorMap ma, mb0, mb1;
  cudaError_t err = hopper::make_map_3d(&ma, type, args.a, args.K, args.Tseq, args.Bseq, kb,
                                        kb * args.Tseq, box0, kBM, 1);
  if (err == cudaSuccess)
    err = hopper::make_map_3d(&mb0, type, args.b0, args.K, args.N, taps, kb, kb * args.N, box0,
                              Cfg::kBN, 1);
  if (err == cudaSuccess)
    err = Tr::kNB == 2 ? hopper::make_map_3d(&mb1, type, args.b1, args.K, args.N, 1, kb,
                                             kb * args.N, box0, Cfg::kBN, 1)
                       : (mb1 = mb0, cudaSuccess);
  if (err != cudaSuccess) return err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(gemm_kernel<kMode, kRows>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem)) !=
          cudaSuccess)
    return err;
  const int m_tiles = args.Bseq * ((args.Tseq + kBM - 1) / kBM);
  const int tiles = (m_tiles + kRows - 1) / kRows * ((args.N + Cfg::kBN - 1) / Cfg::kBN);
  gemm_kernel<kMode, kRows><<<tiles < sms ? tiles : sms, kGemmThreads, Cfg::kSmem, st>>>(
      ma, mb0, mb1, args);
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
cudaError_t launch_ff_rows(const bf16* x, const void* film, bool film_bf16,
                           const FFWeights& w, const FFScratch& s, bf16* out, int B, int T,
                           int C, int P, bool round_y, cudaStream_t st) {
  const int M = B * T;
  const dim3 warps_grid((M + 7) / 8);
  cudaError_t err = launch_norm_film<true>(x, film, film_bf16, s.q, s.a, nullptr, M, T, C, st);
  if (err != cudaSuccess) return err;

  GemmArgs a = {};
  a.M = M; a.Bseq = 1; a.Tseq = M; a.taps = 1;
  a.a = s.q; a.a_scale = s.a;
  a.b0 = w.wxq; a.b1 = w.wgq; a.w_scale0 = w.wxs; a.w_scale1 = w.wgs;
  a.bias0 = w.bx; a.bias1 = w.bg; a.out = s.g; a.N = P; a.K = C;
  if ((err = launch_gemm<kGeglu, kRows>(a, st)) != cudaSuccess) return err;

  requant_kernel<bf16><<<warps_grid, 256, 0, st>>>(s.g, s.q, s.a, M, P);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  GemmArgs c = {};
  c.M = M; c.Bseq = B; c.Tseq = T; c.taps = 3; c.round_bf16 = round_y;
  c.a = s.q; c.a_scale = s.a; c.b0 = w.wcq; c.w_scale0 = w.wcs; c.bias0 = w.bc;
  c.out = s.y; c.N = P; c.K = P;
  if ((err = launch_gemm<kConv, kRows>(c, st)) != cudaSuccess) return err;

  if (round_y)
    requant_kernel<bf16><<<warps_grid, 256, 0, st>>>(static_cast<const bf16*>(s.y), s.q, s.a, M, P);
  else
    requant_kernel<float><<<warps_grid, 256, 0, st>>>(static_cast<const float*>(s.y), s.q, s.a, M, P);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  GemmArgs o = {};
  o.M = M; o.Bseq = 1; o.Tseq = M; o.taps = 1;
  o.a = s.q; o.a_scale = s.a; o.b0 = w.wfq; o.w_scale0 = w.wfs; o.bias0 = w.bf;
  o.resid = x; o.out = out; o.N = C; o.K = P;
  return launch_gemm<kOut, kRows>(o, st);
}

// out = x + FF(normFiLM(x)); film f32 or (film_bf16) bf16; rows 1 or 2
// selects the GEMMs' M tile (128 or 256 tokens). Needs C % 64 == 0 and
// P % 64 == 0.
inline cudaError_t launch_ff(const bf16* x, const void* film, bool film_bf16,
                             const FFWeights& w, const FFScratch& s, bf16* out, int B,
                             int T, int C, int P, bool round_y, int rows, cudaStream_t st) {
  if (B <= 0 || T <= 0 || C <= 0 || P <= 0 || C % 64 != 0 || P % 64 != 0 ||
      (rows != 1 && rows != 2))
    return cudaErrorInvalidValue;
  return rows == 2 ? launch_ff_rows<2>(x, film, film_bf16, w, s, out, B, T, C, P, round_y, st)
                   : launch_ff_rows<1>(x, film, film_bf16, w, s, out, B, T, C, P, round_y, st);
}

}  // namespace ff
