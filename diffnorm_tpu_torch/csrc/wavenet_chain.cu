// One WaveNet chain (all stacks at one dilation) for the DDIM denoiser and
// the speech VAE: bf16 in and out with f32 sums (wavenet_chain_bf16), or
// float32 throughout (wavenet_chain_f32).
//
// Replaces diffnorm_tpu/ops/pallas_wavenet.py:wavenet_chain (_chain_kernel).
// Per stack s, for x [B, T, C]:
//     res = x W_res[s] + b_res[s]
//     h   = sum_i shift(x, (k-1-i) d) W_conv[s, i]        (causal taps)
//     h   = h * gamma[b, s] + beta'[b, s]                  (conv bias in beta')
//     x   = tanh(h) * sigmoid(h) + res                     (rounded to x's type)
// and after the last stack skip = x W_skip + b_skip. Every weight is stored
// [out, in] (K-major: the input channel is contiguous).
//
// Bound on an H100: operations. One denoiser chain at B64 x T128, C=512,
// S=4, k=3 is 2 * 8192 * (S (k+1) + 1) * C^2 = 73 GFLOP against ~25 MB of
// weights and activations, ~2900 FLOP per byte; 74 us at 989 TFLOP/s dense
// bf16 when every tap is live (a tap whose rows all fall before t = 0 is
// skipped, so at large dilations the bound is lower).
//
// bf16 design: one launch per stack and one for the skip projection, each a
// persistent grid of at most one block per SM walking 128 x 128 output
// tiles. An M tile is 128 rows of one sequence. Warpgroup 2 is the
// producer: one thread keeps TMA loads in flight through a ring of
// mbarrier-guarded, 128B-swizzled stages, each 64 channels of K: the A tile
// of x (16 KB), the tap's weight tile (16 KB) and, for the unshifted tap,
// the residual weight tile (16 KB). x is read through a 3-D tensor map
// [B, T, C]: tap i loads its A tile at (b, t0 - shift_i, k0), and TMA's
// zero fill supplies the causal zeros before t = 0 and the rows past T, as
// the int8 conv GEMM does (int8_ff.cuh, design (a)). The unshifted tap feeds
// the residual product from the same A stage. Warpgroups 0 and 1 take rows
// 0-63 and 64-127 on wgmma m64n128k16 with f32 accumulators: 64 registers a
// thread for h and 64 for res. A tap whose shifted rows all fall before
// t = 0 is neither loaded (whole tile) nor multiplied (one warpgroup's 64
// rows). Each tile's gamma, beta' and bias columns are staged in shared
// memory before its products, and the epilogue computes a row's values
// before it stores them (tanhf / expf, not the fast intrinsics). Between
// stacks the activation goes through device memory (8 MB at the denoiser
// shape, mostly served from the 50 MB L2); keeping it on chip across
// stacks, and the chains in one launch, are later work.
//
// float32 design: the same launches on a plain SIMT kernel, 64 x 64 tiles of
// 256 threads with 4 x 4 outputs each, K in steps of 16 through shared
// memory, FMA in f32. It is correct first; its speed is recorded, not tuned.
//
// Shapes: C % 8 == 0 (16-byte rows for TMA; the K and N tails are
// zero-filled), any B and T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// ------------------------------------------------------------------ bf16

constexpr int kBM = 128;   // rows of an M tile: two consumer warpgroups x 64
constexpr int kBN = 128;   // output columns of a tile
constexpr int kBK = 64;    // K channels per stage: one 128-byte swizzled row
constexpr int kRowBytes = kBK * 2;
constexpr int kThreads = 384;  // warpgroups 0, 1 consume; warpgroup 2 produces
constexpr int kATile = kBM * kRowBytes;
constexpr int kBTile = kBN * kRowBytes;

template <bool kStack>
struct Cfg {
  static constexpr int kStageBytes = kATile + (kStack ? 2 : 1) * kBTile;
  static constexpr int kStages = kStack ? 4 : 6;
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + alignment
};

struct ChainArgs {
  const void* bias;    // [C]: b_res (stack) or b_skip
  const float* gamma;  // stack: row b at b * film_stride
  const float* beta;
  void* out;           // [B, T, C]
  int film_stride, B, T, C, taps, dilation;
};

// the first tap whose shifted rows reach t >= 0 for some row <= last_row
__device__ __forceinline__ int first_live_tap(int last_row, int taps, int dilation) {
  int i = 0;
  while (i < taps - 1 && (taps - 1 - i) * dilation > last_row) ++i;
  return i;
}

// tile -> (sequence, first row, first column); the columns run fastest, so
// consecutive tiles share their A rows in L2
struct Tile {
  int b, t0, n0, last;  // last: the tile's last row below T

  __device__ __forceinline__ Tile(int tile, int n_tiles_n, int tiles_per_seq, int T) {
    const int m = tile / n_tiles_n;
    n0 = (tile % n_tiles_n) * kBN;
    b = m / tiles_per_seq;
    t0 = (m % tiles_per_seq) * kBM;
    last = min(t0 + kBM - 1, T - 1);
  }
};

// one stage of a warpgroup's 64 rows: 4 k-steps into h (and res)
template <bool kRes>
__device__ __forceinline__ void consume_stage(float (&h)[64], float (&res)[64],
                                              const unsigned char* st, int wg) {
#pragma unroll
  for (int ks = 0; ks < kBK / 16; ++ks) {
    const uint64_t da = hopper::desc_sw128(st + wg * 64 * kRowBytes + ks * 32);
    hopper::wgmma_bf16_n128(h, da, hopper::desc_sw128(st + kATile + ks * 32), 1);
    if constexpr (kRes)
      hopper::wgmma_bf16_n128(res, da, hopper::desc_sw128(st + kATile + kBTile + ks * 32), 1);
  }
}

// kStack: one WaveNet stack (the taps of tm_w, the residual tm_res, FiLM and
// the gated activation). Otherwise the 1x1 projection x W + bias (skip).
template <bool kStack>
__global__ void __launch_bounds__(kThreads, 1)
chain_kernel(__grid_constant__ const CUtensorMap tm_x,    // x [B, T, C]
             __grid_constant__ const CUtensorMap tm_w,    // [taps, C_out, C_in]
             __grid_constant__ const CUtensorMap tm_res,  // [1, C_out, C_in]
             const ChainArgs p) {
  typedef Cfg<kStack> G;
  constexpr int kS = G::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kS], empty[kS];
  // the tile's gamma, beta' and bias columns, double-buffered by tile
  __shared__ float params[2][3][kBN];
  unsigned char* smem = hopper::align1024(smem_raw);

  const int tiles_per_seq = (p.T + kBM - 1) / kBM;
  const int n_tiles_n = (p.C + kBN - 1) / kBN;
  const int n_tiles = p.B * tiles_per_seq * n_tiles_n;
  const int nk = (p.C + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // warp-uniform by construction (a shuffle from lane 0), so the compiler
  // sees no divergence in the warpgroup's branches around its wgmma
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int g_it = 0;  // stages loaded so far, over all of the block's tiles
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const Tile tl(tile, n_tiles_n, tiles_per_seq, p.T);
        for (int i = first_live_tap(tl.last, p.taps, p.dilation); i < p.taps; ++i) {
          const int shift = (p.taps - 1 - i) * p.dilation;
          const bool with_res = kStack && shift == 0;
          for (int kb = 0; kb < nk; ++kb, ++g_it) {
            const int s = g_it % kS;
            hopper::mbar_wait(&empty[s], ((g_it / kS) & 1) ^ 1);
            hopper::mbar_arrive_expect_tx(&full[s], kATile + (with_res ? 2 : 1) * kBTile);
            unsigned char* st = smem + s * G::kStageBytes;
            hopper::tma_load_3d(st, &tm_x, &full[s], kb * kBK, tl.t0 - shift, tl.b);
            hopper::tma_load_3d(st + kATile, &tm_w, &full[s], kb * kBK, tl.n0, i);
            if (with_res)
              hopper::tma_load_3d(st + kATile + kBTile, &tm_res, &full[s], kb * kBK, tl.n0, 0);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, q = lane % 4;
    // accumulator element i of the warpgroup's 64 x 128 tile: row
    // 16 warp + g + 8 (i % 4 / 2), column 8 (i / 4) + 2 q + i % 2
    float h[64], res[64];
    int g_it = 0;  // stages consumed so far, over all of the block's tiles
    for (int tile = blockIdx.x, parity = 0; tile < n_tiles; tile += gridDim.x, parity ^= 1) {
      const Tile tl(tile, n_tiles_n, tiles_per_seq, p.T);
      float(&prm)[3][kBN] = params[parity];
      for (int c = threadIdx.x; c < 3 * kBN; c += 256) {
        const int which = c / kBN, n = tl.n0 + c % kBN;
        float v = 0.f;
        if (n < p.C) {
          if (which == 2)
            v = __bfloat162float(static_cast<const bf16*>(p.bias)[n]);
          else if (kStack)
            v = (which == 0 ? p.gamma : p.beta)[static_cast<size_t>(tl.b) * p.film_stride + n];
        }
        prm[which][c % kBN] = v;
      }
      // the 256 consumer threads: every one is done with the buffer's last
      // tile (two tiles back) and sees this one's parameters
      asm volatile("bar.sync 1, 256;\n" ::: "memory");

#pragma unroll
      for (int i = 0; i < 64; ++i) h[i] = res[i] = 0.f;
      // this warpgroup's last row below T; it multiplies a tap only where
      // some of its rows, shifted, reach t >= 0
      const int wg_t0 = tl.t0 + wg * 64;
      const int wg_last = min(wg_t0 + 63, p.T - 1);
      int held = -1;  // the stage the group in flight reads
      for (int i = first_live_tap(tl.last, p.taps, p.dilation); i < p.taps; ++i) {
        const int shift = (p.taps - 1 - i) * p.dilation;
        const bool live = wg_last >= wg_t0 && shift <= wg_last;
        const bool with_res = kStack && shift == 0;
        for (int kb = 0; kb < nk; ++kb, ++g_it) {
          const int s = g_it % kS;
          hopper::mbar_wait(&full[s], (g_it / kS) & 1);
          const unsigned char* st = smem + s * G::kStageBytes;
          hopper::wgmma_fence();
          if (live) {
            if (with_res)
              consume_stage<true>(h, res, st, wg);
            else
              consume_stage<false>(h, res, st, wg);
          }
          hopper::wgmma_commit();  // an empty group where the rows are dead
          hopper::wgmma_wait<1>();  // the previous stage's group is done
          if (held >= 0 && tid == 0) hopper::mbar_arrive(&empty[held]);
          held = s;
        }
      }
      hopper::wgmma_wait<0>();
      if (held >= 0 && tid == 0) hopper::mbar_arrive(&empty[held]);
      hopper::fence_operand(h);
      if constexpr (kStack) hopper::fence_operand(res);

      // epilogue: the thread holds rows g, g + 8 of its warp's 16 and columns
      // 2q, 2q + 1 of each 8; a row's values are all computed, then stored
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = wg_t0 + warp * 16 + g + half * 8;
        if (t >= p.T) continue;
        __nv_bfloat162 v[kBN / 8];
#pragma unroll
        for (int ni = 0; ni < kBN / 8; ++ni) {
          float o[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * ni + 2 * half + e, c = ni * 8 + 2 * q + e;
            if constexpr (kStack) {
              const float hv = h[i] * prm[0][c] + prm[1][c];
              o[e] = tanhf(hv) * (1.f / (1.f + expf(-hv))) + (res[i] + prm[2][c]);
            } else {
              o[e] = h[i] + prm[2][c];
            }
          }
          v[ni] = __floats2bfloat162_rn(o[0], o[1]);
        }
        bf16* row = static_cast<bf16*>(p.out) + (static_cast<size_t>(tl.b) * p.T + t) * p.C;
#pragma unroll
        for (int ni = 0; ni < kBN / 8; ++ni) {
          const int n = tl.n0 + ni * 8 + 2 * q;
          if (n < p.C) *reinterpret_cast<__nv_bfloat162*>(row + n) = v[ni];
        }
      }
    }
  }
}

template <bool kStack>
cudaError_t launch_bf16(const void* x, const void* w, const void* w_res, const ChainArgs& p,
                        int sms, cudaStream_t st) {
  typedef Cfg<kStack> G;
  const uint64_t row = static_cast<uint64_t>(p.C) * 2;
  CUtensorMap mx, mw, mr;
  cudaError_t err = hopper::make_map_3d(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, p.C, p.T, p.B,
                                        row, row * p.T, kBK, kBM, 1);
  if (err == cudaSuccess)
    err = hopper::make_map_3d(&mw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, p.C, p.C, p.taps, row,
                              row * p.C, kBK, kBN, 1);
  if (err == cudaSuccess)
    err = kStack ? hopper::make_map_3d(&mr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w_res, p.C, p.C, 1,
                                       row, row * p.C, kBK, kBN, 1)
                 : (mr = mw, cudaSuccess);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(chain_kernel<kStack>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               G::kSmem);
  if (err != cudaSuccess) return err;
  const int tiles = p.B * ((p.T + kBM - 1) / kBM) * ((p.C + kBN - 1) / kBN);
  chain_kernel<kStack><<<tiles < sms ? tiles : sms, kThreads, G::kSmem, st>>>(mx, mw, mr, p);
  return cudaGetLastError();
}

// --------------------------------------------------------------- float32

constexpr int kFM = 64, kFN = 64, kFK = 16;  // tile and K step
constexpr int kFThreads = 256;               // 16 x 16 threads, 4 x 4 outputs each

// The float32 form of chain_kernel: rows m of the flattened [B*T, C] x.
template <bool kStack>
__global__ void __launch_bounds__(kFThreads)
chain_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ w_res, const ChainArgs p) {
  __shared__ float sa[kFK][kFM + 4];  // [k][row]
  __shared__ float sb[kFK][kFN + 4];  // [k][column]
  __shared__ float sr[kFK][kFN + 4];
  const int M = p.B * p.T, C = p.C;
  const int m0 = blockIdx.x * kFM, n0 = blockIdx.y * kFN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float h[4][4] = {}, res[4][4] = {};

  int i_first = 0;  // a tap whose shift reaches T reads only zeros
  while (i_first < p.taps - 1 && (p.taps - 1 - i_first) * p.dilation >= p.T) ++i_first;
  for (int i = i_first; i < p.taps; ++i) {
    const int shift = (p.taps - 1 - i) * p.dilation;
    const bool with_res = kStack && shift == 0;
    const float* wi = w + static_cast<size_t>(i) * C * C;
    for (int k0 = 0; k0 < C; k0 += kFK) {
      for (int e = threadIdx.x; e < kFM * kFK; e += kFThreads) {
        const int r = e / kFK, kk = e % kFK, m = m0 + r, k = k0 + kk;
        const bool ok = m < M && k < C && m % p.T >= shift;
        sa[kk][r] = ok ? x[static_cast<size_t>(m - shift) * C + k] : 0.f;
        const int n = n0 + r;  // kFN == kFM: the same loop fills the weights
        const size_t off = static_cast<size_t>(n) * C + k;
        sb[kk][r] = n < C && k < C ? wi[off] : 0.f;
        if (with_res) sr[kk][r] = n < C && k < C ? w_res[off] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kFK; ++kk) {
        float a[4], b[4], br[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a[j] = sa[kk][ty + 16 * j];
          b[j] = sb[kk][tx + 16 * j];
          br[j] = with_res ? sr[kk][tx + 16 * j] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            h[r][c] = fmaf(a[r], b[c], h[r][c]);
            if (with_res) res[r][c] = fmaf(a[r], br[c], res[r][c]);
          }
      }
      __syncthreads();
    }
  }

  const float* bias = static_cast<const float*>(p.bias);
  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + ty + 16 * r;
    if (m >= M) continue;
    const size_t f_row = static_cast<size_t>(m / p.T) * p.film_stride;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx + 16 * c;
      if (n >= C) continue;
      float o;
      if (kStack) {
        const float hv = h[r][c] * p.gamma[f_row + n] + p.beta[f_row + n];
        o = tanhf(hv) * (1.f / (1.f + expf(-hv))) + (res[r][c] + bias[n]);
      } else {
        o = h[r][c] + bias[n];
      }
      out[static_cast<size_t>(m) * C + n] = o;
    }
  }
}

template <bool kStack>
cudaError_t launch_f32(const void* x, const void* w, const void* w_res, const ChainArgs& p,
                       int /*sms*/, cudaStream_t st) {
  const dim3 grid((p.B * p.T + kFM - 1) / kFM, (p.C + kFN - 1) / kFN);
  chain_f32_kernel<kStack><<<grid, kFThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(w_res), p);
  return cudaGetLastError();
}

// ------------------------------------------------------------ the chain

// S stack launches, ping-ponging through buf0 / buf1, then the skip launch
// into out; Elem is the element type of x, the weights, biases and outputs.
template <typename Elem, bool kBf16>
int run_chain(const void* x, const void* w_conv, const void* w_res, const void* w_skip,
              const void* b_res, const void* b_skip, const void* gamma, const void* beta,
              void* buf0, void* buf1, void* out, int B, int T, int C, int S, int K,
              int dilation, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || S <= 0 || K <= 0 || dilation <= 0 || C % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int sms = 0;
  if (kBf16) {
    int device;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t cc = static_cast<size_t>(C) * C;
  const Elem* cur = static_cast<const Elem*>(x);
  for (int s = 0; s < S; ++s) {
    Elem* dst = static_cast<Elem*>(s % 2 == 0 ? buf0 : buf1);
    ChainArgs a = {static_cast<const Elem*>(b_res) + static_cast<size_t>(s) * C,
                   static_cast<const float*>(gamma) + static_cast<size_t>(s) * C,
                   static_cast<const float*>(beta) + static_cast<size_t>(s) * C,
                   dst, S * C, B, T, C, K, dilation};
    const Elem* ws = static_cast<const Elem*>(w_conv) + s * K * cc;
    const Elem* wr = static_cast<const Elem*>(w_res) + s * cc;
    const cudaError_t err = kBf16 ? launch_bf16<true>(cur, ws, wr, a, sms, st)
                                  : launch_f32<true>(cur, ws, wr, a, sms, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    cur = dst;
  }
  ChainArgs a = {b_skip, nullptr, nullptr, out, 0, B, T, C, 1, 1};
  return static_cast<int>(kBf16 ? launch_bf16<false>(cur, w_skip, nullptr, a, sms, st)
                                : launch_f32<false>(cur, w_skip, nullptr, a, sms, st));
}

}  // namespace

// x, out, buf0, buf1: [B, T, C]; w_conv [S, K, C, C], w_res [S, C, C],
// w_skip [C, C], each weight [out, in]; b_res [S, C], b_skip [C]; all in bf16
// (wavenet_chain_bf16) or float32 (wavenet_chain_f32); gamma, beta [B, S, C]
// float32 (beta with the conv bias folded in). All contiguous and 16-byte
// aligned, C % 8 == 0. buf0 / buf1 are scratch for the stack outputs. Every
// launch goes on `stream`; returns the first non-zero cudaError_t, else 0.
extern "C" int wavenet_chain_bf16(const void* x, const void* w_conv, const void* w_res,
                                  const void* w_skip, const void* b_res, const void* b_skip,
                                  const void* gamma, const void* beta, void* buf0, void* buf1,
                                  void* out, int B, int T, int C, int S, int K, int dilation,
                                  void* stream) {
  return run_chain<bf16, true>(x, w_conv, w_res, w_skip, b_res, b_skip, gamma, beta, buf0, buf1,
                               out, B, T, C, S, K, dilation, stream);
}

extern "C" int wavenet_chain_f32(const void* x, const void* w_conv, const void* w_res,
                                 const void* w_skip, const void* b_res, const void* b_skip,
                                 const void* gamma, const void* beta, void* buf0, void* buf1,
                                 void* out, int B, int T, int C, int S, int K, int dilation,
                                 void* stream) {
  return run_chain<float, false>(x, w_conv, w_res, w_skip, b_res, b_skip, gamma, beta, buf0,
                                 buf1, out, B, T, C, S, K, dilation, stream);
}
