// One WaveNet chain (all stacks at one dilation) for the DDIM denoiser and
// the speech VAE, bf16 in and out, f32 accumulation.
//
// Replaces diffnorm_tpu/ops/pallas_wavenet.py:wavenet_chain (_chain_kernel).
// Per stack s, for x [B, T, C]:
//     res = x W_res[s] + b_res[s]
//     h   = sum_i shift(x, (k-1-i) d) W_conv[s, i]        (causal taps)
//     h   = h * gamma[b, s] + beta'[b, s]                  (conv bias in beta')
//     x   = bf16(tanh(h) * sigmoid(h) + res)
// and after the last stack skip = x W_skip + b_skip.
//
// Bound on an H100: operations. One denoiser chain at B64 x T128, C=512,
// S=4, k=3 is 2 * 8192 * (S (k+1) + 1) * C^2 = 73 GFLOP against ~25 MB of
// weights and activations, ~2900 FLOP per byte; 74 us at 989 TFLOP/s dense
// bf16 when every tap is live (a tap whose shift reaches T is skipped).
//
// Design: one launch per stack plus one for the skip projection. Each block
// computes a 128 x 64 tile of the [B*T, C] output; 8 warps of 32 x 32 run
// bf16 mma.sync (m16n8k16) on fragments read with ldmatrix, accumulating in
// f32 registers. The (tap, 64-channel) steps stream through a 3-stage
// cp.async ring in shared memory, so loads of later steps overlap the
// products of the current one. The causal shift is applied while the A tile
// is loaded: row (b, t) of tap i reads row (b, t - shift), or zeros (the
// copy's zero-fill) before t = 0. The tap with shift 0 also feeds the
// residual 1x1 conv from the same A tile. The whole epilogue (FiLM,
// tanh * sigmoid, residual, biases) runs on the accumulator registers, so
// the conv output never reaches memory. Between stacks the activation goes
// through device memory (8 MB at the denoiser shape, mostly served from the
// 50 MB L2). Keeping it on chip across stacks, TMA and wgmma are later work.
// Ragged M (= B*T) and C are masked at 8-channel granularity: C % 8 == 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128, BN = 64, BK = 64;
constexpr int kWarpsM = 4, kWarpsN = 2;           // warp tile 32 x 32
constexpr int kThreads = kWarpsM * kWarpsN * 32;  // 256
constexpr int kStages = 3;
constexpr int LDA = BK + 8;  // padded rows (144 B): ldmatrix reads
constexpr int LDB = BN + 8;  // 8 rows without bank conflicts
constexpr int kVec = 8;      // bf16 values per 16-byte copy
constexpr int kATile = BM * LDA;
constexpr int kBTile = BK * LDB;
constexpr int kStageElems = kATile + 2 * kBTile;  // A, B, B of the residual
constexpr int kSmemBytes = kStages * kStageElems * 2;

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

// d += a (16 x 16, row-major) * b (16 x 8, k-major pairs), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The warp's 32 x 32 share of sa * sb over one BK step (2 x 4 mma tiles),
// and of sa * sb_res into acc_res when with_res, reusing the A fragments.
__device__ __forceinline__ void mma_step(const bf16* sa, const bf16* sb,
                                         const bf16* sb_res, bool with_res,
                                         float (&acc)[2][4][4],
                                         float (&acc_res)[2][4][4], int wm, int wn,
                                         int lane) {
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix_x4(a[mi], sa + (wm * 32 + mi * 16 + lane % 16) * LDA + ks * 16 +
                             (lane / 16) * 8);
    const int b_off = (ks * 16 + lane % 16) * LDB + wn * 32 + (lane / 16) * 8;
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, sb + b_off + nj * 16);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
        mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
      }
    }
    if (with_res) {
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, sb_res + b_off + nj * 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc_res[mi][2 * nj], a[mi], b[0], b[1]);
          mma_bf16(acc_res[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
}

// kStack: one WaveNet stack (K causal taps of w, the residual 1x1 w_res,
// FiLM + gated activation epilogue). Otherwise a 1x1 projection x w + bias
// (the chain's skip conv).
template <bool kStack>
__global__ void __launch_bounds__(kThreads, 2)  // <= 128 registers: 2 blocks/SM
chain_gemm_kernel(const bf16* __restrict__ x,
                  const bf16* __restrict__ w,      // [K, C, C]
                  const bf16* __restrict__ w_res,  // [C, C]
                  const bf16* __restrict__ bias,   // [C]
                  const float* __restrict__ gamma, // row b at b * film_stride
                  const float* __restrict__ beta, int film_stride,
                  bf16* __restrict__ out, int M, int T, int C, int K, int dilation) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // live taps: i_first .. K-1 (a tap whose shift reaches T reads only zeros)
  int i_first = 0;
  if (kStack)
    while ((K - 1 - i_first) * dilation >= T) ++i_first;
  const int n_taps = K - i_first;
  const int n_iter = ((C + BK - 1) / BK) * n_taps;

  auto load_stage = [&](int it, int stage) {
    const int k0 = (it / n_taps) * BK, i = i_first + it % n_taps;
    const int shift = kStack ? (K - 1 - i) * dilation : 0;
    bf16* sa = smem + stage * kStageElems;
    bf16* sb = sa + kATile;
#pragma unroll
    for (int c = tid; c < BM * BK / kVec; c += kThreads) {
      const int r = c / (BK / kVec), col = (c % (BK / kVec)) * kVec;
      const int m = m0 + r, k = k0 + col;
      const bool ok = m < M && k < C && m % T >= shift;
      cp_async16(sa + r * LDA + col,
                 ok ? x + static_cast<size_t>(m - shift) * C + k : x, ok);
    }
#pragma unroll
    for (int c = tid; c < BK * BN / kVec; c += kThreads) {
      const int r = c / (BN / kVec), col = (c % (BN / kVec)) * kVec;
      const int k = k0 + r, n = n0 + col;
      const bool ok = k < C && n < C;
      const size_t off = static_cast<size_t>(k) * C + n;
      const bf16* wi = w + static_cast<size_t>(i) * C * C;
      cp_async16(sb + r * LDB + col, ok ? wi + off : w, ok);
      if (kStack && shift == 0)
        cp_async16(sb + kBTile + r * LDB + col, ok ? w_res + off : w_res, ok);
    }
  };

  float acc[2][4][4], acc_res[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = acc_res[mi][ni][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_iter) load_stage(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `it` has landed; stage it-1 is free to refill
    if (it + kStages - 1 < n_iter) load_stage(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    const bf16* sa = smem + (it % kStages) * kStageElems;
    const bool with_res = kStack && i_first + it % n_taps == K - 1;  // unshifted tap
    mma_step(sa, sa + kATile, sa + kATile + kBTile, with_res, acc, acc_res, wm, wn, lane);
  }
  cp_async_wait<0>();

  // epilogue on the accumulators: thread holds rows g, g+8 and columns
  // 2q, 2q+1 of each 16 x 8 tile
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 32 + mi * 16 + g + half * 8;
      if (m >= M) continue;
      const size_t f_row = static_cast<size_t>(m / T) * film_stride;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn * 32 + ni * 8 + 2 * q;
        if (n >= C) continue;
        const float2 bn = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + n));
        float v0 = acc[mi][ni][2 * half], v1 = acc[mi][ni][2 * half + 1];
        if (kStack) {
          const float2 gm = *reinterpret_cast<const float2*>(gamma + f_row + n);
          const float2 bt = *reinterpret_cast<const float2*>(beta + f_row + n);
          const float h0 = v0 * gm.x + bt.x, h1 = v1 * gm.y + bt.y;
          const float r0 = acc_res[mi][ni][2 * half] + bn.x;
          const float r1 = acc_res[mi][ni][2 * half + 1] + bn.y;
          v0 = tanhf(h0) * (1.f / (1.f + expf(-h0))) + r0;
          v1 = tanhf(h1) * (1.f / (1.f + expf(-h1))) + r1;
        } else {
          v0 += bn.x;
          v1 += bn.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(m) * C + n) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
}

}  // namespace

// x, out, buf0, buf1: [B, T, C] bf16; w_conv [S, K, C, C], w_res [S, C, C],
// w_skip [C, C] bf16, each weight [in, out]; b_res [S, C], b_skip [C] bf16;
// gamma, beta [B, S, C] f32 (beta with the conv bias folded in). All
// contiguous, C % 8 == 0. buf0/buf1 are scratch for the stack outputs. Every
// launch goes on `stream`; returns the first non-zero cudaError_t, else 0.
extern "C" int wavenet_chain_bf16(const void* x, const void* w_conv,
                                  const void* w_res, const void* w_skip,
                                  const void* b_res, const void* b_skip,
                                  const void* gamma, const void* beta,
                                  void* buf0, void* buf1, void* out, int B,
                                  int T, int C, int S, int K, int dilation,
                                  void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || S <= 0 || K <= 0 || dilation <= 0 ||
      C % kVec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // more than 48 KB of dynamic shared memory must be allowed explicitly
  cudaError_t attr = cudaFuncSetAttribute(
      chain_gemm_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr == cudaSuccess)
    attr = cudaFuncSetAttribute(chain_gemm_kernel<false>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * T;
  const dim3 grid((M + BM - 1) / BM, (C + BN - 1) / BN);
  const size_t cc = static_cast<size_t>(C) * C;
  const bf16* cur = static_cast<const bf16*>(x);
  for (int s = 0; s < S; ++s) {
    bf16* dst = static_cast<bf16*>(s % 2 == 0 ? buf0 : buf1);
    chain_gemm_kernel<true><<<grid, kThreads, kSmemBytes, st>>>(
        cur, static_cast<const bf16*>(w_conv) + s * K * cc,
        static_cast<const bf16*>(w_res) + s * cc,
        static_cast<const bf16*>(b_res) + static_cast<size_t>(s) * C,
        static_cast<const float*>(gamma) + static_cast<size_t>(s) * C,
        static_cast<const float*>(beta) + static_cast<size_t>(s) * C, S * C,
        dst, M, T, C, K, dilation);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cur = dst;
  }
  chain_gemm_kernel<false><<<grid, kThreads, kSmemBytes, st>>>(
      cur, static_cast<const bf16*>(w_skip), nullptr,
      static_cast<const bf16*>(b_skip), nullptr, nullptr, 0,
      static_cast<bf16*>(out), M, T, C, 1, 1);
  return static_cast<int>(cudaGetLastError());
}
