// One whole transformer layer of the DDIM denoiser (int8 W8A8 FF), bf16 in
// and out.
//
// Replaces diffnorm_tpu/ops/pallas_block.py:fused_layer (_layer_kernel):
//     hn  = bf16(normFiLM(x, film_attn))                       f32 norm
//     q, k, v = bf16(hn Wq), bf16(hn Wkv)                       f32 sums
//     per head: p = softmax(q k^T / sqrt(dh), keys masked to -1e30)
//               o_h = bf16(bf16(p) v)
//     x1  = x + bf16(sum_h o_h Wo[h])
//     out = x1 + FF(normFiLM(x1, film_ff))    (int8_ff.cuh, conv output
//                                              rounded to bf16 before its
//                                              requantization)
//
// Bound on an H100: operations. At B64 x T128, C=512, 8 heads x 64, P=1408:
// 132.9 G int8 ops (67.1 us at 1979 TOP/s) plus 19.3 GFLOP of bf16 (q/kv/o
// projections and attention, 19.5 us at 989 TFLOP/s); ~27 MB of bytes, ~8 us.
//
// Design: the TPU kernel ran one batch row per grid step with all weights in
// VMEM. Here the layer is a sequence of launches over the B*T tokens: the
// attention norm (one warp per token), the q/kv projection as one bf16 GEMM
// against [Wq | Wkv] (the tiled GEMM of int8_ff.cuh with bf16 mma.sync),
// masked attention, the output projection (the same GEMM, residual in its
// epilogue), then the FF sublayer of int8_ff.cuh. The attention kernel
// streams 64-key blocks through shared memory, so any T fits (the CLI's
// buckets reach 6144): one block per (64 queries, head, batch row), four
// warps of 16 query rows on bf16 mma.sync. A first pass over the key blocks
// keeps the online softmax's running max and rescaled sum; a second pass
// recomputes the scores and forms p = exp(s - max) / sum, rounds it to bf16
// and multiplies it with V, as the reference rounds the normalized
// probabilities (an unnormalized product would round elsewhere). Masked keys
// score -1e30, so a fully masked row is uniform over its keys, never NaN;
// keys past T score -inf and weigh nothing.

#include "int8_ff.cuh"

namespace {

using ff::bf16;

constexpr int kDh = 64;       // head width
constexpr int kBq = 64;       // query rows per block (4 warps x 16)
constexpr int kBk = 64;       // keys per streamed block
constexpr int kLd = kDh + 8;  // padded smem row (144 B): ldmatrix is conflict-free
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// rows r0 .. r0+63 of one head's 64 columns (row stride ld) into s; rows
// past T are zeros
__device__ __forceinline__ void load_tile(bf16* s, const bf16* base, int r0, int T,
                                          int ld, int tid) {
  for (int c = tid; c < 64 * (kDh / 8); c += kThreads) {
    const int r = c / (kDh / 8), col = (c % (kDh / 8)) * 8;
    const bool ok = r0 + r < T;
    ff::cp_async16(s + r * kLd + col, ok ? base + static_cast<size_t>(r0 + r) * ld + col : base,
                   ok);
  }
}

// qkv [B*T, 3C] bf16 (q ++ k ++ v, head h at columns h*64 of each third);
// mask [B, T] (nonzero = valid key); out [B*T, C] bf16, head h at h*64.
__global__ void __launch_bounds__(kThreads)
attention_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ mask,
                 bf16* __restrict__ out, int T, int C, float scale) {
  __shared__ __align__(128) bf16 sQ[kBq * kLd];
  __shared__ __align__(128) bf16 sK[kBk * kLd];
  __shared__ __align__(128) bf16 sV[kBk * kLd];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBq;
  const int ld = 3 * C;
  const bf16* base = qkv + static_cast<size_t>(b) * T * ld + h * kDh;
  const uint8_t* mrow = mask + static_cast<size_t>(b) * T;
  const int g = lane / 4, qd = lane % 4;

  load_tile(sQ, base, q0, T, ld, tid);
  ff::cp_async_commit();
  ff::cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[kDh / 16][4];
#pragma unroll
  for (int ks = 0; ks < kDh / 16; ++ks)
    ff::ldmatrix_x4(qa[ks], sQ + (warp * 16 + lane % 16) * kLd + ks * 16 + (lane / 16) * 8);

  // the warp's 16 x 64 scores against the key block at k0 (in sK): thread
  // holds rows g (e = 0, 1) and g + 8 (e = 2, 3), keys ni*8 + 2qd + (e & 1)
  auto scores = [&](int k0, float (&s)[kBk / 8][4]) {
#pragma unroll
    for (int ni = 0; ni < kBk / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kDh / 16; ++ks)
#pragma unroll
      for (int nj = 0; nj < kBk / 16; ++nj) {
        uint32_t bfr[4];
        ff::ldmatrix_x4(bfr, sK + (nj * 16 + lane % 8 + (lane / 16) * 8) * kLd + ks * 16 +
                                 ((lane / 8) % 2) * 8);
        ff::mma(s[2 * nj], qa[ks], bfr[0], bfr[1]);
        ff::mma(s[2 * nj + 1], qa[ks], bfr[2], bfr[3]);
      }
#pragma unroll
    for (int ni = 0; ni < kBk / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + ni * 8 + 2 * qd + (e & 1);
        float v = __fmul_rn(s[ni][e], scale);
        if (j >= T)
          v = -INFINITY;
        else if (!mrow[j])
          v = -1e30f;
        s[ni][e] = v;
      }
  };

  // pass 1: online softmax statistics per row (running max, rescaled sum)
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < T; k0 += kBk) {
    __syncthreads();  // every warp is done with the previous key block
    load_tile(sK, base + C, k0, T, ld, tid);
    ff::cp_async_commit();
    ff::cp_async_wait<0>();
    __syncthreads();
    float s[kBk / 8][4];
    scores(k0, s);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int ni = 0; ni < kBk / 8; ++ni) mx = fmaxf(mx, fmaxf(s[ni][2 * r], s[ni][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);  // finite: key k0 < T is in the block
      float sum = 0.f;
#pragma unroll
      for (int ni = 0; ni < kBk / 8; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) sum = __fadd_rn(sum, expf(__fsub_rn(s[ni][2 * r + e], m_new)));
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
      l_run[r] = __fadd_rn(__fmul_rn(l_run[r], expf(__fsub_rn(m_run[r], m_new))), sum);
      m_run[r] = m_new;
    }
  }

  // pass 2: p = bf16(exp(s - max) / sum), o = p V with f32 sums
  float o[kDh / 8][4];
#pragma unroll
  for (int ni = 0; ni < kDh / 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[ni][e] = 0.f;
  for (int k0 = 0; k0 < T; k0 += kBk) {
    __syncthreads();
    load_tile(sK, base + C, k0, T, ld, tid);
    load_tile(sV, base + 2 * C, k0, T, ld, tid);
    ff::cp_async_commit();
    ff::cp_async_wait<0>();
    __syncthreads();
    float s[kBk / 8][4];
    scores(k0, s);
#pragma unroll
    for (int ni = 0; ni < kBk / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[ni][e] = __fdiv_rn(expf(__fsub_rn(s[ni][e], m_run[e / 2])), l_run[e / 2]);
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      // the score accumulators of n-tiles 2kk, 2kk+1 are the A fragment of
      // keys 16kk .. 16kk+15
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nj = 0; nj < kDh / 16; ++nj) {
        uint32_t bfr[4];
        ff::ldmatrix_x4_trans(bfr, sV + (kk * 16 + lane % 16) * kLd + nj * 16 + (lane / 16) * 8);
        ff::mma(o[2 * nj], pa, bfr[0], bfr[1]);
        ff::mma(o[2 * nj + 1], pa, bfr[2], bfr[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + warp * 16 + g + 8 * r;
    if (t >= T) continue;
    bf16* orow = out + (static_cast<size_t>(b) * T + t) * C + h * kDh;
#pragma unroll
    for (int ni = 0; ni < kDh / 8; ++ni)
      *reinterpret_cast<__nv_bfloat162*>(orow + ni * 8 + 2 * qd) =
          __floats2bfloat162_rn(o[ni][2 * r], o[ni][2 * r + 1]);
  }
}

}  // namespace

// x, out [B, T, C] bf16; mask [B, T] bool (1 byte); film_attn, film_ff
// [B, 2C] f32; wqkv [3C, C] and wo [C, C] bf16 as [out, in]; the int8 FF
// weights of ops/ffpipe.py:pack_ff_weights; scratch hn, oh, x1 bf16 [B*T, C],
// qkv bf16 [B*T, 3C], q int8 [B*T, max(C, P)], a f32 [B*T], g and y bf16
// [B*T, P]. All contiguous and 16-byte aligned; dim_head == 64,
// heads * 64 == C, P % 64 == 0. Every launch goes on `stream`; returns the
// first non-zero cudaError_t, else 0.
extern "C" int fused_layer_bf16(const void* x, const void* mask, const void* film_attn,
                                const void* film_ff, const void* wqkv, const void* wo,
                                const void* wxq, const void* wxs, const void* bx,
                                const void* wgq, const void* wgs, const void* bg,
                                const void* wcq, const void* wcs, const void* bc,
                                const void* wfq, const void* wfs, const void* bf,
                                void* hn, void* qkv, void* oh, void* x1, void* q, void* a,
                                void* g, void* y, void* out, int B, int T, int C, int P,
                                int heads, int dim_head, void* stream) {
  if (B <= 0 || T <= 0 || dim_head != kDh || heads * kDh != C || P <= 0 || P % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * T;
  const bf16* xb = static_cast<const bf16*>(x);

  ff::norm_film_kernel<false><<<(M + 7) / 8, 256, 0, st>>>(
      xb, static_cast<const float*>(film_attn), nullptr, nullptr, static_cast<bf16*>(hn), M, T,
      C, static_cast<float>(sqrt(static_cast<double>(C))));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  ff::GemmArgs proj = {};
  proj.M = M; proj.T = T; proj.taps = 1;
  proj.a = hn; proj.b0 = wqkv; proj.out = qkv; proj.N = 3 * C; proj.K = C;
  if ((err = ff::launch_gemm<ff::kBf16Store, 1>(proj, st)) != cudaSuccess)
    return static_cast<int>(err);

  attention_kernel<<<dim3((T + kBq - 1) / kBq, heads, B), kThreads, 0, st>>>(
      static_cast<const bf16*>(qkv), static_cast<const uint8_t*>(mask),
      static_cast<bf16*>(oh), T, C, static_cast<float>(pow(static_cast<double>(dim_head), -0.5)));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  ff::GemmArgs outp = {};
  outp.M = M; outp.T = T; outp.taps = 1;
  outp.a = oh; outp.b0 = wo; outp.resid = xb; outp.out = x1; outp.N = C; outp.K = C;
  if ((err = ff::launch_gemm<ff::kBf16Resid, 1>(outp, st)) != cudaSuccess)
    return static_cast<int>(err);

  const ff::FFWeights w = {
      static_cast<const int8_t*>(wxq), static_cast<const int8_t*>(wgq),
      static_cast<const int8_t*>(wcq), static_cast<const int8_t*>(wfq),
      static_cast<const float*>(wxs),  static_cast<const float*>(wgs),
      static_cast<const float*>(wcs),  static_cast<const float*>(wfs),
      static_cast<const float*>(bx),   static_cast<const float*>(bg),
      static_cast<const float*>(bc),   static_cast<const float*>(bf)};
  const ff::FFScratch s = {static_cast<int8_t*>(q), static_cast<float*>(a),
                           static_cast<bf16*>(g), y};
  return static_cast<int>(ff::launch_ff(static_cast<const bf16*>(x1),
                                        static_cast<const float*>(film_ff), w, s,
                                        static_cast<bf16*>(out), B, T, C, P,
                                        /*round_y=*/true, /*rows=*/1, st));
}
