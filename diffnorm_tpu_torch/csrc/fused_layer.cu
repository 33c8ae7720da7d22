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
// against [Wq | Wkv] (the TMA + wgmma GEMM of int8_ff.cuh in its bf16
// modes), masked attention, the output projection (the same GEMM, residual
// in its epilogue), then the FF sublayer of int8_ff.cuh. The attention kernel
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills instead of reading when !valid
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

// d += a (16 x 16 bf16, row) * b (16 x 8 bf16, col), f32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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
    cp_async16(s + r * kLd + col, ok ? base + static_cast<size_t>(r0 + r) * ld + col : base,
                   ok);
  }
}

constexpr int kTileElems = 64 * kLd;  // one 64-row tile of a head, padded rows
constexpr int kStages = 3;             // K/V tile pairs in flight
constexpr int kResident = 2;           // up to this many key tiles: the one-pass form
constexpr int kAttnSmem = (1 + 2 * kStages) * kTileElems * 2;  // Q, then K and V per stage

// qkv [B*T, 3C] bf16 (q ++ k ++ v, head h at columns h*64 of each third);
// mask [B, T] (nonzero = valid key); out [B*T, C] bf16, head h at h*64.
// For T <= 128 (the DDIM path) every K and V tile is loaded at once and
// the softmax takes one pass. Longer sequences take two passes, whose loads
// are one sequence, pass 1's K tiles then pass 2's K and V tiles, streamed
// through kStages buffers by cp.async: up to two tiles are in flight while
// one computes.
__global__ void __launch_bounds__(kThreads, 3)
attention_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ mask,
                 bf16* __restrict__ out, int T, int C, float scale) {
  extern __shared__ __align__(128) unsigned char attn_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(attn_smem);
  auto sK = [&](int s) { return sQ + (1 + 2 * s) * kTileElems; };
  auto sV = [&](int s) { return sQ + (2 + 2 * s) * kTileElems; };
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBq;
  const int ld = 3 * C;
  const bf16* base = qkv + static_cast<size_t>(b) * T * ld + h * kDh;
  const uint8_t* mrow = mask + static_cast<size_t>(b) * T;
  const int g = lane / 4, qd = lane % 4;
  const int n_tiles = (T + kBk - 1) / kBk, n_loads = 2 * n_tiles;

  // load u < n_tiles: pass 1's K tile u; else pass 2's K and V tile u - n_tiles
  auto start_load = [&](int u) {
    const int s = u % kStages, k0 = (u < n_tiles ? u : u - n_tiles) * kBk;
    load_tile(sK(s), base + C, k0, T, ld, tid);
    if (u >= n_tiles) load_tile(sV(s), base + 2 * C, k0, T, ld, tid);
  };
  load_tile(sQ, base, q0, T, ld, tid);
  if (n_tiles <= kResident) {  // every K and V tile at once, for the one-pass form
    for (int t = 0; t < n_tiles; ++t) {
      load_tile(sK(t), base + C, t * kBk, T, ld, tid);
      load_tile(sV(t), base + 2 * C, t * kBk, T, ld, tid);
    }
    cp_async_commit();
  } else {
#pragma unroll
    for (int u = 0; u < kStages - 1; ++u) {
      if (u < n_loads) start_load(u);
      cp_async_commit();  // group u (group 0 also holds Q)
    }
  }
  uint32_t qa[kDh / 16][4];

  // the warp's 16 x 64 scores against the key block at k0 (in sk): thread
  // holds rows g (e = 0, 1) and g + 8 (e = 2, 3), keys ni*8 + 2qd + (e & 1)
  auto scores = [&](const bf16* sk, int k0, float (&s)[kBk / 8][4]) {
#pragma unroll
    for (int ni = 0; ni < kBk / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kDh / 16; ++ks)
#pragma unroll
      for (int nj = 0; nj < kBk / 16; ++nj) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, sk + (nj * 16 + lane % 8 + (lane / 16) * 8) * kLd + ks * 16 +
                             ((lane / 8) % 2) * 8);
        mma(s[2 * nj], qa[ks], bfr[0], bfr[1]);
        mma(s[2 * nj + 1], qa[ks], bfr[2], bfr[3]);
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

  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float o[kDh / 8][4];
#pragma unroll
  for (int ni = 0; ni < kDh / 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[ni][e] = 0.f;

  // o += bf16(p) V for the key block in sv, p in s
  auto p_times_v = [&](const bf16* sv, const float (&s)[kBk / 8][4]) {
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
        ldmatrix_x4_trans(bfr, sv + (kk * 16 + lane % 16) * kLd + nj * 16 + (lane / 16) * 8);
        mma(o[2 * nj], pa, bfr[0], bfr[1]);
        mma(o[2 * nj + 1], pa, bfr[2], bfr[3]);
      }
    }
  };

  if (n_tiles <= kResident) {
    // one pass (T <= 128, the DDIM path): every score in registers, the
    // exact row max and sum, then p = bf16(exp(s - max) / sum) and o = p V
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kDh / 16; ++ks)
      ldmatrix_x4(qa[ks], sQ + (warp * 16 + lane % 16) * kLd + ks * 16 + (lane / 16) * 8);
    float s[kResident][kBk / 8][4];
#pragma unroll
    for (int t = 0; t < kResident; ++t) {
      if (t < n_tiles) {
        scores(sK(t), t * kBk, s[t]);
      } else {
#pragma unroll
        for (int ni = 0; ni < kBk / 8; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[t][ni][e] = -INFINITY;  // no keys: weighs nothing
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < kResident; ++t)
#pragma unroll
        for (int ni = 0; ni < kBk / 8; ++ni)
          mx = fmaxf(mx, fmaxf(s[t][ni][2 * r], s[t][ni][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      m_run[r] = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));  // finite: key 0 < T
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kResident; ++t)
#pragma unroll
        for (int ni = 0; ni < kBk / 8; ++ni)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            s[t][ni][e] = expf(__fsub_rn(s[t][ni][e], m_run[r]));
            sum = __fadd_rn(sum, s[t][ni][e]);
          }
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
      l_run[r] = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
    }
#pragma unroll
    for (int t = 0; t < kResident; ++t) {
      if (t >= n_tiles) break;
#pragma unroll
      for (int ni = 0; ni < kBk / 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][ni][e] = __fdiv_rn(s[t][ni][e], l_run[e / 2]);
      p_times_v(sV(t), s[t]);
    }
  }

  // longer sequences, two passes over the key blocks: pass 1 keeps the
  // online softmax statistics per row (running max, rescaled sum); pass 2
  // forms p = bf16(exp(s - max) / sum) and o = p V with f32 sums
  for (int u = 0; n_tiles > kResident && u < n_loads; ++u) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // load u has landed; every warp is done with load u - 1's buffer
    if (u + kStages - 1 < n_loads) start_load(u + kStages - 1);
    cp_async_commit();
    if (u == 0) {
#pragma unroll
      for (int ks = 0; ks < kDh / 16; ++ks)
        ldmatrix_x4(qa[ks], sQ + (warp * 16 + lane % 16) * kLd + ks * 16 + (lane / 16) * 8);
    }
    const int s_idx = u % kStages, k0 = (u < n_tiles ? u : u - n_tiles) * kBk;
    float s[kBk / 8][4];
    scores(sK(s_idx), k0, s);
    if (u < n_tiles) {
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
          for (int e = 0; e < 2; ++e)
            sum = __fadd_rn(sum, expf(__fsub_rn(s[ni][2 * r + e], m_new)));
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
        l_run[r] = __fadd_rn(__fmul_rn(l_run[r], expf(__fsub_rn(m_run[r], m_new))), sum);
        m_run[r] = m_new;
      }
      continue;
    }
#pragma unroll
    for (int ni = 0; ni < kBk / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[ni][e] = __fdiv_rn(expf(__fsub_rn(s[ni][e], m_run[e / 2])), l_run[e / 2]);
    p_times_v(sV(s_idx), s);
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
// [B, 2C] f32, or both bf16 if film_bf16; wqkv [3C, C] and wo [C, C] bf16
// as [out, in]; the int8 FF weights of ops/ffpipe.py:pack_ff_weights;
// scratch hn, oh, x1 bf16 [B*T, C], qkv bf16 [B*T, 3C], q int8 [B*T,
// max(C, P)], a f32 [B*T], g and y bf16 [B*T, P]. All contiguous and 16-byte aligned; dim_head == 64,
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
                                int heads, int dim_head, int film_bf16, void* stream) {
  if (B <= 0 || T <= 0 || dim_head != kDh || heads * kDh != C || P <= 0 || P % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * T;
  const bf16* xb = static_cast<const bf16*>(x);

  cudaError_t err = ff::launch_norm_film<false>(xb, film_attn, film_bf16 != 0, nullptr, nullptr,
                                                static_cast<bf16*>(hn), M, T, C, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  ff::GemmArgs proj = {};
  proj.M = M; proj.Bseq = 1; proj.Tseq = M; proj.taps = 1;
  proj.a = hn; proj.b0 = wqkv; proj.out = qkv; proj.N = 3 * C; proj.K = C;
  if ((err = ff::launch_gemm<ff::kBf16Store, 1>(proj, st)) != cudaSuccess)
    return static_cast<int>(err);

  if ((err = cudaFuncSetAttribute(attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kAttnSmem)) != cudaSuccess)
    return static_cast<int>(err);
  attention_kernel<<<dim3((T + kBq - 1) / kBq, heads, B), kThreads, kAttnSmem, st>>>(
      static_cast<const bf16*>(qkv), static_cast<const uint8_t*>(mask),
      static_cast<bf16*>(oh), T, C, static_cast<float>(pow(static_cast<double>(dim_head), -0.5)));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  ff::GemmArgs outp = {};
  outp.M = M; outp.Bseq = 1; outp.Tseq = M; outp.taps = 1;
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
                                        film_ff, film_bf16 != 0, w, s,
                                        static_cast<bf16*>(out), B, T, C, P,
                                        /*round_y=*/true, /*rows=*/1, st));
}
