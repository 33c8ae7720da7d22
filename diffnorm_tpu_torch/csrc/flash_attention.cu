// Non-causal attention with a key-padding mask, online softmax, f32 sums.
//
// Replaces diffnorm_tpu/ops/pallas_attention.py:flash_attention (_attn_kernel
// and _attn_kernel_wide, which compute the same function):
//     s   = (q * scale) k^T                    f32, scale = 1/sqrt(D)
//     s_j = -1e30 where mask[b, j] is 0        (keys j < Tk)
//     out = (exp(s - max) v) / max(sum exp(s - max), 1e-30), cast to q's type
// Keys past Tk take no part: the TPU kernel pads Tk to its 512-key block and
// masks the padded keys like real ones, so a row whose keys are all masked
// comes out as sum(v) / Tk_pad there; here it is the mean of v over the Tk
// keys, which is what masked_attention (the path the kernel replaces) gives.
//
// Bound on an H100: bytes at the S2ST decoder's shape (q [2,8,256,64]
// against k/v [2,8,2112,64], bf16: 9.7 MB, 2.9 us at 3.35 TB/s; 2.2 GFLOP),
// operations at self-attention lengths (B2 H8 T4096 D64: 68.7 GFLOP, 69 us
// at the bf16 peak).
//
// Design (bf16): one block per (64 queries, batch x head), four warps of 16
// query rows. Q goes once into mma.sync A fragments (through shared memory);
// K and V stream through shared memory in 64-key tiles with cp.async, V's
// copy landing while the scores of the tile are computed. Scores are
// m16n8k16 bf16 mma with f32 sums: bf16 x bf16 products are exact in f32,
// and for D = 64 so is the scale 1/8, so only the order of the sums differs
// from the TPU kernel's f32 dot. The online softmax keeps each row's running
// max and sum in f32. The TPU multiplies f32 probabilities by V; a bf16 P
// would cost ~2^-9 relative, more than the reference tolerance, so P is
// split into bf16 hi + lo (lo = bf16(p - hi)) and P.V is two mma per tile,
// which keeps ~2^-17 of P. float32 inputs take a plain FMA kernel (one warp
// per query row, a lane per key for the scores and per channel for P.V).
// wgmma, TMA and a deeper K/V pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBq = 64;  // query rows per block (4 warps x 16)
constexpr int kBk = 64;  // keys per streamed tile
constexpr int kThreads = 128;
constexpr float kMasked = -1.0e30f;  // pallas_attention.py NEG_INF

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills instead of reading when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

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

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  __nv_bfloat162 h;
  h.x = lo;
  h.y = hi;
  return *reinterpret_cast<uint32_t*>(&h);
}

// p = hi + lo with hi = bf16(p), lo = bf16(p - hi); packs the pairs (a, b)
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi, uint32_t& lo) {
  const bf16 ha = __float2bfloat16_rn(a), hb = __float2bfloat16_rn(b);
  hi = pack_bf16(ha, hb);
  lo = pack_bf16(__float2bfloat16_rn(a - __bfloat162float(ha)),
                 __float2bfloat16_rn(b - __bfloat162float(hb)));
}

// rows r0 .. r0+63 of a [T, D] matrix into s (row stride D + 8); rows past
// T are zeros
template <int D>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* base, int r0, int T, int tid) {
  constexpr int kLd = D + 8, kChunks = D / 8;
  for (int c = tid; c < 64 * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = r0 + r < T;
    cp_async16(s + r * kLd + col, ok ? base + static_cast<size_t>(r0 + r) * D + col : base, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attn_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                 bf16* __restrict__ out, int H, int Tq, int Tk, float scale) {
  constexpr int kLd = D + 8;  // padded row (16 B): ldmatrix is conflict-free
  __shared__ __align__(128) bf16 sK[kBk * kLd];
  __shared__ __align__(128) bf16 sV[kBk * kLd];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.y, q0 = blockIdx.x * kBq;
  const bf16* qb = q + static_cast<size_t>(bh) * Tq * D;
  const bf16* kb = k + static_cast<size_t>(bh) * Tk * D;
  const bf16* vb = v + static_cast<size_t>(bh) * Tk * D;
  const uint8_t* mrow = mask ? mask + static_cast<size_t>(bh / H) * Tk : nullptr;
  const int g = lane / 4, qd = lane % 4;

  // the Q tile passes through sK into the warps' A fragments
  load_tile<D>(sK, qb, q0, Tq, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ldmatrix_x4(qa[ks], sK + (warp * 16 + lane % 16) * kLd + ks * 16 + (lane / 16) * 8);

  // thread holds rows g (r = 0: e = 0, 1) and g + 8 (r = 1: e = 2, 3);
  // columns ni*8 + 2qd + (e & 1) of keys (s) and channels (o)
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int ni = 0; ni < D / 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[ni][e] = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += kBk) {
    __syncthreads();  // every warp is done with sK (Q or the last tile) and sV
    load_tile<D>(sK, kb, k0, Tk, tid);
    cp_async_commit();
    load_tile<D>(sV, vb, k0, Tk, tid);
    cp_async_commit();
    cp_async_wait<1>();  // K has landed; V may still be in flight
    __syncthreads();

    float s[kBk / 8][4];
#pragma unroll
    for (int ni = 0; ni < kBk / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
      for (int nj = 0; nj < kBk / 16; ++nj) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, sK + (nj * 16 + lane % 8 + (lane / 16) * 8) * kLd + ks * 16 +
                             ((lane / 8) % 2) * 8);
        mma(s[2 * nj], qa[ks], bfr[0], bfr[1]);
        mma(s[2 * nj + 1], qa[ks], bfr[2], bfr[3]);
      }
#pragma unroll
    for (int ni = 0; ni < kBk / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + ni * 8 + 2 * qd + (e & 1);
        float x = s[ni][e] * scale;
        if (j >= Tk)
          x = -INFINITY;  // past the keys: weighs nothing
        else if (mrow && !mrow[j])
          x = kMasked;
        s[ni][e] = x;
      }

    // online softmax: the tile holds key k0 < Tk, so each row max is finite
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int ni = 0; ni < kBk / 8; ++ni) mx = fmaxf(mx, fmaxf(s[ni][2 * r], s[ni][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      const float alpha = expf(m_run[r] - m_new);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int ni = 0; ni < kBk / 8; ++ni)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[ni][e] = expf(s[ni][e] - m_new);
          sum += s[ni][e];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[r] = l_run[r] * alpha + sum;
      m_run[r] = m_new;
#pragma unroll
      for (int ni = 0; ni < D / 8; ++ni) {
        o[ni][2 * r] *= alpha;
        o[ni][2 * r + 1] *= alpha;
      }
    }

    cp_async_wait<0>();
    __syncthreads();  // V has landed for every thread's copies
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      // the accumulators of n-tiles 2kk, 2kk+1 are the A fragment of keys
      // 16kk .. 16kk+15
      uint32_t hi[4], lo[4];
      split_pair(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_pair(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int nj = 0; nj < D / 16; ++nj) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, sV + (kk * 16 + lane % 16) * kLd + nj * 16 + (lane / 16) * 8);
        mma(o[2 * nj], hi, bfr[0], bfr[1]);
        mma(o[2 * nj + 1], hi, bfr[2], bfr[3]);
        mma(o[2 * nj], lo, bfr[0], bfr[1]);
        mma(o[2 * nj + 1], lo, bfr[2], bfr[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + warp * 16 + g + 8 * r;
    if (t >= Tq) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
    bf16* orow = out + (static_cast<size_t>(bh) * Tq + t) * D;
#pragma unroll
    for (int ni = 0; ni < D / 8; ++ni)
      *reinterpret_cast<__nv_bfloat162*>(orow + ni * 8 + 2 * qd) =
          __floats2bfloat162_rn(o[ni][2 * r] / l, o[ni][2 * r + 1] / l);
  }
}

// float32: 16 query rows per block, 4 per warp; 32-key tiles, a lane per
// key for the scores and per channel (lane + 32 i) for P.V
constexpr int kQ32 = 16, kK32 = 32, kMaxD = 128;

__global__ void __launch_bounds__(kThreads)
attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const uint8_t* __restrict__ mask,
                float* __restrict__ out, int H, int Tq, int Tk, int D, float scale) {
  __shared__ float sQ[kQ32][kMaxD];
  __shared__ float sK[kK32][kMaxD + 1];  // odd stride: lane-per-key reads are conflict-free
  __shared__ float sV[kK32][kMaxD];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.y, q0 = blockIdx.x * kQ32;
  const float* qb = q + static_cast<size_t>(bh) * Tq * D;
  const float* kb = k + static_cast<size_t>(bh) * Tk * D;
  const float* vb = v + static_cast<size_t>(bh) * Tk * D;
  const uint8_t* mrow = mask ? mask + static_cast<size_t>(bh / H) * Tk : nullptr;

  for (int i = tid; i < kQ32 * D; i += kThreads) {
    const int r = i / D, c = i % D;
    sQ[r][c] = q0 + r < Tq ? qb[static_cast<size_t>(q0 + r) * D + c] * scale : 0.f;
  }
  float m_run[4], l_run[4], o[4][kMaxD / 32];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    m_run[rr] = -INFINITY;
    l_run[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i) o[rr][i] = 0.f;
  }

  for (int k0 = 0; k0 < Tk; k0 += kK32) {
    __syncthreads();
    for (int i = tid; i < kK32 * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < Tk;
      sK[r][c] = ok ? kb[static_cast<size_t>(k0 + r) * D + c] : 0.f;
      sV[r][c] = ok ? vb[static_cast<size_t>(k0 + r) * D + c] : 0.f;
    }
    __syncthreads();
    const int j = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int r = warp * 4 + rr;
      float s = 0.f;
      for (int c = 0; c < D; ++c) s = fmaf(sQ[r][c], sK[lane][c], s);
      if (j >= Tk)
        s = -INFINITY;
      else if (mrow && !mrow[j])
        s = kMasked;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[rr], mx);
      const float alpha = expf(m_run[rr] - m_new);
      const float p = expf(s - m_new);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[rr] = l_run[rr] * alpha + sum;
      m_run[rr] = m_new;
#pragma unroll
      for (int i = 0; i < kMaxD / 32; ++i) {
        const int d = lane + 32 * i;
        float acc = o[rr][i] * alpha;
        for (int jj = 0; jj < kK32; ++jj) {
          const float pj = __shfl_sync(0xffffffffu, p, jj);
          if (d < D) acc = fmaf(pj, sV[jj][d], acc);
        }
        o[rr][i] = acc;
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int t = q0 + warp * 4 + rr;
    if (t >= Tq) continue;
    const float l = fmaxf(l_run[rr], 1e-30f);
    float* orow = out + (static_cast<size_t>(bh) * Tq + t) * D;
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i) {
      const int d = lane + 32 * i;
      if (d < D) orow[d] = o[rr][i] / l;
    }
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* mask, void* out,
                        int BH, int H, int Tq, int Tk, float scale, cudaStream_t st) {
  attn_bf16_kernel<D><<<dim3((Tq + kBq - 1) / kBq, BH), kThreads, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(out), H, Tq, Tk, scale);
  return cudaGetLastError();
}

}  // namespace

// q [BH, Tq, D], k/v [BH, Tk, D], out [BH, Tq, D], bf16, contiguous and
// 16-byte aligned, with BH = B * H; mask [B, Tk] bytes (nonzero = valid) or
// null (every key valid). D in {32, 64, 96, 128}. Launches on `stream`;
// returns the cudaError_t of the launch.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, int BH, int H, int Tq, int Tk,
                                    int D, float scale, void* stream) {
  if (BH <= 0 || H <= 0 || BH % H != 0 || Tq <= 0 || Tk <= 0 || BH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return static_cast<int>(launch_bf16<32>(q, k, v, mask, out, BH, H, Tq, Tk, scale, st));
    case 64: return static_cast<int>(launch_bf16<64>(q, k, v, mask, out, BH, H, Tq, Tk, scale, st));
    case 96: return static_cast<int>(launch_bf16<96>(q, k, v, mask, out, BH, H, Tq, Tk, scale, st));
    case 128:
      return static_cast<int>(launch_bf16<128>(q, k, v, mask, out, BH, H, Tq, Tk, scale, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same for float32 tensors, 1 <= D <= 128.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, int BH, int H, int Tq, int Tk,
                                   int D, float scale, void* stream) {
  if (BH <= 0 || H <= 0 || BH % H != 0 || Tq <= 0 || Tk <= 0 || BH > 65535 || D <= 0 ||
      D > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  attn_f32_kernel<<<dim3((Tq + kQ32 - 1) / kQ32, BH), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), H, Tq, Tk, D, scale);
  return static_cast<int>(cudaGetLastError());
}
