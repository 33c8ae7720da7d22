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
// at the bf16 peak; float32 at HuBERT's long form [1,12,3499,64]: 37.6
// GFLOP, three tf32 passes of each product 0.228 ms at 494.7 TFLOP/s).
//
// Design, bf16 with D = 64 or 128 (attn_wgmma_kernel). A block is one
// warpgroup of 64 query rows plus one producer warp. The producer loads Q
// once and streams K and V in 64-key tiles by TMA (128-byte swizzle) through
// a ring of mbarrier-guarded stages (4 at D = 64, 3 at D = 128), so the next
// tiles are in flight while one computes; with each tile it turns the tile's
// mask bytes into two 32-bit words (ballot) in shared memory, so the
// consumers read no mask from global memory. Both products are wgmma: q k^T
// from shared Q and K (both K-major), then P.V with P from registers (the
// score accumulators are the A fragments) and V read MN-major (transposed)
// from shared memory. The TPU multiplies f32 probabilities by V; a bf16 P
// would cost ~2^-9 relative, more than the reference tolerance, so P is
// split into bf16 hi + lo (lo = bf16(p - hi)) and P.V is two wgmma per
// k-step, which keeps ~2^-17 of P. Scores and the running max live in the
// log2 domain (scale * log2 e folded into one multiply, exp2f).
// Split over the keys: where (query tiles x B*H) would leave the card under
// about two blocks per SM (the S2ST decoder: 4 x 16 = 64 blocks for 132
// SMs), the wrapper cuts the key tiles into contiguous ranges, one block per
// (range, query tile, head); each writes its unnormalized f32 o and its rows'
// max m and sum l, and attn_merge_kernel combines them:
//     m* = max_i m_i,  o = sum_i 2^(m_i - m*) o_i / max(sum_i 2^(m_i - m*) l_i, 1e-30)
// No range starts at or past Tk (so every range has a key and a finite m); a
// range whose keys are all masked has m = -1e30 and weighs nothing beside one
// with a valid key, and a row with no valid key is the mean over the Tk keys.
//
// D = 32 and 96 take an mma.sync kernel (attn_mma_kernel:
// 64-query blocks of 4 warps, 64-key K/V tiles by cp.async, ldmatrix +
// m16n8k16 with the same hi + lo P): their rows are 64 and 192 bytes, which
// do not tile into the 128-byte swizzled rows the wgmma kernel is built on.
// D = 32 is UnitY's (decoders 256 wide, 8 heads): its first-pass decoder's
// encoder attention in a long-form beam decode, one query a row against
// >= 2048 encoder frames. No path of the port runs D = 96.
//
// Design, float32 with 1 <= D <= 128 (attn_tf32_kernel). The paths that
// send float32 here (HuBERT in cli.prepare) run with TF32 off and are held
// to a float32 SGEMM, and one tf32 pass (10-bit mantissas) misses the
// kernel's tolerance at score std 9 (tests/test_torch_flash_attention.py
// emulates both). So both products run on tf32 tensor cores in three
// passes: x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), and
// x y = hi hi' + hi lo' + lo hi', which keeps float32's accuracy. Three
// prologue launches write Q and K split into [hi; lo] halves and V^T split
// the same way (tf32 wgmma reads shared operands K-major only, and P.V's B
// operand is V), with D zero-padded to whole 32-float swizzle regions and
// the keys of each group of 8 stored in V^T as 0, 2, 4, 6, 1, 3, 5, 7: then
// the score accumulators are P's A fragments, split in registers with no
// shuffle. The main kernel is the bf16 one's shape: a producer warp streams
// 64-key tiles of the four operands by TMA through an mbarrier ring, and
// two consumer warpgroups of 64 queries (one where D > 64) share each tile.
// Where D > 64 only one stage fits in shared memory, so there loads and
// compute take turns (no path runs float32 with D > 64).
// The tensor cores truncate each k-step's float32 sum, so each product sums
// its small cross terms first, and each tile's P.V starts from zero and is
// added to the output with rounding to nearest. Summed in place over the
// 3499 keys of HuBERT's long form, the truncation reached 7.3e-5 of the
// features' scale after 11 layers on an H100 (2.6e-6 per tile; the SIMT
// kernel this replaces gave 2.0e-6). No split over the keys: at the
// float32 decoder shape the unsplit grid is already faster than SDPA's
// float32 kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

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
attn_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
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

// ------------------------------------------------- wgmma kernel, D 64/128

constexpr int kWgThreads = 160;      // one consumer warpgroup + one producer warp
constexpr int kRegionBytes = 64 * 128;  // 64 rows of one 128-byte column region
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct WgCfg {
  static constexpr int kRegions = D / 64;  // 128-byte column regions per row
  static constexpr int kTile = kRegions * kRegionBytes;  // a Q, K or V tile
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr int kSmem = kTile + kStages * 2 * kTile + 1024;  // + alignment
};

// Q [BH, Tq, D], K/V [BH, Tk, D] through the tensor maps; key tiles
// [tile0, tile0 + tiles) of this block's range. n_splits == 1: out [BH, Tq,
// D] bf16, normalized. Else o_part [n_splits, BH, Tq, D] f32 unnormalized
// and ml_part [n_splits, BH, Tq, 2] (max in the log2 domain, sum).
template <int D>
__global__ void __launch_bounds__(kWgThreads, D == 64 ? 3 : 1)
attn_wgmma_kernel(__grid_constant__ const CUtensorMap tm_q,
                  __grid_constant__ const CUtensorMap tm_k,
                  __grid_constant__ const CUtensorMap tm_v, const uint8_t* __restrict__ mask,
                  bf16* __restrict__ out, float* __restrict__ o_part,
                  float* __restrict__ ml_part, int H, int Tq, int Tk, int n_splits,
                  int tiles_per_split, float scale_log2) {
  typedef WgCfg<D> Cfg;
  constexpr int kS = Cfg::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kS], empty[kS], q_full;
  __shared__ uint32_t mbits[kS][2];  // bit c of word w: key 32w + c of the tile is valid
  unsigned char* sQ = hopper::align1024(smem_raw);
  auto sK = [&](int s) { return sQ + Cfg::kTile + s * 2 * Cfg::kTile; };
  auto sV = [&](int s) { return sK(s) + Cfg::kTile; };

  const int split = blockIdx.x % n_splits, q0 = (blockIdx.x / n_splits) * kBq;
  const int bh = blockIdx.y;
  const int tile0 = split * tiles_per_split;
  const int n_tiles = min(tiles_per_split, (Tk + kBk - 1) / kBk - tile0);  // >= 1

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    hopper::mbar_init(&q_full, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer warp: Q once, then K, V and the mask bits of each tile
    const int lane = threadIdx.x - 128;
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(&q_full, Cfg::kTile);
      for (int r = 0; r < Cfg::kRegions; ++r)
        hopper::tma_load_3d(sQ + r * kRegionBytes, &tm_q, &q_full, 64 * r, q0, bh);
    }
    const uint8_t* mrow = mask ? mask + static_cast<size_t>(bh / H) * Tk : nullptr;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kS;
      const int k0 = (tile0 + i) * kBk;
      const int j0 = k0 + lane, j1 = k0 + 32 + lane;
      const uint32_t w0 = __ballot_sync(0xffffffffu, j0 < Tk && (!mrow || mrow[j0]));
      const uint32_t w1 = __ballot_sync(0xffffffffu, j1 < Tk && (!mrow || mrow[j1]));
      if (lane == 0) {
        hopper::mbar_wait(&empty[s], ((i / kS) & 1) ^ 1);
        mbits[s][0] = w0;
        mbits[s][1] = w1;
        hopper::mbar_arrive_expect_tx(&full[s], 2 * Cfg::kTile);  // releases mbits[s]
        for (int r = 0; r < Cfg::kRegions; ++r) {
          hopper::tma_load_3d(sK(s) + r * kRegionBytes, &tm_k, &full[s], 64 * r, k0, bh);
          hopper::tma_load_3d(sV(s) + r * kRegionBytes, &tm_v, &full[s], 64 * r, k0, bh);
        }
      }
      __syncwarp();
    }
    return;
  }

  // consumer warpgroup: thread holds rows g (r = 0: e = 0, 1) and g + 8
  // (r = 1: e = 2, 3) of its warp's 16, columns 8 ni + 2 qd + (e & 1) of
  // each accumulator (keys in sc, channels in o)
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, qd = lane % 4;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float o[Cfg::kRegions][32];
#pragma unroll
  for (int r = 0; r < Cfg::kRegions; ++r)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[r][i] = 0.f;

  hopper::mbar_wait(&q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kS;
    const int k0 = (tile0 + i) * kBk;
    hopper::mbar_wait(&full[s], (i / kS) & 1);

    float sc[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int off = (ks / 4) * kRegionBytes + (ks % 4) * 32;
      hopper::wgmma_bf16_n64(sc, hopper::desc_sw128(sQ + off), hopper::desc_sw128(sK(s) + off),
                             ks > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operand(sc);

    const uint32_t mb[2] = {mbits[s][0], mbits[s][1]};
    const int lim = Tk - k0;  // keys at or past it are past Tk
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = ni * 8 + 2 * qd + (e & 1);
        const float x = sc[4 * ni + e] * scale_log2;
        sc[4 * ni + e] = col >= lim ? -INFINITY : ((mb[ni / 4] >> (col % 32)) & 1u) ? x : kMasked;
      }

    // online softmax: key k0 < Tk is in the tile, so each row max is finite
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
        mx = fmaxf(mx, fmaxf(sc[4 * ni + 2 * r], sc[4 * ni + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      const float alpha = exp2f(m_run[r] - m_new);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          sc[4 * ni + e] = exp2f(sc[4 * ni + e] - m_new);
          sum += sc[4 * ni + e];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[r] = l_run[r] * alpha + sum;
      m_run[r] = m_new;
#pragma unroll
      for (int rg = 0; rg < Cfg::kRegions; ++rg)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          o[rg][4 * ni + 2 * r] *= alpha;
          o[rg][4 * ni + 2 * r + 1] *= alpha;
        }
    }

    // P.V: the accumulators of key columns 16 kk .. 16 kk + 15 are the A
    // fragment of k-step kk; hi and lo stay untouched until the wait
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split_pair(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1], hi[kk][j], lo[kk][j]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int rg = 0; rg < Cfg::kRegions; ++rg) {
        const uint64_t dv = hopper::desc_sw128(sV(s) + rg * kRegionBytes + kk * 2048);
        hopper::wgmma_bf16_n64_rs_tb(o[rg], hi[kk], dv, 1);
        hopper::wgmma_bf16_n64_rs_tb(o[rg], lo[kk], dv, 1);
      }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int rg = 0; rg < Cfg::kRegions; ++rg) hopper::fence_operand(o[rg]);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);  // K, V and mbits of stage s are read
  }

  const int BH = gridDim.y;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + warp * 16 + g + 8 * r;
    if (t >= Tq) continue;
    if (n_splits == 1) {
      const float l = fmaxf(l_run[r], 1e-30f);
      bf16* orow = out + (static_cast<size_t>(bh) * Tq + t) * D;
#pragma unroll
      for (int rg = 0; rg < Cfg::kRegions; ++rg)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
          *reinterpret_cast<__nv_bfloat162*>(orow + rg * 64 + ni * 8 + 2 * qd) =
              __floats2bfloat162_rn(o[rg][4 * ni + 2 * r] / l, o[rg][4 * ni + 2 * r + 1] / l);
    } else {
      const size_t row = (static_cast<size_t>(split) * BH + bh) * Tq + t;
      float* orow = o_part + row * D;
#pragma unroll
      for (int rg = 0; rg < Cfg::kRegions; ++rg)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
          *reinterpret_cast<float2*>(orow + rg * 64 + ni * 8 + 2 * qd) =
              make_float2(o[rg][4 * ni + 2 * r], o[rg][4 * ni + 2 * r + 1]);
      if (qd == 0) *reinterpret_cast<float2*>(ml_part + 2 * row) = make_float2(m_run[r], l_run[r]);
    }
  }
}

// One warp per (b*h, t) row: the splits' partial results merged in split
// order, normalized once, rounded to bf16.
template <int D>
__global__ void __launch_bounds__(256)
attn_merge_kernel(const float* __restrict__ o_part, const float* __restrict__ ml_part,
                  bf16* __restrict__ out, int rows, int n_splits) {
  constexpr int kPer = D / 32;  // channels per lane, consecutive
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  float m_star = -INFINITY;
  for (int i = 0; i < n_splits; ++i)
    m_star = fmaxf(m_star, ml_part[2 * (static_cast<size_t>(i) * rows + row)]);
  float acc[kPer], l = 0.f;
#pragma unroll
  for (int c = 0; c < kPer; ++c) acc[c] = 0.f;
  for (int i = 0; i < n_splits; ++i) {
    const size_t r = static_cast<size_t>(i) * rows + row;
    const float w = exp2f(ml_part[2 * r] - m_star);
    l += w * ml_part[2 * r + 1];
    const float* orow = o_part + r * D + lane * kPer;
#pragma unroll
    for (int c = 0; c < kPer; ++c) acc[c] += w * orow[c];
  }
  l = fmaxf(l, 1e-30f);
  bf16* dst = out + static_cast<size_t>(row) * D + lane * kPer;
#pragma unroll
  for (int c = 0; c < kPer; c += 2)
    *reinterpret_cast<__nv_bfloat162*>(dst + c) = __floats2bfloat162_rn(acc[c] / l, acc[c + 1] / l);
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* mask, void* out,
                         void* o_part, void* ml_part, int BH, int H, int Tq, int Tk, float scale,
                         int n_splits, int tiles_per_split, cudaStream_t st) {
  typedef WgCfg<D> Cfg;
  const int tiles = (Tk + kBk - 1) / kBk;
  if (n_splits < 1 || tiles_per_split < 1 || (n_splits - 1) * tiles_per_split >= tiles ||
      n_splits * tiles_per_split < tiles || (n_splits > 1 && (!o_part || !ml_part)))
    return cudaErrorInvalidValue;  // an empty range, or keys left over
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const uint64_t t = i == 0 ? Tq : Tk;
    const cudaError_t err = hopper::make_map_3d(
        &maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, bases[i], D, t, BH, D * 2ull, t * D * 2ull,
        64, 64, 1);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(attn_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (err != cudaSuccess) return err;
  const int q_tiles = (Tq + kBq - 1) / kBq;
  attn_wgmma_kernel<D><<<dim3(q_tiles * n_splits, BH), kWgThreads, Cfg::kSmem, st>>>(
      maps[0], maps[1], maps[2], static_cast<const uint8_t*>(mask), static_cast<bf16*>(out),
      static_cast<float*>(o_part), static_cast<float*>(ml_part), H, Tq, Tk, n_splits,
      tiles_per_split, scale * kLog2e);
  if ((err = cudaGetLastError()) != cudaSuccess || n_splits == 1) return err;
  const int rows = BH * Tq;
  attn_merge_kernel<D><<<(rows + 7) / 8, 256, 0, st>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(ml_part),
      static_cast<bf16*>(out), rows, n_splits);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* mask, void* out,
                       int BH, int H, int Tq, int Tk, float scale, cudaStream_t st) {
  attn_mma_kernel<D><<<dim3((Tq + kBq - 1) / kBq, BH), kThreads, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(out), H, Tq, Tk, scale);
  return cudaGetLastError();
}

// ------------------------------------------ float32: tf32 wgmma, D <= 128

// The split operands' padded widths: D to whole 32-float (128-byte) swizzle
// regions, Tk to whole groups of 8 keys (V^T's rows). The wrapper sizes its
// scratch through flash_attention_f32_scratch, which reads these too.
constexpr int f32_padded_d(int D) { return (D + 31) / 32 * 32; }
constexpr int f32_padded_tk(int Tk) { return (Tk + 7) / 8 * 8; }

// tf32(x) rounded to nearest, ties away from zero (cvt.rna.tf32.f32), with
// the 13 bits the tensor cores do not read cleared
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-22 |x|): hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// DP: D padded to the 32-float (128-byte) column regions of the swizzled
// tiles. Two consumer warpgroups share each K/V tile where the stages fit
// beside their Q (DP <= 64), one otherwise; as many stages as fit in 227 KB,
// up to 4. That is 4 at DP 32 and 2 at DP 64, but 1 at DP 96 and 128 (a 96
// or 128 KB stage beside 48 or 64 KB of Q): there the producer loads tile
// i + 1 only once every consumer warp has released tile i, so loads and
// compute do not overlap. No path runs float32 with D > 64 (HuBERT's heads
// are 64 wide).
template <int DP>
struct F32Cfg {
  static constexpr int kWG = DP <= 64 ? 2 : 1;
  static constexpr int kThreads = 128 * kWG + 32;
  static constexpr int kRows = 64 * kWG;                 // query rows per block
  static constexpr int kRegions = DP / 32;               // of a Q or K row
  static constexpr int kQHalf = kRegions * kRegionBytes;  // 64 rows of Q hi (or lo)
  static constexpr int kKHalf = kRegions * kRegionBytes;  // 64 keys of K hi (or lo)
  static constexpr int kVHalf = (kBk / 32) * DP * 128;    // V^T hi (or lo): DP rows, 64 keys
  static constexpr int kStage = 2 * kKHalf + 2 * kVHalf;
  static constexpr int kQ = kWG * 2 * kQHalf;
  static constexpr int kFit = (232448 - 2048 - kQ) / kStage;  // 227 KB, less alignment
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kSmem = kQ + kStages * kStage + 1024;
};

// src [rows, D] -> dst [2][rows, DP]: tf32 hi and lo of each element, zeros
// in the columns D .. DP-1 (n = rows * DP)
template <int DP>
__global__ void split_rows_kernel(const float* __restrict__ src, float* __restrict__ dst,
                                  size_t n, int D) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t row = i / DP;
    const int c = static_cast<int>(i % DP);
    uint32_t hi, lo;
    split_tf32(c < D ? src[row * D + c] : 0.f, hi, lo);
    dst[i] = __uint_as_float(hi);
    dst[n + i] = __uint_as_float(lo);
  }
}

// v [BH, Tk, D] -> dst [2][BH, DP, Tkp]: V^T split into tf32 hi and lo, the
// keys of each group of 8 stored in the order 0, 2, 4, 6, 1, 3, 5, 7 (see
// the P.V step of attn_tf32_kernel), zeros past Tk and past D. A block
// transposes 32 keys x 32 channels through shared memory.
__global__ void __launch_bounds__(256)
split_vt_kernel(const float* __restrict__ v, float* __restrict__ dst, int Tk, int Tkp, int D,
                int DP) {
  __shared__ float tile[32][33];
  const int bh = blockIdx.z, p0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int r = ty; r < 32; r += 8) {
    const int key = p0 + r, c = c0 + tx;
    tile[r][tx] = key < Tk && c < D ? v[(static_cast<size_t>(bh) * Tk + key) * D + c] : 0.f;
  }
  __syncthreads();
  const int j = tx & 7, key = (tx & ~7) + (j < 4 ? 2 * j : 2 * j - 7);
  const size_t half = static_cast<size_t>(gridDim.z) * DP * Tkp;
  for (int r = ty; r < 32; r += 8) {
    const int c = c0 + r, p = p0 + tx;
    if (p >= Tkp) continue;
    uint32_t hi, lo;
    split_tf32(tile[key][r], hi, lo);
    const size_t i = (static_cast<size_t>(bh) * DP + c) * Tkp + p;
    dst[i] = __uint_as_float(hi);
    dst[half + i] = __uint_as_float(lo);
  }
}

// The float32 attention on tf32 tensor cores, three passes per product:
// x y ~ hi hi' + hi lo' + lo hi' (the dropped lo lo' is under 2^-22 |x y|).
// Q, K and V^T come split from the prologue launches ([hi; lo] stacked on
// the head axis of each tensor map: coordinate bh + half * BH). A block is
// kWG consumer warpgroups of 64 query rows and one producer warp that loads
// Q once and streams 64-key tiles of K hi/lo and V^T hi/lo through the ring.
// S = Q K^T is three wgmma per 8-channel k-step from shared Q and K (both
// K-major). P.V: tf32 wgmma reads B K-major only, hence V^T (keys along the
// row); the score accumulators of key group kk (thread: rows g, g + 8; keys
// 2c, 2c + 1) are the A fragment of k-step kk (k indices c, c + 4) once the
// keys of each group of 8 are stored in the order 0, 2, 4, 6, 1, 3, 5, 7,
// so P, split into tf32 hi + lo in registers, feeds the product unshuffled.
// Masking and the log2-domain online softmax are the bf16 kernel's.
template <int DP>
__global__ void __launch_bounds__(F32Cfg<DP>::kThreads, 1)
attn_tf32_kernel(__grid_constant__ const CUtensorMap tm_q,
                 __grid_constant__ const CUtensorMap tm_k,
                 __grid_constant__ const CUtensorMap tm_v, const uint8_t* __restrict__ mask,
                 float* __restrict__ out, int H, int Tq, int Tk, int D, float scale_log2) {
  typedef F32Cfg<DP> Cfg;
  constexpr int kS = Cfg::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kS], empty[kS], q_full;
  __shared__ uint32_t mbits[kS][2];  // bit c of word w: key 32w + c of the tile is valid
  // Q: [warpgroup][hi, lo][region][64 rows x 128 B]; a stage: K [hi, lo][region]
  // [64 keys x 128 B], then V^T [hi, lo][key region][DP rows x 128 B]
  unsigned char* sQ = hopper::align1024(smem_raw);
  auto sK = [&](int s) { return sQ + Cfg::kQ + s * Cfg::kStage; };
  auto sV = [&](int s) { return sK(s) + 2 * Cfg::kKHalf; };

  const int q0 = blockIdx.x * Cfg::kRows, bh = blockIdx.y, BH = gridDim.y;
  const int n_tiles = (Tk + kBk - 1) / kBk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * Cfg::kWG);  // one arrival per consumer warp
    }
    hopper::mbar_init(&q_full, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * Cfg::kWG) {
    const int lane = threadIdx.x - 128 * Cfg::kWG;
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(&q_full, Cfg::kQ);
      for (int wg = 0; wg < Cfg::kWG; ++wg)
        for (int half = 0; half < 2; ++half)
          for (int r = 0; r < Cfg::kRegions; ++r)
            hopper::tma_load_3d(sQ + (2 * wg + half) * Cfg::kQHalf + r * kRegionBytes, &tm_q,
                                &q_full, 32 * r, q0 + 64 * wg, bh + half * BH);
    }
    const uint8_t* mrow = mask ? mask + static_cast<size_t>(bh / H) * Tk : nullptr;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kS;
      const int k0 = i * kBk;
      const int j0 = k0 + lane, j1 = k0 + 32 + lane;
      const uint32_t w0 = __ballot_sync(0xffffffffu, j0 < Tk && (!mrow || mrow[j0]));
      const uint32_t w1 = __ballot_sync(0xffffffffu, j1 < Tk && (!mrow || mrow[j1]));
      if (lane == 0) {
        hopper::mbar_wait(&empty[s], ((i / kS) & 1) ^ 1);
        mbits[s][0] = w0;
        mbits[s][1] = w1;
        hopper::mbar_arrive_expect_tx(&full[s], Cfg::kStage);  // releases mbits[s]
        for (int half = 0; half < 2; ++half) {
          for (int r = 0; r < Cfg::kRegions; ++r)
            hopper::tma_load_3d(sK(s) + half * Cfg::kKHalf + r * kRegionBytes, &tm_k, &full[s],
                                32 * r, k0, bh + half * BH);
          for (int j = 0; j < kBk / 32; ++j)
            hopper::tma_load_3d(sV(s) + half * Cfg::kVHalf + j * DP * 128, &tm_v, &full[s],
                                k0 + 32 * j, 0, bh + half * BH);
        }
      }
      __syncwarp();
    }
    return;
  }

  // consumer warpgroup wg: thread holds rows g (r = 0: e = 0, 1) and g + 8
  // (r = 1: e = 2, 3) of its warp's 16, columns 8 ni + 2 qd + (e & 1) of
  // each accumulator (keys in sc, channels 32 c + column in o[c])
  const int tid = threadIdx.x % 128, wg = threadIdx.x / 128, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, qd = lane % 4;
  const unsigned char* q_hi = sQ + 2 * wg * Cfg::kQHalf;
  const unsigned char* q_lo = q_hi + Cfg::kQHalf;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float o[Cfg::kRegions][16];
#pragma unroll
  for (int c = 0; c < Cfg::kRegions; ++c)
#pragma unroll
    for (int i = 0; i < 16; ++i) o[c][i] = 0.f;

  hopper::mbar_wait(&q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kS;
    const int k0 = i * kBk;
    hopper::mbar_wait(&full[s], (i / kS) & 1);
    const unsigned char* k_hi = sK(s);
    const unsigned char* k_lo = k_hi + Cfg::kKHalf;

    // the tensor cores truncate each k-step's sum to float32, so the small
    // cross terms go in first, while the sum is small, and hi hi' last
    float sc[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int pass = 0; pass < 3; ++pass)
#pragma unroll
      for (int ks = 0; ks < DP / 8; ++ks) {
        const int off = (ks / 4) * kRegionBytes + (ks % 4) * 32;
        hopper::wgmma_tf32_n64(sc, hopper::desc_sw128((pass == 1 ? q_lo : q_hi) + off),
                               hopper::desc_sw128((pass == 0 ? k_lo : k_hi) + off),
                               pass > 0 || ks > 0);
      }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operand(sc);

    const uint32_t mb[2] = {mbits[s][0], mbits[s][1]};
    const int lim = Tk - k0;  // keys at or past it are past Tk
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = ni * 8 + 2 * qd + (e & 1);
        const float x = sc[4 * ni + e] * scale_log2;
        sc[4 * ni + e] = col >= lim ? -INFINITY : ((mb[ni / 4] >> (col % 32)) & 1u) ? x : kMasked;
      }

    // online softmax: key k0 < Tk is in the tile, so each row max is finite
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
        mx = fmaxf(mx, fmaxf(sc[4 * ni + 2 * r], sc[4 * ni + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      const float alpha = exp2f(m_run[r] - m_new);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          sc[4 * ni + e] = exp2f(sc[4 * ni + e] - m_new);
          sum += sc[4 * ni + e];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[r] = l_run[r] * alpha + sum;
      m_run[r] = m_new;
#pragma unroll
      for (int c = 0; c < Cfg::kRegions; ++c)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          o[c][4 * ni + 2 * r] *= alpha;
          o[c][4 * ni + 2 * r + 1] *= alpha;
        }
    }

    // P.V: k-step kk takes keys 8 kk .. 8 kk + 7, stored in V^T as 0, 2, 4,
    // 6, 1, 3, 5, 7, so k index qd is key 2 qd (accumulator e = 0 / 2 for
    // rows g / g + 8) and k index qd + 4 is key 2 qd + 1 (e = 1 / 3); hi and
    // lo stay untouched until the last wait
    uint32_t hi[8][4], lo[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      split_tf32(sc[4 * kk + 0], hi[kk][0], lo[kk][0]);
      split_tf32(sc[4 * kk + 2], hi[kk][1], lo[kk][1]);
      split_tf32(sc[4 * kk + 1], hi[kk][2], lo[kk][2]);
      split_tf32(sc[4 * kk + 3], hi[kk][3], lo[kk][3]);
    }
    // The tile's product goes into fresh accumulators t, cross terms first,
    // and is added to o in float32 (round to nearest): summed in the tensor
    // cores' accumulators across the tiles, every k-step would truncate the
    // running sum (two 32-channel regions at a time where their count is
    // even, to bound registers; one at a time at DP = 32 and 96)
    const unsigned char* v_hi = sV(s);
    const unsigned char* v_lo = v_hi + Cfg::kVHalf;
    constexpr int kPair = Cfg::kRegions % 2 ? 1 : 2;
    static_assert(Cfg::kRegions % kPair == 0, "P.V's chunks must tile the channel regions");
#pragma unroll
    for (int c0 = 0; c0 < Cfg::kRegions; c0 += kPair) {
      float t[kPair][16];
      hopper::wgmma_fence();
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
#pragma unroll
          for (int j = 0; j < kPair; ++j) {
            const int off = (kk / 4) * DP * 128 + (kk % 4) * 32 + (c0 + j) * 32 * 128;
            hopper::wgmma_tf32_n32_rs(t[j], pass == 1 ? lo[kk] : hi[kk],
                                      hopper::desc_sw128((pass == 0 ? v_lo : v_hi) + off),
                                      pass > 0 || kk > 0);
          }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < kPair; ++j) {
        hopper::fence_operand(t[j]);
#pragma unroll
        for (int i = 0; i < 16; ++i) o[c0 + j][i] += t[j][i];
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);  // K, V^T and mbits of stage s are read
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + 64 * wg + warp * 16 + g + 8 * r;
    if (t >= Tq) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
    float* orow = out + (static_cast<size_t>(bh) * Tq + t) * D;
#pragma unroll
    for (int c = 0; c < Cfg::kRegions; ++c)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 32 * c + 8 * ni + 2 * qd + e;
          if (col < D) orow[col] = o[c][4 * ni + 2 * r + e] / l;
        }
  }
}

template <int DP>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, const void* mask, void* out,
                        float* qs, float* ks, float* vts, int BH, int H, int Tq, int Tk, int D,
                        float scale, cudaStream_t st) {
  typedef F32Cfg<DP> Cfg;
  static_assert(DP % 32 == 0, "DP is D padded to whole 32-float regions");
  const int Tkp = f32_padded_tk(Tk);
  const size_t nq = static_cast<size_t>(BH) * Tq * DP, nk = static_cast<size_t>(BH) * Tk * DP;
  split_rows_kernel<DP><<<static_cast<int>(std::min<size_t>((nq + 255) / 256, 4096)), 256, 0,
                          st>>>(static_cast<const float*>(q), qs, nq, D);
  split_rows_kernel<DP><<<static_cast<int>(std::min<size_t>((nk + 255) / 256, 4096)), 256, 0,
                          st>>>(static_cast<const float*>(k), ks, nk, D);
  split_vt_kernel<<<dim3((Tkp + 31) / 32, DP / 32, BH), dim3(32, 8), 0, st>>>(
      static_cast<const float*>(v), vts, Tk, Tkp, D, DP);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap maps[3];
  const uint64_t tq = Tq, tk = Tk, tkp = Tkp, dp = DP;
  if ((err = hopper::make_map_3d(&maps[0], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, qs, dp, tq, 2 * BH,
                                 dp * 4, tq * dp * 4, 32, 64, 1)) != cudaSuccess ||
      (err = hopper::make_map_3d(&maps[1], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ks, dp, tk, 2 * BH,
                                 dp * 4, tk * dp * 4, 32, 64, 1)) != cudaSuccess ||
      (err = hopper::make_map_3d(&maps[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, vts, tkp, dp, 2 * BH,
                                 tkp * 4, dp * tkp * 4, 32, DP, 1)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(attn_tf32_kernel<DP>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem)) !=
      cudaSuccess)
    return err;
  attn_tf32_kernel<DP><<<dim3((Tq + Cfg::kRows - 1) / Cfg::kRows, BH), Cfg::kThreads, Cfg::kSmem,
                         st>>>(maps[0], maps[1], maps[2], static_cast<const uint8_t*>(mask),
                               static_cast<float*>(out), H, Tq, Tk, D, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// q [BH, Tq, D], k/v [BH, Tk, D], out [BH, Tq, D], bf16, contiguous and
// 16-byte aligned, with BH = B * H; mask [B, Tk] bytes (nonzero = valid) or
// null (every key valid). D in {32, 64, 96, 128}. For D 64/128 the 64-key
// tiles are cut into n_splits ranges of tiles_per_split (the last may be
// shorter, none empty); n_splits > 1 needs the scratch o_part f32
// [n_splits, BH, Tq, D] and ml_part f32 [n_splits, BH, Tq, 2]. D 32/96 take
// n_splits 1. Launches on `stream`; returns the first non-zero
// cudaError_t, else 0.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, void* o_part, void* ml_part,
                                    int BH, int H, int Tq, int Tk, int D, float scale,
                                    int n_splits, int tiles_per_split, void* stream) {
  if (BH <= 0 || H <= 0 || BH % H != 0 || Tq <= 0 || Tk <= 0 || BH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((D == 32 || D == 96) && n_splits != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 32: return static_cast<int>(launch_mma<32>(q, k, v, mask, out, BH, H, Tq, Tk, scale, st));
    case 96: return static_cast<int>(launch_mma<96>(q, k, v, mask, out, BH, H, Tq, Tk, scale, st));
    case 64:
      return static_cast<int>(launch_wgmma<64>(q, k, v, mask, out, o_part, ml_part, BH, H, Tq, Tk,
                                               scale, n_splits, tiles_per_split, st));
    case 128:
      return static_cast<int>(launch_wgmma<128>(q, k, v, mask, out, o_part, ml_part, BH, H, Tq,
                                                Tk, scale, n_splits, tiles_per_split, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

static bool f32_args_ok(int BH, int H, int Tq, int Tk, int D) {
  return BH > 0 && H > 0 && BH % H == 0 && Tq > 0 && Tk > 0 && BH <= 65535 && D > 0 && D <= 128;
}

// The element counts of flash_attention_f32's scratch for these shapes, into
// counts[0..2]: qs [2, BH, Tq, DP], ks [2, BH, Tk, DP] and vts [2, BH, DP,
// Tkp], with DP = f32_padded_d(D) and Tkp = f32_padded_tk(Tk). Returns
// cudaErrorInvalidValue where flash_attention_f32 would refuse the shapes.
extern "C" int flash_attention_f32_scratch(int BH, int H, int Tq, int Tk, int D,
                                           long long* counts) {
  if (!f32_args_ok(BH, H, Tq, Tk, D) || !counts) return static_cast<int>(cudaErrorInvalidValue);
  const long long dp = f32_padded_d(D);
  counts[0] = 2LL * BH * Tq * dp;
  counts[1] = 2LL * BH * Tk * dp;
  counts[2] = 2LL * BH * dp * f32_padded_tk(Tk);
  return 0;
}

// The same as flash_attention_bf16 for float32 tensors, 1 <= D <= 128, on
// tf32 tensor cores in three passes, with no split over the keys. The
// scratch qs, ks and vts (f32, 16-byte aligned, of the element counts that
// flash_attention_f32_scratch gives) take the split operands.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, void* qs, void* ks, void* vts,
                                   int BH, int H, int Tq, int Tk, int D, float scale,
                                   void* stream) {
  if (!f32_args_ok(BH, H, Tq, Tk, D) || !qs || !ks || !vts)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t (*launch)(const void*, const void*, const void*, const void*, void*, float*,
                        float*, float*, int, int, int, int, int, float, cudaStream_t);
  switch (f32_padded_d(D)) {
    case 32: launch = launch_tf32<32>; break;
    case 64: launch = launch_tf32<64>; break;
    case 96: launch = launch_tf32<96>; break;
    default: launch = launch_tf32<128>;
  }
  const cudaError_t err = launch(q, k, v, mask, out, static_cast<float*>(qs),
                                 static_cast<float*>(ks), static_cast<float*>(vts), BH, H, Tq, Tk,
                                 D, scale, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
