// Fused RMSNorm + FiLM for the DDIM denoiser's adaptive norms, bf16 or
// float32 (x, film and the output share one type).
//
// Replaces diffnorm_tpu/ops/pallas_norm.py:rms_norm_film (_norm_film_kernel).
// Computes, for x [B, T, C] and film [B, 2C] (gamma ++ beta):
//     y = x * rsqrt(max(sum(x^2), eps^2)) * sqrt(C) * gamma_b + beta_b
// in f32, written in x's type.
//
// Bound on an H100: bytes. Each element takes a handful of f32 operations
// against 4 bytes of traffic (read x, write y), far below the ~295 operations
// per byte where the tensor cores would be the limit. At [64, 128, 512] the
// call moves 16.9 MB, 5.0 us at 3.35 TB/s.
//
// Design: one warp per (b, t) row, 16-byte vector loads and stores, the sum
// of squares reduced with warp shuffles (no shared memory, no second launch).
// The row is read a second time for the output; that read hits L1, so device
// memory still sees one read and one write of x. The TPU kernel tiled the
// per-batch film to 8 sublanes; here each warp reads its row's gamma/beta
// directly (row / T picks the batch row). The float32 instantiation runs the
// same code with two 16-byte accesses per 8 values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kVec = 8;  // values per vector access (16 bytes of bf16, 32 of float32)

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[kVec]) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) {
    float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float v[kVec]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// y[j] = (v[j] * inv) * g[j] + b[j], written as 8 values of the output type
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[kVec], float inv,
                                       const float g[kVec], const float b[kVec]) {
  uint4 packed;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j)
    o[j] = __floats2bfloat162_rn((v[2 * j] * inv) * g[2 * j] + b[2 * j],
                                 (v[2 * j + 1] * inv) * g[2 * j + 1] +
                                     b[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = packed;
}

__device__ __forceinline__ void store8(float* p, const float v[kVec], float inv,
                                       const float g[kVec], const float b[kVec]) {
  float y[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) y[j] = (v[j] * inv) * g[j] + b[j];
  *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(y[4], y[5], y[6], y[7]);
}

template <typename Elem>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rms_norm_film_kernel(const Elem* __restrict__ x, const Elem* __restrict__ film,
                     Elem* __restrict__ out, int rows, int T, int C,
                     float scale, float eps2) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const Elem* xr = x + static_cast<size_t>(row) * C;

  float ss = 0.f;
  for (int c = lane * kVec; c < C; c += 32 * kVec) {
    float v[kVec];
    load8(xr + c, v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) ss += v[j] * v[j];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = rsqrtf(fmaxf(ss, eps2)) * scale;

  const Elem* gamma = film + static_cast<size_t>(row / T) * 2 * C;
  const Elem* beta = gamma + C;
  Elem* yr = out + static_cast<size_t>(row) * C;
  for (int c = lane * kVec; c < C; c += 32 * kVec) {
    float v[kVec], g[kVec], b[kVec];
    load8(xr + c, v);
    load8(gamma + c, g);
    load8(beta + c, b);
    store8(yr + c, v, inv, g, b);
  }
}

template <typename Elem>
int launch(const void* x, const void* film, void* out, int rows, int T, int C, float eps,
           void* stream) {
  if (rows <= 0 || T <= 0 || C <= 0 || C % kVec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  rms_norm_film_kernel<Elem><<<grid, kWarpsPerBlock * 32, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Elem*>(x), static_cast<const Elem*>(film),
      static_cast<Elem*>(out), rows, T, C, sqrtf(static_cast<float>(C)), eps * eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: [rows = B*T, C]; film: [B, 2C]; all bf16 (rms_norm_film_bf16) or
// all float32 (rms_norm_film_f32), contiguous and 16-byte aligned, C a
// multiple of 8. Launches on `stream`; returns the cudaError_t of the launch
// (0 on success).
extern "C" int rms_norm_film_bf16(const void* x, const void* film, void* out,
                                  int rows, int T, int C, float eps,
                                  void* stream) {
  return launch<__nv_bfloat16>(x, film, out, rows, T, C, eps, stream);
}

extern "C" int rms_norm_film_f32(const void* x, const void* film, void* out,
                                 int rows, int T, int C, float eps,
                                 void* stream) {
  return launch<float>(x, film, out, rows, T, C, eps, stream);
}
