// The int8 W8A8 feed-forward sublayer, x + FF(normFiLM(x)), bf16 in and out.
//
// Replaces diffnorm_tpu/ops/pallas_ffpipe.py:ffpipe_layer (_ffpipe_kernel)
// and its two-row twin _ffpipe_layer2 (_ffpipe_kernel2). The kernels and
// their design are in int8_ff.cuh; this file is the C entry point that
// ops/ffpipe.py loads with ctypes.

#include "int8_ff.cuh"

// x, out [B, T, C] bf16; film [B, 2C] f32, or bf16 if film_bf16; the
// packed weights of ops/ffpipe.py:pack_ff_weights; scratch q int8 [B*T,
// max(C, P)], a f32 [B*T], g bf16 [B*T, P], y f32 [B*T, P]. All contiguous and 16-byte
// aligned, C % 64 == 0, P % 64 == 0, rows 1 or 2. The conv output is
// requantized from f32, as pallas_ffpipe.py does. Every launch goes on
// `stream`; returns the first non-zero cudaError_t, else 0.
extern "C" int int8_ff_bf16(const void* x, const void* film, const void* wxq,
                            const void* wxs, const void* bx, const void* wgq,
                            const void* wgs, const void* bg, const void* wcq,
                            const void* wcs, const void* bc, const void* wfq,
                            const void* wfs, const void* bf, void* q, void* a,
                            void* g, void* y, void* out, int B, int T, int C, int P,
                            int rows, int film_bf16, void* stream) {
  const ff::FFWeights w = {
      static_cast<const int8_t*>(wxq), static_cast<const int8_t*>(wgq),
      static_cast<const int8_t*>(wcq), static_cast<const int8_t*>(wfq),
      static_cast<const float*>(wxs),  static_cast<const float*>(wgs),
      static_cast<const float*>(wcs),  static_cast<const float*>(wfs),
      static_cast<const float*>(bx),   static_cast<const float*>(bg),
      static_cast<const float*>(bc),   static_cast<const float*>(bf)};
  const ff::FFScratch s = {static_cast<int8_t*>(q), static_cast<float*>(a),
                           static_cast<ff::bf16*>(g), y};
  return static_cast<int>(ff::launch_ff(
      static_cast<const ff::bf16*>(x), film, film_bf16 != 0, w, s,
      static_cast<ff::bf16*>(out), B, T, C, P, /*round_y=*/false, rows,
      static_cast<cudaStream_t>(stream)));
}
