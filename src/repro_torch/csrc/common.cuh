// Shared device helpers of the port's conv kernels.
//
// tap_coords() is the im2col index arithmetic of
// repro_torch/kernels/im2col_pack/kernel.py::tap_coords (itself the twin of
// the JAX package's kernels/im2col_pack/kernel.py::tap_coords): the plain
// PyTorch versions and these kernels compute the same source coordinates, so
// stride, padding and the ragged last strip cannot drift between them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// dtype codes passed from Python (repro_torch/kernels/_build.py::DTYPE_CODE)
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;

// Threads of one block: each owns output columns j, j + kThreads, ... of a strip.
constexpr int kThreads = 128;
// Output rows (features of a tile) one thread accumulates in registers at once.
constexpr int kRows = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as PyTorch's .to(bfloat16)
}

// Geometry of one convolution over a CNHW map [c, b, h, w] with output
// positions p = (batch, oh, ow) flattened, packed into n_strips strips of v.
struct ConvGeom {
  int c, b, h, w;
  int kh, kw, stride, pad;
  int ho, wo;
  int v, n_strips;
};

// The tap_coords rule in two steps, so a kernel that visits many taps of one
// position decodes the position once.
//
// decode_position: batch bb of output position p and the map coordinates
// (ih0, iw0) of its (0, 0) tap.  Returns false for a position past the end
// (the ragged last strip).
__device__ __forceinline__ bool decode_position(int p, const ConvGeom& g, int& bb, int& ih0,
                                                int& iw0) {
  const int hw = g.ho * g.wo;
  bb = p / hw;
  const int rem = p - bb * hw;
  const int oh = rem / g.wo;
  const int ow = rem - oh * g.wo;
  ih0 = oh * g.stride - g.pad;
  iw0 = ow * g.stride - g.pad;
  return p < g.b * hw;
}

// tap_shift: map coordinates of tap (ikh, ikw) of a decoded position.
// Returns false for an off-map tap.
__device__ __forceinline__ bool tap_shift(int ih0, int iw0, int ikh, int ikw, const ConvGeom& g,
                                          int& ih, int& iw) {
  ih = ih0 + ikh;
  iw = iw0 + ikw;
  return ih >= 0 && ih < g.h && iw >= 0 && iw < g.w;
}

// Source coordinates of output position p at kernel tap (ikh, ikw).  Returns
// false for an off-map tap or a position past the end; the coordinates are
// then meaningless and must not be read.
__device__ __forceinline__ bool tap_coords(int p, int ikh, int ikw, const ConvGeom& g,
                                           int& bb, int& ih, int& iw) {
  int ih0, iw0;
  const bool in_range = decode_position(p, g, bb, ih0, iw0);
  return tap_shift(ih0, iw0, ikh, ikw, g, ih, iw) && in_range;
}

__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fc00000); }

// Launch-time check shared by the entry points: a kernel that needs more
// than the default 48 KB of dynamic shared memory must opt in first.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro
