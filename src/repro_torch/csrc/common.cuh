// Shared device helpers of the port's kernels.
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
// Output rows (features of a tile) one thread accumulates in registers at once
// (repro_torch/kernels/_build.py::KROWS sizes shared memory with it).
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

// next_position: decode_position of p + 1 from that of p, without a
// division: ow steps by one and wraps to the next output row, oh wraps to
// the next batch.  Past the end bb keeps counting, so bb < g.b is
// decode_position's in-range test.
__device__ __forceinline__ void next_position(const ConvGeom& g, int& bb, int& ih0, int& iw0) {
  iw0 += g.stride;
  if (iw0 > (g.wo - 1) * g.stride - g.pad) {
    iw0 = -g.pad;
    ih0 += g.stride;
    if (ih0 > (g.ho - 1) * g.stride - g.pad) {
      ih0 = -g.pad;
      ++bb;
    }
  }
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

// Asynchronous global -> shared copies (sm_80+ cp.async).  A thread's copies
// land once it has waited for their group; a __syncthreads() after the wait
// makes every thread's copies visible to the block.  Both addresses must be
// aligned to the copy's size.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}
__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem_src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// A 16-byte copy that lands as zeros where ``valid`` is false: the source
// size is then 0 and nothing is read (gmem_src must still be a mapped
// address of the same tensor).
__device__ __forceinline__ void cp_async16_zfill(void* smem_dst, const void* gmem_src,
                                                 bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const unsigned src_size = valid ? 16u : 0u;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src),
               "r"(src_size));
}
// The 4-byte form, through L1 (a gather that reads neighbouring taps again).
__device__ __forceinline__ void cp_async4_zfill(void* smem_dst, const void* gmem_src, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const unsigned src_size = valid ? 4u : 0u;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem_src),
               "r"(src_size));
}

// Four consecutive values of a shared-memory row as f32: one 16-byte load
// (f32) or one 8-byte load (bf16).  p must be aligned to the load's size.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

// Four consecutive outputs, each rounded once from its f32 value.
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 lo, hi;
  lo.x = from_f32<__nv_bfloat16>(v[0]);
  lo.y = from_f32<__nv_bfloat16>(v[1]);
  hi.x = from_f32<__nv_bfloat16>(v[2]);
  hi.y = from_f32<__nv_bfloat16>(v[3]);
  uint2 q;
  q.x = *reinterpret_cast<const unsigned*>(&lo);
  q.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = q;
}

// 1, 2, 4 or 8 consecutive values of a shared-memory row as f32; p aligned to
// the load.
__device__ __forceinline__ void load_cols(const float* p, float (&v)[4]) { load4(p, v); }
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p, float (&v)[4]) {
  load4(p, v);
}
__device__ __forceinline__ void load_cols(const float* p, float (&v)[2]) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  v[0] = q.x;
  v[1] = q.y;
}
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p, float (&v)[2]) {
  const float2 q = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  v[0] = q.x;
  v[1] = q.y;
}
template <typename T>
__device__ __forceinline__ void load_cols(const T* p, float (&v)[1]) {
  v[0] = to_f32(*p);
}
template <typename T>
__device__ __forceinline__ void load_cols(const T* p, float (&v)[8]) {
  float a[4], b[4];
  load4(p, a);
  load4(p + 4, b);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[q] = a[q];
    v[4 + q] = b[q];
  }
}

// The 8 staged values of one kept row for a thread's 8 output rows, as f32:
// two broadcast 16-byte loads (f32) or one (bf16, widened exactly).
__device__ __forceinline__ void load_rows(const float* p, float (&w)[kRows]) {
  float a[4], b[4];
  load4(p, a);
  load4(p + 4, b);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    w[q] = a[q];
    w[4 + q] = b[q];
  }
}
__device__ __forceinline__ void load_rows(const __nv_bfloat16* p, float (&w)[kRows]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const unsigned words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[i]));
    w[2 * i] = f.x;
    w[2 * i + 1] = f.y;
  }
}

// 1, 2, 4 or 8 consecutive outputs, each rounded once from its f32 value.
template <typename T>
__device__ __forceinline__ void store_cols(T* p, const float (&v)[4]) {
  store4(p, v);
}
__device__ __forceinline__ void store_cols(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store_cols(__nv_bfloat16* p, const float (&v)[2]) {
  __nv_bfloat162 q;
  q.x = from_f32<__nv_bfloat16>(v[0]);
  q.y = from_f32<__nv_bfloat16>(v[1]);
  *reinterpret_cast<__nv_bfloat162*>(p) = q;
}
template <typename T>
__device__ __forceinline__ void store_cols(T* p, const float (&v)[1]) {
  *p = from_f32<T>(v[0]);
}
template <typename T>
__device__ __forceinline__ void store_cols(T* p, const float (&v)[8]) {
  store4(p, {v[0], v[1], v[2], v[3]});
  store4(p + 4, {v[4], v[5], v[6], v[7]});
}

// Launch-time check shared by the entry points: a kernel that needs more
// than the default 48 KB of dynamic shared memory must opt in first.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro
