// Fused im2col + pack (paper Algorithm 2) for Hopper.
//
// Replaces: src/repro/kernels/im2col_pack/kernel.py::im2col_pack_pallas
// (_kernel), the TPU kernel that emits a [c_block, V] strip tile per grid
// step from a VMEM-resident block of the CNHW map.
//
// Computes strips[s, r, j] = x[c, bb, ih, iw] for r = (ikh*kw + ikw)*C + c and
// output position p = s*V + j, or 0 where the tap is off the map or p is past
// the last position (the ragged last strip).  An exact copy: the element bits
// are moved, never converted, so the result is bit-identical to the plain
// version for every dtype.
//
// Bound: bytes.  It does no arithmetic beyond index math; it reads each map
// element once per tap that touches it and writes every strip element once.
// Design: one block per strip row (s, r), its threads along j, so the stores
// of a warp are 128 consecutive bytes (f32) and the loads follow the map's
// contiguous W axis (stride 1) or every other element (stride 2).  The
// validity test runs before the load, so an off-map tap is never read.
#include "common.cuh"

namespace {

template <typename E>  // E holds the element's bits: uint32_t (f32) or uint16_t (bf16)
__global__ void __launch_bounds__(repro::kThreads)
im2col_pack_kernel(const E* __restrict__ x, E* __restrict__ out, repro::ConvGeom g) {
  const int k_rows = g.kh * g.kw * g.c;
  const int row = blockIdx.x;  // s * k_rows + r
  const int s = row / k_rows;
  const int r = row - s * k_rows;
  const int tap = r / g.c;
  const int ch = r - tap * g.c;
  const int ikh = tap / g.kw;
  const int ikw = tap - ikh * g.kw;
  const E* xc = x + static_cast<long long>(ch) * g.b * g.h * g.w;
  E* o = out + static_cast<long long>(row) * g.v;
  for (int j = threadIdx.x; j < g.v; j += blockDim.x) {
    int bb, ih, iw;
    E val = 0;
    if (repro::tap_coords(s * g.v + j, ikh, ikw, g, bb, ih, iw)) {
      val = xc[(static_cast<long long>(bb) * g.h + ih) * g.w + iw];
    }
    o[j] = val;
  }
}

}  // namespace

// x: [c, b, h, w] contiguous; out: [n_strips, kh*kw*c, v] contiguous.
extern "C" int repro_im2col_pack(const void* x, void* out, int elem_bytes, int c, int b,
                                 int h, int w, int kh, int kw, int stride, int pad,
                                 int ho, int wo, int v, int n_strips, void* stream) {
  const repro::ConvGeom g{c, b, h, w, kh, kw, stride, pad, ho, wo, v, n_strips};
  const long long rows = static_cast<long long>(n_strips) * kh * kw * c;
  if (rows <= 0 || rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(rows));
  if (elem_bytes == 4) {
    im2col_pack_kernel<uint32_t><<<grid, repro::kThreads, 0, st>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), g);
  } else if (elem_bytes == 2) {
    im2col_pack_kernel<uint16_t><<<grid, repro::kThreads, 0, st>>>(
        static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), g);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
