// Fused im2col + pack + column-wise N:M sparse GEMM conv for Hopper.
//
// Replaces: src/repro/kernels/conv_gemm/kernel.py::conv2d_fused_pallas
// (_kernel), the TPU megakernel that keeps the whole CNHW map in VMEM and
// gathers each kept (kh, kw, c) row of a strip from it.
//
// Computes out[t*T + f, s*V + j] = sum_k values[t, k, f] * X[idx[t, k], s*V + j]
// where X is the im2col matrix of the CNHW map x (row r = (ikh*kw + ikw)*C + c,
// column p = (batch, oh, ow)), zero off the map and past the last position.
// float32 accumulation; f32 or bf16 operands; output in the operands' dtype.
//
// Bound: bytes.  The map is read, the small weight is read, and the output
// [O, S*V] is written once; the packed strips never reach device memory, which
// is the point of fusing.  At T = 8 rows per tile there are about 4 FLOP per
// f32 byte, below the ~20 FLOP/byte f32 ridge.  Design: the TPU kept the whole
// map resident in VMEM; a Hopper block has at most 227 KB of shared memory,
// far less than a batch-256 map, so this kernel gathers straight from device
// memory through the 50 MB L2, which holds the map (1-4 MB on the main path)
// while the S x n_tiles blocks re-read it.  One block per (strip s, tile t):
// it stages values[t] and the decoded (channel offset, ikh, ikw) of each kept
// row in shared memory, block_k rows at a time; each thread owns output
// column j, decodes its position (batch, oh, ow) once, and keeps kRows f32
// accumulators in registers.  Neighbouring threads read neighbouring ow, so
// the gathers coalesce along the map's W axis.  An index outside [0, K)
// contributes NaN instead of reading out of bounds.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(repro::kThreads)
conv2d_fused_kernel(const T* __restrict__ x, const T* __restrict__ values,
                    const int* __restrict__ idx, T* __restrict__ out, repro::ConvGeom g,
                    int k_kept, int tile, int block_k) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* s_off = reinterpret_cast<long long*>(smem);     // [block_k] channel offset
  float* s_val = reinterpret_cast<float*>(s_off + block_k);  // [block_k, tile]
  int* s_kh = reinterpret_cast<int*>(s_val + block_k * tile);  // [block_k], -1: bad index
  int* s_kw = s_kh + block_k;                                // [block_k]
  const int s = blockIdx.x;
  const int t = blockIdx.y;
  const int k_rows = g.kh * g.kw * g.c;
  const long long plane = static_cast<long long>(g.b) * g.h * g.w;  // one channel of x
  const T* vals_t = values + static_cast<long long>(t) * k_kept * tile;
  const int* idx_t = idx + static_cast<long long>(t) * k_kept;
  const long long out_ld = static_cast<long long>(g.n_strips) * g.v;

  for (int j0 = 0; j0 < g.v; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    // the position is decoded once; tap_shift moves it per kept row
    int bb, ih0, iw0;
    const bool in_range = repro::decode_position(s * g.v + j, g, bb, ih0, iw0) && j < g.v;
    const T* xb = x + static_cast<long long>(bb) * g.h * g.w;
    for (int f0 = 0; f0 < tile; f0 += repro::kRows) {
      float acc[repro::kRows];
#pragma unroll
      for (int f = 0; f < repro::kRows; ++f) acc[f] = 0.f;
      for (int k0 = 0; k0 < k_kept; k0 += block_k) {
        const int nk = min(block_k, k_kept - k0);
        __syncthreads();  // the previous chunk is no longer read
        for (int e = threadIdx.x; e < nk * tile; e += blockDim.x) {
          s_val[e] = repro::to_f32(vals_t[static_cast<long long>(k0) * tile + e]);
        }
        for (int e = threadIdx.x; e < nk; e += blockDim.x) {
          const int r = idx_t[k0 + e];
          if (r >= 0 && r < k_rows) {
            const int tap = r / g.c;
            const int ch = r - tap * g.c;
            s_off[e] = ch * plane;
            s_kh[e] = tap / g.kw;
            s_kw[e] = tap - (tap / g.kw) * g.kw;
          } else {
            s_off[e] = 0;
            s_kh[e] = -1;
            s_kw[e] = 0;
          }
        }
        __syncthreads();
        if (in_range) {
          for (int k = 0; k < nk; ++k) {
            const int ikh = s_kh[k];
            int ih, iw;
            float xv = 0.f;
            if (ikh < 0) {
              xv = repro::quiet_nan();
            } else if (repro::tap_shift(ih0, iw0, ikh, s_kw[k], g, ih, iw)) {
              xv = repro::to_f32(xb[s_off[k] + static_cast<long long>(ih) * g.w + iw]);
            }
            const float* wk = s_val + k * tile + f0;
#pragma unroll
            for (int f = 0; f < repro::kRows; ++f) {
              if (f0 + f < tile) acc[f] = fmaf(wk[f], xv, acc[f]);
            }
          }
        }
      }
      if (j < g.v) {  // past-the-end positions of the ragged last strip hold 0
#pragma unroll
        for (int f = 0; f < repro::kRows; ++f) {
          if (f0 + f < tile) {
            out[static_cast<long long>(t * tile + f0 + f) * out_ld +
                static_cast<long long>(s) * g.v + j] = repro::from_f32<T>(acc[f]);
          }
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* values, const int* idx, void* out,
           const repro::ConvGeom& g, int n_tiles, int k_kept, int tile, int block_k,
           cudaStream_t st) {
  const size_t smem = static_cast<size_t>(block_k) *
                      (tile * sizeof(float) + sizeof(long long) + 2 * sizeof(int));
  cudaError_t err = repro::allow_smem(conv2d_fused_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.n_strips, n_tiles);
  conv2d_fused_kernel<T><<<grid, repro::kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(values), idx, static_cast<T*>(out), g,
      k_kept, tile, block_k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [c, b, h, w]; values: [n_tiles, k_kept, tile]; idx: [n_tiles, k_kept] int32
// (rows of the (kh, kw, c)-flattened reduction dim); out: [n_tiles*tile, n_strips*v].
extern "C" int repro_conv2d_fused(const void* x, const void* values, const void* idx,
                                  void* out, int dtype, int c, int b, int h, int w, int kh,
                                  int kw, int stride, int pad, int ho, int wo, int v,
                                  int n_strips, int n_tiles, int k_kept, int tile,
                                  int block_k, void* stream) {
  if (n_strips <= 0 || n_tiles <= 0 || n_tiles > 65535 || k_kept <= 0 || tile <= 0 ||
      block_k <= 0 || v <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const repro::ConvGeom g{c, b, h, w, kh, kw, stride, pad, ho, wo, v, n_strips};
  auto st = static_cast<cudaStream_t>(stream);
  const int* ids = static_cast<const int*>(idx);
  if (dtype == repro::kDtypeF32) {
    return launch<float>(x, values, ids, out, g, n_tiles, k_kept, tile, block_k, st);
  }
  if (dtype == repro::kDtypeBF16) {
    return launch<__nv_bfloat16>(x, values, ids, out, g, n_tiles, k_kept, tile, block_k, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
