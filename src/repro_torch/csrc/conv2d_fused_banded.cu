// Banded fused im2col + pack + column-wise N:M sparse GEMM conv for Hopper.
//
// Replaces: src/repro/kernels/conv_gemm/kernel.py::conv2d_fused_banded_pallas
// (_banded_kernel), the TPU megakernel that keeps only a double-buffered row
// band [C, band_rows, W] of the [C, B*H, W] map in VMEM, DMA'd across its
// sequential grid steps.
//
// Computes the same function as conv2d_fused.cu, and the same numbers: each
// output is the same chain of fmaf over the kept rows in the same order, so
// the two kernels agree bit for bit.
//
// Bound: bytes.  The map is read (halo rows once per band that needs them),
// the weight is read, the output [O, S*V] is written once; at T = 8 rows per
// tile there are about 4 FLOP per f32 byte.  Design: the TPU carried its
// double buffer from one sequential grid step to the next; Hopper blocks run
// in parallel and in no order, so each block walks its own bands (band
// blockIdx.x, then every gridDim.x-th band after it) and overlaps inside
// itself: it copies band g+1's window into the second shared-memory slot with
// cp.async while it computes band g from the first.  A band is hb strips; its
// window is the band_rows rows of [C, B*H, W] from the band's origin, one
// contiguous segment per channel (16-byte copies where W * elem allows, else
// 4-byte ones).  The gather then reads the kept (kh, kw, c) rows from shared
// memory with band-local rows bb*H + ih - origin.  The origin is computed by
// band_origin() below, the twin of repro_torch/kernels/conv_gemm/plan.py::
// _band_origin (clamped to B*H - band_rows); the copy and the gather both use
// it, so they cannot disagree; a tap row that still falls outside the window
// (a band_rows too small for the geometry) contributes NaN.  Two f32 windows
// are 18-130 KB on the pruned resnet-tiny convs at (V = 128, hb = 2) and 258
// KB for the stride-2 conv at (V = 256, hb = 2) or (V = 128, hb = 4): that
// geometry needs bf16, and the dispatch predicate says so from the same
// footprint.  An index outside [0, K) contributes NaN instead of reading out
// of bounds.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kTapInts = 3;  // per kept row: channel offset, ikh, ikw

// Shared-memory bytes, also computed by
// repro_torch/kernels/conv_gemm/kernel.py::banded_smem_bytes.
size_t banded_smem(int c, int w, int band_rows, int block_k, int elem) {
  return 2 * static_cast<size_t>(c) * band_rows * w * elem +
         static_cast<size_t>(block_k) * (repro::kRows * sizeof(float) + kTapInts * sizeof(int));
}

__device__ __forceinline__ int band_origin(int band, int hb, int band_rows,
                                           const repro::ConvGeom& g) {
  const int p0 = band * hb * g.v;
  const int hw = g.ho * g.wo;
  const int bb0 = p0 / hw;
  const int oh0 = (p0 - bb0 * hw) / g.wo;
  const int r0 = max(bb0 * g.h + oh0 * g.stride - g.pad, 0);
  return min(r0, g.b * g.h - band_rows);
}

template <typename T>
__global__ void __launch_bounds__(repro::kThreads)
banded_kernel(const T* __restrict__ x, const T* __restrict__ values, const int* __restrict__ idx,
              T* __restrict__ out, repro::ConvGeom g, int k_kept, int tile, int block_k, int hb,
              int band_rows, int n_bands, int copy_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int seg = band_rows * g.w;  // elements of one channel's window
  const int band_elems = g.c * seg;
  T* bands = reinterpret_cast<T*>(smem);                             // [2, C, band_rows, W]
  float* s_val = reinterpret_cast<float*>(bands + 2 * band_elems);  // [block_k, kRows]
  int* s_off = reinterpret_cast<int*>(s_val + block_k * repro::kRows);  // [block_k]
  int* s_kh = s_off + block_k;  // [block_k], -1: bad index
  int* s_kw = s_kh + block_k;   // [block_k]
  const int t = blockIdx.y;
  const int bh = g.b * g.h;
  const int k_rows = g.kh * g.kw * g.c;
  const T* vals_t = values + static_cast<long long>(t) * k_kept * tile;
  const int* idx_t = idx + static_cast<long long>(t) * k_kept;
  const long long out_ld = static_cast<long long>(g.n_strips) * g.v;

  auto issue = [&](int band, int slot) {
    const int org = band_origin(band, hb, band_rows, g);
    T* dst = bands + slot * band_elems;
    const int per = copy_bytes / static_cast<int>(sizeof(T));  // elements per copy
    const int units = seg / per;
    for (int e = threadIdx.x; e < g.c * units; e += blockDim.x) {
      const int ch = e / units;
      const int u = e - ch * units;
      const T* src = x + (static_cast<long long>(ch) * bh + org) * g.w + u * per;
      if (copy_bytes == 16) {
        repro::cp_async16(dst + ch * seg + u * per, src);
      } else {
        repro::cp_async4(dst + ch * seg + u * per, src);
      }
    }
    repro::cp_async_commit();
  };

  int band = blockIdx.x;
  if (band >= n_bands) return;
  issue(band, 0);
  for (int slot = 0; band < n_bands; band += gridDim.x, slot ^= 1) {
    const int next = band + gridDim.x;
    if (next < n_bands) {
      issue(next, slot ^ 1);  // band g+1 streams in while band g is computed
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();
    const T* win = bands + slot * band_elems;
    const int org = band_origin(band, hb, band_rows, g);
    const int s_end = min((band + 1) * hb, g.n_strips);
    for (int s = band * hb; s < s_end; ++s) {
      for (int j0 = 0; j0 < g.v; j0 += blockDim.x) {
        const int j = j0 + threadIdx.x;
        int bb, ih0, iw0;
        const bool in_range = repro::decode_position(s * g.v + j, g, bb, ih0, iw0) && j < g.v;
        const int row0 = bb * g.h + ih0 - org;  // band-local row of tap row 0
        for (int f0 = 0; f0 < tile; f0 += repro::kRows) {
          float acc[repro::kRows];
#pragma unroll
          for (int f = 0; f < repro::kRows; ++f) acc[f] = 0.f;
          for (int k0 = 0; k0 < k_kept; k0 += block_k) {
            const int nk = min(block_k, k_kept - k0);
            __syncthreads();  // the previous chunk is no longer read
            for (int e = threadIdx.x; e < nk * repro::kRows; e += blockDim.x) {
              const int kk = e / repro::kRows;
              const int f = e - kk * repro::kRows;
              s_val[e] = f0 + f < tile
                             ? repro::to_f32(vals_t[static_cast<long long>(k0 + kk) * tile + f0 + f])
                             : 0.f;
            }
            for (int e = threadIdx.x; e < nk; e += blockDim.x) {
              const int r = idx_t[k0 + e];
              if (r >= 0 && r < k_rows) {
                const int tap = r / g.c;
                s_off[e] = (r - tap * g.c) * seg;
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
                  // a row outside the window means band_rows or the origin
                  // disagrees with the data: NaN, never a neighbouring row
                  const int row = row0 + ikh;
                  xv = row >= 0 && row < band_rows ? repro::to_f32(win[s_off[k] + row * g.w + iw])
                                                   : repro::quiet_nan();
                }
                const float* wk = s_val + k * repro::kRows;
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
    __syncthreads();  // this slot is refilled by the next band's prefetch
  }
}

template <typename T>
int launch(const void* x, const void* values, const int* idx, void* out,
           const repro::ConvGeom& g, int n_tiles, int k_kept, int tile, int block_k, int hb,
           int band_rows, int n_bands, size_t smem, cudaStream_t st) {
  cudaError_t err = repro::allow_smem(banded_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // about two blocks per SM in all; each walks its share of the bands
  const int per_tile = std::max(1, (2 * sms + n_tiles - 1) / n_tiles);
  const dim3 grid(std::min(n_bands, per_tile), n_tiles);
  const int row_bytes = g.w * static_cast<int>(sizeof(T));
  const int copy_bytes = (row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) ? 16 : 4;
  banded_kernel<T><<<grid, repro::kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(values), idx, static_cast<T*>(out), g,
      k_kept, tile, block_k, hb, band_rows, n_bands, copy_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [c, b, h, w], 4-byte aligned with w * elem a multiple of 4; values:
// [n_tiles, k_kept, tile]; idx: [n_tiles, k_kept] int32 (rows of the (kh, kw,
// c)-flattened reduction dim); out: [n_tiles*tile, n_strips*v].  hb, band_rows
// and n_bands come from plan.py::band_plan; smem_bytes must equal this
// kernel's layout.
extern "C" int repro_conv2d_fused_banded(const void* x, const void* values, const void* idx,
                                         void* out, int dtype, int c, int b, int h, int w,
                                         int kh, int kw, int stride, int pad, int ho, int wo,
                                         int v, int n_strips, int n_tiles, int k_kept, int tile,
                                         int block_k, int hb, int band_rows, int n_bands,
                                         long long smem_bytes, void* stream) {
  const int elem = dtype == repro::kDtypeF32 ? 4 : 2;
  if (n_strips <= 0 || n_tiles <= 0 || n_tiles > 65535 || k_kept <= 0 || tile <= 0 ||
      block_k <= 0 || v <= 0 || hb <= 0 || band_rows <= 0 || band_rows > b * h ||
      n_bands != (n_strips + hb - 1) / hb || (w * elem) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = banded_smem(c, w, band_rows, block_k, elem);
  if (static_cast<long long>(smem) != smem_bytes) return static_cast<int>(cudaErrorInvalidValue);
  const repro::ConvGeom g{c, b, h, w, kh, kw, stride, pad, ho, wo, v, n_strips};
  auto st = static_cast<cudaStream_t>(stream);
  const int* ids = static_cast<const int*>(idx);
  if (dtype == repro::kDtypeF32) {
    return launch<float>(x, values, ids, out, g, n_tiles, k_kept, tile, block_k, hb, band_rows,
                         n_bands, smem, st);
  }
  if (dtype == repro::kDtypeBF16) {
    return launch<__nv_bfloat16>(x, values, ids, out, g, n_tiles, k_kept, tile, block_k, hb,
                                 band_rows, n_bands, smem, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
