// Column-wise N:M sparse GEMM on packed strips (paper Algorithm 1, strip-major)
// for Hopper.
//
// Replaces: src/repro/kernels/colwise_nm/kernel.py::colwise_nm_matmul_strips_pallas
// (_strips_kernel), the GEMM half of the two-kernel conv plan.
//
// Computes out[t*T + f, s*V + j] = sum_k values[t, k, f] * strips[s, idx[t, k], j]
// with float32 accumulation (f32 or bf16 operands), output in the operands' dtype.
//
// Bound: bytes at the conv shapes of the main path.  Each kept strip row is
// used by only T = 8 output rows, about 2*T/4 = 4 FLOP per f32 byte read,
// far below the card's ~20 FLOP/byte f32 ridge, so the tensor cores would
// not help yet.  Design: one block per (strip s, tile t).  The block stages
// values[t] and idx[t] in shared memory (block_k rows at a time), and each
// thread owns output column j of the strip and keeps kRows f32 accumulators
// in registers.  The k loop reads strips[s, idx[t, k], j], which is one
// coalesced row per warp; a ragged k_kept is the loop bound, with no padding
// rows.  An index outside [0, K) contributes NaN instead of reading out of
// bounds, so a bad index shows in the output.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(repro::kThreads)
strips_kernel(const T* __restrict__ strips, const T* __restrict__ values,
              const int* __restrict__ idx, T* __restrict__ out, int n_strips, int k_rows,
              int v, int k_kept, int tile, int block_k) {
  extern __shared__ float smem[];
  float* s_val = smem;                                      // [block_k, tile]
  int* s_idx = reinterpret_cast<int*>(s_val + block_k * tile);  // [block_k]
  const int s = blockIdx.x;
  const int t = blockIdx.y;
  const T* strip = strips + static_cast<long long>(s) * k_rows * v;
  const T* vals_t = values + static_cast<long long>(t) * k_kept * tile;
  const int* idx_t = idx + static_cast<long long>(t) * k_kept;
  const long long out_ld = static_cast<long long>(n_strips) * v;

  for (int j0 = 0; j0 < v; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
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
        for (int e = threadIdx.x; e < nk; e += blockDim.x) s_idx[e] = idx_t[k0 + e];
        __syncthreads();
        if (j < v) {
          for (int k = 0; k < nk; ++k) {
            const int r = s_idx[k];
            const float xv = (r >= 0 && r < k_rows)
                                 ? repro::to_f32(strip[static_cast<long long>(r) * v + j])
                                 : repro::quiet_nan();
            const float* wk = s_val + k * tile + f0;
#pragma unroll
            for (int f = 0; f < repro::kRows; ++f) {
              if (f0 + f < tile) acc[f] = fmaf(wk[f], xv, acc[f]);
            }
          }
        }
      }
      if (j < v) {
#pragma unroll
        for (int f = 0; f < repro::kRows; ++f) {
          if (f0 + f < tile) {
            out[static_cast<long long>(t * tile + f0 + f) * out_ld +
                static_cast<long long>(s) * v + j] = repro::from_f32<T>(acc[f]);
          }
        }
      }
    }
  }
}

template <typename T>
int launch(const void* strips, const void* values, const int* idx, void* out,
           int n_strips, int k_rows, int v, int n_tiles, int k_kept, int tile, int block_k,
           cudaStream_t st) {
  const size_t smem = static_cast<size_t>(block_k) * (tile * sizeof(float) + sizeof(int));
  cudaError_t err = repro::allow_smem(strips_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_strips, n_tiles);
  strips_kernel<T><<<grid, repro::kThreads, smem, st>>>(
      static_cast<const T*>(strips), static_cast<const T*>(values), idx,
      static_cast<T*>(out), n_strips, k_rows, v, k_kept, tile, block_k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strips: [n_strips, k_rows, v]; values: [n_tiles, k_kept, tile];
// idx: [n_tiles, k_kept] int32; out: [n_tiles*tile, n_strips*v].  All contiguous.
extern "C" int repro_colwise_nm_strips(const void* strips, const void* values, const void* idx,
                                       void* out, int dtype, int n_strips, int k_rows, int v,
                                       int n_tiles, int k_kept, int tile, int block_k,
                                       void* stream) {
  if (n_strips <= 0 || n_tiles <= 0 || n_tiles > 65535 || k_kept <= 0 || tile <= 0 ||
      block_k <= 0 || v <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const int* ids = static_cast<const int*>(idx);
  if (dtype == repro::kDtypeF32) {
    return launch<float>(strips, values, ids, out, n_strips, k_rows, v, n_tiles, k_kept,
                         tile, block_k, st);
  }
  if (dtype == repro::kDtypeBF16) {
    return launch<__nv_bfloat16>(strips, values, ids, out, n_strips, k_rows, v, n_tiles,
                                 k_kept, tile, block_k, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
