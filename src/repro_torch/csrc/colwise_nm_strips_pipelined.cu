// Pipelined strip-major column-wise N:M sparse GEMM for Hopper: the GEMM half
// of the pipelined two-kernel conv plan.
//
// Replaces: src/repro/kernels/colwise_nm/kernel.py::
// colwise_nm_matmul_strips_pipelined_pallas (_strips_pipelined_kernel), the
// TPU kernel that keeps the strips in HBM and double-buffers chunks of hb
// whole strips into VMEM across its sequential grid steps.
//
// Computes the same function as colwise_nm_strips.cu:
// out[t*T + f, s*V + j] = sum_k values[t, k, f] * strips[s, idx[t, k], j],
// and the same numbers: each output is the same chain of fmaf over k in the
// same order, so the two kernels agree bit for bit.
//
// Bound: bytes, as the plain strip GEMM (about 4 FLOP per f32 byte at T = 8).
// Design: the TPU carried its double buffer from one grid step to the next;
// Hopper blocks run in parallel and in no order, so the overlap lives inside
// one block.  Staging whole strips does not fit either: one f32 strip at
// K = 144, V = 128 is 72 KB, two slots of two strips 288 KB, over the 227 KB
// a block may use.  So a block owns hb consecutive strips of one tile and
// runs a two-slot cp.async ring over [block_k, V] slices of the *gathered
// kept rows* of a strip: the copy of slice i+1 is in flight while slice i is
// multiplied, and only kept rows are ever moved.  Each slot also holds the
// slice's values for the kRows output rows being accumulated.  A block walks
// its own strips with a loop bound, so the ragged last chunk needs no
// re-cover of the chunk before it, as the TPU's fixed-size DMA did.  Each
// thread owns output columns j and j + 128 of a strip.  An index outside
// [0, K) fills its slice row with NaN instead of reading out of bounds.
#include "common.cuh"

namespace {

constexpr int kMaxCols = 2;  // columns per thread: V <= 2 * kThreads

// Shared-memory bytes, also computed by
// repro_torch/kernels/colwise_nm/kernel.py::pipelined_smem_bytes.
size_t pipelined_smem(int v, int block_k, int elem) {
  return 2 * static_cast<size_t>(block_k) * v * elem +
         2 * static_cast<size_t>(block_k) * repro::kRows * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(repro::kThreads)
pipelined_kernel(const T* __restrict__ strips, const T* __restrict__ values,
                 const int* __restrict__ idx, T* __restrict__ out, int n_strips, int k_rows,
                 int v, int k_kept, int tile, int block_k, int hb) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);                       // [2, block_k, v]
  float* s_val = reinterpret_cast<float*>(ring + 2 * block_k * v);  // [2, block_k, kRows]
  constexpr int kPer16 = 16 / sizeof(T);
  const int row_chunks = v / kPer16;
  const int t = blockIdx.y;
  const int s_begin = blockIdx.x * hb;
  const int s_end = min(s_begin + hb, n_strips);
  const int n_slices = (k_kept + block_k - 1) / block_k;
  const T* vals_t = values + static_cast<long long>(t) * k_kept * tile;
  const int* idx_t = idx + static_cast<long long>(t) * k_kept;
  const long long out_ld = static_cast<long long>(n_strips) * v;
  const T nan_t = repro::from_f32<T>(repro::quiet_nan());

  for (int s = s_begin; s < s_end; ++s) {
    const T* strip = strips + static_cast<long long>(s) * k_rows * v;
    for (int f0 = 0; f0 < tile; f0 += repro::kRows) {
      // slice i -> slot: the kept rows k0 .. k0+nk of the strip, and their
      // values for output rows f0 .. f0+kRows
      auto issue = [&](int i, int slot) {
        const int k0 = i * block_k;
        const int nk = min(block_k, k_kept - k0);
        T* dst = ring + slot * block_k * v;
        for (int e = threadIdx.x; e < nk * row_chunks; e += blockDim.x) {
          const int kk = e / row_chunks;
          const int ch = e - kk * row_chunks;
          const int r = idx_t[k0 + kk];
          T* d = dst + kk * v + ch * kPer16;
          if (r >= 0 && r < k_rows) {
            repro::cp_async16(d, strip + static_cast<long long>(r) * v + ch * kPer16);
          } else {
            for (int q = 0; q < kPer16; ++q) d[q] = nan_t;
          }
        }
        float* sv = s_val + slot * block_k * repro::kRows;
        for (int e = threadIdx.x; e < nk * repro::kRows; e += blockDim.x) {
          const int kk = e / repro::kRows;
          const int f = e - kk * repro::kRows;
          sv[e] = f0 + f < tile
                      ? repro::to_f32(vals_t[static_cast<long long>(k0 + kk) * tile + f0 + f])
                      : 0.f;
        }
        repro::cp_async_commit();
      };

      float acc[kMaxCols][repro::kRows];
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
#pragma unroll
        for (int f = 0; f < repro::kRows; ++f) acc[c][f] = 0.f;
      }
      __syncthreads();  // both slots are free: the previous pass is done reading
      issue(0, 0);
      for (int i = 0; i < n_slices; ++i) {
        if (i + 1 < n_slices) {
          issue(i + 1, (i + 1) & 1);
          repro::cp_async_wait<1>();  // slice i has landed, slice i+1 may fly
        } else {
          repro::cp_async_wait<0>();
        }
        __syncthreads();
        const T* xs = ring + (i & 1) * block_k * v;
        const float* sv = s_val + (i & 1) * block_k * repro::kRows;
        const int nk = min(block_k, k_kept - i * block_k);
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c) {
          const int j = threadIdx.x + c * blockDim.x;
          if (j < v) {
            for (int k = 0; k < nk; ++k) {
              const float xv = repro::to_f32(xs[k * v + j]);
              const float* wk = sv + k * repro::kRows;
#pragma unroll
              for (int f = 0; f < repro::kRows; ++f) {
                if (f0 + f < tile) acc[c][f] = fmaf(wk[f], xv, acc[c][f]);
              }
            }
          }
        }
        __syncthreads();  // slot i&1 is refilled by the issue of slice i+2
      }
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        const int j = threadIdx.x + c * blockDim.x;
        if (j < v) {
#pragma unroll
          for (int f = 0; f < repro::kRows; ++f) {
            if (f0 + f < tile) {
              out[static_cast<long long>(t * tile + f0 + f) * out_ld +
                  static_cast<long long>(s) * v + j] = repro::from_f32<T>(acc[c][f]);
            }
          }
        }
      }
    }
  }
}

template <typename T>
int launch(const void* strips, const void* values, const int* idx, void* out, int n_strips,
           int k_rows, int v, int n_tiles, int k_kept, int tile, int block_k, int hb,
           size_t smem, cudaStream_t st) {
  cudaError_t err = repro::allow_smem(pipelined_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_strips + hb - 1) / hb, n_tiles);
  pipelined_kernel<T><<<grid, repro::kThreads, smem, st>>>(
      static_cast<const T*>(strips), static_cast<const T*>(values), idx, static_cast<T*>(out),
      n_strips, k_rows, v, k_kept, tile, block_k, hb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strips: [n_strips, k_rows, v], 16-byte aligned, with v * elem a multiple of
// 16 and v <= 256; values: [n_tiles, k_kept, tile]; idx: [n_tiles, k_kept]
// int32; out: [n_tiles*tile, n_strips*v].  All contiguous.  smem_bytes must
// equal this kernel's layout.
extern "C" int repro_colwise_nm_strips_pipelined(const void* strips, const void* values,
                                                 const void* idx, void* out, int dtype,
                                                 int n_strips, int k_rows, int v, int n_tiles,
                                                 int k_kept, int tile, int block_k, int hb,
                                                 long long smem_bytes, void* stream) {
  const int elem = dtype == repro::kDtypeF32 ? 4 : 2;
  if (n_strips <= 0 || n_tiles <= 0 || n_tiles > 65535 || k_kept <= 0 || tile <= 0 ||
      block_k <= 0 || hb <= 0 || v <= 0 || v > kMaxCols * repro::kThreads ||
      (v * elem) % 16 != 0 || reinterpret_cast<uintptr_t>(strips) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = pipelined_smem(v, block_k, elem);
  if (static_cast<long long>(smem) != smem_bytes) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const int* ids = static_cast<const int*>(idx);
  if (dtype == repro::kDtypeF32) {
    return launch<float>(strips, values, ids, out, n_strips, k_rows, v, n_tiles, k_kept, tile,
                         block_k, hb, smem, st);
  }
  if (dtype == repro::kDtypeBF16) {
    return launch<__nv_bfloat16>(strips, values, ids, out, n_strips, k_rows, v, n_tiles, k_kept,
                                 tile, block_k, hb, smem, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
