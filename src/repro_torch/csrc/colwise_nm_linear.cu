// Column-wise N:M sparse linear layer (paper Algorithm 1) for Hopper.
//
// Replaces: src/repro/kernels/colwise_nm/kernel.py::colwise_nm_matmul_pallas
// (_kernel), the TPU kernel that keeps a [block_b, d_in] activation block in
// VMEM and gathers the kept columns of each tile from it.
//
// Computes y[b, t*T + f] = sum_k x[b, idx[t, k]] * values[t, k, f] with float32
// accumulation (f32 or bf16 operands), output in the operands' dtype.
//
// Bound: at the serving widths (x [256, 960], T = d_out = 2560, half the rows
// kept) the work is 2*256*480*2560 = 0.63 GFLOP on 6 MB, about 100 FLOP per
// byte: operations bound in f32 outside the tensor cores, bytes bound in bf16.
// Design: a register-tiled GEMM over the kept rows.  One block per (row block
// of block_b rows, tile t, chunk of up to 32 columns of T), so shared memory
// never grows with T: a whole-d_out tile (T = 2560 at smollm-360m's d_ff) is
// 80 column chunks, and resnet-tiny's T = 8 is one.  The block's 256 threads
// are 8 column lanes x 32 row lanes; a thread keeps f32 accumulators for
// ceil(block_b/32) rows x ceil(chunk/8) columns.  For each block_k chunk of the
// kept rows the block stages idx[t], the values chunk [block_k, chunk] and the
// gathered activations x[rows, idx] [block_k, block_b] in shared memory, each
// value then used by every row (and each activation by every column) of the
// block.  The staging is latency-bound, so its loops carry no division and
// keep 8 loads in flight per thread, and 8 warps share each block: a warp's
// lanes read one contiguous row of the values chunk, or consecutive kept
// indices of one row of x, which the ascending idx keeps close together (L2
// holds x).  A ragged k_kept is the loop bound, with no padding rows.  An
// index outside [0, d_in) contributes NaN instead of reading out of bounds.
#include "common.cuh"

namespace {

constexpr int kLinThreads = 256;
constexpr int kWarps = kLinThreads / 32;
constexpr int kColLanes = 8;
constexpr int kRowLanes = kLinThreads / kColLanes;  // 32
constexpr int kMaxRowsPerThread = 8;                // block_b <= 256
constexpr int kMaxColsPerThread = 4;                // column chunk <= 32
constexpr int kMaxChunk = kColLanes * kMaxColsPerThread;
constexpr int kUnroll = 8;                          // staging loads in flight

// Shared-memory layout, also computed by
// repro_torch/kernels/colwise_nm/kernel.py::linear_smem_bytes.  Rows of the
// gathered activations are padded by one float so the staging stores, which
// walk k with the lanes of a warp, fall in different banks.
struct LinearLayout {
  int cw;   // columns of T per block
  int ldx;  // row stride of the staged activations
  size_t bytes;
};

LinearLayout linear_layout(int tile, int block_b, int block_k) {
  LinearLayout l;
  l.cw = tile < kMaxChunk ? tile : kMaxChunk;
  l.ldx = block_b + 1;
  l.bytes = static_cast<size_t>(block_k) * (l.ldx + l.cw + 1) * sizeof(float);
  return l;
}

template <typename T>
__global__ void __launch_bounds__(kLinThreads)
linear_kernel(const T* __restrict__ x, const T* __restrict__ values, const int* __restrict__ idx,
              T* __restrict__ out, int n_rows, int d_in, int d_out, int k_kept, int tile,
              int block_b, int block_k, int cw, int ldx) {
  extern __shared__ float smem[];
  float* s_x = smem;                                          // [block_k, ldx]
  float* s_val = s_x + block_k * ldx;                         // [block_k, cw]
  int* s_idx = reinterpret_cast<int*>(s_val + block_k * cw);  // [block_k]
  const int t = blockIdx.y;
  const int c0 = blockIdx.z * cw;
  const int ncol = min(cw, tile - c0);
  const int r0 = blockIdx.x * block_b;
  const int nrow = min(block_b, n_rows - r0);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int cl = threadIdx.x % kColLanes;
  const int rl = threadIdx.x / kColLanes;
  const int tm = (block_b + kRowLanes - 1) / kRowLanes;  // rows per thread
  const int tn = (cw + kColLanes - 1) / kColLanes;       // columns per thread
  const T* vals_t = values + static_cast<long long>(t) * k_kept * tile + c0;
  const int* idx_t = idx + static_cast<long long>(t) * k_kept;
  const T* x_blk = x + static_cast<long long>(r0) * d_in;
  const float bad = repro::quiet_nan();  // what an out-of-range index reads

  float acc[kMaxRowsPerThread][kMaxColsPerThread];
#pragma unroll
  for (int i = 0; i < kMaxRowsPerThread; ++i) {
#pragma unroll
    for (int j = 0; j < kMaxColsPerThread; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < k_kept; k0 += block_k) {
    const int nk = min(block_k, k_kept - k0);
    __syncthreads();  // the previous chunk is no longer read
    for (int e = threadIdx.x; e < nk; e += blockDim.x) s_idx[e] = idx_t[k0 + e];
    // values chunk: a warp's lanes read one contiguous row of the chunk
    if (lane < ncol) {
      for (int kb = warp; kb < nk; kb += kWarps * kUnroll) {
        float v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int k = kb + u * kWarps;
          v[u] = k < nk ? repro::to_f32(vals_t[static_cast<long long>(k0 + k) * tile + lane])
                        : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int k = kb + u * kWarps;
          if (k < nk) s_val[k * cw + lane] = v[u];
        }
      }
    }
    __syncthreads();  // s_idx is read below
    // gathered activations: a warp's lanes read consecutive kept indices of
    // one row; the warps take rows warp, warp + 8, ...
    for (int k = lane; k < nk; k += 32) {
      const int ix = s_idx[k];
      const bool ok = ix >= 0 && ix < d_in;
      for (int rb = warp; rb < nrow; rb += kWarps * kUnroll) {
        float v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int r = rb + u * kWarps;
          v[u] = r < nrow ? (ok ? repro::to_f32(x_blk[static_cast<long long>(r) * d_in + ix])
                                : bad)
                          : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int r = rb + u * kWarps;
          if (r < nrow) s_x[k * ldx + r] = v[u];
        }
      }
    }
    __syncthreads();
    for (int k = 0; k < nk; ++k) {
      float wv[kMaxColsPerThread];
#pragma unroll
      for (int j = 0; j < kMaxColsPerThread; ++j) {
        const int c = cl + j * kColLanes;
        wv[j] = c < ncol ? s_val[k * cw + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kMaxRowsPerThread; ++i) {
        if (i < tm) {
          const int r = rl + i * kRowLanes;
          const float xv = r < nrow ? s_x[k * ldx + r] : 0.f;
#pragma unroll
          for (int j = 0; j < kMaxColsPerThread; ++j) {
            if (j < tn) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxRowsPerThread; ++i) {
    const int r = rl + i * kRowLanes;
    if (i < tm && r < nrow) {
#pragma unroll
      for (int j = 0; j < kMaxColsPerThread; ++j) {
        const int c = cl + j * kColLanes;
        if (c < ncol) {
          out[static_cast<long long>(r0 + r) * d_out + static_cast<long long>(t) * tile + c0 +
              c] = repro::from_f32<T>(acc[i][j]);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* values, const int* idx, void* out, int n_rows, int d_in,
           int n_tiles, int k_kept, int tile, int block_b, int block_k, const LinearLayout& l,
           cudaStream_t st) {
  cudaError_t err = repro::allow_smem(linear_kernel<T>, l.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_rows + block_b - 1) / block_b, n_tiles, (tile + l.cw - 1) / l.cw);
  linear_kernel<T><<<grid, kLinThreads, l.bytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(values), idx, static_cast<T*>(out),
      n_rows, d_in, n_tiles * tile, k_kept, tile, block_b, block_k, l.cw, l.ldx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [n_rows, d_in]; values: [n_tiles, k_kept, tile]; idx: [n_tiles, k_kept] int32;
// out: [n_rows, n_tiles*tile].  All contiguous; block_b <= 256.  smem_bytes is
// the caller's size of the launch's shared memory: it must equal this
// kernel's layout.
extern "C" int repro_colwise_nm_linear(const void* x, const void* values, const void* idx,
                                       void* out, int dtype, int n_rows, int d_in, int n_tiles,
                                       int k_kept, int tile, int block_b, int block_k,
                                       long long smem_bytes, void* stream) {
  if (n_rows <= 0 || d_in <= 0 || n_tiles <= 0 || n_tiles > 65535 || k_kept <= 0 ||
      tile <= 0 || block_b <= 0 || block_b > kRowLanes * kMaxRowsPerThread || block_k <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const LinearLayout l = linear_layout(tile, block_b, block_k);
  if (static_cast<long long>(l.bytes) != smem_bytes || (tile + l.cw - 1) / l.cw > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const int* ids = static_cast<const int*>(idx);
  if (dtype == repro::kDtypeF32) {
    return launch<float>(x, values, ids, out, n_rows, d_in, n_tiles, k_kept, tile, block_b,
                         block_k, l, st);
  }
  if (dtype == repro::kDtypeBF16) {
    return launch<__nv_bfloat16>(x, values, ids, out, n_rows, d_in, n_tiles, k_kept, tile,
                                 block_b, block_k, l, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
