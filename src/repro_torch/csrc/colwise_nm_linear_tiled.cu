// Column-wise N:M sparse linear layer (paper Algorithm 1) for Hopper, as one
// register-tiled, double-buffered GEMM over the gathered kept rows.
//
// Replaces: src/repro/kernels/colwise_nm/kernel.py::colwise_nm_matmul_pallas
// (_kernel), the TPU kernel that walks tile t's kept rows as a sequential
// grid axis (kc), gathering x[:, idx[t, kc-block]] from a VMEM-resident
// activation block into an f32 accumulator in VMEM scratch.  Serves every
// tile width T that is a multiple of 64; csrc/colwise_nm_linear.cu keeps
// the others.
//
// Computes y[b, t*T + f] = sum_k x[b, idx[t, k]] * values[t, k, f] with float32
// accumulation (f32 or bf16 operands), output in the operands' dtype.
//
// Bound: at many rows (scoring's 8192 rows of smollm-360m, 80 GFLOP a layer)
// operations in f32 on the CUDA cores (67 TFLOP/s); at few rows (decode's 4)
// the bytes of the compressed weight, read once (19.7 MB a layer).
// Design: one block of 256 threads per (BM-row block, tile t, 64 columns of
// T), walking all of tile t's kept rows in steps of BK = 32 (the TPU's kc
// axis becomes this in-block loop).  BM is a template parameter (16, 64 or
// 128; the wrapper picks it from the row count) and each thread keeps
// (BM/16) x 4 f32 accumulators.  A two-stage ring in shared memory overlaps
// step i+1's loads with step i's FMAs, with one __syncthreads a step: the
// values tile [BK, 64] is contiguous rows and moves by 16-byte cp.async; the
// gathered activations x[rows, idx[t, k0:k0+BK]] are loaded into registers
// before step i is computed and stored after it, k-major (As[k][m]) as f32,
// rows padded by 4 floats so the transposing stores of a warp (8 kept rows
// x 4 rows) hit 32 banks.  The FMA loop reads As and the values with 16-byte
// shared loads (a warp is 4 row groups x 8 column groups: one wavefront
// each) for (BM/16) x 4 FMAs.  idx is read one step ahead of the gather that
// uses it, so no load waits on another.
// Bit-identity: every output is one fmaf(x, w, acc) chain over k ascending
// from 0.f, rounded once by repro::from_f32, exactly as in
// colwise_nm_linear.cu, so the two kernels give the same bits.  A ragged
// last step is zero in both operands (never a real index: 0 * x[:, 0] is NaN
// where x[:, 0] is inf), ragged rows are zero and masked at the store, and
// an index outside [0, d_in) stages NaN, so it reaches exactly its tile's
// columns.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;   // columns of T per block
constexpr int kBK = 32;   // kept rows per pipeline step
constexpr int kPadA = 4;  // floats of padding per staged kept row

// Shared-memory bytes, also computed by
// repro_torch/kernels/colwise_nm/kernel.py::linear_tiled_smem_bytes: two
// stages of the gathered activations [BK][BM + 4] in f32 and of the values
// tile [BK][64] in the operands' dtype.
size_t tiled_smem_bytes(int bm, int itemsize) {
  return static_cast<size_t>(2) * kBK * ((bm + kPadA) * sizeof(float) + kBN * itemsize);
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
tiled_kernel(const T* __restrict__ x, const T* __restrict__ values, const int* __restrict__ idx,
             T* __restrict__ out, int n_rows, int d_in, int d_out, int k_kept, int tile) {
  constexpr int TM = BM / 16;                  // rows per thread
  constexpr int LDA = BM + kPadA;              // row stride of As
  constexpr int XLOADS = BM / 8;               // gathered activations per thread per step
  constexpr int VEC = 16 / sizeof(T);          // elements of one 16-byte copy
  constexpr int ROW_CHUNKS = kBN / VEC;        // 16-byte copies per values row
  constexpr int CHUNKS = kBK * ROW_CHUNKS;     // per values tile
  static_assert(CHUNKS % kThreads == 0, "whole copies per thread");
  constexpr int CPT = CHUNKS / kThreads;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);        // [2][kBK][LDA]
  T* Bs = reinterpret_cast<T*>(As + 2 * kBK * LDA);      // [2][kBK][kBN]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t = blockIdx.y;
  const int c0 = blockIdx.z * kBN;
  const long long r0 = static_cast<long long>(blockIdx.x) * BM;
  const int nrow = static_cast<int>(min(static_cast<long long>(BM), n_rows - r0));
  const T* vals_t = values + static_cast<long long>(t) * k_kept * tile + c0;
  const int* idx_t = idx + static_cast<long long>(t) * k_kept;
  const T* x_blk = x + r0 * d_in;
  const int n_steps = (k_kept + kBK - 1) / kBK;
  const T zero = repro::from_f32<T>(0.f);
  const T bad = repro::from_f32<T>(repro::quiet_nan());  // what an out-of-range index reads

  // Gather role: kept row sk of each step, block rows sm, sm + 8, ...  A
  // warp covers 8 consecutive kept rows of 4 block rows.
  const int sk = (warp & 3) * 8 + (lane & 7);
  const int sm = (warp >> 2) * 4 + (lane >> 3);
  // FMA role: rows TM*tr .. TM*tr + TM-1, columns 4*tc .. 4*tc + 3; a warp
  // is 4 row groups x 8 column groups.
  const int tr = (warp >> 1) * 4 + (lane >> 3);
  const int tc = (warp & 1) * 8 + (lane & 7);

  auto load_idx = [&](int step) -> int {
    const int k = step * kBK + sk;
    return k < k_kept ? idx_t[k] : 0;
  };
  // Issue the loads of one step's gathered activations into registers;
  // nothing waits on them until store_x.
  auto load_x = [&](int step, int ix, T (&v)[XLOADS]) {
    const bool kin = step * kBK + sk < k_kept;
    const bool ok = ix >= 0 && ix < d_in;
#pragma unroll
    for (int i = 0; i < XLOADS; ++i) {
      const int m = sm + 8 * i;
      const bool live = kin && m < nrow;
      T val = live && !ok ? bad : zero;
      if (live && ok) val = x_blk[static_cast<long long>(m) * d_in + ix];
      v[i] = val;
    }
  };
  auto store_x = [&](int stage, const T (&v)[XLOADS]) {
    float* a = As + stage * kBK * LDA + sk * LDA + sm;
#pragma unroll
    for (int i = 0; i < XLOADS; ++i) a[8 * i] = repro::to_f32(v[i]);
  };
  // The values tile of one step by 16-byte cp.async; rows past k_kept are
  // zero.
  auto copy_values = [&](int step, int stage) {
    T* b = Bs + stage * kBK * kBN;
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      const int c = tid + u * kThreads;
      const int row = c / ROW_CHUNKS;
      const int col = (c % ROW_CHUNKS) * VEC;
      const int k = step * kBK + row;
      if (k < k_kept) {
        repro::cp_async16(b + row * kBN + col, vals_t + static_cast<long long>(k) * tile + col);
      } else {
        *reinterpret_cast<uint4*>(b + row * kBN + col) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    repro::cp_async_commit();
  };

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  T xv[XLOADS];
  copy_values(0, 0);
  load_x(0, load_idx(0), xv);
  int ix_next = n_steps > 1 ? load_idx(1) : 0;
  store_x(0, xv);
  repro::cp_async_wait<0>();
  __syncthreads();

  for (int s = 0; s < n_steps; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < n_steps;
    if (more) {
      // stage s+1 was last read in step s-1, before the barrier ending it
      copy_values(s + 1, cur ^ 1);
      load_x(s + 1, ix_next, xv);
      ix_next = s + 2 < n_steps ? load_idx(s + 2) : 0;
    }
    const float* a_s = As + cur * kBK * LDA + tr * TM;
    const T* b_s = Bs + cur * kBK * kBN + tc * 4;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM];
      if constexpr (TM >= 4) {
#pragma unroll
        for (int q = 0; q < TM / 4; ++q) {
          float a4[4];
          repro::load4(a_s + kk * LDA + 4 * q, a4);
#pragma unroll
          for (int e = 0; e < 4; ++e) a[4 * q + e] = a4[e];
        }
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = a_s[kk * LDA + i];
      }
      float w[4];
      repro::load4(b_s + kk * kBN, w);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
    }
    if (more) {
      store_x(cur ^ 1, xv);
      repro::cp_async_wait<0>();
    }
    __syncthreads();
  }

  T* out_blk = out + r0 * d_out + static_cast<long long>(t) * tile + c0 + tc * 4;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = tr * TM + i;
    if (m < nrow) repro::store4(out_blk + static_cast<long long>(m) * d_out, acc[i]);
  }
}

template <typename T, int BM>
int launch(const void* x, const void* values, const int* idx, void* out, int n_rows, int d_in,
           int n_tiles, int k_kept, int tile, size_t smem, cudaStream_t st) {
  cudaError_t err = repro::allow_smem(tiled_kernel<T, BM>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_rows + BM - 1) / BM, n_tiles, tile / kBN);
  tiled_kernel<T, BM><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(values), idx, static_cast<T*>(out), n_rows,
      d_in, n_tiles * tile, k_kept, tile);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(int block_rows, const void* x, const void* values, const int* idx, void* out,
                int n_rows, int d_in, int n_tiles, int k_kept, int tile, size_t smem,
                cudaStream_t st) {
  switch (block_rows) {
    case 16:
      return launch<T, 16>(x, values, idx, out, n_rows, d_in, n_tiles, k_kept, tile, smem, st);
    case 64:
      return launch<T, 64>(x, values, idx, out, n_rows, d_in, n_tiles, k_kept, tile, smem, st);
    case 128:
      return launch<T, 128>(x, values, idx, out, n_rows, d_in, n_tiles, k_kept, tile, smem, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: [n_rows, d_in]; values: [n_tiles, k_kept, tile]; idx: [n_tiles, k_kept] int32;
// out: [n_rows, n_tiles*tile].  All contiguous, x and values 16-byte
// aligned; tile a multiple of 64; block_rows 16, 64 or 128.  smem_bytes is
// the caller's size of the launch's shared memory: it must equal this
// kernel's layout.
extern "C" int repro_colwise_nm_linear_tiled(const void* x, const void* values, const void* idx,
                                             void* out, int dtype, int n_rows, int d_in,
                                             int n_tiles, int k_kept, int tile, int block_rows,
                                             long long smem_bytes, void* stream) {
  if (n_rows <= 0 || d_in <= 0 || n_tiles <= 0 || n_tiles > 65535 || k_kept <= 0 ||
      tile <= 0 || tile % kBN != 0 || tile / kBN > 65535 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(values) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int itemsize = dtype == repro::kDtypeF32 ? 4 : 2;
  const size_t smem = tiled_smem_bytes(block_rows, itemsize);
  if (static_cast<long long>(smem) != smem_bytes) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const int* ids = static_cast<const int*>(idx);
  if (dtype == repro::kDtypeF32) {
    return launch_rows<float>(block_rows, x, values, ids, out, n_rows, d_in, n_tiles, k_kept,
                              tile, smem, st);
  }
  if (dtype == repro::kDtypeBF16) {
    return launch_rows<__nv_bfloat16>(block_rows, x, values, ids, out, n_rows, d_in, n_tiles,
                                      k_kept, tile, smem, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
