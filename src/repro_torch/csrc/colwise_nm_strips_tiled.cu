// Strip-major column-wise N:M sparse GEMM for Hopper, register-tiled over a
// cp.async ring of gathered strip rows: one kernel template behind two entry
// points, the strip GEMM (one strip a block) and the pipelined strip GEMM
// (hb strips a block).
//
// Replaces: src/repro/kernels/colwise_nm/kernel.py::colwise_nm_matmul_strips_pallas
// (_strips_kernel, one strip a grid step) and
// ::colwise_nm_matmul_strips_pipelined_pallas (_strips_pipelined_kernel, which
// keeps the strips in HBM and copies chunk g+1 of hb strips while chunk g is
// multiplied).  csrc/colwise_nm_strips.cu and colwise_nm_strips_pipelined.cu
// keep the calls the shape rule (kernel.py::strips_tiled_takes) refuses.
//
// Computes out[t*T + f, s*V + j] = sum_k values[t, k, f] * strips[s, idx[t, k], j]
// with float32 accumulation (f32 or bf16 operands), output in the operands' dtype.
//
// Bound: bytes at resnet-tiny's convs (a gathered strip row feeds T = 8
// output rows, about 4 FLOP per f32 byte, far below the card's f32 ridge);
// operations (f32 on the CUDA cores) at ResNet-18's layer3 and layer4 at
// batch 8, where k_kept reaches 1152 and 2304.  What held the old kernels
// back was latency, not bandwidth: one 4-byte global load per kept row and
// thread, behind a shared read of its index (colwise_nm_strips.cu), or a
// two-slot ring that never had a second slice in flight at k_kept <=
// block_k and restarted cold for every strip (colwise_nm_strips_pipelined.cu).
// Design: one block per (hb strips, tile t).  The block stages idx[t],
// then all of values[t] (in its dtype, rows padded to whole 8-row groups
// with zeros) in shared memory once, both by cp.async, so that no thread
// waits on one load after another.  A two-slot ring of slices of 16
// *gathered kept rows* moves by 16-byte cp.async; the slice counter runs
// over the (strip step, row-group pass, k-chunk) triples of all the
// block's strips, so the first slice of a step is in flight while the last
// slice of the step before is multiplied, with one __syncthreads a slice.
// A step is `lanes` of the block's strips side by side, each on its own
// threads, one slice carrying every lane's rows (the one-strip entry point
// has one lane; the pipelined one takes all hb where the threads allow, so
// idx[t] and values[t] are staged once for hb strips).  A thread owns CPT
// contiguous columns and 8 output rows of one lane (8 x CPT f32
// accumulators); per kept row it reads its columns with one shared load and
// the row's 8 values with two broadcast 16-byte loads (one in bf16, widened
// exactly).  A whole slice's 16 rows are unrolled without a guard.  Row
// groups beyond the block's threads are walked as passes over the ring.
// The sweep (kernels/colwise_nm/tune.py) set the constants: a block's time
// is its warps' serial slices, not the copies' latency, so 16-row slices
// beat 8, a deeper ring and a column split over more blocks read alike or
// worse, and the instance (CPT, lanes) is chosen by a rule of the shape
// (kernel.py::strips_tiled_config) that keeps enough threads over the grid.
// Bit-identity: every output is one fmaf(w, x, acc) chain over k ascending
// from 0.f, rounded once by repro::from_f32, as in colwise_nm_strips.cu, so
// the kernels give the same bits.  A ragged k_kept is a loop bound, and an
// index outside [0, K) fills its slice row with NaN instead of reading out of
// bounds, so it reaches exactly its tile's rows.
#include "common.cuh"

namespace {

constexpr int kBK = 16;           // kept rows of one ring slice
constexpr int kStages = 2;        // ring slots
constexpr int kMaxThreads = 256;  // threads of a block, at most

// Shared-memory bytes, also computed by
// repro_torch/kernels/colwise_nm/kernel.py::strips_tiled_smem_bytes: the
// values [k_kept, tp] and the ring [kStages, lanes, kBK, v] in the operands'
// dtype, and the indices.
size_t tiled_smem(int k_kept, int tp, int lanes, int v, int itemsize) {
  return static_cast<size_t>(k_kept) * tp * itemsize +
         static_cast<size_t>(kStages) * lanes * kBK * v * itemsize +
         static_cast<size_t>(4) * k_kept;
}

// Position in a block's walk: slice i is k-chunk `chunk` of row-group pass
// `pass` of the block's strip step `sl` (its strips sl*lanes ..
// sl*lanes + lanes-1, side by side).
struct Walk {
  int i, sl, pass, chunk;
  __device__ __forceinline__ void next(int passes, int n_chunks) {
    ++i;
    if (++chunk == n_chunks) {
      chunk = 0;
      if (++pass == passes) {
        pass = 0;
        ++sl;
      }
    }
  }
};

template <typename T, int CPT>
__global__ void __launch_bounds__(kMaxThreads)
strips_tiled_kernel(const T* __restrict__ strips, const T* __restrict__ values,
                    const int* __restrict__ idx, T* __restrict__ out, int n_strips, int k_rows,
                    int v, int n_tiles, int k_kept, int tile, int hb, int lanes, int rg,
                    int passes, int tp) {
  constexpr int VEC = 16 / sizeof(T);  // elements of one 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_val = reinterpret_cast<T*>(smem);               // [k_kept, tp]
  T* ring = s_val + static_cast<size_t>(k_kept) * tp;  // [kStages, lanes, kBK, v]
  const int slot_elems = lanes * kBK * v;
  int* s_idx = reinterpret_cast<int*>(ring + kStages * slot_elems);  // [k_kept]

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  // block -> (strip group, tile), tiles fastest: the blocks that read one
  // strip run side by side and share its rows in L2
  const int t = blockIdx.x % n_tiles;
  const int s_begin = (blockIdx.x / n_tiles) * hb;
  const int n_s = min(hb, n_strips - s_begin);
  const int n_chunks = (k_kept + kBK - 1) / kBK;
  const int n_slices = (n_s + lanes - 1) / lanes * passes * n_chunks;
  const T* vals_t = values + static_cast<long long>(t) * k_kept * tile;
  const int* idx_t = idx + static_cast<long long>(t) * k_kept;
  const long long out_ld = static_cast<long long>(n_strips) * v;
  const T nan_t = repro::from_f32<T>(repro::quiet_nan());

  // copy role: 16-byte chunk `cp_ch` of kept rows cp_row, cp_row + cp_step,
  // ... of strip lane `cp_lane`, each lane copied by its own threads
  const int lane_threads = nt / lanes;
  const int row_chunks = v / VEC;
  const int cp_lane = tid / lane_threads;
  const int cp_ch = tid % row_chunks;
  const int cp_row = (tid % lane_threads) / row_chunks;
  const int cp_step = lane_threads / row_chunks;
  // FMA role: columns CPT*col .. CPT*col + CPT-1, row group g of each pass,
  // of strip lane `lane`
  const int nc = v / CPT;
  const int col = tid % nc;
  const int g = (tid / nc) % rg;
  const int lane = tid / (nc * rg);

  // idx[t] first: every gather waits on it
  if (reinterpret_cast<uintptr_t>(idx_t) % 16 == 0 && k_kept % 4 == 0) {
    for (int e = tid; e < k_kept / 4; e += nt) repro::cp_async16(s_idx + 4 * e, idx_t + 4 * e);
  } else {
    for (int e = tid; e < k_kept; e += nt) repro::cp_async4(s_idx + e, idx_t + e);
  }
  repro::cp_async_commit();
  repro::cp_async_wait<0>();
  __syncthreads();
  // values[t] once a block, in its own dtype, rows padded with zeros to tp:
  // one copy group ahead of the ring's, so it lands with slice 0
  const long long val_bytes = static_cast<long long>(k_kept) * tile * sizeof(T);
  if (tp == tile && reinterpret_cast<uintptr_t>(vals_t) % 16 == 0 && val_bytes % 16 == 0) {
    const char* src = reinterpret_cast<const char*>(vals_t);
    char* dst = reinterpret_cast<char*>(s_val);
    for (long long e = tid; e < val_bytes / 16; e += nt) {
      repro::cp_async16(dst + 16 * e, src + 16 * e);
    }
  } else {
    const T zero = repro::from_f32<T>(0.f);
    for (int e = tid; e < k_kept * tp; e += nt) {
      const int k = e / tp;
      const int f = e - k * tp;
      if (f >= tile) {
        s_val[e] = zero;
      } else if constexpr (sizeof(T) == 4) {
        repro::cp_async4(s_val + e, vals_t + static_cast<long long>(k) * tile + f);
      } else {
        s_val[e] = vals_t[static_cast<long long>(k) * tile + f];
      }
    }
  }
  repro::cp_async_commit();

  auto issue = [&](const Walk& w, int slot) {
    if (w.i < n_slices) {
      const int k0 = w.chunk * kBK;
      const int nk = min(kBK, k_kept - k0);
      const int sl = w.sl * lanes + cp_lane;  // this lane's strip, of the block's
      if (sl < n_s) {
        const T* strip = strips + static_cast<long long>(s_begin + sl) * k_rows * v + cp_ch * VEC;
        T* dst = ring + slot * slot_elems + cp_lane * kBK * v + cp_ch * VEC;
        for (int kk = cp_row; kk < nk; kk += cp_step) {
          const int r = s_idx[k0 + kk];
          if (r >= 0 && r < k_rows) {
            repro::cp_async16(dst + kk * v, strip + static_cast<long long>(r) * v);
          } else {
#pragma unroll
            for (int q = 0; q < VEC; ++q) dst[kk * v + q] = nan_t;
          }
        }
      }
    }
    repro::cp_async_commit();  // empty past the walk's end: the group count stays uniform
  };

  Walk iw{0, 0, 0, 0};
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    issue(iw, p);
    iw.next(passes, n_chunks);
  }
  float acc[repro::kRows][CPT];
#pragma unroll
  for (int r = 0; r < repro::kRows; ++r) {
#pragma unroll
    for (int q = 0; q < CPT; ++q) acc[r][q] = 0.f;
  }

  Walk cw{0, 0, 0, 0};
  int slot = 0;
  int fill = kStages - 1;
  for (; cw.i < n_slices; cw.next(passes, n_chunks)) {
    repro::cp_async_wait<kStages - 2>();  // this thread's copies of slice i landed
    __syncthreads();  // everyone's landed; slot fill was last read by slice i-1
    issue(iw, fill);
    iw.next(passes, n_chunks);
    fill = fill + 1 == kStages ? 0 : fill + 1;

    const int k0 = cw.chunk * kBK;
    const int nk = min(kBK, k_kept - k0);
    const int grp = cw.pass * rg + g;  // 8-row group of the tile
    const T* xs = ring + slot * slot_elems + lane * kBK * v + col * CPT;
    const T* ws = s_val + static_cast<long long>(k0) * tp + grp * repro::kRows;
    auto fma_row = [&](int kk) {
      float x[CPT];
      repro::load_cols(xs + kk * v, x);
      float w[repro::kRows];
      repro::load_rows(ws + kk * tp, w);
#pragma unroll
      for (int r = 0; r < repro::kRows; ++r) {
#pragma unroll
        for (int q = 0; q < CPT; ++q) acc[r][q] = fmaf(w[r], x[q], acc[r][q]);
      }
    };
    if (nk == kBK) {  // a whole slice: unrolled without a guard, loads hoisted
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) fma_row(kk);
    } else {
      for (int kk = 0; kk < nk; ++kk) fma_row(kk);
    }
    slot = slot + 1 == kStages ? 0 : slot + 1;

    if (cw.chunk == n_chunks - 1) {  // this (strip, pass) is done: write its rows
      const int sl = cw.sl * lanes + lane;  // a lane past the block's strips stores nothing
      T* o = out + static_cast<long long>(s_begin + sl) * v + col * CPT;
#pragma unroll
      for (int r = 0; r < repro::kRows; ++r) {
        const int f = grp * repro::kRows + r;
        if (f < tile && sl < n_s) {
          repro::store_cols(o + (static_cast<long long>(t) * tile + f) * out_ld, acc[r]);
        }
#pragma unroll
        for (int q = 0; q < CPT; ++q) acc[r][q] = 0.f;
      }
    }
  }
}

template <typename T, int CPT>
int launch(const void* strips, const void* values, const int* idx, void* out, int n_strips,
           int k_rows, int v, int n_tiles, int k_kept, int tile, int hb, int lanes, int rg,
           size_t smem, cudaStream_t st) {
  const int groups = (tile + repro::kRows - 1) / repro::kRows;
  const int passes = (groups + rg - 1) / rg;
  const int tp = passes * rg * repro::kRows;
  auto kernel = strips_tiled_kernel<T, CPT>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>((n_strips + hb - 1) / hb) * n_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), (v / CPT) * rg * lanes, smem, st>>>(
      static_cast<const T*>(strips), static_cast<const T*>(values), idx, static_cast<T*>(out),
      n_strips, k_rows, v, n_tiles, k_kept, tile, hb, lanes, rg, passes, tp);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_instance(int cpt, const void* strips, const void* values, const int* idx, void* out,
                    int n_strips, int k_rows, int v, int n_tiles, int k_kept, int tile, int hb,
                    int lanes, int rg, size_t smem, cudaStream_t st) {
  switch (cpt) {
    case 1:
      return launch<T, 1>(strips, values, idx, out, n_strips, k_rows, v, n_tiles, k_kept, tile,
                          hb, lanes, rg, smem, st);
    case 2:
      return launch<T, 2>(strips, values, idx, out, n_strips, k_rows, v, n_tiles, k_kept, tile,
                          hb, lanes, rg, smem, st);
    case 4:
      return launch<T, 4>(strips, values, idx, out, n_strips, k_rows, v, n_tiles, k_kept, tile,
                          hb, lanes, rg, smem, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_checked(const void* strips, const void* values, const void* idx, void* out, int dtype,
                   int n_strips, int k_rows, int v, int n_tiles, int k_kept, int tile, int hb,
                   int lanes, int cpt, int rg, long long smem_bytes, void* stream) {
  const int itemsize = dtype == repro::kDtypeF32 ? 4 : 2;
  const int groups = (tile + repro::kRows - 1) / repro::kRows;
  if (n_strips <= 0 || k_rows <= 0 || v <= 0 || n_tiles <= 0 || k_kept <= 0 || tile <= 0 ||
      hb <= 0 || lanes <= 0 || lanes > hb || rg <= 0 || rg > groups ||
      (cpt != 1 && cpt != 2 && cpt != 4) || (v * itemsize) % 16 != 0 || v % cpt != 0 ||
      (v / cpt) * rg * lanes > kMaxThreads || reinterpret_cast<uintptr_t>(strips) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tp = (groups + rg - 1) / rg * rg * repro::kRows;
  const size_t smem = tiled_smem(k_kept, tp, lanes, v, itemsize);
  if (static_cast<long long>(smem) != smem_bytes) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const int* ids = static_cast<const int*>(idx);
  if (dtype == repro::kDtypeF32) {
    return launch_instance<float>(cpt, strips, values, ids, out, n_strips, k_rows, v, n_tiles,
                                  k_kept, tile, hb, lanes, rg, smem, st);
  }
  if (dtype == repro::kDtypeBF16) {
    return launch_instance<__nv_bfloat16>(cpt, strips, values, ids, out, n_strips, k_rows, v,
                                          n_tiles, k_kept, tile, hb, lanes, rg, smem, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// strips: [n_strips, k_rows, v], 16-byte aligned, v * itemsize a multiple
// of 16; values: [n_tiles, k_kept, tile]; idx: [n_tiles, k_kept] int32; out:
// [n_tiles*tile, n_strips*v], 16-byte aligned.  All contiguous.  The
// instance: cpt columns a thread (1, 2 or 4), rg 8-row groups a pass (at
// most the tile's, and (v / cpt) * rg * lanes <= 256 threads).  smem_bytes
// must equal this kernel's layout (tiled_smem).
//
// One strip a block (the strip GEMM).
extern "C" int repro_colwise_nm_strips_tiled(const void* strips, const void* values,
                                             const void* idx, void* out, int dtype,
                                             int n_strips, int k_rows, int v, int n_tiles,
                                             int k_kept, int tile, int cpt, int rg,
                                             long long smem_bytes, void* stream) {
  return launch_checked(strips, values, idx, out, dtype, n_strips, k_rows, v, n_tiles, k_kept,
                        tile, 1, 1, cpt, rg, smem_bytes, stream);
}

// hb strips a block (the pipelined strip GEMM), `lanes` of them side by side
// (1 <= lanes <= hb), the ring running across the steps of lanes strips.
extern "C" int repro_colwise_nm_strips_pipelined_tiled(
    const void* strips, const void* values, const void* idx, void* out, int dtype, int n_strips,
    int k_rows, int v, int n_tiles, int k_kept, int tile, int hb, int lanes, int cpt, int rg,
    long long smem_bytes, void* stream) {
  return launch_checked(strips, values, idx, out, dtype, n_strips, k_rows, v, n_tiles, k_kept,
                        tile, hb, lanes, cpt, rg, smem_bytes, stream);
}
