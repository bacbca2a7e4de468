// Fused im2col + pack + column-wise N:M sparse GEMM conv for Hopper, over a
// ring of dense im2col slices that a block gathers once for a group of tiles.
//
// Replaces: src/repro/kernels/conv_gemm/kernel.py::conv2d_fused_pallas
// (_kernel), the TPU megakernel that keeps the whole CNHW map in VMEM and
// gathers each kept (kh, kw, c) row of a strip from it.  csrc/conv2d_fused.cu
// keeps the calls the shape rule (kernel.py::fused_tiled_takes) refuses and
// is this kernel's bitwise yardstick.
//
// Computes out[t*T + f, p] = sum_k values[t, k, f] * X[idx[t, k], p] where X
// is the im2col matrix of the CNHW map x (row r = (ikh*kw + ikw)*C + c,
// column p = (batch, oh, ow)), zero off the map and past the last position.
// float32 accumulation; f32 or bf16 operands; output in the operands' dtype.
//
// Bound: bytes at resnet-tiny's convs (two tiles of 8 rows, so a gathered
// element feeds at most 16 FMAs); operations (f32 on the CUDA cores) at
// ResNet-18's layer3 and layer4 at batch 8 (32 and 64 tiles, k_kept 1152 and
// 2304).  What held conv2d_fused.cu back: one block per (strip, tile), so the
// n_tiles blocks of a strip each gathered its kept rows again (16x the
// im2col's elements at layer3), one scalar global load per kept row and
// thread, behind three shared reads and the bounds tests, feeding 8 FMAs,
// with no load in flight ahead of its use.
//
// Design: a block is (a run of NP = 32*CPT positions, a group of up to 8
// whole tiles).  It walks the *dense* im2col rows in slices of BK (16, 32,
// 64 or 128), ascending, and gathers each slice once for its positions into
// a two-slot ring in shared memory, one slice ahead of the FMAs: by 4-byte
// cp.async with zero fill in f32 (off-map taps and past-the-end positions
// land as +0; rows past K are never read, so never copied), and in bf16,
// whose 2-byte elements cannot be cp.async'ed, by loads into registers
// before a slice's FMAs and stores to the ring after them.  Each dense row
// is decoded once a block into a shared table and each copied position once
// into registers; neighbouring positions are neighbouring ow, so the copies
// coalesce along W.  The block reads idx once (four entries at a time) into
// each tile's first kept row at or past each slice; a warp owns one 8-row
// group of one tile and takes its tile's kept rows that fall in the slice,
// in order, from the ring slot, which also carries those rows' 8 values and
// indices (16- and 4-byte cp.async by the owning warp, one slice ahead).  A
// thread owns 4 of the 8 rows at 2*CPT positions: a kept row costs it one
// broadcast load of its tile's index, one 8- to 32-byte load of its
// positions and one 16-byte load of its 4 values (8 bytes in bf16), for
// 8*CPT FMAs, and a gathered element feeds up to 8 tiles.
// What the sweep (kernels/conv_gemm/tune.py) showed: the kernel is bound by
// each SM's shared-memory wavefronts, not by the gather's latency (2, 4 or
// 8 ring slots read alike, so the ring has 2), so the thread tile was cut
// from 8 rows x CPT positions (every lane loading all 8 values of a kept
// row) to 4 x 2*CPT; taller slices cut the barriers and the tiles'
// imbalance between them.  Left to itself ptxas held the f32 instances at
// CPT 1 to 64 registers; launch bounds of one block an SM let it take 99
// (114 at CPT 2) and keep more of the unrolled loops' loads in flight:
// 10-15% faster at ResNet-18's layer3/4 and 6% at resnet-tiny, 20% slower
// at layer1/2, whose 3-4 blocks an SM no longer fit the register file.
// The instance (CPT, tiles a block, BK) is a rule of the shape
// (kernel.py::fused_tiled_config) fitted to that sweep.
//
// Bit identity: every output is one fmaf(w, x, acc) chain over k = 0 ..
// k_kept-1 from 0.f, rounded once by repro::from_f32, with +0 for an off-map
// tap, as in conv2d_fused.cu.  Walking ascending slices meets a tile's kept
// rows in k order only where idx[t] is strictly ascending, as the format
// says (core/formats.py) but the wrapper cannot check without reading the
// device.  So the block checks each tile when it reads idx[t]: a tile that
// is not strictly ascending, or that holds an index outside [0, K), skips
// the ring and afterwards walks its kept rows one by one in k order,
// gathering from the map as conv2d_fused.cu does.  That path gives the same
// bits, and an index outside [0, K) gives NaN in exactly its tile's rows.
// Past-the-end positions are written as 0, as there.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;  // threads of a block, at most: 8 warps
constexpr int kMaxHeld = 16;      // bf16: map elements a thread carries a slice
constexpr int kFar = -(1 << 29);  // a tap row or column off any map
constexpr int kHalf = repro::kRows / 2;  // output rows a thread: half its warp's 8

// Shared-memory bytes, also computed by
// repro_torch/kernels/conv_gemm/kernel.py::fused_tiled_smem_bytes: the
// two-slot ring's map slices [2, bk, np] and kept rows' values [2, rgb, bk,
// kRows] in the operands' dtype, the row table [k_rows] (int2), the ring's
// kept-row indices [2, group, bk], each tile's slice bounds [group,
// n_slices + 1] and its bad flag [group].
size_t tiled_smem(int k_rows, int np, int group, int rgb, int bk, int itemsize) {
  const size_t n_sl = (k_rows + bk - 1) / bk;
  return static_cast<size_t>(2) * bk * (np + rgb * repro::kRows) * itemsize +
         static_cast<size_t>(8) * k_rows +
         static_cast<size_t>(4) * (2 * group * bk + group * (n_sl + 1) + group);
}

// Map offset of output position p's (0, 0) tap, and that tap's row and
// column: far off the map for a position past the end.
__device__ __forceinline__ void position(int p, const repro::ConvGeom& g, int& base, int& ih0,
                                         int& iw0) {
  int bb;
  if (repro::decode_position(p, g, bb, ih0, iw0)) {
    base = (bb * g.h + ih0) * g.w + iw0;
  } else {
    base = 0;
    ih0 = iw0 = kFar;
  }
}

template <typename T, int CPT, int BK>
__global__ void __launch_bounds__(kMaxThreads, 1)  // registers over occupancy: see above
fused_tiled_kernel(const T* __restrict__ x, const T* __restrict__ values,
                   const int* __restrict__ idx, T* __restrict__ out, repro::ConvGeom g,
                   int n_tiles, int k_kept, int tile, int group) {
  constexpr int NP = 32 * CPT;  // positions of a block
  constexpr int P = 2 * CPT;    // positions of a thread, beside kHalf rows
  constexpr int kRows = repro::kRows;
  constexpr bool kAsync = sizeof(T) == 4;  // the map slices by cp.async
  extern __shared__ __align__(16) unsigned char smem[];
  const int rgt = tile / kRows;  // 8-row groups of a tile
  const int rgb = group * rgt;   // of the block: one warp each
  const int k_rows = g.kh * g.kw * g.c;
  const int n_sl = (k_rows + BK - 1) / BK;
  T* ring_x = reinterpret_cast<T*>(smem);                                     // [2, BK, NP]
  T* ring_w = ring_x + 2 * BK * NP;                                           // [2, rgb, BK, 8]
  int2* s_row = reinterpret_cast<int2*>(ring_w + 2 * rgb * BK * kRows);      // [k_rows]
  int* ring_i = reinterpret_cast<int*>(s_row + k_rows);                      // [2, group, BK]
  int* s_bnd = ring_i + 2 * group * BK;                                      // [group, n_sl + 1]
  int* s_bad = s_bnd + group * (n_sl + 1);                                   // [group]

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  // block -> (position run, tile group), groups fastest: the blocks that
  // gather one run's map lines run side by side and share them in L2
  const int n_groups = (n_tiles + group - 1) / group;
  const int tg = blockIdx.x % n_groups;
  const int p0 = (blockIdx.x / n_groups) * NP;
  const int n_pos = g.b * g.ho * g.wo;
  const long long out_ld = static_cast<long long>(g.n_strips) * g.v;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int tl = warp / rgt;      // the warp's tile, of the group ...
  const int q = warp - tl * rgt;  // ... and its 8-row group;
  const int half = lane / 16;     // the thread's 4 rows of it ...
  const int pl = lane % 16;       // ... at positions pl*P .. pl*P + P-1
  const int t = tg * group + tl;
  const bool has_tile = t < n_tiles;  // the last group may be short
  const long long t_safe = has_tile ? t : 0;
  const T* vals_t = values + t_safe * k_kept * tile + q * kRows;
  const int* idx_t = idx + t_safe * k_kept;

  float acc[kHalf][P];
#pragma unroll
  for (int r = 0; r < kHalf; ++r) {
#pragma unroll
    for (int c = 0; c < P; ++c) acc[r][c] = 0.f;
  }
  // the thread's 4 rows at its P positions; past-the-end positions hold 0
  auto store = [&]() {
    T* o = out + (t_safe * tile + q * kRows + half * kHalf) * out_ld + p0 + pl * P;
#pragma unroll
    for (int r = 0; r < kHalf; ++r) {
      float v[P];
#pragma unroll
      for (int c = 0; c < P; ++c) v[c] = p0 + pl * P + c < n_pos ? acc[r][c] : 0.f;
      repro::store_cols(o + r * out_ld, v);
    }
  };
  if (p0 >= n_pos) {  // a run wholly past the last position
    if (has_tile) store();
    return;
  }

  // the copy role: positions cp_p + j*nt (j < ppt) of rows cp_r, cp_r + rs,
  // ... of each slice, the positions decoded once into registers
  const int rs = nt >= NP ? nt / NP : 1;
  const int ppt = nt >= NP ? 1 : NP / nt;
  const int cp_p = tid % NP;
  const int cp_r = nt >= NP ? tid / NP : 0;
  int pb[CPT], ph[CPT], pw[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    if (j < ppt) position(p0 + cp_p + j * nt, g, pb[j], ph[j], pw[j]);
  }

  // the tables: each dense row's channel-and-tap offset and tap; per tile,
  // the first kept row at or past each slice, and whether idx[t] is
  // strictly ascending within [0, K)
  const int plane = g.b * g.h * g.w;  // one channel of x
  for (int r = tid; r < k_rows; r += nt) {
    const int tap = r / g.c;
    const int ikh = tap / g.kw;
    const int ikw = tap - ikh * g.kw;
    s_row[r] = make_int2((r - tap * g.c) * plane + ikh * g.w + ikw, (ikh << 16) | ikw);
  }
  for (int e = tid; e < group; e += nt) s_bad[e] = 0;
  __syncthreads();
  const int n_quads = (k_kept + 3) / 4;  // a thread reads 4 kept rows at once
  for (int e = tid; e < group * n_quads; e += nt) {
    const int gl = e / n_quads;
    const int k0 = (e - gl * n_quads) * 4;
    if (tg * group + gl >= n_tiles) continue;
    const int* it = idx + static_cast<long long>(tg * group + gl) * k_kept;
    int r[5];  // idx[t][k0-1 .. k0+3], independent loads in flight together
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const int k = k0 - 1 + j;
      r[j] = k < 0 ? -1 : k < k_kept ? it[k] : 0;
    }
    int* bnd = s_bnd + gl * (n_sl + 1);
#pragma unroll
    for (int j = 1; j < 5; ++j) {
      const int k = k0 + j - 1;
      if (k < k_kept) {
        if (r[j] < 0 || r[j] >= k_rows || r[j] <= r[j - 1]) {
          s_bad[gl] = 1;
        } else {
          for (int s = r[j - 1] < 0 ? 0 : r[j - 1] / BK + 1; s <= r[j] / BK; ++s) bnd[s] = k;
          if (k == k_kept - 1) {
            for (int s = r[j] / BK + 1; s <= n_sl; ++s) bnd[s] = k_kept;
          }
        }
      }
    }
  }
  __syncthreads();
  const bool good = has_tile && s_bad[tl] == 0;  // warp-uniform
  const int* bnd = s_bnd + tl * (n_sl + 1);

  // the kept rows of the warp's tile in slice i: their values (the warp's 8
  // of each) and, by the tile's first warp, their indices
  auto stage_rows = [&](int i, int slot) {
    if (!good) return;
    constexpr int VEC = 16 / sizeof(T);  // values of one 16-byte copy
    constexpr int CH = kRows / VEC;      // copies of a row's 8 values
    const int kb = bnd[i];
    const int n = bnd[i + 1] - kb;
    T* dst = ring_w + (slot * rgb + warp) * BK * kRows;
    for (int e = lane; e < n * CH; e += 32) {
      const int part = (e % CH) * VEC;
      repro::cp_async16(dst + (e / CH) * kRows + part,
                        vals_t + static_cast<long long>(kb + e / CH) * tile + part);
    }
    if (q == 0) {
      for (int e = lane; e < n; e += 32) {
        repro::cp_async4(ring_i + (slot * group + tl) * BK + e, idx_t + kb + e);
      }
    }
  };
  // dense row i*BK + m's map offset and tap; rows past K are never read
  auto row_of = [&](int i, int m, int& off, int& ikh, int& ikw) {
    const int2 rc = s_row[i * BK + m];
    off = rc.x;
    ikh = rc.y >> 16;
    ikw = rc.y & 0xffff;
  };
  auto on_map = [&](int j, int ikh, int ikw) {
    return static_cast<unsigned>(ph[j] + ikh) < static_cast<unsigned>(g.h) &&
           static_cast<unsigned>(pw[j] + ikw) < static_cast<unsigned>(g.w);
  };
  T held[kAsync ? 1 : kMaxHeld];  // bf16: the next slice, between its load and store
  auto fetch = [&](int i, int slot) {  // slice i into ring slot `slot` (f32), or registers
    if (i < n_sl) {
      const int rows = min(BK, k_rows - i * BK);
      if constexpr (kAsync) {
        // unrolled: several rows' table loads in flight before their copies
#pragma unroll 4
        for (int m = cp_r; m < rows; m += rs) {
          int off, ikh, ikw;
          row_of(i, m, off, ikh, ikw);
          T* dst = ring_x + (slot * BK + m) * NP + cp_p;
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            if (j < ppt) {
              const bool valid = on_map(j, ikh, ikw);
              repro::cp_async4_zfill(dst + j * nt, valid ? x + (pb[j] + off) : x, valid);
            }
          }
        }
      } else {  // one position a thread (ppt == 1), at most kMaxHeld rows
#pragma unroll
        for (int mm = 0; mm < kMaxHeld; ++mm) {
          const int m = cp_r + mm * rs;
          if (m < rows) {
            int off, ikh, ikw;
            row_of(i, m, off, ikh, ikw);
            held[mm] = on_map(0, ikh, ikw) ? x[pb[0] + off] : repro::from_f32<T>(0.f);
          }
        }
      }
      stage_rows(i, slot);
    }
    repro::cp_async_commit();  // empty past the walk's end: the group count stays uniform
  };
  auto keep = [&](int i, int slot) {  // bf16: the held slice into its slot
    if constexpr (!kAsync) {
      if (i < n_sl) {
        const int rows = min(BK, k_rows - i * BK);
#pragma unroll
        for (int mm = 0; mm < kMaxHeld; ++mm) {
          const int m = cp_r + mm * rs;
          if (m < rows) ring_x[(slot * BK + m) * NP + cp_p] = held[mm];
        }
      }
    }
  };

  fetch(0, 0);
  keep(0, 0);
  for (int i = 0; i < n_sl; ++i) {
    const int slot = i & 1;
    repro::cp_async_wait<0>();  // this thread's copies of slice i landed
    __syncthreads();  // everyone's landed; slot 1-slot was last read by slice i-1
    fetch(i + 1, 1 - slot);
    if (good) {
      const int n = bnd[i + 1] - bnd[i];
      const T* xs = ring_x + slot * BK * NP + pl * P;
      const T* ws = ring_w + (slot * rgb + warp) * BK * kRows + half * kHalf;
      const int* is = ring_i + (slot * group + tl) * BK;
      const int r0 = i * BK;
#pragma unroll 8
      for (int kk = 0; kk < n; ++kk) {
        float xv[P];
        repro::load_cols(xs + (is[kk] - r0) * NP, xv);
        float w[kHalf];
        repro::load4(ws + kk * kRows, w);
#pragma unroll
        for (int r = 0; r < kHalf; ++r) {
#pragma unroll
          for (int c = 0; c < P; ++c) acc[r][c] = fmaf(w[r], xv[c], acc[r][c]);
        }
      }
    }
    keep(i + 1, 1 - slot);
  }

  if (has_tile && !good) {
    // idx[t] is not strictly ascending, or holds an index outside [0, K):
    // its kept rows one by one in k order, gathered from the map
    int base[P], ih0[P], iw0[P];
#pragma unroll
    for (int c = 0; c < P; ++c) position(p0 + pl * P + c, g, base[c], ih0[c], iw0[c]);
    for (int k = 0; k < k_kept; ++k) {
      const int r = idx_t[k];
      float xv[P];
#pragma unroll
      for (int c = 0; c < P; ++c) {
        if (r < 0 || r >= k_rows) {
          xv[c] = repro::quiet_nan();
        } else {
          const int2 rc = s_row[r];
          const int ih = ih0[c] + (rc.y >> 16);
          const int iw = iw0[c] + (rc.y & 0xffff);
          xv[c] = static_cast<unsigned>(ih) < static_cast<unsigned>(g.h) &&
                          static_cast<unsigned>(iw) < static_cast<unsigned>(g.w)
                      ? repro::to_f32(x[base[c] + rc.x])
                      : 0.f;
        }
      }
      const T* wk = vals_t + static_cast<long long>(k) * tile + half * kHalf;
#pragma unroll
      for (int r = 0; r < kHalf; ++r) {
        const float w = repro::to_f32(wk[r]);
#pragma unroll
        for (int c = 0; c < P; ++c) acc[r][c] = fmaf(w, xv[c], acc[r][c]);
      }
    }
  }
  if (has_tile) store();
}

template <typename T, int CPT, int BK>
int launch(const void* x, const void* values, const int* idx, void* out, const repro::ConvGeom& g,
           int n_tiles, int k_kept, int tile, int group, size_t smem, cudaStream_t st) {
  auto kernel = fused_tiled_kernel<T, CPT, BK>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long runs = static_cast<long long>(g.n_strips) * g.v / (32 * CPT);
  const long long blocks = runs * ((n_tiles + group - 1) / group);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), 32 * group * (tile / repro::kRows), smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(values), idx, static_cast<T*>(out), g,
      n_tiles, k_kept, tile, group);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BK>
int launch_cpt(int cpt, const void* x, const void* values, const int* idx, void* out,
               const repro::ConvGeom& g, int n_tiles, int k_kept, int tile, int group,
               size_t smem, cudaStream_t st) {
  switch (cpt) {
    case 1:
      return launch<T, 1, BK>(x, values, idx, out, g, n_tiles, k_kept, tile, group, smem, st);
    case 2:
      return launch<T, 2, BK>(x, values, idx, out, g, n_tiles, k_kept, tile, group, smem, st);
    case 4:
      return launch<T, 4, BK>(x, values, idx, out, g, n_tiles, k_kept, tile, group, smem, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_instance(int cpt, int bk, const void* x, const void* values, const int* idx, void* out,
                    const repro::ConvGeom& g, int n_tiles, int k_kept, int tile, int group,
                    size_t smem, cudaStream_t st) {
  if (bk == 16) {
    return launch_cpt<T, 16>(cpt, x, values, idx, out, g, n_tiles, k_kept, tile, group, smem, st);
  }
  if (bk == 32) {
    return launch_cpt<T, 32>(cpt, x, values, idx, out, g, n_tiles, k_kept, tile, group, smem, st);
  }
  if (bk == 64) {
    return launch_cpt<T, 64>(cpt, x, values, idx, out, g, n_tiles, k_kept, tile, group, smem, st);
  }
  if (bk == 128) {
    return launch_cpt<T, 128>(cpt, x, values, idx, out, g, n_tiles, k_kept, tile, group, smem, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: [c, b, h, w] with fewer than 2^31 elements; values: [n_tiles, k_kept,
// tile], 16-byte aligned; idx: [n_tiles, k_kept] int32 (rows of the (kh, kw,
// c)-flattened reduction dim); out: [n_tiles*tile, n_strips*v], 16-byte
// aligned.  All contiguous.  The instance: cpt (1, 2 or 4; a block runs 32 *
// cpt positions, v a multiple of it), group tiles a block (tile a multiple
// of 8, 32 * group * tile / 8 <= 256 threads, a multiple or a divisor of
// the block's positions) and bk dense rows a slice (16, 32, 64 or 128).  In bf16 a
// thread carries one position of at most kMaxHeld rows a slice: threads >=
// 32 * cpt * bk / kMaxHeld.  smem_bytes must equal this kernel's layout
// (tiled_smem).
extern "C" int repro_conv2d_fused_tiled(const void* x, const void* values, const void* idx,
                                        void* out, int dtype, int c, int b, int h, int w,
                                        int kh, int kw, int stride, int pad, int ho, int wo,
                                        int v, int n_strips, int n_tiles, int k_kept, int tile,
                                        int cpt, int group, int bk, long long smem_bytes,
                                        void* stream) {
  const int itemsize = dtype == repro::kDtypeF32 ? 4 : 2;
  const long long threads = 32LL * group * (tile / repro::kRows);
  const long long np = 32LL * cpt;
  if (n_strips <= 0 || n_tiles <= 0 || k_kept <= 0 || tile <= 0 || tile % repro::kRows != 0 ||
      group <= 0 || threads > kMaxThreads || (cpt != 1 && cpt != 2 && cpt != 4) || v <= 0 ||
      v % np != 0 || (threads % np != 0 && np % threads != 0) || (bk != 16 && bk != 32 && bk != 64 && bk != 128) ||
      (itemsize == 2 && threads * kMaxHeld < np * bk) ||
      static_cast<long long>(c) * b * h * w >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(values) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = tiled_smem(kh * kw * c, 32 * cpt, group, group * (tile / repro::kRows), bk,
                                 itemsize);
  if (static_cast<long long>(smem) != smem_bytes) return static_cast<int>(cudaErrorInvalidValue);
  const repro::ConvGeom g{c, b, h, w, kh, kw, stride, pad, ho, wo, v, n_strips};
  auto st = static_cast<cudaStream_t>(stream);
  const int* ids = static_cast<const int*>(idx);
  if (dtype == repro::kDtypeF32) {
    return launch_instance<float>(cpt, bk, x, values, ids, out, g, n_tiles, k_kept, tile, group,
                                  smem, st);
  }
  if (dtype == repro::kDtypeBF16) {
    return launch_instance<__nv_bfloat16>(cpt, bk, x, values, ids, out, g, n_tiles, k_kept, tile,
                                          group, smem, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
