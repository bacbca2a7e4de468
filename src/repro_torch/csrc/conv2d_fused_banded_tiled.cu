// Banded fused im2col + pack + column-wise N:M sparse GEMM conv for Hopper,
// register-tiled over a zero-padded shared window, bit-identical to
// conv2d_fused_banded.cu (and so to conv2d_fused.cu).
//
// Replaces: src/repro/kernels/conv_gemm/kernel.py::conv2d_fused_banded_pallas
// (_banded_kernel, :300), the TPU megakernel that keeps only a double-
// buffered row band [C, band_rows, W] of the [C, B*H, W] map in VMEM.  Serves
// the shapes repro_torch/kernels/conv_gemm/kernel.py::banded_tiled_takes
// accepts: tiles of a multiple of 8 rows, map rows of whole 16-byte copies, a
// 16-byte aligned map, and a window plus one tile's staged weights within a
// block's 227 KB; conv2d_fused_banded.cu keeps the others.
//
// Bound: at resnet-tiny's five pruned convs (batch 256, f32) bytes and
// operations are on a par: about 19 MB (5.8 us at 3.35 TB/s) against 153 M
// FMAs (4.6 us at 67 TFLOP/s).  conv2d_fused_banded.cu took 27x its bound:
// each of a band's tile-blocks copied the same window; every strip restaged
// the weights and the decoded taps between two barriers; and each of its
// FMAs came with a scalar shared load and a dozen integer instructions
// (tap_shift's bounds tests, the row rebase, the window test).
//
// Design:
// - One block per band walks every output row of the band (all tiles), so
//   the window is copied once per band.  The grid is the bands, at most as
//   many blocks as the card holds at once (SM count x occupancy, queried
//   once an instance, device and shared-memory size); a block walks band
//   blockIdx.x and every gridDim.x-th band after it, and copies the next
//   band's window once it is done with the current one.  One window: at
//   resnet-tiny and ResNet-18 layer1 a block seldom walks a second band, and
//   a second window stage measured no faster (PERF.md).
// - The weights are staged as f32, [group][k_kept][T], with each kept
//   row's offset into a channel's window, c * plane + ikh * pitch + ikw.
//   Where all of values fits beside the window (group = n_tiles, as at
//   resnet-tiny) they are staged once a block and kept across its bands,
//   with no barrier but the band's.  Where they do not (ResNet-18 from
//   layer2 on), the block stages them group tiles at a time, each tile's
//   whole k_kept, with two barriers a group: an output's fmaf chain runs
//   over its tile's kept rows in registers, so chunks of k would have to
//   keep a unit's accumulators across barriers and restage the weights for
//   each round of units.  An index outside [0, K) sets its tile's flag, and
//   the tile's outputs are NaN.
// - The window is zero-padded, so the gather needs no bounds test.  In the
//   padded row space each image has pad zero rows above and below (Hp = H +
//   2 pad rows an image); output position (bb, oh, ow) reads, at tap (ikh,
//   ikw), padded row bb * Hp + oh * stride + ikh and column ow * stride -
//   pad + ikw.  A band's window holds band_rows padded rows from its top row
//   (tiled_origin below, the twin of repro_torch/kernels/conv_gemm/plan.py::
//   tiled_band_origin); a row's W values start at lead + r * pitch, 16-byte
//   aligned, and the pitch - W elements after them stay zero: that row's
//   right pad and the next row's left pad.  Rows of the map move by 16-byte
//   cp.async; pad rows, and rows past the map, land as zeros (source size 0).
//   A tap's address is then the position's base plus the kept row's offset:
//   one shared load.
// - Register tile: a warp takes 32 * P positions of one 8-row group of one
//   tile; lane l owns positions l, l + 32, ... (P of them) x the group's 8
//   rows.  A kept row costs P window loads (consecutive positions across the
//   warp), two float4 weight broadcasts and a quarter of an int4 offset
//   broadcast (a whole one where k_kept % 4 != 0) for 8 P FMAs, with no
//   barrier in the loop.  P (2 or 4) is a template parameter;
//   banded_tiled_config picks it.  A block has 256 threads.
// Bit identity with conv2d_fused_banded.cu, which this kernel keeps: each
// output is one fmaf chain over its tile's kept rows in idx order from 0.f,
// fmaf(value, x, acc) on to_f32 operands, stored once through from_f32; a
// tap in the padding reads a stored +0.f, as the other kernel's xv = 0.f,
// and is not skipped (an inf or NaN weight times 0 is NaN); positions past
// B*Ho*Wo in the ragged last strip hold 0.  Built with the same flags.  A
// position whose taps would leave the window (a band_rows short of what the
// geometry needs) gives NaN, never a neighbouring row.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kGroupRows = 8;  // output rows a thread: one 8-row group of a tile
constexpr int kTiledThreads = 256;

// The padded window's geometry (repro_torch/kernels/conv_gemm/plan.py::
// tiled_band_plan computes it).
struct TiledGeom {
  int hp;        // padded rows an image, h + 2 * pad
  int rows;      // padded rows of a window
  int lead;      // elements before row 0's values
  int pitch;     // elements from one window row to the next
  int plane;     // elements of one channel's window, lead + rows * pitch
  int band_len;  // positions a band, hb * v
  int n_bands;
  int n_pos;     // b * ho * wo
  int n_cols;    // n_strips * v, the output's columns
};

// Shared-memory bytes, also computed by
// repro_torch/kernels/conv_gemm/kernel.py::banded_tiled_smem_bytes: the
// window in the map's dtype, then a group of tiles' values in f32, their
// kept rows' offsets and each tile's flag.
size_t tiled_smem(int c, int plane, int n_tiles, int k_kept, int tile, int elem, int group) {
  return static_cast<size_t>(c) * plane * elem +
         sizeof(float) * (static_cast<size_t>(group) * k_kept * (tile + 1) + n_tiles);
}

// Padded row of band's first position at tap row 0: the window's top row.
__device__ __forceinline__ int tiled_origin(int band, const repro::ConvGeom& g,
                                            const TiledGeom& tg) {
  const int p0 = band * tg.band_len;
  const int hw = g.ho * g.wo;
  const int bb = p0 / hw;
  const int oh = (p0 - bb * hw) / g.wo;
  return bb * tg.hp + oh * g.stride;
}

// One kept row of a unit: its weights for the 8 rows (two float4
// broadcasts) times the P positions' window values at base + off, each into
// its own fmaf chain.
template <typename T, int P>
__device__ __forceinline__ void kept_row(const T* win, const int (&base)[P], int off,
                                         const float* wrow, float (&acc)[P][kGroupRows]) {
  float wk[kGroupRows];
  float w4[4];
  repro::load4(wrow, w4);
#pragma unroll
  for (int f = 0; f < 4; ++f) wk[f] = w4[f];
  repro::load4(wrow + 4, w4);
#pragma unroll
  for (int f = 0; f < 4; ++f) wk[4 + f] = w4[f];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const float xv = repro::to_f32(win[base[q] + off]);
#pragma unroll
    for (int f = 0; f < kGroupRows; ++f) acc[q][f] = fmaf(wk[f], xv, acc[q][f]);
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kTiledThreads)
banded_tiled_kernel(const T* __restrict__ x, const T* __restrict__ values,
                    const int* __restrict__ idx, T* __restrict__ out, repro::ConvGeom g,
                    TiledGeom tg, int n_tiles, int k_kept, int tile, int group) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // elements of a 16-byte copy
  constexpr int NT = kTiledThreads;
  constexpr int NW = NT / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  T* win = reinterpret_cast<T*>(smem);                                 // [C][plane]
  float* s_val = reinterpret_cast<float*>(win + g.c * tg.plane);       // [group][k_kept][T]
  int* s_off = reinterpret_cast<int*>(s_val + group * k_kept * tile);  // [group][k_kept]
  int* s_bad = s_off + group * k_kept;                                 // [n_tiles]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k_rows = g.kh * g.kw * g.c;
  const int wv = g.w / VEC;               // 16-byte copies a map row
  const int gv = (tg.pitch - g.w) / VEC;  // 16-byte zero chunks after a row
  const int lv = tg.lead / VEC;

  auto issue = [&](int band) {
    const int r0 = tiled_origin(band, g, tg);
    const int per_ch = tg.rows * wv;
    for (int e = tid; e < g.c * per_ch; e += NT) {
      const int ch = e / per_ch;
      const int rem = e - ch * per_ch;
      const int r = rem / wv;
      const int u = rem - r * wv;
      const int row = r0 + r;  // padded row
      const int bb = row / tg.hp;
      const int ih = row - bb * tg.hp - g.pad;
      const bool valid = bb < g.b && ih >= 0 && ih < g.h;
      const T* src =
          valid ? x + ((static_cast<long long>(ch) * g.b + bb) * g.h + ih) * g.w + u * VEC : x;
      repro::cp_async16_zfill(win + ch * tg.plane + tg.lead + r * tg.pitch + u * VEC, src, valid);
    }
    repro::cp_async_commit();
  };

  // tiles t0 .. t0 + group - 1 (those that exist): values as f32 and each
  // kept row's window offset; a bad index flags its tile
  auto stage = [&](int t0) {
    const int n = min(group, n_tiles - t0);
    const T* v0 = values + static_cast<long long>(t0) * k_kept * tile;
    for (int e = tid; e < n * k_kept * tile; e += NT) s_val[e] = repro::to_f32(v0[e]);
    for (int e = tid; e < n * k_kept; e += NT) {
      const int r = idx[t0 * k_kept + e];
      if (r >= 0 && r < k_rows) {
        const int tap = r / g.c;
        const int ikh = tap / g.kw;
        s_off[e] = (r - tap * g.c) * tg.plane + ikh * tg.pitch + (tap - ikh * g.kw);
      } else {
        s_off[e] = 0;  // a safe address; the tile's outputs become NaN
        s_bad[t0 + e / k_kept] = 1;
      }
    }
  };

  // the first band's window streams in under the prologue (the copies write
  // only the rows' values, never a margin)
  issue(blockIdx.x);
  // zeros: the window's margins, and the tile flags
  {
    const int per_plane = lv + tg.rows * gv;
    const int4 zero = make_int4(0, 0, 0, 0);
    for (int e = tid; e < g.c * per_plane; e += NT) {
      const int ch = e / per_plane;
      const int j = e - ch * per_plane;
      int at = j * VEC;
      if (j >= lv) {
        const int r = (j - lv) / gv;
        at = tg.lead + r * tg.pitch + g.w + (j - lv - r * gv) * VEC;
      }
      *reinterpret_cast<int4*>(win + ch * tg.plane + at) = zero;
    }
    for (int t = tid; t < n_tiles; t += NT) s_bad[t] = 0;
  }
  __syncthreads();
  const bool once = group >= n_tiles;  // the block's weights, kept across its bands
  if (once) stage(0);

  const int groups = tile / kGroupRows;  // 8-row groups a tile
  const int n_pc = (tg.band_len + 32 * P - 1) / (32 * P);  // position chunks a band
  const int hw = g.ho * g.wo;
  const long long out_ld = tg.n_cols;

  for (int band = blockIdx.x; band < tg.n_bands; band += gridDim.x) {
    repro::cp_async_wait<0>();
    __syncthreads();
    const int r0 = tiled_origin(band, g, tg);
    const int p_band = band * tg.band_len;
    for (int t0 = 0; t0 < n_tiles; t0 += group) {
      if (!once) {  // the previous group's units are done before it is replaced
        if (t0 > 0) __syncthreads();
        stage(t0);
        __syncthreads();
      }
      const int n_rg = min(group, n_tiles - t0) * groups;  // 8-row groups staged
      for (int u = warp; u < n_rg * n_pc; u += NW) {
        const int rg = u % n_rg;
        const int tl = rg / groups;  // the tile's place in the staged group
        const int t = t0 + tl;
        const int f0 = (rg - tl * groups) * kGroupRows;
        const int j0 = (u / n_rg) * 32 * P + lane;  // this lane's first position in the band
        int base[P];
        bool store[P], live[P], outside[P];
#pragma unroll
        for (int q = 0; q < P; ++q) {
          const int j = j0 + q * 32;
          const int p = p_band + j;
          store[q] = j < tg.band_len && p < tg.n_cols;
          live[q] = store[q] && p < tg.n_pos;
          outside[q] = false;
          base[q] = 0;
          if (live[q]) {
            const int bb = p / hw;
            const int rem = p - bb * hw;
            const int oh = rem / g.wo;
            const int ow = rem - oh * g.wo;
            const int row = bb * tg.hp + oh * g.stride - r0;  // window row of tap row 0
            if (row >= 0 && row + g.kh <= tg.rows) {
              base[q] = tg.lead + row * tg.pitch + ow * g.stride - g.pad;
            } else {
              outside[q] = true;
            }
          }
        }
        float acc[P][kGroupRows];
#pragma unroll
        for (int q = 0; q < P; ++q) {
#pragma unroll
          for (int f = 0; f < kGroupRows; ++f) acc[q][f] = 0.f;
        }
        const float* vals_t = s_val + static_cast<long long>(tl) * k_kept * tile + f0;
        const int* off_t = s_off + tl * k_kept;
        int k = 0;
        if ((k_kept & 3) == 0) {  // the tile's offsets are 16-byte aligned: 4 a load
          for (; k < k_kept; k += 4) {
            const int4 o = *reinterpret_cast<const int4*>(off_t + k);
            kept_row<T, P>(win, base, o.x, vals_t + k * tile, acc);
            kept_row<T, P>(win, base, o.y, vals_t + (k + 1) * tile, acc);
            kept_row<T, P>(win, base, o.z, vals_t + (k + 2) * tile, acc);
            kept_row<T, P>(win, base, o.w, vals_t + (k + 3) * tile, acc);
          }
        }
        for (; k < k_kept; ++k) kept_row<T, P>(win, base, off_t[k], vals_t + k * tile, acc);
        const bool bad = s_bad[t] != 0;
#pragma unroll
        for (int q = 0; q < P; ++q) {
          if (!store[q]) continue;
          const long long col = static_cast<long long>(p_band) + j0 + q * 32;
#pragma unroll
          for (int f = 0; f < kGroupRows; ++f) {
            // past-the-end positions of the ragged last strip hold 0
            const float y = !live[q] ? 0.f : (bad || outside[q]) ? repro::quiet_nan() : acc[q][f];
            out[static_cast<long long>(t * tile + f0 + f) * out_ld + col] = repro::from_f32<T>(y);
          }
        }
      }
    }
    __syncthreads();  // the window is refilled next
    if (band + gridDim.x < tg.n_bands) issue(band + gridDim.x);
  }
}

template <typename T, int P>
int launch(const void* x, const void* values, const int* idx, void* out,
           const repro::ConvGeom& g, const TiledGeom& tg, int n_tiles, int k_kept, int tile,
           int group, size_t smem, cudaStream_t st) {
  auto kernel = banded_tiled_kernel<T, P>;
  // every band its own block where the card holds them all at once; else
  // each block walks its share of the bands.  The cap (SM count x blocks an
  // SM holds at this shared memory) is queried once an instance, device and
  // size, not on every launch of a host-bound forward.
  static int cap_dev = -1, cap = 0;
  static size_t cap_smem = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev != cap_dev || smem != cap_smem) {
    int sms = 0, per_sm = 0;
    err = repro::allow_smem(kernel, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTiledThreads, smem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    cap = std::max(1, per_sm) * sms;
    cap_dev = dev;
    cap_smem = smem;
  }
  const int grid = std::min(tg.n_bands, cap);
  kernel<<<grid, kTiledThreads, smem, st>>>(static_cast<const T*>(x), static_cast<const T*>(values), idx,
                                 static_cast<T*>(out), g, tg, n_tiles, k_kept, tile, group);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_positions(int positions, const void* x, const void* values, const int* idx, void* out,
                     const repro::ConvGeom& g, const TiledGeom& tg, int n_tiles, int k_kept,
                     int tile, int group, size_t smem, cudaStream_t st) {
  if (positions == 2) {
    return launch<T, 2>(x, values, idx, out, g, tg, n_tiles, k_kept, tile, group, smem, st);
  }
  if (positions == 4) {
    return launch<T, 4>(x, values, idx, out, g, tg, n_tiles, k_kept, tile, group, smem, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: [c, b, h, w], 16-byte aligned with w * elem a multiple of 16; values:
// [n_tiles, k_kept, tile] with tile a multiple of 8; idx: [n_tiles, k_kept]
// int32 (rows of the (kh, kw, c)-flattened reduction dim); out:
// [n_tiles*tile, n_strips*v].  hb, n_bands, band_rows, lead, pitch and plane
// come from plan.py::tiled_band_plan; positions (2 or 4 a thread) and group
// (tiles staged at once, 1 .. n_tiles) from kernel.py; smem_bytes must equal
// this kernel's layout.
extern "C" int repro_conv2d_fused_banded_tiled(
    const void* x, const void* values, const void* idx, void* out, int dtype, int c, int b,
    int h, int w, int kh, int kw, int stride, int pad, int ho, int wo, int v, int n_strips,
    int n_tiles, int k_kept, int tile, int hb, int n_bands, int band_rows, int lead, int pitch,
    int plane, int positions, int group, long long smem_bytes, void* stream) {
  const int elem = dtype == repro::kDtypeF32 ? 4 : dtype == repro::kDtypeBF16 ? 2 : 0;
  const int vec = elem ? 16 / elem : 1;
  if (elem == 0 || c <= 0 || b <= 0 || h <= 0 || w <= 0 || kh <= 0 || kw <= 0 || stride <= 0 ||
      pad < 0 || ho <= 0 || wo <= 0 || v <= 0 || n_strips <= 0 || n_tiles <= 0 ||
      k_kept <= 0 || tile <= 0 || tile % kGroupRows != 0 || hb <= 0 ||
      n_bands != (n_strips + hb - 1) / hb ||
      static_cast<long long>(n_strips - 1) * v >= static_cast<long long>(b) * ho * wo ||
      band_rows < kh || w % vec != 0 || lead % vec != 0 || lead < pad ||
      pitch % vec != 0 || pitch - w < vec || pitch - w < pad ||
      plane != lead + band_rows * pitch || group <= 0 || group > n_tiles ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = tiled_smem(c, plane, n_tiles, k_kept, tile, elem, group);
  if (static_cast<long long>(smem) != smem_bytes) return static_cast<int>(cudaErrorInvalidValue);
  const repro::ConvGeom g{c, b, h, w, kh, kw, stride, pad, ho, wo, v, n_strips};
  const TiledGeom tg{h + 2 * pad, band_rows, lead, pitch, plane, hb * v, n_bands, b * ho * wo,
                     n_strips * v};
  auto st = static_cast<cudaStream_t>(stream);
  const int* ids = static_cast<const int*>(idx);
  if (dtype == repro::kDtypeF32) {
    return launch_positions<float>(positions, x, values, ids, out, g, tg, n_tiles, k_kept,
                                   tile, group, smem, st);
  }
  return launch_positions<__nv_bfloat16>(positions, x, values, ids, out, g, tg, n_tiles,
                                         k_kept, tile, group, smem, st);
}
