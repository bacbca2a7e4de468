// Fused im2col + pack (paper Algorithm 2) for Hopper, tiled: a block copies
// a group of taps of a block of channels for one strip, in 16-byte rows.
//
// Replaces: src/repro/kernels/im2col_pack/kernel.py::im2col_pack_pallas
// (_kernel), the TPU kernel whose grid step (strip, tap, channel block)
// gathers a [c_block, V] strip tile with one set of indices for the whole
// channel block.  csrc/im2col_pack.cu keeps the strip widths the shape rule
// (kernel.py::im2col_tiled_takes) refuses and is this kernel's bitwise
// yardstick.
//
// Computes strips[s, r, j] = x[c, bb, ih, iw] for r = (ikh*kw + ikw)*C + c and
// output position p = s*V + j, or 0 where the tap is off the map or p is past
// the last position (the ragged last strip).  An exact copy: the element bits
// are moved as uint32_t (f32) or uint16_t (bf16), never converted, so the
// result is bit-identical to im2col_pack.cu and to the plain version, NaN
// payloads and -0.0 included.
//
// Bound: bytes.  It does no arithmetic beyond index math; it reads each map
// element once per tap that touches it (from L2 after the first tap) and
// writes every strip element once.  What held im2col_pack.cu back: one
// 128-thread block per strip row (512 bytes in f32, 256 in bf16), so block
// scheduling set the pace; two to four integer divisions per element to find
// its tap, channel and position, though a position's decode is the same for
// all K rows of its strip and its source offset the same for all channels of
// a tap; one 4- or 2-byte store per thread; one load in flight per thread.
//
// Design: a block is (strip s, tg taps from tap t0, channels [c0, c0 + cb)).
// Each thread owns EPT = 16 / sizeof(element) consecutive positions of the
// strip (4 in f32, 8 in bf16), so its row segment is one 16-byte store; V /
// EPT threads cover a strip row and the block's threads take rp rows at once
// (rp * V / EPT threads, at most 256).  A thread decodes its first position
// once (repro::decode_position, the kernel's only divisions) and steps to
// the others (repro::next_position), for all the block's taps.  At each tap
// it shifts them (repro::tap_shift) into EPT plane offsets held in
// registers, -1 for an off-map or past-the-end lane; the channel loop is
// then one plane add per channel: EPT read-only loads (an invalid lane loads
// nothing and writes zero bits) and one 16-byte store, U channels at a time
// so that U * EPT loads are in flight before the first store.  A warp writes
// whole 128-byte lines from registers, so no shared memory is used; the
// map's rows (W innermost, CNHW) rule out TMA's im2col mode, which wants
// channels innermost.  Stride 2 reads every other element of a map row, by
// the same scalar loads.
// What the sweep (kernels/im2col_pack/tune.py) showed: with one tap a block
// a thread of a C 8 or 16 conv wrote one or two rows and the block's start
// and its load round trip set its time (16.4 us for resnet-tiny's first
// conv, 2.6x its bound); a group of taps a block gives a thread 3 to 9 rows
// (9.4 us).  Unrolling over (channel, tap) rows, so that several taps'
// loads are in flight, was slower everywhere (recomputing each position's
// shift and address every row costs more than the round trips it overlaps).
// With L2 flushed before each call the times hardly move: the kernel is not
// yet bound by device memory.  The instance (cb, tg, U) is a rule of the
// shape (kernel.py::im2col_tiled_config) fitted to that sweep.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ uint4 pack16(const uint32_t (&e)[4]) {
  return make_uint4(e[0], e[1], e[2], e[3]);
}
__device__ __forceinline__ uint4 pack16(const uint16_t (&e)[8]) {
  // little-endian: the lower position's bits in the low half of a word
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = static_cast<uint32_t>(e[2 * i]) | (static_cast<uint32_t>(e[2 * i + 1]) << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename E, int U>  // E holds the element's bits; U channels a step
__global__ void __launch_bounds__(kMaxThreads)
im2col_pack_tiled_kernel(const E* __restrict__ x, E* __restrict__ out, repro::ConvGeom g, int cb,
                         int rp, int tg) {
  constexpr int kEpt = 16 / sizeof(E);
  const int nl = g.v / kEpt;  // threads along a strip row
  const int lane = threadIdx.x % nl;
  const int rg = threadIdx.x / nl;  // the row of a pass this thread takes
  const int s = blockIdx.x;
  const int taps = g.kh * g.kw;
  const int t0 = blockIdx.y * tg;
  const int t_end = min(t0 + tg, taps);
  const int c0 = blockIdx.z * cb;
  const int c_end = min(c0 + cb, g.c);
  const int j0 = lane * kEpt;

  // this thread's positions, decoded once for all the block's taps
  int bb[kEpt], ih0[kEpt], iw0[kEpt];
  repro::decode_position(s * g.v + j0, g, bb[0], ih0[0], iw0[0]);
#pragma unroll
  for (int i = 1; i < kEpt; ++i) {
    bb[i] = bb[i - 1];
    ih0[i] = ih0[i - 1];
    iw0[i] = iw0[i - 1];
    repro::next_position(g, bb[i], ih0[i], iw0[i]);
  }

  const long long plane = static_cast<long long>(g.b) * g.h * g.w;
  const long long k_rows = static_cast<long long>(taps) * g.c;
  int ikh = t0 / g.kw;
  int ikw = t0 - ikh * g.kw;
  for (int tap = t0; tap < t_end; ++tap) {
    // the plane offsets of the positions at this tap, -1 off the map or
    // past the last position
    long long off[kEpt];
#pragma unroll
    for (int i = 0; i < kEpt; ++i) {
      int ih, iw;
      const bool ok = repro::tap_shift(ih0[i], iw0[i], ikh, ikw, g, ih, iw) && bb[i] < g.b;
      off[i] = ok ? (static_cast<long long>(bb[i]) * g.h + ih) * g.w + iw : -1;
    }
    E* o = out + (s * k_rows + static_cast<long long>(tap) * g.c) * g.v + j0;
    for (int c = c0 + rg; c < c_end; c += U * rp) {
      uint4 q[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int cc = c + u * rp;
        E e[kEpt];
        const E* xc = x + cc * plane;
#pragma unroll
        for (int i = 0; i < kEpt; ++i) {
          e[i] = (cc < c_end && off[i] >= 0) ? __ldg(xc + off[i]) : E(0);
        }
        q[u] = pack16(e);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int cc = c + u * rp;
        if (cc < c_end) *reinterpret_cast<uint4*>(o + cc * static_cast<long long>(g.v)) = q[u];
      }
    }
    if (++ikw == g.kw) {
      ikw = 0;
      ++ikh;
    }
  }
}

template <typename E>
int launch_instance(int unroll, const void* x, void* out, const repro::ConvGeom& g, int cb,
                    int rp, int tg, dim3 grid, int threads, cudaStream_t st) {
  const E* xs = static_cast<const E*>(x);
  E* os = static_cast<E*>(out);
  switch (unroll) {
    case 1:
      im2col_pack_tiled_kernel<E, 1><<<grid, threads, 0, st>>>(xs, os, g, cb, rp, tg);
      break;
    case 2:
      im2col_pack_tiled_kernel<E, 2><<<grid, threads, 0, st>>>(xs, os, g, cb, rp, tg);
      break;
    case 4:
      im2col_pack_tiled_kernel<E, 4><<<grid, threads, 0, st>>>(xs, os, g, cb, rp, tg);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [c, b, h, w] contiguous; out: [n_strips, kh*kw*c, v] contiguous, 16-byte
// aligned.  cb: channels a block; tg: taps a block; rp: strip rows a block
// takes at once (rp * v / (16 / elem_bytes) threads); unroll: channels a
// thread loads before it stores.
extern "C" int repro_im2col_pack_tiled(const void* x, void* out, int elem_bytes, int c, int b,
                                       int h, int w, int kh, int kw, int stride, int pad, int ho,
                                       int wo, int v, int n_strips, int cb, int tg, int rp,
                                       int unroll, void* stream) {
  if (elem_bytes != 4 && elem_bytes != 2) return static_cast<int>(cudaErrorInvalidValue);
  const int ept = 16 / elem_bytes;
  const long long rows = static_cast<long long>(n_strips) * kh * kw * c;
  const long long threads = static_cast<long long>(rp) * (v / ept);
  const long long chunks = cb > 0 ? (c + static_cast<long long>(cb) - 1) / cb : 0;
  const long long tap_groups = tg > 0 ? (static_cast<long long>(kh) * kw + tg - 1) / tg : 0;
  if (rows <= 0 || rows > 0x7fffffffLL || v <= 0 || v % ept != 0 || rp <= 0 || rp > cb ||
      threads > kMaxThreads || chunks <= 0 || chunks > 65535 || tap_groups <= 0 ||
      tap_groups > 65535 || ho <= 0 || wo <= 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const repro::ConvGeom g{c, b, h, w, kh, kw, stride, pad, ho, wo, v, n_strips};
  const dim3 grid(static_cast<unsigned>(n_strips), static_cast<unsigned>(tap_groups),
                  static_cast<unsigned>(chunks));
  auto st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    return launch_instance<uint32_t>(unroll, x, out, g, cb, rp, tg, grid,
                                     static_cast<int>(threads), st);
  }
  return launch_instance<uint16_t>(unroll, x, out, g, cb, rp, tg, grid, static_cast<int>(threads),
                                   st);
}
