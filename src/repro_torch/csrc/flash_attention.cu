// Flash attention (forward) for Hopper.
//
// Replaces: src/repro/kernels/flash_attn/kernel.py::flash_attention_pallas
// (_kernel), the TPU kernel whose grid (BH, Sq/bq, Sk/bk) walks the K/V
// blocks as its sequential ("arbitrary") axis with m, l and acc in VMEM
// scratch, reached through flash_attn/ops.py::flash_attention after the GQA
// expansion and three transposes to [BH, S, D].
//
// Computes what flash_attn/ref.py::flash_attention_ref computes, with the
// GQA head map of ops.py: for batch b, query row i and head h, the softmax
// over keys j < Sk (and j <= i when causal: the top-left mask with no
// offset, also when Sq != Sk) of q.k / sqrt(D), times V, where q head h
// reads KV head (h * KV) / H (defined also for H % KV != 0, where h / g is
// not).  Scores, m, l and the accumulator are float32.  As in _kernel, the
// probabilities are cast to V's dtype before the PV product (a rounding in
// bf16, nothing in f32), and the output is acc / max(l, 1e-30) in q's dtype.
//
// Bound: at smollm-360m's scoring shape (B 4, S 2048, H 15, KV 5, D 64,
// causal) the work is 4 * B*H * D * S(S+1)/2 = 32 GFLOP on 84 MB (Q, K and
// V at KV heads, O, read or written once), ~380 FLOP per byte: operations
// bound (0.48 ms at 67 TFLOP/s, f32 outside the tensor cores).
//
// Design, simple first: one block of 128 threads per (64-row query tile,
// head, batch).  It reads q, k and v in their [B, S, heads, D] layout (no
// transposes, no expanded K/V) and loops over 64-key K/V tiles itself: that
// loop takes the place of the TPU's sequential grid axis, and m, l and acc
// stay in registers across it.  Q, K and V tiles are staged in shared
// memory as f32, the Q and K rows padded by one float and the probability
// rows by two against bank conflicts.  Thread (ty, tx) owns the query rows
// 4ty..4ty+3 of its tile: it scores them against keys tx, tx+8, ..., tx+56
// of the K tile, reduces each row's max and sum over the 8 threads of the
// row with warp shuffles, and keeps their accumulators for the output
// columns tx, tx+8, ...  The probabilities reach the PV product through
// shared memory.  In causal mode a block stops after the last K/V tile that
// holds a key <= its last query row.  The tiles it skips lie wholly above
// the diagonal, and skipping them is exact: every row's first tile holds key
// 0, so m is finite before any skipped tile could add exp(NEG - m) = 0 to l
// and to acc.  Causal blocks are launched heaviest first, so the short ones
// fill the tail.  Tensor cores (wgmma), TMA or cp.async pipelining and warp
// specialisation are later work.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kFlashThreads = 128;
constexpr int kBq = 64;                              // query rows of a block
constexpr int kBk = 64;                              // keys of a staged tile
constexpr int kColLanes = 8;                         // tx
constexpr int kRowLanes = kFlashThreads / kColLanes;  // ty, 16
constexpr int kRowsPerThread = kBq / kRowLanes;      // 4
constexpr int kKeysPerThread = kBk / kColLanes;      // 8
constexpr int kLdp = kBk + 2;                        // row stride of the probabilities
constexpr int kMaxD = 128;
constexpr float kNeg = -1e30f;

// Shared-memory layout, also computed by
// repro_torch/kernels/flash_attn/kernel.py::flash_smem_bytes.  With ld = D + 1
// (odd) the 4 query rows and the 8 key rows a warp reads at one d fall in
// different banks; with kLdp = 66 the probabilities a warp writes do too.
struct FlashLayout {
  int ld;  // row stride of the staged Q and K rows
  size_t bytes;
};

FlashLayout flash_layout(int d) {
  FlashLayout l;
  l.ld = d + 1;
  const size_t floats = static_cast<size_t>(kBq) * l.ld     // Q
                        + static_cast<size_t>(kBk) * l.ld   // K
                        + static_cast<size_t>(kBk) * d      // V
                        + static_cast<size_t>(kBq) * kLdp;  // probabilities
  l.bytes = floats * sizeof(float);
  return l;
}

struct FlashArgs {
  int b, sq, sk, h, kv, d, causal;
  float scale;
};

// DC: output columns a thread accumulates, ceil(D / 8) rounded up to the
// variant (2, 4, 8 or 16); columns past D are never read or written.
template <typename T, int DC>
__global__ void __launch_bounds__(kFlashThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, FlashArgs a, int ld) {
  extern __shared__ float smem[];
  const int d = a.d;
  float* s_q = smem;             // [kBq, ld]
  float* s_k = s_q + kBq * ld;   // [kBk, ld]
  float* s_v = s_k + kBk * ld;   // [kBk, d]
  float* s_p = s_v + kBk * d;    // [kBq, kLdp]

  const int n_qt = (a.sq + kBq - 1) / kBq;
  const int bx = static_cast<int>(blockIdx.x);
  const int q0 = (a.causal ? n_qt - 1 - bx : bx) * kBq;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int kvh = static_cast<int>((static_cast<long long>(hh) * a.kv) / a.h);  // ops.py's map
  const int tx = threadIdx.x % kColLanes;
  const int ty = threadIdx.x / kColLanes;

  const long long q_row = static_cast<long long>(a.h) * d;    // stride of a q/out row
  const long long kv_row = static_cast<long long>(a.kv) * d;  // stride of a k/v row
  const T* qb = q + static_cast<long long>(bb) * a.sq * q_row + static_cast<long long>(hh) * d;
  const T* kb = k + static_cast<long long>(bb) * a.sk * kv_row + static_cast<long long>(kvh) * d;
  const T* vb = v + static_cast<long long>(bb) * a.sk * kv_row + static_cast<long long>(kvh) * d;

  // Query rows past Sq are staged as zero; their outputs are not written.
  for (int e = threadIdx.x; e < kBq * d; e += kFlashThreads) {
    const int r = e / d, c = e - r * d;
    const int i = q0 + r;
    s_q[r * ld + c] = i < a.sq ? repro::to_f32(qb[i * q_row + c]) : 0.f;
  }

  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][DC];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) acc[i][cc] = 0.f;
  }

  const int q_last = min(q0 + kBq, a.sq) - 1;
  int n_kt = (a.sk + kBk - 1) / kBk;
  if (a.causal) n_kt = min(n_kt, q_last / kBk + 1);  // exact: see the header

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBk;
    __syncthreads();  // Q is staged; the last tile's K, V and P are read
    // Keys past Sk are staged as zero (never NaN: p * v must stay 0).
    for (int e = threadIdx.x; e < kBk * d; e += kFlashThreads) {
      const int j = e / d, c = e - j * d;
      const int kp = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kp < a.sk) {
        kx = repro::to_f32(kb[kp * kv_row + c]);
        vx = repro::to_f32(vb[kp * kv_row + c]);
      }
      s_k[j * ld + c] = kx;
      s_v[j * d + c] = vx;
    }
    __syncthreads();

    float s[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) s[i][j] = 0.f;
    }
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float qv[kRowsPerThread], kx[kKeysPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) qv[i] = s_q[(ty * kRowsPerThread + i) * ld + c];
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) kx[j] = s_k[(tx + kColLanes * j) * ld + c];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
        for (int j = 0; j < kKeysPerThread; ++j) s[i][j] = fmaf(qv[i], kx[j], s[i][j]);
      }
    }

    // Online softmax of the tile.  A row's 8 threads are lanes 8t..8t+7 of
    // one warp, so xor-shuffles over 1, 2, 4 reduce it.
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = ty * kRowsPerThread + i;
      const int qi = q0 + r;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const int kp = k0 + tx + kColLanes * j;
        const bool ok = kp < a.sk && (!a.causal || kp <= qi);
        s[i][j] = ok ? s[i][j] * a.scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < kColLanes; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        // p in V's dtype for the PV product, as _kernel's p.astype(v.dtype)
        s_p[r * kLdp + tx + kColLanes * j] = repro::to_f32(repro::from_f32<T>(p));
      }
#pragma unroll
      for (int off = 1; off < kColLanes; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) acc[i][cc] *= alpha;
    }
    __syncthreads();  // the tile's probabilities are in shared memory

#pragma unroll 4
    for (int j = 0; j < kBk; ++j) {
      float pj[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) pj[i] = s_p[(ty * kRowsPerThread + i) * kLdp + j];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const int c = tx + kColLanes * cc;
        const float vx = c < d ? s_v[j * d + c] : 0.f;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) acc[i][cc] = fmaf(pj[i], vx, acc[i][cc]);
      }
    }
  }

  T* ob = out + static_cast<long long>(bb) * a.sq * q_row + static_cast<long long>(hh) * d;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int qi = q0 + ty * kRowsPerThread + i;
    if (qi >= a.sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) {
      const int c = tx + kColLanes * cc;
      if (c < d) ob[qi * q_row + c] = repro::from_f32<T>(acc[i][cc] / denom);
    }
  }
}

template <typename T, int DC>
int launch(const void* q, const void* k, const void* v, void* out, const FlashArgs& a,
           const FlashLayout& l, cudaStream_t st) {
  cudaError_t err = repro::allow_smem(flash_kernel<T, DC>, l.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.sq + kBq - 1) / kBq, a.h, a.b);
  flash_kernel<T, DC><<<grid, kFlashThreads, l.bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), a, l.ld);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, const FlashArgs& a,
             const FlashLayout& l, cudaStream_t st) {
  if (a.d <= 16) return launch<T, 2>(q, k, v, out, a, l, st);
  if (a.d <= 32) return launch<T, 4>(q, k, v, out, a, l, st);
  if (a.d <= 64) return launch<T, 8>(q, k, v, out, a, l, st);
  return launch<T, 16>(q, k, v, out, a, l, st);
}

}  // namespace

// q/out: [b, sq, h, d]; k/v: [b, sk, kv, d]; all contiguous, one dtype.
// causal: 0 or 1.  smem_bytes is the caller's size of the launch's shared
// memory: it must equal this kernel's layout for d.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int dtype, int b, int sq, int sk, int h, int kv, int d,
                                     int causal, long long smem_bytes, void* stream) {
  if (b <= 0 || b > 65535 || sq <= 0 || sk <= 0 || h <= 0 || h > 65535 || kv <= 0 ||
      d <= 0 || d > kMaxD || (causal != 0 && causal != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FlashLayout l = flash_layout(d);
  if (static_cast<long long>(l.bytes) != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the scale as the Pallas kernel forms it: 1 / math.sqrt(d) in double,
  // rounded to f32 where it multiplies the f32 scores
  const FlashArgs a{b, sq, sk, h, kv, d, causal,
                    static_cast<float>(1.0 / sqrt(static_cast<double>(d)))};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kDtypeF32) return launch_d<float>(q, k, v, out, a, l, st);
  if (dtype == repro::kDtypeBF16) return launch_d<__nv_bfloat16>(q, k, v, out, a, l, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
