// Flash attention (forward) for Hopper, register-tiled and cp.async
// double-buffered, bit-identical to flash_attention.cu.
//
// Replaces: src/repro/kernels/flash_attn/kernel.py::flash_attention_pallas
// (_kernel), the TPU kernel whose grid (BH, Sq/bq, Sk/bk) walks the K/V
// blocks as its sequential axis with m, l and acc in VMEM scratch.  Serves
// every head with D % 4 == 0 (f32) or D % 8 == 0 (bf16), D <= 128, and
// 16-byte aligned operands (repro_torch/kernels/flash_attn/kernel.py::
// flash_tiled_takes); flash_attention.cu keeps the others.
//
// Computes what flash_attention.cu computes (its header states the function:
// the GQA map (h * KV) / H, the top-left causal mask, f32 scores, m, l and
// acc, probabilities rounded through V's dtype, acc / max(l, 1e-30)).
//
// Bound: at smollm-360m's scoring shape (B 4, S 2048, H 15, KV 5, D 64,
// causal) 32.2 GFLOP of f32 FMAs on 84 MB: operations bound, 0.481 ms at
// 67 TFLOP/s (f32 outside the tensor cores).  flash_attention.cu reached 22%
// of that peak: its QK and PV loops feed the FMAs from scalar shared loads
// (2.7 FMAs a load) and the block waits at every K/V tile's staging.
//
// Design: one block of (BQ / RPT) * 8 threads per (BQ-row query tile, head,
// batch); BQ is 64 or 128 rows, RPT 4 or 8 rows a thread (template
// parameters; the wrapper picks them per D, flash_tiled_config).  Q, K and V
// are staged in their own dtype, row-major with rows padded by 16 bytes
// (ld = D + 4 in f32), so the 16-byte (bf16: 8-byte) reads of 8 consecutive
// key rows by a quarter-warp fall in distinct banks.  K and V move by 16-byte
// cp.async into a two-stage ring: tile kt + 1 is in flight while tile kt is
// computed, with one __syncthreads a tile.  Keys past Sk and query rows past
// Sq land as zeros (cp.async with a source size of 0), never stale data: a
// masked p = 0 times a NaN would not stay 0.  In QK a thread reads float4s
// of its RPT query rows (a broadcast within its 8 lanes) and of its 8 keys:
// 16 FMAs a load at RPT 4, 21 at RPT 8.  The probabilities go to shared
// memory key-major, [64][BQ + 4], one float4 store per key and 4 rows; a
// row's probabilities are written and read by the 8 lanes of one warp, so a
// __syncwarp orders them.  In PV a thread owns the columns 32g + 4tx ..
// 32g + 4tx + 3 (g < ceil(D / 32)), read as float4s of V beside a float4 of
// its rows' probabilities.  The grid is (head, batch, query tile), the
// query tile slowest, so the blocks start in order of their query tile: in
// causal mode every head's heaviest tiles first, and the short ones fill the
// tail (with the query tile fastest, as in flash_attention.cu, the first
// wave mixes heavy and light blocks; this order alone took 11% off the
// scoring shape's time on the H100).
//
// Bit identity with flash_attention.cu, which this kernel keeps:
// - 64-key tiles in ascending order; a thread (lane tx of its row's 8)
//   holds keys tx + 8j of a tile;
// - each score is one fmaf chain over c = 0 .. D-1 ascending from 0.f, then
//   times scale, masked to kNeg;
// - the row max and sum run over j ascending, then xor-shuffles 1, 2, 4;
// - p = expf(s - m_new) rounded through T for PV, the sum of the unrounded p;
//   alpha = expf(m - m_new), l = alpha * l + sum, acc *= alpha;
// - each output is one fmaf chain over the tile's keys ascending, divided by
//   fmaxf(l, 1e-30f) once.
// The expressions are written as in flash_attention.cu and built with the
// same flags (no fast math).  A row of a 128-row block that meets a tile
// wholly above its diagonal (which a 64-row block would have skipped) adds
// expf(kNeg - m) = 0 to l, multiplies by alpha = expf(0) = 1 and adds 0 * v
// to acc: exact, since m is finite after the row's first tile (it holds key
// 0).  The causal skip of tiles above the whole block's diagonal stays.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kBk = 64;         // keys of a staged tile (flash_attention.cu kBk)
constexpr int kColLanes = 8;    // tx: the lanes that share a query row
constexpr int kKeysPerThread = kBk / kColLanes;  // 8
constexpr int kStages = 2;      // the K/V ring
constexpr int kMaxD = 128;
constexpr float kNeg = -1e30f;

// Shared-memory bytes, also computed by
// repro_torch/kernels/flash_attn/kernel.py::flash_tiled_smem_bytes: the Q
// tile [BQ][ld] and two stages of the K and V tiles [64][ld] in the
// operands' dtype, ld = D + 16 / itemsize, and the probabilities [64][BQ + 4]
// in f32.
size_t tiled_smem_bytes(int d, int itemsize, int bq) {
  const size_t ld = static_cast<size_t>(d) + 16 / itemsize;
  return (static_cast<size_t>(bq) + 2 * kStages * kBk) * ld * itemsize +
         static_cast<size_t>(kBk) * (bq + 4) * sizeof(float);
}

struct TiledArgs {
  int b, sq, sk, h, kv, d, causal;
  float scale;
};

// DG: groups of 32 output columns, ceil(D / 32); columns past D are never
// read or written.
template <typename T, int BQ, int RPT, int DG>
__global__ void __launch_bounds__((BQ / RPT) * kColLanes)
flash_tiled_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   T* __restrict__ out, TiledArgs a) {
  constexpr int kThreads = (BQ / RPT) * kColLanes;
  constexpr int kVec = 16 / sizeof(T);  // elements of one 16-byte copy, and of a row's pad
  constexpr int kLdp = BQ + 4;          // row stride of the key-major probabilities
  static_assert(RPT % 4 == 0, "a thread's rows move as float4s");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = a.d;
  const int ld = d + kVec;
  T* s_q = reinterpret_cast<T*>(smem_raw);                               // [BQ][ld]
  T* s_kv = s_q + BQ * ld;                                               // [stage][K, V][64][ld]
  float* s_p = reinterpret_cast<float*>(s_kv + 2 * kStages * kBk * ld);  // [64][kLdp]

  const int n_qt = (a.sq + BQ - 1) / BQ;
  const int bx = static_cast<int>(blockIdx.z);
  const int q0 = (a.causal ? n_qt - 1 - bx : bx) * BQ;
  const int hh = blockIdx.x;
  const int bb = blockIdx.y;
  const int kvh = static_cast<int>((static_cast<long long>(hh) * a.kv) / a.h);  // ops.py's map
  const int tid = threadIdx.x;
  const int tx = tid % kColLanes;
  const int ty = tid / kColLanes;

  const long long q_row = static_cast<long long>(a.h) * d;    // stride of a q/out row
  const long long kv_row = static_cast<long long>(a.kv) * d;  // stride of a k/v row
  const T* qb = q + static_cast<long long>(bb) * a.sq * q_row + static_cast<long long>(hh) * d;
  const T* kb = k + static_cast<long long>(bb) * a.sk * kv_row + static_cast<long long>(kvh) * d;
  const T* vb = v + static_cast<long long>(bb) * a.sk * kv_row + static_cast<long long>(kvh) * d;
  const int chunks = d / kVec;  // 16-byte copies per row

  // Query rows past Sq land as zero; their outputs are not written.
  for (int e = tid; e < BQ * chunks; e += kThreads) {
    const int r = e / chunks;
    const int c = (e - r * chunks) * kVec;
    const int i = q0 + r;
    const bool ok = i < a.sq;
    repro::cp_async16_zfill(s_q + r * ld + c, ok ? qb + i * q_row + c : qb, ok);
  }
  // Keys past Sk land as zero (never stale: p * v must stay 0).
  auto stage_tile = [&](int kt) {
    T* s_k = s_kv + (kt & 1) * 2 * kBk * ld;
    T* s_v = s_k + kBk * ld;
    const int k0 = kt * kBk;
    for (int e = tid; e < kBk * chunks; e += kThreads) {
      const int j = e / chunks;
      const int c = (e - j * chunks) * kVec;
      const int kp = k0 + j;
      const bool ok = kp < a.sk;
      const long long off = ok ? kp * kv_row + c : 0;
      repro::cp_async16_zfill(s_k + j * ld + c, kb + off, ok);
      repro::cp_async16_zfill(s_v + j * ld + c, vb + off, ok);
    }
  };

  float m[RPT], l[RPT], acc[RPT][DG][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < DG; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;
    }
  }

  const int q_last = min(q0 + BQ, a.sq) - 1;
  int n_kt = (a.sk + kBk - 1) / kBk;
  if (a.causal) n_kt = min(n_kt, q_last / kBk + 1);  // exact: see flash_attention.cu

  stage_tile(0);
  repro::cp_async_commit();  // Q and tile 0
  for (int kt = 0; kt < n_kt; ++kt) {
    repro::cp_async_wait<0>();
    // Tile kt (and Q) landed for every thread, and every thread is done with
    // tile kt - 1, whose stage the next copy overwrites.
    __syncthreads();
    if (kt + 1 < n_kt) stage_tile(kt + 1);
    repro::cp_async_commit();
    const T* s_k = s_kv + (kt & 1) * 2 * kBk * ld;
    const T* s_v = s_k + kBk * ld;
    const int k0 = kt * kBk;

    float s[RPT][kKeysPerThread];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) s[i][j] = 0.f;
    }
#pragma unroll 2
    for (int c = 0; c < d; c += 4) {
      float qv[RPT][4], kx[kKeysPerThread][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i) repro::load4(s_q + (ty * RPT + i) * ld + c, qv[i]);
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j)
        repro::load4(s_k + (tx + kColLanes * j) * ld + c, kx[j]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
#pragma unroll
          for (int j = 0; j < kKeysPerThread; ++j) s[i][j] = fmaf(qv[i][e], kx[j][e], s[i][j]);
        }
      }
    }

    // Online softmax of the tile, as flash_attention.cu; s becomes the
    // probabilities rounded through T.
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qi = q0 + ty * RPT + i;
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
        s[i][j] = repro::to_f32(repro::from_f32<T>(p));
      }
#pragma unroll
      for (int off = 1; off < kColLanes; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < DG; ++g) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      float* dst = s_p + (tx + kColLanes * j) * kLdp + ty * RPT;
#pragma unroll
      for (int i4 = 0; i4 < RPT; i4 += 4) {
        const float p4[4] = {s[i4][j], s[i4 + 1][j], s[i4 + 2][j], s[i4 + 3][j]};
        repro::store4(dst + i4, p4);
      }
    }
    __syncwarp();  // a row's probabilities come from the 8 lanes of this warp

#pragma unroll 4
    for (int j = 0; j < kBk; ++j) {
      float pj[RPT];
#pragma unroll
      for (int i4 = 0; i4 < RPT; i4 += 4) {
        float p4[4];
        repro::load4(s_p + j * kLdp + ty * RPT + i4, p4);
#pragma unroll
        for (int e = 0; e < 4; ++e) pj[i4 + e] = p4[e];
      }
#pragma unroll
      for (int g = 0; g < DG; ++g) {
        const int c = 32 * g + 4 * tx;
        float vx[4] = {0.f, 0.f, 0.f, 0.f};
        if (c < d) repro::load4(s_v + j * ld + c, vx);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][g][e] = fmaf(pj[i], vx[e], acc[i][g][e]);
        }
      }
    }
  }

  T* ob = out + static_cast<long long>(bb) * a.sq * q_row + static_cast<long long>(hh) * d;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + ty * RPT + i;
    if (qi >= a.sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < DG; ++g) {
      const int c = 32 * g + 4 * tx;
      if (c >= d) continue;
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = acc[i][g][e] / denom;
      repro::store4(ob + qi * q_row + c, o);
    }
  }
}

template <typename T, int BQ, int RPT, int DG>
int launch(const void* q, const void* k, const void* v, void* out, const TiledArgs& a,
           size_t bytes, cudaStream_t st) {
  auto kernel = flash_tiled_kernel<T, BQ, RPT, DG>;
  cudaError_t err = repro::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.h, a.b, (a.sq + BQ - 1) / BQ);
  kernel<<<grid, (BQ / RPT) * kColLanes, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), a);
  return static_cast<int>(cudaGetLastError());
}

// RPT 8 takes D <= 64: at 8 rows a thread, wider heads' accumulators would
// spill (kernel.py's FLASH_TILED_SHAPES holds the same rule).
template <typename T, int BQ, int RPT>
int launch_d(const void* q, const void* k, const void* v, void* out, const TiledArgs& a,
             size_t bytes, cudaStream_t st) {
  if (a.d <= 32) return launch<T, BQ, RPT, 1>(q, k, v, out, a, bytes, st);
  if (a.d <= 64) return launch<T, BQ, RPT, 2>(q, k, v, out, a, bytes, st);
  if constexpr (RPT == 4) {
    if (a.d <= 96) return launch<T, BQ, RPT, 3>(q, k, v, out, a, bytes, st);
    return launch<T, BQ, RPT, 4>(q, k, v, out, a, bytes, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_shape(const void* q, const void* k, const void* v, void* out, const TiledArgs& a,
                 int bq, int rpt, size_t bytes, cudaStream_t st) {
  if (bq == 64 && rpt == 4) return launch_d<T, 64, 4>(q, k, v, out, a, bytes, st);
  if (bq == 64 && rpt == 8) return launch_d<T, 64, 8>(q, k, v, out, a, bytes, st);
  if (bq == 128 && rpt == 4) return launch_d<T, 128, 4>(q, k, v, out, a, bytes, st);
  if (bq == 128 && rpt == 8) return launch_d<T, 128, 8>(q, k, v, out, a, bytes, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// q/out: [b, sq, h, d]; k/v: [b, sk, kv, d]; all contiguous, one dtype, 16-byte
// aligned, d a multiple of 16 bytes.  causal: 0 or 1.  block_rows (64 or 128)
// and rows_per_thread (4 or 8; 8 only for d <= 64) pick the instance.
// smem_bytes is the caller's size of the launch's shared memory: it must
// equal this kernel's layout.
extern "C" int repro_flash_attention_tiled(const void* q, const void* k, const void* v, void* out,
                                           int dtype, int b, int sq, int sk, int h, int kv,
                                           int d, int causal, int block_rows,
                                           int rows_per_thread, long long smem_bytes,
                                           void* stream) {
  const int itemsize = dtype == repro::kDtypeF32 ? 4 : dtype == repro::kDtypeBF16 ? 2 : 0;
  if (itemsize == 0 || b <= 0 || b > 65535 || sq <= 0 || sk <= 0 || h <= 0 || h > 65535 ||
      kv <= 0 || d <= 0 || d > kMaxD || (d * itemsize) % 16 != 0 ||
      (causal != 0 && causal != 1) || (rows_per_thread == 8 && d > 64) ||
      (block_rows != 64 && block_rows != 128) || (sq + block_rows - 1) / block_rows > 65535 ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = tiled_smem_bytes(d, itemsize, block_rows);
  if (static_cast<long long>(bytes) != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the scale as flash_attention.cu forms it
  const TiledArgs a{b, sq, sk, h, kv, d, causal,
                    static_cast<float>(1.0 / sqrt(static_cast<double>(d)))};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kDtypeF32) {
    return launch_shape<float>(q, k, v, out, a, block_rows, rows_per_thread, bytes, st);
  }
  return launch_shape<__nv_bfloat16>(q, k, v, out, a, block_rows, rows_per_thread, bytes, st);
}
