// Ragged paged decode attention for Hopper, the pages split over warps.
//
// Replaces: src/repro/kernels/flash_attn/paged.py::paged_attention_pallas
// (_kernel), the TPU kernel whose grid walks a sequence's pages as its
// sequential axis.  csrc/paged_attention.cu carries that walk over: one
// block per (KV head, query block, sequence) visits the pages one after
// another, so at the decode shape 20 blocks on 132 SMs pay one global round
// trip and four barriers per page, with most threads idle.  This kernel
// takes the shapes paged.py::paged_split_takes accepts; the other kernel
// stays for the rest and as the yardstick.
//
// Computes what paged.py::paged_attention_ref computes: for every sequence
// b, query row i and head h, softmax over (cache rows < lengths[b], read
// through tables[b]) ++ (this step's new keys t with t <= i), times the
// matching V rows, with scale 1/sqrt(D), float32 scores, softmax and
// accumulation, and the output in q's dtype.  GQA: q head h reads KV head
// h / (H / KV).  Its plain version is flash_attn/ref.py::
// paged_attention_split_ref: the same tiles, the same per-warp partials,
// the same combine.
//
// Bound: at serving shapes the work is ~4 FLOP per K/V element read, so it
// is bytes bound (the valid cache rows of K and V, read once), but at a few
// hundred rows those bytes take well under a microsecond: latency, one
// round trip and the launch set the time.  Design, simple first: one block
// of W warps per (KV head, sequence) holds all R = g * Sq query rows of the
// KV head's g heads (q staged once as f32 in shared memory).  A sequence's
// work is a list of tiles: its pages that hold valid rows, then its new
// keys in chunks of page_size rows; warp w takes tiles w, w + W, ..., its
// page ids read once, one a lane.  Each warp streams its tiles' K and V
// rows of its KV head into its own two shared slots as 16-byte cp.async
// copies (rows past the length are not read), the next tile in flight
// behind the current one, and keeps the running m, l and acc of its rows
// in registers: for the scores lane j takes key j of the tile (all D
// columns, q broadcast from shared memory), for the PV product a lane owns
// columns lane, lane + 32, ...; all RM rows of the instance run without a
// branch, so their shuffle chains overlap.  Each step
// multiplies the probabilities by the mask (cache row < length, new key t
// <= i), so a masked key adds exactly nothing.  At the end one combine in
// shared memory merges the W partials: m* = max m_w, l = sum e^(m_w - m*)
// l_w, acc the same way, a warp whose m is still -1e30 (it saw no valid
// key: its l and acc are 0) weighted 0, so exp(NEG - NEG) = 1 cannot let
// it in; out = acc / max(l, 1e-30).  A page id outside [0, n_phys) stages
// NaN rows, never an out-of-bounds read, so its sequence's output is NaN.
// The combine sums in another order than paged_attention.cu, so the two
// kernels agree to rounding, not bit for bit.
#include "common.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct SplitArgs {
  int b, sq, h, kv, d, n_phys, page_size, n_max, g, rows;
  float scale;
  int ldk;                 // row stride (elements) of a staged K row: D + 16 bytes
  long long slot_bytes;    // one slot: page_size K rows, then page_size V rows
  long long warp_bytes;    // a warp's slots, or its partial for the combine
  long long q_bytes;       // the f32 q rows of the block, RM of them
};

// Shared-memory layout, also computed by
// repro_torch/kernels/flash_attn/paged.py::paged_split_smem_bytes: the f32
// q rows [RM, D] (rows past R are zeros), then per warp the larger of its
// slots and its partial m[R], l[R], acc[R, D] in f32, each rounded up to 16
// bytes.  A warp has two slots, or one where no sequence can give it a
// second tile (W >= n_max + ceil(Sq / page_size)): its next tile is then
// always past the end and slot 1 is never written.  K rows are padded by
// 16 bytes so the score loop, whose lanes read one row each, spreads over
// the banks.
SplitArgs split_layout(int b, int sq, int h, int kv, int d, int n_phys, int page_size,
                       int n_max, int itemsize, int warps, int rm) {
  SplitArgs a;
  a.b = b;
  a.sq = sq;
  a.h = h;
  a.kv = kv;
  a.d = d;
  a.n_phys = n_phys;
  a.page_size = page_size;
  a.n_max = n_max;
  a.g = h / kv;
  a.rows = a.g * sq;
  a.scale = 1.0f / sqrtf(static_cast<float>(d));
  a.ldk = d + 16 / itemsize;
  auto up16 = [](long long x) { return (x + 15) / 16 * 16; };
  a.slot_bytes = static_cast<long long>(page_size) * (a.ldk + d) * itemsize;
  const int max_tiles = n_max + (sq + page_size - 1) / page_size;
  const long long slots = (warps >= max_tiles ? 1 : 2) * a.slot_bytes;
  const long long partial = 4LL * a.rows * (d + 2);
  a.warp_bytes = up16(slots > partial ? slots : partial);
  a.q_bytes = up16(4LL * rm * d);
  return a;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// A butterfly: every lane ends with the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// 16 bytes of quiet NaNs in T.
template <typename T> __device__ __forceinline__ uint4 nan16();
template <> __device__ __forceinline__ uint4 nan16<float>() {
  return make_uint4(0x7fc00000u, 0x7fc00000u, 0x7fc00000u, 0x7fc00000u);
}
template <> __device__ __forceinline__ uint4 nan16<__nv_bfloat16>() {
  return make_uint4(0x7fc07fc0u, 0x7fc07fc0u, 0x7fc07fc0u, 0x7fc07fc0u);
}

// W warps; RM query rows a lane holds (R <= RM); NC columns a lane owns in
// the PV product (D <= 32 * NC).
template <typename T, int W, int RM, int NC>
__global__ void __launch_bounds__(W * 32)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                   const T* __restrict__ v_new, const T* __restrict__ k_pages,
                   const T* __restrict__ v_pages, const int* __restrict__ tables,
                   const int* __restrict__ lengths, T* __restrict__ out, SplitArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kVec = 16 / sizeof(T);  // elements of one 16-byte copy
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = a.g, d = a.d, ps = a.page_size, R = a.rows, ldk = a.ldk;
  const long long kv_row = static_cast<long long>(a.kv) * d;  // stride of a K/V row
  float* s_q = reinterpret_cast<float*>(smem);                // [RM, d]
  unsigned char* wbase = smem + a.q_bytes + warp * a.warp_bytes;
  auto slot_k = [&](int s) { return reinterpret_cast<T*>(wbase + s * a.slot_bytes); };
  auto slot_v = [&](int s) { return slot_k(s) + ps * ldk; };

  const int len = max(lengths[b], 0);
  const int n_used = min((len + ps - 1) / ps, a.n_max);  // pages with valid rows
  const int n_tiles = n_used + (a.sq + ps - 1) / ps;     // then the new keys

  // Rows of tile u that hold keys.
  auto tile_rows = [&](int u) {
    return u < n_used ? min(ps, len - u * ps) : min(ps, a.sq - (u - n_used) * ps);
  };

  // Lane i holds the page id of the warp's i-th tile, read with the length
  // rather than after it; a warp's tiles past 32 read theirs when staged.
  const int* row = tables + static_cast<long long>(b) * a.n_max;
  const int col = warp + lane * W;
  const int my_page = col < a.n_max ? row[col] : 0;

  // Stage the warp's k-th tile u = warp + k * W (its K and V rows of this KV
  // head) into slot s: one commit group per call, empty past the last tile.
  auto issue = [&](int k, int s) {
    const int u = warp + k * W;
    if (u < n_tiles) {
      const int nrows = tile_rows(u);
      const T* kb;
      const T* vb;
      bool ok = true;
      if (u < n_used) {
        const int page = k < 32 ? __shfl_sync(kFull, my_page, k) : row[u];
        ok = page >= 0 && page < a.n_phys;
        const long long base = static_cast<long long>(ok ? page : 0) * ps * kv_row + kvh * d;
        kb = k_pages + base;
        vb = v_pages + base;
      } else {
        const long long base =
            (static_cast<long long>(b) * a.sq + (u - n_used) * ps) * kv_row + kvh * d;
        kb = k_new + base;
        vb = v_new + base;
      }
      T* sk = slot_k(s);
      T* sv = slot_v(s);
      const int vpr = d / kVec;  // 16-byte copies of a row
      for (int e = lane; e < nrows * vpr; e += 32) {
        const int j = e / vpr, c = (e - j * vpr) * kVec;
        if (ok) {
          repro::cp_async16(sk + j * ldk + c, kb + j * kv_row + c);
          repro::cp_async16(sv + j * d + c, vb + j * kv_row + c);
        } else {
          *reinterpret_cast<uint4*>(sk + j * ldk + c) = nan16<T>();
          *reinterpret_cast<uint4*>(sv + j * d + c) = nan16<T>();
        }
      }
    }
    repro::cp_async_commit();
  };

  issue(0, 0);  // in flight while the block stages q

  // q rows of this KV head as f32: row r = i * g + hh is query i, head
  // kvh * g + hh; the g heads of one query are contiguous.  Rows R..RM-1
  // are zeros: every lane computes all RM rows without a branch, and only
  // the first R reach the output.
  const int gd = g * d;
  for (int e = threadIdx.x * 4; e < RM * d; e += W * 32 * 4) {
    const int i = e / gd;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (e < R * d) {
      repro::load4(q + (static_cast<long long>(b) * a.sq + i) * a.h * d +
                       static_cast<long long>(kvh) * gd + (e - i * gd),
                   v);
    }
    repro::store4(s_q + e, v);
  }

  float m[RM], l[RM], acc[RM][NC];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < NC; ++t) acc[r][t] = 0.f;
  }
  __syncthreads();  // q staged

  for (int k = 0, u = warp; u < n_tiles; ++k, u += W) {
    issue(k + 1, (k + 1) & 1);
    repro::cp_async_wait<1>();
    __syncwarp();  // every lane's copies of tile u have landed
    const T* sk = slot_k(k & 1);
    const T* sv = slot_v(k & 1);
    const bool cache = u < n_used;
    const int nrows = tile_rows(u);
    const int t0 = cache ? 0 : (u - n_used) * ps;  // new key of row 0

    // Scores: lane j takes key j of the tile.
    float s[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) s[r] = 0.f;
    if (lane < nrows) {
      const T* kr = sk + lane * ldk;
      for (int c = 0; c < d; c += 4) {
        float kx[4];
        repro::load4(kr + c, kx);
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          float qx[4];
          repro::load4(s_q + r * d + c, qx);
          s[r] = fmaf(qx[0], kx[0], s[r]);
          s[r] = fmaf(qx[1], kx[1], s[r]);
          s[r] = fmaf(qx[2], kx[2], s[r]);
          s[r] = fmaf(qx[3], kx[3], s[r]);
        }
      }
    }

    // The online-softmax step, the probabilities multiplied by the mask.
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const bool valid = lane < nrows && (cache || t0 + lane <= r / g);
      const float sc = valid ? s[r] * a.scale : kNeg;
      const float m_new = fmaxf(m[r], warp_max(sc));
      s[r] = valid ? expf(sc - m_new) : 0.f;  // now the probability
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(s[r]);
      m[r] = m_new;
#pragma unroll
      for (int t = 0; t < NC; ++t) acc[r][t] *= alpha;
    }

    // PV: a lane owns columns lane + 32 t; key j's probability from lane j.
    for (int j = 0; j < nrows; ++j) {
      float vx[NC];
#pragma unroll
      for (int t = 0; t < NC; ++t) {
        const int c = lane + 32 * t;
        vx[t] = c < d ? repro::to_f32(sv[j * d + c]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float p = __shfl_sync(kFull, s[r], j);
#pragma unroll
        for (int t = 0; t < NC; ++t) acc[r][t] = fmaf(p, vx[t], acc[r][t]);
      }
    }
    __syncwarp();  // the slot is read before the next tile's copies land in it
  }
  repro::cp_async_wait<0>();
  __syncwarp();

  // The warp's partial, over its own slots: m[R], l[R], acc[R, d].
  float* pm = reinterpret_cast<float*>(wbase);
  float* pl = pm + R;
  float* pa = pl + R;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    if (r < R) {
      if (lane == 0) {
        pm[r] = m[r];
        pl[r] = l[r];
      }
#pragma unroll
      for (int t = 0; t < NC; ++t) {
        const int c = lane + 32 * t;
        if (c < d) pa[r * d + c] = acc[r][t];
      }
    }
  }
  __syncthreads();

  // The combine: one output element a thread at a time.
  const long long out_base = static_cast<long long>(b) * a.sq * a.h * d +
                             static_cast<long long>(kvh) * gd;
  for (int e = threadIdx.x; e < R * d; e += W * 32) {
    const int r = e / d, c = e - r * d;
    float m_star = kNeg;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      m_star = fmaxf(m_star, reinterpret_cast<const float*>(smem + a.q_bytes + w * a.warp_bytes)[r]);
    }
    float l_sum = 0.f, a_sum = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float* pw = reinterpret_cast<const float*>(smem + a.q_bytes + w * a.warp_bytes);
      const float m_w = pw[r];
      const float wt = m_w > kNeg ? expf(m_w - m_star) : 0.f;
      l_sum = fmaf(wt, pw[R + r], l_sum);
      a_sum = fmaf(wt, pw[2 * R + r * d + c], a_sum);
    }
    const int i = r / g;
    out[out_base + static_cast<long long>(i) * a.h * d + (e - i * gd)] =
        repro::from_f32<T>(a_sum / fmaxf(l_sum, 1e-30f));
  }
}

template <typename T, int W, int RM, int NC>
int launch(const void* q, const void* k_new, const void* v_new, const void* k_pages,
           const void* v_pages, const int* tables, const int* lengths, void* out,
           const SplitArgs& a, size_t bytes, cudaStream_t st) {
  cudaError_t err = repro::allow_smem(paged_split_kernel<T, W, RM, NC>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.kv, a.b);
  paged_split_kernel<T, W, RM, NC><<<grid, W * 32, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<const T*>(k_pages), static_cast<const T*>(v_pages), tables, lengths,
      static_cast<T*>(out), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W, int RM>
int by_columns(int d, const void* q, const void* k_new, const void* v_new,
               const void* k_pages, const void* v_pages, const int* tables, const int* lengths,
               void* out, const SplitArgs& a, size_t bytes, cudaStream_t st) {
  if (d <= 64) {
    return launch<T, W, RM, 2>(q, k_new, v_new, k_pages, v_pages, tables, lengths, out, a,
                               bytes, st);
  }
  return launch<T, W, RM, 4>(q, k_new, v_new, k_pages, v_pages, tables, lengths, out, a, bytes,
                             st);
}

template <typename T, int W>
int by_rows(int rows, const void* q, const void* k_new, const void* v_new, const void* k_pages,
            const void* v_pages, const int* tables, const int* lengths, void* out,
            const SplitArgs& a, size_t bytes, cudaStream_t st) {
  switch (rows) {
    case 4:
      return by_columns<T, W, 4>(a.d, q, k_new, v_new, k_pages, v_pages, tables, lengths, out,
                                 a, bytes, st);
    case 8:
      return by_columns<T, W, 8>(a.d, q, k_new, v_new, k_pages, v_pages, tables, lengths, out,
                                 a, bytes, st);
    case 16:
      return by_columns<T, W, 16>(a.d, q, k_new, v_new, k_pages, v_pages, tables, lengths, out,
                                  a, bytes, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int by_warps(int warps, int rows, const void* q, const void* k_new, const void* v_new,
             const void* k_pages, const void* v_pages, const int* tables, const int* lengths,
             void* out, const SplitArgs& a, size_t bytes, cudaStream_t st) {
  switch (warps) {
    case 4:
      return by_rows<T, 4>(rows, q, k_new, v_new, k_pages, v_pages, tables, lengths, out, a,
                           bytes, st);
    case 8:
      return by_rows<T, 8>(rows, q, k_new, v_new, k_pages, v_pages, tables, lengths, out, a,
                           bytes, st);
    case 16:
      return by_rows<T, 16>(rows, q, k_new, v_new, k_pages, v_pages, tables, lengths, out, a,
                            bytes, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: [b, sq, h, d]; k_new/v_new: [b, sq, kv, d]; k_pages/v_pages:
// [n_phys, page_size, kv, d]; tables: [b, n_max] int32; lengths: [b] int32;
// out: [b, sq, h, d].  All contiguous, q and the K/V tensors 16-byte
// aligned; h % kv == 0; d * itemsize a multiple of 16 and d <= 128;
// page_size <= 32; (h / kv) * sq <= rows.  warps (4, 8 or 16) and rows (4,
// 8 or 16: RM, the query rows a lane holds) pick the instance.  smem_bytes is the caller's size of the
// launch's shared memory: it must equal this kernel's layout.
extern "C" int repro_paged_attention_split(const void* q, const void* k_new, const void* v_new,
                                           const void* k_pages, const void* v_pages,
                                           const void* tables, const void* lengths, void* out,
                                           int dtype, int b, int sq, int h, int kv, int d,
                                           int n_phys, int page_size, int n_max, int warps,
                                           int rows, long long smem_bytes, void* stream) {
  const int itemsize = dtype == repro::kDtypeF32 ? 4 : dtype == repro::kDtypeBF16 ? 2 : 0;
  if (itemsize == 0 || b <= 0 || b > 65535 || sq <= 0 || h <= 0 || kv <= 0 || h % kv != 0 ||
      d <= 0 || d > 128 || (d * itemsize) % 16 != 0 || n_phys <= 0 || page_size <= 0 ||
      page_size > 32 || n_max <= 0 || (h / kv) * sq > rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SplitArgs a =
      split_layout(b, sq, h, kv, d, n_phys, page_size, n_max, itemsize, warps, rows);
  const long long bytes = a.q_bytes + warps * a.warp_bytes;
  if (bytes != smem_bytes) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(tables);
  const int* lens = static_cast<const int*>(lengths);
  const size_t nb = static_cast<size_t>(bytes);
  if (dtype == repro::kDtypeF32) {
    return by_warps<float>(warps, rows, q, k_new, v_new, k_pages, v_pages, tbl, lens, out, a,
                           nb, st);
  }
  return by_warps<__nv_bfloat16>(warps, rows, q, k_new, v_new, k_pages, v_pages, tbl, lens,
                                 out, a, nb, st);
}
