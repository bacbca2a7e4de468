// Ragged paged decode attention for Hopper.
//
// Replaces: src/repro/kernels/flash_attn/paged.py::paged_attention_pallas
// (_kernel), the TPU kernel whose grid walks a sequence's pages as its
// sequential axis, with the page table in scalar-prefetched SMEM and each
// page DMA'd into a two-slot VMEM buffer.
//
// Computes what paged.py::paged_attention_ref computes: for every sequence b,
// query row i and head h, softmax over (cache rows < lengths[b], read through
// tables[b]) ++ (this step's new keys t with t <= i), times the matching V
// rows, with scale 1/sqrt(D), float32 scores, softmax and accumulation, and
// the output in q's dtype.  GQA: q head h reads KV head h / (H / KV).
//
// Bound: at serving shapes (one query row per sequence, a few hundred cache
// rows) the work is ~4 FLOP per K/V element read, so it is bytes bound: the
// K and V rows of the valid cache, read once.  Design, simple first: one
// block per (KV head, block of query rows, sequence); it reads the sequence's
// length and page ids itself (the TPU's scalar prefetch) and loops over the
// pages that hold valid rows (the TPU's sequential grid axis).  For each page
// it stages the page's [page_size, D] K and V rows of its KV head in shared
// memory as f32 (rows past the length are not read: they are zero and
// masked), computes the g*bq x page_size scores, runs the online-softmax
// update with the probabilities multiplied by the mask (so a page or a cache
// with no valid row adds exactly nothing), and then does the same for the new
// keys, page_size at a time, masked t <= i and t < Sq.  The output is acc /
// max(l, 1e-30).  A page past the length is never visited: masked, it would
// add exactly nothing.  A page id outside [0, n_phys) reads NaN, never out of
// bounds.  cp.async double buffering, split-K over pages and wgmma are later
// work.
#include "common.cuh"

namespace {

constexpr int kAttnThreads = 128;
constexpr float kNeg = -1e30f;

// Shared-memory layout, also computed by
// repro_torch/kernels/flash_attn/paged.py::paged_smem_bytes.  K rows are
// padded by one float so the score loop, whose lanes walk the page's rows at
// one d, falls in different banks.
struct PagedLayout {
  int rows;  // g * block_q query rows of a block
  int ldk;   // row stride of the staged K rows
  size_t bytes;
};

PagedLayout paged_layout(int rows, int page_size, int d) {
  PagedLayout l;
  l.rows = rows;
  l.ldk = d + 1;
  const size_t floats = static_cast<size_t>(rows) * d      // q
                        + static_cast<size_t>(page_size) * l.ldk  // K
                        + static_cast<size_t>(page_size) * d      // V
                        + static_cast<size_t>(rows) * page_size   // scores
                        + static_cast<size_t>(rows) * d           // acc
                        + 3 * static_cast<size_t>(rows);          // m, l, alpha
  l.bytes = floats * sizeof(float);
  return l;
}

struct PagedArgs {
  int b, sq, h, kv, d, n_phys, page_size, n_max, block_q, g;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
paged_kernel(const T* __restrict__ q, const T* __restrict__ k_new, const T* __restrict__ v_new,
             const T* __restrict__ k_pages, const T* __restrict__ v_pages,
             const int* __restrict__ tables, const int* __restrict__ lengths, T* __restrict__ out,
             PagedArgs a, int ldk) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x;
  const int i0 = blockIdx.y * a.block_q;
  const int b = blockIdx.z;
  const int nq = min(a.block_q, a.sq - i0);
  const int g = a.g, d = a.d, ps = a.page_size;
  const int rows = nq * g;  // row r: query i0 + r / g, head kvh * g + r % g
  const int max_rows = a.block_q * g;
  float* s_q = smem;                          // [max_rows, d]
  float* s_k = s_q + max_rows * d;            // [ps, ldk]
  float* s_v = s_k + ps * ldk;                // [ps, d]
  float* s_s = s_v + ps * d;                  // [max_rows, ps]
  float* s_acc = s_s + max_rows * ps;         // [max_rows, d]
  float* s_m = s_acc + max_rows * d;          // [max_rows]
  float* s_l = s_m + max_rows;                // [max_rows]
  float* s_alpha = s_l + max_rows;            // [max_rows]

  const long long kv_row = static_cast<long long>(a.kv) * d;  // stride of a K/V row
  const long long q_row = static_cast<long long>(a.h) * d;    // stride of a q row
  for (int e = threadIdx.x; e < rows * d; e += blockDim.x) {
    const int r = e / d, c = e - (e / d) * d;
    const long long qi = static_cast<long long>(b) * a.sq + i0 + r / g;
    s_q[e] = repro::to_f32(q[qi * q_row + static_cast<long long>(kvh * g + r % g) * d + c]);
    s_acc[e] = 0.f;
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    s_m[r] = kNeg;
    s_l[r] = 0.f;
  }

  // One online-softmax step over `nk` staged rows.  `valid(r, j)` says
  // whether query row r may attend staged row j.
  auto update = [&](int nk, auto valid) {
    __syncthreads();  // staging done
    for (int e = threadIdx.x; e < rows * ps; e += blockDim.x) {
      const int r = e / ps, j = e - (e / ps) * ps;
      float s = kNeg;
      if (j < nk && valid(r, j)) {
        const float* qr = s_q + r * d;
        const float* kr = s_k + j * ldk;
        float dot = 0.f;
        for (int c = 0; c < d; ++c) dot = fmaf(qr[c], kr[c], dot);
        s = dot * a.scale;
      }
      s_s[e] = s;
    }
    __syncthreads();
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      float* sr = s_s + r * ps;
      const float m_prev = s_m[r];
      float m_new = m_prev;
      for (int j = 0; j < nk; ++j) m_new = fmaxf(m_new, sr[j]);
      float sum = 0.f;
      for (int j = 0; j < ps; ++j) {
        const float p = (j < nk && valid(r, j)) ? expf(sr[j] - m_new) : 0.f;
        sr[j] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      s_l[r] = alpha * s_l[r] + sum;
      s_m[r] = m_new;
      s_alpha[r] = alpha;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rows * d; e += blockDim.x) {
      const int r = e / d, c = e - (e / d) * d;
      const float* pr = s_s + r * ps;
      float pv = 0.f;
      for (int j = 0; j < nk; ++j) pv = fmaf(pr[j], s_v[j * d + c], pv);
      s_acc[e] = s_alpha[r] * s_acc[e] + pv;
    }
    __syncthreads();  // the staged rows are no longer read
  };

  // The cache, page by page.
  const int len = max(lengths[b], 0);
  const int n_used = min((len + ps - 1) / ps, a.n_max);
  const float bad = repro::quiet_nan();
  for (int jp = 0; jp < n_used; ++jp) {
    const int page = tables[static_cast<long long>(b) * a.n_max + jp];
    const bool ok = page >= 0 && page < a.n_phys;
    const int nk = min(ps, len - jp * ps);  // valid rows of this page
    const long long base = (static_cast<long long>(ok ? page : 0) * ps) * kv_row + kvh * d;
    for (int e = threadIdx.x; e < ps * d; e += blockDim.x) {
      const int j = e / d, c = e - (e / d) * d;
      float kx = 0.f, vx = 0.f;
      if (j < nk) {
        const long long off = base + j * kv_row + c;
        kx = ok ? repro::to_f32(k_pages[off]) : bad;
        vx = ok ? repro::to_f32(v_pages[off]) : bad;
      }
      s_k[j * ldk + c] = kx;
      s_v[j * d + c] = vx;
    }
    update(nk, [](int, int) { return true; });
  }

  // This step's new keys, page_size at a time: row t is query t's own key.
  for (int t0 = 0; t0 < a.sq && t0 <= i0 + nq - 1; t0 += ps) {
    const int nk = min(ps, a.sq - t0);
    const long long base = (static_cast<long long>(b) * a.sq + t0) * kv_row + kvh * d;
    for (int e = threadIdx.x; e < ps * d; e += blockDim.x) {
      const int j = e / d, c = e - (e / d) * d;
      float kx = 0.f, vx = 0.f;
      if (j < nk) {
        kx = repro::to_f32(k_new[base + j * kv_row + c]);
        vx = repro::to_f32(v_new[base + j * kv_row + c]);
      }
      s_k[j * ldk + c] = kx;
      s_v[j * d + c] = vx;
    }
    update(nk, [&](int r, int j) { return t0 + j <= i0 + r / g; });
  }

  for (int e = threadIdx.x; e < rows * d; e += blockDim.x) {
    const int r = e / d, c = e - (e / d) * d;
    const long long qi = static_cast<long long>(b) * a.sq + i0 + r / g;
    out[qi * q_row + static_cast<long long>(kvh * g + r % g) * d + c] =
        repro::from_f32<T>(s_acc[e] / fmaxf(s_l[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k_new, const void* v_new, const void* k_pages,
           const void* v_pages, const int* tables, const int* lengths, void* out,
           const PagedArgs& a, const PagedLayout& l, cudaStream_t st) {
  cudaError_t err = repro::allow_smem(paged_kernel<T>, l.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.kv, (a.sq + a.block_q - 1) / a.block_q, a.b);
  paged_kernel<T><<<grid, kAttnThreads, l.bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<const T*>(k_pages), static_cast<const T*>(v_pages), tables, lengths,
      static_cast<T*>(out), a, l.ldk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: [b, sq, h, d]; k_new/v_new: [b, sq, kv, d]; k_pages/v_pages:
// [n_phys, page_size, kv, d]; tables: [b, n_max] int32; lengths: [b] int32;
// out: [b, sq, h, d].  All contiguous; h % kv == 0.  smem_bytes is the
// caller's size of the launch's shared memory: it must equal this kernel's
// layout for g * block_q query rows.
extern "C" int repro_paged_attention(const void* q, const void* k_new, const void* v_new,
                                     const void* k_pages, const void* v_pages,
                                     const void* tables, const void* lengths, void* out,
                                     int dtype, int b, int sq, int h, int kv, int d, int n_phys,
                                     int page_size, int n_max, int block_q,
                                     long long smem_bytes, void* stream) {
  if (b <= 0 || b > 65535 || sq <= 0 || h <= 0 || kv <= 0 || h % kv != 0 || d <= 0 ||
      n_phys <= 0 || page_size <= 0 || n_max <= 0 || block_q <= 0 ||
      (sq + block_q - 1) / block_q > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PagedArgs a{b, sq, h, kv, d, n_phys, page_size, n_max, block_q, h / kv,
              1.0f / sqrtf(static_cast<float>(d))};
  const PagedLayout l = paged_layout(a.g * block_q, page_size, d);
  if (static_cast<long long>(l.bytes) != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(tables);
  const int* lens = static_cast<const int*>(lengths);
  if (dtype == repro::kDtypeF32) {
    return launch<float>(q, k_new, v_new, k_pages, v_pages, tbl, lens, out, a, l, st);
  }
  if (dtype == repro::kDtypeBF16) {
    return launch<__nv_bfloat16>(q, k_new, v_new, k_pages, v_pages, tbl, lens, out, a, l, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
