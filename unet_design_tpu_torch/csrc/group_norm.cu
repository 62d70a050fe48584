// GroupNorm forward for contiguous NCHW tensors, CUDA C++ for sm_90a.
//
// Replaces no TPU kernel: GroupNorm in the JAX package is XLA's.  It was
// added because PyTorch's own CUDA GroupNorm launches its statistics pass
// (RowwiseMomentsCUDAKernel) with one block per (sample, group) row, and
// the PDE U-Nets' GroupNorm(1) at batch 8 has 8 rows of 131,072-1,048,576
// elements: 8 blocks on a card of 132 SMs, 51 GB/s.  Wrapper, plan and
// plain version: ops/group_norm.py.
//
// A row r = n * G + g of x (N, C, HW) holds the C / G channels of group g
// of sample n, D = (C / G) * HW contiguous elements.  Out of x it writes
//   mean[r], rstd[r] = 1 / sqrt(var[r] + eps)   (fp32, biased variance),
//   y = (x - mean[r]) * (rstd[r] * gamma[c]) + beta[c]
// computed in fp32 and stored in x's dtype (float32 or bfloat16).
//
// Bound.  A few operations per element: the work is bound by bytes.  The
// least a forward can move is x read once and y written once; this design
// reads x twice (statistics, then normalisation), and the second read
// finds x in the 50 MB L2 where x fits there.
//
// Design.  Three kernels, launched by group_norm_launch on one stream.
// * moments_kernel: a team of kTeam threads (a warp up to a block; the
//   plan picks it from the chunk's length) takes one chunk of one row,
//   reads it once in 16-byte vectors (kUnroll of them in flight a thread;
//   an unaligned head and tail one element at a time), and reduces it to
//   (count, mean, M2): each vector's mean and M2 by two passes over its
//   registers, folded into the thread's running moments by Chan's merge
//   (Welford's update is its one-element case), then Chan's merge across
//   warp shuffles and, for a team of several warps, shared memory.  Never
//   E[x^2] - E[x]^2: rows are long and need not have mean 0.  A row in
//   one chunk gets its mean and rstd there; else the chunk's (mean, M2)
//   goes to a buffer of partials.
// * finalize_kernel (rows in several chunks only): a block a row merges
//   the row's partials the same way and writes mean and rstd.
// * normalize_kernel: flat over x, kUnroll vectors a thread; each vector's
//   plane (n * C + c), row and channel come from multiply-shift divisions.
//   Vectors need HW to be a multiple of the vector width and x 16-byte
//   aligned; otherwise it takes one element at a time.
// The plan (ops/group_norm.py) cuts a row into as many chunks as it takes
// to fill the card a couple of times over, none under 4,096 elements: the
// PDE rows split into 32-256 chunks, and the DDPM's 8,192 rows (batch
// 256, GroupNorm(32)) stay one chunk each.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // block size of every kernel
constexpr int kUnroll = 4;     // 16-byte loads a thread keeps in flight
constexpr int kWarps = kThreads / 32;
constexpr int kBad = 1;        // cudaErrorInvalidValue

template <typename T> struct Pack;
template <> struct Pack<float> {
  static constexpr int V = 4;
  __device__ __forceinline__ static void load(uint4 u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 store(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <> struct Pack<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ __forceinline__ static void two(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ __forceinline__ static uint32_t pair(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a low, b high
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ __forceinline__ static void load(uint4 u, float* f) {
    two(u.x, f);
    two(u.y, f + 2);
    two(u.z, f + 4);
    two(u.w, f + 6);
  }
  __device__ __forceinline__ static uint4 store(const float* f) {
    return make_uint4(pair(f[0], f[1]), pair(f[2], f[3]), pair(f[4], f[5]),
                      pair(f[6], f[7]));
  }
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Count, mean and sum of squared deviations of some elements.
struct Moments {
  float n, mean, m2;
};

// Chan's merge of (nb, mb, m2b) into a; nothing where nb is 0.
__device__ __forceinline__ void merge(Moments& a, float nb, float mb,
                                      float m2b) {
  if (nb == 0.f) return;
  const float n = a.n + nb;
  const float delta = mb - a.mean;
  const float w = nb / n;
  a.mean += delta * w;
  a.m2 += m2b + delta * delta * a.n * w;
  a.n = n;
}

__device__ __forceinline__ void warp_merge(Moments& a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float nb = __shfl_xor_sync(0xffffffffu, a.n, off);
    const float mb = __shfl_xor_sync(0xffffffffu, a.mean, off);
    const float m2b = __shfl_xor_sync(0xffffffffu, a.m2, off);
    merge(a, nb, mb, m2b);
  }
}

// Merges the moments of a team of kTeam threads (kTeam a multiple of 32
// dividing kThreads); the team's first thread returns the result.  Every
// thread of the block calls it.
template <int kTeam>
__device__ __forceinline__ Moments team_merge(Moments a) {
  warp_merge(a);
  if constexpr (kTeam > 32) {
    constexpr int kPer = kTeam / 32;  // warps a team
    __shared__ Moments part[kWarps];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) part[warp] = a;
    __syncthreads();
    if (warp % kPer == 0) {
      a = lane < kPer ? part[warp + lane] : Moments{0.f, 0.f, 0.f};
      warp_merge(a);
    }
  }
  return a;
}

__device__ __forceinline__ float rstd_of(float m2, int d, float eps) {
  return 1.f / sqrtf(m2 / static_cast<float>(d) + eps);
}

// Moments of one vector's V values: mean, then the squares about it.
template <int V>
__device__ __forceinline__ void add_vector(Moments& a, const float* f) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) s += f[j];
  const float m = s * (1.f / V);
  float m2 = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) m2 += (f[j] - m) * (f[j] - m);
  merge(a, static_cast<float>(V), m, m2);
}

struct MomentArgs {
  int rows;     // N * G
  int row_len;  // D = (C / G) * HW
  int chunks;   // chunk k of a row: [k * D / chunks, (k + 1) * D / chunks)
  float eps;
};

__device__ __forceinline__ int chunk_start(int k, const MomentArgs& a) {
  return static_cast<int>(static_cast<long long>(k) * a.row_len / a.chunks);
}

// grid: rows * chunks / (kThreads / kTeam) blocks (rounded up); a team of
// kTeam threads a (row, chunk).
template <typename T, int kTeam>
__global__ void __launch_bounds__(kThreads)
moments_kernel(const T* __restrict__ x, float* __restrict__ mean,
               float* __restrict__ rstd, float* __restrict__ part_mean,
               float* __restrict__ part_m2, const MomentArgs a) {
  using P = Pack<T>;
  constexpr int V = P::V;
  const int item = blockIdx.x * (kThreads / kTeam) + threadIdx.x / kTeam;
  const int lane = threadIdx.x % kTeam;
  Moments m{0.f, 0.f, 0.f};
  const bool active = item < a.rows * a.chunks;
  int row = 0, chunk = 0;
  if (active) {
    row = item / a.chunks;
    chunk = item - row * a.chunks;
    const int start = chunk_start(chunk, a);
    const int len = chunk_start(chunk + 1, a) - start;
    const T* p = x + static_cast<long long>(row) * a.row_len + start;
    const int head = min(
        static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) /
                         sizeof(T)),
        len);
    const int nvec = (len - head) / V;
    const int tail0 = head + nvec * V;
    const uint4* pv = reinterpret_cast<const uint4*>(p + head);
    for (int base = lane; base < nvec; base += kTeam * kUnroll) {
      uint4 v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int i = base + k * kTeam;
        if (i < nvec) v[k] = __ldg(pv + i);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (base + k * kTeam < nvec) {
          float f[V];
          P::load(v[k], f);
          add_vector<V>(m, f);
        }
      }
    }
    // head and tail: fewer than 2V elements, one a thread
    const int n_edge = head + (len - tail0);
    if (lane < n_edge) {
      const int e = lane < head ? lane : tail0 + (lane - head);
      merge(m, 1.f, to_float(p[e]), 0.f);
    }
  }
  m = team_merge<kTeam>(m);
  if (!active || lane != 0) return;
  if (a.chunks == 1) {
    mean[row] = m.mean;
    rstd[row] = rstd_of(m.m2, a.row_len, a.eps);
  } else {
    part_mean[item] = m.mean;
    part_m2[item] = m.m2;
  }
}

// grid: rows; a block merges a row's chunks.
__global__ void __launch_bounds__(kThreads)
finalize_kernel(const float* __restrict__ part_mean,
                const float* __restrict__ part_m2, float* __restrict__ mean,
                float* __restrict__ rstd, const MomentArgs a) {
  const int row = blockIdx.x;
  Moments m{0.f, 0.f, 0.f};
  for (int k = threadIdx.x; k < a.chunks; k += kThreads) {
    const int i = row * a.chunks + k;
    const int len = chunk_start(k + 1, a) - chunk_start(k, a);
    merge(m, static_cast<float>(len), part_mean[i], part_m2[i]);
  }
  m = team_merge<kThreads>(m);
  if (threadIdx.x == 0) {
    mean[row] = m.mean;
    rstd[row] = rstd_of(m.m2, a.row_len, a.eps);
  }
}

// n / d for n < 2^31 by a multiply and a shift (d >= 1).
struct FastDiv {
  uint32_t m, s;
  __device__ __forceinline__ uint32_t operator()(uint32_t n) const {
    return (__umulhi(n, m) + n) >> s;
  }
};

FastDiv make_div(uint32_t d) {
  uint32_t s = 0;
  while ((1ull << s) < d) ++s;
  const uint64_t m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return FastDiv{static_cast<uint32_t>(m), s};
}

struct NormArgs {
  long long total;  // N * C * HW
  int hw, c;
  FastDiv by_hw, by_cg, by_c;
};

// grid: total / (kThreads * kUnroll * V) blocks (rounded up), each a
// contiguous span of x; kVec: 16-byte vectors (HW a multiple of V, x and y
// 16-byte aligned), else one element at a time.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
normalize_kernel(const T* __restrict__ x, T* __restrict__ y,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta,
                 const float* __restrict__ mean,
                 const float* __restrict__ rstd, const NormArgs a) {
  using P = Pack<T>;
  constexpr int V = P::V;
  constexpr int kSpan = kThreads * kUnroll * V;
  const long long base = static_cast<long long>(blockIdx.x) * kSpan;
  // the span's first plane and where in it the span starts; offsets from
  // there stay under 2^31
  const long long p0 = base / a.hw;
  const uint32_t h0 = static_cast<uint32_t>(base - p0 * a.hw);
  const int tid = threadIdx.x;
  auto scale_shift = [&](uint32_t q, float& s, float& t, float& mu) {
    const uint32_t plane = static_cast<uint32_t>(p0) + a.by_hw(q);
    const uint32_t row = a.by_cg(plane);
    const uint32_t c = plane - a.by_c(plane) * a.c;
    mu = __ldg(mean + row);
    s = __ldg(rstd + row) * __ldg(gamma + c);
    t = __ldg(beta + c);
  };
  if constexpr (kVec) {
    uint4 v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long e = base + static_cast<long long>(k * kThreads + tid) * V;
      if (e < a.total) v[k] = __ldg(reinterpret_cast<const uint4*>(x + e));
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int off = (k * kThreads + tid) * V;
      if (base + off >= a.total) continue;
      float s, t, mu, f[V];
      scale_shift(h0 + off, s, t, mu);
      P::load(v[k], f);
#pragma unroll
      for (int j = 0; j < V; ++j) f[j] = fmaf(f[j] - mu, s, t);
      *reinterpret_cast<uint4*>(y + base + off) = P::store(f);
    }
  } else {
    constexpr int kN = kUnroll * V;
    T v[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const long long e = base + k * kThreads + tid;
      if (e < a.total) v[k] = x[e];
    }
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int off = k * kThreads + tid;
      if (base + off >= a.total) continue;
      float s, t, mu;
      scale_shift(h0 + off, s, t, mu);
      y[base + off] = from_float<T>(fmaf(to_float(v[k]) - mu, s, t));
    }
  }
}

template <typename T, int kTeam>
int launch_moments(const T* x, float* mean, float* rstd, float* pm,
                   float* pm2, const MomentArgs& a, cudaStream_t s) {
  constexpr int per = kThreads / kTeam;
  const long long items = static_cast<long long>(a.rows) * a.chunks;
  const long long blocks = (items + per - 1) / per;
  if (blocks > 0x7fffffff) return kBad;
  moments_kernel<T, kTeam><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      x, mean, rstd, pm, pm2, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* xv, void* yv, const float* gamma,
                 const float* beta, float* mean, float* rstd, float* part,
                 long long total, int rows, int row_len, int hw, int c,
                 int chunks, int team, float eps, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const MomentArgs ma{rows, row_len, chunks, eps};
  float* pm = part;
  float* pm2 = part + static_cast<long long>(rows) * chunks;
  int e;
  switch (team) {
    case 32: e = launch_moments<T, 32>(x, mean, rstd, pm, pm2, ma, s); break;
    case 64: e = launch_moments<T, 64>(x, mean, rstd, pm, pm2, ma, s); break;
    case 128: e = launch_moments<T, 128>(x, mean, rstd, pm, pm2, ma, s); break;
    case 256: e = launch_moments<T, 256>(x, mean, rstd, pm, pm2, ma, s); break;
    default: return kBad;
  }
  if (e) return e;
  if (chunks > 1) {
    finalize_kernel<<<rows, kThreads, 0, s>>>(pm, pm2, mean, rstd, ma);
    e = static_cast<int>(cudaGetLastError());
    if (e) return e;
  }
  const int cg = row_len / hw;  // channels a group
  const NormArgs na{total, hw, c, make_div(hw), make_div(cg), make_div(c)};
  constexpr int V = Pack<T>::V;
  constexpr long long span = static_cast<long long>(kThreads) * kUnroll * V;
  const long long blocks = (total + span - 1) / span;
  if (blocks > 0x7fffffff) return kBad;
  const bool vec = hw % V == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (vec)
    normalize_kernel<T, true><<<grid, kThreads, 0, s>>>(x, y, gamma, beta,
                                                         mean, rstd, na);
  else
    normalize_kernel<T, false><<<grid, kThreads, 0, s>>>(x, y, gamma, beta,
                                                          mean, rstd, na);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// GroupNorm of x (N, C, HW), contiguous, into y (same shape and dtype),
// mean and rstd (N * G floats each), with `part` (2 * N * G * chunks
// floats) for the partial moments of rows in several chunks.  gamma and
// beta: C floats.  A row of D = row_len elements is cut into `chunks`
// chunks, chunk k [k * D / chunks, (k + 1) * D / chunks), each reduced by
// `team` threads (32, 64, 128 or 256).  dtype 0 = float32, 1 = bfloat16.
// Launches on `stream`, allocates nothing, does not synchronise; returns
// the first cudaError_t (0 = success).
int group_norm_launch(const void* x, void* y, const void* gamma,
                      const void* beta, void* mean, void* rstd, void* part,
                      long long total, int rows, int row_len, int hw, int c,
                      int chunks, int team, int dtype, float eps,
                      void* stream) {
  if (rows < 1 || row_len < 1 || hw < 1 || c < 1 || chunks < 1 ||
      chunks > row_len || row_len % hw || c % (row_len / hw) ||
      static_cast<long long>(rows) * chunks > 0x7fffffffLL ||
      total != static_cast<long long>(rows) * row_len ||
      total / hw > 0x7fffffffLL)
    return kBad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  float* p = static_cast<float*>(part);
  if (dtype == 0)
    return launch_typed<float>(x, y, g, b, m, r, p, total, rows, row_len, hw,
                               c, chunks, team, eps, s);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(x, y, g, b, m, r, p, total, rows,
                                       row_len, hw, c, chunks, team, eps, s);
  return kBad;
}

}  // extern "C"
