// Multi-level Haar LL pyramid for NHWC tensors, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel
// unet_design_tpu/ops/pallas/haar.py::haar_pyramid_fused (pl.pallas_call at
// haar.py:60, body _pyramid_kernel / _avg_matrix).  Given x (N, H, W, C) with
// H and W divisible by f = 2^(L-1), it writes levels 1..L-1 of the pyramid
// [x, down1, ..., down_{L-1}], each level the 2x2 mean of the one before,
// into one buffer, level after level.  Sums are taken in fp32 and kept in
// fp32 from level to level (as the TPU kernel does); each level is cast to
// the input dtype only when stored.  The four values of a 2x2 block are
// summed as ((a + b) + (c + d)) * 0.25 with (a, b) the top row, the order of
// haar_pyramid_reference in ops/haar.py, so both agree bit for bit.
//
// Bound.  Three adds and a multiply per output element: the work is bound
// by bytes.  At the main path's (8, 128, 128, 3) fp32 with L = 4 it reads
// 1.57 MB and writes 0.52 MB, 0.624 us at 3.35 TB/s, less than what one
// launch of any kernel takes on the device; so what decides the time is
// how many round trips to device memory a block waits for, and the host's
// cost of a call.
//
// Measured (chip_smoke.py on an NVIDIA H100 80GB HBM3, 700 W; PERF.md):
// 3.06 us on the device at that shape and 3.0-3.1 us at CIFAR's
// (128, 32, 32, 3) L4, against 7.08 us for the earlier design of one
// 16x16 tile a block reduced level by level behind barriers; an empty
// kernel on the same grid takes 0.88 us.
//
// Design.  ops/haar.py's Plan picks the tile width (seg); make_plan below
// derives everything else from the shape and seg on every launch: the
// level offsets in the output buffer, the shared-memory layout and the
// block size.
//
// * A block takes f whole image rows (one row band), or, where f rows of the
//   image are more than 36 KB, a segment of them whose width is a multiple
//   of f.  In NHWC f whole rows are one contiguous span, and so is every
//   level's part of it; a split tile loads its f row pieces one after
//   another.  Because H and W are multiples of f, no tile ever holds a
//   partial 2x2 block at any level.
// * Load: the span is copied into shared memory, as it lies, in 16-byte
//   vectors; each thread issues up to kLoadVecs of them before it stores
//   any, so a block waits for one round trip to device memory (at the main
//   path's shape: 128 blocks of 12 KB, the whole input requested in one
//   wave).  An unaligned head and tail go one element at a time.
// * Reduce: each thread owns one level-1 pixel (all C channels, C a
//   template parameter for C <= 4) and reads its 2x2 block from shared
//   memory.  Threads of a warp hold level-1 pixels in Z order, so the next
//   two levels are xor shuffles over groups of 4 and 16 lanes: no barrier
//   between levels 1, 2 and 3, and every thread works at level 1.  Deeper
//   levels (L >= 5 only) go through fp32 shared buffers, a barrier each.
// * Store: every level is staged in shared memory in the input dtype and
//   written back as contiguous spans in 16-byte vectors.
// * Offsets inside a block are 32-bit; the inner loops divide by nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxThreads = 512;
constexpr int kLoadVecs = 4;      // 16-byte loads a thread keeps in flight
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;  // what a block may opt in to on sm_90
constexpr int kMaxGridYZ = 65535;

// How one shape is launched: derived from the shape by make_plan below and
// passed to the kernel by value.
struct HaarPlan {
  long long level_off[kMaxLevels];  // element offset of level l in out (l>=1)
  int n, h, w, c;
  int n_levels;    // L >= 2
  int dtype;       // 0 = float32, 1 = bfloat16
  int seg;         // pixels per width segment, a multiple of 2^(L-1)
  int n_seg;       // segments per row band (1: a tile is f whole rows)
  int threads;     // block size, a multiple of 32
  int smem_bytes;  // dynamic shared memory of a block
  // byte offsets in shared memory: levels 0..L-1 in the input dtype, then
  // two fp32 buffers used when L >= 5
  int smem_off[kMaxLevels + 2];
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
  return __float2bfloat16(v);  // round to nearest even
}

// The spans are copied as raw bits: E is an unsigned integer of the
// element's width, V elements make one 16-byte vector.
template <typename T> struct Bits;
template <> struct Bits<float> { using type = uint32_t; };
template <> struct Bits<__nv_bfloat16> { using type = uint16_t; };

template <typename E> union Vec16 {
  uint4 u;
  E e[16 / sizeof(E)];
};

// Leading elements of g before its first 16-byte boundary, at most n.
template <typename E>
__device__ __forceinline__ int head_of(const E* g, int n) {
  const int h = static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(g) & 15)) & 15) / sizeof(E));
  return min(h, n);
}

// Copies n elements from global g to shared s.  Every load of a thread is
// issued before the first of its stores to shared memory.
template <typename E>
__device__ __forceinline__ void load_span(const E* __restrict__ g, E* s,
                                          int n, int tid, int nt) {
  constexpr int V = 16 / sizeof(E);
  const int head = head_of(g, n);
  const int nvec = (n - head) / V;
  const int tail0 = head + nvec * V;
  const int n_edge = head + (n - tail0);  // < 2V <= 16 <= nt
  int ei = -1;
  E edge = 0;
  if (tid < n_edge) {
    ei = tid < head ? tid : tail0 + (tid - head);
    edge = g[ei];
  }
  const uint4* gv = reinterpret_cast<const uint4*>(g + head);
  E* sb = s + head;
  const bool s_aligned = (reinterpret_cast<uintptr_t>(sb) & 15) == 0;
  for (int base = 0; base < nvec; base += kLoadVecs * nt) {
    Vec16<E> v[kLoadVecs];
#pragma unroll
    for (int k = 0; k < kLoadVecs; ++k) {
      const int i = base + k * nt + tid;
      if (i < nvec) v[k].u = __ldg(gv + i);
    }
#pragma unroll
    for (int k = 0; k < kLoadVecs; ++k) {
      const int i = base + k * nt + tid;
      if (i < nvec) {
        if (s_aligned) {
          reinterpret_cast<uint4*>(sb)[i] = v[k].u;
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) sb[i * V + j] = v[k].e[j];
        }
      }
    }
  }
  if (ei >= 0) s[ei] = edge;
}

// Copies n elements from shared s to global g.
template <typename E>
__device__ __forceinline__ void store_span(E* __restrict__ g, const E* s,
                                           int n, int tid, int nt) {
  constexpr int V = 16 / sizeof(E);
  const int head = head_of(g, n);
  const int nvec = (n - head) / V;
  const int tail0 = head + nvec * V;
  const int n_edge = head + (n - tail0);
  uint4* gv = reinterpret_cast<uint4*>(g + head);
  const E* sb = s + head;
  const bool s_aligned = (reinterpret_cast<uintptr_t>(sb) & 15) == 0;
  for (int i = tid; i < nvec; i += nt) {
    Vec16<E> v;
    if (s_aligned) {
      v.u = reinterpret_cast<const uint4*>(sb)[i];
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v.e[j] = sb[i * V + j];
    }
    gv[i] = v.u;
  }
  if (tid < n_edge) {
    const int ei = tid < head ? tid : tail0 + (tid - head);
    g[ei] = s[ei];
  }
}

// grid: (segments, H / f, N); block: p.threads
template <typename T, int kC>
__global__ void __launch_bounds__(kMaxThreads)
haar_pyramid_kernel(const T* __restrict__ x, T* __restrict__ out,
                    const HaarPlan p) {
  using E = typename Bits<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = kC > 0 ? kC : p.c;
  const int L = p.n_levels;
  const int f = 1 << (L - 1);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int w0 = blockIdx.x * p.seg;
  const int wlen = min(p.seg, p.w - w0);  // a multiple of f
  const int r0 = blockIdx.y * f;
  const int n = blockIdx.z;
  const bool whole = p.n_seg == 1;         // f whole rows: one span a level

  // ---- level 0: f rows of wlen pixels, dense in shared memory
  {
    const E* xb = reinterpret_cast<const E*>(x);
    E* s0 = reinterpret_cast<E*>(smem + p.smem_off[0]);
    const long long g0 =
        ((static_cast<long long>(n) * p.h + r0) * p.w + w0) * C;
    const int row = wlen * C;
    if (whole) {
      load_span(xb + g0, s0, f * row, tid, nt);
    } else {
      const long long pitch = static_cast<long long>(p.w) * C;
      for (int r = 0; r < f; ++r)
        load_span(xb + g0 + r * pitch, s0 + r * row, row, tid, nt);
    }
  }
  __syncthreads();

  // ---- levels 1..min(L-1, 3): a thread per level-1 pixel, Z order in
  // groups of gs x gs pixels (gs * gs lanes), so level 2 is a 2x2 block of
  // lanes (xor 1, 2) and level 3 a 2x2 block of those (xor 4, 8)
  const int s_log = min(L - 2, 2);
  const int gs = 1 << s_log;
  const int within = tid & (gs * gs - 1);   // nt is a multiple of 32
  const int dx = (within & 1) | ((within >> 1) & 2);
  const int dy = ((within >> 1) & 1) | ((within >> 2) & 2);
  const int row0 = wlen * C;
  const int row1 = (wlen >> 1) * C;
  const int row2 = (wlen >> 2) * C;
  const int row3 = (wlen >> 3) * C;
  const int lanes = gs * (wlen >> 1);       // lanes for one row of groups
  const T* s0 = reinterpret_cast<const T*>(smem + p.smem_off[0]);
  T* s1 = reinterpret_cast<T*>(smem + p.smem_off[1]);
  T* s2 = reinterpret_cast<T*>(smem + p.smem_off[2]);
  T* s3 = reinterpret_cast<T*>(smem + p.smem_off[3]);
  float* f3 = reinterpret_cast<float*>(smem + p.smem_off[kMaxLevels]);
  for (int gr = 0; gr < (f >> 1); gr += gs) {    // rows of groups
    for (int base = 0; base < lanes; base += nt) {  // the same in all lanes
      const int q = base + tid;
      const bool active = q < lanes;
      const int y1 = gr + dy;
      const int x1 = ((q >> (2 * s_log)) << s_log) + dx;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float v1 = 0.f;
        if (active) {
          const T* a = s0 + (2 * y1) * row0 + (2 * x1) * C + c;
          v1 = ((to_float(a[0]) + to_float(a[C])) +
                (to_float(a[row0]) + to_float(a[row0 + C]))) * 0.25f;
          s1[y1 * row1 + x1 * C + c] = from_float<T>(v1);
        }
        if (L > 2) {
          // a + b == b + a in IEEE arithmetic: every lane of the block gets
          // the bits of ((a + b) + (c + d)) * 0.25
          float h = v1 + __shfl_xor_sync(0xffffffffu, v1, 1);
          const float v2 = (h + __shfl_xor_sync(0xffffffffu, h, 2)) * 0.25f;
          if (active && (within & 3) == 0)
            s2[(y1 >> 1) * row2 + (x1 >> 1) * C + c] = from_float<T>(v2);
          if (L > 3) {
            h = v2 + __shfl_xor_sync(0xffffffffu, v2, 4);
            const float v3 =
                (h + __shfl_xor_sync(0xffffffffu, h, 8)) * 0.25f;
            if (active && within == 0) {
              const int i3 = (y1 >> 2) * row3 + (x1 >> 2) * C + c;
              s3[i3] = from_float<T>(v3);
              if (L > 4) f3[i3] = v3;
            }
          }
        }
      }
    }
  }

  // ---- levels 4..L-1 (L >= 5): fp32 ping-pong in shared memory
  if (L > 4) {
    float* fb[2] = {f3, reinterpret_cast<float*>(
                            smem + p.smem_off[kMaxLevels + 1])};
    for (int l = 4; l < L; ++l) {
      __syncthreads();
      const float* src = fb[l & 1];        // level l - 1 (level 3 in fb[0])
      float* dst = fb[(l + 1) & 1];
      T* so = reinterpret_cast<T*>(smem + p.smem_off[l]);
      const int rs = (wlen >> (l - 1)) * C;
      const int rd = (wlen >> l) * C;
      const int wd = wlen >> l;
      for (int r = 0; r < (f >> l); ++r) {
        for (int xo = tid; xo < wd; xo += nt) {
          for (int c = 0; c < C; ++c) {
            const float* a = src + (2 * r) * rs + (2 * xo) * C + c;
            const float v =
                ((a[0] + a[C]) + (a[rs] + a[rs + C])) * 0.25f;
            dst[r * rd + xo * C + c] = v;
            so[r * rd + xo * C + c] = from_float<T>(v);
          }
        }
      }
    }
  }
  __syncthreads();

  // ---- store levels 1..L-1 as contiguous spans
  E* ob = reinterpret_cast<E*>(out);
  for (int l = 1; l < L; ++l) {
    const E* sl = reinterpret_cast<const E*>(smem + p.smem_off[l]);
    const int hl = p.h >> l;
    const int wl = p.w >> l;
    const int row = (wlen >> l) * C;
    const long long g =
        p.level_off[l] +
        ((static_cast<long long>(n) * hl + (r0 >> l)) * wl + (w0 >> l)) * C;
    if (whole) {
      store_span(ob + g, sl, (f >> l) * row, tid, nt);
    } else {
      const long long pitch = static_cast<long long>(wl) * C;
      for (int r = 0; r < (f >> l); ++r)
        store_span(ob + g + r * pitch, sl + r * row, row, tid, nt);
    }
  }
}

long long round16(long long n) { return (n + 15) & ~15LL; }

// Fills p for x (n, h, w, c) in dtype (0 = float32, 1 = bfloat16), L
// levels and tiles `seg` pixels wide.  Returns cudaErrorInvalidValue for
// what the kernel does not take.
int make_plan(int n, int h, int w, int c, int n_levels, int dtype, int seg,
              HaarPlan& p) {
  constexpr int kBad = static_cast<int>(cudaErrorInvalidValue);
  if (n_levels < 2 || n_levels > kMaxLevels || (dtype != 0 && dtype != 1) ||
      n < 1 || h < 1 || w < 1 || c < 1)
    return kBad;
  const int f = 1 << (n_levels - 1);
  if (h % f || w % f || seg % f || seg < f || seg > w || n > kMaxGridYZ ||
      h / f > kMaxGridYZ)
    return kBad;
  const int esize = dtype == 0 ? 4 : 2;
  p = HaarPlan{};
  p.n = n; p.h = h; p.w = w; p.c = c;
  p.n_levels = n_levels; p.dtype = dtype;
  p.seg = seg;
  p.n_seg = (w + seg - 1) / seg;
  // levels 1..L-1 back to back in out
  long long off = 0;
  for (int l = 1; l < n_levels; ++l) {
    p.level_off[l] = off;
    off += static_cast<long long>(n) * (h >> l) * (w >> l) * c;
  }
  // shared: levels 0..L-1 of a tile in the input dtype, each on a 16-byte
  // boundary, then (L >= 5) fp32 buffers sized for levels 3 and 4
  long long end = 0;
  for (int l = 0; l < n_levels; ++l) {
    p.smem_off[l] = static_cast<int>(end);
    end += round16(static_cast<long long>(f >> l) * (seg >> l) * c * esize);
    if (end > kMaxSmem) return kBad;
  }
  if (n_levels > 4) {
    for (int i = 0; i < 2; ++i) {
      p.smem_off[kMaxLevels + i] = static_cast<int>(end);
      end += round16(static_cast<long long>(f >> (3 + i)) * (seg >> (3 + i)) *
                     c * 4);
    }
    if (end > kMaxSmem) return kBad;
  }
  p.smem_bytes = static_cast<int>(end);
  // a thread for each level-1 pixel of a row of lane groups, and enough
  // threads for one wave of kLoadVecs 16-byte loads each; whole warps
  const long long lanes = (1LL << std::min(n_levels - 2, 2)) * (seg / 2);
  const long long vecs =
      (static_cast<long long>(f) * seg * c * esize + 15) / 16;
  const long long want = std::max(lanes, (vecs + kLoadVecs - 1) / kLoadVecs);
  p.threads = static_cast<int>(
      std::min(static_cast<long long>(kMaxThreads), (want + 31) / 32 * 32));
  return 0;
}

template <typename T, int kC>
int launch_one(const void* x, void* out, const HaarPlan& p, cudaStream_t s) {
  if (p.smem_bytes > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        haar_pyramid_kernel<T, kC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(p.n_seg, p.h >> (p.n_levels - 1), p.n);
  haar_pyramid_kernel<T, kC><<<grid, p.threads, p.smem_bytes, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* x, void* out, const HaarPlan& p,
                 cudaStream_t s) {
  switch (p.c) {
    case 1: return launch_one<T, 1>(x, out, p, s);
    case 2: return launch_one<T, 2>(x, out, p, s);
    case 3: return launch_one<T, 3>(x, out, p, s);
    case 4: return launch_one<T, 4>(x, out, p, s);
    default: return launch_one<T, 0>(x, out, p, s);
  }
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// Launches the pyramid of x (n, h, w, c) into out (levels 1..L-1 back to
// back) on `stream`, in tiles `seg` pixels wide; returns the cudaError_t of
// the launch (0 = success).  Allocates nothing and does not synchronise.
int haar_pyramid_launch(const void* x, void* out, int n, int h, int w, int c,
                        int n_levels, int dtype, int seg, void* stream) {
  HaarPlan p;
  const int e = make_plan(n, h, w, c, n_levels, dtype, seg, p);
  if (e) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_typed<float>(x, out, p, s);
  return launch_typed<__nv_bfloat16>(x, out, p, s);
}

// An empty kernel on the grid and block size that haar_pyramid_launch
// gives the same arguments: the device's floor for one launch of it, which
// chip_smoke.py measures beside the pyramid.
int haar_empty_launch(int n, int h, int w, int c, int n_levels, int dtype,
                      int seg, void* stream) {
  HaarPlan p;
  const int e = make_plan(n, h, w, c, n_levels, dtype, seg, p);
  if (e) return e;
  const dim3 grid(p.n_seg, p.h >> (p.n_levels - 1), p.n);
  empty_kernel<<<grid, p.threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
