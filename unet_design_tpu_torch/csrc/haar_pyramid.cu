// Multi-level Haar LL pyramid for NHWC tensors, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel
// unet_design_tpu/ops/pallas/haar.py::haar_pyramid_fused (pl.pallas_call at
// haar.py:60, body _pyramid_kernel / _avg_matrix).  Given x (N, H, W, C) with
// H and W divisible by 2^(L-1), it writes levels 1..L-1 of the pyramid
// [x, down1, ..., down_{L-1}], each level the 2x2 mean of the one before.
// Sums are taken in fp32 and kept in fp32 from level to level (as the TPU
// kernel does); each level is cast to the input dtype only when stored.
//
// Bound.  The work is a 2x2 reduction with 3 adds and 1 multiply per output
// element, so it is bound by bytes, not operations.  At the main-path shape
// (8, 128, 128, 3) fp32 with L = 4 it reads 1.57 MB and writes 0.52 MB
// (levels 1-3: 64^2 + 32^2 + 16^2 pixels x 24 planes x 4 B), about 2.1 MB or
// 0.6 us at 3.35 TB/s.  A launch costs several microseconds, so launch
// latency, not bandwidth, decides the time at this size.
//
// Design.  The TPU kernel moved channels in front and wrote each octave as
// the matmuls A_h . x . A_w^T for the MXU.  On Hopper that is wasted: the
// reduction is memory bound, so this kernel keeps the NHWC layout and does
// no transpose.  One block takes one image, one channel chunk and one
// spatial tile whose sides are a multiple of 2^(L-1).  It loads the tile
// into shared memory with channels innermost (neighbouring threads read
// neighbouring addresses), then reduces level by level inside shared
// memory, ping-ponging between two buffers, and stores each level's
// sub-tile with the same coalesced order.  The input is read once and every
// output written once.  Because H and W are multiples of 2^(L-1), a tile
// that runs over the image edge does so by whole coarsest-level pixels, so
// the edge needs only a bounds check, never a partial 2x2 block.
//
// The four values of a 2x2 block are summed as ((a + b) + (c + d)) * 0.25,
// where (a, b) is the top row; haar_pyramid_reference in ops/haar.py uses
// the same order, so both agree bit for bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;

struct OutPtrs {
  void* p[kMaxLevels];
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

// grid: (tiles along W, tiles along H, N * channel chunks)
// smem: fp32 buffers of tile*tile*cb and (tile/2)*(tile/2)*cb floats
template <typename T>
__global__ void __launch_bounds__(kThreads)
haar_pyramid_kernel(const T* __restrict__ x, OutPtrs outs, int H, int W,
                    int C, int n_levels, int tile, int cb) {
  extern __shared__ float smem[];
  float* buf[2] = {smem, smem + tile * tile * cb};

  const int n_chunks = (C + cb - 1) / cb;
  const int n = blockIdx.z / n_chunks;
  const int c0 = (blockIdx.z % n_chunks) * cb;
  const int cw = min(cb, C - c0);  // channels in this chunk
  const int r0 = blockIdx.y * tile;
  const int w0 = blockIdx.x * tile;

  // level 0: load the tile, channels innermost
  {
    const int rows = min(tile, H - r0);
    const int cols = min(tile, W - w0);
    const int count = tile * tile * cw;
    float* dst = buf[0];
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      const int c = i % cw;
      const int col = (i / cw) % tile;
      const int row = i / (cw * tile);
      float v = 0.f;
      if (row < rows && col < cols) {
        const long long g =
            ((static_cast<long long>(n) * H + r0 + row) * W + w0 + col) *
                static_cast<long long>(C) + c0 + c;
        v = to_float(x[g]);
      }
      dst[i] = v;
    }
  }
  __syncthreads();

  int t = tile;     // side of the source sub-tile
  int h = H, w = W; // source level's image size
  for (int lvl = 1; lvl < n_levels; ++lvl) {
    const float* src = buf[(lvl - 1) & 1];
    float* dst = buf[lvl & 1];
    const int to = t >> 1;
    const int ho = h >> 1, wo = w >> 1;
    const int ro = r0 >> lvl, wof = w0 >> lvl;
    const int rows = min(to, ho - ro);
    const int cols = min(to, wo - wof);
    T* out = static_cast<T*>(outs.p[lvl - 1]);
    const int count = to * to * cw;
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      const int c = i % cw;
      const int col = (i / cw) % to;
      const int row = i / (cw * to);
      const int s = ((2 * row) * t + 2 * col) * cw + c;  // top-left of 2x2
      const float v = ((src[s] + src[s + cw]) +
                       (src[s + t * cw] + src[s + t * cw + cw])) * 0.25f;
      dst[i] = v;
      if (row < rows && col < cols) {
        const long long g =
            ((static_cast<long long>(n) * ho + ro + row) * wo + wof + col) *
                static_cast<long long>(C) + c0 + c;
        out[g] = from_float<T>(v);
      }
    }
    __syncthreads();
    t = to;
    h = ho;
    w = wo;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  outs holds n_levels - 1 device
// pointers (levels 1..L-1), each (N, H>>l, W>>l, C) contiguous.  Launches on
// `stream` and returns the cudaError_t of the launch (0 = success).
int haar_pyramid_launch(const void* x, void* const* outs, int N, int H, int W,
                        int C, int n_levels, int dtype, int tile, int cb,
                        void* stream) {
  if (n_levels < 2 || n_levels > kMaxLevels) return cudaErrorInvalidValue;
  if (tile % (1 << (n_levels - 1)) != 0) return cudaErrorInvalidValue;
  if (H % (1 << (n_levels - 1)) != 0 || W % (1 << (n_levels - 1)) != 0)
    return cudaErrorInvalidValue;
  OutPtrs ptrs = {};
  for (int l = 0; l < n_levels - 1; ++l) ptrs.p[l] = outs[l];
  const int n_chunks = (C + cb - 1) / cb;
  const dim3 grid((W + tile - 1) / tile, (H + tile - 1) / tile, N * n_chunks);
  const size_t smem =
      static_cast<size_t>(tile * tile + (tile / 2) * (tile / 2)) * cb *
      sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    haar_pyramid_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x), ptrs, H, W, C, n_levels, tile, cb);
  } else if (dtype == 1) {
    haar_pyramid_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), ptrs, H, W, C, n_levels, tile,
        cb);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
