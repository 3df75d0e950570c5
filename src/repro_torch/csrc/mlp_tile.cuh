// Shared pieces of the hand-written Hopper kernels (banked_mlp.cu, mp_update.cu).
//
// Both kernels end in the same fused 2-layer MLP over a tile of rows held in
// shared memory: y = relu(x @ W1 + b1) @ W2 + b2, with W1/W2 one node type's
// weights.  This header holds that tile product and the slot-range table the
// kernels take by value.  Plain fp32 FMA on the CUDA cores (no TF32, no tensor
// cores), accumulated in a fixed order, so every row's result is independent
// of which tile or block computed it.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kMaxRanges = 12;       // MAX_OPS: at most one slot range per row
constexpr int kThreads = 256;        // 16 column groups x 16 row groups
constexpr int kRowsPerThread = 4;
constexpr int kTileRows = 16 * kRowsPerThread;  // rows of one tile
constexpr int kMaxColsPerThread = 8;            // widths up to 16 * 8 = 128

// Slot ranges (type, start, stop), absolute rows; passed to kernels by value.
struct SlotRanges {
  int n;
  int type[kMaxRanges];
  int start[kMaxRanges];
  int stop[kMaxRanges];
};

// Row stride of a shared-memory tile with k columns: odd, so the two row
// groups a warp reads (4 rows apart) fall in different banks.
__host__ __device__ inline int tile_stride(int k) { return k | 1; }

// dst[i] = src[i] for i < n by the whole block, 16 bytes a thread where both
// sides are 16-byte aligned.
__device__ inline void copy_block(float* dst, const float* src, long long n) {
  if (((reinterpret_cast<size_t>(dst) | reinterpret_cast<size_t>(src)) & 15) == 0) {
    const long long n4 = n / 4;
    for (long long i = threadIdx.x; i < n4; i += blockDim.x)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
    for (long long i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  } else {
    for (long long i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

// out[r, c] = act(sum_k in[r, k] * w[k, c] + b[c]) for rows r < rows, c < width.
// in: kTileRows x k in shared memory (row stride in_stride); w: k x width and
// b: width, both in shared memory.  Thread (ty, tx) owns rows ty*4 .. ty*4+3 and
// columns tx + 16 j, j < CPT.  store(r, c, v) writes one result.
template <int CPT, bool kRelu, typename Store>
__device__ __forceinline__ void dense_tile(const float* in, int in_stride, int k,
                                           const float* w, const float* b, int width,
                                           int rows, Store store) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  if (ty * kRowsPerThread >= rows) return;  // a partial tile: no valid row here
  float acc[kRowsPerThread][CPT];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  const float* in_rows = in + ty * kRowsPerThread * in_stride;
  for (int kk = 0; kk < k; ++kk) {
    float a[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) a[i] = in_rows[i * in_stride + kk];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tx + 16 * j;
      const float wv = c < width ? w[kk * width + c] : 0.f;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) acc[i][j] = fmaf(a[i], wv, acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = ty * kRowsPerThread + i;
    if (r < rows) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + 16 * j;
        if (c < width) {
          float v = acc[i][j] + b[c];
          if (kRelu) v = fmaxf(v, 0.f);
          store(r, c, v);
        }
      }
    }
  }
}

// Columns per thread for a layer width: the next power of two of width / 16.
inline int cols_per_thread(int width) {
  int cpt = 1;
  while (16 * cpt < width) cpt *= 2;
  return cpt;
}

// Shared-memory floats of one type's staged weights: W1 (f x h1), b1, W2 (h1 x h2), b2.
__host__ __device__ inline long long weight_floats(int f, int h1, int h2) {
  return (long long)f * h1 + h1 + (long long)h1 * h2 + h2;
}

}  // namespace repro_torch
