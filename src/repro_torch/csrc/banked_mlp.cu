// banked_mlp: the fused slotted banked 2-layer MLP for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/banked_mlp/kernel.py:banked_mlp_slotted_pallas.
// For every member e and slot range (t, s, stop):
//   y[e, b, s:stop] = relu(x[e, b, s:stop] @ W1[e, t] + b1[e, t]) @ W2[e, t] + b2[e, t]
//
// The member axis E is explicit: one launch covers every ensemble member (the
// JAX package got that from jax.vmap over a pallas_call).  x may be shared by
// all members (member stride 0), as the placed path's stage-0 input is.
//
// What bounds it on this card: arithmetic.  Each row does F*H1 + H1*H2 FMAs
// (12,288 for the op_upd bank at H = 64) against F*4 bytes of input, far above
// the H100's fp32 ridge of 67e12 / 3.35e12 = 20 FLOP per byte.  This first
// version runs plain fp32 FMA on the CUDA cores (no TF32, no tensor cores), so
// it matches the plain PyTorch version to 1e-5.
//
// Design: one block owns one (member, slot range) pair and a run of 64-row
// tiles of that range's rows across the batch.  It stages that one type's W1
// and W2 (at most 32 KB + 16 KB at F = 128, H = 64) in shared memory once --
// the whole 5-type bank (245 KB) would not fit -- and reuses them for every
// tile it walks.  Rows are the range's (graph, slot) pairs in order, so a
// ragged tail (F = 39 or 4, a range of one slot, a batch of one) is masked
// rather than padded.  Each tile stays in shared memory between the two
// layers: x is read once from device memory and y written once.
#include <cuda_runtime.h>

#include "mlp_tile.cuh"

namespace repro_torch {

// Per-range block offsets: range r owns blocks [first_block[r], first_block[r + 1]).
struct BlockTable {
  SlotRanges ranges;
  int first_block[kMaxRanges + 1];
};

template <int CPT>
__global__ void __launch_bounds__(kThreads) banked_mlp_kernel(
    const float* __restrict__ x, long long x_member_stride, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2, const float* __restrict__ b2,
    float* __restrict__ y, int B, int N, int F, int H1, int H2, int T, BlockTable table,
    int rows_per_block) {
  extern __shared__ float smem[];
  const int e = blockIdx.y;
  int r = 0;
  while (r + 1 < table.ranges.n && (int)blockIdx.x >= table.first_block[r + 1]) ++r;
  const int t = table.ranges.type[r];
  const int start = table.ranges.start[r];
  const int L = table.ranges.stop[r] - start;  // rows of this range in one graph
  const long long total = (long long)B * L;
  const long long row0 = (long long)(blockIdx.x - table.first_block[r]) * rows_per_block;
  const long long row1 = min(total, row0 + rows_per_block);

  float* w1s = smem;
  float* b1s = w1s + F * H1;
  float* w2s = b1s + H1;
  float* b2s = w2s + H1 * H2;
  float* xs = b2s + H2;
  const int xs_stride = tile_stride(F);
  float* hs = xs + kTileRows * xs_stride;
  const int hs_stride = tile_stride(H1);

  const long long et = (long long)e * T + t;
  copy_block(w1s, w1 + et * F * H1, F * H1);
  copy_block(b1s, b1 + et * H1, H1);
  copy_block(w2s, w2 + et * H1 * H2, H1 * H2);
  copy_block(b2s, b2 + et * H2, H2);
  const float* xe = x + e * x_member_stride;
  float* ye = y + (long long)e * B * N * H2;
  __shared__ long long row_of[kTileRows];  // (graph * N + slot) of each tile row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (long long tile0 = row0; tile0 < row1; tile0 += kTileRows) {
    const int rows = (int)min((long long)kTileRows, row1 - tile0);
    // one warp per row: the row's address is worked out once, lanes copy its columns
    for (int rr = warp; rr < rows; rr += kThreads / 32) {
      const long long li = tile0 + rr;
      const long long g = li / L;
      const long long row = g * N + start + (li - g * L);
      if (lane == 0) row_of[rr] = row;
      const float* src = xe + row * F;
      for (int k = lane; k < F; k += 32) xs[rr * xs_stride + k] = src[k];
    }
    __syncthreads();
    dense_tile<CPT, true>(xs, xs_stride, F, w1s, b1s, H1, rows,
                          [&](int rr, int c, float v) { hs[rr * hs_stride + c] = v; });
    __syncthreads();
    dense_tile<CPT, false>(hs, hs_stride, H1, w2s, b2s, H2, rows,
                           [&](int rr, int c, float v) { ye[row_of[rr] * H2 + c] = v; });
    __syncthreads();  // row_of, xs and hs are rewritten by the next tile
  }
}

template <int CPT>
static cudaError_t launch(const float* x, long long x_member_stride, const float* w1,
                          const float* b1, const float* w2, const float* b2, float* y, int E,
                          int B, int N, int F, int H1, int H2, int T, const BlockTable& table,
                          int rows_per_block, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(banked_mlp_kernel<CPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(table.first_block[table.ranges.n], E);
  banked_mlp_kernel<CPT><<<grid, kThreads, smem, stream>>>(
      x, x_member_stride, w1, b1, w2, b2, y, B, N, F, H1, H2, T, table, rows_per_block);
  return cudaGetLastError();
}

}  // namespace repro_torch

using namespace repro_torch;

// x: (E, B, N, F) with rows of one member contiguous and member stride
// x_member_stride (0: shared by all members).  w1 (E, T, F, H1), b1 (E, T, H1),
// w2 (E, T, H1, H2), b2 (E, T, H2), y (E, B, N, H2): all contiguous fp32.
// Launches on `stream` of CUDA device `device`; returns the cudaError_t of the
// launch (0 on success).
extern "C" int banked_mlp_launch(const float* x, long long x_member_stride, const float* w1,
                                 const float* b1, const float* w2, const float* b2, float* y,
                                 int E, int B, int N, int F, int H1, int H2, int T,
                                 SlotRanges ranges, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ranges.n < 1 || ranges.n > kMaxRanges || E < 1 || B < 1 || F < 1 ||
      H1 > 16 * kMaxColsPerThread || H2 > 16 * kMaxColsPerThread)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (weight_floats(F, H1, H2) +
                                       (long long)kTileRows * (tile_stride(F) + tile_stride(H1)));
  int smem_max = 0;
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  // dynamic shared memory plus the kernel's static row table must fit
  if (smem + sizeof(long long) * kTileRows > (size_t)smem_max) return (int)cudaErrorInvalidValue;

  // Tiles per block: enough blocks to fill the card about twice over (two
  // blocks fit on one SM), at most 8 tiles so weights are staged per 512 rows.
  long long tiles = 0;
  for (int r = 0; r < ranges.n; ++r) {
    if (ranges.start[r] < 0 || ranges.stop[r] > N || ranges.start[r] >= ranges.stop[r] ||
        ranges.type[r] < 0 || ranges.type[r] >= T)
      return (int)cudaErrorInvalidValue;
    tiles += ((long long)B * (ranges.stop[r] - ranges.start[r]) + kTileRows - 1) / kTileRows;
  }
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (sms < 1) sms = 1;
  long long per_block = (tiles * E) / (2LL * sms);
  per_block = per_block < 1 ? 1 : (per_block > 8 ? 8 : per_block);
  const int rows_per_block = (int)per_block * kTileRows;

  BlockTable table;
  table.ranges = ranges;
  table.first_block[0] = 0;
  for (int r = 0; r < ranges.n; ++r) {
    const long long rows = (long long)B * (ranges.stop[r] - ranges.start[r]);
    table.first_block[r + 1] = table.first_block[r] + (int)((rows + rows_per_block - 1) / rows_per_block);
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (cols_per_thread(H1 > H2 ? H1 : H2)) {
    case 1:
      return (int)launch<1>(x, x_member_stride, w1, b1, w2, b2, y, E, B, N, F, H1, H2, T, table,
                            rows_per_block, smem, s);
    case 2:
      return (int)launch<2>(x, x_member_stride, w1, b1, w2, b2, y, E, B, N, F, H1, H2, T, table,
                            rows_per_block, smem, s);
    case 4:
      return (int)launch<4>(x, x_member_stride, w1, b1, w2, b2, y, E, B, N, F, H1, H2, T, table,
                            rows_per_block, smem, s);
    default:
      return (int)launch<8>(x, x_member_stride, w1, b1, w2, b2, y, E, B, N, F, H1, H2, T, table,
                            rows_per_block, smem, s);
  }
}
