// mp_update: one fused stage-3 message-passing depth step for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mp_update/kernel.py:mp_update_pallas.
// For member e, graph b and row v of the span [s, stop):
//   msg      = sum_{u < p} a_flow[b, u, v] * h[e, b, u]
//   upd      = relu([h[e, b, v], msg] @ W1[e, t(v)] + b1[e, t(v)]) @ W2[e, t(v)] + b2[e, t(v)]
//   out[e, b, v] = upd            if depth[b, v] == d and mask[b, v] > 0
//                  h[e, b, v]     otherwise (and for every row outside the span)
//
// The member axis E is explicit (one launch for every ensemble member), and
// the graph fields a_flow / depth / mask take a batch stride, 0 when one
// skeleton is shared by every candidate of the placed path.  slot_ranges, the
// span, p and d are runtime arguments, not compile-time constants: one build
// serves every query structure and every depth of the scan.  The output is a
// fresh tensor: the aggregation reads rows of h that the update replaces.
//
// What bounds it on this card: at the main path's shapes, arithmetic for the
// rows it updates (2H*H1 + H1*H2 FMAs per selected row) and, in the scan plan
// where only the rows at depth d are selected, the pass-through copy of h
// (bytes).  This version runs plain fp32 FMA (no TF32, no tensor cores) so it
// matches the plain PyTorch version to 1e-5.
//
// Design: one block owns one member and a run of graphs.  It flags the rows
// that take the update and copies the others 16 bytes a thread; then, one
// slot range at a time, it compacts the range's selected (graph, row) pairs
// into a list and, when there are any, stages that type's W1 and W2 in shared
// memory (the 5-type bank, 245 KB at H = 64, would not fit) and runs the
// 2-layer MLP only on those rows in 64-row tiles.  The Pallas kernel
// computed every span row and selected afterwards; skipping unselected rows
// gives the same output, since each row's result depends only on its own
// inputs.  Row order in the list does not change any value.
#include <cuda_runtime.h>

#include "mlp_tile.cuh"

namespace repro_torch {

struct StepArgs {
  SlotRanges ranges;
  int span_start, span_stop;  // rows eligible for this depth step
  int parent_rows;            // a_flow[u, v] == 0 for u >= parent_rows, v in the span
  int depth;                  // the level d being updated
};

template <int CPT>
__global__ void __launch_bounds__(kThreads) mp_update_kernel(
    const float* __restrict__ h, float* __restrict__ out, const float* __restrict__ a_flow,
    long long a_batch_stride, const int* __restrict__ depth, long long depth_batch_stride,
    const float* __restrict__ mask, long long mask_batch_stride, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2, const float* __restrict__ b2,
    int B, int N, int H, int H1, int T, StepArgs args, int graphs_per_block) {
  extern __shared__ float smem[];
  const int e = blockIdx.y;
  const int g0 = blockIdx.x * graphs_per_block;
  const int g1 = min(B, g0 + graphs_per_block);
  const int K = 2 * H;

  float* w1s = smem;
  float* b1s = w1s + K * H1;
  float* w2s = b1s + H1;
  float* b2s = w2s + H1 * H;
  float* zs = b2s + H;
  const int zs_stride = tile_stride(K);
  float* hs = zs + kTileRows * zs_stride;
  const int hs_stride = tile_stride(H1);
  const int n_rows = (g1 - g0) * N;  // the block's rows, graph-major
  int* list = reinterpret_cast<int*>(hs + kTileRows * hs_stride);
  unsigned char* chosen = reinterpret_cast<unsigned char*>(list + n_rows);
  __shared__ int n_selected;
  __shared__ long long row_of[kTileRows];  // (graph * N + row) of each tile row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const float* he = h + (long long)e * B * N * H;
  float* oe = out + (long long)e * B * N * H;
  const long long first = (long long)g0 * N * H;  // the block's first element

  // 0. which of the block's rows take the update
  for (int row = threadIdx.x; row < n_rows; row += blockDim.x) {
    const int g = g0 + row / N, v = row % N;
    chosen[row] = v >= args.span_start && v < args.span_stop &&
                  depth[g * depth_batch_stride + v] == args.depth &&
                  mask[g * mask_batch_stride + v] > 0.f;
  }
  __syncthreads();

  // 1. the other rows keep h: everything outside the span, and unselected span rows
  if (H % 4 == 0 && ((reinterpret_cast<size_t>(he + first) | reinterpret_cast<size_t>(oe + first)) & 15) == 0) {
    const int H4 = H / 4;
    const float4* src = reinterpret_cast<const float4*>(he + first);
    float4* dst = reinterpret_cast<float4*>(oe + first);
    for (int i = threadIdx.x; i < n_rows * H4; i += blockDim.x)
      if (!chosen[i / H4]) dst[i] = src[i];
  } else {
    for (int i = threadIdx.x; i < n_rows * H; i += blockDim.x)
      if (!chosen[i / H]) oe[first + i] = he[first + i];
  }

  // 2. per slot range: list its selected rows; if any, stage its type's
  //    weights and run the MLP on them
  for (int r = 0; r < args.ranges.n; ++r) {
    const int t = args.ranges.type[r];
    const int start = args.ranges.start[r];
    const int L = args.ranges.stop[r] - start;
    __syncthreads();  // the previous range is done with the weights and the list
    if (threadIdx.x == 0) n_selected = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < (g1 - g0) * L; i += blockDim.x) {
      const int item = (i / L) * N + start + i % L;
      if (chosen[item]) list[atomicAdd(&n_selected, 1)] = item;
    }
    __syncthreads();
    const int count = n_selected;
    if (count == 0) continue;
    const long long et = (long long)e * T + t;
    copy_block(w1s, w1 + et * K * H1, K * H1);
    copy_block(b1s, b1 + et * H1, H1);
    copy_block(w2s, w2 + et * H1 * H, H1 * H);
    copy_block(b2s, b2 + et * H, H);
    __syncthreads();
    for (int tile0 = 0; tile0 < count; tile0 += kTileRows) {
      const int rows = min(kTileRows, count - tile0);
      // z = [h[v], msg[v]], one warp per row, lanes over the columns
      for (int rr = warp; rr < rows; rr += kThreads / 32) {
        const int item = list[tile0 + rr];
        const int g = g0 + item / N, v = item % N;
        if (lane == 0) row_of[rr] = (long long)g * N + v;
        const float* hg = he + (long long)g * N * H;
        const float* ag = a_flow + g * a_batch_stride;
        for (int c = lane; c < H; c += 32) {
          float msg = 0.f;
          for (int u = 0; u < args.parent_rows; ++u) msg = fmaf(ag[u * N + v], hg[u * H + c], msg);
          zs[rr * zs_stride + c] = hg[v * H + c];
          zs[rr * zs_stride + H + c] = msg;
        }
      }
      __syncthreads();
      dense_tile<CPT, true>(zs, zs_stride, K, w1s, b1s, H1, rows,
                            [&](int rr, int c, float v) { hs[rr * hs_stride + c] = v; });
      __syncthreads();
      dense_tile<CPT, false>(hs, hs_stride, H1, w2s, b2s, H, rows,
                             [&](int rr, int c, float v) { oe[row_of[rr] * H + c] = v; });
      __syncthreads();  // row_of, zs and hs are rewritten by the next tile
    }
  }
}

template <int CPT>
static cudaError_t launch(const float* h, float* out, const float* a_flow, long long a_bs,
                          const int* depth, long long d_bs, const float* mask, long long m_bs,
                          const float* w1, const float* b1, const float* w2, const float* b2,
                          int E, int B, int N, int H, int H1, int T, const StepArgs& args,
                          int graphs_per_block, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(mp_update_kernel<CPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((B + graphs_per_block - 1) / graphs_per_block, E);
  mp_update_kernel<CPT><<<grid, kThreads, smem, stream>>>(h, out, a_flow, a_bs, depth, d_bs, mask,
                                                         m_bs, w1, b1, w2, b2, B, N, H, H1, T,
                                                         args, graphs_per_block);
  return cudaGetLastError();
}

}  // namespace repro_torch

using namespace repro_torch;

// h, out: (E, B, N, H) contiguous fp32.  a_flow: B graphs of (N, N) fp32 at
// batch stride a_batch_stride (0: one shared graph); depth int32 and mask fp32:
// B rows of N at their batch strides.  w1 (E, T, 2H, H1), b1 (E, T, H1),
// w2 (E, T, H1, H), b2 (E, T, H): contiguous fp32.  The ranges tile
// [span_start, span_stop).  Launches on `stream` of CUDA device `device`;
// returns the cudaError_t of the launch (0 on success).
extern "C" int mp_update_launch(const float* h, float* out, const float* a_flow,
                                long long a_batch_stride, const int* depth,
                                long long depth_batch_stride, const float* mask,
                                long long mask_batch_stride, const float* w1, const float* b1,
                                const float* w2, const float* b2, int E, int B, int N, int H,
                                int H1, int T, SlotRanges ranges, int span_start, int span_stop,
                                int parent_rows, int d, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ranges.n < 1 || ranges.n > kMaxRanges || E < 1 || B < 1 || N < 1 || H < 1 ||
      H > 16 * kMaxColsPerThread || H1 > 16 * kMaxColsPerThread || span_start < 0 ||
      span_stop > N || span_start >= span_stop || parent_rows < 1 || parent_rows > N)
    return (int)cudaErrorInvalidValue;
  int edge = span_start;
  for (int r = 0; r < ranges.n; ++r) {
    if (ranges.start[r] != edge || ranges.stop[r] <= edge || ranges.type[r] < 0 ||
        ranges.type[r] >= T)
      return (int)cudaErrorInvalidValue;
    edge = ranges.stop[r];
  }
  if (edge != span_stop) return (int)cudaErrorInvalidValue;

  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (sms < 1) sms = 1;
  // Graphs per block: enough blocks to fill the card about twice over, at
  // most 64 graphs (the selected-row list then holds at most 64 * N entries).
  long long gpb = ((long long)B * E + 2LL * sms - 1) / (2LL * sms);
  gpb = gpb < 1 ? 1 : (gpb > 64 ? 64 : gpb);
  const size_t smem =
      sizeof(float) * (weight_floats(2 * H, H1, H) +
                       (long long)kTileRows * (tile_stride(2 * H) + tile_stride(H1))) +
      (sizeof(int) + sizeof(unsigned char)) * gpb * N;  // the selected-row list and flags
  int smem_max = 0;
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  // dynamic shared memory plus the kernel's static counter and row table must fit
  if (smem + sizeof(int) + sizeof(long long) * kTileRows > (size_t)smem_max)
    return (int)cudaErrorInvalidValue;

  StepArgs args;
  args.ranges = ranges;
  args.span_start = span_start;
  args.span_stop = span_stop;
  args.parent_rows = parent_rows;
  args.depth = d;
  cudaStream_t s = (cudaStream_t)stream;
  switch (cols_per_thread(H > H1 ? H : H1)) {
    case 1:
      return (int)launch<1>(h, out, a_flow, a_batch_stride, depth, depth_batch_stride, mask,
                            mask_batch_stride, w1, b1, w2, b2, E, B, N, H, H1, T, args, (int)gpb,
                            smem, s);
    case 2:
      return (int)launch<2>(h, out, a_flow, a_batch_stride, depth, depth_batch_stride, mask,
                            mask_batch_stride, w1, b1, w2, b2, E, B, N, H, H1, T, args, (int)gpb,
                            smem, s);
    case 4:
      return (int)launch<4>(h, out, a_flow, a_batch_stride, depth, depth_batch_stride, mask,
                            mask_batch_stride, w1, b1, w2, b2, E, B, N, H, H1, T, args, (int)gpb,
                            smem, s);
    default:
      return (int)launch<8>(h, out, a_flow, a_batch_stride, depth, depth_batch_stride, mask,
                            mask_batch_stride, w1, b1, w2, b2, E, B, N, H, H1, T, args, (int)gpb,
                            smem, s);
  }
}
