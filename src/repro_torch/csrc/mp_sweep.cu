// mp_sweep: the whole banded stage-3 message-passing sweep in one launch, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mp_sweep/kernel.py:mp_sweep_pallas.
// For member e and graph b, every level (d, [s, stop), slot ranges, p) of the
// table in order, on the state h that the previous level left:
//   msg[v]   = sum_{u < p} a_flow[b, u, v] * h[e, b, u]            v in [s, stop)
//   upd[v]   = relu([h[v], msg[v]] @ W1[e, t(v)] + b1[e, t(v)]) @ W2[e, t(v)] + b2[e, t(v)]
//   h[v]     = upd[v]  if depth[b, v] == d and mask[b, v] > 0, else unchanged
// Every message of a level reads the state from before that level's writes
// (the Pallas kernel computed msg from its carried value before the where).
//
// The level table is a by-value struct (SweepLevels), not compile-time
// constants as in Pallas: one build serves every banding.  The member axis E
// is explicit (one launch for every ensemble member) and a_flow / depth / mask
// take a batch stride, 0 when one skeleton is shared by the batch.
//
// What bounds it on this card: at the main path's shapes (15 members x 4096
// graphs, 11 trimmed rows, 6 levels) the fp32 arithmetic of the selected rows
// (2H*H1 + H1*H FMAs each) against the bytes of one read and one write of the
// state.  Plain fp32 FMA (no TF32, no tensor cores), so it matches the plain
// PyTorch version to 1e-5.
//
// Design: one block owns one member and a run of graphs, and keeps their
// whole state, and their a_flow, in shared memory from the first level to the
// last: h is read from device memory once and written once.  Per level it
// flags the selected rows; then, per slot range with a selected row, it stages
// that type's W1 and W2 in shared memory (the 5-type bank would not fit) and
// runs the 2-layer MLP on those rows in 64-row tiles, as mp_update.cu does.
// The weights are copied asynchronously (cp.async), so the copy runs while
// the block gathers the first tile's messages.  The updated rows
// go to their place in `out` (device memory, this block's own rows), not to
// the shared state, so every message of the level reads the state from before
// the level; after a barrier the level's updated rows are copied from `out`
// into the shared state.  The final state then overwrites all of the block's
// rows of `out`.  __syncthreads orders the block's global writes before its
// reads, so no other block and no atomic is involved, and the result does not
// depend on scheduling.
#include <cuda_runtime.h>

#include "mlp_tile.cuh"

namespace repro_torch {

constexpr int kMaxLevels = 8;  // MAX_DEPTH: at most one level per depth

struct SweepLevel {
  int depth;                  // the level d being updated
  int span_start, span_stop;  // rows eligible at this level
  int parent_rows;            // a_flow[u, v] == 0 for u >= parent_rows, v in the span
  SlotRanges ranges;          // tile [span_start, span_stop)
};

// The banding table, by value (about 1.3 KB of kernel parameters).
struct SweepLevels {
  int n;
  SweepLevel level[kMaxLevels];
};

// dst[i] = src[i] for i < n, issued as asynchronous 16-byte copies where both
// sides allow it (plain loads otherwise); cp_async_wait() waits for them.
__device__ inline void copy_block_async(float* dst, const float* src, long long n) {
  if (((reinterpret_cast<size_t>(dst) | reinterpret_cast<size_t>(src)) & 15) != 0 || n % 4 != 0) {
    copy_block(dst, src, n);
    return;
  }
  for (long long i = threadIdx.x; i < n / 4; i += blockDim.x) {
    const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst + 4 * i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(src + 4 * i));
  }
}

__device__ inline void cp_async_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

template <int CPT>
__global__ void __launch_bounds__(kThreads) mp_sweep_kernel(
    const float* __restrict__ h, float* out, const float* __restrict__ a_flow,
    long long a_batch_stride, const int* __restrict__ depth, long long depth_batch_stride,
    const float* __restrict__ mask, long long mask_batch_stride, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2, const float* __restrict__ b2,
    int B, int N, int H, int H1, int T, SweepLevels levels, int graphs_per_block) {
  extern __shared__ float smem[];
  const int e = blockIdx.y;
  const int g0 = blockIdx.x * graphs_per_block;
  const int g1 = min(B, g0 + graphs_per_block);
  const int K = 2 * H;
  const int n_rows = (g1 - g0) * N;  // the block's rows, graph-major

  float* w1s = smem;
  float* b1s = w1s + K * H1;
  float* w2s = b1s + H1;
  float* b2s = w2s + H1 * H;
  float* zs = b2s + H;
  const int zs_stride = tile_stride(K);
  float* hs = zs + kTileRows * zs_stride;
  const int hs_stride = tile_stride(H1);
  float* state = hs + kTileRows * hs_stride;  // n_rows x H, carried across levels
  float* a_s = state + (long long)n_rows * H;  // the block's a_flow: one graph when shared
  const int a_graphs = a_batch_stride == 0 ? 1 : g1 - g0;
  int* list = reinterpret_cast<int*>(a_s + (long long)a_graphs * N * N);
  unsigned char* chosen = reinterpret_cast<unsigned char*>(list + n_rows);
  __shared__ int n_selected;
  __shared__ int row_of[kTileRows];  // block row of each tile row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const long long first = ((long long)e * B + g0) * N * H;  // the block's first element
  const float* hb = h + first;
  float* ob = out + first;

  copy_block_async(state, hb, (long long)n_rows * H);
  for (int gl = 0; gl < a_graphs; ++gl)
    copy_block(a_s + gl * N * N, a_flow + (g0 + gl) * a_batch_stride, N * N);
  cp_async_wait();

  for (int l = 0; l < levels.n; ++l) {
    const int d = levels.level[l].depth;
    const int s = levels.level[l].span_start;
    const int stop = levels.level[l].span_stop;
    const int p = levels.level[l].parent_rows;
    __syncthreads();  // the state load, or the previous level's write-back, is done
    // 1. which of the block's rows take this level's update
    for (int row = threadIdx.x; row < n_rows; row += blockDim.x) {
      const int g = g0 + row / N, v = row % N;
      chosen[row] = v >= s && v < stop && depth[g * depth_batch_stride + v] == d &&
                    mask[g * mask_batch_stride + v] > 0.f;
    }
    // 2. per slot range: list its selected rows; if any, stage its type's
    //    weights and run the MLP on them, results to `out`
    for (int r = 0; r < levels.level[l].ranges.n; ++r) {
      const int t = levels.level[l].ranges.type[r];
      const int start = levels.level[l].ranges.start[r];
      const int L = levels.level[l].ranges.stop[r] - start;
      __syncthreads();  // the flags are set; the previous range is done with the list
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
      copy_block_async(w1s, w1 + et * K * H1, (long long)K * H1);
      copy_block_async(b1s, b1 + et * H1, H1);
      copy_block_async(w2s, w2 + et * H1 * H, (long long)H1 * H);
      copy_block_async(b2s, b2 + et * H, H);
      for (int tile0 = 0; tile0 < count; tile0 += kTileRows) {
        const int rows = min(kTileRows, count - tile0);
        // z = [h[v], msg[v]] from the state before this level: one warp per
        // row, lanes over the columns
        for (int rr = warp; rr < rows; rr += kThreads / 32) {
          const int item = list[tile0 + rr];
          const int gl = item / N, v = item % N;
          if (lane == 0) row_of[rr] = item;
          const float* sg = state + (long long)gl * N * H;
          const float* ag = a_s + (a_batch_stride == 0 ? 0 : gl * N * N);
          for (int c = lane; c < H; c += 32) {
            float msg = 0.f;
            for (int u = 0; u < p; ++u) msg = fmaf(ag[u * N + v], sg[u * H + c], msg);
            zs[rr * zs_stride + c] = sg[v * H + c];
            zs[rr * zs_stride + H + c] = msg;
          }
        }
        if (tile0 == 0) cp_async_wait();  // this thread's share of the weights has landed
        __syncthreads();
        dense_tile<CPT, true>(zs, zs_stride, K, w1s, b1s, H1, rows,
                              [&](int rr, int c, float val) { hs[rr * hs_stride + c] = val; });
        __syncthreads();
        dense_tile<CPT, false>(hs, hs_stride, H1, w2s, b2s, H, rows,
                               [&](int rr, int c, float val) { ob[(long long)row_of[rr] * H + c] = val; });
        __syncthreads();  // row_of, zs and hs are rewritten by the next tile
      }
    }
    // 3. every message of the level is computed: the updated rows join the state
    __syncthreads();
    for (int i = threadIdx.x; i < n_rows * H; i += blockDim.x)
      if (chosen[i / H]) state[i] = ob[i];
  }
  __syncthreads();
  copy_block(ob, state, (long long)n_rows * H);
}

// Shared memory of one block: staged weights of one type, the two 64-row
// tiles, the state and a_flow of `gpb` graphs (one a_flow when shared), their
// selected-row list and flags.
static size_t sweep_smem(int N, int H, int H1, long long gpb, bool shared_graph) {
  return sizeof(float) * (weight_floats(2 * H, H1, H) +
                          (long long)kTileRows * (tile_stride(2 * H) + tile_stride(H1)) +
                          gpb * N * H + (shared_graph ? 1 : gpb) * N * N) +
         (sizeof(int) + sizeof(unsigned char)) * gpb * N;
}

template <int CPT>
static cudaError_t launch(const float* h, float* out, const float* a_flow, long long a_bs,
                          const int* depth, long long d_bs, const float* mask, long long m_bs,
                          const float* w1, const float* b1, const float* w2, const float* b2,
                          int E, int B, int N, int H, int H1, int T, const SweepLevels& levels,
                          int graphs_per_block, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(mp_sweep_kernel<CPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((B + graphs_per_block - 1) / graphs_per_block, E);
  mp_sweep_kernel<CPT><<<grid, kThreads, smem, stream>>>(h, out, a_flow, a_bs, depth, d_bs, mask,
                                                        m_bs, w1, b1, w2, b2, B, N, H, H1, T,
                                                        levels, graphs_per_block);
  return cudaGetLastError();
}

}  // namespace repro_torch

using namespace repro_torch;

// h, out: (E, B, N, H) contiguous fp32, distinct buffers.  a_flow: B graphs
// of (N, N) fp32 at batch stride a_batch_stride (0: one shared graph); depth
// int32 and mask fp32: B rows of N at their batch strides.  w1 (E, T, 2H, H1),
// b1 (E, T, H1), w2 (E, T, H1, H), b2 (E, T, H): contiguous fp32.  Each
// level's ranges tile its span.  Launches on `stream` of CUDA device
// `device`; returns the cudaError_t of the launch (0 on success), and
// cudaErrorInvalidValue for a table or shape the kernel does not take.
extern "C" int mp_sweep_launch(const float* h, float* out, const float* a_flow,
                               long long a_batch_stride, const int* depth,
                               long long depth_batch_stride, const float* mask,
                               long long mask_batch_stride, const float* w1, const float* b1,
                               const float* w2, const float* b2, int E, int B, int N, int H,
                               int H1, int T, SweepLevels levels, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (levels.n < 1 || levels.n > kMaxLevels || E < 1 || B < 1 || N < 1 || H < 1 || T < 1 ||
      H > 16 * kMaxColsPerThread || H1 > 16 * kMaxColsPerThread)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < levels.n; ++l) {
    const SweepLevel& lv = levels.level[l];
    if (lv.span_start < 0 || lv.span_stop > N || lv.span_start >= lv.span_stop ||
        lv.parent_rows < 1 || lv.parent_rows > N || lv.ranges.n < 1 || lv.ranges.n > kMaxRanges)
      return (int)cudaErrorInvalidValue;
    int edge = lv.span_start;
    for (int r = 0; r < lv.ranges.n; ++r) {
      if (lv.ranges.start[r] != edge || lv.ranges.stop[r] <= edge || lv.ranges.type[r] < 0 ||
          lv.ranges.type[r] >= T)
        return (int)cudaErrorInvalidValue;
      edge = lv.ranges.stop[r];
    }
    if (edge != lv.span_stop) return (int)cudaErrorInvalidValue;
  }

  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (sms < 1) sms = 1;
  int smem_max = 0;
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  // Graphs per block: enough blocks to fill the card about twice over, at
  // most 32 graphs (their state and a_flow are about 115 KB at N = 12,
  // H = 64), fewer when the block would not fit.  Dynamic shared memory plus the kernel's
  // static counter and row table must fit.
  const size_t smem_static = sizeof(int) * (1 + kTileRows);
  long long gpb = ((long long)B * E + 2LL * sms - 1) / (2LL * sms);
  gpb = gpb < 1 ? 1 : (gpb > 32 ? 32 : gpb);
  const bool shared_graph = a_batch_stride == 0;
  while (gpb > 1 && sweep_smem(N, H, H1, gpb, shared_graph) + smem_static > (size_t)smem_max) --gpb;
  const size_t smem = sweep_smem(N, H, H1, gpb, shared_graph);
  if (smem + smem_static > (size_t)smem_max) return (int)cudaErrorInvalidValue;

  cudaStream_t s = (cudaStream_t)stream;
  switch (cols_per_thread(H > H1 ? H : H1)) {
    case 1:
      return (int)launch<1>(h, out, a_flow, a_batch_stride, depth, depth_batch_stride, mask,
                            mask_batch_stride, w1, b1, w2, b2, E, B, N, H, H1, T, levels,
                            (int)gpb, smem, s);
    case 2:
      return (int)launch<2>(h, out, a_flow, a_batch_stride, depth, depth_batch_stride, mask,
                            mask_batch_stride, w1, b1, w2, b2, E, B, N, H, H1, T, levels,
                            (int)gpb, smem, s);
    case 4:
      return (int)launch<4>(h, out, a_flow, a_batch_stride, depth, depth_batch_stride, mask,
                            mask_batch_stride, w1, b1, w2, b2, E, B, N, H, H1, T, levels,
                            (int)gpb, smem, s);
    default:
      return (int)launch<8>(h, out, a_flow, a_batch_stride, depth, depth_batch_stride, mask,
                            mask_batch_stride, w1, b1, w2, b2, E, B, N, H, H1, T, levels,
                            (int)gpb, smem, s);
  }
}
