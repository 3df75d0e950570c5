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
// fresh tensor, and every message reads h as it was before the step.
//
// What bounds it on this card: bytes.  The step copies h to out (377 MB in
// and out at the scan step, 15 x 4096 x 12 x 64), while the MLP runs only on
// the rows at depth d (about one row in 12 there), on the tensor cores in
// 3xTF32 (mma_tile.cuh).
//
// Design: one block owns one member and a run of G graphs, as many as its
// shared memory holds (G = 39 at H = 64: 49.6 KB of weights, a 33.8 KB z
// tile, 3.8 KB a graph).  It loads its graphs' depth and mask, then their h
// rows and a_flow, into shared memory with cp.async: h crosses the bus once
// in.  From depth and mask it lists each slot range's selected rows and
// starts the cp.async of the first selected range's weights, which lands
// while h does.  It writes the other rows to out from shared memory; then, per
// slot range with selected rows, it builds each row's z = [h_v, sum_u a[u, v]
// h_u] from shared memory into the tile, split into TF32 halves once, runs the
// tensor-core MLP on the tile, and writes the rows out.  The Pallas kernel
// computed every span row and selected afterwards; computing only the
// selected rows gives the same output, since each row's result depends only
// on its own inputs.  The order of rows in a list does not change any value.
// Where one type's weights and a split z tile of 32 rows pass a block's
// shared memory (H = H1 = 128: 197.6 KB and 66.6 KB), the z tile holds 16
// fp32 rows instead (16 KB), which the 8 warps split at each fragment load,
// as banked_mlp does.
#include <cuda_runtime.h>

#include "mma_tile.cuh"

namespace repro_torch {

struct StepArgs {
  SlotRanges ranges;
  int span_start, span_stop;  // rows eligible for this depth step
  int parent_rows;            // a_flow[u, v] == 0 for u >= parent_rows, v in the span
  int depth;                  // the level d being updated
};

struct StepTensors {
  const float* h;
  float* out;
  const float* a_flow;
  long long a_bs;
  const int* depth;
  long long d_bs;
  const float* mask;
  long long m_bs;
  const float *w1, *b1, *w2, *b2;
  int B, N, H, T;
  mma::Dims dims;  // k = 2H, n1 = H1, n2 = H
};

// Shared memory of one block, in floats from its start: weights, the tile,
// then G graphs' h rows, a_flow, depth, mask, the selected-row lists, a flag
// per row that keeps h, and the per-range counts.  A field read at batch
// stride 0 is held once.
struct StepSmem {
  long long tile, h, a, depth, mask, list, keep, count, total;
};

// Rows of one z tile.  The selected rows of a block's slot range are few (about
// one per graph at a scan step), and a tile of (hi, lo) pairs takes twice the
// shared memory of an fp32 one.  The fp32 tile, where the split one does not
// fit, holds 16 rows.
constexpr int kZRows = 32;
constexpr int kZRowsFp32 = 16;

// Floats of the z tile: split (hi, lo) pairs of kZRows rows, or kZRowsFp32 fp32 rows.
__host__ __device__ inline long long z_tile_floats(mma::Dims d, bool split) {
  return split ? mma::split_tile_floats(d, kZRows) : mma::tile_floats(d, kZRowsFp32);
}

__host__ __device__ inline StepSmem step_smem(mma::Dims d, bool split, int G, int N, int H, bool a_shared,
                                              bool d_shared, bool m_shared) {
  StepSmem s;
  s.tile = mma::weight_floats(d);
  s.h = s.tile + z_tile_floats(d, split);
  s.a = s.h + (long long)G * N * H;
  s.depth = s.a + mma::round4((a_shared ? 1LL : G) * N * N);
  s.mask = s.depth + mma::round4((d_shared ? 1LL : G) * N);
  s.list = s.mask + mma::round4((m_shared ? 1LL : G) * N);
  s.keep = s.list + mma::round4((long long)G * N);
  s.count = s.keep + mma::round4(((long long)G * N + 3) / 4);
  s.total = s.count + mma::round4(kMaxRanges);
  return s;
}

// The first slot range after r with selected rows (ranges.n if none).
__device__ __forceinline__ int next_selected(const SlotRanges& ranges, const int* count, int r) {
  ++r;
  while (r < ranges.n && count[r] == 0) ++r;
  return r;
}

template <int NTW, bool kSplit>
__global__ void __launch_bounds__(mma::kThreads, 1)
    mp_update_kernel(StepTensors a, StepArgs args, int G) {
  constexpr int kZ = kSplit ? kZRows : kZRowsFp32;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int e = blockIdx.y;
  const int g0 = blockIdx.x * G;
  const int ng = min(G, a.B - g0);
  const int N = a.N, H = a.H, tid = threadIdx.x;
  const StepSmem lay = step_smem(a.dims, kSplit, G, N, H, a.a_bs == 0, a.d_bs == 0, a.m_bs == 0);
  float* weights = smem;
  float* tile = smem + lay.tile;
  float* hs = smem + lay.h;
  float* as = smem + lay.a;
  int* ds = reinterpret_cast<int*>(smem + lay.depth);
  float* ms = smem + lay.mask;
  int* list = reinterpret_cast<int*>(smem + lay.list);  // selected rows (graph * N + v)
  unsigned char* keep = reinterpret_cast<unsigned char*>(smem + lay.keep);
  int* count = reinterpret_cast<int*>(smem + lay.count);
  const int n_rows = ng * N;
  const long long first = ((long long)e * a.B + g0) * N * H;  // the block's first element of h

  // 1. depth and mask, then h and a_flow, asynchronously
  mma::copy_rows(ds, a.depth, g0, a.d_bs ? ng : 1, N, a.d_bs);
  mma::copy_rows(reinterpret_cast<int*>(ms), reinterpret_cast<const int*>(a.mask), g0, a.m_bs ? ng : 1, N, a.m_bs);
  if (tid < kMaxRanges) count[tid] = 0;
  mma::cp_async_commit();
  mma::copy_async(hs, a.h + first, n_rows * H);
  if (a.a_bs == (long long)N * N)
    mma::copy_async(as, a.a_flow + g0 * a.a_bs, n_rows * N);
  else
    for (int gi = 0; gi < (a.a_bs ? ng : 1); ++gi)
      mma::copy_async(as + gi * N * N, a.a_flow + (g0 + gi) * a.a_bs, N * N);
  mma::cp_async_commit();

  // 2. which rows take the update: a list per slot range, range r's entries
  //    at [ng * (start_r - span_start), ...)
  mma::cp_async_wait<1>();
  __syncthreads();
  for (int row = tid; row < n_rows; row += blockDim.x) {
    const int gi = row / N, v = row - gi * N;
    const bool sel = v >= args.span_start && v < args.span_stop &&
               ds[(a.d_bs ? gi * N : 0) + v] == args.depth && ms[(a.m_bs ? gi * N : 0) + v] > 0.f;
    keep[row] = !sel;
    if (sel) {
      int r = 0;
      while (args.ranges.stop[r] <= v) ++r;
      list[ng * (args.ranges.start[r] - args.span_start) + atomicAdd(&count[r], 1)] = row;
    }
  }
  __syncthreads();
  const long long et = (long long)e * a.T;
  const mma::Dims d = a.dims;
  // the selected ranges in order; the first one's weights load while h lands
  const int r0 = next_selected(args.ranges, count, -1);
  if (r0 < args.ranges.n) {
    mma::stage_weights(weights, d, et + args.ranges.type[r0], a.w1, a.b1, a.w2, a.b2);
    mma::cp_async_wait<1>();
  } else {
    mma::cp_async_wait<0>();
  }
  __syncthreads();

  // 3. the rows that keep h, from shared memory: thread tid copies piece
  //    tid % per_row of rows tid / per_row + k * rows_per_pass
  {
    float* oe = a.out + first;
    const bool vec = H % 4 == 0 && mma::aligned16(oe);
    const int per_row = vec ? H / 4 : H, rows_per_pass = blockDim.x / per_row;
    const int r_off = tid / per_row, piece = tid - r_off * per_row;
    if (r_off < rows_per_pass)
      for (int row = r_off; row < n_rows; row += rows_per_pass) {
        if (!keep[row]) continue;
        const int i = row * per_row + piece;
        if (vec)
          reinterpret_cast<float4*>(oe)[i] = reinterpret_cast<const float4*>(hs)[i];
        else
          oe[i] = hs[i];
      }
  }

  // 4. per selected slot range: z tiles through the MLP
  const mma::Staged w = mma::staged_at(weights, d);
  const mma::Layout lz = kSplit ? mma::split_layout(d.k) : mma::act_layout(d.k), ly = mma::act_layout(d.n2);
  long long staged = r0 < args.ranges.n ? et + args.ranges.type[r0] : -1;
  for (int r = r0; r < args.ranges.n; r = next_selected(args.ranges, count, r)) {
    const int n_sel = count[r];
    const int* seg = list + ng * (args.ranges.start[r] - args.span_start);
    const long long key = et + args.ranges.type[r];
    if (key != staged) {  // the previous range's last tile is done with the weights
      mma::stage_weights(weights, d, key, a.w1, a.b1, a.w2, a.b2);
      staged = key;
    }
    for (int tile0 = 0; tile0 < n_sel; tile0 += kZ) {
      const int rows = min(kZ, n_sel - tile0);
      // z = [h_v, msg_v] as (hi, lo) pairs, split once here for all 8 warps
      // (or as fp32 in the fp32 tile); thread tid builds column tid % H of
      // rows tid / H + k * rows_per_pass
      const int rows_per_pass = blockDim.x / H, r_off = tid / H, c = tid - r_off * H;
      if (r_off < rows_per_pass)
        for (int rr = r_off; rr < rows; rr += rows_per_pass) {
          const int row = seg[tile0 + rr], gi = row / N, v = row - gi * N;
          const float* hg = hs + gi * N * H + c;
          const float* ag = as + (a.a_bs ? gi * N * N : 0) + v;
          // four partial sums, so the loads are not one dependent chain
          float m0 = 0.f, m1 = 0.f, m2 = 0.f, m3 = 0.f;
          int u = 0;
          for (; u + 4 <= args.parent_rows; u += 4) {
            m0 = fmaf(ag[u * N], hg[u * H], m0);
            m1 = fmaf(ag[(u + 1) * N], hg[(u + 1) * H], m1);
            m2 = fmaf(ag[(u + 2) * N], hg[(u + 2) * H], m2);
            m3 = fmaf(ag[(u + 3) * N], hg[(u + 3) * H], m3);
          }
          for (; u < args.parent_rows; ++u) m0 = fmaf(ag[u * N], hg[u * H], m0);
          const float msg = (m0 + m1) + (m2 + m3);
          if constexpr (kSplit) {
            uint32_t hi, lo;
            float2* zr = reinterpret_cast<float2*>(tile) + rr * lz.stride;
            mma::split(hg[v * H], hi, lo);
            zr[c] = make_float2(__uint_as_float(hi), __uint_as_float(lo));
            mma::split(msg, hi, lo);
            zr[H + c] = make_float2(__uint_as_float(hi), __uint_as_float(lo));
          } else {
            tile[mma::act_at(lz, rr, c)] = hg[v * H];
            tile[mma::act_at(lz, rr, H + c)] = msg;
          }
        }
      mma::cp_async_wait<0>();  // this thread's share of the weights
      __syncthreads();          // z and the weights, for every thread
      mma::mlp_tile<NTW, kSplit, kZ>(tile, rows, d, w);
      const int rr = tid >> 2;
      if (rr < rows) {
        const int row = seg[tile0 + rr], gi = row / N, v = row - gi * N;
        mma::store_row(a.out + first + ((long long)gi * N + v) * H, tile, ly, rr, H, tid & 3);
      }
      __syncthreads();  // the tile is rewritten by the next z
    }
  }
}

template <int NTW, bool kSplit>
static cudaError_t launch(const StepTensors& a, const StepArgs& args, int E, int G, size_t smem,
                          cudaStream_t stream) {
  const auto kernel = mp_update_kernel<NTW, kSplit>;
  const cudaError_t err = mma::allow_shared_memory(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.B + G - 1) / G, E);
  kernel<<<grid, mma::kThreads, smem, stream>>>(a, args, G);
  return cudaGetLastError();
}

template <int NTW>
static cudaError_t launch_plan(const StepTensors& a, const StepArgs& args, int E, int G, size_t smem, bool split,
                               cudaStream_t stream) {
  return split ? launch<NTW, true>(a, args, E, G, smem, stream) : launch<NTW, false>(a, args, E, G, smem, stream);
}

}  // namespace repro_torch

using namespace repro_torch;

// h, out: (E, B, N, H) contiguous fp32, out 16-byte aligned.  a_flow: B graphs
// of (N, N) fp32 at batch stride a_batch_stride (0: one shared graph); depth
// int32 and mask fp32: B rows of N at their batch strides.  w1 (E, T, 2H, H1),
// b1 (E, T, H1), w2 (E, T, H1, H), b2 (E, T, H): contiguous fp32.  H and H1 are
// multiples of 8 up to 128.  The ranges tile [span_start, span_stop).
// Launches on `stream` of CUDA device `device`; returns the cudaError_t of the
// launch (0 on success).
extern "C" int mp_update_launch(const float* h, float* out, const float* a_flow,
                                long long a_batch_stride, const int* depth,
                                long long depth_batch_stride, const float* mask,
                                long long mask_batch_stride, const float* w1, const float* b1,
                                const float* w2, const float* b2, int E, int B, int N, int H,
                                int H1, int T, SlotRanges ranges, int span_start, int span_stop,
                                int parent_rows, int d, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const mma::Dims dims{2 * H, H1, H};
  if (ranges.n < 1 || ranges.n > kMaxRanges || E < 1 || B < 1 || N < 1 || !mma::widths_ok(dims) ||
      span_start < 0 || span_stop > N || span_start >= span_stop || parent_rows < 1 ||
      parent_rows > N || (reinterpret_cast<size_t>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  int edge = span_start;
  for (int r = 0; r < ranges.n; ++r) {
    if (ranges.start[r] != edge || ranges.stop[r] <= edge || ranges.type[r] < 0 ||
        ranges.type[r] >= T)
      return (int)cudaErrorInvalidValue;
    edge = ranges.stop[r];
  }
  if (edge != span_stop) return (int)cudaErrorInvalidValue;

  const mma::DeviceInfo card = mma::device_info(device);
  const bool a0 = a_batch_stride == 0, d0 = depth_batch_stride == 0, m0 = mask_batch_stride == 0;
  // the split z tile where one graph fits beside it, else the fp32 tile
  const bool split = sizeof(float) * (size_t)step_smem(dims, true, 1, N, H, a0, d0, m0).total <= (size_t)card.smem_max;
  auto bytes = [&](int G) { return sizeof(float) * (size_t)step_smem(dims, split, G, N, H, a0, d0, m0).total; };
  // Graphs per block: the most that one block's shared memory holds (one block
  // an SM), and no more than fill the card once over.  Two blocks an SM leave
  // room for 8 graphs, whose slot ranges select about 3 rows each at a scan
  // step, so every weight stage and every 16-row MMA tile serves a handful of
  // rows, and the step ran slower that way.
  const long long fill = ((long long)B * E + card.sms - 1) / card.sms;
  int G = 1;
  while (G < fill && G < B && bytes(G + 1) <= (size_t)card.smem_max) ++G;
  const size_t smem = bytes(G);
  if (smem > (size_t)card.smem_max) return (int)cudaErrorInvalidValue;

  StepArgs args;
  args.ranges = ranges;
  args.span_start = span_start;
  args.span_stop = span_stop;
  args.parent_rows = parent_rows;
  args.depth = d;
  const StepTensors a{h, out, a_flow, a_batch_stride, depth, depth_batch_stride, mask,
                      mask_batch_stride, w1, b1, w2, b2, B, N, H, T, dims};
  cudaStream_t s = (cudaStream_t)stream;
  switch (mma::n_tiles_per_warp(H1, H)) {
    case 1:
      return (int)launch_plan<1>(a, args, E, G, smem, split, s);
    case 2:
      return (int)launch_plan<2>(a, args, E, G, smem, split, s);
    case 4:
      return (int)launch_plan<4>(a, args, E, G, smem, split, s);
    default:
      return (int)launch_plan<8>(a, args, E, G, smem, split, s);
  }
}
