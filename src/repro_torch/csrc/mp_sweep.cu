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
// What bounds it on this card: bytes, one read and one write of the state (346
// MB at estimate_many's shape, 15 members x 4096 graphs x 11 trimmed rows x
// 64), against 5.9 GFLOP of MLP on the selected rows, which run on the tensor
// cores in 3xTF32 (mma_tile.cuh) and so stay within 1e-5 of the plain fp32
// version.  What holds it back is the work of one block, whose phases run one
// after another (one block an SM): at that shape a clock64 split
// (kernels/mp_sweep/phases.py) puts about half of a block's time in the MLP,
// at mma.sync's TF32 rate with a stage's ten or so rows padded to the 16-row
// MMA tile (1.8 rows computed per row needed); a sixth in issuing the weight
// copies, which every SM draws from L2 at once (a member's five types, 49.7
// KB each at H = 64, do not fit in shared memory together, so a type is
// staged again at each level that selects rows of it); a ninth in building z
// rows.
//
// Design: one block owns one member and a run of G graphs, as many as its
// shared memory holds (G = 43 at H = 64: 49.7 KB of weights, a 33.8 KB z tile
// of 32 rows, 3.4 KB a graph).  It keeps their whole state and a_flow in
// shared memory from the first level to the last: h is read from device
// memory once and written once, the write as one bulk copy.  The selection
// does not depend on the state, so one pass after the load lists every
// level's selected rows, bucketed by (level, type): a stage.  The host orders
// each level's stages so that a level begins with the type the previous level
// ended with, and a stage whose type is already staged copies nothing.  Per
// stage the block stages that type's weights (cp.async, landing while the
// first z tile is built), builds each selected row's z = [h_v, sum_u a[u, v]
// h_u] from the shared state into the tile, split into TF32 halves once, runs
// the tensor-core MLP (mma::mlp_tile) and writes the rows back into the shared
// state.  That is safe when no selected row of a level is a parent of another
// selected row of the same level, which holds for every depth-banded graph; a
// level where it does not hold (the selection pass checks) writes its rows to
// `out` instead and copies them into the state after its last stage, so its
// messages still read the state from before the level.  Row results do not
// depend on the order of a list, so two launches give bitwise-equal answers.
// Where one type's weights and a split z tile of 32 rows pass a block's
// shared memory (H = H1 = 128: 197.6 KB and 66.6 KB), the z tile holds 16
// fp32 rows instead (16 KB), which the 8 warps split at each fragment load,
// as banked_mlp does; two graphs' state then fit beside it.
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "mma_tile.cuh"

namespace repro_torch {

constexpr int kMaxLevels = 8;                        // MAX_DEPTH: at most one level per depth
constexpr int kMaxStages = kMaxLevels * kMaxRanges;  // one stage per (level, type)
constexpr int kZRows = 32;                           // rows of one split z tile, as in mp_update.cu
constexpr int kZRowsFp32 = 16;                       // rows of one fp32 z tile

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

// The table as the kernel walks it (built on the host by make_plan).  Stage k
// holds the selected rows of one type at one level; its list starts at entry
// G * base[k] of the block's list and holds at most G * (rows of its ranges).
struct SweepPlan {
  int n_levels, list_rows;  // list entries per graph: the sum of the span lengths
  int depth[kMaxLevels], span_start[kMaxLevels], span_stop[kMaxLevels], parent_rows[kMaxLevels];
  int range_stop[kMaxLevels][kMaxRanges];
  int range_stage[kMaxLevels][kMaxRanges];  // the stage of each range's rows
  int first_stage[kMaxLevels + 1];          // level l's stages: [first_stage[l], first_stage[l + 1])
  int type[kMaxStages];
  int base[kMaxStages];
};

struct SweepTensors {
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

// Shared memory of one block, in floats from its start: weights, the z tile,
// then G graphs' state, a_flow, depth, mask, the stage lists (16-bit rows),
// the per-stage counts and the levels' conflict bits.  A field read at batch
// stride 0 is held once.
struct SweepSmem {
  long long tile, h, a, depth, mask, list, count, total;
};

__host__ __device__ inline SweepSmem sweep_smem(mma::Dims d, bool split, int G, int N, int H, int list_rows,
                                                bool a_shared, bool d_shared, bool m_shared) {
  SweepSmem s;
  s.tile = mma::weight_floats(d);
  s.h = s.tile + (split ? mma::split_tile_floats(d, kZRows) : mma::tile_floats(d, kZRowsFp32));
  s.a = s.h + (long long)G * N * H;
  s.depth = s.a + mma::round4((a_shared ? 1LL : G) * N * N);
  s.mask = s.depth + mma::round4((d_shared ? 1LL : G) * N);
  s.list = s.mask + mma::round4((m_shared ? 1LL : G) * N);
  s.count = s.list + mma::round4(((long long)G * list_rows + 1) / 2);
  s.total = s.count + mma::round4(kMaxStages + 1);
  return s;
}

// The (hi, lo) TF32 halves of x's four values as four pairs at dst[0 .. 1].
__device__ __forceinline__ void split4(float4 x, float4* dst) {
  uint32_t h0, l0, h1, l1, h2, l2, h3, l3;
  mma::split(x.x, h0, l0);
  mma::split(x.y, h1, l1);
  mma::split(x.z, h2, l2);
  mma::split(x.w, h3, l3);
  dst[0] = make_float4(__uint_as_float(h0), __uint_as_float(l0), __uint_as_float(h1), __uint_as_float(l1));
  dst[1] = make_float4(__uint_as_float(h2), __uint_as_float(l2), __uint_as_float(h3), __uint_as_float(l3));
}

template <int NTW, bool kSplit>
__global__ void __launch_bounds__(mma::kThreads, 1)
    mp_sweep_kernel(SweepTensors a, SweepPlan plan, int G) {
  constexpr int kZ = kSplit ? kZRows : kZRowsFp32;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int e = blockIdx.y;
  const int g0 = blockIdx.x * G;
  const int ng = min(G, a.B - g0);
  const int N = a.N, H = a.H, tid = threadIdx.x;
  const SweepSmem lay = sweep_smem(a.dims, kSplit, G, N, H, plan.list_rows, a.a_bs == 0, a.d_bs == 0, a.m_bs == 0);
  float* weights = smem;
  float* tile = smem + lay.tile;
  float* hs = smem + lay.h;
  const float* as = smem + lay.a;
  const int* ds = reinterpret_cast<const int*>(smem + lay.depth);
  const float* ms = smem + lay.mask;
  uint16_t* list = reinterpret_cast<uint16_t*>(smem + lay.list);  // selected rows (graph * N + v)
  int* count = reinterpret_cast<int*>(smem + lay.count);
  int& conflict = count[kMaxStages];  // bit l: a selected row of level l is a parent of another
  const int n_rows = ng * N;
  const long long first = ((long long)e * a.B + g0) * N * H;  // the block's first element of h
  float* ob = a.out + first;

  // 1. depth, mask, the state and a_flow, asynchronously
  mma::copy_rows(const_cast<int*>(ds), a.depth, g0, a.d_bs ? ng : 1, N, a.d_bs);
  mma::copy_rows(reinterpret_cast<int*>(const_cast<float*>(ms)), reinterpret_cast<const int*>(a.mask), g0,
                 a.m_bs ? ng : 1, N, a.m_bs);
  for (int k = tid; k < kMaxStages; k += blockDim.x) count[k] = 0;
  if (tid == 0) conflict = 0;
  mma::copy_async(hs, a.h + first, n_rows * H);
  if (a.a_bs == (long long)N * N)
    mma::copy_async(const_cast<float*>(as), a.a_flow + g0 * a.a_bs, n_rows * N);
  else
    for (int gi = 0; gi < (a.a_bs ? ng : 1); ++gi)
      mma::copy_async(const_cast<float*>(as) + gi * N * N, a.a_flow + (g0 + gi) * a.a_bs, N * N);

  // 2. every level's selected rows, listed by stage, and the levels where a
  //    selected row is a parent of another
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
  for (int row = tid; row < n_rows; row += blockDim.x) {
    const int gi = row / N, v = row - gi * N;
    const int* dg = ds + (a.d_bs ? gi * N : 0);
    const float* mg = ms + (a.m_bs ? gi * N : 0);
    const float* ag = as + (a.a_bs ? gi * N * N : 0) + v;
    if (!(mg[v] > 0.f)) continue;
    for (int l = 0; l < plan.n_levels; ++l) {
      const int d = plan.depth[l], s = plan.span_start[l], stop = plan.span_stop[l];
      if (dg[v] != d || v < s || v >= stop) continue;
      int r = 0;
      while (plan.range_stop[l][r] <= v) ++r;
      const int k = plan.range_stage[l][r];
      list[ng * plan.base[k] + atomicAdd(&count[k], 1)] = static_cast<uint16_t>(row);
      for (int u = s; u < min(plan.parent_rows[l], stop); ++u)
        if (ag[u * N] != 0.f && dg[u] == d && mg[u] > 0.f) atomicOr(&conflict, 1 << l);
    }
  }
  __syncthreads();

  // 3. the levels in order, each stage's rows through the MLP in z tiles
  const long long et = (long long)e * a.T;
  const mma::Dims dm = a.dims;
  long long staged = -1;
  const mma::Staged w = mma::staged_at(weights, dm);
  const mma::Layout lz = kSplit ? mma::split_layout(dm.k) : mma::act_layout(dm.k), ly = mma::act_layout(dm.n2);
  const int rows_per_pass = blockDim.x / (H / 4), r_off = tid / (H / 4), c = tid - r_off * (H / 4);
  for (int l = 0; l < plan.n_levels; ++l) {
    const bool direct = !((conflict >> l) & 1);
    const int p = plan.parent_rows[l];
    for (int k = plan.first_stage[l]; k < plan.first_stage[l + 1]; ++k) {
      const int n_sel = count[k];
      if (n_sel == 0) continue;
      const uint16_t* seg = list + ng * plan.base[k];
      const long long key = et + plan.type[k];
      if (key != staged) {  // the previous stage's last tile is done with the weights
        mma::stage_weights(weights, dm, key, a.w1, a.b1, a.w2, a.b2);
        staged = key;
      }
      for (int tile0 = 0; tile0 < n_sel; tile0 += kZ) {
        const int rows = min(kZ, n_sel - tile0);
        // z = [h_v, msg_v] as (hi, lo) pairs (or fp32 in the fp32 tile); thread tid builds columns
        // 4 c .. 4 c + 3 of rows r_off + j * rows_per_pass (16 rows a pass at
        // H = 64: a thread's rows run one after another)
        if (r_off < rows_per_pass)
          for (int rr = r_off; rr < rows; rr += rows_per_pass) {
            const int row = seg[tile0 + rr], gi = row / N, v = row - gi * N;
            const float4* hg = reinterpret_cast<const float4*>(hs + gi * N * H) + c;
            const float* ag = as + (a.a_bs ? gi * N * N : 0) + v;
            float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
            for (int u = 0; u < p; ++u) {
              const float w = ag[u * N];
              const float4 x = hg[u * (H / 4)];
              m = make_float4(fmaf(w, x.x, m.x), fmaf(w, x.y, m.y), fmaf(w, x.z, m.z), fmaf(w, x.w, m.w));
            }
            if constexpr (kSplit) {
              float4* zr = reinterpret_cast<float4*>(tile + 2 * rr * lz.stride);
              split4(hg[v * (H / 4)], zr + 2 * c);
              split4(m, zr + H / 2 + 2 * c);
            } else {
              *reinterpret_cast<float4*>(tile + mma::act_at(lz, rr, 4 * c)) = hg[v * (H / 4)];
              *reinterpret_cast<float4*>(tile + mma::act_at(lz, rr, H + 4 * c)) = m;
            }
          }
        mma::cp_async_wait<0>();  // this thread's share of the weights
        __syncthreads();          // z and the weights, for every thread
        mma::mlp_tile<NTW, kSplit, kZ>(tile, rows, dm, w);
        const int rr = tid >> 2;
        if (rr < rows) {
          const int row = seg[tile0 + rr];
          mma::store_row((direct ? hs : ob) + (long long)row * H, tile, ly, rr, H, tid & 3);
        }
        __syncthreads();  // the tile is rewritten by the next z
      }
    }
    if (!direct) {  // every message of the level is computed: its rows join the state
      for (int k = plan.first_stage[l]; k < plan.first_stage[l + 1]; ++k)
        for (int i = tid; i < count[k] * H; i += blockDim.x) {
          const int row = list[ng * plan.base[k] + i / H];
          hs[row * H + i % H] = ob[(long long)row * H + i % H];
        }
      __syncthreads();
    }
  }

  // 4. the state goes out in one asynchronous bulk copy; the block may end
  //    once the copy has read shared memory
  mma::fence_proxy_async();
  __syncthreads();
  if (tid == 0) mma::bulk_store(ob, hs, (unsigned)(n_rows * H * sizeof(float)));
}

template <int NTW, bool kSplit>
static cudaError_t launch(const SweepTensors& a, const SweepPlan& plan, int E, int G, size_t smem,
                          cudaStream_t stream) {
  const auto kernel = mp_sweep_kernel<NTW, kSplit>;
  const cudaError_t err = mma::allow_shared_memory(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.B + G - 1) / G, E);
  kernel<<<grid, mma::kThreads, smem, stream>>>(a, plan, G);
  return cudaGetLastError();
}

template <int NTW>
static cudaError_t launch_plan(const SweepTensors& a, const SweepPlan& plan, int E, int G, size_t smem, bool split,
                               cudaStream_t stream) {
  return split ? launch<NTW, true>(a, plan, E, G, smem, stream) : launch<NTW, false>(a, plan, E, G, smem, stream);
}

// The kernel's plan of a valid table, false for a table it does not take.
// Each level's stages are its distinct types; the first is the type the
// previous level's stages ended with, if the level has it, and the last one
// that the next level has, if any, so that the weights staged at a level's end
// serve the next level's first stage.
static bool make_plan(const SweepLevels& levels, int N, int T, SweepPlan& plan) {
  if (levels.n < 1 || levels.n > kMaxLevels) return false;
  plan.n_levels = levels.n;
  plan.list_rows = 0;
  int n_stages = 0, prev_last = -1;
  for (int l = 0; l < levels.n; ++l) {
    const SweepLevel& lv = levels.level[l];
    if (lv.span_start < 0 || lv.span_stop > N || lv.span_start >= lv.span_stop || lv.parent_rows < 1 ||
        lv.parent_rows > N || lv.ranges.n < 1 || lv.ranges.n > kMaxRanges)
      return false;
    int edge = lv.span_start;
    for (int r = 0; r < lv.ranges.n; ++r) {
      if (lv.ranges.start[r] != edge || lv.ranges.stop[r] <= edge || lv.ranges.type[r] < 0 || lv.ranges.type[r] >= T)
        return false;
      edge = lv.ranges.stop[r];
    }
    if (edge != lv.span_stop) return false;
    plan.depth[l] = lv.depth;
    plan.span_start[l] = lv.span_start;
    plan.span_stop[l] = lv.span_stop;
    plan.parent_rows[l] = lv.parent_rows;
    // the level's distinct types in order of appearance
    int types[kMaxRanges], n_types = 0;
    for (int r = 0; r < lv.ranges.n; ++r) {
      int j = 0;
      while (j < n_types && types[j] != lv.ranges.type[r]) ++j;
      if (j == n_types) types[n_types++] = lv.ranges.type[r];
    }
    for (int j = 1; j < n_types; ++j)
      if (types[j] == prev_last) std::swap(types[0], types[j]);
    for (int j = n_types - 1; j > 0 && l + 1 < levels.n; --j) {
      const SlotRanges& next = levels.level[l + 1].ranges;
      bool in_next = false;
      for (int r = 0; r < next.n; ++r) in_next |= next.type[r] == types[j];
      if (in_next) {
        std::swap(types[j], types[n_types - 1]);
        break;
      }
    }
    prev_last = types[n_types - 1];
    plan.first_stage[l] = n_stages;
    for (int j = 0; j < n_types; ++j) {
      const int k = n_stages + j;
      plan.type[k] = types[j];
      plan.base[k] = plan.list_rows;
      for (int r = 0; r < lv.ranges.n; ++r)
        if (lv.ranges.type[r] == types[j]) {
          plan.range_stage[l][r] = k;
          plan.list_rows += lv.ranges.stop[r] - lv.ranges.start[r];
        }
    }
    for (int r = 0; r < lv.ranges.n; ++r) plan.range_stop[l][r] = lv.ranges.stop[r];
    n_stages += n_types;
  }
  plan.first_stage[levels.n] = n_stages;
  return true;
}

}  // namespace repro_torch

using namespace repro_torch;

// h, out: (E, B, N, H) contiguous fp32, distinct buffers, out 16-byte aligned.
// a_flow: B graphs of (N, N) fp32 at batch stride a_batch_stride (0: one
// shared graph); depth int32 and mask fp32: B rows of N at their batch
// strides.  w1 (E, T, 2H, H1), b1 (E, T, H1), w2 (E, T, H1, H), b2 (E, T, H):
// contiguous fp32.  H and H1 are multiples of 8 up to 128.  Each level's
// ranges tile its span.  Launches on `stream` of CUDA device `device`; returns
// the cudaError_t of the launch (0 on success), and cudaErrorInvalidValue for
// a table or shape the kernel does not take.
extern "C" int mp_sweep_launch(const float* h, float* out, const float* a_flow, long long a_batch_stride,
                               const int* depth, long long depth_batch_stride, const float* mask,
                               long long mask_batch_stride, const float* w1, const float* b1, const float* w2,
                               const float* b2, int E, int B, int N, int H, int H1, int T, SweepLevels levels,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const mma::Dims dims{2 * H, H1, H};
  SweepPlan plan;
  if (E < 1 || B < 1 || N < 1 || T < 1 || !mma::widths_ok(dims) || (reinterpret_cast<size_t>(out) & 15) != 0 ||
      !make_plan(levels, N, T, plan))
    return (int)cudaErrorInvalidValue;

  const mma::DeviceInfo card = mma::device_info(device);
  const bool a0 = a_batch_stride == 0, d0 = depth_batch_stride == 0, m0 = mask_batch_stride == 0;
  // the split z tile where one graph fits beside it, else the fp32 tile
  auto bytes_of = [&](bool split, int G) {
    return sizeof(float) * (size_t)sweep_smem(dims, split, G, N, H, plan.list_rows, a0, d0, m0).total;
  };
  const bool split = bytes_of(true, 1) <= (size_t)card.smem_max;
  auto bytes = [&](int G) { return bytes_of(split, G); };
  // Graphs per block: the most that one block's shared memory holds (one block
  // an SM), and no more than fill the card once over; list rows fit 16 bits.
  const long long fill = ((long long)B * E + card.sms - 1) / card.sms;
  int G = 1;
  while (G < fill && G < B && (long long)(G + 1) * N <= 65536 && bytes(G + 1) <= (size_t)card.smem_max) ++G;
  const size_t smem = bytes(G);
  if (smem > (size_t)card.smem_max || (long long)G * N > 65536) return (int)cudaErrorInvalidValue;

  const SweepTensors a{h, out, a_flow, a_batch_stride, depth, depth_batch_stride, mask, mask_batch_stride,
                       w1, b1, w2, b2, B, N, H, T, dims};
  cudaStream_t s = (cudaStream_t)stream;
  switch (mma::n_tiles_per_warp(H1, H)) {
    case 1:
      return (int)launch_plan<1>(a, plan, E, G, smem, split, s);
    case 2:
      return (int)launch_plan<2>(a, plan, E, G, smem, split, s);
    case 4:
      return (int)launch_plan<4>(a, plan, E, G, smem, split, s);
    default:
      return (int)launch_plan<8>(a, plan, E, G, smem, split, s);
  }
}
