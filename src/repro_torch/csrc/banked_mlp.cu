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
// What bounds it on this card: on the CUDA cores, arithmetic (F*H1 + H1*H2
// FMAs per row against F*4 bytes in: 24,576 FLOP per 512 bytes for op_upd at
// H = 64).  On the tensor cores in 3xTF32 (mma_tile.cuh; three TF32 products
// per fp32 product, up to 495 / 3 = 165 TFLOP/s), bytes: op_upd moves 570 MB
// (0.170 ms at 3.35 TB/s) for 18.1 GFLOP (0.110 ms).  This kernel reaches
// neither: with mma.sync, the three MMAs and the operand splits of every
// fragment are issued one warp instruction at a time, and that issue rate
// sets its time (PERF.md).
//
// Design: the work is a list of 64-row tiles, member-major, each tile inside
// one (member, slot range) pair; rows are the range's (graph, slot) pairs in
// order, so a ragged tail (F = 39 or 4, a range of one slot, a batch of one)
// is masked rather than padded in device memory.  The grid is one wave: as
// many blocks as fit on the card at once, each walking an equal run of the
// list, so the card stays full whatever the ranges' sizes (two blocks fit on
// an SM at op_upd: 49.6 KB of weights and two 32 KB tiles).  A block stages a
// pair's weights with cp.async when its run enters that pair (the whole
// 5-type bank, 245 KB at H = 64, would not fit), and keeps a ring of two input
// tiles: the cp.async loads of the next tile's rows (16 bytes where a row is
// 16-byte aligned, 4 bytes otherwise: F = 39 rows are 156 bytes) run while the
// tensor cores work on the current one.  The output goes back through shared
// memory and out in 16-byte row-contiguous writes.  Where one type's weights
// and two 64-row tiles pass a block's shared memory (F = 256 at H1 = H2 =
// 128: 197.6 KB of weights and 2 x 64 KB of tiles), the tiles take 16 rows
// instead (2 x 16 KB).
#include <cuda_runtime.h>

#include "mma_tile.cuh"

namespace repro_torch {

// Per-member tile offsets: range r owns tiles [first_tile[r], first_tile[r + 1]) of each member.
struct TileTable {
  SlotRanges ranges;
  int first_tile[kMaxRanges + 1];
};

struct BankArgs {
  const float* x;
  long long x_member_stride;
  const float *w1, *b1, *w2, *b2;
  float* y;
  int B, N, T;
  mma::Dims dims;  // k = F, n1 = H1, n2 = H2
};

// Where tile i of the list lies: member e, range r, its first row inside the
// range's B * L rows, and its number of rows.
struct TileAt {
  int e, r, row0, rows;
};

template <int kTileRows>
__device__ __forceinline__ TileAt locate(const TileTable& table, int B, int i) {
  const int per_member = table.first_tile[table.ranges.n];
  TileAt at;
  at.e = i / per_member;
  const int rem = i - at.e * per_member;
  at.r = 0;
  while (at.r + 1 < table.ranges.n && rem >= table.first_tile[at.r + 1]) ++at.r;
  at.row0 = (rem - table.first_tile[at.r]) * kTileRows;
  const int total = B * (table.ranges.stop[at.r] - table.ranges.start[at.r]);
  at.rows = min(kTileRows, total - at.row0);
  return at;
}

// Row (graph * N + slot) of the range's li-th row.
__device__ __forceinline__ long long slot_row(const TileTable& table, int r, int N, int li) {
  const int start = table.ranges.start[r], L = table.ranges.stop[r] - start;
  const int g = li / L;
  return (long long)g * N + start + (li - g * L);
}

// Issue the loads of tile `at` into buf (4 threads a row), and zero the
// padding columns F .. round8(F).
__device__ __forceinline__ void load_tile(float* buf, const BankArgs& a, const TileTable& table,
                                          const TileAt& at) {
  const int rr = threadIdx.x >> 2, sub = threadIdx.x & 3;
  if (rr >= at.rows) return;
  const int F = a.dims.k;
  const mma::Layout lx = mma::act_layout(F);
  const float* src = a.x + at.e * a.x_member_stride + slot_row(table, at.r, a.N, at.row0 + rr) * F;
  if (F % 4 == 0 && mma::aligned16(src)) {
    for (int c = 4 * sub; c < F; c += 16) mma::cp_async16(buf + mma::act_at(lx, rr, c), src + c);
  } else {
    for (int c = sub; c < F; c += 4) mma::cp_async4(buf + mma::act_at(lx, rr, c), src + c);
  }
  for (int c = F + sub; c < mma::round8(F); c += 4) buf[mma::act_at(lx, rr, c)] = 0.f;
}

template <int NTW, int kTileRows>
__global__ void __launch_bounds__(mma::kThreads, NTW >= 8 ? 1 : 2)
    banked_mlp_kernel(BankArgs a, TileTable table, int n_tiles, int tiles_per_block) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int begin = blockIdx.x * tiles_per_block;
  const int end = min(n_tiles, begin + tiles_per_block);
  if (begin >= end) return;
  const mma::Dims d = a.dims;
  float* weights = smem;
  float* const buf0 = weights + mma::weight_floats(d);  // the ring: buf0, buf0 + tile_floats
  const int ring = mma::tile_floats(d, kTileRows);
  const mma::Staged w = mma::staged_at(weights, d);
  const mma::Layout ly = mma::act_layout(d.n2);

  TileAt at = locate<kTileRows>(table, a.B, begin);
  load_tile(buf0, a, table, at);
  mma::cp_async_commit();
  long long staged = -1;  // member * T + type of the staged weights
  for (int i = begin; i < end; ++i) {
    float* buf = buf0 + ((i - begin) & 1) * ring;
    const long long key = (long long)at.e * a.T + table.ranges.type[at.r];
    if (key != staged) {  // the run enters another (member, type): stage its weights
      __syncthreads();
      mma::stage_weights(weights, d, key, a.w1, a.b1, a.w2, a.b2);
      staged = key;
    }
    mma::cp_async_wait<0>();  // tile i (and any weights) landed
    __syncthreads();          // ... for every thread; the other buffer is free
    TileAt next;
    if (i + 1 < end) {
      next = locate<kTileRows>(table, a.B, i + 1);
      load_tile(buf0 + ((i + 1 - begin) & 1) * ring, a, table, next);
      mma::cp_async_commit();
    }
    mma::mlp_tile<NTW, false, kTileRows>(buf, at.rows, d, w);
    const int rr = threadIdx.x >> 2;
    if (rr < at.rows) {
      float* dst = a.y + ((long long)at.e * a.B * a.N + slot_row(table, at.r, a.N, at.row0 + rr)) * d.n2;
      mma::store_row(dst, buf, ly, rr, d.n2, threadIdx.x & 3);
    }
    at = next;
  }
}

template <int NTW, int kTileRows>
static cudaError_t launch(const BankArgs& a, const TileTable& table, int E, size_t smem, int sms,
                          cudaStream_t stream) {
  const auto kernel = banked_mlp_kernel<NTW, kTileRows>;
  cudaError_t err = mma::allow_shared_memory(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;  // blocks an SM at this shared memory
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, mma::kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const long long n_tiles = (long long)E * table.first_tile[table.ranges.n];
  long long blocks = (long long)sms * per_sm;  // one wave
  if (blocks > n_tiles) blocks = n_tiles;
  const int per_block = (int)((n_tiles + blocks - 1) / blocks);
  blocks = (n_tiles + per_block - 1) / per_block;
  kernel<<<(unsigned)blocks, mma::kThreads, smem, stream>>>(a, table, (int)n_tiles, per_block);
  return cudaGetLastError();
}

template <int NTW>
static cudaError_t launch_plan(const BankArgs& a, const TileTable& table, int E, size_t smem, int sms, int tile_rows,
                               cudaStream_t stream) {
  return tile_rows == mma::kRows ? launch<NTW, mma::kRows>(a, table, E, smem, sms, stream)
                                 : launch<NTW, 16>(a, table, E, smem, sms, stream);
}

}  // namespace repro_torch

using namespace repro_torch;

// x: (E, B, N, F) with rows of one member contiguous and member stride
// x_member_stride (0: shared by all members).  w1 (E, T, F, H1), b1 (E, T, H1),
// w2 (E, T, H1, H2), b2 (E, T, H2), y (E, B, N, H2): all contiguous fp32, y
// 16-byte aligned.  H1 and H2 are multiples of 8 up to 128.  Launches on
// `stream` of CUDA device `device`; returns the cudaError_t of the launch (0 on
// success).
extern "C" int banked_mlp_launch(const float* x, long long x_member_stride, const float* w1,
                                 const float* b1, const float* w2, const float* b2, float* y,
                                 int E, int B, int N, int F, int H1, int H2, int T,
                                 SlotRanges ranges, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const mma::Dims dims{F, H1, H2};
  if (ranges.n < 1 || ranges.n > kMaxRanges || E < 1 || B < 1 || N < 1 || !mma::widths_ok(dims) ||
      (reinterpret_cast<size_t>(y) & 15) != 0 || (long long)E * B * N >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  // 64-row tiles where two of them fit beside the weights, else 16-row tiles
  const mma::DeviceInfo card = mma::device_info(device);
  auto bytes = [&](int rows) {
    return sizeof(float) * (mma::weight_floats(dims) + 2LL * mma::tile_floats(dims, rows));
  };
  const int tile_rows = bytes(mma::kRows) <= (size_t)card.smem_max ? mma::kRows : 16;
  const size_t smem = bytes(tile_rows);
  if (smem > (size_t)card.smem_max) return (int)cudaErrorInvalidValue;
  TileTable table;
  table.ranges = ranges;
  table.first_tile[0] = 0;
  for (int r = 0; r < ranges.n; ++r) {
    if (ranges.start[r] < 0 || ranges.stop[r] > N || ranges.start[r] >= ranges.stop[r] ||
        ranges.type[r] < 0 || ranges.type[r] >= T)
      return (int)cudaErrorInvalidValue;
    const long long rows = (long long)B * (ranges.stop[r] - ranges.start[r]);
    table.first_tile[r + 1] = table.first_tile[r] + (int)((rows + tile_rows - 1) / tile_rows);
  }
  if ((long long)E * table.first_tile[ranges.n] >= (1LL << 31)) return (int)cudaErrorInvalidValue;

  const BankArgs a{x, x_member_stride, w1, b1, w2, b2, y, B, N, T, dims};
  cudaStream_t s = (cudaStream_t)stream;
  switch (mma::n_tiles_per_warp(H1, H2)) {
    case 1:
      return (int)launch_plan<1>(a, table, E, smem, card.sms, tile_rows, s);
    case 2:
      return (int)launch_plan<2>(a, table, E, smem, card.sms, tile_rows, s);
    case 4:
      return (int)launch_plan<4>(a, table, E, smem, card.sms, tile_rows, s);
    default:
      return (int)launch_plan<8>(a, table, E, smem, card.sms, tile_rows, s);
  }
}
