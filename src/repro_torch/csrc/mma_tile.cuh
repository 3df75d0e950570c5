// The tensor-core MLP tile of the hand-written Hopper kernels (banked_mlp.cu,
// mp_update.cu, mp_sweep.cu), and the slot-range table they take by value.
//
// One block of 8 warps computes the fused y = relu(x @ W1 + b1) @ W2 + b2 over
// a tile of up to 64 rows held in shared memory, with one node type's W1/W2
// staged in shared memory.  The products run on the tensor cores as warp-level
// mma.sync.m16n8k8 in TF32, and keep fp32 accuracy with the 3xTF32 split:
//
//   x = hi(x) + lo(x),  hi = rna(x),  lo = rna(x - hi)   (rna: cvt.rna.tf32.f32)
//   x * w ~= lo(x) hi(w) + hi(x) lo(w) + hi(x) hi(w)     (lo * lo dropped)
//
// The three products of one k-step (8 terms of the sum) are summed on the
// tensor cores from zero, the two small products before the large one, and
// that partial is added to the fp32 accumulator on the CUDA cores (round to
// nearest).  The split keeps about 22 bits of every product (TF32 alone keeps
// 11); the partial sums limit the tensor cores' own accumulation, which rounds
// less carefully than an fp32 add, to 8 terms at a time (accumulating all of K
// there missed 1e-5 at width 128 on the card).  So the tile stays within 1e-5
// of the fp32 plain version where TF32 alone would not.  The summation order
// is fixed by the code, so two launches on the same inputs are bitwise equal.
//
// rna runs on the integer units: cvt.rna.tf32.f32 compiles for sm_90a to a
// longer compare-and-select sequence, and was slower in both kernels; the two
// round alike, ties away from zero.
//
// Warps: a full tile runs as 4 row groups of 16 rows x 2 column groups; warp
// (mi, ni) owns rows 16 mi .. 16 mi + 15 and the n-tiles (8 columns each) j
// with j % 2 == ni, in both layers.  A tile of at most 32 or 16 rows runs as
// 2 x 4 or 1 x 8 warps instead, so a short tile still spreads over all 8
// warps.  The hidden activation goes back to shared memory between the layers
// (the accumulator layout is not the operand layout) and is written over the
// consumed input, as is the output, which the caller then stores row by row
// with 16-byte writes.
//
// Where the split happens: for the weights, at every fragment load.  Splitting
// them once at staging doubles their shared memory (99 KB per type at H = 64
// instead of 49.6 KB): banked_mlp then fits one block on an SM instead of two,
// and ran slower that way.  For the activations, at the fragment load too
// (banked_mlp, whose input lands by cp.async), or once when the tile is
// written (mp_update builds its z rows itself; the tile then holds (hi, lo)
// pairs, so its 8 warps do not each split the same elements).
//
// Shared-memory layouts, chosen so that every fragment load is free of bank
// conflicts and every row starts 16-byte aligned (cp.async writes 16 bytes):
// - an fp32 activation tile with k columns (k padded with zeros to a multiple
//   of 8): element (r, c) at r * k + (c ^ 4 (r & 7)) when k % 32 == 0, else
//   at r * (k + 4) + c (a stride of 4 mod 8 puts the 8 rows of a fragment in
//   8 bank groups);
// - a split tile: pair (r, c) at r * (k + 4) + c, in pairs;
// - a weight matrix with n columns: element (k, c) at k * n + (c ^ 8 (k & 3))
//   when n % 32 == 0, else at k * s + c with s = 8 mod 32.
// Widths are multiples of 8 up to 128; the launches refuse others (the
// wrappers zero-pad a ragged width to the next multiple of 8 and trim the
// output: zero columns give relu(0) = 0, and zero rows of W2 add nothing).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kMaxRanges = 12;  // MAX_OPS: at most one slot range per row

// Slot ranges (type, start, stop), absolute rows; passed to kernels by value.
struct SlotRanges {
  int n;
  int type[kMaxRanges];
  int start[kMaxRanges];
  int stop[kMaxRanges];
};

namespace mma {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 64;        // rows of one tile: 4 row groups of 16
constexpr int kMaxWidth = 128;   // widest layer: 8 n-tiles per warp

// Row-major fp32 matrix in shared memory: element (r, c) at r * stride + (c ^ (f(r) & swz)).
struct Layout {
  int stride;
  int swz;
};

__host__ __device__ inline int round8(int k) { return (k + 7) & ~7; }
__host__ __device__ inline long long round4(long long n) { return (n + 3) & ~3LL; }

// An activation tile of k columns (the operand A of a layer, or its output).
__host__ __device__ inline Layout act_layout(int k) {
  k = round8(k);
  return k % 32 == 0 ? Layout{k, 0x1c} : Layout{k + 4, 0};
}
__device__ __forceinline__ int act_at(Layout l, int r, int c) {
  return r * l.stride + (c ^ (((r & 7) << 2) & l.swz));
}

// A weight matrix of n columns (the operand B of a layer).
__host__ __device__ inline Layout weight_layout(int n) {
  return n % 32 == 0 ? Layout{n, 0x18} : Layout{n + (40 - n % 32) % 32, 0};
}
__device__ __forceinline__ int weight_at(Layout l, int k, int c) {
  return k * l.stride + (c ^ (((k & 3) << 3) & l.swz));
}

// One type's staged weights: W1 (round8(k) x n1, zero rows past k), b1, W2 (n1 x n2), b2.
struct Dims {
  int k, n1, n2;
};

__host__ __device__ inline long long weight_floats(Dims d) {
  return (long long)round8(d.k) * weight_layout(d.n1).stride + d.n1 +
         (long long)d.n1 * weight_layout(d.n2).stride + d.n2;
}

// Floats of one fp32 tile buffer of `rows` rows: it holds the input, then
// the hidden activation, then the output.
__host__ __device__ inline int tile_floats(Dims d, int rows = kRows) {
  int s = act_layout(d.k).stride;
  s = s > act_layout(d.n1).stride ? s : act_layout(d.n1).stride;
  s = s > act_layout(d.n2).stride ? s : act_layout(d.n2).stride;
  return rows * s;
}

// n-tiles per warp for the wider of the two layers: 1, 2, 4 or 8.
inline int n_tiles_per_warp(int n1, int n2) {
  const int nt = ((n1 > n2 ? n1 : n2) / 8 + 1) / 2;
  int p = 1;
  while (p < nt) p *= 2;
  return p;
}

inline bool widths_ok(Dims d) {
  return d.k >= 1 && d.n1 >= 8 && d.n2 >= 8 && d.n1 <= kMaxWidth && d.n2 <= kMaxWidth &&
         d.n1 % 8 == 0 && d.n2 % 8 == 0;
}

// --- host side ---------------------------------------------------------------

// What a launch sizes itself by.
struct DeviceInfo {
  int sms, smem_max;
};

inline DeviceInfo device_info(int device) {
  DeviceInfo i{0, 0};
  cudaDeviceGetAttribute(&i.sms, cudaDevAttrMultiProcessorCount, device);
  cudaDeviceGetAttribute(&i.smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (i.sms < 1) i.sms = 1;
  return i;
}

// Let `kernel` take `smem` bytes of dynamic shared memory, the carveout
// favouring shared memory.
inline cudaError_t allow_shared_memory(const void* kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

// --- asynchronous copies -----------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// dst[i] = src[i] for i < n, by the whole block, asynchronously: 16 bytes a
// thread where both sides are 16-byte aligned, 4 bytes otherwise.
__device__ inline void copy_async(float* dst, const float* src, int n) {
  if (aligned16(dst) && aligned16(src)) {
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) cp_async16(dst + 4 * i, src + 4 * i);
    for (int i = 4 * (n / 4) + threadIdx.x; i < n; i += blockDim.x) cp_async4(dst + i, src + i);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async4(dst + i, src + i);
  }
}

// dst[gi * n + j] = src[(g0 + gi) * stride + j] for gi < graphs, j < n: rows
// of a per-graph field, asynchronously, 4 bytes a thread.
__device__ inline void copy_rows(int* dst, const int* src, int g0, int graphs, int n, long long stride) {
  if (stride == n) {
    for (int i = threadIdx.x; i < graphs * n; i += blockDim.x) cp_async4(dst + i, src + (long long)g0 * n + i);
  } else {
    for (int i = threadIdx.x; i < graphs * n; i += blockDim.x)
      cp_async4(dst + i, src + (long long)(g0 + i / n) * stride + i % n);
  }
}

// Make this thread's earlier writes (shared and global) visible to the
// asynchronous proxy that bulk copies run in.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async;\n" ::: "memory"); }

// dst[0 .. bytes) = src[0 .. bytes) from shared to global memory as one bulk
// copy by the calling thread (bytes a multiple of 16, both 16-byte aligned);
// returns once the copy has read src, and the write completes on its own.
__device__ inline void bulk_store(float* dst, const float* src, unsigned bytes) {
  const unsigned from = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(from), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// A rows x n row-major matrix at src into the weight layout for n columns.
// Thread tid copies piece tid % pieces of rows tid / pieces + j * per_pass:
// no division per piece.
__device__ inline void stage_matrix(float* dst, const float* src, int rows, int n) {
  const Layout l = weight_layout(n);
  const bool vec = aligned16(src);
  const int pieces = vec ? n / 4 : n;  // n % 8 == 0
  const int per_pass = blockDim.x / pieces, k0 = threadIdx.x / pieces;
  const int c = (threadIdx.x - k0 * pieces) * (vec ? 4 : 1);
  if (k0 >= per_pass) return;
  for (int k = k0; k < rows; k += per_pass) {
    if (vec)
      cp_async16(dst + weight_at(l, k, c), src + (long long)k * n + c);
    else
      cp_async4(dst + weight_at(l, k, c), src + (long long)k * n + c);
  }
}

// cvt.rna.tf32.f32 on the integer units: round the magnitude to nearest at 10
// mantissa bits, ties away from zero, and clear the 13 bits below.
__device__ __forceinline__ uint32_t tf32_rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Pointers into one type's staged weights.
struct Staged {
  const float *w1, *b1, *w2, *b2;
};

__device__ inline Staged staged_at(const float* base, Dims d) {
  Staged s;
  s.w1 = base;
  s.b1 = s.w1 + (long long)round8(d.k) * weight_layout(d.n1).stride;
  s.w2 = s.b1 + d.n1;
  s.b2 = s.w2 + (long long)d.n1 * weight_layout(d.n2).stride;
  return s;
}

// Issue the copies of the weights of bank entry `key` (member * T + type) of
// the (E, T, ...) weight tensors into base, and commit them as one cp.async
// group.  W1's rows past k are zeroed, so a zero-padded input adds nothing.
__device__ inline void stage_weights(float* base, Dims d, long long key, const float* w1, const float* b1,
                                     const float* w2, const float* b2) {
  const Staged s = staged_at(base, d);
  stage_matrix(const_cast<float*>(s.w1), w1 + key * d.k * d.n1, d.k, d.n1);
  const Layout l1 = weight_layout(d.n1);
  for (int i = threadIdx.x; i < (round8(d.k) - d.k) * d.n1; i += blockDim.x)
    const_cast<float*>(s.w1)[weight_at(l1, d.k + i / d.n1, i % d.n1)] = 0.f;
  copy_async(const_cast<float*>(s.b1), b1 + key * d.n1, d.n1);
  stage_matrix(const_cast<float*>(s.w2), w2 + key * d.n1 * d.n2, d.n1, d.n2);
  copy_async(const_cast<float*>(s.b2), b2 + key * d.n2, d.n2);
  cp_async_commit();
}

// --- the tensor-core product -------------------------------------------------

// d += a (16x8, row) * b (8x8, col), TF32 in, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The hi and lo TF32 halves of A (r, c): split here from an fp32 tile, or
// read as a (hi, lo) pair from a tile split when it was written.
template <bool kSplitA>
__device__ __forceinline__ void load_a(const float* row, int c, int swz, uint32_t& hi, uint32_t& lo) {
  if (kSplitA) {
    const float2 v = reinterpret_cast<const float2*>(row)[c];
    hi = __float_as_uint(v.x);
    lo = __float_as_uint(v.y);
  } else {
    split(row[c ^ swz], hi, lo);
  }
}

// acc = A[row0 .. row0 + 15, 0 .. k) @ W[0 .. k, n-tiles of this warp] in 3xTF32.
// k is a multiple of 8 (zero-padded).  A is an fp32 tile in layout la, or
// (kSplitA) a tile of (hi, lo) pairs with stride la.stride pairs.  The warp's
// n-tiles are ni, ni + WN, ...; one past the last n-tile is clamped to it
// (computed again and not written), so the loop has no branch and the
// compiler interleaves the n-tiles' MMA chains.  Fragment layout of m16n8k8
// (g = lane / 4, t = lane % 4): A (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4);
// B (t, g), (t + 4, g); C (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
template <int NTW, int WN, bool kSplitA>
__device__ __forceinline__ void warp_gemm(const float* A, Layout la, int k, const float* W, Layout lw,
                                          int n, int row0, int ni, float (&acc)[NTW][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int last = (n >> 3) - 1;
  const int width = kSplitA ? 2 : 1;                     // floats per element
  const float* a0 = A + width * (row0 + g) * la.stride;  // row0 % 16 == 0, so (row & 7) == g
  const float* a1 = a0 + width * 8 * la.stride;
  const int aswz = (g << 2) & la.swz;
  const int bswz = (t << 3) & lw.swz;
  int col[NTW];
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    col[j] = (8 * min(WN * j + ni, last) + g) ^ bswz;
  }
#pragma unroll 2
  for (int k0 = 0; k0 < k; k0 += 8) {
    uint32_t ah[4], al[4];
    load_a<kSplitA>(a0, k0 + t, aswz, ah[0], al[0]);
    load_a<kSplitA>(a1, k0 + t, aswz, ah[1], al[1]);
    load_a<kSplitA>(a0, k0 + t + 4, aswz, ah[2], al[2]);
    load_a<kSplitA>(a1, k0 + t + 4, aswz, ah[3], al[3]);
    const int b0 = (k0 + t) * lw.stride, b4 = b0 + 4 * lw.stride;  // rows k0 + t, k0 + t + 4
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      uint32_t bh[2], bl[2];
      split(W[b0 + col[j]], bh[0], bl[0]);
      split(W[b4 + col[j]], bh[1], bl[1]);
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(part, al, bh);
      mma_tf32(part, ah, bl);
      mma_tf32(part, ah, bh);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += part[i];
    }
  }
}

// out(r, c) = act(acc + bias[c]) for this warp's rows and n-tiles: fp32 in
// layout lo, or (kSplitOut) (hi, lo) pairs with stride lo.stride pairs.
template <int NTW, int WN, bool kRelu, bool kSplitOut>
__device__ __forceinline__ void warp_epilogue(float* out, Layout lo, const float (&acc)[NTW][4],
                                              const float* bias, int n, int row0, int ni) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int jj = WN * j + ni;
    if (jj < (n >> 3)) {
      const int c = 8 * jj + 2 * t;
      float v[2][2] = {{acc[j][0] + bias[c], acc[j][1] + bias[c + 1]},
                       {acc[j][2] + bias[c], acc[j][3] + bias[c + 1]}};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + g + 8 * h;
        if (kRelu) v[h][0] = fmaxf(v[h][0], 0.f), v[h][1] = fmaxf(v[h][1], 0.f);
        if (kSplitOut) {
          uint32_t h0, l0, h1, l1;
          split(v[h][0], h0, l0);
          split(v[h][1], h1, l1);
          *reinterpret_cast<uint4*>(out + 2 * (r * lo.stride + c)) = make_uint4(h0, l0, h1, l1);
        } else {
          *reinterpret_cast<float2*>(out + act_at(lo, r, c)) = make_float2(v[h][0], v[h][1]);
        }
      }
    }
  }
}

// Layout, in (hi, lo) pairs, of a split tile with k columns: a stride of 4
// mod 8 pairs puts the 16 threads of each half-warp's 8-byte fragment loads in
// distinct banks.
__host__ __device__ inline Layout split_layout(int k) { return Layout{round8(k) + 4, 0}; }

// Floats of a split tile of `rows` rows: it holds the input and the hidden
// activation as (hi, lo) pairs, then the fp32 output.
__host__ __device__ inline int split_tile_floats(Dims d, int rows) {
  int s = 2 * split_layout(d.k).stride;
  s = s > 2 * split_layout(d.n1).stride ? s : 2 * split_layout(d.n1).stride;
  s = s > act_layout(d.n2).stride ? s : act_layout(d.n2).stride;
  return rows * s;
}

// Both layers with kWarps / WN row groups of 16 rows and WN column groups:
// warp w owns rows 16 (w % (kWarps / WN)) + 0..15 and n-tiles w / (kWarps / WN) + WN j.
template <int NTW, int WN, bool kSplit>
__device__ __forceinline__ void mlp_layers(float* tile, Dims d, Staged w) {
  constexpr int kWm = kWarps / WN;
  const int warp = threadIdx.x >> 5, row0 = 16 * (warp % kWm), ni = warp / kWm;
  const Layout lx = kSplit ? split_layout(d.k) : act_layout(d.k);
  const Layout lh = kSplit ? split_layout(d.n1) : act_layout(d.n1);
  const Layout ly = act_layout(d.n2);
  float acc[NTW][4];
  warp_gemm<NTW, WN, kSplit>(tile, lx, round8(d.k), w.w1, weight_layout(d.n1), d.n1, row0, ni, acc);
  __syncthreads();  // every warp is done reading the input rows
  warp_epilogue<NTW, WN, true, kSplit>(tile, lh, acc, w.b1, d.n1, row0, ni);
  __syncthreads();
  warp_gemm<NTW, WN, kSplit>(tile, lh, d.n1, w.w2, weight_layout(d.n2), d.n2, row0, ni, acc);
  __syncthreads();
  warp_epilogue<NTW, WN, false, false>(tile, ly, acc, w.b2, d.n2, row0, ni);
  __syncthreads();
}

// The fused 2-layer MLP over the first `rows` rows of tile; on return the
// tile holds the output in act_layout(d.n2).  The input is an fp32 tile in
// act_layout(d.k), zero-padded to round8(d.k) columns, or (kSplit) a tile of
// (hi, lo) pairs in split_layout(d.k), so that its 8 warps load the split
// halves instead of each splitting the same elements; the hidden activation
// then stays split too.  Called by the whole block; every thread must reach
// it.  Rows past `rows` hold whatever the tile held and are computed to no
// purpose: a row of the product depends on its own input row only.  As few
// row groups as the rows need, so that a short tile (the selected rows of
// mp_update) still spreads over all 8 warps; NTW is the n-tiles a warp takes
// with 2 column groups.  kMaxRows bounds `rows` (a tile of that many rows).
template <int NTW, bool kSplit = false, int kMaxRows = kRows>
__device__ inline void mlp_tile(float* tile, int rows, Dims d, Staged w) {
  if constexpr (kMaxRows <= 16) {
    mlp_layers<(NTW + 3) / 4, 8, kSplit>(tile, d, w);
  } else {
    if (rows <= 16)
      mlp_layers<(NTW + 3) / 4, 8, kSplit>(tile, d, w);
    else if (kMaxRows <= 32 || rows <= 32)
      mlp_layers<(NTW + 1) / 2, 4, kSplit>(tile, d, w);
    else
      mlp_layers<NTW, 2, kSplit>(tile, d, w);
  }
}

// Write tile row r (output layout for n columns, n % 8 == 0) to dst, 16 bytes
// a thread: the 4 threads `sub` = 0..3 of one row share its n / 4 chunks.
__device__ __forceinline__ void store_row(float* dst, const float* tile, Layout ly, int r, int n, int sub) {
  for (int c = 4 * sub; c < n; c += 16)
    *reinterpret_cast<float4*>(dst + c) = *reinterpret_cast<const float4*>(tile + act_at(ly, r, c));
}

}  // namespace mma
}  // namespace repro_torch
