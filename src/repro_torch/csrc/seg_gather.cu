// seg_gather: the cross-query merged engine's aggregations, for Hopper (sm_90a).
//
// gather_sum replaces the TPU kernel repro/kernels/seg_gather/kernel.py:gather_sum_pallas:
//   out[e, b, r] = sum_{p < P} w[b, r, p] * h[e, b, idx[b, r, p]]
// (stage 3's parent-table aggregation, P = max_parents; stage 2's host
// gather, P = 1).  segment_sum replaces segment_sum_pallas:
//   out[e, b, s] = sum_{r: seg[b, r] == s} x[e, b, r]        s < n_seg
// (stage 1's OPS->HW sum over each host's operators).
//
// The TPU kernels built one-hot selection matrices and ran them on the matrix
// unit, because a TPU kernel cannot gather; their wrappers padded the rows to
// a power of two for it.  Here each output element is one thread's direct
// indexed loads, with no padding.  The member axis E is explicit; the index
// tables and weights are per graph and shared by every member, read through
// their strides (a column slice of a wider table, or the transposed layout a
// GPU sort returns, needs no copy).  Indices are int64 (what torch's argsort /
// argmax return), read as they are.  An index outside the rows contributes
// nothing.
//
// What bounds them: bytes.  Each output element costs P (or N) loads and as
// many adds; the work is a few FLOPs per byte moved.  Each thread owns four
// consecutive columns (16-byte loads and stores) where the rows allow it.
// Sums run over p (or r) in ascending order with no atomics, so two runs give
// bitwise-equal answers; products and sums are rounded separately (no FMA
// contraction), as the plain PyTorch version computes them.
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kSegThreads = 256;

template <int V>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void axpy(T& acc, float w, T x) {
    acc.x = __fadd_rn(acc.x, __fmul_rn(w, x.x));
    acc.y = __fadd_rn(acc.y, __fmul_rn(w, x.y));
    acc.z = __fadd_rn(acc.z, __fmul_rn(w, x.z));
    acc.w = __fadd_rn(acc.w, __fmul_rn(w, x.w));
  }
  __device__ static void add(T& acc, T x) {
    acc.x = __fadd_rn(acc.x, x.x);
    acc.y = __fadd_rn(acc.y, x.y);
    acc.z = __fadd_rn(acc.z, x.z);
    acc.w = __fadd_rn(acc.w, x.w);
  }
};
template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static void axpy(T& acc, float w, T x) { acc = __fadd_rn(acc, __fmul_rn(w, x)); }
  __device__ static void add(T& acc, T x) { acc = __fadd_rn(acc, x); }
};

// One thread per (e, b, r, column group); grid-stride over the outputs.
template <int V>
__global__ void __launch_bounds__(kSegThreads) gather_sum_kernel(
    const float* __restrict__ h, const long long* __restrict__ idx, long long idx_batch_stride,
    long long idx_row_stride, long long idx_p_stride, const float* __restrict__ w,
    long long w_batch_stride, long long w_row_stride, long long w_p_stride, float* __restrict__ out,
    int E, int B, int N, int R, int P, int H) {
  using T = typename Vec<V>::T;
  const int HV = H / V;
  const long long total = (long long)E * B * R * HV;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % HV);
    const long long row = i / HV;  // (e * B + b) * R + r
    const int r = (int)(row % R);
    const long long eb = row / R;  // e * B + b
    const int b = (int)(eb % B);
    const long long* ir = idx + b * idx_batch_stride + r * idx_row_stride;
    const float* wr = w + b * w_batch_stride + r * w_row_stride;
    const T* hb = reinterpret_cast<const T*>(h + eb * N * H);
    T acc = Vec<V>::zero();
    for (int p = 0; p < P; ++p) {
      const long long u = ir[p * idx_p_stride];
      if (u < 0 || u >= N) continue;
      Vec<V>::axpy(acc, wr[p * w_p_stride], hb[u * HV + c]);
    }
    reinterpret_cast<T*>(out)[i] = acc;
  }
}

// One thread per (e, b, s, column group): the rows of segment s, in order.
template <int V>
__global__ void __launch_bounds__(kSegThreads) segment_sum_kernel(
    const float* __restrict__ x, const long long* __restrict__ seg, long long seg_batch_stride,
    float* __restrict__ out, int E, int B, int N, int S, int H) {
  using T = typename Vec<V>::T;
  const int HV = H / V;
  const long long total = (long long)E * B * S * HV;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % HV);
    const long long row = i / HV;  // (e * B + b) * S + s
    const int s = (int)(row % S);
    const long long eb = row / S;
    const int b = (int)(eb % B);
    const long long* sb = seg + b * seg_batch_stride;
    const T* xb = reinterpret_cast<const T*>(x + eb * N * H);
    T acc = Vec<V>::zero();
    for (int r = 0; r < N; ++r)
      if (sb[r] == s) Vec<V>::add(acc, xb[r * HV + c]);
    reinterpret_cast<T*>(out)[i] = acc;
  }
}

// Blocks for `total` outputs: one per 256, at most 32 per SM (grid-stride beyond).
static int seg_blocks(long long total, int device) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (sms < 1) sms = 1;
  long long blocks = (total + kSegThreads - 1) / kSegThreads;
  const long long cap = 32LL * sms;
  return (int)(blocks < 1 ? 1 : (blocks > cap ? cap : blocks));
}

static bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<size_t>(a) | reinterpret_cast<size_t>(b)) & 15) == 0;
}

}  // namespace repro_torch

using namespace repro_torch;

// h: (E, B, N, H) contiguous fp32.  idx (int64) and w (fp32): (B, R, P) at
// the given batch, row and entry strides, in elements.  out: (E, B, R, H)
// contiguous fp32.  Returns the cudaError_t of the launch.
extern "C" int gather_sum_launch(const float* h, const long long* idx, long long idx_batch_stride,
                                 long long idx_row_stride, long long idx_p_stride, const float* w,
                                 long long w_batch_stride, long long w_row_stride,
                                 long long w_p_stride, float* out, int E, int B, int N, int R,
                                 int P, int H, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E < 1 || B < 1 || N < 1 || R < 1 || P < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (H % 4 == 0 && aligned16(h, out)) {
    const long long total = (long long)E * B * R * (H / 4);
    gather_sum_kernel<4><<<seg_blocks(total, device), kSegThreads, 0, s>>>(
        h, idx, idx_batch_stride, idx_row_stride, idx_p_stride, w, w_batch_stride, w_row_stride,
        w_p_stride, out, E, B, N, R, P, H);
  } else {
    const long long total = (long long)E * B * R * H;
    gather_sum_kernel<1><<<seg_blocks(total, device), kSegThreads, 0, s>>>(
        h, idx, idx_batch_stride, idx_row_stride, idx_p_stride, w, w_batch_stride, w_row_stride,
        w_p_stride, out, E, B, N, R, P, H);
  }
  return (int)cudaGetLastError();
}

// x: (E, B, N, H) contiguous fp32.  seg (int64): B rows of N contiguous
// entries at batch stride seg_batch_stride.  out: (E, B, S, H) contiguous
// fp32.  Returns the cudaError_t of the launch.
extern "C" int segment_sum_launch(const float* x, const long long* seg, long long seg_batch_stride,
                                  float* out, int E, int B, int N, int S, int H, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E < 1 || B < 1 || N < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (H % 4 == 0 && aligned16(x, out)) {
    const long long total = (long long)E * B * S * (H / 4);
    segment_sum_kernel<4><<<seg_blocks(total, device), kSegThreads, 0, s>>>(
        x, seg, seg_batch_stride, out, E, B, N, S, H);
  } else {
    const long long total = (long long)E * B * S * H;
    segment_sum_kernel<1><<<seg_blocks(total, device), kSegThreads, 0, s>>>(
        x, seg, seg_batch_stride, out, E, B, N, S, H);
  }
  return (int)cudaGetLastError();
}
