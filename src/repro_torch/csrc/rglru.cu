// rglru: the RG-LRU block's gated linear recurrence, for Hopper (sm_90a).
//
//   out[b, t, d] = h_t,   h_t = a[b, t, d] * h_{t-1} + x[b, t, d],   h_{-1} = h0[b, d]
//
// Replaces the TPU kernel repro/kernels/rglru/kernel.py:linear_scan_pallas.
// That kernel tiled T into chunks that ran in order on one core and carried
// the state in a VMEM scratch buffer from one grid step to the next.  Blocks
// on this card run in no order, so nothing may carry between them: here one
// thread owns one (b, d) channel and walks all of T itself, with the state in
// a register.  Neighbouring threads own neighbouring channels, so each step's
// loads and stores are coalesced along D.  The ragged tail of D is masked;
// B and T need no tiling rule.
//
// What bounds it: bytes.  Every element of a and x is read once and every
// element of out written once; the work is 2 flops per 12 bytes.  The chain
// through h is serial, so each thread loads the next kScanAhead steps of a
// and x into registers before it runs the current steps' dependent updates,
// keeping loads in flight while it computes.  With B * D threads in all
// (10,240 at the prefill shape (4, 2048, 2560)), this simple design cannot
// keep enough bytes in flight to reach the memory rate; a scan split across
// T (more threads, a second pass for the carries) is a later kernel's work.
//
// Each step rounds the product and the sum separately (no FMA contraction),
// as the plain PyTorch loop (kernels/rglru/ref.py) computes them, so the two
// agree bitwise and two launches give bitwise-equal answers.
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kScanThreads = 128;
constexpr int kScanAhead = 16;

// One thread per (b, d): grid (ceil(D / kScanThreads), B).  a, x and h0 are
// read through their strides (in elements); out is contiguous (B, T, D).
__global__ void __launch_bounds__(kScanThreads) linear_scan_kernel(
    const float* __restrict__ a, long long a_sb, long long a_st, long long a_sd,
    const float* __restrict__ x, long long x_sb, long long x_st, long long x_sd,
    const float* __restrict__ h0, long long h_sb, long long h_sd, float* __restrict__ out, int T,
    int D) {
  const int d = blockIdx.x * kScanThreads + threadIdx.x;
  if (d >= D) return;
  const long long b = blockIdx.y;
  const float* ap = a + b * a_sb + d * a_sd;
  const float* xp = x + b * x_sb + d * x_sd;
  float* op = out + b * (long long)T * D + d;
  float h = h0[b * h_sb + d * h_sd];

  float a_next[kScanAhead], x_next[kScanAhead];
#pragma unroll
  for (int k = 0; k < kScanAhead; ++k) {
    a_next[k] = k < T ? ap[k * a_st] : 0.f;
    x_next[k] = k < T ? xp[k * x_st] : 0.f;
  }
  for (int t0 = 0; t0 < T; t0 += kScanAhead) {
    float a_cur[kScanAhead], x_cur[kScanAhead];
#pragma unroll
    for (int k = 0; k < kScanAhead; ++k) {
      a_cur[k] = a_next[k];
      x_cur[k] = x_next[k];
    }
    const int t1 = t0 + kScanAhead;
    if (t1 < T) {
#pragma unroll
      for (int k = 0; k < kScanAhead; ++k) {
        const long long t = t1 + k;
        a_next[k] = t < T ? ap[t * a_st] : 0.f;
        x_next[k] = t < T ? xp[t * x_st] : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kScanAhead; ++k) {
      if (t0 + k < T) {
        h = __fadd_rn(__fmul_rn(a_cur[k], h), x_cur[k]);
        op[(long long)(t0 + k) * D] = h;
      }
    }
  }
}

}  // namespace repro_torch

using namespace repro_torch;

// a, x: (B, T, D) fp32 at the given batch, step and channel strides; h0:
// (B, D) fp32 at its batch and channel strides (a slice of a stacked cache
// needs no copy).  out: (B, T, D) contiguous fp32, not overlapping the
// inputs.  T = 0 launches nothing.  Returns the cudaError_t of the launch.
extern "C" int linear_scan_launch(const float* a, long long a_sb, long long a_st, long long a_sd,
                                  const float* x, long long x_sb, long long x_st, long long x_sd,
                                  const float* h0, long long h_sb, long long h_sd, float* out,
                                  int B, int T, int D, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 0 || T < 0 || D < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0 || D == 0) return (int)cudaSuccess;
  const dim3 grid((D + kScanThreads - 1) / kScanThreads, B);
  linear_scan_kernel<<<grid, kScanThreads, 0, (cudaStream_t)stream>>>(
      a, a_sb, a_st, a_sd, x, x_sb, x_st, x_sd, h0, h_sb, h_sd, out, T, D);
  return (int)cudaGetLastError();
}
