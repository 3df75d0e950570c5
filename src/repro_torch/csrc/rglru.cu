// rglru: the RG-LRU block's gated linear recurrence, for Hopper (sm_90a).
//
//   out[b, t, d] = h_t,   h_t = a[b, t, d] * h_{t-1} + x[b, t, d],   h_{-1} = h0[b, d]
//
// Replaces the TPU kernel repro/kernels/rglru/kernel.py:linear_scan_pallas.
// That kernel tiled T into chunks that ran in order on one core and carried
// the state in a VMEM scratch buffer from one grid step to the next.  Blocks
// on this card run in no order, so nothing carries between them: a block owns
// 32 consecutive channels of one batch row, one per lane, and walks all of T
// itself.
//
// What bounds it: bytes.  Every element of a and x is read once and every
// element of out written once; the work is 2 flops per 12 bytes.  One thread
// per channel walking T (10,240 threads at the prefill shape (4, 2048, 2560))
// cannot keep enough loads in flight to reach the memory rate, so the scan is
// split across T inside the block: its warps take consecutive chunks of
// kChunk steps (a round of kScanWarps * kChunk steps), each loads its chunk into
// registers with coalesced 128-byte rows, and computes the chunk's composed
// map h -> A h + S (A the product of its a, S its scan from 0).  The warps
// fold those maps onto the block's carry in a fixed order through shared
// memory, so each warp has its carry-in; it re-runs its chunk from there and
// writes it.  The fold of all the round's maps is the next round's carry.  The
// next round's loads are issued before the current round's work, so they are
// in flight meanwhile.  Four warps of 16 steps let every block of the
// prefill shape (320) be resident at once; eight warps fit two blocks an SM
// and left a second wave, and were slower.  A short scan (a decode step has
// one step) runs the same round: the chunks past T are identity maps, and up
// to 16 steps warp 0 re-runs its chunk from h0 in the plain loop's order.
// The ragged tail of D and of T is masked.
//
// Each step rounds the product and the sum separately (no FMA contraction), as
// the plain PyTorch loop (kernels/rglru/ref.py) does; but past 16 steps the
// carries are composed maps, not the sequential recurrence, so the result
// agrees with the plain loop to fp32 rounding (within 1e-5), not bitwise.  The
// order of every operation is fixed, so two launches give bitwise-equal
// answers.
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kScanWarps = 4;  // warps of a block, each a chunk of a round
constexpr int kChunk = 16;     // steps a warp takes per round

struct ScanArgs {
  const float* a;
  long long a_sb, a_st, a_sd;
  const float* x;
  long long x_sb, x_st, x_sd;
  const float* h0;
  long long h_sb, h_sd;
  float* out;
  int T, D;
};

// This lane's kChunk steps from t0 of a and x; steps past T (and dead lanes)
// read as the identity step a = 1, x = 0.
__device__ __forceinline__ void load_chunk(const ScanArgs& s, const float* ap, const float* xp, bool live, int t0,
                                           float (&av)[kChunk], float (&xv)[kChunk]) {
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    const bool ok = live && t0 + k < s.T;
    av[k] = ok ? ap[(long long)(t0 + k) * s.a_st] : 1.f;
    xv[k] = ok ? xp[(long long)(t0 + k) * s.x_st] : 0.f;
  }
}

// One step of the recurrence, the product and the sum rounded separately.
__device__ __forceinline__ float step(float a, float h, float x) { return __fadd_rn(__fmul_rn(a, h), x); }

// Blocks of kScanWarps warps over 32 channels; grid (ceil(D / 32), B).  a, x
// and h0 are read through their strides (in elements); out is contiguous
// (B, T, D).
__global__ void __launch_bounds__(32 * kScanWarps) linear_scan_kernel(ScanArgs s) {
  __shared__ float2 maps[2][kScanWarps][32];  // (A, S) of each warp's chunk, by round parity
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = blockIdx.x * 32 + lane;
  const bool live = d < s.D;
  const long long b = blockIdx.y;
  const float* ap = s.a + b * s.a_sb + (live ? d : 0) * s.a_sd;
  const float* xp = s.x + b * s.x_sb + (live ? d : 0) * s.x_sd;
  float* op = s.out + b * (long long)s.T * s.D + (live ? d : 0);
  float carry = live ? s.h0[b * s.h_sb + d * s.h_sd] : 0.f;
  constexpr int round_steps = kScanWarps * kChunk;

  float av[kChunk], xv[kChunk];
  load_chunk(s, ap, xp, live, warp * kChunk, av, xv);
  for (int r0 = 0, parity = 0; r0 < s.T; r0 += round_steps, parity ^= 1) {
    const int t0 = r0 + warp * kChunk;
    float an[kChunk], xn[kChunk];  // the next round's chunk, in flight meanwhile
    load_chunk(s, ap, xp, live, t0 + round_steps, an, xn);
    // this chunk's map from zero
    float A = 1.f, S = 0.f;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      S = step(av[k], S, xv[k]);
      A = __fmul_rn(A, av[k]);
    }
    maps[parity][warp][lane] = make_float2(A, S);
    __syncthreads();
    // carry-in: the maps of warps 0 .. warp - 1 applied to the block's carry
    // in order; the same fold over every warp is the next round's carry
    float c = carry, next = carry;
    for (int j = 0; j < kScanWarps; ++j) {
      if (j == warp) c = next;
      const float2 m = maps[parity][j][lane];
      next = step(m.x, next, m.y);
    }
    float hh = c;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (t0 + k >= s.T) break;
      hh = step(av[k], hh, xv[k]);
      if (live) op[(long long)(t0 + k) * s.D] = hh;
    }
    carry = next;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      av[k] = an[k];
      xv[k] = xn[k];
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
  const dim3 grid((D + 31) / 32, B);
  const ScanArgs s{a, a_sb, a_st, a_sd, x, x_sb, x_st, x_sd, h0, h_sb, h_sd, out, T, D};
  linear_scan_kernel<<<grid, 32 * kScanWarps, 0, (cudaStream_t)stream>>>(s);
  return (int)cudaGetLastError();
}
