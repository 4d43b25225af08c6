// Mamba-1 selective scan for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssm_scan/kernel.py:_ssm_kernel
// (launched by selective_scan_pallas).  It computes the same function, in
// float32:
//
//     h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t     (per channel d, state n)
//     y_t = sum_n C_t[n] * h_t[n]
//
// over dt, x [B, S, D], B_t, C_t [B, S, N], A [D, N] and the initial
// state h0 [B, D, N]; it writes y [B, S, D] and the final state h_out
// [B, D, N].  The product dt * B * x is taken in that order, as in the
// reference (selective_scan_ref).
//
// Design.  One thread per (batch row b, channel d) keeps its N states (N
// up to 16) and its row of A in registers for the whole sequence, so the
// [B, S, D, N] state tensor never exists and the state never leaves the
// chip between steps.  A block holds 128 neighbouring channels of one
// batch row: at each step its threads read dt, x and write y at
// neighbouring addresses (coalesced).  B_t and C_t, which every channel of
// a batch row shares, are staged in shared memory 32 steps at a time and
// read as broadcasts.  The Pallas grid (B, D / tile_d) over a sequential
// fori_loop becomes this grid of independent blocks with the time loop
// inside each thread; D need not divide anything (the ragged edge is
// masked).  B_t and C_t may be strided views (rows of a wider projection);
// every other tensor is contiguous.  h_out may be h0 itself: each thread
// reads its own state before the loop and writes it after, so a decode
// cache is updated in place.
//
// exp is expf, not __expf: expf keeps 2 ulp of accuracy for every
// argument (dt * A reaches tens here), and costs, besides the one MUFU.EX2
// that __expf would issue, about six FP32 instructions of range reduction
// and scaling per call.
//
// What bounds it on this card.  Per (b, t, d) the work is one element of
// dt, x and y (12 bytes) and N exponentials, plus per (b, d) the 2 N
// floats of h0 and h_out.  At the serving path's prefill (B 8, S 128,
// D 8192, N 16) that is ~109 MB, ~33 us at 3.35 TB/s, against 134 M
// exponentials, ~32 us at 16 per SM per clock on 132 SMs at 1.98 GHz: a
// near tie of bytes and the special-function unit, with the FP32 FMAs at
// about a third of either.  At decode (S = 1) the h0 / h_out traffic
// bounds it.  The kernel keeps every byte to one read or write; what it
// does not do yet is overlap the loads of step t + 1 with the arithmetic
// of step t beyond what the compiler schedules, or split a long sequence
// into chunks scanned in parallel.  chip_smoke.py measures it against
// that bound and PERF.md keeps the numbers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kChunk = 32;     // time steps of B and C staged at once
constexpr int kMaxState = 16;

template <int N>
__global__ void __launch_bounds__(kThreads)
    ssm_scan_kernel(const float* __restrict__ dt, const float* __restrict__ bm,
                    const float* __restrict__ cm, const float* __restrict__ x,
                    const float* __restrict__ a, const float* h0, float* __restrict__ y,
                    float* h_out, int S, int D, long long sb_b, long long sb_s, long long sc_b,
                    long long sc_s) {
  __shared__ float sB[kChunk][N];
  __shared__ float sC[kChunk][N];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < D;

  float av[N], h[N];
  if (live) {
    const float* a_row = a + static_cast<long long>(d) * N;
    const float* h_row = h0 + (static_cast<long long>(b) * D + d) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      av[n] = a_row[n];
      h[n] = h_row[n];
    }
  }
  const float* bm_row = bm + b * sb_b;
  const float* cm_row = cm + b * sc_b;
  const long long base = static_cast<long long>(b) * S * D + d;  // (b, t = 0, d)

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int len = min(kChunk, S - t0);
    __syncthreads();  // every thread is done with the previous chunk's B and C
    for (int i = threadIdx.x; i < len * N; i += kThreads) {
      const int t = i / N, n = i - t * N;
      sB[t][n] = bm_row[(t0 + t) * sb_s + n];
      sC[t][n] = cm_row[(t0 + t) * sc_s + n];
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int t = 0; t < len; ++t) {
        const long long idx = base + static_cast<long long>(t0 + t) * D;
        const float dtv = dt[idx];
        const float xv = x[idx];
        float yv = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float decay = expf(dtv * av[n]);
          h[n] = decay * h[n] + dtv * sB[t][n] * xv;
          yv += h[n] * sC[t][n];
        }
        y[idx] = yv;
      }
    }
  }
  if (live) {
    float* h_row = h_out + (static_cast<long long>(b) * D + d) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) h_row[n] = h[n];
  }
}

template <int N>
cudaError_t launch(const float* dt, const float* bm, const float* cm, const float* x,
                   const float* a, const float* h0, float* y, float* h_out, int B, int S, int D,
                   long long sb_b, long long sb_s, long long sc_b, long long sc_s,
                   cudaStream_t stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  ssm_scan_kernel<N><<<grid, kThreads, 0, stream>>>(dt, bm, cm, x, a, h0, y, h_out, S, D, sb_b,
                                                    sb_s, sc_b, sc_s);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const float*, const float*, const float*, const float*,
                                 const float*, const float*, float*, float*, int, int, int,
                                 long long, long long, long long, long long, cudaStream_t);

// launch<N> for N = 1 .. kMaxState, indexed by N - 1
constexpr LaunchFn kLaunch[kMaxState] = {
    launch<1>,  launch<2>,  launch<3>,  launch<4>,  launch<5>,  launch<6>,
    launch<7>,  launch<8>,  launch<9>,  launch<10>, launch<11>, launch<12>,
    launch<13>, launch<14>, launch<15>, launch<16>,
};

}  // namespace

// dt, x, y: contiguous [B, S, D]; a: contiguous [D, N]; h0, h_out:
// contiguous [B, D, N] (h_out may equal h0); bm, cm: [B, S, N] with a unit
// stride on N and element strides (sb_b, sb_s), (sc_b, sc_s) on B and S.
// All float32 on the current device.  1 <= N <= 16, 1 <= B <= 65535,
// D >= 1, S >= 0.  Launches on `stream`; returns the cudaError_t of the
// launch (0 = success).
extern "C" int da4ml_ssm_scan(const float* dt, const float* bm, const float* cm, const float* x,
                              const float* a, const float* h0, float* y, float* h_out, int B,
                              int S, int D, int N, long long sb_b, long long sb_s,
                              long long sc_b, long long sc_s, void* stream) {
  if (B <= 0 || B > 65535 || S < 0 || D <= 0 || N < 1 || N > kMaxState) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(kLaunch[N - 1](dt, bm, cm, x, a, h0, y, h_out, B, S, D, sb_b, sb_s,
                                         sc_b, sc_s, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* da4ml_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
