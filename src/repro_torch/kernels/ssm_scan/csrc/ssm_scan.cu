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
// Two kernels, chosen by the wrapper from the shape alone (S == 1 takes
// the decode kernel, any other S the prefill kernel; kernel.py
// scan_kernel_for).  Both split a channel's N states over neighbouring
// lanes of a warp and sum y over them with __shfl_xor_sync; the slice of
// a lane past N is masked, never read and never written.  Each lane reads
// its slice of h0 and writes the same slice of h_out and nothing else,
// after its last read of h0, so h_out may be h0 itself: a decode cache is
// updated in place.
//
// Decode (S = 1): bound by the bytes of h0, h_out and A (2 N + N floats
// per channel).  One thread per channel filled a quarter of the card's
// 132 x 2,048 thread slots at falcon-mamba-7b's B 8 x D 8192 and moved
// its state with 4-byte loads 64 bytes apart; here 1, 2 or 4 lanes (N <=
// 4, 8, 16) each own a slice of 4 states, 262,144 threads at that shape,
// and move their slices of h0, h_out and A as 16-byte vectors (when N % 4
// == 0 and the three are 16-byte aligned; 4-byte loads otherwise),
// neighbouring lanes on neighbouring addresses.  B_t and C_t are read
// directly, as broadcasts (every channel of a batch row reads the same N
// values): no shared memory and no barrier.  exp is expf: the kernel
// waits on memory, not on the special-function unit.
//
// Prefill (S > 1): 1 or 2 lanes per channel (N <= 8, 16), each with up to
// 8 states, a block holding 256 or 128 channels of one batch row.  dt and
// x of a chunk of 8 or 16 steps and its B_t and C_t come into shared
// memory by cp.async while the chunk before is computed (two buffers, one
// barrier per chunk); a lane reads its dt and x as a broadcast of its
// channel and its B and C slices as 16-byte shared loads.  The
// exponential is ex2.approx of dt * (A * log2 e), with A scaled once per
// lane: one MUFU.EX2 and one multiply, where expf adds about six FP32
// instructions of range reduction.  The product dt * B * x keeps the
// reference's order: at the serving path's inputs (|y| up to ~56, where
// 1e-5 is two ulps) taking dt * x first put y 1.1e-5 off the plain
// version; in the reference's order ex2.approx stays as close to it as
// expf does.  The sequence is not split into chunks scanned in parallel:
// B x D x N independent recurrences already fill the card at the main
// path's batch, and a chunked scan would add a second pass over the
// states.
//
// Training.  On the autograd path the wrapper passes hc, and both kernels
// also write the state at the start of every 8 steps (16-byte stores, each
// lane its slice) for the backward (ssm_scan_bwd.cu); the prefill kernel
// then walks each chunk in runs of 8 steps.  These are separate template
// instances (kHc): serving passes null and runs the instances it ran
// before, with the same outputs bit for bit.
//
// What bounds it on this card.  Per (b, t, d) the work is one element of
// dt, x and y (12 bytes) and N exponentials, plus per (b, d) the 2 N
// floats of h0 and h_out.  At the serving path's prefill (B 8, S 128,
// D 8192, N 16) that is ~109 MB, ~33 us at 3.35 TB/s, against 134 M
// exponentials, ~32 us at 16 per SM per clock on 132 SMs at 1.98 GHz; the
// compiled loop issues six instructions per state update, one of them the
// MUFU.EX2.  At decode the 8.9 MB of h0, h_out and A bound it, ~2.7 us.
// chip_smoke.py measures both against that bound (decode with the state
// coming from device memory, as on the main path) and PERF.md keeps the
// numbers and what was tried.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxState = 16;
constexpr int kSlice = 4;  // states per lane
constexpr int kHcChunk = 8;  // steps between the chunk-start states the training path keeps

// lanes per channel: the 4-state slices of N, rounded up to a power of two
__host__ __device__ constexpr int lanes_for(int n) { return n <= 4 ? 1 : (n <= 8 ? 2 : 4); }

__device__ __forceinline__ float sum_over_lanes(float v, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int N, bool kVec, bool kHc>
__global__ void __launch_bounds__(kThreads)
    ssm_decode_kernel(const float* __restrict__ dt, const float* __restrict__ bm,
                      const float* __restrict__ cm, const float* __restrict__ x,
                      const float* __restrict__ a, const float* h0, float* __restrict__ y,
                      float* h_out, float* __restrict__ hc, int D, long long sb_b,
                      long long sc_b) {
  constexpr int L = lanes_for(N);
  const int b = blockIdx.y;
  const int gid = blockIdx.x * kThreads + threadIdx.x;
  const int d = gid / L, n0 = (gid % L) * kSlice;
  const bool live = d < D;
  // a slice wholly past N (N = 12: the fourth lane's) is neither read nor
  // written; with N % 4 == 0 (the vector path) no slice is cut by N
  const bool slice_live = live && n0 < N;
  const long long row = static_cast<long long>(b) * D + d;  // (b, t = 0, d) and (b, d)

  float av[kSlice] = {}, hv[kSlice] = {}, bv[kSlice] = {}, cv[kSlice] = {};
  float dtv = 0.f, xv = 0.f;
  if (live) {
    dtv = dt[row];
    xv = x[row];
    const float* a_sl = a + static_cast<long long>(d) * N + n0;
    const float* h_sl = h0 + row * N + n0;
    if (kVec) {
      if (slice_live) {
        const float4 a4 = *reinterpret_cast<const float4*>(a_sl);
        const float4 h4 = *reinterpret_cast<const float4*>(h_sl);
        av[0] = a4.x, av[1] = a4.y, av[2] = a4.z, av[3] = a4.w;
        hv[0] = h4.x, hv[1] = h4.y, hv[2] = h4.z, hv[3] = h4.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kSlice; ++j) {
        if (n0 + j < N) av[j] = a_sl[j], hv[j] = h_sl[j];
      }
    }
#pragma unroll
    for (int j = 0; j < kSlice; ++j) {
      if (n0 + j < N) bv[j] = bm[b * sb_b + n0 + j], cv[j] = cm[b * sc_b + n0 + j];
    }
    if constexpr (kHc) {  // training: the one chunk's start state is h0 ([B, 1, D, N])
#pragma unroll
      for (int j = 0; j < kSlice; ++j) {
        if (n0 + j < N) hc[row * N + n0 + j] = hv[j];
      }
    }
  }
  float yv = 0.f;
#pragma unroll
  for (int j = 0; j < kSlice; ++j) {
    hv[j] = expf(dtv * av[j]) * hv[j] + dtv * bv[j] * xv;
    yv += hv[j] * cv[j];
  }
  yv = sum_over_lanes(yv, L);  // every lane takes part, live or not
  if (!live) return;
  if (n0 == 0) y[row] = yv;
  float* h_sl = h_out + row * N + n0;
  if (kVec) {
    if (slice_live) *reinterpret_cast<float4*>(h_sl) = make_float4(hv[0], hv[1], hv[2], hv[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kSlice; ++j) {
      if (n0 + j < N) h_sl[j] = hv[j];
    }
  }
}

// 4-byte cp.async; src_bytes 0 fills the shared word with zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ float fast_exp2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// lanes per channel of the prefill kernel
__host__ __device__ constexpr int prefill_lanes_for(int n) { return n <= 8 ? 1 : 2; }

template <int N>
struct Prefill {
  static constexpr int L = prefill_lanes_for(N);
  static constexpr int kSPL = ((N + L - 1) / L + 3) / 4 * 4;  // states per lane, in float4s
  static constexpr int kSP = kSPL * L;                         // states per channel, padded
  static constexpr int kCh = kThreads / L;                     // channels per block
  static constexpr int kT = 8 * L;                             // steps per chunk: kT kCh = 2,048
  struct Smem {                                                // two chunks: one computed, one loading
    float dt[2][kT][kCh];
    float x[2][kT][kCh];
    alignas(16) float b[2][kT][kSP];
    alignas(16) float c[2][kT][kSP];
  };
};

template <int N, bool kHc>
__global__ void __launch_bounds__(kThreads)
    ssm_prefill_kernel(const float* __restrict__ dt, const float* __restrict__ bm,
                       const float* __restrict__ cm, const float* __restrict__ x,
                       const float* __restrict__ a, const float* h0, float* __restrict__ y,
                       float* h_out, float* __restrict__ hc, int S, int D, long long sb_b,
                       long long sb_s, long long sc_b, long long sc_s) {
  using P = Prefill<N>;
  constexpr int L = P::L, kSPL = P::kSPL, kCh = P::kCh, kT = P::kT, kSP = P::kSP;
  constexpr float kLog2e = 1.4426950408889634f;
  __shared__ typename P::Smem sm;

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kCh;
  const int ch = threadIdx.x / L, n0 = (threadIdx.x % L) * kSPL;
  const int d = d0 + ch;
  const bool live = d < D;
  const long long hrow = (static_cast<long long>(b) * D + d) * N;

  float a2[kSPL] = {}, hv[kSPL] = {};
  if (live) {
#pragma unroll
    for (int j = 0; j < kSPL; ++j) {
      if (n0 + j < N) {
        a2[j] = a[static_cast<long long>(d) * N + n0 + j] * kLog2e;
        hv[j] = h0[hrow + n0 + j];
      }
    }
  }
  const float* bm_b = bm + b * sb_b;
  const float* cm_b = cm + b * sc_b;
  const long long seq0 = static_cast<long long>(b) * S;  // row (b, t = 0)

  // one chunk's dt, x, B, C into buffer buf; zeros past S, D and N
  auto stage = [&](int buf, int t0) {
    for (int e = threadIdx.x; e < kT * kCh; e += kThreads) {
      const int t = e / kCh, c = e % kCh;
      const bool ok = t0 + t < S && d0 + c < D;
      const long long idx = ok ? (seq0 + t0 + t) * D + d0 + c : 0;
      cp_async4(&sm.dt[buf][t][c], dt + idx, ok);
      cp_async4(&sm.x[buf][t][c], x + idx, ok);
    }
    for (int e = threadIdx.x; e < kT * kSP; e += kThreads) {
      const int t = e / kSP, n = e % kSP;
      const bool ok = t0 + t < S && n < N;
      cp_async4(&sm.b[buf][t][n], bm_b + (ok ? (t0 + t) * sb_s + n : 0), ok);
      cp_async4(&sm.c[buf][t][n], cm_b + (ok ? (t0 + t) * sc_s + n : 0), ok);
    }
  };

  // chunk k + 1 is requested while chunk k is computed
  const int chunks = (S + kT - 1) / kT;
  const int n_hc = (S + kHcChunk - 1) / kHcChunk;
  if (chunks > 0) stage(0, 0);
  for (int k = 0; k < chunks; ++k) {
    const int buf = k & 1, t0 = k * kT;
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // chunk k is in shared memory for every thread, and every thread is
    // done with chunk k - 1, whose buffers the next request refills
    __syncthreads();
    if (k + 1 < chunks) stage(buf ^ 1, t0 + kT);
    const int len = min(kT, S - t0);
    auto step = [&](int t) {
      const float dtv = sm.dt[buf][t][ch];
      const float xv = sm.x[buf][t][ch];
      float yv = 0.f;
#pragma unroll
      for (int q = 0; q < kSPL; q += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(&sm.b[buf][t][n0 + q]);
        const float4 c4 = *reinterpret_cast<const float4*>(&sm.c[buf][t][n0 + q]);
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          hv[q + j] = fast_exp2(dtv * a2[q + j]) * hv[q + j] + dtv * bv[j] * xv;
          yv += hv[q + j] * cv[j];
        }
      }
      yv = sum_over_lanes(yv, L);
      if (live && n0 == 0) y[(seq0 + t0 + t) * D + d] = yv;
    };
    if constexpr (!kHc) {  // serving
#pragma unroll 4
      for (int t = 0; t < len; ++t) step(t);
    } else {  // training: the state at the start of every kHcChunk steps, for the backward
      for (int t8 = 0; t8 < len; t8 += kHcChunk) {  // t0 is a multiple of kHcChunk
        if (live) {
          float* p = hc + ((static_cast<long long>(b) * n_hc + (t0 + t8) / kHcChunk) * D + d) * N;
#pragma unroll
          for (int q = 0; q < kSPL; q += 4) {
            if (N % 4 == 0) {  // 16-byte aligned: hc is contiguous
              if (n0 + q < N) {
                *reinterpret_cast<float4*>(p + n0 + q) =
                    make_float4(hv[q], hv[q + 1], hv[q + 2], hv[q + 3]);
              }
            } else {
#pragma unroll
              for (int j = q; j < q + 4; ++j) {
                if (n0 + j < N) p[n0 + j] = hv[j];
              }
            }
          }
        }
        const int end = min(len, t8 + kHcChunk);
#pragma unroll 4
        for (int t = t8; t < end; ++t) step(t);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < kSPL; ++j) {
      if (n0 + j < N) h_out[hrow + n0 + j] = hv[j];
    }
  }
}

struct Args {
  const float *dt, *bm, *cm, *x, *a, *h0;
  float *y, *h_out, *hc;
  int B, S, D;
  long long sb_b, sb_s, sc_b, sc_s;
  cudaStream_t stream;
};

template <int N>
cudaError_t launch(int kernel, const Args& g) {
  constexpr int L = lanes_for(N);
  if (kernel == 0) {  // decode
    const dim3 grid((g.D * L + kThreads - 1) / kThreads, g.B);
    const bool vec = N % kSlice == 0 && reinterpret_cast<uintptr_t>(g.a) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(g.h0) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(g.h_out) % 16 == 0;
    // the training path's instances (kHc) are separate: serving's compile as before
    auto kern = vec ? (g.hc ? ssm_decode_kernel<N, true, true>
                            : ssm_decode_kernel<N, true, false>)
                    : (g.hc ? ssm_decode_kernel<N, false, true>
                            : ssm_decode_kernel<N, false, false>);
    kern<<<grid, kThreads, 0, g.stream>>>(g.dt, g.bm, g.cm, g.x, g.a, g.h0, g.y, g.h_out, g.hc,
                                          g.D, g.sb_b, g.sc_b);
  } else {
    const dim3 grid((g.D + Prefill<N>::kCh - 1) / Prefill<N>::kCh, g.B);
    auto kern = g.hc ? ssm_prefill_kernel<N, true> : ssm_prefill_kernel<N, false>;
    kern<<<grid, kThreads, 0, g.stream>>>(g.dt, g.bm, g.cm, g.x, g.a, g.h0, g.y, g.h_out, g.hc,
                                          g.S, g.D, g.sb_b, g.sb_s, g.sc_b, g.sc_s);
  }
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(int, const Args&);

// launch<N> for N = 1 .. kMaxState, indexed by N - 1
constexpr LaunchFn kLaunch[kMaxState] = {
    launch<1>,  launch<2>,  launch<3>,  launch<4>,  launch<5>,  launch<6>,
    launch<7>,  launch<8>,  launch<9>,  launch<10>, launch<11>, launch<12>,
    launch<13>, launch<14>, launch<15>, launch<16>,
};

}  // namespace

// kernel: 0 = decode (S must be 1), 1 = prefill (any S >= 0).
// dt, x, y: contiguous [B, S, D]; a: contiguous [D, N]; h0, h_out:
// contiguous [B, D, N] (h_out may equal h0); bm, cm: [B, S, N] with a unit
// stride on N and element strides (sb_b, sb_s), (sc_b, sc_s) on B and S.
// All float32 on the current device.  1 <= N <= 16, 1 <= B <= 65535,
// D >= 1.  hc, when not null (the training path), receives the state at
// the start of every 8 steps, contiguous [B, ceil(S / 8), D, N] (chunk 0's
// is h0), for the backward (ssm_scan_bwd.cu); serving passes null.
// Launches on `stream`; returns the cudaError_t of the launch (0 =
// success).
extern "C" int da4ml_ssm_scan(int kernel, const float* dt, const float* bm, const float* cm,
                              const float* x, const float* a, const float* h0, float* y,
                              float* h_out, float* hc, int B, int S, int D, int N, long long sb_b,
                              long long sb_s, long long sc_b, long long sc_s, void* stream) {
  if (B <= 0 || B > 65535 || S < 0 || D <= 0 || N < 1 || N > kMaxState ||
      (kernel != 0 && kernel != 1) || (kernel == 0 && S != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args g{dt, bm, cm, x, a, h0, y, h_out, hc, B, S, D, sb_b, sb_s, sc_b, sc_s,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(kLaunch[N - 1](kernel, g));
}

extern "C" const char* da4ml_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
