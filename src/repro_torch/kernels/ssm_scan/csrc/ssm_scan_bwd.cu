// Backward of the Mamba-1 selective scan for NVIDIA Hopper (sm_90a).
//
// The JAX package has no backward kernel: it differentiates the Mamba
// block's inline lax.scan.  The port runs its forward kernel (ssm_scan.cu,
// the port of repro/kernels/ssm_scan/kernel.py:_ssm_kernel) wherever the
// tensors lie on the card, training included, so the gradient through that
// kernel needs a kernel of its own; this is it.  Its plain version is
// selective_scan_bwd_ref (autograd through selective_scan_ref).
//
// The forward, in f32: decay_t = 2^(dt_t A log2 e), h_t = decay_t h_{t-1} +
// dt_t B_t x_t, y_t = sum_n C_t[n] h_t[n].  Given dy [B, S, D] and dh (the
// gradient of the final state, or none), in reverse time with g = dL/dh_t
// and u_t = decay_t h_{t-1}:
//
//     g += dy_t * C_t                           (per channel d, state n)
//     dC_t[n] = sum_d dy_t[d] h_t[d, n]         (over channels: a reduction)
//     dB_t[n] = sum_d g[d, n] dt_t[d] x_t[d]    (over channels: a reduction)
//     dx_t[d] = dt_t sum_n g B_t
//     ddt_t[d] = sum_n g (A u_t + B_t x_t)
//     dA[d, n] += g dt_t u_t                    (over batch and time)
//     g *= decay_t
//
// and dh0 = g at the end.
//
// The chunk-start states come from the forward: on the training path the
// prefill kernel (ssm_scan.cu) writes the state at the start of every
// chunk of kChunk = 8 steps into hc [B, ceil(S / 8), D, N] (_SelectiveScan
// allocates and saves it; serving passes null).  At falcon-mamba's training
// shape (B 8, S 128, D 8192, N 16) that is 67 MB held per layer between
// the forward and the backward (remat "full" recomputes one layer's
// forward just before its backward, so one layer's at a time).
//
// Two kernels, no atomics, so two launches give the same bits:
//
//  1. the reverse scan (ssm_bwd_kernel): 1, 2 or 4 lanes per channel (N <=
//     4, 8, 16), each with a slice of 4 states; a block of 256 threads holds
//     256, 128 or 64 channels of one batch row.  Chunks are walked from the
//     last; each chunk's dt, x, dy, B and C come into shared memory by
//     cp.async while the chunk after it is computed (two buffers).  Per
//     chunk, a forward pass from hc recomputes the 8 states, keeping
//     u_t = decay_t h_{t-1} in registers (32 a thread) and staging each
//     channel's dC contribution dy_t h_t in shared memory; the reverse pass
//     walks the 8 steps back with g in registers and stages each channel's
//     dB contribution g dt_t x_t.  Each step's decay is 2^(dt A log2 e) by
//     ex2.approx, A scaled by log2 e once per lane, as the forward prefill:
//     two exponentials per state update (one per pass), no expf.  ddt and
//     dx sum over the channel's lanes by shuffles.  Once per chunk the
//     block sums the staged dB and dC contributions over its channels,
//     each (t, n) by one thread in a fixed order, and writes one partial
//     per block; dA is written as one partial per batch row.
//     __launch_bounds__(256, 2): at most 128 registers a thread, so two
//     blocks fit an SM (~80 KB of shared memory each at N 16).
//  2. the reduction (ssm_bwd_reduce): dB and dC sum the blocks' partials,
//     dA the batch rows', each in a fixed order.
//
// What bounds it on this card.  Per (b, t, d) it reads dt, x and dy and
// writes ddt and dx (20 bytes), and per (b, d) h0, dh and dh0 (3 N floats);
// besides, it reads hc once (N floats per channel per 8 steps).  Per state
// update, two MUFU.EX2 and ~20 FP32 instructions.  At falcon-mamba's
// training shape the ~177 MB of inputs and outputs take ~53 us at
// 3.35 TB/s, hc's 67 MB ~20 us more, the 268 M exponentials ~64 us at 16
// per SM per clock, and the FP32 work about as long: the kernel is near
// balanced between memory, the special-function unit and the FP32 pipes,
// so the design keeps all three fed (2 blocks of 8 warps an SM, the next
// chunk's loads in flight) rather than trading one for another.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxState = 16;
constexpr int kChunk = 8;  // steps per chunk: hc's spacing
constexpr int kSlice = 4;  // states per lane
constexpr float kLog2e = 1.4426950408889634f;

template <int N>
struct Bwd {
  static constexpr int L = N <= 4 ? 1 : (N <= 8 ? 2 : 4);  // lanes per channel
  static constexpr int kNP = L * kSlice;                    // states per channel, padded
  static constexpr int kCh = kThreads / L;                  // channels per block
  static constexpr int kLd = kCh + 1;  // staged rows padded: the sums' reads hit 32 banks
  struct Smem {
    float dt[2][kChunk][kCh];
    float x[2][kChunk][kCh];
    float dy[2][kChunk][kCh];
    alignas(16) float b[2][kChunk][kNP];
    alignas(16) float c[2][kChunk][kNP];
    float red[2][kChunk][kNP][kLd];  // per channel: dB, dC contributions of the chunk
  };
};

struct Args {
  const float *dt, *bm, *cm, *x, *a, *dy, *dh, *hc;
  float *ddt, *dbm, *dcm, *dx, *da, *dh0;
  float *part_b, *part_c, *part_a;
  int B, S, D;
  cudaStream_t stream;
};

__device__ __forceinline__ float fast_exp2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// 4-byte cp.async; src_bytes 0 fills the shared word with zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

template <int N>
__global__ void __launch_bounds__(kThreads, 2) ssm_bwd_kernel(Args g) {
  using P = Bwd<N>;
  constexpr int L = P::L, kNP = P::kNP, kCh = P::kCh;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<typename P::Smem*>(smem_raw);

  const int b = blockIdx.y, blk = blockIdx.x;
  const int ch = threadIdx.x / L, n0 = (threadIdx.x % L) * kSlice;
  const int d0 = blk * kCh, d = d0 + ch;
  const bool live = d < g.D;
  const int S = g.S, D = g.D;
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const long long seq0 = static_cast<long long>(b) * S;  // row (b, t = 0)
  const long long hrow = (static_cast<long long>(b) * D + d) * N;

  auto ok = [&](int j) { return live && n0 + j < N; };
  float a2[kSlice], av[kSlice], gv[kSlice], dav[kSlice], hn[kSlice];
#pragma unroll
  for (int j = 0; j < kSlice; ++j) {
    av[j] = ok(j) ? g.a[static_cast<long long>(d) * N + n0 + j] : 0.f;
    a2[j] = av[j] * kLog2e;
    gv[j] = ok(j) && g.dh != nullptr ? g.dh[hrow + n0 + j] : 0.f;
    dav[j] = 0.f;
  }
  // the state at the start of chunk c (zeros past N and D)
  auto load_hc = [&](int c) {
    const float* p = g.hc + ((static_cast<long long>(b) * n_chunks + c) * D + d) * N + n0;
    if (N % kSlice == 0) {
      const float4 v = live && n0 < N ? *reinterpret_cast<const float4*>(p)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
      hn[0] = v.x, hn[1] = v.y, hn[2] = v.z, hn[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < kSlice; ++j) hn[j] = ok(j) ? p[j] : 0.f;
    }
  };
  // chunk c's dt, x, dy, B, C into buffer buf; zeros past S, D and N
  auto stage = [&](int buf, int c) {
    const int t0 = c * kChunk;
    for (int e = threadIdx.x; e < kChunk * kCh; e += kThreads) {
      const int t = e / kCh, k = e % kCh;
      const bool in = t0 + t < S && d0 + k < D;
      const long long idx = in ? (seq0 + t0 + t) * D + d0 + k : 0;
      cp_async4(&sm.dt[buf][t][k], g.dt + idx, in);
      cp_async4(&sm.x[buf][t][k], g.x + idx, in);
      cp_async4(&sm.dy[buf][t][k], g.dy + idx, in);
    }
    for (int e = threadIdx.x; e < kChunk * kNP; e += kThreads) {
      const int t = e / kNP, n = e % kNP;
      const bool in = t0 + t < S && n < N;
      const long long idx = in ? (seq0 + t0 + t) * N + n : 0;
      cp_async4(&sm.b[buf][t][n], g.bm + idx, in);
      cp_async4(&sm.c[buf][t][n], g.cm + idx, in);
    }
  };

  stage((n_chunks - 1) & 1, n_chunks - 1);
  load_hc(n_chunks - 1);
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int buf = c & 1, t0 = c * kChunk, len = min(kChunk, S - t0);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // chunk c is in shared memory for every thread, and every thread is
    // done with chunk c + 1 (its buffers and the staged sums)
    __syncthreads();
    if (c > 0) stage(buf ^ 1, c - 1);
    float h[kSlice];
#pragma unroll
    for (int j = 0; j < kSlice; ++j) h[j] = hn[j];
    if (c > 0) load_hc(c - 1);

    // forward through the chunk: u_t = decay_t h_{t-1}; dC's contributions
    float u[kChunk][kSlice];
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      if (tt < len) {
        const float dtv = sm.dt[buf][tt][ch], xv = sm.x[buf][tt][ch], dyv = sm.dy[buf][tt][ch];
        const float4 b4 = *reinterpret_cast<const float4*>(&sm.b[buf][tt][n0]);
        const float bv[kSlice] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int j = 0; j < kSlice; ++j) {
          u[tt][j] = fast_exp2(dtv * a2[j]) * h[j];
          h[j] = u[tt][j] + dtv * bv[j] * xv;
          sm.red[1][tt][n0 + j][ch] = dyv * h[j];
        }
      }
    }

    // back through the chunk
#pragma unroll
    for (int tt = kChunk - 1; tt >= 0; --tt) {
      if (tt < len) {
        const float dtv = sm.dt[buf][tt][ch], xv = sm.x[buf][tt][ch], dyv = sm.dy[buf][tt][ch];
        const float4 b4 = *reinterpret_cast<const float4*>(&sm.b[buf][tt][n0]);
        const float4 c4 = *reinterpret_cast<const float4*>(&sm.c[buf][tt][n0]);
        const float bv[kSlice] = {b4.x, b4.y, b4.z, b4.w};
        const float cv[kSlice] = {c4.x, c4.y, c4.z, c4.w};
        float ddt = 0.f, gb = 0.f;
#pragma unroll
        for (int j = 0; j < kSlice; ++j) {
          gv[j] = fmaf(dyv, cv[j], gv[j]);
          const float gd = gv[j] * dtv;
          dav[j] = fmaf(gd, u[tt][j], dav[j]);
          ddt = fmaf(gv[j], fmaf(av[j], u[tt][j], bv[j] * xv), ddt);
          gb = fmaf(gv[j], bv[j], gb);
          sm.red[0][tt][n0 + j][ch] = gd * xv;
          gv[j] *= fast_exp2(dtv * a2[j]);
        }
        // over the channel's lanes
#pragma unroll
        for (int off = L >> 1; off > 0; off >>= 1) {
          ddt += __shfl_xor_sync(0xffffffffu, ddt, off);
          gb += __shfl_xor_sync(0xffffffffu, gb, off);
        }
        if (live && n0 == 0) {
          const long long row = (seq0 + t0 + tt) * D + d;
          g.ddt[row] = ddt;
          g.dx[row] = dtv * gb;
        }
      }
    }
    __syncthreads();  // the chunk's contributions are staged

    // the block's partial of dB (which 0) and dC (which 1) for each step
    // of the chunk and state: its channels summed by one thread, in order
    for (int o = threadIdx.x; o < 2 * kChunk * N; o += kThreads) {
      const int which = o / (kChunk * N), tt = (o / N) % kChunk, n = o % N;
      if (tt >= len) continue;
      const float* r = sm.red[which][tt][n];
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 4
      for (int k = 0; k < kCh; k += 4) {
        s0 += r[k];
        s1 += r[k + 1];
        s2 += r[k + 2];
        s3 += r[k + 3];
      }
      const long long at = ((static_cast<long long>(b) * gridDim.x + blk) * S + t0 + tt) * N + n;
      (which == 0 ? g.part_b : g.part_c)[at] = (s0 + s1) + (s2 + s3);
    }
  }
#pragma unroll
  for (int j = 0; j < kSlice; ++j) {
    if (ok(j)) {
      g.dh0[hrow + n0 + j] = gv[j];
      g.part_a[hrow + n0 + j] = dav[j];
    }
  }
}

// dB and dC: the blocks' partials summed in order; dA: the batch rows'.
__global__ void __launch_bounds__(kThreads) ssm_bwd_reduce(Args g, int N, int n_blocks) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long n_bc = static_cast<long long>(g.B) * g.S * N;
  if (i < n_bc) {
    const long long per_b = static_cast<long long>(g.S) * N;
    const long long b = i / per_b, rest = i % per_b;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < n_blocks; ++k) {
      const long long at = (b * n_blocks + k) * per_b + rest;
      sb += g.part_b[at];
      sc += g.part_c[at];
    }
    g.dbm[i] = sb;
    g.dcm[i] = sc;
  } else if (i < n_bc + static_cast<long long>(g.D) * N) {
    const long long dn = i - n_bc;
    float s = 0.f;
    for (int b = 0; b < g.B; ++b) s += g.part_a[static_cast<long long>(b) * g.D * N + dn];
    g.da[dn] = s;
  }
}

template <int N>
cudaError_t launch(const Args& g, int n_blocks) {
  using P = Bwd<N>;
  constexpr int kBytes = sizeof(typename P::Smem);
  static bool opted = false;
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssm_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return err;
    opted = true;
  }
  if (n_blocks != (g.D + P::kCh - 1) / P::kCh) return cudaErrorInvalidValue;
  ssm_bwd_kernel<N><<<dim3(n_blocks, g.B), kThreads, kBytes, g.stream>>>(g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(g.B) * g.S * N + static_cast<long long>(g.D) * N;
  ssm_bwd_reduce<<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads, 0,
                   g.stream>>>(g, N, n_blocks);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const Args&, int);

constexpr LaunchFn kLaunch[kMaxState] = {
    launch<1>,  launch<2>,  launch<3>,  launch<4>,  launch<5>,  launch<6>,
    launch<7>,  launch<8>,  launch<9>,  launch<10>, launch<11>, launch<12>,
    launch<13>, launch<14>, launch<15>, launch<16>,
};

}  // namespace

// All tensors float32, contiguous, on the current device: dt, x, dy, ddt,
// dx [B, S, D]; bm, cm, dbm, dcm [B, S, N]; a, da [D, N]; dh, dh0
// [B, D, N] (dh may be null: a zero gradient of the final state); hc
// [B, ceil(S / 8), D, N], the forward's chunk-start states (chunk 0's is
// h0).  part_b,
// part_c: scratch [B, n_blocks, S, N]; part_a: scratch [B, D, N].
// n_blocks: the blocks of a batch row (scan_bwd_plan in kernel.py:
// ceil(D / channels per block)), checked here.  1 <= N <= 16,
// 1 <= B <= 65535, S >= 1, D >= 1.  Launches both kernels on `stream`;
// returns the cudaError_t of the launches (0 = success).
extern "C" int da4ml_ssm_scan_bwd(const float* dt, const float* bm, const float* cm,
                                  const float* x, const float* a, const float* dy,
                                  const float* dh, const float* hc, float* ddt, float* dbm,
                                  float* dcm, float* dx, float* da, float* dh0, float* part_b,
                                  float* part_c, float* part_a, int B, int S, int D, int N,
                                  int n_blocks, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || D <= 0 || N < 1 || N > kMaxState || n_blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args g{dt, bm, cm, x, a, dy, dh, hc, ddt, dbm, dcm, dx, da, dh0,
               part_b, part_c, part_a, B, S, D, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(kLaunch[N - 1](g, n_blocks));
}

extern "C" const char* da4ml_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
