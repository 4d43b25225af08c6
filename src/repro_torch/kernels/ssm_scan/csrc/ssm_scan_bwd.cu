// Backward of the Mamba-1 selective scan for NVIDIA Hopper (sm_90a).
//
// The JAX package has no backward kernel: it differentiates the Mamba
// block's inline lax.scan.  The port runs its forward kernel (ssm_scan.cu,
// the port of repro/kernels/ssm_scan/kernel.py:_ssm_kernel) wherever the
// tensors lie on the card, training included, so the gradient through that
// kernel needs a kernel of its own; this is it.  Its plain version is
// selective_scan_bwd_ref (autograd through selective_scan_ref).
//
// The forward, in f32: decay_t = exp(dt_t A), h_t = decay_t * h_{t-1} +
// dt_t * B_t * x_t, y_t = sum_n C_t[n] h_t[n].  Given dy [B, S, D] and
// dh (the gradient of the final state, or none), in reverse time with
// g = dL/dh_t:
//
//     g += dy_t * C_t                           (per channel d, state n)
//     dC_t[n] = sum_d dy_t[d] h_t[d, n]         (over channels: a reduction)
//     dB_t[n] = sum_d g[d, n] dt_t[d] x_t[d]    (over channels: a reduction)
//     dx_t[d] = sum_n g dt_t B_t
//     ddt_t[d] = sum_n g (A decay_t h_{t-1} + B_t x_t)
//     dA[d, n] += g dt_t decay_t h_{t-1}        (over batch and time)
//     g *= decay_t
//
// and dh0 = g at the end.  Two kernels, no atomics, so two launches give
// the same bits:
//
//  1. the scan (one thread per channel and state slice, 1 or 2 lanes per
//     channel as in the forward's prefill kernel; a block holds 256 or 128
//     channels of one batch row).  A forward pass keeps the state at the
//     start of every chunk of kChunk = 8 steps in a scratch [B, chunks, D,
//     N] (at falcon-mamba's B 8, S 128, D 8192, N 16: 67 MB, where all
//     h_t would take 537 MB); the reverse pass then, chunk by chunk,
//     recomputes the chunk's states into registers from its start and
//     walks back through it with the state in registers.  dB_t and dC_t
//     are summed over the warp's channels by shuffles, over the block's
//     warps in shared memory in a fixed order, and written as one partial
//     per block; dA is written as one partial per batch row.
//  2. the reduction: dB and dC sum the blocks' partials, dA the batch
//     rows', each in a fixed order.
//
// What bounds it on this card.  Per (b, t, d) it reads dt, x and dy and
// writes ddt and dx (20 bytes), and per (b, d) h0, dh and dh0 (3 N floats),
// plus the chunk-start states (written once, read once); its exponentials
// are 3 per state update (forward pass, chunk recompute, reverse step).  At
// falcon-mamba's training shape the ~60 MB of inputs and outputs take
// ~18 us at 3.35 TB/s and the 400 M exponentials ~95 us at 16 per SM per
// clock: the special-function unit bounds it.  A simple kernel that is
// right comes first; PERF.md keeps its time beside its bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxState = 16;
constexpr int kChunk = 8;  // steps per chunk: the recomputed states stay in registers

template <int N>
struct Bwd {
  static constexpr int L = N <= 8 ? 1 : 2;       // lanes per channel
  static constexpr int kSPL = (N + L - 1) / L;   // states per lane
  static constexpr int kSP = kSPL * L;           // states per channel, padded
  static constexpr int kCh = kThreads / L;       // channels per block
};

struct Args {
  const float *dt, *bm, *cm, *x, *a, *h0, *dy, *dh;
  float *ddt, *dbm, *dcm, *dx, *da, *dh0;
  float *hc, *part_b, *part_c, *part_a;
  int B, S, D;
  cudaStream_t stream;
};

template <int N>
__global__ void __launch_bounds__(kThreads) ssm_bwd_kernel(Args g) {
  using P = Bwd<N>;
  constexpr int L = P::L, kSPL = P::kSPL, kSP = P::kSP, kCh = P::kCh;
  __shared__ float red_b[kWarps][kChunk][kSP];
  __shared__ float red_c[kWarps][kChunk][kSP];

  const int b = blockIdx.y, blk = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ch = threadIdx.x / L, n0 = (threadIdx.x % L) * kSPL;
  const int d = blk * kCh + ch;
  const bool live = d < g.D;
  const int S = g.S, D = g.D;
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const long long seq0 = static_cast<long long>(b) * S;  // row (b, t = 0)
  const long long hrow = (static_cast<long long>(b) * D + d) * N;
  const float* bm_b = g.bm + seq0 * N;
  const float* cm_b = g.cm + seq0 * N;

  auto ok = [&](int j) { return live && n0 + j < N; };
  float av[kSPL], h[kSPL];
#pragma unroll
  for (int j = 0; j < kSPL; ++j) {
    av[j] = ok(j) ? g.a[static_cast<long long>(d) * N + n0 + j] : 0.f;
    h[j] = ok(j) ? g.h0[hrow + n0 + j] : 0.f;
  }
  // one step of the forward recurrence at time t
  auto step = [&](float (&hv)[kSPL], int t) {
    const float dtv = live ? g.dt[(seq0 + t) * D + d] : 0.f;
    const float xv = live ? g.x[(seq0 + t) * D + d] : 0.f;
#pragma unroll
    for (int j = 0; j < kSPL; ++j) {
      const float bv = ok(j) ? bm_b[static_cast<long long>(t) * N + n0 + j] : 0.f;
      hv[j] = expf(dtv * av[j]) * hv[j] + dtv * bv * xv;
    }
  };
  // the chunk-start states
  auto hc_at = [&](int c) {
    return g.hc + ((static_cast<long long>(b) * n_chunks + c) * D + d) * N + n0;
  };
  for (int c = 0; c < n_chunks; ++c) {
#pragma unroll
    for (int j = 0; j < kSPL; ++j) {
      if (ok(j)) hc_at(c)[j] = h[j];
    }
    const int len = min(kChunk, S - c * kChunk);
    for (int tt = 0; tt < len; ++tt) step(h, c * kChunk + tt);
  }

  float gv[kSPL], dav[kSPL];
#pragma unroll
  for (int j = 0; j < kSPL; ++j) {
    gv[j] = ok(j) && g.dh != nullptr ? g.dh[hrow + n0 + j] : 0.f;
    dav[j] = 0.f;
  }
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk, len = min(kChunk, S - t0);
    float hs[kChunk][kSPL];  // h_{t-1} of each step of the chunk
#pragma unroll
    for (int j = 0; j < kSPL; ++j) h[j] = ok(j) ? hc_at(c)[j] : 0.f;
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      if (tt < len) {
#pragma unroll
        for (int j = 0; j < kSPL; ++j) hs[tt][j] = h[j];
        step(h, t0 + tt);
      }
    }
    // h is now h_t of the chunk's last step
#pragma unroll
    for (int tt = kChunk - 1; tt >= 0; --tt) {
      float sb[kSPL], sc[kSPL];
#pragma unroll
      for (int j = 0; j < kSPL; ++j) sb[j] = sc[j] = 0.f;
      if (tt < len) {
        const long long row = (seq0 + t0 + tt) * D + d;
        const float dtv = live ? g.dt[row] : 0.f;
        const float xv = live ? g.x[row] : 0.f;
        const float dyv = live ? g.dy[row] : 0.f;
        float ddt = 0.f, dxv = 0.f;
#pragma unroll
        for (int j = 0; j < kSPL; ++j) {
          const long long bc = static_cast<long long>(t0 + tt) * N + n0 + j;
          const float bv = ok(j) ? bm_b[bc] : 0.f;
          const float cv = ok(j) ? cm_b[bc] : 0.f;
          gv[j] += dyv * cv;
          sc[j] = dyv * h[j];
          const float decay = expf(dtv * av[j]);
          const float hp = hs[tt][j];
          dav[j] += gv[j] * dtv * decay * hp;
          ddt += gv[j] * (av[j] * decay * hp + bv * xv);
          dxv += gv[j] * dtv * bv;
          sb[j] = gv[j] * dtv * xv;
          gv[j] *= decay;
          h[j] = hp;
        }
        // over the channel's lanes
#pragma unroll
        for (int off = L >> 1; off > 0; off >>= 1) {
          ddt += __shfl_xor_sync(0xffffffffu, ddt, off);
          dxv += __shfl_xor_sync(0xffffffffu, dxv, off);
        }
        if (live && n0 == 0) {
          g.ddt[row] = ddt;
          g.dx[row] = dxv;
        }
      }
      // dB_t and dC_t over the warp's channels (lanes L apart), fixed order;
      // every lane takes part, so the shuffles see a whole warp
#pragma unroll
      for (int j = 0; j < kSPL; ++j) {
#pragma unroll
        for (int off = L; off < 32; off <<= 1) {
          sb[j] += __shfl_xor_sync(0xffffffffu, sb[j], off);
          sc[j] += __shfl_xor_sync(0xffffffffu, sc[j], off);
        }
      }
      if (lane < L) {
#pragma unroll
        for (int j = 0; j < kSPL; ++j) {
          red_b[warp][tt][n0 + j] = sb[j];
          red_c[warp][tt][n0 + j] = sc[j];
        }
      }
    }
    __syncthreads();
    // the block's partial of the chunk: the warps summed in order
    for (int i = threadIdx.x; i < kChunk * kSP; i += kThreads) {
      const int tt = i / kSP, n = i % kSP;
      if (tt < len && n < N) {
        float sb = 0.f, sc = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          sb += red_b[w][tt][n];
          sc += red_c[w][tt][n];
        }
        const long long at =
            ((static_cast<long long>(b) * gridDim.x + blk) * S + t0 + tt) * N + n;
        g.part_b[at] = sb;
        g.part_c[at] = sc;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kSPL; ++j) {
    if (ok(j)) {
      g.dh0[hrow + n0 + j] = gv[j];
      g.part_a[hrow + n0 + j] = dav[j];
    }
  }
}

// dB and dC: the blocks' partials summed in order; dA: the batch rows'.
__global__ void __launch_bounds__(kThreads)
    ssm_bwd_reduce(Args g, int N, int n_blocks) {
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
cudaError_t launch(const Args& g) {
  const int n_blocks = (g.D + Bwd<N>::kCh - 1) / Bwd<N>::kCh;
  ssm_bwd_kernel<N><<<dim3(n_blocks, g.B), kThreads, 0, g.stream>>>(g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(g.B) * g.S * N + static_cast<long long>(g.D) * N;
  ssm_bwd_reduce<<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads, 0,
                   g.stream>>>(g, N, n_blocks);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const Args&);

constexpr LaunchFn kLaunch[kMaxState] = {
    launch<1>,  launch<2>,  launch<3>,  launch<4>,  launch<5>,  launch<6>,
    launch<7>,  launch<8>,  launch<9>,  launch<10>, launch<11>, launch<12>,
    launch<13>, launch<14>, launch<15>, launch<16>,
};

}  // namespace

// The scratch each call needs, in floats: the chunk-start states, the
// per-block partials of dB and dC, the per-batch-row partials of dA.
extern "C" long long da4ml_ssm_scan_bwd_scratch(int B, int S, int D, int N) {
  if (N < 1 || N > kMaxState) return -1;
  const int ch = N <= 8 ? kThreads : kThreads / 2;
  const long long n_blocks = (D + ch - 1) / ch;
  const long long chunks = (S + kChunk - 1) / kChunk;
  return static_cast<long long>(B) * chunks * D * N + 2LL * B * n_blocks * S * N +
         static_cast<long long>(B) * D * N;
}

// All tensors float32, contiguous, on the current device: dt, x, dy, ddt,
// dx [B, S, D]; bm, cm, dbm, dcm [B, S, N]; a, da [D, N]; h0, dh, dh0
// [B, D, N] (dh may be null: a zero gradient of the final state).
// scratch: da4ml_ssm_scan_bwd_scratch(B, S, D, N) floats.  1 <= N <= 16,
// 1 <= B <= 65535, S >= 1, D >= 1.  Launches both kernels on `stream`;
// returns the cudaError_t of the launches (0 = success).
extern "C" int da4ml_ssm_scan_bwd(const float* dt, const float* bm, const float* cm,
                                  const float* x, const float* a, const float* h0,
                                  const float* dy, const float* dh, float* ddt, float* dbm,
                                  float* dcm, float* dx, float* da, float* dh0, float* scratch,
                                  int B, int S, int D, int N, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || D <= 0 || N < 1 || N > kMaxState) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ch = N <= 8 ? kThreads : kThreads / 2;
  const long long n_blocks = (D + ch - 1) / ch;
  const long long chunks = (S + kChunk - 1) / kChunk;
  float* hc = scratch;
  float* part_b = hc + static_cast<long long>(B) * chunks * D * N;
  float* part_c = part_b + B * n_blocks * S * N;
  float* part_a = part_c + B * n_blocks * S * N;
  const Args g{dt, bm, cm, x, a, h0, dy, dh, ddt, dbm, dcm, dx, da, dh0,
               hc, part_b, part_c, part_a, B, S, D, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(kLaunch[N - 1](g));
}

extern "C" const char* da4ml_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
