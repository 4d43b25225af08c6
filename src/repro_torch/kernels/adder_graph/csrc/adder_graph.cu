// Levelized adder-graph (DAIS) executor for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/adder_graph/kernel.py:_adder_graph_kernel
// (launched by adder_graph_pallas).  It computes the same function:
//
//     V = x^T                                   (rows 0 .. n_in-1)
//     per level, for its ops:  V[n_in + op] = (V[a] << sh_a) + sign * (V[b] << sh_b)
//     y[:, j] = sign_j * mask_j * (V[row_j] shifted by shift_j)
//               (left if shift_j >= 0, arithmetic right otherwise)
//
// in int32 with wraparound.  All arithmetic is done on uint32_t, where
// overflow is defined: a left shift of 32 or more gives 0, an arithmetic
// right shift of 32 or more gives the sign fill, and sign * b and * mask
// wrap as XLA's int32 does.
//
// Design.  The TPU kernel baked the level bounds in as static slices and
// held a [n_rows, block_b] value buffer in VMEM.  Here the instruction
// table, the output table and the level starts are runtime device arrays,
// so one compiled kernel serves every table.  A block owns a tile of up to
// 32 samples; nothing passes between blocks.  Inside a block the threads
// walk the (op, sample) pairs of one level, the sample index fastest, and
// __syncthreads() separates the levels.  One sample of the Mixer's largest
// table needs (1024 + 6113) * 4 B = 28.5 KB of values, so V does not fit in
// shared memory for a useful tile; it lives in a global scratch laid out
// [n_rows, batch], where the 32 lanes of a warp read 32 neighbouring
// samples of one row: each load and store is one 128-byte segment.
//
// What bounds it on this card: not bytes and not operations.  At serving
// batches the Mixer's tables need well under 0.01 ms of either (a few MB,
// a few tens of millions of int32 operations), but a table runs for
// 0.02-0.34 ms (chip_smoke.py on an H100 SXM at 700 W; PERF.md).  A batch of
// 256 samples gives the Mixer's head table only 8 blocks of 32 samples for
// 132 SMs, so each thread walks hundreds of (op, sample) pairs one after
// another, each a gather from the global scratch: too few loads are in
// flight to hide their latency.  Launch latency is
// not what bounds it: the profiler's device time for one forward equals the
// per-call times.  What the design does about it: the scratch accesses are
// coalesced (a warp reads one 128-byte segment per row), the tables are read
// through the cache by every block, and one compiled kernel serves every
// table.  More samples per SM in flight (smaller tiles at small batches, V in
// shared memory for small tables), fewer barriers (fused levels) and one CUDA
// graph per forward are the work of a later redesign.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t shl(uint32_t v, int s) {
  return s >= 32 ? 0u : (v << s);
}

__device__ __forceinline__ uint32_t sar(uint32_t v, int s) {
  const int32_t sv = static_cast<int32_t>(v);
  return static_cast<uint32_t>(s >= 32 ? (sv >> 31) : (sv >> s));
}

__global__ void __launch_bounds__(kThreads) adder_graph_kernel(
    const int32_t* __restrict__ x,             // [batch, n_in]
    const int32_t* __restrict__ instr,         // [n_ops, 5]
    const int32_t* __restrict__ outs,          // [n_out, 4]
    const int32_t* __restrict__ level_starts,  // [n_levels + 1]
    int n_levels, int n_in, int n_out, int batch, int tile,
    uint32_t* v,                               // [n_rows, batch] scratch, read and written
    int32_t* __restrict__ y) {                 // [batch, n_out]
  const long long B = batch;
  const int b0 = blockIdx.x * tile;
  const int nb = min(tile, batch - b0);

  for (int p = threadIdx.x; p < n_in * tile; p += kThreads) {
    const int i = p / tile, s = p % tile;
    if (s < nb) v[i * B + b0 + s] = static_cast<uint32_t>(x[(b0 + s) * (long long)n_in + i]);
  }
  __syncthreads();

  for (int level = 0; level < n_levels; ++level) {
    const int lo = level_starts[level], hi = level_starts[level + 1];
    for (int p = threadIdx.x; p < (hi - lo) * tile; p += kThreads) {
      const int op = lo + p / tile, s = p % tile;
      if (s < nb) {
        const int32_t* ins = instr + 5LL * op;
        const long long col = b0 + s;
        const uint32_t a = shl(v[ins[0] * B + col], ins[2]);
        const uint32_t b = shl(v[ins[1] * B + col], ins[3]);
        v[(n_in + op) * B + col] = a + static_cast<uint32_t>(ins[4]) * b;
      }
    }
    __syncthreads();
  }

  for (int p = threadIdx.x; p < n_out * tile; p += kThreads) {
    const int j = p / tile, s = p % tile;
    if (s < nb) {
      const int32_t* o = outs + 4LL * j;
      uint32_t r = v[o[0] * B + b0 + s];
      r = o[1] >= 0 ? shl(r, o[1]) : sar(r, -o[1]);
      r = r * static_cast<uint32_t>(o[2]) * static_cast<uint32_t>(o[3]);
      y[(b0 + s) * (long long)n_out + j] = static_cast<int32_t>(r);
    }
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int da4ml_adder_graph(const int32_t* x, const int32_t* instr, const int32_t* outs,
                                 const int32_t* level_starts, int n_levels, int n_in, int n_out,
                                 int batch, int tile, int32_t* scratch, int32_t* y,
                                 void* stream) {
  if (batch <= 0 || tile <= 0 || tile > 32) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((batch + tile - 1) / tile);
  adder_graph_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, instr, outs, level_starts, n_levels, n_in, n_out, batch, tile,
      reinterpret_cast<uint32_t*>(scratch), y);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* da4ml_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
