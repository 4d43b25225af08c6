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
// Optionally an epilogue (the integer executor's elementwise steps that
// follow the table, up to the next table) is applied to each output before
// its one store: for output j of kernel row b, with e = epi[b % rows][j],
//
//     y = max((y << e.shift) + e.bias, floor)       floor: 0 for a ReLU, else INT_MIN
//     y = clamp(y shifted by e.d, lo, hi)            (left if d > 0, arithmetic right else)
//
// in the same int32 wraparound, so it equals those steps run one by one.
// A launch without one runs the kernels' EPI = false instances.
//
// Design.  The TPU kernel held a [n_rows, block_b] value buffer in VMEM.
// Hopper has 227 KB of shared memory per block, too little for one sample
// of the Mixer's head table if every row keeps its own place (7,137 rows,
// 28.5 KB), but not once rows share places: a row is live from the level
// that writes it to the level that last reads it, and the host-side plan
// (slots.py) gives each row a slot that only rows written after its last
// use take again.  The head table then needs 3,278 slots (13.1 KB a
// sample), every Mixer table fits, and two entry points remain:
//
//  * shared (adder_graph_smem_kernel): a block owns a tile of 1 to 32
//    samples and holds their values in dynamic shared memory, laid out
//    [n_slots][tile].  It stages its samples' inputs into slots 0..n_in-1,
//    walks the levels with one __syncthreads() each, and writes y.  An op
//    is one 16-byte instruction (dst, a, b, shifts and sign), read with one
//    vector load; a thread applies it to 1, 2 or 4 neighbouring samples with
//    vector loads and stores of shared memory.  The launch plan (slots.py)
//    grows the tile only while the grid keeps two blocks per SM, so small
//    batches spread over the card (the head table at 256 samples: 256 blocks
//    of one sample and 13 KB) and large ones share each instruction among
//    more samples.
//  * global (adder_graph_global_kernel): for a table whose one sample does
//    not fit a block's shared memory.  V is a global scratch laid out
//    [n_rows, batch], up to 32 samples a block, the 32 lanes of a warp on
//    32 neighbouring samples of a row (one 128-byte segment per access).
//
// The host picks the entry point by that size rule alone; the two compute
// the same bits.
//
// What bounds it on this card: not device memory and not the integer
// units.  At serving batches the Mixer's tables need well under 0.01 ms of
// either (a few MB, a few tens of millions of int32 operations).  Every op
// of every sample is two gathers and a store in shared memory plus its
// share of a 16-byte instruction load through the same L1 path, so the
// SM's shared-memory and L1 throughput (and the bank conflicts of random
// gathers) bounds the large batches, and the chain of 7 to 11 levels, each
// ending in a barrier, with the launch itself, the small ones.  The design
// keeps every gather in shared memory, spreads small batches over the
// SMs, and shares each instruction among up to four samples per thread.
// Unrolling the level loop with the next level's instructions prefetched,
// eight samples per thread, and rows padded against bank conflicts were
// each slower on the card at the Mixer's shapes (PERF.md, section 6).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGlobalThreads = 256;
constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 232448;  // a Hopper block's shared memory, opt-in above 48 KB

__device__ __forceinline__ uint32_t shl(uint32_t v, int s) {
  return s >= 32 ? 0u : (v << s);
}

__device__ __forceinline__ uint32_t sar(uint32_t v, int s) {
  const int32_t sv = static_cast<int32_t>(v);
  return static_cast<uint32_t>(s >= 32 ? (sv >> 31) : (sv >> s));
}

// y[b, j] from the value of its row (or slot) r.
__device__ __forceinline__ int32_t output_value(uint32_t r, int4 o) {
  r = o.y >= 0 ? shl(r, o.y) : sar(r, -o.y);
  r = r * static_cast<uint32_t>(o.z) * static_cast<uint32_t>(o.w);
  return static_cast<int32_t>(r);
}

// The epilogue: a table of rows x n_out entries (bias, shift | d << 8),
// shift in 0..32 and d in -32..32, the shift amounts already saturated as
// PyTorch's shifts saturate; floor, lo and hi apply to every output.
struct Epilogue {
  const int2* table;
  int rows, floor, lo, hi;
};

__device__ __forceinline__ int32_t apply_epilogue(int32_t y, int row, int j, int n_out,
                                                  const Epilogue& ep) {
  const int r = ep.rows == 1 ? 0 : row % ep.rows;
  const int2 e = __ldg(ep.table + static_cast<long long>(r) * n_out + j);
  const int d = e.y >> 8;
  uint32_t u = shl(static_cast<uint32_t>(y), e.y & 0xff) + static_cast<uint32_t>(e.x);
  u = static_cast<uint32_t>(max(static_cast<int32_t>(u), ep.floor));
  u = d > 0 ? shl(u, d) : sar(u, -d);
  return min(max(static_cast<int32_t>(u), ep.lo), ep.hi);
}

// VEC neighbouring samples' values of one slot, moved as one vector.
template <int VEC>
struct Vals {
  uint32_t e[VEC];
};

template <int VEC>
__device__ __forceinline__ Vals<VEC> load_vals(const uint32_t* p) {
  Vals<VEC> r;
  if constexpr (VEC == 4) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    r.e[0] = t.x; r.e[1] = t.y; r.e[2] = t.z; r.e[3] = t.w;
  } else if constexpr (VEC == 2) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    r.e[0] = t.x; r.e[1] = t.y;
  } else {
    r.e[0] = *p;
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void store_vals(uint32_t* p, const Vals<VEC>& r) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(r.e[0], r.e[1], r.e[2], r.e[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(r.e[0], r.e[1]);
  } else {
    *p = r.e[0];
  }
}

// ops[i] = (dst slot, a slot, b slot, sh_a | sh_b << 8 | sign << 16);
// outs[j] = (slot, shift, sign, mask); input i sits in slot i.
template <int VEC, bool EPI>
__global__ void __launch_bounds__(kMaxThreads) adder_graph_smem_kernel(
    const int32_t* __restrict__ x,             // [batch, n_in]
    const int4* __restrict__ ops,              // [n_ops]
    const int4* __restrict__ outs,             // [n_out]
    const int32_t* __restrict__ level_starts,  // [n_levels + 1]
    int n_levels, int n_in, int n_out, int batch, int log2_tile,
    Epilogue ep,                               // read only where EPI
    int32_t* __restrict__ y) {                 // [batch, n_out]
  extern __shared__ __align__(16) uint32_t v[];  // [n_slots][tile]
  constexpr int kLog2Vec = VEC == 4 ? 2 : (VEC == 2 ? 1 : 0);
  const int tile = 1 << log2_tile;
  const int log2_groups = log2_tile - kLog2Vec;  // VEC-sample groups in the tile
  const int b0 = blockIdx.x << log2_tile;
  const int nb = min(tile, batch - b0);

  // stage: neighbouring threads read neighbouring inputs of one sample
  for (int p = threadIdx.x; p < n_in * nb; p += blockDim.x) {
    const int s = p / n_in, i = p - s * n_in;
    v[i * tile + s] = static_cast<uint32_t>(x[(b0 + s) * static_cast<long long>(n_in) + i]);
  }
  __syncthreads();

  // Samples nb .. tile-1 of a ragged last tile hold garbage and compute
  // garbage, which wraps harmlessly and is never written out.
  for (int level = 0; level < n_levels; ++level) {
    const int lo = level_starts[level], hi = level_starts[level + 1];
    const int n = (hi - lo) << log2_groups;
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      const int4 op = __ldg(ops + lo + (p >> log2_groups));
      const int s = (p & ((1 << log2_groups) - 1)) << kLog2Vec;
      const int sh_a = op.w & 0xff, sh_b = (op.w >> 8) & 0xff;
      const uint32_t sign = static_cast<uint32_t>(op.w >> 16);  // sign-extended
      const Vals<VEC> a = load_vals<VEC>(v + op.y * tile + s);
      const Vals<VEC> b = load_vals<VEC>(v + op.z * tile + s);
      Vals<VEC> r;
#pragma unroll
      for (int e = 0; e < VEC; ++e) r.e[e] = shl(a.e[e], sh_a) + sign * shl(b.e[e], sh_b);
      store_vals<VEC>(v + op.x * tile + s, r);
    }
    __syncthreads();
  }

  // neighbouring threads write neighbouring outputs of one sample
  for (int p = threadIdx.x; p < n_out * nb; p += blockDim.x) {
    const int s = p / n_out, j = p - s * n_out;
    const int4 o = __ldg(outs + j);
    int32_t r = output_value(v[o.x * tile + s], o);
    if constexpr (EPI) r = apply_epilogue(r, b0 + s, j, n_out, ep);
    y[(b0 + s) * static_cast<long long>(n_out) + j] = r;
  }
}

template <bool EPI>
__global__ void __launch_bounds__(kGlobalThreads) adder_graph_global_kernel(
    const int32_t* __restrict__ x,             // [batch, n_in]
    const int32_t* __restrict__ instr,         // [n_ops, 5]
    const int4* __restrict__ outs,             // [n_out]: (row, shift, sign, mask)
    const int32_t* __restrict__ level_starts,  // [n_levels + 1]
    int n_levels, int n_in, int n_out, int batch, int tile,
    Epilogue ep,                               // read only where EPI
    uint32_t* v,                               // [n_rows, batch] scratch, read and written
    int32_t* __restrict__ y) {                 // [batch, n_out]
  const long long B = batch;
  const int b0 = blockIdx.x * tile;
  const int nb = min(tile, batch - b0);

  for (int p = threadIdx.x; p < n_in * tile; p += kGlobalThreads) {
    const int i = p / tile, s = p % tile;
    if (s < nb) v[i * B + b0 + s] = static_cast<uint32_t>(x[(b0 + s) * (long long)n_in + i]);
  }
  __syncthreads();

  for (int level = 0; level < n_levels; ++level) {
    const int lo = level_starts[level], hi = level_starts[level + 1];
    for (int p = threadIdx.x; p < (hi - lo) * tile; p += kGlobalThreads) {
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

  for (int p = threadIdx.x; p < n_out * tile; p += kGlobalThreads) {
    const int j = p / tile, s = p % tile;
    if (s < nb) {
      int32_t r = output_value(v[outs[j].x * B + b0 + s], outs[j]);
      if constexpr (EPI) r = apply_epilogue(r, b0 + s, j, n_out, ep);
      y[(b0 + s) * (long long)n_out + j] = r;
    }
  }
}

template <int VEC, bool EPI>
cudaError_t launch_smem(const int32_t* x, const int32_t* ops, const int32_t* outs,
                        const int32_t* level_starts, int n_levels, int n_in, int n_out,
                        int batch, int log2_tile, int threads, size_t smem, const Epilogue& ep,
                        int32_t* y, cudaStream_t stream) {
  static bool opted_in = false;  // the attribute is set once; setting it twice is harmless
  if (smem > 48 * 1024 && !opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        adder_graph_smem_kernel<VEC, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int tile = 1 << log2_tile;
  const dim3 grid((batch + tile - 1) / tile);
  adder_graph_smem_kernel<VEC, EPI><<<grid, threads, smem, stream>>>(
      x, reinterpret_cast<const int4*>(ops), reinterpret_cast<const int4*>(outs), level_starts,
      n_levels, n_in, n_out, batch, log2_tile, ep, y);
  return cudaGetLastError();
}

template <bool EPI>
cudaError_t launch_smem_vec(const int32_t* x, const int32_t* ops, const int32_t* outs,
                            const int32_t* level_starts, int n_levels, int n_in, int n_out,
                            int batch, int log2_tile, int threads, size_t smem,
                            const Epilogue& ep, int32_t* y, cudaStream_t s) {
  switch (log2_tile) {
    case 0:
      return launch_smem<1, EPI>(x, ops, outs, level_starts, n_levels, n_in, n_out, batch,
                                 log2_tile, threads, smem, ep, y, s);
    case 1:
      return launch_smem<2, EPI>(x, ops, outs, level_starts, n_levels, n_in, n_out, batch,
                                 log2_tile, threads, smem, ep, y, s);
    default:
      return launch_smem<4, EPI>(x, ops, outs, level_starts, n_levels, n_in, n_out, batch,
                                 log2_tile, threads, smem, ep, y, s);
  }
}

// The epilogue of the entry points' arguments; valid without one (epi null).
bool make_epilogue(const int32_t* epi, int epi_rows, int floor, int lo, int hi, Epilogue* ep) {
  *ep = Epilogue{reinterpret_cast<const int2*>(epi), epi_rows, floor, lo, hi};
  return epi == nullptr || epi_rows > 0;
}

}  // namespace

// The shared-memory entry point.  ops [n_ops, 4] and outs [n_out, 4] are
// the slot plan's tables (16-byte aligned); tile = 1 << log2_tile samples
// per block (1 to 32); threads per block a multiple of 32, at most 512.
// epi [epi_rows, n_out, 2] (8-byte aligned), floor, lo and hi are the
// epilogue (header); a null epi launches without one.
// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int da4ml_adder_graph_smem(const int32_t* x, const int32_t* ops, const int32_t* outs,
                                      const int32_t* level_starts, int n_levels, int n_in,
                                      int n_out, int batch, int n_slots, int log2_tile,
                                      int threads, const int32_t* epi, int epi_rows, int floor,
                                      int lo, int hi, int32_t* y, void* stream) {
  const size_t smem = static_cast<size_t>(n_slots) * 4u << (log2_tile < 0 ? 0 : log2_tile);
  Epilogue ep;
  if (batch <= 0 || n_slots <= 0 || n_slots < n_in || log2_tile < 0 || log2_tile > 5 ||
      threads <= 0 || threads > kMaxThreads || threads % 32 != 0 || smem > kMaxSmem ||
      !make_epilogue(epi, epi_rows, floor, lo, hi, &ep)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      epi == nullptr
          ? launch_smem_vec<false>(x, ops, outs, level_starts, n_levels, n_in, n_out, batch,
                                   log2_tile, threads, smem, ep, y, s)
          : launch_smem_vec<true>(x, ops, outs, level_starts, n_levels, n_in, n_out, batch,
                                  log2_tile, threads, smem, ep, y, s));
}

// The global-scratch entry point: instr [n_ops, 5] and outs [n_out, 4] are
// the tables themselves; scratch is [n_rows, batch] int32; tile 1 to 32;
// the epilogue as for the shared-memory entry point.
// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int da4ml_adder_graph_global(const int32_t* x, const int32_t* instr,
                                        const int32_t* outs, const int32_t* level_starts,
                                        int n_levels, int n_in, int n_out, int batch, int tile,
                                        const int32_t* epi, int epi_rows, int floor, int lo,
                                        int hi, int32_t* scratch, int32_t* y, void* stream) {
  Epilogue ep;
  if (batch <= 0 || tile <= 0 || tile > 32 || !make_epilogue(epi, epi_rows, floor, lo, hi, &ep)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((batch + tile - 1) / tile);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto o = reinterpret_cast<const int4*>(outs);
  const auto v = reinterpret_cast<uint32_t*>(scratch);
  if (epi == nullptr) {
    adder_graph_global_kernel<false><<<grid, kGlobalThreads, 0, s>>>(
        x, instr, o, level_starts, n_levels, n_in, n_out, batch, tile, ep, v, y);
  } else {
    adder_graph_global_kernel<true><<<grid, kGlobalThreads, 0, s>>>(
        x, instr, o, level_starts, n_levels, n_in, n_out, batch, tile, ep, v, y);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* da4ml_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
