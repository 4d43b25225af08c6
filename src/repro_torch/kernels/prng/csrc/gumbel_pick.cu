// The categorical pick of the LM engine for NVIDIA Hopper (sm_90a): for
// each row b of logits [B, V], the first index of the maximum of
// logits / T + gumbel(key, [B, V], dtype), the noise of element (b, v)
// drawn at flat index b * V + v.
//
// Replaces no TPU kernel: the JAX engine picks a categorical token with
// jax.random.categorical(sub, logits / T) (src/repro/serve/engine.py:60),
// which XLA runs as its threefry, -log(-log(u)), an add and an argmax.
// This kernel gives the same index, with the reference's roundings:
//   - bfloat16: logits / T rounded to bfloat16 (T, a Python float, is
//     rounded to bfloat16 first: a weak type); the noise
//     -bf16(log(-bf16(log(u)))) of 8-bit uniforms (threefry.cuh); the sum
//     rounded to bfloat16;
//   - float32: the quotient and the sum in float32; the noise from 23-bit
//     uniforms;
//   - ties go to the first index (argmax's), a NaN above every number.
//
// Design.  The [B, V] noise is never written: each thread hashes the flat
// index of the logits it reads and keeps its own best (value, index).  A
// row is split over a thread-block cluster of up to 8 blocks (B = 8 rows
// of a decode batch would fill 8 of the 132 SMs with one block a row);
// each block reduces its part (warp shuffles, then shared memory), and
// block 0 of the cluster reads the others' results through distributed
// shared memory and writes the row's index.  In bfloat16 the noise takes
// 128 values: each block fills a table of them (128 threads, two logf
// each) before it reads a logit, so an element costs the hash, a table
// read, a division and an add.
//
// What bounds it on this card: operations.  An element costs about 78
// int32 operations (the hash's 72 among them) against 2 or 4 bytes read,
// and an SM issues 64 int32 lanes a clock; in float32 the two logf run
// on the FP32 lanes and the special-function units beside them.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "threefry.cuh"

namespace cg = cooperative_groups;

namespace {

using da4ml_prng::gumbel_bf16;
using da4ml_prng::gumbel_bf16_mantissa;
using da4ml_prng::gumbel_f32;
using da4ml_prng::round_bf16;
using da4ml_prng::threefry_bits;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 8;  // a portable cluster
constexpr int kPerThread = 4;  // logits a thread reads at least, before a row is split again
constexpr int kNoIndex = 0x7FFFFFFF;

// (a, ia) comes before (b, ib) in argmax's order: a NaN first, then the
// larger value, then the lower index
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an != bn) return an;
  if (!an && a != b) return a > b;
  return ia < ib;
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
    gumbel_pick_kernel(const void* __restrict__ logits, int V, long long row_stride, uint32_t k0,
                       uint32_t k1, float temperature, long long* __restrict__ out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int row = blockIdx.y;
  __shared__ float noise[BF16 ? 128 : 1];
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ float block_v;
  __shared__ int block_i;
  if constexpr (BF16) {
    if (threadIdx.x < 128) noise[threadIdx.x] = gumbel_bf16(threadIdx.x);
    __syncthreads();
  }
  const int chunk = (V + n_split - 1) / n_split;
  const int lo = split * chunk;
  const int hi = min(V, lo + chunk);
  const unsigned long long base = static_cast<unsigned long long>(row) * V;
  float best = -CUDART_INF_F;
  int best_i = kNoIndex;
  for (int v = lo + static_cast<int>(threadIdx.x); v < hi; v += kThreads) {
    const unsigned long long g = base + static_cast<unsigned long long>(v);
    const uint32_t bits =
        threefry_bits(k0, k1, static_cast<uint32_t>(g >> 32), static_cast<uint32_t>(g));
    const long long at = static_cast<long long>(row) * row_stride + v;
    float s;
    if constexpr (BF16) {
      const float x = __bfloat162float(static_cast<const __nv_bfloat16*>(logits)[at]);
      const float scaled = round_bf16(__fdiv_rn(x, temperature));
      s = round_bf16(__fadd_rn(scaled, noise[gumbel_bf16_mantissa(bits)]));
    } else {
      const float x = static_cast<const float*>(logits)[at];
      s = __fadd_rn(__fdiv_rn(x, temperature), gumbel_f32(bits));
    }
    if (before(s, v, best, best_i)) {
      best = s;
      best_i = v;
    }
  }
  // the block's best: within each warp, then across the warps
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xFFFFFFFFu, best, off);
    const int oi = __shfl_down_sync(0xFFFFFFFFu, best_i, off);
    if (before(ov, oi, best, best_i)) {
      best = ov;
      best_i = oi;
    }
  }
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    warp_v[warp] = best;
    warp_i[warp] = best_i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      if (before(warp_v[w], warp_i[w], best, best_i)) {
        best = warp_v[w];
        best_i = warp_i[w];
      }
    }
    block_v = best;
    block_i = best_i;
  }
  // the row's best: block 0 reads the cluster's other blocks' results
  cluster.sync();
  if (split == 0 && threadIdx.x == 0) {
    for (int c = 1; c < n_split; ++c) {
      const float cv = *cluster.map_shared_rank(&block_v, c);
      const int ci = *cluster.map_shared_rank(&block_i, c);
      if (before(cv, ci, best, best_i)) {
        best = cv;
        best_i = ci;
      }
    }
    out[row] = best_i;
  }
  cluster.sync();  // no block leaves while block 0 still reads its shared memory
}

template <bool BF16>
cudaError_t launch(const void* logits, int B, int V, long long row_stride, uint32_t k0,
                   uint32_t k1, float temperature, long long* out, cudaStream_t stream) {
  int splits = (V + kThreads * kPerThread - 1) / (kThreads * kPerThread);
  splits = splits < 1 ? 1 : (splits > kMaxSplits ? kMaxSplits : splits);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, gumbel_pick_kernel<BF16>, logits, V,
                                             row_stride, k0, k1, temperature, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// bf16: 1 for bfloat16 logits, 0 for float32; B rows of V logits, row
// stride row_stride elements (unit stride along V); temperature already
// rounded to the logits' dtype; out: int64 [B].
extern "C" int da4ml_gumbel_pick(int bf16, const void* logits, int B, int V,
                                 long long row_stride, unsigned int k0, unsigned int k1,
                                 float temperature, long long* out, void* stream) {
  if (logits == nullptr || out == nullptr || B < 1 || B > 65535 || V < 1 ||
      (B > 1 && row_stride < V)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? launch<true>(logits, B, V, row_stride, k0, k1, temperature, out, s)
                               : launch<false>(logits, B, V, row_stride, k0, k1, temperature, out,
                                               s));
}

extern "C" const char* da4ml_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
