// GQA flash attention (causal or full) with an online softmax, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:_flash_kernel
// (launched by flash_attention_pallas).  It computes the same function:
//
//     q [B, Hq, Sq, D], k and v [B, Hkv, Sk, D], query head h reads KV head
//     h / (Hq / Hkv); query row i sits at absolute position offset + i;
//     in causal mode key j counts when j <= offset + i, and a masked logit
//     is -1e30 (not -inf), as in the Pallas kernel;
//     out = softmax(scale * q k^T) v, in q's dtype, computed in f32 with a
//     running max m, normaliser l and accumulator acc per row, and written
//     as acc / max(l, 1e-30).
//
// Like the Pallas kernel (and unlike the plain version, attention_ref) it
// scales q before the QK product and keeps p in f32 for the PV product.
// A row that sees no key at all (only possible with a negative offset)
// gives 0 or the mean of the masked values it visited, as the Pallas
// kernel does; attention_ref gives NaN there.  Keys past Sk, the ragged
// edge, are left out entirely, so Sq and Sk need not divide any tile.
//
// Design.  One block of 4 warps per (tile of 16 query rows, query head,
// batch); each warp owns 4 of the rows.  The block walks the keys in tiles
// of 64 (32 at head_dim 128): all 128 threads stage a K and a V tile in
// shared memory as f32, with 16-byte loads where the tensors are 16-byte
// aligned (K rows padded to D + 1 floats, so the 32 lanes reading 32 keys
// hit 32 banks).  Then each warp computes its rows' logits with one key
// per lane (every K value it reads serves 4 rows), updates the running max
// and normaliser with warp shuffles, writes p to shared memory, and
// accumulates p v with one output dim per lane.  Sums are f32 on the CUDA
// cores.  In causal mode the key loop ends at the block's last query
// position: causal prefill visits about half the keys, and decode reads
// only the live prefix of a max_seq cache.  The offset is read from a
// device int32 when the caller passes one, so a decode step never syncs
// the host to learn the cache position.
//
// What bounds it on this card.  At decode (one query row per head, a
// cache of a few hundred keys) the work is reading the live K/V prefix:
// bytes, a fraction of a microsecond per layer at 3.35 TB/s.  At long
// prefill it is the O(S^2 D) products: operations, which the tensor cores
// would run at 989 TFLOP/s in bf16.  This first kernel does neither at
// its bound: the products run on the CUDA cores in f32, the tiles are
// loaded by the threads themselves, not TMA, with no overlap of the next
// tile's loads and this tile's products, and a decode step has only
// B * Hq blocks, in which one warp of four has a live row and no split
// over the keys shares the work.  wgmma for the
// two products, TMA staging and split-K decode are the redesign's work;
// chip_smoke.py measures the kernel against its bound, and PERF.md keeps
// the numbers.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRowsPerWarp = 4;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kRowsPerWarp * kWarps;  // query rows per block
constexpr float kMasked = -1e30f;  // the Pallas kernel's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Eight bf16 or four f32 values from 16 aligned bytes, as f32.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Stage `n_rows` rows of D values, starting at row `row0` of `src` (row
// stride `stride` elements), into `dst` [n_rows][LD] as f32 times `mul`;
// rows at or past `limit` are zeros.  All kThreads threads take part.
template <typename T, int D, int LD>
__device__ __forceinline__ void stage(float* dst, const T* src, long long stride, long long row0,
                                      long long limit, int n_rows, float mul, bool aligned) {
  if (aligned) {
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kPerRow = D / kVec;
    for (int i = threadIdx.x; i < n_rows * kPerRow; i += kThreads) {
      const int r = i / kPerRow, c = (i % kPerRow) * kVec;
      float vals[kVec];
      if (row0 + r < limit) {
        load16(src + (row0 + r) * stride + c, vals);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) vals[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) dst[r * LD + c + e] = vals[e] * mul;
    }
  } else {
    for (int i = threadIdx.x; i < n_rows * D; i += kThreads) {
      const int r = i / D, c = i % D;
      dst[r * LD + c] = row0 + r < limit ? to_f32(src[(row0 + r) * stride + c]) * mul : 0.f;
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Hq, int Hkv, int Sq, int Sk,
    long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss,
    float scale, int causal, const int32_t* __restrict__ offset_dev, int offset_host,
    bool aligned) {
  constexpr int BK = D <= 64 ? 64 : 32;  // keys per tile
  constexpr int KPL = BK / 32;           // keys per lane
  constexpr int DPL = (D + 31) / 32;     // output dims per lane

  __shared__ float qs[kRows][D];
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D];
  __shared__ float ps[kRows][BK];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kRows;
  const int hk = h / (Hq / Hkv);
  const long long offset = offset_dev != nullptr ? *offset_dev : offset_host;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  stage<T, D, D>(&qs[0][0], qb, qss, q0, Sq, kRows, scale, aligned);

  // keys the block needs: all of them, or (causal) up to its last row's position
  long long n_keys = Sk;
  if (causal) {
    const long long hi = offset + min(q0 + kRows, Sq);
    n_keys = hi < 0 ? 0 : (hi < Sk ? hi : Sk);
  }

  const int r0 = warp * kRowsPerWarp;
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
  long long qpos[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
    qpos[r] = offset + q0 + r0 + r;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  }

  for (long long k0 = 0; k0 < n_keys; k0 += BK) {
    __syncthreads();  // q staged; the previous tile's K, V and p are read
    stage<T, D, D + 1>(&ks[0][0], kb, kss, k0, Sk, BK, 1.f, aligned);
    stage<T, D, D>(&vs[0][0], vb, vss, k0, Sk, BK, 1.f, aligned);
    __syncthreads();

    float s[kRowsPerWarp][KPL];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < KPL; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float kd[KPL];
#pragma unroll
      for (int c = 0; c < KPL; ++c) kd[c] = ks[lane + 32 * c][d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float qd = qs[r0 + r][d];
#pragma unroll
        for (int c = 0; c < KPL; ++c) s[r][c] = fmaf(qd, kd[c], s[r][c]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float tile_max = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        const long long j = k0 + lane + 32 * c;
        if (j >= Sk) {
          s[r][c] = -CUDART_INF_F;  // past the ragged edge: not a key
        } else if (causal && j > qpos[r]) {
          s[r][c] = kMasked;
        }
        tile_max = fmaxf(tile_max, s[r][c]);
      }
      const float m_new = fmaxf(m[r], warp_max(tile_max));
      const float alpha = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        const float p = expf(s[r][c] - m_new);
        ps[r0 + r][lane + 32 * c] = p;
        psum += p;
      }
      l[r] = l[r] * alpha + warp_sum(psum);
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[r][e] *= alpha;
    }
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vj[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        const int d = lane + 32 * e;
        vj[e] = d < D ? vs[j][d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float p = ps[r0 + r][j];
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] = fmaf(p, vj[e], acc[r][e]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + r0 + r;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * Hq + h) * Sq + qi) * D;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < D) orow[d] = from_f32<T>(acc[r][e] / den);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                   int Hkv, int Sq, int Sk, const long long* st, float scale, int causal,
                   const int32_t* offset_dev, int offset_host, bool aligned,
                   cudaStream_t stream) {
  const dim3 grid((Sq + kRows - 1) / kRows, Hq, B);
  flash_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Hq, Hkv, Sq, Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], scale, causal, offset_dev, offset_host, aligned);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(int head_dim, const void* q, const void* k, const void* v,
                              void* o, int B, int Hq, int Hkv, int Sq, int Sk,
                              const long long* st, float scale, int causal,
                              const int32_t* offset_dev, int offset_host, bool aligned,
                              cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, st, scale, causal, offset_dev,
                           offset_host, aligned, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Sk, st, scale, causal, offset_dev,
                           offset_host, aligned, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, st, scale, causal, offset_dev,
                           offset_host, aligned, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, st, scale, causal, offset_dev,
                            offset_host, aligned, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: the element strides of the
// batch, head and sequence dims of q, k and v (9 values; the head_dim
// stride must be 1); o is contiguous [B, Hq, Sq, D].  offset_dev, when
// not null, points to the int32 absolute position of q's first row on the
// device; otherwise offset_host is used.  aligned != 0 promises that q, k
// and v start on 16 bytes and that their strides are multiples of 16
// bytes, for 16-byte loads.  Launches on `stream`; returns the cudaError_t
// of the launch (0 = success).
extern "C" int da4ml_flash_attention(int dtype, int head_dim, const void* q, const void* k,
                                     const void* v, void* o, int B, int Hq, int Hkv, int Sq,
                                     int Sk, const long long* strides, float scale,
                                     int causal, const int32_t* offset_dev, int offset_host,
                                     int aligned, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk < 0 || Hq > 65535 ||
      B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(dispatch_head_dim<float>(head_dim, q, k, v, o, B, Hq, Hkv, Sq, Sk,
                                                     strides, scale, causal, offset_dev,
                                                     offset_host, aligned != 0, s));
  }
  if (dtype == 1) {
    return static_cast<int>(dispatch_head_dim<__nv_bfloat16>(
        head_dim, q, k, v, o, B, Hq, Hkv, Sq, Sk, strides, scale, causal, offset_dev,
        offset_host, aligned != 0, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* da4ml_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
