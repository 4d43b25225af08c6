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
// A row that sees no key at all (only possible with a negative offset)
// gives 0 or the mean of the masked values it visited, as the Pallas
// kernel does; attention_ref gives NaN there.  Keys past Sk, the ragged
// edge, are left out entirely, so Sq and Sk need not divide any tile.  The
// offset is read from a device int32 when the caller passes one, so a
// decode step never syncs the host, and no launch depends on its value.
//
// Three kernels; the host picks one by shape and dtype (kernel.py,
// flash_plan):
//
//  * decode (flash_decode_kernel), when the Hq / Hkv query heads of a GQA
//    group times Sq make at most 16 rows, in f32 or bf16.  One cluster of
//    S blocks (S = 1..8) per (batch, KV head).  The group's rows are packed
//    into one block, so each K/V byte is read once per group, not once per
//    query head.  The live keys (all of them, or in causal mode those up to
//    the last row's position, read on the device) are split evenly across
//    the S blocks of the cluster; a split with no live key loads nothing.
//    A block stages its K/V in shared memory in the input dtype with
//    16-byte cp.async, 128 keys at a time, and each of its 4 warps takes
//    32 of them, one key per lane, keeping its own (m, l, acc) for every
//    row.  The warps' partials are merged in shared memory, then the
//    cluster's blocks merge theirs through distributed shared memory
//    (Hopper's thread block clusters), each block writing a share of the
//    output: one launch, no scratch in device memory.  S is chosen from
//    the shapes alone: the largest that keeps B * Hkv * S blocks within
//    the card's SMs and 32 cached keys per split.
//  * tensor-core prefill (flash_mma_kernel), bf16.  One block of 4 warps
//    per 64 packed rows (query position major, head of the group minor) of
//    a (batch, KV head); each warp owns 16 rows.  QK^T and PV run on the
//    tensor cores as mma.sync.m16n8k16 with f32 accumulation: Q and K
//    fragments by 32-bit shared loads, V fragments by ldmatrix.trans.  K/V
//    tiles of 128 keys (smollm-135m's whole prompt in one) come through a
//    two-stage cp.async ring, K and V in separate copy groups, so QK^T
//    waits only for K and the next tile's loads overlap this tile's
//    products.  The logits are scaled in f32 after the product (in base 2,
//    for exp2), and p is rounded to bf16 for the PV product (the mma takes
//    bf16 operands), as attention_ref does; the Pallas kernel scales q
//    first and keeps p in f32.  The normaliser l sums p in f32.  A warp
//    skips the key tiles past its rows' last position.
//  * CUDA-core (flash_simt_kernel), f32 outside decode: one block of 4
//    warps per 16 query rows of one query head; K and V staged in shared
//    memory as f32, products in f32 on the CUDA cores (no TF32), q scaled
//    before the QK product and p kept in f32 as in the Pallas kernel.
//
// What bounds it on this card.  At decode (one query row per head, a
// cache of a few hundred keys) the work is reading the live K/V prefix:
// bytes, a fraction of a microsecond per layer at 3.35 TB/s, so latency
// bounds the kernel: the design puts all of a split's loads in flight at
// once and spreads the splits over the SMs.  At prefill it is the
// O(Sq Sk D) products, which at smollm-135m's 128 tokens take well under a
// microsecond at the tensor cores' rate either way: latency and
// parallelism bound it again, hence the small mma.sync tiles and the
// overlap of loads with products, not wgmma's 64-row warpgroup tiles.
//
// Head dims.  Each kernel is compiled for D = 16, 32, 64, 80, 112 and 128
// (80: stablelm-3b, 112: kimi-k2; the others the configs' powers of two).
// Nothing assumes a power of two: every D is a multiple of 16, so the
// m16n8k16 tiles divide it (D / 16 k-steps, D / 8 output tiles, taken in
// pairs by ldmatrix.x4); a row is D / 8 (bf16) or D / 4 (f32) 16-byte
// vectors, which the staging loops spread over all threads whatever
// their count; every padded row stride (D + 16 bytes) stays a multiple
// of 16 bytes and maps the 8 rows of a fragment load, or of a quarter
// warp's 16-byte loads, to distinct banks; a lane's share of the output
// dims (D / 32 rounded up) masks the dims past D.  At D = 112 the decode
// kernel's f32 tile takes 131,200 bytes of shared memory and the bf16
// prefill kernel 138,240, both within a block's 227 KB.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

namespace cg = cooperative_groups;

constexpr float kMasked = -1e30f;  // the Pallas kernel's NEG_INF
constexpr int kMaxSmem = 232448;   // a Hopper block's shared memory, opt-in above 48 KB

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

// Eight bf16 or four f32 values from 16 aligned bytes (global or shared), as f32.
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (src is
// then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + n_rows) of a strided [*, D] tensor into dst
// [n_rows][LD] in the input dtype; rows at or past `limit` are zeros.  With
// `aligned`, 16-byte cp.async (the caller commits and waits); otherwise
// element loads and stores.  Threads tid = 0 .. nthreads-1 take part.
template <typename T, int D, int LD>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, long long stride,
                                           long long row0, long long limit, int n_rows,
                                           bool aligned, int tid, int nthreads) {
  if (aligned) {
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kPerRow = D / kVec;
    for (int i = tid; i < n_rows * kPerRow; i += nthreads) {
      const int r = i / kPerRow, c = (i % kPerRow) * kVec;
      const bool ok = row0 + r < limit;
      cp_async16(dst + r * LD + c, ok ? src + (row0 + r) * stride + c : src, ok);
    }
  } else {
    for (int i = tid; i < n_rows * D; i += nthreads) {
      const int r = i / D, c = i % D;
      dst[r * LD + c] = from_f32<T>(row0 + r < limit ? to_f32(src[(row0 + r) * stride + c]) : 0.f);
    }
  }
}

// ---------------------------------------------------------------------
// decode: GQA-packed rows, keys split across the warps and a cluster
// ---------------------------------------------------------------------
constexpr int kDecWarps = 4;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecKeys = 32 * kDecWarps;  // keys staged per tile: one per lane

template <typename T, int D, int ROWS>
struct DecLayout {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kLdK = D + kVec;  // K rows padded by 16 bytes: lanes on 32 rows spread over the banks
  static constexpr int kLdP = D + 2;     // a partial: m, l, acc[D]
  static constexpr int kQBytes = ROWS * D * 4;
  static constexpr int kKVBytes = kDecKeys * (kLdK + D) * sizeof(T);
  static constexpr int kPartBytes = kDecWarps * ROWS * kLdP * 4;  // reuses the K/V space
  static constexpr int kMidBytes = kKVBytes > kPartBytes ? kKVBytes : kPartBytes;
  static constexpr int kBlkBytes = ROWS * kLdP * 4;
  static constexpr int kBytes = kQBytes + kMidBytes + kBlkBytes;
};

template <typename T, int D, int ROWS>
__global__ void __launch_bounds__(kDecThreads) flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Hq, int Hkv, int Sq, int Sk,
    long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss,
    float scale, int causal, const int32_t* __restrict__ offset_dev, int offset_host,
    bool aligned) {
  using L = DecLayout<T, D, ROWS>;
  constexpr int DPL = (D + 31) / 32;  // output dims per lane
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);                        // [ROWS][D], times scale
  T* ks = reinterpret_cast<T*>(smem + L::kQBytes);                   // [kDecKeys][kLdK]
  T* vs = ks + kDecKeys * L::kLdK;                                   // [kDecKeys][D]
  float* part = reinterpret_cast<float*>(smem + L::kQBytes);         // [warps][ROWS][kLdP]
  float* blk = reinterpret_cast<float*>(smem + L::kQBytes + L::kMidBytes);  // [ROWS][kLdP]

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int G = Hq / Hkv, R = G * Sq;  // packed row r: query head hk * G + r % G, position r / G
  const long long offset = offset_dev != nullptr ? *offset_dev : offset_host;

  long long n_keys = Sk;
  if (causal) {
    const long long hi = offset + Sq;
    n_keys = hi < 0 ? 0 : (hi < Sk ? hi : Sk);
  }
  const long long chunk = (n_keys + n_split - 1) / n_split;
  const long long k_lo = min(n_keys, split * chunk), k_hi = min(n_keys, k_lo + chunk);

  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
  for (int i = tid; i < ROWS * D; i += kDecThreads) {
    const int r = i / D, d = i % D;
    float val = 0.f;
    if (r < R) {
      val = to_f32(q[b * qsb + (hk * G + r % G) * qsh + (r / G) * qss + d]) * scale;
    }
    qs[i] = val;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  }

  for (long long t0 = k_lo; t0 < k_hi; t0 += kDecKeys) {
    __syncthreads();  // q staged; the previous tile's K and V are read
    stage_rows<T, D, L::kLdK>(ks, kb, kss, t0, k_hi, kDecKeys, aligned, tid, kDecThreads);
    stage_rows<T, D, D>(vs, vb, vss, t0, k_hi, kDecKeys, aligned, tid, kDecThreads);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (t0 + warp * 32 >= k_hi) continue;  // no live key for this warp in the tile

    const int kr = warp * 32 + lane;  // this lane's key in the tile
    const long long j = t0 + kr;
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
#pragma unroll
    for (int c = 0; c < D; c += L::kVec) {
      float kv[L::kVec];
      load16(ks + kr * L::kLdK + c, kv);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
#pragma unroll
        for (int e = 0; e < L::kVec; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qs + r * D + c + e);
          s[r] = fmaf(qv.x, kv[e], s[r]);
          s[r] = fmaf(qv.y, kv[e + 1], s[r]);
          s[r] = fmaf(qv.z, kv[e + 2], s[r]);
          s[r] = fmaf(qv.w, kv[e + 3], s[r]);
        }
      }
    }

    float p[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= R) {  // uniform: rows past the group's are not computed
        p[r] = 0.f;
        continue;
      }
      float sr = s[r];
      if (j >= k_hi) {
        sr = -CUDART_INF_F;  // not a key of this split
      } else if (causal && j > offset + r / G) {
        sr = kMasked;
      }
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float alpha = expf(m[r] - m_new);
      p[r] = expf(sr - m_new);
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[r][e] *= alpha;
    }

#pragma unroll 4
    for (int jj = 0; jj < 32; ++jj) {
      float vj[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        const int d = lane + 32 * e;
        vj[e] = d < D ? to_f32(vs[(warp * 32 + jj) * D + d]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], jj);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] = fmaf(pj, vj[e], acc[r][e]);
      }
    }
  }

  // merge the warps' partials in shared memory (over the K/V space)
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float* pr = part + (warp * ROWS + r) * L::kLdP;
    if (lane == 0) {
      pr[0] = m[r];
      pr[1] = l[r];
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < D) pr[2 + d] = acc[r][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < R * D; i += kDecThreads) {
    const int r = i / D, d = i % D;
    float mx = kMasked;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, part[(w * ROWS + r) * L::kLdP]);
    float sum_l = 0.f, sum_a = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float* pr = part + (w * ROWS + r) * L::kLdP;
      const float wt = expf(pr[0] - mx);
      sum_l += pr[1] * wt;
      sum_a += pr[2 + d] * wt;
    }
    blk[r * L::kLdP + 2 + d] = sum_a;
    if (d == 0) {
      blk[r * L::kLdP] = mx;
      blk[r * L::kLdP + 1] = sum_l;
    }
  }

  // merge the cluster's block partials through distributed shared memory;
  // each block writes every n_split-th output element
  cluster.sync();
  for (int i = split * kDecThreads + tid; i < R * D; i += n_split * kDecThreads) {
    const int r = i / D, d = i % D;
    float mx = kMasked;
    for (int c = 0; c < n_split; ++c) {
      mx = fmaxf(mx, cluster.map_shared_rank(blk, c)[r * L::kLdP]);
    }
    float sum_l = 0.f, sum_a = 0.f;
    for (int c = 0; c < n_split; ++c) {
      const float* pr = cluster.map_shared_rank(blk, c) + r * L::kLdP;
      const float wt = expf(pr[0] - mx);
      sum_l += pr[1] * wt;
      sum_a += pr[2 + d] * wt;
    }
    const int h = hk * G + r % G, qi = r / G;
    o[((static_cast<long long>(b) * Hq + h) * Sq + qi) * D + d] =
        from_f32<T>(sum_a / fmaxf(sum_l, 1e-30f));
  }
  cluster.sync();  // no block leaves while another still reads its shared memory
}

// ---------------------------------------------------------------------
// prefill on the tensor cores (bf16)
// ---------------------------------------------------------------------
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16 * kMmaWarps;  // packed rows per block
constexpr int kMmaKeys = 128;             // keys per tile

template <int D>
struct MmaLayout {
  static constexpr int kLd = D + 8;  // bf16 rows padded by 16 bytes: fragment loads hit 32 banks
  static constexpr int kQElems = kMmaRows * kLd;
  static constexpr int kTileElems = kMmaKeys * kLd;
  static constexpr int kBytes = (kQElems + 4 * kTileElems) * 2;  // Q, K[2], V[2]
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Hq, int Hkv,
    int Sq, int Sk, long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss, float scale, int causal,
    const int32_t* __restrict__ offset_dev, int offset_host, bool aligned) {
  using L = MmaLayout<D>;
  constexpr int kLd = L::kLd;
  constexpr int NT = kMmaKeys / 8;  // n8 tiles of the logits
  constexpr int DT = D / 8;         // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [kMmaRows][kLd]
  __nv_bfloat16* ks = qs + L::kQElems;                         // [2][kMmaKeys][kLd]
  __nv_bfloat16* vs = ks + 2 * L::kTileElems;                  // [2][kMmaKeys][kLd]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane >> 2, tig = lane & 3;  // mma fragment group and thread in group
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, R = G * Sq;
  const int r0 = blockIdx.x * kMmaRows;
  const long long offset = offset_dev != nullptr ? *offset_dev : offset_host;

  // keys the block needs, and the last position among this warp's rows
  const int last_row = min(R, r0 + kMmaRows) - 1;
  long long n_keys = Sk;
  if (causal) {
    const long long hi = offset + last_row / G + 1;
    n_keys = hi < 0 ? 0 : (hi < Sk ? hi : Sk);
  }
  const long long warp_last = offset + min(R - 1, r0 + warp * 16 + 15) / G;
  const int ra = r0 + warp * 16 + grp, rb = ra + 8;  // this thread's two rows
  const long long pos_a = ra < R ? offset + ra / G : (1LL << 62);
  const long long pos_b = rb < R ? offset + rb / G : (1LL << 62);

  const __nv_bfloat16* kb = k + b * ksb + hk * ksh;
  const __nv_bfloat16* vb = v + b * vsb + hk * vsh;

  // Q: packed rows, zeros past R
  {
    constexpr int kPerRow = D / 8;
    for (int i = tid; i < kMmaRows * (aligned ? kPerRow : D); i += kMmaThreads) {
      const int r = aligned ? i / kPerRow : i / D;
      const int c = aligned ? (i % kPerRow) * 8 : i % D;
      const int row = r0 + r;
      const bool ok = row < R;
      const __nv_bfloat16* src =
          ok ? q + b * qsb + (hk * G + row % G) * qsh + (row / G) * qss + c : q;
      if (aligned) {
        cp_async16(qs + r * kLd + c, src, ok);
      } else {
        qs[r * kLd + c] = ok ? *src : __float2bfloat16(0.f);
      }
    }
  }
  // copy groups: Q with K of tile 0, then V of tile 0, then K and V of each
  // next tile, so QK^T waits only for K and the next tile's copies overlap
  // this tile's products
  const int n_tiles = static_cast<int>((n_keys + kMmaKeys - 1) / kMmaKeys);
  if (n_tiles > 0) {
    stage_rows<__nv_bfloat16, D, kLd>(ks, kb, kss, 0, Sk, kMmaKeys, aligned, tid, kMmaThreads);
  }
  cp_async_commit();
  if (n_tiles > 0) {
    stage_rows<__nv_bfloat16, D, kLd>(vs, vb, vss, 0, Sk, kMmaKeys, aligned, tid, kMmaThreads);
  }
  cp_async_commit();
  const float scale_log2 = scale * 1.44269504088896341f;  // logits in base 2: p = 2^(x - m)

  float acc[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  float m_a = kMasked, m_b = kMasked, l_a = 0.f, l_b = 0.f;  // l: this thread's share

  for (int t = 0; t < n_tiles; ++t) {
    const long long t0 = static_cast<long long>(t) * kMmaKeys;
    const bool more = t + 1 < n_tiles;
    if (more) {
      const int nb = (t + 1) & 1;
      stage_rows<__nv_bfloat16, D, kLd>(ks + nb * L::kTileElems, kb, kss, t0 + kMmaKeys, Sk,
                                        kMmaKeys, aligned, tid, kMmaThreads);
      cp_async_commit();
      stage_rows<__nv_bfloat16, D, kLd>(vs + nb * L::kTileElems, vb, vss, t0 + kMmaKeys, Sk,
                                        kMmaKeys, aligned, tid, kMmaThreads);
      cp_async_commit();
      cp_async_wait<3>();  // this tile's K (and Q) have landed
    } else {
      cp_async_wait<1>();
    }
    __syncthreads();

    // else every key of the tile is past this warp's rows
    const bool active = !causal || t0 <= warp_last;
    const __nv_bfloat16* kt = ks + (t & 1) * L::kTileElems;
    const __nv_bfloat16* vt = vs + (t & 1) * L::kTileElems;
    float s[NT][4];
    if (active) {
      // S = Q K^T for this warp's 16 rows and the tile's 64 keys
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* qa = qs + (warp * 16 + grp) * kLd + kk * 16 + tig * 2;
        const uint32_t a[4] = {
            *reinterpret_cast<const uint32_t*>(qa),
            *reinterpret_cast<const uint32_t*>(qa + 8 * kLd),
            *reinterpret_cast<const uint32_t*>(qa + 8),
            *reinterpret_cast<const uint32_t*>(qa + 8 * kLd + 8),
        };
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const __nv_bfloat16* kp = kt + (n * 8 + grp) * kLd + kk * 16 + tig * 2;
          mma_bf16(s[n], a, *reinterpret_cast<const uint32_t*>(kp),
                   *reinterpret_cast<const uint32_t*>(kp + 8));
        }
      }

      // scale, mask, and the online softmax of rows a (s[.][0..1]) and b (s[.][2..3])
      float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long long j = t0 + n * 8 + tig * 2 + e;
          float xa = s[n][e] * scale_log2, xb = s[n][2 + e] * scale_log2;
          if (j >= Sk) {
            xa = xb = -CUDART_INF_F;  // past the ragged edge: not a key
          } else if (causal) {
            if (j > pos_a) xa = kMasked;
            if (j > pos_b) xb = kMasked;
          }
          s[n][e] = xa;
          s[n][2 + e] = xb;
          mx_a = fmaxf(mx_a, xa);
          mx_b = fmaxf(mx_b, xb);
        }
      }
      const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
      const float alpha_a = exp2f(m_a - mn_a), alpha_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[n][0] = exp2f(s[n][0] - m_a);
        s[n][1] = exp2f(s[n][1] - m_a);
        s[n][2] = exp2f(s[n][2] - m_b);
        s[n][3] = exp2f(s[n][3] - m_b);
        ps_a += s[n][0] + s[n][1];
        ps_b += s[n][2] + s[n][3];
      }
      l_a = l_a * alpha_a + ps_a;
      l_b = l_b * alpha_b + ps_b;
#pragma unroll
      for (int t2 = 0; t2 < DT; ++t2) {
        acc[t2][0] *= alpha_a;
        acc[t2][1] *= alpha_a;
        acc[t2][2] *= alpha_b;
        acc[t2][3] *= alpha_b;
      }
    }
    if (more) {
      cp_async_wait<2>();  // this tile's V has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (active) {
      // O += P V: the logits' accumulator layout is the A fragment's
#pragma unroll
      for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
        const uint32_t a[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
        };
#pragma unroll
        for (int dn = 0; dn < DT; dn += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vt + (kk * 16 + (lane & 15)) * kLd + dn * 8 + (lane >> 4) * 8);
          mma_bf16(acc[dn], a, bv[0], bv[1]);
          mma_bf16(acc[dn + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // this tile's buffers are read before the next loads reuse them
  }
  cp_async_wait<0>();  // with no key tile, Q's copies are still in flight

  // out = acc / l for rows a and b
  const float inv_a = 1.f / fmaxf(quad_sum(l_a), 1e-30f);
  const float inv_b = 1.f / fmaxf(quad_sum(l_b), 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half == 0 ? ra : rb;
    if (row >= R) continue;
    const float inv = half == 0 ? inv_a : inv_b;
    const int h = hk * G + row % G, qi = row / G;
    __nv_bfloat16* orow = o + ((static_cast<long long>(b) * Hq + h) * Sq + qi) * D;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      const __nv_bfloat162 val = __floats2bfloat162_rn(acc[dn][2 * half] * inv,
                                                       acc[dn][2 * half + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(orow + dn * 8 + tig * 2) = val;
    }
  }
}

// ---------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------
constexpr int kRowsPerWarp = 4;
constexpr int kSimtWarps = 4;
constexpr int kSimtThreads = 32 * kSimtWarps;
constexpr int kSimtRows = kRowsPerWarp * kSimtWarps;  // query rows per block

// Stage `n_rows` rows of D values into `dst` [n_rows][LD] as f32 times
// `mul`; rows at or past `limit` are zeros.  All kSimtThreads threads take
// part.
template <int D, int LD>
__device__ __forceinline__ void stage_f32(float* dst, const float* src, long long stride,
                                          long long row0, long long limit, int n_rows,
                                          float mul, bool aligned) {
  if (aligned) {
    constexpr int kPerRow = D / 4;
    for (int i = threadIdx.x; i < n_rows * kPerRow; i += kSimtThreads) {
      const int r = i / kPerRow, c = (i % kPerRow) * 4;
      float vals[4] = {0.f, 0.f, 0.f, 0.f};
      if (row0 + r < limit) load16(src + (row0 + r) * stride + c, vals);
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[r * LD + c + e] = vals[e] * mul;
    }
  } else {
    for (int i = threadIdx.x; i < n_rows * D; i += kSimtThreads) {
      const int r = i / D, c = i % D;
      dst[r * LD + c] = row0 + r < limit ? src[(row0 + r) * stride + c] * mul : 0.f;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kSimtThreads) flash_simt_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, int Hq, int Hkv, int Sq, int Sk,
    long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss,
    float scale, int causal, const int32_t* __restrict__ offset_dev, int offset_host,
    bool aligned) {
  constexpr int BK = D <= 64 ? 64 : 32;  // keys per tile
  constexpr int KPL = BK / 32;           // keys per lane
  constexpr int DPL = (D + 31) / 32;     // output dims per lane

  __shared__ float qs[kSimtRows][D];
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D];
  __shared__ float ps[kSimtRows][BK];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kSimtRows;
  const int hk = h / (Hq / Hkv);
  const long long offset = offset_dev != nullptr ? *offset_dev : offset_host;

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;

  stage_f32<D, D>(&qs[0][0], qb, qss, q0, Sq, kSimtRows, scale, aligned);

  // keys the block needs: all of them, or (causal) up to its last row's position
  long long n_keys = Sk;
  if (causal) {
    const long long hi = offset + min(q0 + kSimtRows, Sq);
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
    stage_f32<D, D + 1>(&ks[0][0], kb, kss, k0, Sk, BK, 1.f, aligned);
    stage_f32<D, D>(&vs[0][0], vb, vss, k0, Sk, BK, 1.f, aligned);
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
    float* orow = o + ((static_cast<long long>(b) * Hq + h) * Sq + qi) * D;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < D) orow[d] = acc[r][e] / den;
    }
  }
}

// ---------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------
struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Hq, Hkv, Sq, Sk;
  const long long* st;
  float scale;
  int causal;
  const int32_t* offset_dev;
  int offset_host;
  bool aligned;
  int splits;
  cudaStream_t stream;
};

// Opt a kernel in to `bytes` of dynamic shared memory, once.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes, bool& done) {
  if (bytes <= 48 * 1024 || done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

template <typename T, int D, int ROWS>
cudaError_t launch_decode(const Args& a) {
  auto kernel = flash_decode_kernel<T, D, ROWS>;
  constexpr int kBytes = DecLayout<T, D, ROWS>::kBytes;
  static_assert(kBytes <= kMaxSmem, "decode tile exceeds shared memory");
  static bool opted = false;
  cudaError_t err = opt_in(kernel, kBytes, opted);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.B * a.Hkv, 1);
  cfg.blockDim = dim3(kDecThreads, 1, 1);
  cfg.dynamicSmemBytes = kBytes;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const long long* st = a.st;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                           static_cast<const T*>(a.v), static_cast<T*>(a.o), a.Hq, a.Hkv, a.Sq,
                           a.Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
                           a.scale, a.causal, a.offset_dev, a.offset_host, a.aligned);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const Args& a) {
  auto kernel = flash_mma_kernel<D>;
  constexpr int kBytes = MmaLayout<D>::kBytes;
  static bool opted = false;
  const cudaError_t err = opt_in(kernel, kBytes, opted);
  if (err != cudaSuccess) return err;
  const int G = a.Hq / a.Hkv;
  const dim3 grid((G * a.Sq + kMmaRows - 1) / kMmaRows, a.Hkv, a.B);
  const long long* st = a.st;
  kernel<<<grid, kMmaThreads, kBytes, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<__nv_bfloat16*>(a.o), a.Hq, a.Hkv,
      a.Sq, a.Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], a.scale,
      a.causal, a.offset_dev, a.offset_host, a.aligned);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_simt(const Args& a) {
  const dim3 grid((a.Sq + kSimtRows - 1) / kSimtRows, a.Hq, a.B);
  const long long* st = a.st;
  flash_simt_kernel<D><<<grid, kSimtThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.Hq, a.Hkv, a.Sq, a.Sk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], a.scale, a.causal,
      a.offset_dev, a.offset_host, a.aligned);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_decode_rows(const Args& a) {
  return (a.Hq / a.Hkv) * a.Sq <= 4 ? launch_decode<T, D, 4>(a) : launch_decode<T, D, 16>(a);
}

// kernel: 0 = CUDA cores (f32), 1 = decode, 2 = tensor cores (bf16)
template <int D>
cudaError_t dispatch(int dtype, int kernel, const Args& a) {
  if (kernel == 1) {
    return dtype == 0 ? launch_decode_rows<float, D>(a) : launch_decode_rows<__nv_bfloat16, D>(a);
  }
  if (kernel == 2 && dtype == 1) return launch_mma<D>(a);
  if (kernel == 0 && dtype == 0) return launch_simt<D>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  kernel: 0 = the CUDA-core kernel
// (float32 only), 1 = decode (Hq / Hkv * Sq <= 16; `splits` blocks per
// cluster, 1 to 8), 2 = the tensor-core kernel (bfloat16 only).  strides:
// the element strides of the batch, head and sequence dims of q, k and v
// (9 values; the head_dim stride must be 1); o is contiguous
// [B, Hq, Sq, D].  offset_dev, when not null, points to the int32 absolute
// position of q's first row on the device; otherwise offset_host is used.
// aligned != 0 promises that q, k and v start on 16 bytes and that their
// strides are multiples of 16 bytes, for 16-byte loads.  Launches on
// `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int da4ml_flash_attention(int dtype, int kernel, int splits, int head_dim,
                                     const void* q, const void* k, const void* v, void* o,
                                     int B, int Hq, int Hkv, int Sq, int Sk,
                                     const long long* strides, float scale, int causal,
                                     const int32_t* offset_dev, int offset_host, int aligned,
                                     void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk < 0 || Hq > 65535 ||
      B > 65535 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (kernel == 1 && ((Hq / Hkv) * static_cast<long long>(Sq) > 16 || splits < 1 ||
                      splits > 8 || static_cast<long long>(B) * Hkv > 65535)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, o, B, Hq, Hkv, Sq, Sk, strides, scale, causal, offset_dev, offset_host,
               aligned != 0, splits, static_cast<cudaStream_t>(stream)};
  switch (head_dim) {
    case 16:
      return static_cast<int>(dispatch<16>(dtype, kernel, a));
    case 32:
      return static_cast<int>(dispatch<32>(dtype, kernel, a));
    case 64:
      return static_cast<int>(dispatch<64>(dtype, kernel, a));
    case 80:
      return static_cast<int>(dispatch<80>(dtype, kernel, a));
    case 112:
      return static_cast<int>(dispatch<112>(dtype, kernel, a));
    case 128:
      return static_cast<int>(dispatch<128>(dtype, kernel, a));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* da4ml_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
