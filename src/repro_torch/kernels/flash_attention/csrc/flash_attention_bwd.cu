// Backward of GQA flash attention (causal or full) for NVIDIA Hopper
// (sm_90a): dQ, dK and dV of out = softmax(scale * q k^T) v.
//
// The JAX package has no backward kernel: it differentiates its jnp
// attention (attention_ref).  The port runs its forward kernel
// (flash_attention.cu, the port of repro/kernels/flash_attention/kernel.py:
// _flash_kernel) wherever a tensor lies on the card, training included, so
// the gradient through that kernel needs a kernel of its own; this is it.
// Its plain version is attention_bwd_ref (autograd through attention_ref).
//
//     q, o, dO [B, Hq, Sq, D], k, v [B, Hkv, Sk, D], all contiguous; query
//     head h reads KV head h / (Hq / Hkv); query row i sits at absolute
//     position offset + i, and in causal mode sees key j when
//     j <= offset + i (a masked key takes no part: p = 0);
//     S = scale q k^T, P = softmax(S) over the keys, dP = dO v^T,
//     delta_i = sum_d dO_id O_id, dS = P * (dP - delta),
//     dQ = scale dS k, dK = scale dS^T q, dV = P^T dO,
//     dK and dV summed over the query heads of a GQA group.
//
// FA2's split, two kernels per call, no float atomics: every sum is taken
// by one thread in a fixed order, so two launches on the same inputs give
// the same bits (crash recovery resumes to the same parameters).
//
//  1. dQ (one block per 64 query rows of one query head, or 16 in f32):
//     delta of its rows from dO and O, then a pass over the keys for the
//     rows' log-sum-exp (the forward kernel does not store it: the
//     serving path's launch stays as it was), written to `lse`, then a
//     second pass for dQ.  Both passes stop at the block's causal frontier,
//     and a warp skips the key tiles past its own rows.
//  2. dK and dV (one block per 64 keys of one KV head, or 16 in f32):
//     loops over the group's query heads and the query tiles from the first
//     row that can see its keys, reading Q, dO, lse and delta, and keeps
//     dK and dV in registers.
//
// bf16 runs the products on the tensor cores (mma.sync.m16n8k16, f32
// accumulation; the fragment loads are the forward kernel's): P and dS
// are rounded to bf16 as the operands of the second products, as FA2
// does.  f32 runs on the CUDA cores, all in f32.  Outputs take q's dtype.
//
// What bounds it on this card.  At smollm-135m's training shape (q [8, 9,
// 128, 64], k/v [8, 3, 128, 64], bf16, causal) the work is ~5 causal
// products of 2 S^2 D flops per head plus one more for the log-sum-exp
// pass: a few microseconds at the tensor cores' rate, and the bytes (q, k,
// v, o, dO read, dq, dk, dv written) fewer still; latency and the few
// blocks (48 for dK/dV) bound it.  A simple kernel that is right comes
// first; PERF.md keeps its time beside its bound.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr float kLog2e = 1.44269504088896341f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Rows [row0, row0 + n_rows) of a contiguous [*, D] tensor into dst
// [n_rows][LD]; rows at or past `limit` are zeros.  16-byte aligned rows
// (the wrapper's promise); the caller waits for the copies.
template <typename T, int D, int LD>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, long long row0,
                                           long long limit, int n_rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < n_rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    const bool ok = row0 + r < limit;
    cp_async16(dst + r * LD + c, ok ? src + (row0 + r) * D + c : src, ok);
  }
}

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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of rows [0, 16) and columns [kk * 16, kk * 16 + 16) of a
// row-major bf16 tile with row stride LD (lane: group grp, thread tig).
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int kk,
                                       int grp, int tig) {
  const __nv_bfloat16* p = tile + grp * LD + kk * 16 + tig * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// acc[n] += A (16 x D, rows of `a_tile`) times B^T, where B is NT * 8 rows
// of D values (`b_tile`, row-major): the logits of 16 rows against NT * 8
// rows, both tiles with row stride LD.
template <int D, int NT, int LD>
__device__ __forceinline__ void rows_dot_rows(float (&acc)[NT][4], const __nv_bfloat16* a_tile,
                                              const __nv_bfloat16* b_tile, int grp, int tig) {
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    load_a<LD>(a, a_tile, kk, grp, tig);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const __nv_bfloat16* bp = b_tile + (n * 8 + grp) * LD + kk * 16 + tig * 2;
      mma_bf16(acc[n], a, ld32(bp), ld32(bp + 8));
    }
  }
}

// out[dn] += W (16 x NT * 8, in the accumulator layout of rows_dot_rows,
// rounded to bf16) times M (NT * 8 rows of D values, row-major, stride LD).
template <int D, int NT, int LD>
__device__ __forceinline__ void weights_times_rows(float (&out)[D / 8][4], const float (&w)[NT][4],
                                                   const __nv_bfloat16* m_tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t a[4] = {
        pack_bf16(w[2 * kk][0], w[2 * kk][1]),
        pack_bf16(w[2 * kk][2], w[2 * kk][3]),
        pack_bf16(w[2 * kk + 1][0], w[2 * kk + 1][1]),
        pack_bf16(w[2 * kk + 1][2], w[2 * kk + 1][3]),
    };
#pragma unroll
    for (int dn = 0; dn < D / 8; dn += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, m_tile + (kk * 16 + (lane & 15)) * LD + dn * 8 + (lane >> 4) * 8);
      mma_bf16(out[dn], a, b[0], b[1]);
      mma_bf16(out[dn + 1], a, b[2], b[3]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *lse, *delta;
  int B, Hq, Hkv, Sq, Sk;
  float scale;
  int causal, offset;
  cudaStream_t stream;
};

// keys [0, n) that rows up to position `last_pos` may see
__device__ __forceinline__ long long keys_upto(long long last_pos, int Sk, int causal) {
  if (!causal) return Sk;
  const long long hi = last_pos + 1;
  return hi < 0 ? 0 : (hi < Sk ? hi : Sk);
}

// ---------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------
constexpr int kRows = 64;  // query rows (dQ) or keys (dK, dV) per block: 16 per warp
constexpr int kKeys = 64;  // keys per tile of the dQ kernel

template <int D>
struct DqLayout {
  static constexpr int kLd = D + 8;  // padded by 16 bytes, as the forward kernel's tiles
  static constexpr int kTile = kRows * kLd;
  static constexpr int kBytes = 4 * kTile * 2 + kRows * 4;  // Q, dO, K, V; delta
};

template <int D>
__global__ void __launch_bounds__(kThreads) fa_bwd_dq_mma(Args g) {
  using L = DqLayout<D>;
  constexpr int kLd = L::kLd, NT = kKeys / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = qs + L::kTile;
  __nv_bfloat16* ks = dos + L::kTile;
  __nv_bfloat16* vs = ks + L::kTile;
  float* delta_s = reinterpret_cast<float*>(vs + L::kTile);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane >> 2, tig = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (g.Hq / g.Hkv);
  const int q0 = blockIdx.x * kRows;
  const long long qhead = (static_cast<long long>(b) * g.Hq + h) * g.Sq;  // row (b, h, 0)
  const long long khead = (static_cast<long long>(b) * g.Hkv + hk) * g.Sk;
  const auto* q = static_cast<const __nv_bfloat16*>(g.q) + qhead * D;
  const auto* o = static_cast<const __nv_bfloat16*>(g.o) + qhead * D;
  const auto* dout = static_cast<const __nv_bfloat16*>(g.dout) + qhead * D;
  const auto* k = static_cast<const __nv_bfloat16*>(g.k) + khead * D;
  const auto* v = static_cast<const __nv_bfloat16*>(g.v) + khead * D;

  stage_rows<__nv_bfloat16, D, kLd>(qs, q, q0, g.Sq, kRows);
  stage_rows<__nv_bfloat16, D, kLd>(dos, dout, q0, g.Sq, kRows);
  cp_async_wait_all();
  // delta of the warp's 16 rows
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    const long long row = q0 + r;
    float part = 0.f;
    if (row < g.Sq) {
      for (int d = lane; d < D; d += 32) part += to_f32(dout[row * D + d]) * to_f32(o[row * D + d]);
    }
    part = warp_sum(part);
    if (lane == 0) {
      delta_s[r] = part;
      if (row < g.Sq) g.delta[qhead + row] = part;
    }
  }

  const int ra = q0 + warp * 16 + grp, rb = ra + 8;  // this thread's two rows
  const long long pos_a = static_cast<long long>(g.offset) + ra;
  const long long pos_b = static_cast<long long>(g.offset) + rb;
  const long long n_keys = keys_upto(g.offset + static_cast<long long>(min(g.Sq, q0 + kRows)) - 1,
                                     g.Sk, g.causal);
  const long long warp_last = g.offset + static_cast<long long>(min(g.Sq - 1, q0 + warp * 16 + 15));
  const float scale_log2 = g.scale * kLog2e;
  const __nv_bfloat16* qw = qs + warp * 16 * kLd;
  const __nv_bfloat16* dow = dos + warp * 16 * kLd;

  auto visible = [&](long long j, int row, long long pos) {
    return row < g.Sq && j < g.Sk && (!g.causal || j <= pos);
  };

  // pass 1: the rows' log-sum-exp, in base 2 of the scaled logits
  float m_a = -CUDART_INF_F, m_b = -CUDART_INF_F, l_a = 0.f, l_b = 0.f;
  for (long long t0 = 0; t0 < n_keys; t0 += kKeys) {
    __syncthreads();  // the previous tile is read
    stage_rows<__nv_bfloat16, D, kLd>(ks, k, t0, g.Sk, kKeys);
    cp_async_wait_all();
    __syncthreads();
    if (g.causal && t0 > warp_last) continue;
    float s[NT][4];
    rows_dot_rows<D, NT, kLd>(s, qw, ks, grp, tig);
    float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long j = t0 + n * 8 + tig * 2 + e;
        s[n][e] = visible(j, ra, pos_a) ? s[n][e] * scale_log2 : -CUDART_INF_F;
        s[n][2 + e] = visible(j, rb, pos_b) ? s[n][2 + e] * scale_log2 : -CUDART_INF_F;
        mx_a = fmaxf(mx_a, s[n][e]);
        mx_b = fmaxf(mx_b, s[n][2 + e]);
      }
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
    // a row that has seen no key yet keeps l = 0 (no -inf - -inf)
    const float ref_a = mn_a == -CUDART_INF_F ? 0.f : mn_a;
    const float ref_b = mn_b == -CUDART_INF_F ? 0.f : mn_b;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      ps_a += exp2f(s[n][0] - ref_a) + exp2f(s[n][1] - ref_a);
      ps_b += exp2f(s[n][2] - ref_b) + exp2f(s[n][3] - ref_b);
    }
    l_a = l_a * exp2f(m_a - ref_a) + ps_a;
    l_b = l_b * exp2f(m_b - ref_b) + ps_b;
    m_a = mn_a;
    m_b = mn_b;
  }
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  // a row with no key: lse +inf, so every p of it is 0
  const float lse_a = l_a > 0.f ? m_a + log2f(l_a) : CUDART_INF_F;
  const float lse_b = l_b > 0.f ? m_b + log2f(l_b) : CUDART_INF_F;
  if (tig == 0) {
    if (ra < g.Sq) g.lse[qhead + ra] = lse_a;
    if (rb < g.Sq) g.lse[qhead + rb] = lse_b;
  }
  __syncthreads();  // delta_s and the staged Q and dO are visible to every warp
  const float delta_a = delta_s[warp * 16 + grp], delta_b = delta_s[warp * 16 + grp + 8];

  // pass 2: dQ = scale dS K
  float dq[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t) dq[t][0] = dq[t][1] = dq[t][2] = dq[t][3] = 0.f;
  for (long long t0 = 0; t0 < n_keys; t0 += kKeys) {
    __syncthreads();
    stage_rows<__nv_bfloat16, D, kLd>(ks, k, t0, g.Sk, kKeys);
    stage_rows<__nv_bfloat16, D, kLd>(vs, v, t0, g.Sk, kKeys);
    cp_async_wait_all();
    __syncthreads();
    if (g.causal && t0 > warp_last) continue;
    float p[NT][4], dp[NT][4];
    rows_dot_rows<D, NT, kLd>(p, qw, ks, grp, tig);
    rows_dot_rows<D, NT, kLd>(dp, dow, vs, grp, tig);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long j = t0 + n * 8 + tig * 2 + e;
        const float pa = visible(j, ra, pos_a) ? exp2f(p[n][e] * scale_log2 - lse_a) : 0.f;
        const float pb = visible(j, rb, pos_b) ? exp2f(p[n][2 + e] * scale_log2 - lse_b) : 0.f;
        p[n][e] = pa * (dp[n][e] - delta_a);  // dS
        p[n][2 + e] = pb * (dp[n][2 + e] - delta_b);
      }
    }
    weights_times_rows<D, NT, kLd>(dq, p, ks, lane);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half == 0 ? ra : rb;
    if (row >= g.Sq) continue;
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(g.dq) + (qhead + row) * D;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      *reinterpret_cast<__nv_bfloat162*>(out + dn * 8 + tig * 2) = __floats2bfloat162_rn(
          dq[dn][2 * half] * g.scale, dq[dn][2 * half + 1] * g.scale);
    }
  }
}

template <int D>
struct DkvLayout {
  static constexpr int BQ = D <= 64 ? 64 : 32;  // query rows per tile: registers bound it
  static constexpr int kLd = D + 8;
  static constexpr int kBytes = (2 * kRows + 2 * BQ) * kLd * 2 + 2 * BQ * 4;  // K, V, Q, dO; lse, delta
};

template <int D>
__global__ void __launch_bounds__(kThreads) fa_bwd_dkdv_mma(Args g) {
  using L = DkvLayout<D>;
  constexpr int kLd = L::kLd, BQ = L::BQ, NT = BQ / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kRows * kLd;
  __nv_bfloat16* qs = vs + kRows * kLd;
  __nv_bfloat16* dos = qs + BQ * kLd;
  float* lse_s = reinterpret_cast<float*>(dos + BQ * kLd);
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane >> 2, tig = lane & 3;
  const int hk = blockIdx.y, b = blockIdx.z, G = g.Hq / g.Hkv;
  const int k0 = blockIdx.x * kRows;
  const long long khead = (static_cast<long long>(b) * g.Hkv + hk) * g.Sk;
  stage_rows<__nv_bfloat16, D, kLd>(ks, static_cast<const __nv_bfloat16*>(g.k) + khead * D, k0,
                                    g.Sk, kRows);
  stage_rows<__nv_bfloat16, D, kLd>(vs, static_cast<const __nv_bfloat16*>(g.v) + khead * D, k0,
                                    g.Sk, kRows);

  const long long ja = k0 + warp * 16 + grp, jb = ja + 8;  // this thread's two keys
  const long long warp_first = k0 + warp * 16;             // the warp's first key
  // the first query row that sees any of the block's keys
  long long first_row = g.causal ? static_cast<long long>(k0) - g.offset : 0;
  first_row = first_row < 0 ? 0 : first_row;
  const int qt0 = static_cast<int>(min(first_row, static_cast<long long>(g.Sq)) / BQ * BQ);
  const float scale_log2 = g.scale * kLog2e;
  const __nv_bfloat16* kw = ks + warp * 16 * kLd;
  const __nv_bfloat16* vw = vs + warp * 16 * kLd;

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t) {
    dk[t][0] = dk[t][1] = dk[t][2] = dk[t][3] = 0.f;
    dv[t][0] = dv[t][1] = dv[t][2] = dv[t][3] = 0.f;
  }
  for (int hh = 0; hh < G; ++hh) {
    const long long qhead = (static_cast<long long>(b) * g.Hq + hk * G + hh) * g.Sq;
    for (int q0 = qt0; q0 < g.Sq; q0 += BQ) {
      __syncthreads();  // the previous tile is read
      stage_rows<__nv_bfloat16, D, kLd>(qs, static_cast<const __nv_bfloat16*>(g.q) + qhead * D,
                                        q0, g.Sq, BQ);
      stage_rows<__nv_bfloat16, D, kLd>(dos,
                                        static_cast<const __nv_bfloat16*>(g.dout) + qhead * D,
                                        q0, g.Sq, BQ);
      for (int i = tid; i < BQ; i += kThreads) {
        const bool ok = q0 + i < g.Sq;
        lse_s[i] = ok ? g.lse[qhead + q0 + i] : 0.f;
        delta_s[i] = ok ? g.delta[qhead + q0 + i] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();
      // no row of the tile sees the warp's keys
      if (g.causal && g.offset + static_cast<long long>(min(g.Sq - 1, q0 + BQ - 1)) < warp_first)
        continue;
      float p[NT][4], dp[NT][4];
      rows_dot_rows<D, NT, kLd>(p, kw, qs, grp, tig);   // S^T: keys x queries
      rows_dot_rows<D, NT, kLd>(dp, vw, dos, grp, tig);  // dP^T
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n * 8 + tig * 2 + e;  // the query row in the tile
          const long long row = q0 + c, pos = g.offset + row;
          const bool row_ok = row < g.Sq;
          const bool va = row_ok && ja < g.Sk && (!g.causal || ja <= pos);
          const bool vb = row_ok && jb < g.Sk && (!g.causal || jb <= pos);
          p[n][e] = va ? exp2f(p[n][e] * scale_log2 - lse_s[c]) : 0.f;
          p[n][2 + e] = vb ? exp2f(p[n][2 + e] * scale_log2 - lse_s[c]) : 0.f;
          dp[n][e] = p[n][e] * (dp[n][e] - delta_s[c]);  // dS^T
          dp[n][2 + e] = p[n][2 + e] * (dp[n][2 + e] - delta_s[c]);
        }
      }
      weights_times_rows<D, NT, kLd>(dv, p, dos, lane);
      weights_times_rows<D, NT, kLd>(dk, dp, qs, lane);
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long key = half == 0 ? ja : jb;
    if (key >= g.Sk) continue;
    __nv_bfloat16* dk_row = static_cast<__nv_bfloat16*>(g.dk) + (khead + key) * D;
    __nv_bfloat16* dv_row = static_cast<__nv_bfloat16*>(g.dv) + (khead + key) * D;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      *reinterpret_cast<__nv_bfloat162*>(dk_row + dn * 8 + tig * 2) = __floats2bfloat162_rn(
          dk[dn][2 * half] * g.scale, dk[dn][2 * half + 1] * g.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv_row + dn * 8 + tig * 2) =
          __floats2bfloat162_rn(dv[dn][2 * half], dv[dn][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------
constexpr int kPerWarp = 4;                 // query rows (dQ) or keys (dK, dV) per warp
constexpr int kSimtRows = 4 * kPerWarp;     // per block
constexpr int kLaneTile = 32;               // keys (dQ) or query rows (dK, dV) per tile: one per lane

// The f32 kernels' shared memory: the block's 16 rows [16][D] twice, and a
// tile of 32 rows [32][D + 1] (padded: lane-indexed rows hit 32 banks)
// twice, plus two vectors of 32 (dK, dV: lse and delta of the tile's rows).
template <int D>
struct SimtLayout {
  static constexpr int kBlock = kSimtRows * D;
  static constexpr int kTile = kLaneTile * (D + 1);
  static constexpr int kBytes = (2 * kBlock + 2 * kTile + 2 * kLaneTile) * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads) fa_bwd_dq_simt(Args g) {
  constexpr int DPL = (D + 31) / 32;  // dims per lane
  using L = SimtLayout<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  auto qs = reinterpret_cast<float (*)[D]>(smem);
  auto dos = qs + kSimtRows;
  auto ks = reinterpret_cast<float (*)[D + 1]>(smem + 2 * L::kBlock * 4);
  auto vs = ks + kLaneTile;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (g.Hq / g.Hkv);
  const int q0 = blockIdx.x * kSimtRows;
  const long long qhead = (static_cast<long long>(b) * g.Hq + h) * g.Sq;
  const long long khead = (static_cast<long long>(b) * g.Hkv + hk) * g.Sk;
  const float* q = static_cast<const float*>(g.q) + qhead * D;
  const float* o = static_cast<const float*>(g.o) + qhead * D;
  const float* dout = static_cast<const float*>(g.dout) + qhead * D;
  const float* k = static_cast<const float*>(g.k) + khead * D;
  const float* v = static_cast<const float*>(g.v) + khead * D;

  for (int i = threadIdx.x; i < kSimtRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const bool ok = q0 + r < g.Sq;
    qs[r][d] = ok ? q[(q0 + r) * static_cast<long long>(D) + d] : 0.f;
    dos[r][d] = ok ? dout[(q0 + r) * static_cast<long long>(D) + d] : 0.f;
  }
  const int r0 = warp * kPerWarp;
  float delta[kPerWarp], m[kPerWarp], l[kPerWarp];
  long long pos[kPerWarp];
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    const long long row = q0 + r0 + r;
    float part = 0.f;
    if (row < g.Sq) {
      for (int d = lane; d < D; d += 32) part += dout[row * D + d] * o[row * D + d];
    }
    delta[r] = warp_sum(part);
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
    pos[r] = g.offset + row;
  }
  const long long n_keys =
      keys_upto(g.offset + static_cast<long long>(min(g.Sq, q0 + kSimtRows)) - 1, g.Sk, g.causal);

  auto logits = [&](float (&s)[kPerWarp], float (&dp)[kPerWarp], bool with_dp) {
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = ks[lane][d], vd = vs[lane][d];
#pragma unroll
      for (int r = 0; r < kPerWarp; ++r) {
        s[r] = fmaf(qs[r0 + r][d], kd, s[r]);
        if (with_dp) dp[r] = fmaf(dos[r0 + r][d], vd, dp[r]);
      }
    }
  };

  // pass 1: the rows' log-sum-exp (natural base, of the scaled logits)
  for (long long t0 = 0; t0 < n_keys; t0 += kLaneTile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kLaneTile * D; i += kThreads) {
      const int r = i / D, d = i % D;
      ks[r][d] = t0 + r < g.Sk ? k[(t0 + r) * D + d] : 0.f;
    }
    __syncthreads();
    float s[kPerWarp], unused[kPerWarp];
    logits(s, unused, false);
    const long long j = t0 + lane;
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r) {
      const bool vis = q0 + r0 + r < g.Sq && j < g.Sk && (!g.causal || j <= pos[r]);
      const float x = vis ? s[r] * g.scale : -CUDART_INF_F;
      const float mn = fmaxf(m[r], warp_max(x));
      const float ref = mn == -CUDART_INF_F ? 0.f : mn;
      l[r] = l[r] * expf(m[r] - ref) + warp_sum(expf(x - ref));
      m[r] = mn;
    }
  }
  float lse[kPerWarp];
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    lse[r] = l[r] > 0.f ? m[r] + logf(l[r]) : CUDART_INF_F;
    const long long row = q0 + r0 + r;
    if (lane == 0 && row < g.Sq) {
      g.lse[qhead + row] = lse[r];
      g.delta[qhead + row] = delta[r];
    }
  }

  // pass 2: dQ
  float acc[kPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  for (long long t0 = 0; t0 < n_keys; t0 += kLaneTile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kLaneTile * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const bool ok = t0 + r < g.Sk;
      ks[r][d] = ok ? k[(t0 + r) * D + d] : 0.f;
      vs[r][d] = ok ? v[(t0 + r) * D + d] : 0.f;
    }
    __syncthreads();
    float s[kPerWarp], dp[kPerWarp];
    logits(s, dp, true);
    const long long j = t0 + lane;
    float ds[kPerWarp];
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r) {
      const bool vis = q0 + r0 + r < g.Sq && j < g.Sk && (!g.causal || j <= pos[r]);
      const float p = vis ? expf(s[r] * g.scale - lse[r]) : 0.f;
      ds[r] = p * (dp[r] - delta[r]);
    }
#pragma unroll 4
    for (int jj = 0; jj < kLaneTile; ++jj) {
      float kj[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        const int d = lane + 32 * e;
        kj[e] = d < D ? ks[jj][d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kPerWarp; ++r) {
        const float w = __shfl_sync(0xffffffffu, ds[r], jj);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] = fmaf(w, kj[e], acc[r][e]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    const long long row = q0 + r0 + r;
    if (row >= g.Sq) continue;
    float* out = static_cast<float*>(g.dq) + (qhead + row) * D;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < D) out[d] = acc[r][e] * g.scale;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) fa_bwd_dkdv_simt(Args g) {
  constexpr int DPL = (D + 31) / 32;
  using L = SimtLayout<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  auto ks = reinterpret_cast<float (*)[D]>(smem);
  auto vs = ks + kSimtRows;
  auto qs = reinterpret_cast<float (*)[D + 1]>(smem + 2 * L::kBlock * 4);
  auto dos = qs + kLaneTile;
  float* lse_s = reinterpret_cast<float*>(smem + (2 * L::kBlock + 2 * L::kTile) * 4);
  float* delta_s = lse_s + kLaneTile;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hk = blockIdx.y, b = blockIdx.z, G = g.Hq / g.Hkv;
  const int k0 = blockIdx.x * kSimtRows;
  const long long khead = (static_cast<long long>(b) * g.Hkv + hk) * g.Sk;
  const float* k = static_cast<const float*>(g.k) + khead * D;
  const float* v = static_cast<const float*>(g.v) + khead * D;
  for (int i = threadIdx.x; i < kSimtRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const bool ok = k0 + r < g.Sk;
    ks[r][d] = ok ? k[(k0 + r) * static_cast<long long>(D) + d] : 0.f;
    vs[r][d] = ok ? v[(k0 + r) * static_cast<long long>(D) + d] : 0.f;
  }
  const int r0 = warp * kPerWarp;
  long long first_row = g.causal ? static_cast<long long>(k0) - g.offset : 0;
  first_row = first_row < 0 ? 0 : first_row;
  const int qt0 = static_cast<int>(min(first_row, static_cast<long long>(g.Sq)) / kLaneTile *
                                   kLaneTile);

  float acc_k[kPerWarp][DPL], acc_v[kPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc_k[r][e] = acc_v[r][e] = 0.f;

  for (int hh = 0; hh < G; ++hh) {
    const long long qhead = (static_cast<long long>(b) * g.Hq + hk * G + hh) * g.Sq;
    const float* q = static_cast<const float*>(g.q) + qhead * D;
    const float* dout = static_cast<const float*>(g.dout) + qhead * D;
    for (int q0 = qt0; q0 < g.Sq; q0 += kLaneTile) {
      __syncthreads();
      for (int i = threadIdx.x; i < kLaneTile * D; i += kThreads) {
        const int r = i / D, d = i % D;
        const bool ok = q0 + r < g.Sq;
        qs[r][d] = ok ? q[(q0 + r) * static_cast<long long>(D) + d] : 0.f;
        dos[r][d] = ok ? dout[(q0 + r) * static_cast<long long>(D) + d] : 0.f;
      }
      for (int i = threadIdx.x; i < kLaneTile; i += kThreads) {
        const bool ok = q0 + i < g.Sq;
        lse_s[i] = ok ? g.lse[qhead + q0 + i] : 0.f;
        delta_s[i] = ok ? g.delta[qhead + q0 + i] : 0.f;
      }
      __syncthreads();
      // this lane's query row against the warp's keys
      float s[kPerWarp], dp[kPerWarp];
#pragma unroll
      for (int r = 0; r < kPerWarp; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float qd = qs[lane][d], dod = dos[lane][d];
#pragma unroll
        for (int r = 0; r < kPerWarp; ++r) {
          s[r] = fmaf(ks[r0 + r][d], qd, s[r]);
          dp[r] = fmaf(vs[r0 + r][d], dod, dp[r]);
        }
      }
      const long long row = q0 + lane, pos = g.offset + row;
      float p[kPerWarp], ds[kPerWarp];
#pragma unroll
      for (int r = 0; r < kPerWarp; ++r) {
        const long long j = k0 + r0 + r;
        const bool vis = row < g.Sq && j < g.Sk && (!g.causal || j <= pos);
        p[r] = vis ? expf(s[r] * g.scale - lse_s[lane]) : 0.f;
        ds[r] = p[r] * (dp[r] - delta_s[lane]);
      }
#pragma unroll 4
      for (int jj = 0; jj < kLaneTile; ++jj) {
        float qj[DPL], doj[DPL];
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          const int d = lane + 32 * e;
          qj[e] = d < D ? qs[jj][d] : 0.f;
          doj[e] = d < D ? dos[jj][d] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kPerWarp; ++r) {
          const float pw = __shfl_sync(0xffffffffu, p[r], jj);
          const float dw = __shfl_sync(0xffffffffu, ds[r], jj);
#pragma unroll
          for (int e = 0; e < DPL; ++e) {
            acc_v[r][e] = fmaf(pw, doj[e], acc_v[r][e]);
            acc_k[r][e] = fmaf(dw, qj[e], acc_k[r][e]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    const long long key = k0 + r0 + r;
    if (key >= g.Sk) continue;
    float* dk_row = static_cast<float*>(g.dk) + (khead + key) * D;
    float* dv_row = static_cast<float*>(g.dv) + (khead + key) * D;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < D) {
        dk_row[d] = acc_k[r][e] * g.scale;
        dv_row[d] = acc_v[r][e];
      }
    }
  }
}

// ---------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------
template <typename Kernel>
cudaError_t launch_smem(Kernel kernel, dim3 grid, int bytes, const Args& a) {
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, bytes, a.stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const Args& a) {
  cudaError_t err;
  if (dtype == 1) {
    err = launch_smem(fa_bwd_dq_mma<D>, dim3((a.Sq + kRows - 1) / kRows, a.Hq, a.B),
                      DqLayout<D>::kBytes, a);
    if (err != cudaSuccess) return err;
    return launch_smem(fa_bwd_dkdv_mma<D>, dim3((a.Sk + kRows - 1) / kRows, a.Hkv, a.B),
                       DkvLayout<D>::kBytes, a);
  }
  err = launch_smem(fa_bwd_dq_simt<D>, dim3((a.Sq + kSimtRows - 1) / kSimtRows, a.Hq, a.B),
                    SimtLayout<D>::kBytes, a);
  if (err != cudaSuccess) return err;
  return launch_smem(fa_bwd_dkdv_simt<D>, dim3((a.Sk + kSimtRows - 1) / kSimtRows, a.Hkv, a.B),
                     SimtLayout<D>::kBytes, a);
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  q, o,
// dout, dq: contiguous [B, Hq, Sq, D]; k, v, dk, dv: contiguous
// [B, Hkv, Sk, D]; all 16-byte aligned.  lse, delta: f32 scratch
// [B, Hq, Sq], written by the first kernel and read by the second.
// offset: the absolute position of q's first row.  Launches both kernels
// on `stream`; returns the cudaError_t of the launches (0 = success).
extern "C" int da4ml_flash_attention_bwd(int dtype, int head_dim, const void* q, const void* k,
                                         const void* v, const void* o, const void* dout,
                                         void* dq, void* dk, void* dv, float* lse, float* delta,
                                         int B, int Hq, int Hkv, int Sq, int Sk, float scale,
                                         int causal, int offset, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 || Hq > 65535 ||
      B > 65535 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, o, dout, dq, dk, dv, lse, delta, B, Hq, Hkv, Sq, Sk, scale, causal,
               offset, static_cast<cudaStream_t>(stream)};
  switch (head_dim) {
    case 16:
      return static_cast<int>(launch<16>(dtype, a));
    case 32:
      return static_cast<int>(launch<32>(dtype, a));
    case 64:
      return static_cast<int>(launch<64>(dtype, a));
    case 80:
      return static_cast<int>(launch<80>(dtype, a));
    case 112:
      return static_cast<int>(launch<112>(dtype, a));
    case 128:
      return static_cast<int>(launch<128>(dtype, a));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* da4ml_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
