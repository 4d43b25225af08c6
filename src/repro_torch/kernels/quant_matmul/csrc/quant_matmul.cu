// W8A8 matmul with exact int32 sums for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/quant_matmul/kernel.py:_qmm_kernel
// (launched by quant_matmul_pallas).  It computes
//
//     out[m, n] = float(sum_k x[m, k] * w[k, n]) * x_scale[m] * w_scale[n]
//
// for int8 x [M, K] and w [K, N] (both row-major) and float32 scales, into
// a float32 [M, N].  The sum is exact: int32 accumulation in the int8
// tensor cores, which cannot overflow for K < 2^17 (the wrapper refuses
// more).  The epilogue converts with round-to-nearest and multiplies by
// x_scale, then by w_scale, in float32: the order of the JAX oracle
// quant_matmul_ref, so the result is bit-equal to it.  (The Pallas kernel
// sums in float32, which is inexact once a sum passes 2^24.)
//
// Design.  One block of 8 warps per 128 x 128 output tile walks K in
// steps of 64.  The x tile is staged in shared memory row-major and the w
// tile transposed to [n][k] (4 x 4 byte blocks transposed in registers
// with __byte_perm), because mma.sync.m16n8k32 takes both operands with k
// contiguous.  Shared rows are padded to 80 bytes, so the 32-bit fragment
// loads of a warp hit 32 distinct banks.  Each warp owns a 64 x 32 piece of
// the tile: 4 x 4 mma.sync.m16n8k32.s8 per 32 of K, 64 int32 accumulators
// per thread.  The next K step's tiles are loaded from device memory into
// registers while the tensor cores work on the current one (two shared
// buffers, one barrier per step).  Ragged M, N and K are masked in the
// loads (zeros) and in the stores; with K % 16 == 0 and N % 8 == 0 the
// loads are 16- and 8-byte vectors, otherwise bytes.  The JAX op pads to
// block multiples instead; nothing is padded here.
//
// What bounds it on this card.  2 M N K int8 operations against the bytes
// of x, w and the float32 output: at M 1024, K 4096, N 16384 (the size of
// falcon-mamba-7b's in_proj at the serving path's prefill batch) that is
// 137.4 G operations, ~69 us at 1,979 TOPS, against 138 MB, ~41 us at
// 3.35 TB/s, so the operations bound it.  This first kernel reaches the
// tensor cores through mma.sync, not wgmma, stages with the threads' own
// loads rather than TMA, and feeds each mma from shared memory with 32-bit
// loads, so it runs well below that rate; wgmma with TMA-fed tiles is the
// redesign's work.  chip_smoke.py measures it against the bound and PERF.md
// keeps the numbers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kWarpsM = 2, kWarpsN = 4;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;  // 256
constexpr int kWM = kBM / kWarpsM;                // 64 rows per warp
constexpr int kWN = kBN / kWarpsN;                // 32 columns per warp
constexpr int kMT = kWM / 16;                     // m16 tiles per warp
constexpr int kNT = kWN / 8;                      // n8 tiles per warp
constexpr int kLd = kBK + 16;                     // padded shared row, bytes

struct Smem {
  alignas(16) int8_t a[2][kBM][kLd];  // x tile, [m][k]
  alignas(16) int8_t b[2][kBN][kLd];  // w tile transposed, [n][k]
};

// One thread's share of a K step: two 16-byte pieces of the x tile and a
// 4 (k) x 8 (n) block of the w tile.
struct Staged {
  uint4 a[2];
  uint2 b[4];
};

__device__ __forceinline__ uint32_t pack_bytes(const int8_t* p, int lim) {
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < lim) v |= static_cast<uint32_t>(static_cast<uint8_t>(p[j])) << (8 * j);
  }
  return v;
}

template <bool kVec>
__device__ __forceinline__ void load_tiles(Staged& st, const int8_t* __restrict__ x,
                                           const int8_t* __restrict__ w, int M, int N, int K,
                                           int m0, int n0, int k0) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int rep = 0; rep < 2; ++rep) {
    const int c = tid + rep * kThreads;  // 512 pieces: 128 rows x 4
    const int gm = m0 + (c >> 2);
    const int gk = k0 + (c & 3) * 16;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (gm < M && gk < K) {
      const int8_t* p = x + static_cast<long long>(gm) * K + gk;
      if (kVec) {
        v = *reinterpret_cast<const uint4*>(p);
      } else {
        const int left = K - gk;
        v.x = pack_bytes(p, left);
        v.y = pack_bytes(p + 4, left - 4);
        v.z = pack_bytes(p + 8, left - 8);
        v.w = pack_bytes(p + 12, left - 12);
      }
    }
    st.a[rep] = v;
  }
  // w: thread -> (k quad kq, n chunk nc) with kq fastest, so the transposed
  // stores of a warp fall on distinct banks but for one pair
  const int kq = tid & 15, nc = tid >> 4;
  const int gn = n0 + nc * 8;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gk = k0 + kq * 4 + r;
    uint2 v = make_uint2(0, 0);
    if (gk < K && gn < N) {
      const int8_t* p = w + static_cast<long long>(gk) * N + gn;
      if (kVec) {
        v = *reinterpret_cast<const uint2*>(p);
      } else {
        const int left = N - gn;
        v.x = pack_bytes(p, left);
        v.y = pack_bytes(p + 4, left - 4);
      }
    }
    st.b[r] = v;
  }
}

// Column j (0..3) of a 4 x 4 byte block whose rows are r0..r3.
__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3,
                                             uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t t1 = __byte_perm(r0, r1, 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);  // r0.b0 r1.b0 r2.b0 r3.b0
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ void store_tiles(const Staged& st, Smem& sm, int buf) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int rep = 0; rep < 2; ++rep) {
    const int c = tid + rep * kThreads;
    *reinterpret_cast<uint4*>(&sm.a[buf][c >> 2][(c & 3) * 16]) = st.a[rep];
  }
  const int kq = tid & 15, nc = tid >> 4;
  uint32_t lo[4], hi[4];
  transpose4x4(st.b[0].x, st.b[1].x, st.b[2].x, st.b[3].x, lo);  // n 0..3
  transpose4x4(st.b[0].y, st.b[1].y, st.b[2].y, st.b[3].y, hi);  // n 4..7
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    *reinterpret_cast<uint32_t*>(&sm.b[buf][nc * 8 + j][kq * 4]) = lo[j];
    *reinterpret_cast<uint32_t*>(&sm.b[buf][nc * 8 + 4 + j][kq * 4]) = hi[j];
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    quant_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                        const float* __restrict__ xs, const float* __restrict__ ws,
                        float* __restrict__ out, int M, int N, int K) {
  __shared__ Smem sm;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment group and thread in group
  const int wm = (warp / kWarpsN) * kWM, wn = (warp % kWarpsN) * kWN;

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int steps = (K + kBK - 1) / kBK;
  Staged st;
  if (steps > 0) {
    load_tiles<kVec>(st, x, w, M, N, K, m0, n0, 0);
    store_tiles(st, sm, 0);
  }
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) load_tiles<kVec>(st, x, w, M, N, K, m0, n0, (s + 1) * kBK);
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t af[kMT][4], bf[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int row = wm + i * 16 + g;
        af[i][0] = *reinterpret_cast<const uint32_t*>(&sm.a[buf][row][ks + 4 * t]);
        af[i][1] = *reinterpret_cast<const uint32_t*>(&sm.a[buf][row + 8][ks + 4 * t]);
        af[i][2] = *reinterpret_cast<const uint32_t*>(&sm.a[buf][row][ks + 16 + 4 * t]);
        af[i][3] = *reinterpret_cast<const uint32_t*>(&sm.a[buf][row + 8][ks + 16 + 4 * t]);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int col = wn + j * 8 + g;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(&sm.b[buf][col][ks + 4 * t]);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(&sm.b[buf][col][ks + 16 + 4 * t]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    // the other buffer was last read in step s - 1, before the barrier that
    // ended it, so it can be refilled now; the barrier below publishes it
    if (s + 1 < steps) store_tiles(st, sm, buf ^ 1);
    __syncthreads();
  }

  // epilogue: c0, c1 at (row g, cols 2t, 2t+1), c2, c3 at row g + 8
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gm = m0 + wm + i * 16 + g + half * 8;
      if (gm >= M) continue;
      const float sx = xs[gm];
      float* orow = out + static_cast<long long>(gm) * N;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gn = n0 + wn + j * 8 + 2 * t + e;
          if (gn < N) {
            const float v = __int2float_rn(acc[i][j][half * 2 + e]) * sx;
            orow[gn] = v * ws[gn];
          }
        }
      }
    }
  }
}

}  // namespace

// x: int8 [M, K], w: int8 [K, N], xs: float32 [M], ws: float32 [N], out:
// float32 [M, N], all contiguous on the current device; M, N >= 1,
// 0 <= K <= 131071 (so no int32 sum can overflow).  Launches on `stream`;
// returns the cudaError_t of the launch (0 = success).
extern "C" int da4ml_quant_matmul(const int8_t* x, const int8_t* w, const float* xs,
                                  const float* ws, float* out, int M, int N, int K,
                                  void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || K > 131071 || (M + kBM - 1) / kBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = K % 16 == 0 && N % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 8 == 0;
  if (vec) {
    quant_matmul_kernel<true><<<grid, kThreads, 0, s>>>(x, w, xs, ws, out, M, N, K);
  } else {
    quant_matmul_kernel<false><<<grid, kThreads, 0, s>>>(x, w, xs, ws, out, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* da4ml_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
