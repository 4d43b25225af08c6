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
// What bounds it on this card.  2 M N K int8 operations against the bytes
// of x, w and the float32 output: at M 1024, K 4096, N 16384 (the size of
// falcon-mamba-7b's in_proj at the serving path's prefill batch) that is
// 137.4 G operations, ~69 us at 1,979 TOPS, against 138 MB, ~41 us at
// 3.35 TB/s, so the tensor cores bound it, and only wgmma reaches their
// full rate.  A 128 x 256 tile needs 384 bytes of operands per 64 K
// operations: at half the peak rate the card's 132 SMs pull ~5.8 TB/s of
// tiles from L2, so the tiles stream through a deep ring.
//
// Two kernels, chosen by the wrapper by a rule on shapes and alignment
// alone (kernel.py qmm_entry):
//
// 1. The TMA kernel (K % 16 == 0, N % 16 == 0, x, w and out on 16-byte
//    boundaries: what a tensor map can describe).  A persistent grid, one
//    block per SM, walks the 128 (m) x 256 (n) output tiles, m fastest, so
//    the blocks in flight share w's column blocks in L2.  One producer warp
//    brings each 128-byte K step of the x tile and the w tile into shared
//    memory by TMA (cp.async.bulk.tensor, 128-byte swizzle, zeros past the
//    edges) through a ring of four 48 KB stages, full and empty mbarriers
//    between it and two consumer warpgroups.
//    w's major-ness: wgmma takes 8-bit operands K-major only, and w [K, N]
//    is N-major.  A transposed copy of w would move 2 K N bytes more on
//    every call (half the bound at the timed size), and transposing each w
//    tile in shared memory would add a pass over it and a barrier between
//    the threads that transpose and the warpgroup that multiplies, on every
//    stage.  So the kernel computes out^T = w^T x^T: x's tile, which is
//    K-major, is the shared-memory B operand (descriptor: 128-byte swizzle,
//    SBO 1,024 bytes), and w is the register A operand, each thread
//    building its fragment with eight 32-bit shared loads and sixteen byte
//    permutes (__byte_perm: 4 x 4 byte transposes) per 32 of K.  Threads
//    t = 2, 3 of each quad load their rows rotated by two, so every load
//    instruction hits 32 banks; the selectors of the last permutes undo
//    the rotation.  Each consumer warpgroup owns 128 of the tile's n as two
//    64-row slabs (two wgmma.m64n128k32 per 32 of K, 128 int32 accumulators
//    per thread) and waits for its wgmma before it builds the next
//    fragment: the other warpgroup's wgmma fill the tensor cores meanwhile.
//    (Building the next fragment into a second register set while the
//    warpgroup's own wgmma run, with wgmma.wait_group 1, made ptxas
//    serialize the wgmma for want of registers (C7512) and ran slower.)
//    The A fragment's rows are mapped to n so that each thread holds four
//    consecutive n of one m: the epilogue stores out as 16-byte vectors
//    straight from the accumulators, while the producer already loads the
//    next tile.  layout.py holds the same constants and index maps, and the
//    CPU tests walk them in numpy against x @ w.  The tensor maps are
//    encoded on the host at every call (cuTensorMapEncodeTiled, fetched
//    from the driver with cudaGetDriverEntryPoint, so only the runtime is
//    linked) and passed as __grid_constant__ parameters: a captured CUDA
//    graph holds them by value.
// 2. The mma.sync kernel, for what TMA cannot describe (a ragged row
//    stride, a base off 16 bytes).  One block of 8 warps per 128 x 128
//    output tile walks K in steps of 64.  The x tile is staged in shared
//    memory row-major and the w tile transposed to [n][k] (4 x 4 byte blocks
//    transposed in registers with __byte_perm), because mma.sync.m16n8k32
//    takes both operands with k contiguous.  Shared rows are padded to 80
//    bytes, so the 32-bit fragment loads of a warp hit 32 distinct banks.
//    Each warp owns a 64 x 32 piece of the tile: 4 x 4
//    mma.sync.m16n8k32.s8 per 32 of K, 64 int32 accumulators per thread.
//    The next K step's tiles are loaded from device memory into registers
//    while the tensor cores work on the current one (two shared buffers,
//    one barrier per step).  Ragged M, N and K are masked in the loads
//    (zeros) and in the stores; with K % 16 == 0 and N % 8 == 0 the loads
//    are 16- and 8-byte vectors, otherwise bytes.
//
// The JAX op pads to block multiples instead; nothing is padded here.
// chip_smoke.py measures both kernels against the bound and PERF.md keeps
// the numbers.

#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>

namespace {
namespace mma {


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

cudaError_t launch(const int8_t* x, const int8_t* w, const float* xs, const float* ws,
                   float* out, int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const bool vec = K % 16 == 0 && N % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 8 == 0;
  if (vec) {
    quant_matmul_kernel<true><<<grid, kThreads, 0, stream>>>(x, w, xs, ws, out, M, N, K);
  } else {
    quant_matmul_kernel<false><<<grid, kThreads, 0, stream>>>(x, w, xs, ws, out, M, N, K);
  }
  return cudaGetLastError();
}

}  // namespace mma

namespace tma {

// mirrored by layout.py
constexpr int kBM = 128, kBN = 256, kBK = 128, kStages = 4;
constexpr int kConsumers = 2;                      // warpgroups issuing wgmma
constexpr int kThreads = 128 * kConsumers + 32;    // + one producer warp
constexpr int kWBox = 128;                         // n bytes per TMA box of w
constexpr int kXBytes = kBM * kBK;                 // 16 KB
constexpr int kWBoxBytes = kWBox * kBK;            // 16 KB
constexpr int kStageBytes = kXBytes + kBN * kBK;   // 48 KB
constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 2 * kStages * 8;  // + alignment, barriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// K-major operand, 128-byte swizzle: 8-row groups 1,024 bytes apart
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator registers across wgmma
__device__ __forceinline__ void fence_regs(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
      "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
      "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
      "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
      "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
      "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// Thread (consumer, warp, g = lane / 4, t = lane % 4)'s A registers for the
// kk-th 32 bytes of K of a stage (layout.py a_fragment): the words at rows
// k = 32 kk + 16 p + 4 t + ((i + 2 (t / 2)) & 3), bytes cb .. cb + 3 of its
// w box, transposed; column j goes to slab j / 2, register (j % 2) + 2 p.
// Threads t = 2, 3 load their four rows rotated by two, so the rows of one
// load instruction fall in four different pairs of swizzle phases and its
// 32 words in 32 banks (layout.py bank_wavefronts); the rotation is undone
// by the last byte permutes' selectors (lo, hi), at no cost.
__device__ __forceinline__ void a_fragment(const uint8_t* box, int cb, int t, int kk,
                                           uint32_t lo, uint32_t hi, uint32_t (&a)[2][4]) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 32 * kk + 16 * p + 4 * t + ((i + 2 * (t >> 1)) & 3);
      const int off = row * 128 + ((((cb >> 4) ^ (row & 7)) << 4) | (cb & 15));
      r[i] = *reinterpret_cast<const uint32_t*>(box + off);
    }
    const uint32_t p0 = __byte_perm(r[0], r[1], 0x5140), p1 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t p2 = __byte_perm(r[2], r[3], 0x5140), p3 = __byte_perm(r[2], r[3], 0x7362);
    a[0][2 * p] = __byte_perm(p0, p2, lo);
    a[0][2 * p + 1] = __byte_perm(p0, p2, hi);
    a[1][2 * p] = __byte_perm(p1, p3, lo);
    a[1][2 * p + 1] = __byte_perm(p1, p3, hi);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    quant_matmul_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap wmap,
                            const float* __restrict__ xs, const float* __restrict__ ws,
                            float* __restrict__ out, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  // every stage buffer on a 1,024-byte boundary (the swizzle's atom)
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + kStages * kStageBytes;  // kStages full, then kStages empty
  const uint32_t empty0 = full0 + kStages * 8;

  const int tiles_m = (M + kBM - 1) / kBM;
  const int tiles = tiles_m * ((N + kBN - 1) / kBN);
  const int k_steps = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * kConsumers);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {  // the producer warp; its lane 0 issues every load
    if (threadIdx.x % 32 != 0) return;
    int stage = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % tiles_m) * kBM, n0 = (tile / tiles_m) * kBN;
      for (int ks = 0; ks < k_steps; ++ks) {
        const uint32_t full = full0 + 8 * stage, buf = base + stage * kStageBytes;
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        mbar_expect_tx(full, kStageBytes);
        tma_load(buf, &xmap, ks * kBK, m0, full);
#pragma unroll
        for (int c = 0; c < kBN / kWBox; ++c) {
          tma_load(buf + kXBytes + c * kWBoxBytes, &wmap, n0 + c * kWBox, ks * kBK, full);
        }
        if (++stage == kStages) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  // a consumer warpgroup: slabs of n nl + 2 s + h for h = 0, 1 (layout.py n_of)
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int cb = 32 * warp + 4 * g;  // byte column in this warpgroup's w box
  const int nl = wg * 128 + cb;      // the thread's first n in the tile
  const uint32_t lo = t < 2 ? 0x5410 : 0x1054, hi = t < 2 ? 0x7632 : 0x3276;
  int acc[2][64] = {};
  int stage = 0, phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile % tiles_m) * kBM, n0 = (tile / tiles_m) * kBN;
    for (int ks = 0; ks < k_steps; ++ks) {
      mbar_wait(full0 + 8 * stage, phase);
      const uint8_t* box = smem + stage * kStageBytes + kXBytes + wg * kWBoxBytes;
      const uint32_t xbuf = base + stage * kStageBytes;
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) {
        uint32_t a[2][4];
        a_fragment(box, cb, t, kk, lo, hi, a);
        const uint64_t desc = desc_sw128(xbuf + 32 * kk);
        const int scale_d = (ks | kk) != 0;
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        wgmma_fence();
        wgmma_m64n128k32(acc[0], a[0], desc, scale_d);
        wgmma_m64n128k32(acc[1], a[1], desc, scale_d);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc[0]);
        fence_regs(acc[1]);
      }
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);  // this warp is done with the stage
      if (++stage == kStages) stage = 0, phase ^= 1;
    }

    // epilogue: register 4 j + 2 h + e of slab s is (n = nl + 2 s + h,
    // m = 8 j + 2 t + e); n % 4 == 0 and N % 16 == 0, so the four n of a
    // thread are all in range or all out
    const int n = n0 + nl;
    if (n < N) {
      const float w0 = ws[n], w1 = ws[n + 1], w2 = ws[n + 2], w3 = ws[n + 3];
#pragma unroll
      for (int j = 0; j < kBM / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + 8 * j + 2 * t + e;
          if (m < M) {
            const float sx = xs[m];
            float4 v;
            v.x = __int2float_rn(acc[0][4 * j + e]) * sx * w0;
            v.y = __int2float_rn(acc[0][4 * j + 2 + e]) * sx * w1;
            v.z = __int2float_rn(acc[1][4 * j + e]) * sx * w2;
            v.w = __int2float_rn(acc[1][4 * j + 2 + e]) * sx * w3;
            *reinterpret_cast<float4*>(out + static_cast<long long>(m) * N + n) = v;
          }
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// An int8 [rows, cols] row-major tensor read in boxes of box_cols (bytes)
// x box_rows, 128-byte swizzle, zeros past the edges.
cudaError_t encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rows, int cols,
                   int box_cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t launch(const int8_t* x, const int8_t* w, const float* xs, const float* ws,
                   float* out, int M, int N, int K, cudaStream_t stream) {
  static EncodeTiled encode_fn = nullptr;
  static bool smem_set = false;
  if (encode_fn == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorSymbolNotFound;
    encode_fn = reinterpret_cast<EncodeTiled>(fn);
  }
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(quant_matmul_tma_kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  CUtensorMap xmap, wmap;
  cudaError_t e = encode(encode_fn, &xmap, x, M, K, kBK, kBM);
  if (e == cudaSuccess) e = encode(encode_fn, &wmap, w, K, N, kWBox, kBK);
  if (e != cudaSuccess) return e;
  int device = 0, sms = 0;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const long long tiles =
      static_cast<long long>((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  quant_matmul_tma_kernel<<<grid, kThreads, kSmemBytes, stream>>>(xmap, wmap, xs, ws, out, M,
                                                                  N, K);
  return cudaGetLastError();
}

}  // namespace tma
}  // namespace

// kernel 0: the TMA kernel (K % 16 == 0, N % 16 == 0, K > 0, x, w and out
// 16-byte aligned); kernel 1: the mma.sync kernel (any layout).
// x: int8 [M, K], w: int8 [K, N], xs: float32 [M], ws: float32 [N], out:
// float32 [M, N], all contiguous on the current device; M, N >= 1,
// 0 <= K <= 131071 (so no int32 sum can overflow).  Launches on `stream`;
// returns the cudaError_t of the launch (0 = success).
extern "C" int da4ml_quant_matmul(int kernel, const int8_t* x, const int8_t* w, const float* xs,
                                  const float* ws, float* out, int M, int N, int K,
                                  void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || K > 131071) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (kernel == 0) {
    const bool tma_ok = K > 0 && K % 16 == 0 && N % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (!tma_ok) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(tma::launch(x, w, xs, ws, out, M, N, K, s));
  }
  if (kernel != 1 || (M + mma::kBM - 1) / mma::kBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(mma::launch(x, w, xs, ws, out, M, N, K, s));
}

extern "C" const char* da4ml_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
