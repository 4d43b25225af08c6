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
// The rows' log-sum-exp comes from the forward: on the autograd path the
// forward kernel that flash_plan picks (decode, tensor-core or CUDA-core)
// writes it, in base 2 of the scaled logits (+inf for a row that sees no
// key, so every p of that row is 0), and _FlashAttention saves it.  No
// kernel here recomputes it.
//
// bf16 (the training path), two launches:
//  1. delta (fa_bwd_delta): one warp per row, dO . O in f32.
//  2. one grid of two kinds of blocks (fa_bwd_wgmma), each of one consumer
//     warpgroup and one producer warp.  The first blocks each own 64 keys
//     of one KV head and write their dK and dV; the others each own 64
//     query rows of one query head and write their dQ (design (a): a dQ
//     block streams the keys itself, so nothing is added across blocks and
//     no scratch or semaphore is needed).  Every output element is written
//     by one block, every sum is taken in a fixed order: two launches give
//     the same bits (crash recovery resumes to the same parameters).
//     - dK/dV block: K and V (64 keys) stay in shared memory; the group's
//       query heads, and within each the query tiles from the first row
//       that sees the block's keys, stream through a ring (4 stages at
//       head dim 64, 2 at 128): Q and dO tiles by TMA (128-byte swizzle,
//       zeros past the tensor's edges),
//       the tile's lse and delta by the producer warp's lanes (+inf and 0
//       past Sq, so a row past the end has p = 0), full and empty
//       mbarriers between the producer and the warpgroup.  Per tile, four
//       warpgroup products (wgmma.m64nNk16, f32 accumulation): S^T = K Q^T
//       and dP^T = V dO^T with both operands in shared memory (K-major),
//       then P^T and dS^T, rounded to bf16 as FA2 does (ROADMAP Queue 3
//       "Flash in bf16"), stay in registers as the A operand of
//       dV += P^T dO and dK += dS^T Q, whose B operands are the same Q and
//       dO tiles read MN-major.  S^T and dP^T are two commit groups: P^T's
//       exponentials run while dP^T is on the tensor cores, dS^T's while
//       dV is; only the tiles on the causal diagonal are masked.  dK and
//       dV stay in registers over the whole group, summed in the order of
//       its heads.
//     - dQ block: Q and dO (64 rows) stay in shared memory, its rows' lse
//       and delta in registers; the keys up to its causal frontier stream
//       through the same ring (K and V tiles of 64 keys by TMA); per tile
//       three products: S = Q K^T, dP = dO V^T (P's exponentials overlap
//       dP), then dQ += dS K with dS in registers and K read MN-major.
//     The grid is flash_bwd_plan's (kernel.py): ceil(Sk / 64) Hkv B dK/dV
//     blocks first (the longer ones start first), then ceil(Sq / 64) Hq B
//     dQ blocks, so the dQ blocks fill the SMs the dK/dV blocks leave
//     (smollm-135m's step at seq 128: 48 + 144 blocks, where dK/dV alone
//     would be 48 on 132 SMs).  Head dims: D <= 64 runs padded to 64
//     (the wrapper pads 16 and 32; the ring's query tiles are 64 rows),
//     80 to 128 runs at 128 (TMA fills the columns past D with zeros;
//     query tiles of 32 rows, so S^T, dP^T, dK and dV fit the registers).
//     The tensor maps are 3-d (tma_load, encode): the model's q, k, v and
//     dO, [B, S, H, D] viewed as [B, H, S, D], are read where they lie at
//     small sizes (layout SEQ, a template parameter); kernel.py copies
//     them to [B, H, S, D] first at large ones, where reading 128-byte rows
//     a head apart made the kernel 1.6x as slow on the H100 (412 against
//     260 us at seq 1024, batch 16).  Two bigger-tile variants were tried
//     and dropped: two consumer warpgroups sharing each streamed tile
//     (slower at head dim 64, 15% faster only at internvl2-26b's 384 rows
//     at 128, and spilling there), and 4-d tensor maps (the same 1.6x).
//
// f32 (the CUDA cores, left as PR 20 wrote them but for reading the
// stored lse): fa_bwd_dq_simt (delta of its rows, then dQ) and
// fa_bwd_dkdv_simt; all in f32, no TF32.
//
// What bounds it on this card.  Five causal products of 2 S^2 D / 2 flops
// per head (S^T, dP^T, dV, dK, and dQ's S, dP, dQ counted once each: the dQ
// blocks recompute S and dP), against the bytes of q, k, v, o, dO, dq, dk,
// dv once each.  At smollm-135m's training step (q [8, 9, 128, 64], bf16)
// that is ~1.9 us of bytes and ~0.6 us of products: latency bounds it, and
// the design keeps every SM busy and each tile's loads in flight while the
// previous tile is computed.  At seq 1024, batch 16 the products bound it
// (~48 GFLOP a call, ~49 us at 989 TFLOP/s): they run on wgmma, the only
// way to the tensor cores' rate, from swizzled tiles that TMA brings in.
// The softmax part (an exp2 per pair, in both kinds of blocks) runs on the
// CUDA cores between the products; ptxas serialises the wgmma of a
// warpgroup around the divergent paths (C7520), and overlapping one
// warpgroup's softmax with another's products (FA3's ping-pong) is left
// for later.  PERF.md keeps the times.

#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;  // the f32 kernels' block, and one warpgroup
constexpr float kLog2e = 1.44269504088896341f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  const float* lse;
  float* delta;
  int B, Hq, Hkv, Sq, Sk, head_dim;
  const long long* strides;  // bf16: the element strides of q, k, v, dO (batch, head, row)
  int seq;                   // bf16: the tensor maps merge rows with batches (tma_load)
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
// bf16: mbarriers, TMA and wgmma
// ---------------------------------------------------------------------
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

// One box (columns c0 .. c0 + 63 of rows row .. of head h of batch b) of a
// [B, H, S, D] tensor into shared memory, through a 3-d tensor map that
// merges two of its dims (encode, below): heads with batches, coordinates
// (column, row, b H + h); or (SEQ), where a batch's rows are evenly
// strided across its heads (the model's [B, S, H, D] viewed as
// [B, H, S, D]), rows with batches, (column, h, b S + row).  The layout is
// a template parameter: on the H100 a 4-d map over the same tiles, and a
// layout chosen at run time, each made the kernel take ~1.55x as long.
template <bool SEQ>
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int H, int S,
                                         int c0, int row, int h, int b, uint32_t bar) {
  int c1, c2;
  if constexpr (SEQ) {
    c1 = h, c2 = b * S + row;
  } else {
    c1 = row, c2 = b * H + h;
  }
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// A wgmma operand descriptor: 128-byte swizzle, offsets in bytes.
__device__ __forceinline__ uint64_t desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// A tile of `rows` rows and 64 (or 128) bf16 columns as TMA writes it:
// column block c (64 columns, 128 bytes a row) at c * rows * 128 bytes,
// row r at r * 128 within it, 16-byte chunks swizzled in 8-row atoms.
// K-major (the product's depth runs along the columns): k-step kk is 16
// columns, 32 bytes into its column block; 8-row groups 1,024 bytes apart.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int kk) {
  return desc(tile + (kk >> 2) * rows * 128 + (kk & 3) * 32, 16, 1024);
}
// MN-major (the depth runs along the rows): k-step kk is rows 16 kk ..
// 16 kk + 15, 2,048 bytes on; 8-row groups 1,024 bytes apart (SBO), column
// blocks rows * 128 bytes apart (LBO).
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int kk) {
  return desc(tile + kk * 2048, rows * 128, 1024);
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

__device__ __forceinline__ float fast_exp2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// keeps the compiler from moving accumulator registers across wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, f32) = or += A (64 x 16, shared) B (16 x N, shared), both
// K-major; N = 32 or 64 (N / 2 accumulators a thread).
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N, f32) = or += A (64 x 16, registers: bf16 pairs in the mma
// fragment layout) B (16 x N, shared, MN-major); N = 64 or 128.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// delta_i = sum_d dO_id O_id, one warp per row (D even; o contiguous, dO
// with the element strides dsb, dsh, dss of its batch, head and sequence
// dims); block (x, h, b) takes rows 4 x .. 4 x + 3 of head h of batch b.
__global__ void __launch_bounds__(kThreads) fa_bwd_delta(const __nv_bfloat16* __restrict__ o,
                                                          const __nv_bfloat16* __restrict__ dout,
                                                          float* __restrict__ delta, int S,
                                                          int D, long long dsb, long long dsh,
                                                          long long dss) {
  const int i = blockIdx.x * (kThreads / 32) + threadIdx.x / 32, h = blockIdx.y, b = blockIdx.z;
  if (i >= S) return;
  const int lane = threadIdx.x % 32;
  const long long row = (static_cast<long long>(b) * gridDim.y + h) * S + i;
  const auto* o2 = reinterpret_cast<const __nv_bfloat162*>(o + row * D);
  const auto* d2 = reinterpret_cast<const __nv_bfloat162*>(dout + b * dsb + h * dsh + i * dss);
  float s = 0.f;
  for (int c = lane; c < D / 2; c += 32) {
    const float2 a = __bfloat1622float2(o2[c]), b = __bfloat1622float2(d2[c]);
    s = fmaf(a.x, b.x, s);
    s = fmaf(a.y, b.y, s);
  }
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

constexpr int kTileRows = 64;  // keys (dK/dV) or query rows (dQ) of a block; keys of a dQ step
constexpr int kWgThreads = kThreads + 32;  // one consumer warpgroup and the producer warp

// The fused kernel's shared memory; DP the padded head dim (64 or 128).
template <int DP>
struct Wg {
  static constexpr int BQ = DP == 64 ? 64 : 32;     // query rows of a dK/dV step
  static constexpr int kTile = kTileRows * DP * 2;  // bytes of a 64-row tile
  static constexpr int kQTile = BQ * DP * 2;
  static constexpr int kDkdvStage = 2 * kQTile + 2 * BQ * 4;  // Q, dO; lse, delta
  static constexpr int kDqStage = 2 * kTile;                  // K, V
  static constexpr int kStage =
      ((kDkdvStage > kDqStage ? kDkdvStage : kDqStage) + 1023) / 1024 * 1024;
  // the ring: 4 stages at 64 (87 KB, two blocks an SM), 2 at 128 (99 KB);
  // measured on the H100 at seq 1024, batch 16, 2 or 3 stages at 64 were
  // within 2% of 4
  static constexpr int kStages = DP == 64 ? 4 : 2;
  // + up to 1,023 bytes to align the tiles on the swizzle's 1,024-byte atom; barriers
  static constexpr int kBytes = 1024 + 2 * kTile + kStages * kStage + (2 * kStages + 1) * 8;
};

struct WgArgs {
  __nv_bfloat16 *dq, *dk, *dv;
  const float *lse, *delta;
  int B, Hq, Hkv, Sq, Sk, D;
  float scale;
  int causal, offset;
  int n_dkdv;  // blocks [0, n_dkdv) own keys, the rest own query rows
};

template <int DP, bool SEQ>
__global__ void __launch_bounds__(kWgThreads, 1)
    fa_bwd_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap,
                 const WgArgs g) {
  using C = Wg<DP>;
  constexpr int BQ = C::BQ, KB = DP / 64, kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t res0 = base, res1 = base + C::kTile;  // K, V (dK/dV) or Q, dO (dQ)
  const uint32_t ring = base + 2 * C::kTile;
  const uint32_t full0 = ring + kStages * C::kStage, empty0 = full0 + 8 * kStages;
  const uint32_t res_bar = empty0 + 8 * kStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 32);  // the producer's 32 lanes (lane 0's with the bytes)
      mbar_init(empty0 + 8 * s, 4);  // one arrival per consumer warp
    }
    mbar_init(res_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int G = g.Hq / g.Hkv;
  const float sl2 = g.scale * kLog2e;
  const int grp = lane >> 2, tig = lane & 3;  // accumulator fragment: row group, thread in group
  const bool producer = warp == 4;

  if (static_cast<int>(blockIdx.x) < g.n_dkdv) {
    // ---------------- dK and dV of 64 keys of one KV head ----------------
    const int n_kt = (g.Sk + kTileRows - 1) / kTileRows;
    const int kt = blockIdx.x % n_kt, hk = (blockIdx.x / n_kt) % g.Hkv;
    const int b = blockIdx.x / n_kt / g.Hkv;
    const int k0 = kt * kTileRows, khead = b * g.Hkv + hk;
    // the first query row that sees any of the block's keys, its tile, and
    // the tiles per query head
    long long first = g.causal ? static_cast<long long>(k0) - g.offset : 0;
    first = first < 0 ? 0 : first;
    const int n_qt = (g.Sq + BQ - 1) / BQ;
    const int qt0 = first < g.Sq ? static_cast<int>(first / BQ) : n_qt;
    const int per_head = n_qt - qt0, total = G * per_head;

    if (producer) {
      if (lane == 0) {
        mbar_expect_tx(res_bar, 2 * C::kTile);
#pragma unroll
        for (int c = 0; c < KB; ++c) {
          const uint32_t at = c * kTileRows * 128;
          tma_load<SEQ>(res0 + at, &kmap, g.Hkv, g.Sk, 64 * c, k0, hk, b, res_bar);
          tma_load<SEQ>(res1 + at, &vmap, g.Hkv, g.Sk, 64 * c, k0, hk, b, res_bar);
        }
      }
      // each step's lse and delta, read one step ahead into registers
      constexpr int kPer = BQ / 32;
      float pl[kPer], pd[kPer];
      auto fetch = [&](int i) {
        const int q0 = (qt0 + i % per_head) * BQ, qhead = b * g.Hq + hk * G + i / per_head;
#pragma unroll
        for (int m = 0; m < kPer; ++m) {
          const int r = q0 + lane + 32 * m;
          const long long at = static_cast<long long>(qhead) * g.Sq + r;
          pl[m] = r < g.Sq ? g.lse[at] : CUDART_INF_F;  // a row past Sq: p = 0
          pd[m] = r < g.Sq ? g.delta[at] : 0.f;
        }
      };
      if (total > 0) fetch(0);
      for (int i = 0; i < total; ++i) {
        const int s = i % kStages, ph = (i / kStages) & 1;
        const int q0 = (qt0 + i % per_head) * BQ, h = hk * G + i / per_head;
        const uint32_t st = ring + s * C::kStage, full = full0 + 8 * s;
        float* lse_s =
            reinterpret_cast<float*>(smem + 2 * C::kTile + s * C::kStage + 2 * C::kQTile);
        mbar_wait(empty0 + 8 * s, ph ^ 1);
#pragma unroll
        for (int m = 0; m < kPer; ++m) {
          lse_s[lane + 32 * m] = pl[m];
          lse_s[BQ + lane + 32 * m] = pd[m];
        }
        if (lane == 0) {
          mbar_expect_tx(full, 2 * C::kQTile);
#pragma unroll
          for (int c = 0; c < KB; ++c) {
            tma_load<SEQ>(st + c * BQ * 128, &qmap, g.Hq, g.Sq, 64 * c, q0, h, b, full);
            tma_load<SEQ>(st + C::kQTile + c * BQ * 128, &dmap, g.Hq, g.Sq, 64 * c, q0, h, b,
                          full);
          }
        } else {
          mbar_arrive(full);
        }
        if (i + 1 < total) fetch(i + 1);
      }
      return;
    }

    // the consumer warpgroup: rows 16 warp + grp (+ 8) of the 64 keys
    const long long key_a = k0 + 16 * warp + grp, key_b = key_a + 8;
    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(res_bar, 0);
    for (int i = 0; i < total; ++i) {
      const int s = i % kStages, ph = (i / kStages) & 1;
      const int q0 = (qt0 + i % per_head) * BQ;
      const uint32_t qs = ring + s * C::kStage, dos = qs + C::kQTile;
      const float* lse_s =
          reinterpret_cast<const float*>(smem + 2 * C::kTile + s * C::kStage + 2 * C::kQTile);
      const float* delta_s = lse_s + BQ;
      mbar_wait(full0 + 8 * s, ph);
      // a step whose rows all see every key of the block needs no mask (the
      // first step is the first whose last row sees one)
      const long long seen = static_cast<long long>(g.offset) + q0 - k0;  // row 0's last key
      const bool masked = g.causal && seen < kTileRows - 1;
      const int sn = masked ? static_cast<int>(seen) : 0;  // in [1 - BQ, 62] when masked
      float st[BQ / 2], dpt[BQ / 2];  // S^T and dP^T: 64 keys x BQ query rows
      // S^T, then dP^T, as two groups: P^T's exponentials overlap dP^T
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wgmma_ss(st, desc_k(res0, kTileRows, kk), desc_k(qs, BQ, kk), kk);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wgmma_ss(dpt, desc_k(res1, kTileRows, kk), desc_k(dos, BQ, kk), kk);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);

      // P^T: register 4 j + 2 h + e holds key row grp + 8 h and query
      // column 8 j + 2 tig + e; row c sees key row r when r - c <= seen
      const int ra = 16 * warp + grp;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * tig + e;
          const float lse = lse_s[c];
          const float pa = fast_exp2(st[4 * j + e] * sl2 - lse);
          const float pb = fast_exp2(st[4 * j + 2 + e] * sl2 - lse);
          st[4 * j + e] = masked && ra - c > sn ? 0.f : pa;
          st[4 * j + 2 + e] = masked && ra + 8 - c > sn ? 0.f : pb;
        }
      }
      // dV += P^T dO, issued while dS^T is computed: the accumulator
      // layout of 16 query columns is the A fragment of a k-step, rounded
      // to bf16
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(st[8 * kk], st[8 * kk + 1]),
                               pack_bf16(st[8 * kk + 2], st[8 * kk + 3]),
                               pack_bf16(st[8 * kk + 4], st[8 * kk + 5]),
                               pack_bf16(st[8 * kk + 6], st[8 * kk + 7])};
        wgmma_rs(dv, a, desc_mn(dos, BQ, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // dP^T (the groups complete in order)
      fence_regs(dpt);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dl = delta_s[8 * j + 2 * tig + e];
          dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - dl);  // dS^T
          dpt[4 * j + 2 + e] = st[4 * j + 2 + e] * (dpt[4 * j + 2 + e] - dl);
        }
      }
      // dK += dS^T Q
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(dpt[8 * kk], dpt[8 * kk + 1]),
                               pack_bf16(dpt[8 * kk + 2], dpt[8 * kk + 3]),
                               pack_bf16(dpt[8 * kk + 4], dpt[8 * kk + 5]),
                               pack_bf16(dpt[8 * kk + 6], dpt[8 * kk + 7])};
        wgmma_rs(dk, a, desc_mn(qs, BQ, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      if (lane == 0) mbar_arrive(empty0 + 8 * s);  // this warp is done with the stage
    }

    // dK (times scale) and dV: register 4 j + 2 h + e is key row grp + 8 h,
    // column 8 j + 2 tig + e
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long key = h == 0 ? key_a : key_b;
      if (key >= g.Sk) continue;
      const long long at = (static_cast<long long>(khead) * g.Sk + key) * g.D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * tig;
        if (col < g.D) {
          *reinterpret_cast<__nv_bfloat162*>(g.dk + at + col) = __floats2bfloat162_rn(
              dk[4 * j + 2 * h] * g.scale, dk[4 * j + 2 * h + 1] * g.scale);
          *reinterpret_cast<__nv_bfloat162*>(g.dv + at + col) =
              __floats2bfloat162_rn(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
        }
      }
    }
    return;
  }

  // ---------------- dQ of 64 query rows of one query head ----------------
  const int idx = blockIdx.x - g.n_dkdv;
  const int n_qt = (g.Sq + kTileRows - 1) / kTileRows;
  const int qt = idx % n_qt, h = (idx / n_qt) % g.Hq, b = idx / n_qt / g.Hq;
  const int q0 = qt * kTileRows, qhead = b * g.Hq + h;
  const long long n_keys =
      keys_upto(g.offset + static_cast<long long>(min(g.Sq, q0 + kTileRows)) - 1, g.Sk,
                g.causal);
  const int n_kt = static_cast<int>((n_keys + kTileRows - 1) / kTileRows);

  if (producer) {
    if (lane == 0) {
      mbar_expect_tx(res_bar, 2 * C::kTile);
#pragma unroll
      for (int c = 0; c < KB; ++c) {
#pragma unroll
        for (int r = 0; r < kTileRows; r += BQ) {  // the Q and dO maps' boxes are BQ rows
          const uint32_t at = (c * kTileRows + r) * 128;
          tma_load<SEQ>(res0 + at, &qmap, g.Hq, g.Sq, 64 * c, q0 + r, h, b, res_bar);
          tma_load<SEQ>(res1 + at, &dmap, g.Hq, g.Sq, 64 * c, q0 + r, h, b, res_bar);
        }
      }
    }
    for (int i = 0; i < n_kt; ++i) {
      const int s = i % kStages, ph = (i / kStages) & 1;
      const uint32_t st = ring + s * C::kStage, full = full0 + 8 * s;
      mbar_wait(empty0 + 8 * s, ph ^ 1);
      if (lane == 0) {
        mbar_expect_tx(full, 2 * C::kTile);
#pragma unroll
        for (int c = 0; c < KB; ++c) {
          tma_load<SEQ>(st + c * kTileRows * 128, &kmap, g.Hkv, g.Sk, 64 * c, i * kTileRows,
                        h / G, b, full);
          tma_load<SEQ>(st + C::kTile + c * kTileRows * 128, &vmap, g.Hkv, g.Sk, 64 * c,
                        i * kTileRows, h / G, b, full);
        }
      } else {
        mbar_arrive(full);
      }
    }
    return;
  }

  // the consumer warpgroup: rows 16 warp + grp (+ 8) of the 64
  const int r16 = 16 * warp + grp;  // row a within the 64
  const int ra = q0 + r16, rb = ra + 8;
  const long long at_a = static_cast<long long>(qhead) * g.Sq + ra, at_b = at_a + 8;
  const float lse_a = ra < g.Sq ? g.lse[at_a] : CUDART_INF_F;
  const float lse_b = rb < g.Sq ? g.lse[at_b] : CUDART_INF_F;
  const float dl_a = ra < g.Sq ? g.delta[at_a] : 0.f;
  const float dl_b = rb < g.Sq ? g.delta[at_b] : 0.f;
  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  mbar_wait(res_bar, 0);
  for (int i = 0; i < n_kt; ++i) {
    const int s = i % kStages, ph = (i / kStages) & 1;
    const uint32_t kst = ring + s * C::kStage, vst = kst + C::kTile;
    const long long t0 = static_cast<long long>(i) * kTileRows;
    mbar_wait(full0 + 8 * s, ph);
    // a tile whose keys every row of the warpgroup sees needs no mask;
    // else key column kc counts for row r when kc < kmax and kc - r <= lim
    const long long lim_ll = g.causal ? static_cast<long long>(g.offset) + q0 - t0 : 1 << 20;
    const bool masked = lim_ll < kTileRows - 1 || t0 + kTileRows > g.Sk;
    const int lim = static_cast<int>(lim_ll < kTileRows ? lim_ll : kTileRows);
    const int kmax = static_cast<int>(g.Sk - t0 < kTileRows ? g.Sk - t0 : kTileRows);
    float sc[kTileRows / 2], dp[kTileRows / 2];  // S and dP: 64 rows x 64 keys
    // S, then dP, as two groups: P's exponentials overlap dP
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss(sc, desc_k(res0, kTileRows, kk), desc_k(kst, kTileRows, kk), kk);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss(dp, desc_k(res1, kTileRows, kk), desc_k(vst, kTileRows, kk), kk);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);
#pragma unroll
    for (int j = 0; j < kTileRows / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = 8 * j + 2 * tig + e;
        const float pa = fast_exp2(sc[4 * j + e] * sl2 - lse_a);
        const float pb = fast_exp2(sc[4 * j + 2 + e] * sl2 - lse_b);
        sc[4 * j + e] = masked && (kc >= kmax || kc - r16 > lim) ? 0.f : pa;
        sc[4 * j + 2 + e] = masked && (kc >= kmax || kc - r16 - 8 > lim) ? 0.f : pb;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < kTileRows / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - dl_a);  // dS
        dp[4 * j + 2 + e] = sc[4 * j + 2 + e] * (dp[4 * j + 2 + e] - dl_b);
      }
    }

    // dQ += dS K: K read MN-major (the keys are the depth)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileRows / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(dp[8 * kk], dp[8 * kk + 1]),
                             pack_bf16(dp[8 * kk + 2], dp[8 * kk + 3]),
                             pack_bf16(dp[8 * kk + 4], dp[8 * kk + 5]),
                             pack_bf16(dp[8 * kk + 6], dp[8 * kk + 7])};
      wgmma_rs(dq, a, desc_mn(kst, kTileRows, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = hh == 0 ? ra : rb;
    if (row >= g.Sq) continue;
    __nv_bfloat16* out = g.dq + (static_cast<long long>(qhead) * g.Sq + row) * g.D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * tig;
      if (col < g.D) {
        *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(
            dq[4 * j + 2 * hh] * g.scale, dq[4 * j + 2 * hh + 1] * g.scale);
      }
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
  float delta[kPerWarp], lse[kPerWarp];
  long long pos[kPerWarp];
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    const long long row = q0 + r0 + r;
    float part = 0.f;
    if (row < g.Sq) {
      for (int d = lane; d < D; d += 32) part += dout[row * D + d] * o[row * D + d];
    }
    delta[r] = warp_sum(part);
    lse[r] = row < g.Sq ? g.lse[qhead + row] : CUDART_INF_F;  // base 2, from the forward
    pos[r] = g.offset + row;
    if (lane == 0 && row < g.Sq) g.delta[qhead + row] = delta[r];
  }
  const long long n_keys =
      keys_upto(g.offset + static_cast<long long>(min(g.Sq, q0 + kSimtRows)) - 1, g.Sk, g.causal);
  const float sl2 = g.scale * kLog2e;

  auto logits = [&](float (&s)[kPerWarp], float (&dp)[kPerWarp]) {
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = ks[lane][d], vd = vs[lane][d];
#pragma unroll
      for (int r = 0; r < kPerWarp; ++r) {
        s[r] = fmaf(qs[r0 + r][d], kd, s[r]);
        dp[r] = fmaf(dos[r0 + r][d], vd, dp[r]);
      }
    }
  };

  // dQ
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
    logits(s, dp);
    const long long j = t0 + lane;
    float ds[kPerWarp];
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r) {
      const bool vis = q0 + r0 + r < g.Sq && j < g.Sk && (!g.causal || j <= pos[r]);
      const float p = vis ? exp2f(s[r] * sl2 - lse[r]) : 0.f;
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
  const float sl2 = g.scale * kLog2e;

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
        p[r] = vis ? exp2f(s[r] * sl2 - lse_s[lane]) : 0.f;
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
cudaError_t launch_simt(const Args& a) {
  const cudaError_t err =
      launch_smem(fa_bwd_dq_simt<D>, dim3((a.Sq + kSimtRows - 1) / kSimtRows, a.Hq, a.B),
                  SimtLayout<D>::kBytes, a);
  if (err != cudaSuccess) return err;
  return launch_smem(fa_bwd_dkdv_simt<D>, dim3((a.Sk + kSimtRows - 1) / kSimtRows, a.Hkv, a.B),
                     SimtLayout<D>::kBytes, a);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A bf16 [B, H, rows, D] tensor with a unit stride on D and the element
// strides st (batch, head, row; multiples of 8) read in boxes of 64
// columns (128 bytes, the swizzle's span) by box_rows rows of one head,
// 128-byte swizzle, zeros past the edges; the two layouts of tma_load.
// Heads merged with batches (st[0] = H st[1] unless B = 1): dims (D, rows,
// B H), so rows past the end of a head read as zeros.  Rows merged with
// batches (seq; st[0] = rows st[2], rows % 64 == 0, so no box crosses a
// batch element): dims (D, H, B rows), the model's transposed views read
// where they lie.  Either way a box lands as box_rows rows of 128 bytes.
cudaError_t encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int B, int H, int rows,
                   int D, const long long* st, int box_rows, bool seq) {
  if (seq ? (B > 1 && st[0] != rows * st[2]) || rows % kTileRows != 0
          : B > 1 && st[0] != H * st[1]) {
    return cudaErrorInvalidValue;
  }
  const cuuint64_t d = static_cast<cuuint64_t>(D), h = static_cast<cuuint64_t>(H);
  const cuuint64_t s = static_cast<cuuint64_t>(rows), bb = static_cast<cuuint64_t>(B);
  const cuuint64_t dims[3] = {d, seq ? h : s, seq ? bb * s : bb * h};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(seq ? st[1] : st[2]) * 2,
                                 static_cast<cuuint64_t>(seq ? st[2] : st[1]) * 2};
  const cuuint32_t r = static_cast<cuuint32_t>(box_rows);
  const cuuint32_t box[3] = {64, seq ? 1u : r, seq ? r : 1u};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                          strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t encoder(EncodeTiled* out) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  *out = fn;
  return cudaSuccess;
}

template <int DP, bool SEQ>
cudaError_t launch_wgmma(const Args& a, int n_dkdv, int n_dq) {
  using C = Wg<DP>;
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(fa_bwd_wgmma<DP, SEQ>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
    if (e != cudaSuccess) return e;
    opted = true;
  }
  EncodeTiled fn;
  cudaError_t e = encoder(&fn);
  CUtensorMap qmap, kmap, vmap, dmap;
  const long long* st = a.strides;  // q, k, v, dO: (batch, head, row) each
  const int D = a.head_dim;
  const int kr = kTileRows;
  if (e == cudaSuccess) e = encode(fn, &qmap, a.q, a.B, a.Hq, a.Sq, D, st, C::BQ, SEQ);
  if (e == cudaSuccess) e = encode(fn, &kmap, a.k, a.B, a.Hkv, a.Sk, D, st + 3, kr, SEQ);
  if (e == cudaSuccess) e = encode(fn, &vmap, a.v, a.B, a.Hkv, a.Sk, D, st + 6, kr, SEQ);
  if (e == cudaSuccess) e = encode(fn, &dmap, a.dout, a.B, a.Hq, a.Sq, D, st + 9, C::BQ, SEQ);
  if (e != cudaSuccess) return e;
  fa_bwd_delta<<<dim3((a.Sq + 3) / 4, a.Hq, a.B), kThreads, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.o), static_cast<const __nv_bfloat16*>(a.dout), a.delta,
      a.Sq, a.head_dim, st[9], st[10], st[11]);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const WgArgs w{static_cast<__nv_bfloat16*>(a.dq), static_cast<__nv_bfloat16*>(a.dk),
                 static_cast<__nv_bfloat16*>(a.dv), a.lse, a.delta, a.B, a.Hq, a.Hkv, a.Sq, a.Sk,
                 a.head_dim, a.scale, a.causal, a.offset, n_dkdv};
  fa_bwd_wgmma<DP, SEQ><<<n_dkdv + n_dq, kWgThreads, C::kBytes, a.stream>>>(
      qmap, kmap, vmap, dmap, w);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (wgmma).  q, o, dout, dq:
// [B, Hq, Sq, D]; k, v, dk, dv: [B, Hkv, Sk, D]; all 16-byte aligned; o and
// the outputs contiguous.  f32: q, k, v and dout contiguous too.  bf16:
// strides holds the element strides of q, k, v and dout (batch, head,
// sequence each; 12 values, multiples of 8), whose head dim is
// unit-strided; seq != 0: the four are read with rows merged with batches
// (encode says when that is allowed).  bf16 takes D = 64, 80, 112 or 128
// (the wrapper pads 16 and 32 to 64), f32 any of 16, 32, 64, 80, 112, 128.
// lse: the forward's f32 [B, Hq, Sq], base 2 of the scaled logits; delta:
// f32 scratch [B, Hq, Sq].  offset: the absolute position of q's first
// row.  n_dkdv, n_dq: the blocks of flash_bwd_plan (kernel.py), checked
// against the tiles compiled here.  Launches the kernels on `stream`;
// returns the cudaError_t of the launches (0 = success).
extern "C" int da4ml_flash_attention_bwd(int dtype, int head_dim, const void* q, const void* k,
                                         const void* v, const void* o, const void* dout,
                                         void* dq, void* dk, void* dv, const float* lse,
                                         float* delta, int B, int Hq, int Hkv, int Sq, int Sk,
                                         const long long* strides, int seq, float scale,
                                         int causal, int offset, int n_dkdv, int n_dq,
                                         void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 || Hq > 65535 ||
      B > 65535 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, o, dout, dq, dk, dv, lse, delta, B, Hq, Hkv, Sq, Sk, head_dim, strides,
               seq, scale, causal, offset, static_cast<cudaStream_t>(stream)};
  if (dtype == 1) {
    const long long want_dkdv = static_cast<long long>((Sk + kTileRows - 1) / kTileRows) * Hkv * B;
    const long long want_dq = static_cast<long long>((Sq + kTileRows - 1) / kTileRows) * Hq * B;
    if (n_dkdv != want_dkdv || n_dq != want_dq || want_dkdv + want_dq > 0x7fffffffLL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (head_dim != 64 && head_dim != 80 && head_dim != 112 && head_dim != 128) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (head_dim == 64) {
      return static_cast<int>(seq ? launch_wgmma<64, true>(a, n_dkdv, n_dq)
                                  : launch_wgmma<64, false>(a, n_dkdv, n_dq));
    }
    return static_cast<int>(seq ? launch_wgmma<128, true>(a, n_dkdv, n_dq)
                                : launch_wgmma<128, false>(a, n_dkdv, n_dq));
  }
  const long long want_dkdv = static_cast<long long>((Sk + kSimtRows - 1) / kSimtRows) * Hkv * B;
  const long long want_dq = static_cast<long long>((Sq + kSimtRows - 1) / kSimtRows) * Hq * B;
  if (n_dkdv != want_dkdv || n_dq != want_dq) return static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
    case 16:
      return static_cast<int>(launch_simt<16>(a));
    case 32:
      return static_cast<int>(launch_simt<32>(a));
    case 64:
      return static_cast<int>(launch_simt<64>(a));
    case 80:
      return static_cast<int>(launch_simt<80>(a));
    case 112:
      return static_cast<int>(launch_simt<112>(a));
    case 128:
      return static_cast<int>(launch_simt<128>(a));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* da4ml_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
