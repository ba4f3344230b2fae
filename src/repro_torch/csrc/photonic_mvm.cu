// Photonic MVM: int8 codes x int8 weight levels -> int32 accumulate ->
// float32 dequant. Hopper (sm_90a) port of the TPU kernel
// src/repro/kernels/photonic_mvm/kernel.py::mvm_int_kernel (body _mvm_kernel).
//
//   out[m, n] = ((float)sum_k a[m, k] * w[k, n] * act_scale) * ws[n]
//
// ws may be null: then out[m, n] = (float)acc * act_scale, which with
// act_scale = 1 is the raw accumulate the plan's unfused steps dequantize
// themselves (no scale vector to allocate per call).
//
// The levels come laid out once (kernels/photonic_mvm/ops.py::mvm_weights):
// wt [N, k_pad] int8, K contiguous, zero from K up to k_pad, a multiple of
// 128 bytes (one TMA box of K). A bound view lays them out at bind; a call
// on [K, N] levels lays them out per call. Either way one launch of
// mvm_layout_kernel does it (mvm_layout_launch): 128 x 64-byte tiles
// transposed through shared memory with 16-byte loads and stores (a torch
// copy of the transposed view moved fc1's 206 MB at ~0.27 TB/s, byte-wide
// 64 x 64 tiles at ~1.1).
//
// What bounds it on an H100 (the SXM data sheet's 3.35 TB/s and 1,979
// int8 TOP/s at its 700 W limit), at the shapes the main path gives it:
//   * VGG16's fc1-fc3 at a serving bucket (M = 1..16 rows of codes; fc1
//     8 x 25,088 x 4,096) read 103, 17 and 4 MB of levels for a few
//     hundred MOP: HBM bytes bound them (fc1 0.0308 ms at batch 8). The
//     stream route reads fc1's at 2.5-2.7 TB/s, 75-80% of the rate
//     (0.038-0.041 ms at batch 1 and 8; scripts/mvm_routes.py --time on an
//     NVIDIA H100 80GB HBM3 at 700 W). With 512-byte stages and 8 warps a
//     CTA it read them at 2.1 (0.049 ms).
//   * VGG16's conv11-13 as im2col GEMMs (1,568 x 4,608 x 512 at batch 8)
//     are 7.4 GOP over ~10 MB: the int8 tensor cores bound them
//     (0.0047 ms), and only wgmma reaches their full rate. The wgmma
//     route takes 0.014 ms (the same run), a third of that rate: 200
//     CTAs of 64 x 64 on 132 SMs, one warpgroup a CTA.
//   * The vision path's GEMMs (M <= 2,048, K <= 2,304, N <= 256) are a
//     few hundred MOP over a few MB: the launch and the K loop's latency,
//     not HBM or the tensor cores (2.5-7 us a call on every route).
//   * The imaging path's resident convs (M = 524,288, K <= 9, N <= 4)
//     are bytes-bound: ~9 MB per call, a handful of MACs per byte.
// The launcher takes a route and tile from the wrapper's plain Python
// function (ops.py::mvm_config), one route per shape; every CTA covers all
// of K (a K split over a cluster was built and measured, and was no faster
// at any path shape: ops.py::mvm_config):
//
//   stream  M <= 16 (the dense layers): the weight stream. The product is
//           computed transposed, out^T = W^T a^T: 16 output channels of
//           the laid-out levels are mma.m16n8k32's row-major A, the codes
//           its column-major B (one or two n8 tiles of batch rows), so no
//           zero row is multiplied. A producer warp streams 128-byte K
//           boxes of the levels by TMA (128-byte swizzle, conflict-free
//           ldmatrix; an evict-first L2 policy, so the codes stay in L2)
//           into a 4-stage mbarrier ring of 16 KB stages (64 KB in flight
//           a CTA, two CTAs an SM); sixteen consumer warps split each
//           stage's K, take the codes through __ldg (L2) one stage ahead,
//           and add their partial sums in shared memory.
//   wgmma   M > 16, K a multiple of 16 (conv11-13 and the vision GEMMs):
//           wgmma.mma_async m64n64k32 s32.s8.s8, both operands K-major in
//           shared memory in TMA's 128-byte swizzle: A the codes [M, K]
//           (a tensor map built per call on the host), B the laid-out
//           levels (its map built with the layout). A producer warp fills
//           a 4-stage ring of 128-byte K boxes; one consumer warpgroup
//           keeps one wgmma group in flight. 64 x 64 tiles (64 x 128 was
//           no faster at conv11-13 and slower at the vision GEMMs).
//   gemm    M > 16 with K not a multiple of 16 (a tensor map needs 16-byte
//           rows; the 1-channel im2col's K = 9): mma.sync m16n8k32 on
//           16 x 64 CTA tiles (four warps of 16 x 16), K in 32-byte steps
//           through a 3-stage cp.async ring. Ragged or unaligned codes are copied byte by
//           byte with zero fill, so the caller pads nothing.
//   skinny  N <= 8 and K <= 32 (the imaging convs): no tensor core. A CTA
//           copies a run of 1,024 rows of a (one contiguous span of bytes)
//           into shared memory with 16-byte cp.async, the levels (<= 256)
//           sit in shared memory, each thread sums its rows in int32 and
//           stores its N outputs with one vector store.
//
// Numerics: every accumulate is int32, exact in any order (the warps'
// partial sums included), so each route
// equals the plain version's exact integer product. The epilogue is
// __fmul_rn(__fmul_rn((float)acc, act_scale), ws[n]), or its first factor
// alone when ws is null: the reference's association, rounded step by
// step, never contracted.

#include <stdint.h>
#include <string.h>

#include "hopper.cuh"         // mbarriers, TMA, wgmma's sync, the encoder

namespace {

constexpr int BK = 32;                 // gemm: int8 per K step (m16n8k32)
constexpr int STAGES = 3;              // gemm: cp.async ring depth
constexpr int A_LD = BK + 16;          // gemm: smem row of a tile, 48 bytes,
                                       // so the fragment reads hit 32 banks
constexpr int GM_BM = 16;              // gemm: a CTA tile's rows
constexpr int GM_BN = 64;              // and columns, a warp's 16 of them
constexpr int GM_WN = GM_BN / 16;      // warps, side by side along N
constexpr int GM_THREADS = 32 * GM_WN;
constexpr int SK_THREADS = 256;
constexpr int SK_ROWS = 1024;          // rows of a that a skinny CTA stages
constexpr int SK_KMAX = 32;
constexpr int SK_NMAX = 8;

constexpr int KBOX = 128;              // bytes of K a TMA box (the swizzle)

constexpr int ST_CH = 16;              // stream: output channels a CTA
constexpr int ST_BOXES = 8;            // stream: K boxes a stage (1 KB)
constexpr int ST_STAGES = 4;
constexpr int ST_WARPS = 2 * ST_BOXES; // consumer warps, then one producer
constexpr int ST_THREADS = 32 * (ST_WARPS + 1);
constexpr int ST_BOX_BYTES = ST_CH * KBOX;
constexpr int ST_STAGE_BYTES = ST_BOXES * ST_BOX_BYTES;
constexpr int ST_TILE = 16 * ST_CH;    // int sums a warp: 16 rows x 16 ch

constexpr int WG_BM = 64;              // wgmma: a CTA tile's rows
constexpr int WG_BN = 64;              // and columns
constexpr int WG_STAGES = 4;
constexpr int WG_THREADS = 128 + 32;   // one consumer warpgroup, a producer

constexpr int LK = 128;                // layout: a CTA's bytes of K (a box)
constexpr int LN = 64;                 // and rows of N
constexpr int L_LD = LK + 4;           // its smem row: 33 words, odd
constexpr int LT_THREADS = 256;

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes) {
  const unsigned s = smem_u32(smem);
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(s), "l"(gmem));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// the same, read from HBM with an evict-first L2 policy (`policy`, from
// createpolicy): a stream of levels read once does not push out of L2 the
// codes every CTA reads again
__device__ __forceinline__ void tma_load_once(void* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int c0, int c1,
                                              uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;\n"
      :: "r"(smem_u32(dst)), "l"((uint64_t)map), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "l"(policy)
      : "memory");
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return (uint8_t*)(((uintptr_t)p + 1023) & ~(uintptr_t)1023);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float dequant(int acc, float act_scale,
                                         const float* __restrict__ ws,
                                         int n) {
  const float v = __fmul_rn((float)acc, act_scale);
  return ws != nullptr ? __fmul_rn(v, __ldg(ws + n)) : v;
}

// one m16n8k32 A fragment of a 128-byte-swizzled TMA box [16 rows][128 B]
// (1024-byte aligned): k32 step kk, rows 0-15; matrices 0-3 are rows 0-7
// and 8-15 of bytes 0-15, then of bytes 16-31 (a0..a3)
__device__ __forceinline__ void ldmatrix_a(uint32_t (&a)[4],
                                           const uint8_t* box, int kk,
                                           int lane) {
  const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = 2 * kk + (lane >> 4);
  const uint8_t* p = box + r * KBOX + ((c ^ (r & 7)) << 4);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(p)));
}

// wgmma's shared-memory descriptor of a K-major tile in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (the stride
// byte offset; the leading one is unused for a swizzled K-major tile)
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

// d += A (64 x 32 bytes) . B (64 x 32 bytes)^T, both K-major in smem
__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// four bytes of row `row` of the codes from byte k (low byte first), zero
// past M and K: one 32-bit load where K and a keep words aligned (vec)
__device__ __forceinline__ uint32_t code_word(const int8_t* __restrict__ a,
                                              int row, int k, int M, int K,
                                              int vec) {
  if (row >= M || k >= K) return 0u;
  const int8_t* p = a + (size_t)row * K + k;
  if (vec) return __ldg((const unsigned int*)p);
  uint32_t v = 0;
  for (int e = 0; e < 4 && k + e < K; ++e) {
    v |= (uint32_t)(uint8_t)__ldg(p + e) << (8 * e);
  }
  return v;
}

// One CTA: a 16 x 64 output tile over all of K. Four warps side by side,
// each 16 rows x 16 columns: NT = 2 m16n8 fragments. Smem per stage: the
// codes [16][A_LD] and the levels [64][A_LD], both K contiguous, so a
// fragment register is one 32-bit read.
__global__ void __launch_bounds__(GM_THREADS)
mvm_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ wt,
                const float* __restrict__ ws, float act_scale,
                float* __restrict__ out, int M, int N, int K, int k_pad,
                int vec_a) {
  constexpr int BM = GM_BM;
  constexpr int BN = GM_BN;
  constexpr int THREADS = GM_THREADS;
  constexpr int NT = 2;
  __shared__ __align__(16) int8_t as[STAGES][BM * A_LD];
  __shared__ __align__(16) int8_t bs[STAGES][BN * A_LD];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wn = tid >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int m0 = blockIdx.x * BM;          // x: no 65,535 limit on M tiles
  const int n0 = blockIdx.y * BN;
  const int nsteps = max(1, (K + BK - 1) / BK);

  // one K step into ring slot `slot`: 16-byte async copies where the chunk
  // of codes is whole and aligned, else bytes with zero fill past M and K;
  // the levels' rows are zero past K up to k_pad (a multiple of 128)
  auto load = [&](int slot, int step) {
    const int k0 = step * BK;
#pragma unroll
    for (int t = tid; t < BM * 2; t += THREADS) {
      const int r = t >> 1;
      const int gm = m0 + r;
      const int gk = k0 + 16 * (t & 1);
      int8_t* dst = &as[slot][r * A_LD + 16 * (t & 1)];
      const int8_t* src = a + (size_t)gm * K + gk;
      if (vec_a && gm < M && gk + 16 <= K) {
        cp_async(dst, src, 16);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          dst[e] = (gm < M && gk + e < K) ? src[e] : (int8_t)0;
      }
    }
#pragma unroll
    for (int t = tid; t < BN * 2; t += THREADS) {
      const int r = t >> 1;
      const int gn = n0 + r;
      int8_t* dst = &bs[slot][r * A_LD + 16 * (t & 1)];
      if (gn < N) {
        cp_async(dst, wt + (size_t)gn * k_pad + k0 + 16 * (t & 1), 16);
      } else {
        *(int4*)dst = make_int4(0, 0, 0, 0);
      }
    }
  };

  int acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < nsteps; ++it) {
    cp_async_wait<STAGES - 2>();      // step `it` has landed
    __syncthreads();                  // ... for every thread; slot of it-1 free
    const int nx = it + STAGES - 1;
    if (nx < nsteps) load(nx % STAGES, nx);
    cp_async_commit();
    const int8_t* A = as[it % STAGES];
    const int8_t* B = bs[it % STAGES];
    uint32_t af[4], bf[NT][2];
    const int8_t* pa = A + g * A_LD + tig * 4;
    af[0] = *(const uint32_t*)pa;
    af[1] = *(const uint32_t*)(pa + 8 * A_LD);
    af[2] = *(const uint32_t*)(pa + 16);
    af[3] = *(const uint32_t*)(pa + 8 * A_LD + 16);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int8_t* p = B + (wn * NT * 8 + j * 8 + g) * A_LD + tig * 4;
      bf[j][0] = *(const uint32_t*)p;
      bf[j][1] = *(const uint32_t*)(p + 16);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_s8(acc[j], af, bf[j]);
  }
  cp_async_wait<0>();

  // accumulator fragment: c0, c1 at row g, c2, c3 at row g + 8; columns
  // tig*2 and tig*2 + 1
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + g + (e >= 2 ? 8 : 0);
      const int col = n0 + wn * NT * 8 + j * 8 + tig * 2 + (e & 1);
      if (row < M && col < N) {
        out[(size_t)row * N + col] = dequant(acc[j][e], act_scale, ws, col);
      }
    }
  }
}

// The weight stream: out^T = W^T a^T over 16 output channels a CTA
// (blockIdx.x) and all `boxes` K boxes. NT n8 tiles cover M <= 8 * NT rows
// of codes.
template <int NT>
__global__ void __launch_bounds__(ST_THREADS)
mvm_stream_kernel(const __grid_constant__ CUtensorMap wmap,
                  const int8_t* __restrict__ a, const float* __restrict__ ws,
                  float act_scale, float* __restrict__ out, int M, int N,
                  int K, int boxes, int vec_a) {
  constexpr int ENTRIES = 8 * NT * ST_CH;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  int* red = (int*)(ring + ST_STAGES * ST_STAGE_BYTES);  // [warp][row][ch]
  uint64_t* full = (uint64_t*)(red + ST_WARPS * ST_TILE);
  uint64_t* empty = full + ST_STAGES;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int n0 = blockIdx.x * ST_CH;
  const int nstage = (boxes + ST_BOXES - 1) / ST_BOXES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], ST_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  int acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0;

  if (warp == ST_WARPS) {
    // the producer: stage i is boxes 8i .. 8i + 7 of the levels' 16 rows
    if (lane == 0) {
      uint64_t policy;
      asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                   : "=l"(policy));
      for (int i = 0; i < nstage; ++i) {
        const int slot = i % ST_STAGES;
        if (i >= ST_STAGES) {
          mbar_wait(&empty[slot], ((i / ST_STAGES) - 1) & 1);
        }
        const int bx = i * ST_BOXES;
        const int nb = min(ST_BOXES, boxes - bx);
        uint8_t* dst = ring + slot * ST_STAGE_BYTES;
        mbar_expect_tx(&full[slot], nb * ST_BOX_BYTES);
        for (int j = 0; j < nb; ++j) {
          tma_load_once(dst + j * ST_BOX_BYTES, &wmap, &full[slot],
                        (bx + j) * KBOX, n0, policy);
        }
      }
    }
    __syncwarp();
  } else {
    // consumer warp w: box w / 2 of each stage, its 32-byte steps
    // 2 (w & 1) and 2 (w & 1) + 1; the codes come one stage ahead
    const int wbox = warp >> 1;
    const int kk0 = 2 * (warp & 1);
    uint32_t bc[2][NT][2], bn[2][NT][2] = {};
    auto load_codes = [&](int i, uint32_t (&b)[2][NT][2]) {
      const int box = i * ST_BOXES + wbox;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = box * KBOX + (kk0 + j) * 32 + 16 * h + 4 * tig;
            b[j][t][h] = box < boxes
                             ? code_word(a, 8 * t + g, k, M, K, vec_a) : 0u;
          }
    };
    load_codes(0, bc);
    for (int i = 0; i < nstage; ++i) {
      const int slot = i % ST_STAGES;
      if (i + 1 < nstage) load_codes(i + 1, bn);
      mbar_wait(&full[slot], (i / ST_STAGES) & 1);
      if (i * ST_BOXES + wbox < boxes) {
        const uint8_t* box = ring + slot * ST_STAGE_BYTES +
                             wbox * ST_BOX_BYTES;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t af[4];
          ldmatrix_a(af, box, kk0 + j, lane);
#pragma unroll
          for (int t = 0; t < NT; ++t) mma_s8(acc[t], af, bc[j][t]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int h = 0; h < 2; ++h) bc[j][t][h] = bn[j][t][h];
    }
    // fragment: c0, c1 at channel g, c2, c3 at g + 8; rows of codes
    // 8t + 2 tig and + 1
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ch = g + (e >= 2 ? 8 : 0);
        const int row = 8 * t + 2 * tig + (e & 1);
        red[warp * ST_TILE + row * ST_CH + ch] = acc[t][e];
      }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < ENTRIES; e += ST_THREADS) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < ST_WARPS; ++w) s += red[w * ST_TILE + e];
    const int row = e / ST_CH;
    const int n = n0 + e % ST_CH;
    if (row < M && n < N) {
      out[(size_t)row * N + n] = dequant(s, act_scale, ws, n);
    }
  }
}

// The compute-bound GEMM: a 64 x 64 tile (blockIdx.x, .y) over all `boxes`
// K boxes. Warps 0-3 are the consumer warpgroup, warp 4 the producer.
__global__ void __launch_bounds__(WG_THREADS)
mvm_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                 const __grid_constant__ CUtensorMap wmap,
                 const float* __restrict__ ws, float act_scale,
                 float* __restrict__ out, int M, int N, int boxes) {
  constexpr int BN = WG_BN;
  constexpr int A_BYTES = WG_BM * KBOX;
  constexpr int B_BYTES = BN * KBOX;
  constexpr int STAGE = A_BYTES + B_BYTES;
  constexpr int NR = BN / 2;           // accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint64_t* full = (uint64_t*)(ring + WG_STAGES * STAGE);
  uint64_t* empty = full + WG_STAGES;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int m0 = blockIdx.x * WG_BM;
  const int n0 = blockIdx.y * BN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  int acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0;

  if (warp == 4) {
    if (lane == 0) {
      for (int i = 0; i < boxes; ++i) {
        const int slot = i % WG_STAGES;
        if (i >= WG_STAGES) {
          mbar_wait(&empty[slot], ((i / WG_STAGES) - 1) & 1);
        }
        uint8_t* dst = ring + slot * STAGE;
        mbar_expect_tx(&full[slot], STAGE);
        tma_load(dst, &amap, &full[slot], i * KBOX, m0);
        tma_load(dst + A_BYTES, &wmap, &full[slot], i * KBOX, n0);
      }
    }
    __syncwarp();
  } else {
    for (int i = 0; i < boxes; ++i) {
      const int slot = i % WG_STAGES;
      mbar_wait(&full[slot], (i / WG_STAGES) & 1);
      const uint8_t* sa = ring + slot * STAGE;
      const uint64_t da = sw128_desc(sa);
      const uint64_t db = sw128_desc(sa + A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KBOX / 32; ++kk) {
        wgmma_n64(acc, da + 2 * kk, db + 2 * kk);   // 32 bytes of K
      }
      wgmma_commit();
      wgmma_wait<1>();                 // box i - 1's products are done
      if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % WG_STAGES]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NR; ++i) asm volatile("" : "+r"(acc[i]) :: "memory");
  }
  // accumulator j of thread (warp w, g, tig): row 16w + g (+8 for j & 2),
  // columns 8 (j / 4) + 2 tig and + 1 (j and j + 1 for even j)
  if (warp < 4) {
#pragma unroll
    for (int j = 0; j < NR; j += 2) {
      const int row = m0 + 16 * warp + g + ((j & 2) ? 8 : 0);
      const int col = n0 + 8 * (j >> 2) + 2 * tig;
      if (row >= M) continue;
      float* o = out + (size_t)row * N + col;
      if (col + 1 < N && (N & 1) == 0) {
        *(float2*)o = make_float2(dequant(acc[j], act_scale, ws, col),
                                  dequant(acc[j + 1], act_scale, ws,
                                          col + 1));
      } else {
        if (col < N) o[0] = dequant(acc[j], act_scale, ws, col);
        if (col + 1 < N) o[1] = dequant(acc[j + 1], act_scale, ws, col + 1);
      }
    }
  }
}

// N = NN <= 8, K <= 32: rows m0 .. m0 + SK_ROWS - 1 of a are one span of
// bytes. Its 16-byte-aligned middle goes in by cp.async, its ragged head
// and tail byte by byte; byte j of the span lands at abuf[lead + j], lead =
// the span's address mod 16, so aligned global words land on aligned smem.
template <int NN>
__global__ void __launch_bounds__(SK_THREADS)
mvm_skinny_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ wt,
                  const float* __restrict__ ws, float act_scale,
                  float* __restrict__ out, int M, int K, int k_pad) {
  __shared__ __align__(16) int8_t abuf[SK_ROWS * SK_KMAX + 16];
  __shared__ int wsm[SK_KMAX * NN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * SK_ROWS;
  const int rows = min(SK_ROWS, M - m0);
  for (int i = tid; i < K * NN; i += SK_THREADS) {
    wsm[i] = wt[(i % NN) * k_pad + i / NN];       // [k][n] from [n][k_pad]
  }

  const int8_t* p = a + (size_t)m0 * K;
  const uintptr_t pa = (uintptr_t)p;
  const long long len = (long long)rows * K;
  const int lead = (int)(pa & 15);
  long long head = (16 - lead) & 15;             // bytes before the first word
  if (head > len) head = len;
  const long long words = (len - head) / 16;
  const long long tail0 = head + 16 * words;     // first byte after the words
  for (long long i = tid; i < words; i += SK_THREADS) {
    cp_async(abuf + lead + head + 16 * i, p + head + 16 * i, 16);
  }
  cp_async_commit();
  for (long long i = tid; i < head; i += SK_THREADS) abuf[lead + i] = p[i];
  for (long long i = tail0 + tid; i < len; i += SK_THREADS) {
    abuf[lead + i] = p[i];
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int r = tid; r < rows; r += SK_THREADS) {
    const int8_t* row = abuf + lead + r * K;
    int acc[NN];
#pragma unroll
    for (int n = 0; n < NN; ++n) acc[n] = 0;
    for (int k = 0; k < K; ++k) {
      const int av = row[k];
#pragma unroll
      for (int n = 0; n < NN; ++n) acc[n] += av * wsm[k * NN + n];
    }
    float v[NN];
#pragma unroll
    for (int n = 0; n < NN; ++n) v[n] = dequant(acc[n], act_scale, ws, n);
    // out comes from the wrapper's torch.empty: 16-byte aligned, so a row
    // of 2, 4 or 8 floats is one or two vector stores
    float* o = out + (size_t)(m0 + r) * NN;
    if constexpr (NN == 2) {
      *(float2*)o = make_float2(v[0], v[1]);
    } else if constexpr (NN == 4) {
      *(float4*)o = make_float4(v[0], v[1], v[2], v[3]);
    } else if constexpr (NN == 8) {
      ((float4*)o)[0] = make_float4(v[0], v[1], v[2], v[3]);
      ((float4*)o)[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int n = 0; n < NN; ++n) o[n] = v[n];
    }
  }
}

// The levels' layout: w [K, N] int8 (rows N bytes apart) -> wt [N, k_pad],
// K contiguous, zero from K up to k_pad. CTA (x, y) takes K bytes
// k0..k0+127 of rows n0..n0+63: each thread loads two 16-byte runs of a
// row of w (bytes with zero fill where N is not a multiple of 16 or w is
// unaligned, and past K and N) and scatters them to the smem tile [n][k];
// then each thread stores two 16-byte runs of a row of wt. The 33-word smem
// rows keep those 16-byte reads free of bank conflicts.
__global__ void __launch_bounds__(LT_THREADS)
mvm_layout_kernel(const int8_t* __restrict__ w, int8_t* __restrict__ wt,
                  int K, int N, int k_pad, int vec) {
  __shared__ __align__(16) int8_t t[LN * L_LD];
  const int k0 = blockIdx.x * LK;
  const int n0 = blockIdx.y * LN;
  uint32_t v[2][4] = {};
#pragma unroll
  for (int r = 0; r < 2; ++r) {          // both runs' loads first
    const int i = threadIdx.x + r * LT_THREADS;
    const int k = k0 + i / 4;            // row of w
    const int c = 16 * (i % 4);          // its 16 bytes from n0 + c
    const int8_t* src = w + (size_t)k * N + n0 + c;
    if (vec && k < K && n0 + c < N) {
      const int4 u = __ldg((const int4*)src);
      v[r][0] = u.x;
      v[r][1] = u.y;
      v[r][2] = u.z;
      v[r][3] = u.w;
    } else if (k < K) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (n0 + c + j < N) {
          v[r][j / 4] |= (uint32_t)(uint8_t)src[j] << (8 * (j % 4));
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = threadIdx.x + r * LT_THREADS;
    const int c = 16 * (i % 4);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      t[(c + j) * L_LD + i / 4] = (int8_t)(v[r][j / 4] >> (8 * (j % 4)));
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = threadIdx.x + r * LT_THREADS;
    const int n = i / 8;                 // row of wt
    const int q = 16 * (i % 8);          // its 16 bytes from k0 + q
    if (n0 + n < N) {
      const uint32_t* p = (const uint32_t*)(t + n * L_LD + q);
      *(uint4*)(wt + (size_t)(n0 + n) * k_pad + k0 + q) =
          make_uint4(p[0], p[1], p[2], p[3]);
    }
  }
}

// a 2-D map of an int8 matrix [rows, cols] with rows `cols` bytes apart:
// boxes of 128 bytes of a row x box_rows rows, in the 128-byte swizzle,
// zero filled past the matrix
int encode_map(CUtensorMap* map, const void* base, int rows, int cols,
               int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)KBOX, (cuuint32_t)box_rows};
  return encode_int8_map(map, base, 2, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
}

struct Args {
  const int8_t* a;
  const int8_t* wt;
  const float* ws;
  float act_scale;
  float* out;
  int M, N, K, k_pad;
  cudaStream_t stream;
};

// a launch of `kernel` with `smem` bytes of dynamic shared memory
template <typename... Params, typename... Actual>
int launch(void (*kernel)(Params...), dim3 grid, int threads, int smem,
           cudaStream_t stream, Actual... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

int launch_gemm(const Args& x) {
  const int vec_a = x.K % 16 == 0 && (uintptr_t)x.a % 16 == 0;
  const dim3 grid((x.M + GM_BM - 1) / GM_BM, (x.N + GM_BN - 1) / GM_BN);
  mvm_gemm_kernel<<<grid, GM_THREADS, 0, x.stream>>>(
      x.a, x.wt, x.ws, x.act_scale, x.out, x.M, x.N, x.K, x.k_pad, vec_a);
  return (int)cudaGetLastError();
}

template <int NN>
int launch_skinny(const Args& x) {
  const int blocks = (x.M + SK_ROWS - 1) / SK_ROWS;
  mvm_skinny_kernel<NN><<<blocks, SK_THREADS, 0, x.stream>>>(
      x.a, x.wt, x.ws, x.act_scale, x.out, x.M, x.K, x.k_pad);
  return (int)cudaGetLastError();
}

constexpr int ST_SMEM = ST_STAGES * ST_STAGE_BYTES +
                        ST_WARPS * ST_TILE * 4 +
                        2 * ST_STAGES * 8 + 1024;

template <int NT>
int launch_stream(const Args& x, const CUtensorMap& wmap) {
  const int vec_a = x.K % 4 == 0 && (uintptr_t)x.a % 4 == 0;
  const dim3 grid((x.N + ST_CH - 1) / ST_CH);
  return launch(mvm_stream_kernel<NT>, grid, ST_THREADS, ST_SMEM, x.stream,
                wmap, x.a, x.ws, x.act_scale, x.out, x.M, x.N,
                x.K, x.k_pad / KBOX, vec_a);
}

int launch_wgmma(const Args& x, const CUtensorMap& wmap) {
  alignas(64) CUtensorMap amap;
  const int err = encode_map(&amap, x.a, x.M, x.K, WG_BM);
  if (err != 0) return err;
  constexpr int smem = WG_STAGES * (WG_BM + WG_BN) * KBOX +
                       2 * WG_STAGES * 8 + 1024;
  const dim3 grid((x.M + WG_BM - 1) / WG_BM, (x.N + WG_BN - 1) / WG_BN);
  return launch(mvm_wgmma_kernel, grid, WG_THREADS, smem, x.stream, amap,
                wmap, x.ws, x.act_scale, x.out, x.M, x.N,
                x.k_pad / KBOX);
}

}  // namespace

// Lay out the levels: w [K, N] int8, contiguous -> wt [N, k_pad] (k_pad a
// positive multiple of 128 >= K, wt 16-byte aligned), one launch on
// `stream`.
extern "C" int mvm_layout_launch(const void* w, void* wt, int K, int N,
                                 int k_pad, void* stream) {
  if (K < 0 || N < 1 || k_pad < KBOX || k_pad % KBOX != 0 || k_pad < K ||
      (uintptr_t)wt % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int vec = N % 16 == 0 && (uintptr_t)w % 16 == 0;
  const dim3 grid(k_pad / LK, (N + LN - 1) / LN);
  mvm_layout_kernel<<<grid, LT_THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)w, (int8_t*)wt, K, N, k_pad, vec);
  return (int)cudaGetLastError();
}

// The levels' tensor map for a route's box (16 rows for stream, the tile's
// bn for wgmma), written as 128 bytes into `map_out`: built once with the
// layout (ops.py::mvm_weights), then handed to every launch.
extern "C" int mvm_tensor_map(void* map_out, const void* wt, int n,
                              int k_pad, int box_rows) {
  if (n < 1 || k_pad < KBOX || k_pad % KBOX != 0 || box_rows < 1 ||
      box_rows > 256 || (uintptr_t)wt % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  alignas(64) CUtensorMap map;
  const int err = encode_map(&map, wt, n, k_pad, box_rows);
  if (err == 0) memcpy(map_out, &map, sizeof(map));
  return err;
}

// route 0: skinny (bn == N <= 8, K <= 32); 1: gemm (bm = 16, bn = 64); 2:
// stream (bm = 8 or 16 >= M rows of codes, bn = 16 channels a CTA); 3:
// wgmma (bm = bn = 64, K a multiple of 16, `a` 16-byte aligned). wt
// [N, k_pad] are the laid-out levels, `wmap` (routes 2 and 3) their
// 128-byte tensor map with the route's box. Anything else is refused with
// cudaErrorInvalidValue: there is no other kernel.
extern "C" int mvm_int_launch(const void* a, const void* wt,
                              const void* wmap, const void* ws,
                              float act_scale, void* out, int M, int N,
                              int K, int k_pad, int route, int bm, int bn,
                              void* stream) {
  const Args x{(const int8_t*)a, (const int8_t*)wt, (const float*)ws,
               act_scale, (float*)out, M, N, K, k_pad,
               (cudaStream_t)stream};
  const int bad = (int)cudaErrorInvalidValue;
  if (M < 1 || N < 1 || K < 0 || k_pad < KBOX || k_pad % KBOX != 0 ||
      k_pad < K || (uintptr_t)wt % 16 != 0) {
    return bad;
  }
  if (route == 0) {
    if (bn != N || N > SK_NMAX || K > SK_KMAX) return bad;
    switch (N) {
      case 1: return launch_skinny<1>(x);
      case 2: return launch_skinny<2>(x);
      case 3: return launch_skinny<3>(x);
      case 4: return launch_skinny<4>(x);
      case 5: return launch_skinny<5>(x);
      case 6: return launch_skinny<6>(x);
      case 7: return launch_skinny<7>(x);
      case 8: return launch_skinny<8>(x);
      default: return bad;
    }
  }
  if (route == 1) {
    if (bm != GM_BM || bn != GM_BN) return bad;
    return launch_gemm(x);
  }
  if ((route != 2 && route != 3) || wmap == nullptr) return bad;
  alignas(64) CUtensorMap map;
  memcpy(&map, wmap, sizeof(map));
  if (route == 2) {
    if (bn != ST_CH || M > bm) return bad;
    if (bm == 8) return launch_stream<1>(x, map);
    if (bm == 16) return launch_stream<2>(x, map);
    return bad;
  }
  if (bm != WG_BM || bn != WG_BN || K < 16 || K % 16 != 0 ||
      (uintptr_t)a % 16 != 0) {
    return bad;
  }
  return launch_wgmma(x, map);
}
