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
// What bounds it on an H100 (the SXM data sheet's 3.35 TB/s and 1,979
// int8 TOP/s at its 700 W limit): at the serving shapes the work is small.
// The vision path's GEMMs (M <= 2048, K <= 2304, N <= 256 at batch 8) are
// a few hundred MOP over a few MB, so neither HBM nor the int8 tensor cores
// are the limit: the K loop's latency and the number of CTAs are. The imaging
// path's resident convs (M = 524,288, K <= 9, N <= 4) are bytes-bound:
// ~9 MB per call and a handful of MACs per byte. The first design (64x64
// tiles, byte-wise gathers, __dp4a, one unpipelined buffer) gave 1-32 CTAs
// at the vision shapes and 8,192 mostly idle tiles at the imaging ones.
// The launcher now takes a route and a tile from the wrapper's plain
// Python function (kernels/photonic_mvm/ops.py::mvm_config):
//
//   gemm    mma.sync m16n8k32 s8 x s8 -> s32 on the tensor cores. CTA tiles
//           of 16..64 rows x 8..64 columns, one to four warps, so the
//           small-M layers get more CTAs; K in 32-byte steps through a
//           3-stage cp.async ring (16-byte copies, 8 for an 8-wide tile)
//           so copies overlap the MMAs; split-K over gridDim.z where M x N
//           is small and K is large: each split writes its int32 partial
//           sums to a workspace, and mvm_reduce_kernel adds them and runs
//           the epilogue once. Ragged or unaligned operands are copied
//           byte by byte with zero fill, so the caller pads nothing.
//   skinny  N <= 8 and K <= 32 (the imaging convs): no tensor core. A CTA
//           copies a run of 1,024 rows of a (one contiguous span of bytes)
//           into shared memory with 16-byte cp.async, the weights (<= 256
//           levels) sit in shared memory, each thread sums its rows in
//           int32 and stores its N outputs with one vector store.
//
// Numerics: every accumulate is int32, exact in any order (the split-K
// partials included), so each route equals the plain version's exact
// integer product. The epilogue is __fmul_rn(__fmul_rn((float)acc,
// act_scale), ws[n]), or its first factor alone when ws is null: the
// reference's association, rounded step by step, never contracted.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;                 // int8 per K step (one m16n8k32)
constexpr int STAGES = 3;              // cp.async ring depth
constexpr int A_LD = BK + 16;          // smem row of an A tile: 48 bytes,
                                       // so the fragment reads hit 32 banks
constexpr int SK_THREADS = 256;
constexpr int SK_ROWS = 1024;          // rows of a that a skinny CTA stages
constexpr int SK_KMAX = 32;
constexpr int SK_NMAX = 8;
constexpr int RED_THREADS = 256;

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
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

// four int8 of one column, rows r .. r+3 of a row-major smem tile, packed
// low byte first: the k-contiguous register mma's B operand takes
__device__ __forceinline__ uint32_t pack_column(const int8_t* p, int ld) {
  return (uint32_t)(uint8_t)p[0] | (uint32_t)(uint8_t)p[ld] << 8 |
         (uint32_t)(uint8_t)p[2 * ld] << 16 |
         (uint32_t)(uint8_t)p[3 * ld] << 24;
}

// One CTA: a BM x BN output tile over the K steps [z*steps_per, ...) of
// split z = blockIdx.z. WM x WN warps, each a (BM/WM) x (BN/WN) sub-tile of
// MT x NT m16n8 fragments. Smem per stage: A [BM][A_LD] (k contiguous, the
// row-major A fragment is a 32-bit read) and w [BK][BN + 16] as it lies in
// memory (n contiguous; the B fragment packs four rows of one column).
template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN)
mvm_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
                const float* __restrict__ ws, float act_scale,
                float* __restrict__ out, int* __restrict__ part, int M,
                int N, int K, int steps_per, int vec_a, int vec_w) {
  constexpr int THREADS = 32 * WM * WN;
  constexpr int MT = BM / WM / 16;
  constexpr int NT = BN / WN / 8;
  constexpr int B_LD = BN + 16;
  constexpr int CH = BN < 16 ? BN : 16;     // bytes of one w copy
  constexpr int B_CHUNKS = BN / CH;
  static_assert(MT >= 1 && NT >= 1, "warp tile below m16n8");
  __shared__ __align__(16) int8_t as[STAGES][BM * A_LD];
  __shared__ __align__(16) int8_t bs[STAGES][BK * B_LD];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / WN;
  const int wn = warp % WN;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int m0 = blockIdx.x * BM;          // x: no 65,535 limit on M tiles
  const int n0 = blockIdx.y * BN;
  const int steps = (K + BK - 1) / BK;
  const int s0 = blockIdx.z * steps_per;
  const int nsteps = max(0, min(steps, s0 + steps_per) - s0);

  // one K step into ring slot `slot`: 16-byte (8-byte) async copies where
  // the chunk is whole and aligned, else bytes with zero fill past M, N, K
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
    for (int t = tid; t < BK * B_CHUNKS; t += THREADS) {
      const int r = t / B_CHUNKS;
      const int c = t % B_CHUNKS;
      const int gk = k0 + r;
      const int gn = n0 + CH * c;
      int8_t* dst = &bs[slot][r * B_LD + CH * c];
      const int8_t* src = w + (size_t)gk * N + gn;
      if (vec_w && gk < K && gn + CH <= N) {
        cp_async(dst, src, CH);
      } else {
#pragma unroll
        for (int e = 0; e < CH; ++e)
          dst[e] = (gk < K && gn + e < N) ? src[e] : (int8_t)0;
      }
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load(s, s0 + s);
    cp_async_commit();
  }
  for (int it = 0; it < nsteps; ++it) {
    cp_async_wait<STAGES - 2>();      // step `it` has landed
    __syncthreads();                  // ... for every thread; slot of it-1 free
    const int nx = it + STAGES - 1;
    if (nx < nsteps) load(nx % STAGES, s0 + nx);
    cp_async_commit();
    const int8_t* A = as[it % STAGES];
    const int8_t* B = bs[it % STAGES];
    uint32_t af[MT][4], bf[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int8_t* p = A + (wm * MT * 16 + i * 16 + g) * A_LD + tig * 4;
      af[i][0] = *(const uint32_t*)p;
      af[i][1] = *(const uint32_t*)(p + 8 * A_LD);
      af[i][2] = *(const uint32_t*)(p + 16);
      af[i][3] = *(const uint32_t*)(p + 8 * A_LD + 16);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int8_t* p = B + (tig * 4) * B_LD + wn * NT * 8 + j * 8 + g;
      bf[j][0] = pack_column(p, B_LD);
      bf[j][1] = pack_column(p + 16 * B_LD, B_LD);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
  }
  cp_async_wait<0>();

  // accumulator fragment: c0, c1 at row g, c2, c3 at row g + 8; columns
  // tig*2 and tig*2 + 1
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * MT * 16 + i * 16 + g + (e >= 2 ? 8 : 0);
        const int col = n0 + wn * NT * 8 + j * 8 + tig * 2 + (e & 1);
        if (row >= M || col >= N) continue;
        if (gridDim.z == 1) {
          out[(size_t)row * N + col] = dequant(acc[i][j][e], act_scale, ws,
                                               col);
        } else {
          part[((size_t)blockIdx.z * M + row) * N + col] = acc[i][j][e];
        }
      }
    }
  }
}

// split-K: out = dequant(sum over the splits of part[z]), the int32 sum
// exact in any order; int4 loads where the row count allows
__global__ void __launch_bounds__(RED_THREADS)
mvm_reduce_kernel(const int* __restrict__ part, int split,
                  const float* __restrict__ ws, float act_scale,
                  float* __restrict__ out, long long mn, int N) {
  const long long stride = (long long)gridDim.x * RED_THREADS;
  const long long first = (long long)blockIdx.x * RED_THREADS + threadIdx.x;
  if ((mn & 3) == 0) {
    const long long n4 = mn >> 2;
    for (long long i = first; i < n4; i += stride) {
      int4 s = ((const int4*)part)[i];
      for (int z = 1; z < split; ++z) {
        const int4 v = ((const int4*)(part + z * mn))[i];
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      }
      const int n = (int)((4 * i) % N);
      float4 o;
      o.x = dequant(s.x, act_scale, ws, n);
      o.y = dequant(s.y, act_scale, ws, (n + 1) % N);
      o.z = dequant(s.z, act_scale, ws, (n + 2) % N);
      o.w = dequant(s.w, act_scale, ws, (n + 3) % N);
      ((float4*)out)[i] = o;
    }
    return;
  }
  for (long long i = first; i < mn; i += stride) {
    int s = part[i];
    for (int z = 1; z < split; ++z) s += part[z * mn + i];
    out[i] = dequant(s, act_scale, ws, (int)(i % N));
  }
}

// N = NN <= 8, K <= 32: rows m0 .. m0 + SK_ROWS - 1 of a are one span of
// bytes. Its 16-byte-aligned middle goes in by cp.async, its ragged head
// and tail byte by byte; byte j of the span lands at abuf[lead + j], lead =
// the span's address mod 16, so aligned global words land on aligned smem.
template <int NN>
__global__ void __launch_bounds__(SK_THREADS)
mvm_skinny_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
                  const float* __restrict__ ws, float act_scale,
                  float* __restrict__ out, int M, int K) {
  __shared__ __align__(16) int8_t abuf[SK_ROWS * SK_KMAX + 16];
  __shared__ int wsm[SK_KMAX * NN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * SK_ROWS;
  const int rows = min(SK_ROWS, M - m0);
  for (int i = tid; i < K * NN; i += SK_THREADS) wsm[i] = w[i];

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

struct Args {
  const int8_t* a;
  const int8_t* w;
  const float* ws;
  float act_scale;
  float* out;
  int* part;
  int M, N, K, split, steps_per;
  cudaStream_t stream;
};

template <int BM, int BN, int WM, int WN>
int launch_gemm(const Args& x) {
  constexpr int CH = BN < 16 ? BN : 16;
  const int vec_a = x.K % 16 == 0 && (uintptr_t)x.a % 16 == 0;
  const int vec_w = x.N % CH == 0 && (uintptr_t)x.w % CH == 0;
  const dim3 grid((x.M + BM - 1) / BM, (x.N + BN - 1) / BN, x.split);
  mvm_gemm_kernel<BM, BN, WM, WN><<<grid, 32 * WM * WN, 0, x.stream>>>(
      x.a, x.w, x.ws, x.act_scale, x.out, x.part, x.M, x.N, x.K,
      x.steps_per, vec_a, vec_w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || x.split == 1) return (int)err;
  const long long mn = (long long)x.M * x.N;
  long long blocks = ((mn % 4 == 0 ? mn / 4 : mn) + RED_THREADS - 1) /
                     RED_THREADS;
  if (blocks > 4 * 132) blocks = 4 * 132;      // grid-stride beyond that
  mvm_reduce_kernel<<<(int)blocks, RED_THREADS, 0, x.stream>>>(
      x.part, x.split, x.ws, x.act_scale, x.out, mn, x.N);
  return (int)cudaGetLastError();
}

template <int NN>
int launch_skinny(const Args& x) {
  const int blocks = (x.M + SK_ROWS - 1) / SK_ROWS;
  mvm_skinny_kernel<NN><<<blocks, SK_THREADS, 0, x.stream>>>(
      x.a, x.w, x.ws, x.act_scale, x.out, x.M, x.K);
  return (int)cudaGetLastError();
}

}  // namespace

// route 0: skinny (bn == N <= 8, K <= 32); route 1: gemm with a bm x bn
// tile from the table below, `split` K splits of `steps_per` 32-byte steps
// each, `part` an int32 [split, M, N] workspace when split > 1. Anything
// else is refused with cudaErrorInvalidValue: there is no other kernel.
extern "C" int mvm_int_launch(const void* a, const void* w, const void* ws,
                              float act_scale, void* out, void* part, int M,
                              int N, int K, int route, int bm, int bn,
                              int split, int steps_per, void* stream) {
  const Args x{(const int8_t*)a, (const int8_t*)w, (const float*)ws,
               act_scale, (float*)out, (int*)part, M, N, K, split,
               steps_per, (cudaStream_t)stream};
  const int bad = (int)cudaErrorInvalidValue;
  if (M < 1 || N < 1 || K < 0 || split < 1 || steps_per < 1) return bad;
  if (route == 0) {
    if (bn != N || N > SK_NMAX || K > SK_KMAX || split != 1) return bad;
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
  if (route != 1 || (split > 1 && part == nullptr)) return bad;
  const long long steps = ((long long)K + BK - 1) / BK;
  if ((long long)(split - 1) * steps_per >= (steps > 0 ? steps : 1)) {
    return bad;                                // an empty split
  }
  switch (bm * 1000 + bn) {
    case 64064: return launch_gemm<64, 64, 2, 2>(x);
    case 32064: return launch_gemm<32, 64, 2, 2>(x);
    case 32032: return launch_gemm<32, 32, 2, 2>(x);
    case 16064: return launch_gemm<16, 64, 1, 4>(x);
    case 16032: return launch_gemm<16, 32, 1, 2>(x);
    case 16016: return launch_gemm<16, 16, 1, 2>(x);
    case 16008: return launch_gemm<16, 8, 1, 1>(x);
    default: return bad;
  }
}
