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
// What bounds it on an H100: at the serving shapes (M <= 2048, K <= 2304,
// N <= 256 at batch 8) the work is a few hundred MFLOP over a few MB, so
// neither the 3.35 TB/s of HBM nor the int8 tensor cores are the limit;
// launch latency and the small number of blocks are. The design therefore
// keeps to a plain tiled GEMM that is right first:
//   * 64x64 output tiles, 256 threads, each thread a 4x4 register tile;
//   * K streamed through shared memory in 32-byte slices, packed four int8
//     to a word so one __dp4a does four MACs (the accumulate is exact in
//     int32, so any order gives the same sum);
//   * every load is masked, so ragged M/K/N need no padding (the TPU kernel
//     needed its caller to pad to 128/128/512);
//   * the epilogue is __fmul_rn(__fmul_rn((float)acc, act_scale), ws[n]),
//     or its first factor alone when ws is null: the reference's
//     association, rounded step by step, never contracted.
// Making it fast (wgmma s8 tiles fed by TMA, more blocks at small M) is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;              // int8 per K slice
constexpr int KW = BK / 4;          // packed 32-bit words per slice
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
mvm_int_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
               const float* __restrict__ ws, float act_scale,
               float* __restrict__ out, int M, int N, int K) {
  // +1 word of padding per row keeps the column reads off one bank
  __shared__ int as[BM][KW + 1];
  __shared__ int bs[BN][KW + 1];    // w tile transposed: bs[n][k / 4]
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // a tile: BM rows x KW words, four consecutive k per word
    for (int l = tid; l < BM * KW; l += THREADS) {
      const int r = l / KW;
      const int kw = l % KW;
      const int gm = m0 + r;
      const int gk = k0 + kw * 4;
      uint32_t word = 0;
      if (gm < M) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (gk + e < K) {
            word |= (uint32_t)(uint8_t)a[(size_t)gm * K + gk + e] << (8 * e);
          }
        }
      }
      as[r][kw] = (int)word;
    }
    // w tile: consecutive threads read consecutive n (coalesced)
    for (int l = tid; l < BN * KW; l += THREADS) {
      const int c = l % BN;
      const int kw = l / BN;
      const int gn = n0 + c;
      const int gk = k0 + kw * 4;
      uint32_t word = 0;
      if (gn < N) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (gk + e < K) {
            word |= (uint32_t)(uint8_t)w[(size_t)(gk + e) * N + gn] << (8 * e);
          }
        }
      }
      bs[c][kw] = (int)word;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < KW; ++kw) {
      int av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[ty + 16 * i][kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[tx + 16 * j][kw];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) {
        const float v = __fmul_rn((float)acc[i][j], act_scale);
        out[(size_t)m * N + n] = ws != nullptr ? __fmul_rn(v, ws[n]) : v;
      }
    }
  }
}

}  // namespace

extern "C" int mvm_int_launch(const void* a, const void* w, const void* ws,
                              float act_scale, void* out, int M, int N, int K,
                              void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mvm_int_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)a, (const int8_t*)w, (const float*)ws, act_scale,
      (float*)out, M, N, K);
  return (int)cudaGetLastError();
}
