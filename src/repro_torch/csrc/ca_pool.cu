// Compressive Acquisitor: fused channel mix + pool x pool mean pooling.
// Hopper (sm_90a) port of the TPU kernel
// src/repro/kernels/ca_pool/kernel.py::ca_pool_kernel (body _ca_kernel).
//
//   gray mode:  out[b, i, j]    = sum_{c, di, dj} coef[di, dj, c]
//                                   * img[b, p*i + di, p*j + dj, c]
//   mean mode:  out[b, i, j, c] = (sum_{di, dj} img[b, p*i + di, p*j + dj, c])
//                                   / (p * p)
//
// What bounds it on an H100: bytes. It reads each input pixel once and
// does 2 flops per read (p*p*C FMAs per output), far below the card's
// ~20 flops per byte ridge for float32, so 3.35 TB/s of HBM is the limit.
// The design: one thread per output element, no shared memory and no
// intermediate gray or pooled image in device memory. The coefficients
// arrive as a device pointer and are read through __ldg: every thread of a
// warp reads the same coefficient at the same step, so each read is one
// broadcast from L1. No process-wide state is written, so launches on
// several streams or devices with different (p, C) cannot race.
//
// Numerics, bitwise equal to repro_torch.core.compressive:
//   * gray mode is a sequential fmaf chain over c, then di, then dj, from 0
//     -- the order the reference's jitted einsum takes for p = 2 (the TPU
//     kernel's di -> dj -> c order is not);
//   * mean mode sums the window row-major from 0 with __fadd_rn and
//     divides once with __fdiv_rn, as the reference's reduce does.
// Nothing is left to nvcc's FMA contraction: every rounding step is an
// explicit intrinsic.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
ca_gray_kernel(const float* __restrict__ img,
               const float* __restrict__ coef,   // [p][p][C]
               float* __restrict__ out, int B, int H, int W, int C, int p) {
  const int ho = H / p, wo = W / p;
  const long total = (long)B * ho * wo;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int j = (int)(idx % wo);
  const long t = idx / wo;
  const int i = (int)(t % ho);
  const int b = (int)(t / ho);
  const float* base = img + (((long)b * H + (long)p * i) * W + (long)p * j) * C;
  float acc = 0.0f;
  for (int c = 0; c < C; ++c) {
    for (int di = 0; di < p; ++di) {
      for (int dj = 0; dj < p; ++dj) {
        acc = fmaf(base[((long)di * W + dj) * C + c],
                   __ldg(coef + (di * p + dj) * C + c), acc);
      }
    }
  }
  out[idx] = acc;
}

__global__ void __launch_bounds__(THREADS)
ca_mean_kernel(const float* __restrict__ img, float* __restrict__ out, int B,
               int H, int W, int C, int p) {
  const int ho = H / p, wo = W / p;
  const long total = (long)B * ho * wo * C;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  long t = idx / C;
  const int j = (int)(t % wo);
  t /= wo;
  const int i = (int)(t % ho);
  const int b = (int)(t / ho);
  const float* base = img + (((long)b * H + (long)p * i) * W + (long)p * j) * C + c;
  float acc = 0.0f;
  for (int di = 0; di < p; ++di) {
    for (int dj = 0; dj < p; ++dj) {
      acc = __fadd_rn(acc, base[((long)di * W + dj) * C]);
    }
  }
  out[idx] = __fdiv_rn(acc, (float)(p * p));
}

}  // namespace

// gray != 0: fused weighted mode with coef [p, p, C] (a device pointer);
// gray == 0: per-channel mean, coef unused.
extern "C" int ca_pool_launch(const void* img, const void* coef, void* out,
                              int B, int H, int W, int C, int p, int gray,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int ho = H / p, wo = W / p;
  if (gray) {
    const long total = (long)B * ho * wo;
    const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
    ca_gray_kernel<<<blocks, THREADS, 0, s>>>((const float*)img,
                                              (const float*)coef, (float*)out, B,
                                              H, W, C, p);
  } else {
    const long total = (long)B * ho * wo * C;
    const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
    ca_mean_kernel<<<blocks, THREADS, 0, s>>>((const float*)img, (float*)out, B, H,
                                              W, C, p);
  }
  return (int)cudaGetLastError();
}
