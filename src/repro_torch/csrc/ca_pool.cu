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
// ~20 flops per byte ridge for float32, so 3.35 TB/s of HBM (or L2, where
// the caller has just written the input) is the limit, and the design only
// keeps enough loads in flight:
//   * a thread computes a run of R outputs along one output row. A run
//     reads P*R*C contiguous floats of each of its P input rows and writes
//     R (gray) or R*C (mean) contiguous floats;
//   * p, C and R are template arguments for the shapes on the served paths
//     (CA_GRAY_SHAPES, CA_MEAN_SHAPES), so the taps unroll and every load
//     of a run is issued before its first FMA; the coefficients sit in
//     registers, read once a thread from the device pointer (no
//     process-wide constant bank, so launches on several streams or
//     devices with different (p, C) cannot race);
//   * the vector route loads a run's rows as 16-byte streaming loads
//     (read once: evict-first) and stores 16 bytes at a time where the
//     run's outputs are a multiple of 4 floats; the scalar route runs the
//     same instantiation with 4-byte loads and masks a row's ragged tail
//     (rows whose byte length is not a multiple of 16, an input that does
//     not start on 16 bytes, W/p not a multiple of R); the generic route
//     takes runtime p and C, one output pixel a thread;
//   * a 2-D grid: x walks a row's runs, y the output rows (b*H/p + i), so
//     the index math is 32-bit adds and multiplies with no division; only
//     a row's start offset is 64-bit (B*H*W*C may pass 2^31). Where the
//     rows need more CTAs than one wave holds (or than gridDim.y allows),
//     the y blocks walk the rows in a grid-stride loop.
// The route, R, block and grid come from the wrapper
// (kernels/ca_pool/ops.py::ca_config); a combination this file has no
// instantiation for is refused with cudaErrorInvalidValue.
//
// Numerics, bitwise equal to repro_torch.core.compressive:
//   * gray mode is a sequential fmaf chain over c, then di, then dj, from
//     +0.0f -- the order the reference's jitted einsum takes for p = 2 (the
//     TPU kernel's di -> dj -> c order is not); the first step is
//     fmaf(x, k, 0.0f), which rounds a -0 product as the chain does;
//   * mean mode sums the window row-major from 0 with __fadd_rn and
//     divides once with __fdiv_rn, as the reference's reduce does.
// The runs only regroup outputs among threads; each output's chain keeps
// its order. Nothing is left to nvcc's FMA contraction: every rounding
// step is an explicit intrinsic.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int MAX_THREADS = 256;
enum Route { GENERIC = 0, SCALAR = 1, VECTOR = 2 };

// (p, C, R) instantiated per mode; the wrapper's GRAY_SHAPES / MEAN_SHAPES
// list the same. R keeps P*R*C a multiple of 4 (whole 16-byte loads) and a
// thread's registers in bounds (p = 4 at C = 3 reads 48 floats a run).
#define CA_GRAY_SHAPES(X) X(1, 3, 4) X(2, 3, 4) X(4, 3, 1) X(2, 1, 4) X(4, 1, 4)
#define CA_MEAN_SHAPES(X) X(2, 1, 4) X(2, 3, 4) X(4, 1, 4) X(4, 3, 1)

__device__ __forceinline__ float ld1(const float* p) { return __ldcs(p); }

// The N floats of one input row that a run reads (PC = P*C floats an
// output). VEC: N/4 16-byte loads; else 4-byte loads of the run's first
// `valid` outputs only.
template <int N, int PC, bool VEC>
__device__ __forceinline__ void load_run(const float* src, float (&v)[N],
                                         int valid) {
  if constexpr (VEC) {
    static_assert(N % 4 == 0, "a vector run is whole 16-byte loads");
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 t = __ldcs(reinterpret_cast<const float4*>(src) + q);
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] = q / PC < valid ? ld1(src + q) : 0.0f;
  }
}

// The N output floats of a run (K floats an output). VEC with N a multiple
// of 4: 16-byte stores; else 4-byte stores of the first `valid` outputs.
template <int N, int K, bool VEC>
__device__ __forceinline__ void store_run(float* dst, const float (&o)[N],
                                          int valid) {
  if constexpr (VEC && N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<float4*>(dst)[q] =
          make_float4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q)
      if (q / K < valid) dst[q] = o[q];
  }
}

template <int P, int C, int R, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS)
ca_gray_kernel(const float* __restrict__ img,
               const float* __restrict__ coef,   // [P][P][C]
               float* __restrict__ out, int rows, int wo) {
  constexpr int N = P * R * C;
  const int j0 = (blockIdx.x * blockDim.x + threadIdx.x) * R;
  if (j0 >= wo) return;
  const int valid = min(R, wo - j0);
  const int row_len = P * wo * C;                 // W*C floats
  float k[P * P * C];
#pragma unroll
  for (int t = 0; t < P * P * C; ++t) k[t] = __ldg(coef + t);
  for (int r = blockIdx.y * blockDim.y + threadIdx.y; r < rows;
       r += gridDim.y * blockDim.y) {
    float v[P][N];
#pragma unroll
    for (int di = 0; di < P; ++di)
      load_run<N, P * C, VEC>(img + (size_t)(P * r + di) * row_len + j0 * P * C,
                              v[di], valid);
    float o[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int di = 0; di < P; ++di)
#pragma unroll
          for (int dj = 0; dj < P; ++dj)
            acc = fmaf(v[di][(q * P + dj) * C + c], k[(di * P + dj) * C + c],
                       acc);
      o[q] = acc;
    }
    store_run<R, 1, VEC>(out + (size_t)r * wo + j0, o, valid);
  }
}

template <int P, int C, int R, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS)
ca_mean_kernel(const float* __restrict__ img, float* __restrict__ out,
               int rows, int wo) {
  constexpr int N = P * R * C;
  const int j0 = (blockIdx.x * blockDim.x + threadIdx.x) * R;
  if (j0 >= wo) return;
  const int valid = min(R, wo - j0);
  const int row_len = P * wo * C;
  for (int r = blockIdx.y * blockDim.y + threadIdx.y; r < rows;
       r += gridDim.y * blockDim.y) {
    float v[P][N];
#pragma unroll
    for (int di = 0; di < P; ++di)
      load_run<N, P * C, VEC>(img + (size_t)(P * r + di) * row_len + j0 * P * C,
                              v[di], valid);
    float o[R * C];
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float acc = 0.0f;
#pragma unroll
        for (int di = 0; di < P; ++di)
#pragma unroll
          for (int dj = 0; dj < P; ++dj)
            acc = __fadd_rn(acc, v[di][(q * P + dj) * C + c]);
        o[q * C + c] = __fdiv_rn(acc, (float)(P * P));
      }
    store_run<R * C, C, VEC>(out + (size_t)r * wo * C + j0 * C, o, valid);
  }
}

// Any p and C, both modes: one output pixel a thread, the taps in loops.
__global__ void __launch_bounds__(MAX_THREADS)
ca_generic_kernel(const float* __restrict__ img,
                  const float* __restrict__ coef, float* __restrict__ out,
                  int rows, int wo, int C, int p, int gray) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= wo) return;
  const int row_len = p * wo * C;
  for (int r = blockIdx.y * blockDim.y + threadIdx.y; r < rows;
       r += gridDim.y * blockDim.y) {
    const float* base = img + (size_t)(p * r) * row_len + j * p * C;
    if (gray) {
      float acc = 0.0f;
      for (int c = 0; c < C; ++c)
        for (int di = 0; di < p; ++di)
          for (int dj = 0; dj < p; ++dj)
            acc = fmaf(ld1(base + di * row_len + dj * C + c),
                       __ldg(coef + (di * p + dj) * C + c), acc);
      out[(size_t)r * wo + j] = acc;
    } else {
      float* dst = out + ((size_t)r * wo + j) * C;
      for (int c = 0; c < C; ++c) {
        float acc = 0.0f;
        for (int di = 0; di < p; ++di)
          for (int dj = 0; dj < p; ++dj)
            acc = __fadd_rn(acc, ld1(base + di * row_len + dj * C + c));
        dst[c] = __fdiv_rn(acc, (float)(p * p));
      }
    }
  }
}

}  // namespace

// gray != 0: fused weighted mode with coef [p, p, C] (a device pointer);
// gray == 0: per-channel mean, coef unused. route: 0 generic (r = 1), 1
// scalar, 2 vector (r as instantiated); a block of tx x ty threads and a
// grid of gx x gy CTAs. The caller guarantees B*H and p*W*C fit an int,
// and for the vector route 16-byte aligned img and out, W*C a multiple of
// 4 and W/p a multiple of r.
extern "C" int ca_pool_launch(const void* img, const void* coef, void* out,
                              int B, int H, int W, int C, int p, int gray,
                              int route, int r, int tx, int ty, int gx, int gy,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(gx, gy), block(tx, ty);
  const int rows = B * (H / p), wo = W / p;
  const float* x = (const float*)img;
  const float* k = (const float*)coef;
  float* y = (float*)out;
  bool launched = false;
  if (route == GENERIC) {
    if (r != 1) return (int)cudaErrorInvalidValue;
    ca_generic_kernel<<<grid, block, 0, s>>>(x, k, y, rows, wo, C, p, gray);
    launched = true;
  } else if (route == SCALAR || route == VECTOR) {
    const bool vec = route == VECTOR;
#define CA_GRAY_CASE(P_, C_, R_)                                            \
  if (gray && p == P_ && C == C_ && r == R_) {                              \
    if (vec)                                                                \
      ca_gray_kernel<P_, C_, R_, true><<<grid, block, 0, s>>>(x, k, y, rows, \
                                                              wo);          \
    else                                                                    \
      ca_gray_kernel<P_, C_, R_, false><<<grid, block, 0, s>>>(x, k, y,     \
                                                               rows, wo);   \
    launched = true;                                                        \
  }
#define CA_MEAN_CASE(P_, C_, R_)                                              \
  if (!gray && p == P_ && C == C_ && r == R_) {                               \
    if (vec)                                                                  \
      ca_mean_kernel<P_, C_, R_, true><<<grid, block, 0, s>>>(x, y, rows, wo); \
    else                                                                      \
      ca_mean_kernel<P_, C_, R_, false><<<grid, block, 0, s>>>(x, y, rows,    \
                                                               wo);           \
    launched = true;                                                          \
  }
    CA_GRAY_SHAPES(CA_GRAY_CASE)
    CA_MEAN_SHAPES(CA_MEAN_CASE)
#undef CA_GRAY_CASE
#undef CA_MEAN_CASE
  }
  if (!launched) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
