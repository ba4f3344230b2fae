// Fused conv chain: a whole segment of convs in one launch, one block per
// frame. Hopper (sm_90a) port of the TPU kernel
// src/repro/kernels/conv_bank/fused_kernel.py::conv_chain_kernel
// (_chain_kernel, _stage_compute).
//
// Each stage, on one frame held in shared memory:
//   acc  = sum over the k x k taps (and input channels, or per channel when
//          depthwise) of code * level           -- exact integers in f32
//   v    = __fmul_rn(acc, __fmul_rn(scale, ws[co]))
//   v    = __fadd_rn(v, bias[co])                -- when the stage has one
//   v    = act(v)                                -- relu / abs / sign / none
//   y    = pool over size x size windows         -- max, or the row-major
//          sum from 0 then __fdiv_rn by size^2 (the reference's reduce)
//   y    = fmaxf(y, 0)
//   amax = block-wide max of y over the frame    -- the stage barrier
//   scale' = __fdiv_rn(fmaxf(amax, 1e-8f), aq)
//   code = min(max(rintf(__fdiv_rn(y, scale')), 0), 15)   (half to even)
// which is ref.conv_chain_ref and the unfused per-layer epilogue op for op.
// No step is left to nvcc's FMA contraction: every rounding is an explicit
// _rn intrinsic, and the accumulate's fmaf is exact: its operands are
// integers and |acc| < 2^24, which the wrapper (fused.check_exact) checks
// for every stage before it launches (a_qmax * max|level| * k*k*c_in/groups).
//
// What bounds it on an H100: neither bytes nor flops. A frame is read and
// its codes written once (tens of KB per batch), and LeNet's segment is a
// few MFLOP a frame. With one block per frame a batch of 8 occupies 8 of
// 132 SMs, and each stage ends in a block-wide barrier, so latency is the
// limit. The design keeps every intermediate frame in shared memory (two
// ping-pong buffers sized by the largest even and odd inter-stage frames),
// so nothing between stages touches device memory; the stage descriptors
// arrive by value as kernel parameters. A segment that does not fit one
// block's 227 KB is refused by the wrapper (splitting a frame over a
// thread-block cluster with DSMEM is later work, as is using tensor cores
// for the tap loop).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxStages = 16;
constexpr int kThreads = 256;

struct Stage {
  const float* w;      // [k, k, c_in / groups, c_out] HWIO levels
  const float* ws;     // [c_out] weight scales
  const float* bias;   // [c_out] or null
  int h_in, w_in, c_in, c_out, k, stride, pad_top, pad_left;
  int h_conv, w_conv;  // conv output, before pooling
  int h_out, w_out;    // after pooling
  int pool_kind;       // 0 none, 1 max, 2 avg
  int pool_size;       // 1 without pooling
  int depthwise, act, has_bias, pad_;
};

// shared memory: buffer 0 (even inter-stage frames), buffer 1 (odd ones),
// then 32 floats of block-max scratch; offsets in floats
struct Chain {
  int n_stages;
  int buf1_offset;
  int red_offset;
  int pad_;
  Stage st[kMaxStages];
};

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1: return v > 0.0f ? v : 0.0f;                     // relu
    case 2: return fabsf(v);                                // abs
    case 3: return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : v); // sign
    default: return v;                                      // none
  }
}

// conv accumulate at conv output (oh, ow), channel co; x is the stage's
// input frame in shared memory, zero padding by bounds checks
__device__ __forceinline__ float conv_at(const Stage& s, const float* x,
                                         int oh, int ow, int co) {
  float acc = 0.0f;
  const int ih0 = oh * s.stride - s.pad_top;
  const int iw0 = ow * s.stride - s.pad_left;
  for (int di = 0; di < s.k; ++di) {
    const int ih = ih0 + di;
    if (ih < 0 || ih >= s.h_in) continue;
    for (int dj = 0; dj < s.k; ++dj) {
      const int iw = iw0 + dj;
      if (iw < 0 || iw >= s.w_in) continue;
      const float* xp = x + (ih * s.w_in + iw) * s.c_in;
      const int tap = di * s.k + dj;
      if (s.depthwise) {
        acc = fmaf(xp[co], __ldg(s.w + tap * s.c_out + co), acc);
      } else {
        const float* wp = s.w + (size_t)tap * s.c_in * s.c_out + co;
        for (int ci = 0; ci < s.c_in; ++ci) {
          acc = fmaf(xp[ci], __ldg(wp + (size_t)ci * s.c_out), acc);
        }
      }
    }
  }
  return acc;
}

__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    }
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float r = red[0];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(kThreads)
conv_chain_kernel(const float* __restrict__ codes,
                  const float* __restrict__ scale_in, float aq,
                  float* __restrict__ out, float* __restrict__ scale_out,
                  const Chain chain, int in_elems) {
  extern __shared__ float smem[];
  float* buf[2] = {smem, smem + chain.buf1_offset};
  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  for (int i = tid; i < in_elems; i += blockDim.x) {
    buf[0][i] = codes[(size_t)b * in_elems + i];
  }
  float scale = scale_in[b];
  __syncthreads();

  int n_last = in_elems;
  for (int si = 0; si < chain.n_stages; ++si) {
    const Stage& s = chain.st[si];
    const float* x = buf[si & 1];
    float* y = buf[(si + 1) & 1];
    const int n_out = s.h_out * s.w_out * s.c_out;
    float local_max = 0.0f;           // every y is >= 0 after the clamp
    for (int idx = tid; idx < n_out; idx += blockDim.x) {
      const int co = idx % s.c_out;
      const int t = idx / s.c_out;
      const int pw = t % s.w_out;
      const int ph = t / s.w_out;
      const float wscale = __fmul_rn(scale, s.ws[co]);
      const float b_co = s.has_bias ? s.bias[co] : 0.0f;
      const int p = s.pool_size;
      float pooled = 0.0f;
      for (int pi = 0; pi < p; ++pi) {
        for (int pj = 0; pj < p; ++pj) {
          float v = __fmul_rn(conv_at(s, x, ph * p + pi, pw * p + pj, co), wscale);
          if (s.has_bias) v = __fadd_rn(v, b_co);
          v = activate(v, s.act);
          if (s.pool_kind == 1) {
            pooled = (pi == 0 && pj == 0) ? v : fmaxf(pooled, v);
          } else if (s.pool_kind == 2) {
            pooled = __fadd_rn(pooled, v);    // row-major, from 0
          } else {
            pooled = v;
          }
        }
      }
      if (s.pool_kind == 2) pooled = __fdiv_rn(pooled, (float)(p * p));
      pooled = fmaxf(pooled, 0.0f);
      y[idx] = pooled;
      local_max = fmaxf(local_max, pooled);
    }
    const float amax = block_max(local_max, smem + chain.red_offset);
    scale = __fdiv_rn(fmaxf(amax, 1e-8f), aq);
    for (int idx = tid; idx < n_out; idx += blockDim.x) {
      const float q = rintf(__fdiv_rn(y[idx], scale));
      y[idx] = fminf(fmaxf(q, 0.0f), 15.0f);
    }
    __syncthreads();
    n_last = n_out;
  }

  const float* fin = buf[chain.n_stages & 1];
  for (int i = tid; i < n_last; i += blockDim.x) {
    out[(size_t)b * n_last + i] = fin[i];
  }
  if (tid == 0) scale_out[b] = scale;
}

}  // namespace

extern "C" int conv_chain_launch(const void* codes, const void* scale_in,
                                 float aq, void* out, void* scale_out,
                                 const void* chain, int batch, int in_elems,
                                 int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  conv_chain_kernel<<<batch, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)codes, (const float*)scale_in, aq, (float*)out,
      (float*)scale_out, *(const Chain*)chain, in_elems);
  return (int)cudaGetLastError();
}
