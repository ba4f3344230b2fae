// The plan executor's fused epilogue: dequant -> bias -> activation -> pool
// -> CRC requant of one step, as two kernels. It replaces no Pallas kernel:
// its counterpart is XLA's fusion of the reference's jitted executor
// (src/repro/core/plan.py::_execute_steps under jax.jit; the conv epilogue
// at its ConvStep branch, _crc_requant_traced at its top), which compiles
// the same elementwise chain and two reductions into a few fused loops
// around each Pallas call. The port ran it as a dozen eager torch ops a
// step (kernels/epilogue/ref.py keeps that sequence as the plain version).
//
// Per pooled output element, in the plan's association (not the strip
// kernels' _epilogue order):
//   v    = __fmul_rn(x, __fmul_rn(scale, ws[c]))  -- acc * (act_scale * ws);
//          scale and ws are 1 where absent, so a plain tensor passes as is
//   v    = __fadd_rn(v, bias[c])                  -- when there is a bias
//   v    = act(v)                                 -- relu / abs / sign / none
//   y    = pool over p x p windows                -- max, or the row-major
//          sum from 0 then __fdiv_rn by p*p
//   y    = max(y, 0)                              -- clamp_min(y, 0)
// pass 1 (epi_reduce_kernel): y -> device memory, and each block's max of
// y -> partials[b][block];
// pass 2 (epi_quant_kernel): each block reduces its frame's partials (or
// the whole batch's, per-tensor calibration; or takes a max the host
// reduced across shards), then, over the stored y,
//   scale = __fdiv_rn(max(amax, 1e-8f), aq)
//   code  = min(max(rintf(__fdiv_rn(y, scale)), 0), code_max)  (half to even)
// and writes the codes as float32, or straight into the next int8 conv's
// operand: uint8 [B, h + pads, w + pads, cp], the border and the channels
// past c zero. Every rounding is an explicit _rn intrinsic or rintf, so
// nvcc's FMA contraction has nothing to contract, and a -0.0 code comes out
// as +0.0 (equal under ==, as the plain version's may be either). Every
// max and min keeps a NaN, as torch's clamp, amax and max pool do (fmaxf
// would drop it), and sign(NaN) is 0, as torch.sign's: a NaN in a frame's
// accumulate, scale or bias gives that frame (per tensor: the batch) a NaN
// scale and NaN codes, as in the plain version, not finite ones; in the
// uint8 operand a NaN code is the conversion's byte, 0.
//
// What bounds it on an H100: bytes. Each element of the accumulate is read
// and each code written; the arithmetic is a few flops an element. The
// frame's max needs all of y before any code, and a bucket-8 batch of
// VGG16's conv1 is 103 MB of accumulate, twice the L2: so pass 1 stores y
// (the pooled output, a quarter of the accumulate at p = 2) and pass 2
// reads it back. Pass 2 recomputing y from the accumulate instead was
// measured slower at every VGG16 shape but two of 14x14 (PERF.md §6),
// and was dropped. A frame's units (4 channels of a pixel where c % 4 ==
// 0, 16-byte loads; else one element) are spread over `nblk` blocks a
// frame so that a batch fills the card; the two passes need no memset and
// no atomics, and nothing is read back to the host between them (a CUDA
// graph captures both).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// one step's epilogue, laid out by kernels/epilogue/ops.py (_Epi)
struct Epi {
  const float* x;       // [batch] frames of n * p * p floats, xs apart
  const float* scale;   // act_scale: scale_n (1 or batch) values, or null
  const float* ws;      // ws_n (1 or c) values, or null
  const float* bias;    // bias_n (1 or c) values, or null
  float* y;             // [batch, n] pooled y: pass 1 stores, pass 2 reads
  float* partials;      // [batch, nblk1] block maxima of pass 1
  long long xs;         // floats from one frame of x to the next
  long long n;          // pooled elements a frame
  int batch, scale_n, ws_n, bias_n;
  int act;              // 0 none, 1 relu, 2 abs, 3 sign
  int pool_kind;        // 0 none, 1 max, 2 avg
  int p;                // pool size (1 without)
  int w_in;             // x's columns (before pooling)
  int c;                // channels: x's last axis
  int w_out;            // pooled columns
  int nblk1;            // pass 1's blocks a frame
};

// pass 2's output, laid out by kernels/epilogue/ops.py (_Quant)
struct Quant {
  const float* amax;    // one max reduced by the host, or null
  float* scale_out;     // [batch] (per frame) or [1]
  float* codes;         // [batch, n] float32 codes, or null
  uint32_t* operand;    // [batch, hp, wp, cp] uint8 as words, or null
  float aq;
  int per_frame, code_max;
  int hp, wp, cp, top, left, h;   // the operand's geometry; y's pooled rows
  int nblk2;            // pass 2's blocks a frame
};

// max and min that keep a NaN (torch's clamp / amax / max pool)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1: return (v > 0.0f || v != v) ? v : 0.0f;            // relu
    case 2: return fabsf(v);                                   // abs
    case 3: return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f); // sign
    default: return v;                                         // none
  }
}

template <int V>
__device__ __forceinline__ void load(const float* p, float v[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

// y of the V channels c0.. of pooled element o of frame b
template <int V>
__device__ __forceinline__ void pooled(const Epi& e, int b, long long o,
                                       float y[V]) {
  const int c0 = (int)(o % e.c);
  const float s = e.scale ? __ldg(e.scale + (e.scale_n > 1 ? b : 0)) : 1.0f;
  float wsc[V], bv[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    wsc[j] = e.ws ? __fmul_rn(s, __ldg(e.ws + (e.ws_n > 1 ? c0 + j : 0))) : s;
    bv[j] = e.bias ? __ldg(e.bias + (e.bias_n > 1 ? c0 + j : 0)) : 0.0f;
  }
  const float* xb = e.x + (long long)b * e.xs;
  if (e.p == 1) {
    float xv[V];
    load<V>(xb + o, xv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float v = __fmul_rn(xv[j], wsc[j]);
      if (e.bias) v = __fadd_rn(v, bv[j]);
      y[j] = nan_max(activate(v, e.act), 0.0f);
    }
    return;
  }
  const long long pix = o / e.c;
  const long long ph = pix / e.w_out, pw = pix - ph * e.w_out;
#pragma unroll
  for (int j = 0; j < V; ++j) y[j] = 0.0f;
  for (int di = 0; di < e.p; ++di) {
    for (int dj = 0; dj < e.p; ++dj) {
      float xv[V];
      load<V>(xb + ((ph * e.p + di) * e.w_in + pw * e.p + dj) * e.c + c0, xv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float v = __fmul_rn(xv[j], wsc[j]);
        if (e.bias) v = __fadd_rn(v, bv[j]);
        v = activate(v, e.act);
        if (e.pool_kind == 1) {
          y[j] = (di == 0 && dj == 0) ? v : nan_max(y[j], v);
        } else {
          y[j] = __fadd_rn(y[j], v);            // row-major, from 0
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (e.pool_kind == 2) y[j] = __fdiv_rn(y[j], (float)(e.p * e.p));
    y[j] = nan_max(y[j], 0.0f);
  }
}

// the max of v over the block, in every thread (max is exact in any
// order; a NaN anywhere makes it NaN)
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) m = nan_max(m, red[i]);
  __syncthreads();
  return m;
}

// [lo, hi) of `units` for block `blk` of `nblk`
__device__ __forceinline__ void unit_range(long long units, int blk,
                                           int nblk, long long* lo,
                                           long long* hi) {
  const long long per = (units + nblk - 1) / nblk;
  *lo = blk * per;
  *hi = min(units, *lo + per);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
epi_reduce_kernel(const Epi e) {
  __shared__ float red[kWarps];
  const int b = blockIdx.y;
  long long lo, hi;
  unit_range(e.n / V, blockIdx.x, e.nblk1, &lo, &hi);
  float m = 0.0f;                        // every y is >= 0
  for (long long u = lo + threadIdx.x; u < hi; u += kThreads) {
    float y[V];
    pooled<V>(e, b, u * V, y);
#pragma unroll
    for (int j = 0; j < V; ++j) m = nan_max(m, y[j]);
    float* dst = e.y + (long long)b * e.n + u * V;
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
      *dst = y[0];
    }
  }
  m = block_max(m, red);
  if (threadIdx.x == 0) e.partials[b * e.nblk1 + blockIdx.x] = m;
}

__device__ __forceinline__ float code(float y, float scale, int code_max) {
  // + 0.0f turns a -0.0 into +0.0
  return nan_min(nan_max(rintf(__fdiv_rn(y, scale)), 0.0f),
                 (float)code_max) + 0.0f;
}

template <int V, bool kOperand>
__global__ void __launch_bounds__(kThreads)
epi_quant_kernel(const Epi e, const Quant q) {
  __shared__ float red[kWarps];
  const int b = blockIdx.y;
  float amax;
  if (q.amax != nullptr) {
    amax = __ldg(q.amax);
  } else {
    // this frame's block maxima, or every frame's (per-tensor)
    const int first = q.per_frame ? b * e.nblk1 : 0;
    const int count = q.per_frame ? e.nblk1 : e.batch * e.nblk1;
    float m = 0.0f;
    for (int i = threadIdx.x; i < count; i += kThreads) {
      m = nan_max(m, e.partials[first + i]);
    }
    amax = block_max(m, red);
  }
  const float scale = __fdiv_rn(nan_max(amax, 1e-8f), q.aq);
  if (blockIdx.x == 0 && threadIdx.x == 0 && (q.per_frame || b == 0)) {
    q.scale_out[q.per_frame ? b : 0] = scale;
  }
  if constexpr (!kOperand) {
    long long lo, hi;
    unit_range(e.n / V, blockIdx.x, q.nblk2, &lo, &hi);
    for (long long u = lo + threadIdx.x; u < hi; u += kThreads) {
      float y[V];
      load<V>(e.y + (long long)b * e.n + u * V, y);
      float* dst = q.codes + (long long)b * e.n + u * V;
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(
            code(y[0], scale, q.code_max), code(y[1], scale, q.code_max),
            code(y[2], scale, q.code_max), code(y[3], scale, q.code_max));
      } else {
        *dst = code(y[0], scale, q.code_max);
      }
    }
  } else {
    // one 4-byte word (4 channels of a pixel) of the operand a unit
    const int cw = q.cp / 4;
    const long long words = (long long)q.hp * q.wp * cw;
    long long lo, hi;
    unit_range(words, blockIdx.x, q.nblk2, &lo, &hi);
    for (long long u = lo + threadIdx.x; u < hi; u += kThreads) {
      const long long pix = u / cw;
      const int c0 = (int)(u - pix * cw) * 4;
      const int r = (int)(pix / q.wp) - q.top;
      const int s = (int)(pix % q.wp) - q.left;
      uint32_t word = 0;
      if (r >= 0 && r < q.h && s >= 0 && s < e.w_out && c0 < e.c) {
        const long long o = ((long long)r * e.w_out + s) * e.c + c0;
        if constexpr (V == 4) {           // c % 4 == 0: all four are codes
          float y[4];
          load<4>(e.y + (long long)b * e.n + o, y);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            word |= (uint32_t)code(y[j], scale, q.code_max) << (8 * j);
          }
        } else {
          for (int j = 0; j < 4 && c0 + j < e.c; ++j) {
            float y[1];
            load<1>(e.y + (long long)b * e.n + o + j, y);
            word |= (uint32_t)code(y[0], scale, q.code_max) << (8 * j);
          }
        }
      }
      q.operand[(long long)b * words + u] = word;
    }
  }
}

template <int V>
cudaError_t reduce(const Epi& e, cudaStream_t stream) {
  epi_reduce_kernel<V><<<dim3(e.nblk1, e.batch), kThreads, 0, stream>>>(e);
  return cudaGetLastError();
}

template <int V, bool kOperand>
cudaError_t quant(const Epi& e, const Quant& q, cudaStream_t stream) {
  epi_quant_kernel<V, kOperand>
      <<<dim3(q.nblk2, e.batch), kThreads, 0, stream>>>(e, q);
  return cudaGetLastError();
}

}  // namespace

// Pass 1 over the Epi at `epi` (a host struct, passed by value): `vec` 4
// takes 4 channels a unit (c % 4 == 0, 16-byte aligned frames), else 1.
extern "C" int epilogue_reduce_launch(const void* epi, int vec,
                                      void* stream) {
  const Epi& e = *(const Epi*)epi;
  cudaStream_t s = (cudaStream_t)stream;
  if (e.nblk1 < 1 || e.batch < 1 || e.y == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)(vec == 4 ? reduce<4>(e, s) : reduce<1>(e, s));
}

// Pass 2 over the same Epi and the Quant at `qt`: float32 codes where
// qt->codes is set, else the uint8 operand at qt->operand.
extern "C" int epilogue_quant_launch(const void* epi, const void* qt, int vec,
                                     void* stream) {
  const Epi& e = *(const Epi*)epi;
  const Quant& q = *(const Quant*)qt;
  cudaStream_t s = (cudaStream_t)stream;
  if (q.nblk2 < 1 || e.batch < 1 || e.y == nullptr ||
      (q.operand && q.cp % 4)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool op = q.operand != nullptr;
  if (vec == 4) return (int)(op ? quant<4, true>(e, q, s)
                                : quant<4, false>(e, q, s));
  return (int)(op ? quant<1, true>(e, q, s) : quant<1, false>(e, q, s));
}
