// The plan executor's fused epilogue: dequant -> bias -> activation -> pool
// -> CRC requant of one step. It replaces no Pallas kernel: its
// counterpart is XLA's fusion of the reference's jitted executor
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
//   amax = the max of y over the frame (per tensor: over the batch)
//   scale = __fdiv_rn(max(amax, 1e-8f), aq)
//   code  = min(max(rintf(__fdiv_rn(y, scale)), 0), code_max)  (half to even)
// and the codes go out as float32, or straight into the next int8 conv's
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
// What bounds it on an H100: bytes. Each element of the input is read and
// each code written; the arithmetic is a few flops an element. The frame's
// max needs all of y before any code. Three designs, picked by the
// wrapper's plain function of the shape (kernels/epilogue/ops.py::
// epilogue_config):
//   * one launch a call, a thread-block cluster a frame
//     (epi_cluster_kernel): where the calibration is per frame (or the
//     batch one frame) and the pooled frame is of 1,025 to 65,536
//     elements (VGG16's conv13, flatten and dense layers, VGG9-CA's convs,
//     the imaging path's 1-channel frames; below and above, the card ran
//     the pair faster). Each of the cluster's 4, 8 or 16 CTAs (about
//     2,048 elements each) computes its slice of y once and keeps it in its
//     shared memory, the frame's max is exchanged through distributed
//     shared memory behind one cluster barrier (release / acquire at
//     cluster scope, not cg's cluster.sync), and each CTA writes its
//     slice's codes from shared memory. Each input byte is read once and
//     each code written once; no partials in HBM;
//   * the fold (VGG16's conv1-conv10, kernels/conv_bank/strip.py): the int8
//     strip conv's store does this kernel's first pass -- it writes the
//     unpooled, activated, clamped y where it wrote the accumulate, and one
//     max a CTA -- and epi_quant_kernel, given that y as x with no scale,
//     ws or bias, pools (max) it as it writes the codes;
//   * two passes (per-tensor calibration at batch > 1, where the max
//     couples the frames; a max the host reduces across shards; frames
//     outside the cluster form's range): pass 1 (epi_reduce_kernel) writes
//     each block's max of y to partials[b][block] and stores y; pass 2
//     (epi_quant_kernel) reduces its frame's partials (or the batch's, or
//     takes the host's), then writes the codes of the stored y (faster on
//     the card than recomputing it, which the fold's pass 2 does). No
//     memset, no atomics, nothing read back to the host between them (a
//     CUDA graph captures both).
// No unit does a 64-bit division: a frame's offsets are 32-bit (the
// wrapper refuses a frame of 2^31 floats), the frame is the grid's y, and
// a thread's (row, column, channel) is stepped by adds and compares
// (Walk) from one 32-bit division when it starts. A thread has kUnroll
// units' loads in flight at once (a p = 2 window's four together): a
// cluster runs one or two CTAs an SM, and one load at a time a thread
// would leave the SM a few KB in flight. 16-byte loads take 4
// elements a unit where the frames are aligned and either 4 channels of a
// pixel are contiguous (c % 4 == 0) or there is no pool (4 flat elements,
// each its own channel).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;          // a block of the pair
constexpr int kClusterThreads = 512;   // a CTA of a cluster
constexpr int kUnroll = 4;             // units a thread has in flight
constexpr int kClusterScratch = 32;   // floats after a cluster CTA's slice

// one step's epilogue, laid out by kernels/epilogue/ops.py (_Epi)
struct Epi {
  const float* x;       // [batch] frames of n * p * p floats, xs apart
  const float* scale;   // act_scale: scale_n (1 or batch) values, or null
  const float* ws;      // ws_n (1 or c) values, or null
  const float* bias;    // bias_n (1 or c) values, or null
  float* y;             // [batch, n] pooled y pass 1 stores and pass 2
                        // reads; null only in the fold's pass 2, which
                        // pools x (the conv's unpooled y) as it codes
  float* partials;      // [batch, nblk1] block maxima (pass 1's, or the
                        // folded conv's CTAs')
  long long xs;         // floats from one frame of x to the next
  long long n;          // pooled elements a frame (n * p * p < 2^31)
  int batch, scale_n, ws_n, bias_n;
  int act;              // 0 none, 1 relu, 2 abs, 3 sign
  int pool_kind;        // 0 none, 1 max, 2 avg
  int p;                // pool size (1 without)
  int w_in;             // x's columns (before pooling)
  int c;                // channels: x's last axis
  int w_out;            // pooled columns
  int nblk1;            // partials a frame
};

// the codes' destination, laid out by kernels/epilogue/ops.py (_Quant)
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

// a max that keeps a NaN (torch's clamp / amax / max pool)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
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

// the same from memory this kernel wrote (shared memory, or a slice)
template <int V>
__device__ __forceinline__ void load_written(const float* p, float v[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float v[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// (row, column, channel) of a flat index over [rows][cols][chs], stepped
// by a fixed stride with adds and compares (one carry each: the stride's
// own column and channel are below cols and chs)
struct Walk {
  int r, s, ch;
};

__device__ __forceinline__ Walk walk_at(int i, int cols, int chs) {
  const int pix = i / chs;
  const int r = pix / cols;
  return Walk{r, pix - r * cols, i - pix * chs};
}

__device__ __forceinline__ void walk_step(Walk& w, const Walk& d, int cols,
                                          int chs) {
  w.ch += d.ch;
  if (w.ch >= chs) { w.ch -= chs; ++w.s; }
  w.s += d.s;
  if (w.s >= cols) { w.s -= cols; ++w.r; }
  w.r += d.r;
}

// y of the V elements o.. of a frame (xb its x): pooled row ph, column pw,
// channel c0 (the first's; the next V - 1 follow in the flat order, so at
// p == 1 with c % 4 != 0 they wrap into the next pixel's channels)
template <int V>
__device__ __forceinline__ void pooled(const Epi& e, const float* xb, int o,
                                       int ph, int pw, int c0, float y[V]) {
  const float s = e.scale ? __ldg(e.scale + (e.scale_n > 1 ? blockIdx.y : 0))
                          : 1.0f;
  float wsc[V], bv[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    int cj = c0 + j;
    while (cj >= e.c) cj -= e.c;
    wsc[j] = e.ws ? __fmul_rn(s, __ldg(e.ws + (e.ws_n > 1 ? cj : 0))) : s;
    bv[j] = e.bias ? __ldg(e.bias + (e.bias_n > 1 ? cj : 0)) : 0.0f;
  }
  auto value = [&](float x, int j) {
    float v = __fmul_rn(x, wsc[j]);
    if (e.bias) v = __fadd_rn(v, bv[j]);
    return activate(v, e.act);
  };
  if (e.p == 1) {
    float xv[V];
    load<V>(xb + o, xv);
#pragma unroll
    for (int j = 0; j < V; ++j) y[j] = nan_max(value(xv[j], j), 0.0f);
    return;
  }
  const float* base = xb + ((ph * e.p) * e.w_in + pw * e.p) * e.c + c0;
#pragma unroll
  for (int j = 0; j < V; ++j) y[j] = 0.0f;
  for (int di = 0; di < e.p; ++di) {
    for (int dj = 0; dj < e.p; ++dj) {
      float xv[V];
      load<V>(base + (di * e.w_in + dj) * e.c, xv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float v = value(xv[j], j);
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

// the loads of a unit of V elements at a pool of P (1, or 2): x at
// element o, or the 2 x 2 window of pooled (ph, pw), channels c0..
template <int V, int P>
__device__ __forceinline__ void unit_load(const Epi& e, const float* xb,
                                          int o, int ph, int pw, int c0,
                                          float (&xv)[P * P][V]) {
  if constexpr (P == 1) {
    load<V>(xb + o, xv[0]);
  } else {
    const float* base = xb + ((ph * 2) * e.w_in + pw * 2) * e.c + c0;
    load<V>(base, xv[0]);
    load<V>(base + e.c, xv[1]);
    load<V>(base + e.w_in * e.c, xv[2]);
    load<V>(base + (e.w_in + 1) * e.c, xv[3]);
  }
}

// whether a call's x goes into the pool as it is: no scale, ws, bias or
// act (the frames', the CA's, the upsample's, the flatten's, and the fold's
// pass 2 over the conv's y); x * 1.0f is x, so the product is skipped
__device__ __forceinline__ bool plain(const Epi& e) {
  return e.scale == nullptr && e.ws == nullptr && e.bias == nullptr &&
         e.act == 0;
}

// y of a unit from its loads, as pooled() computes it
template <int V, int P>
__device__ __forceinline__ void unit_y(const Epi& e, int c0,
                                       const float (&xv)[P * P][V],
                                       float y[V]) {
  if (plain(e)) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float acc = xv[0][j];
#pragma unroll
      for (int t = 1; t < P * P; ++t) {
        acc = e.pool_kind == 1 ? nan_max(acc, xv[t][j])
                               : __fadd_rn(acc, xv[t][j]);
      }
      if (P > 1 && e.pool_kind == 2) {
        // the sum from 0: 0 + x is x but for a -0, which the clamp below
        // turns into +0 as 0 + -0 would have
        acc = __fdiv_rn(acc, (float)(P * P));
      }
      y[j] = nan_max(acc, 0.0f);
    }
    return;
  }
  const float s = e.scale ? __ldg(e.scale + (e.scale_n > 1 ? blockIdx.y : 0))
                          : 1.0f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float wsc = s, bv = 0.0f;
    if (e.ws_n > 1 || e.bias_n > 1) {
      int cj = c0 + j;
      while (cj >= e.c) cj -= e.c;
      if (e.ws) wsc = __fmul_rn(s, __ldg(e.ws + (e.ws_n > 1 ? cj : 0)));
      if (e.bias) bv = __ldg(e.bias + (e.bias_n > 1 ? cj : 0));
    } else {
      if (e.ws) wsc = __fmul_rn(s, __ldg(e.ws));
      if (e.bias) bv = __ldg(e.bias);
    }
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < P * P; ++t) {
      float v = __fmul_rn(xv[t][j], wsc);
      if (e.bias) v = __fadd_rn(v, bv);
      v = activate(v, e.act);
      if (P == 1) {
        acc = v;
      } else {                          // row-major, the sum from 0
        acc = e.pool_kind == 1 ? (t == 0 ? v : nan_max(acc, v))
                               : __fadd_rn(acc, v);
      }
    }
    if (P > 1 && e.pool_kind == 2) acc = __fdiv_rn(acc, (float)(P * P));
    y[j] = nan_max(acc, 0.0f);
  }
}

// fn(u, y) for each unit u of [lo, hi) this thread takes (lo + tid, then
// every T), kUnroll (a 2 x 2 pool: 2) at a time, all of their loads issued
// before any is used: a load under a branch would leave a warp one load
// in flight. A unit past hi loads the frame's first unit and is dropped.
// P == 0: any pool, pooled() a unit at a time.
template <int V, int P, int T, typename Fn>
__device__ __forceinline__ void for_units(const Epi& e, const float* xb,
                                          int lo, int hi, Fn fn) {
  constexpr int U = P == 2 ? 2 : kUnroll;
  Walk w = walk_at((lo + (int)threadIdx.x) * V, e.w_out, e.c);
  const Walk d = walk_at(T * V, e.w_out, e.c);
  for (int u0 = lo + threadIdx.x; u0 < hi; u0 += U * T) {
    if constexpr (P == 0) {
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int u = u0 + k * T;
        if (u < hi) {
          float y[V];
          pooled<V>(e, xb, u * V, w.r, w.s, w.ch, y);
          fn(u, y);
        }
        walk_step(w, d, e.w_out, e.c);
      }
    } else {
      float xv[U][P * P][V];
      int c0[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const bool ok = u0 + k * T < hi;
        unit_load<V, P>(e, xb, ok ? (u0 + k * T) * V : 0, ok ? w.r : 0,
                        ok ? w.s : 0, ok ? w.ch : 0, xv[k]);
        c0[k] = w.ch;
        walk_step(w, d, e.w_out, e.c);
      }
#pragma unroll
      for (int k = 0; k < U; ++k) {
        if (u0 + k * T >= hi) break;
        float y[V];
        unit_y<V, P>(e, c0[k], xv[k], y);
        fn(u0 + k * T, y);
      }
    }
  }
}

// fn(u, y, real channels) for each operand word u of [lo, hi) this thread
// takes, kUnroll at a time with their loads issued first: 4 channels of a
// pixel (c % 4 == 0), stored y (ys, from element ylo; kept in this
// kernel's memory) or recomputed from x (ys null) at a pool of P; a
// border word or one past hi loads the frame's first unit, dropped
template <int P, int T, typename Fn>
__device__ __forceinline__ void for_words(const Epi& e, const Quant& q,
                                          const float* xb, const float* ys,
                                          int ylo, int lo, int hi, Fn fn) {
  constexpr int U = P == 2 ? 2 : kUnroll;
  const int cw = q.cp / 4;
  Walk w = walk_at(lo + (int)threadIdx.x, q.wp, cw);
  const Walk d = walk_at(T, q.wp, cw);
  for (int u0 = lo + threadIdx.x; u0 < hi; u0 += U * T) {
    float xv[U][P * P][4];
    int c0[U];
    bool in[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int r = w.r - q.top, s = w.s - q.left;
      in[k] = u0 + k * T < hi && r >= 0 && r < q.h && s >= 0 &&
              s < e.w_out && w.ch * 4 < e.c;
      c0[k] = in[k] ? w.ch * 4 : 0;
      const int rr = in[k] ? r : 0, ss = in[k] ? s : 0;
      const int o = (rr * e.w_out + ss) * e.c + c0[k];
      if (ys != nullptr) {
        load_written<4>(ys + o - (in[k] ? ylo : 0), xv[k][0]);
      } else {
        unit_load<4, P>(e, xb, o, rr, ss, c0[k], xv[k]);
      }
      walk_step(w, d, q.wp, cw);
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (u0 + k * T >= hi) break;
      float y[4];
      if (ys != nullptr) {
#pragma unroll
        for (int j = 0; j < 4; ++j) y[j] = xv[k][0][j];
      } else {
        unit_y<4, P>(e, c0[k], xv[k], y);
      }
      fn(u0 + k * T, y, in[k] ? 4 : 0);
    }
  }
}

// the max of v over the block of T threads, in every thread (max is exact
// in any order; a NaN anywhere makes it NaN)
template <int T>
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int i = 1; i < T / 32; ++i) m = nan_max(m, red[i]);
  __syncthreads();
  return m;
}

// [lo, hi) of `units` for block `blk` of `nblk`
__device__ __forceinline__ void unit_range(int units, int blk, int nblk,
                                           int* lo, int* hi) {
  const int per = (units + nblk - 1) / nblk;
  *lo = min(units, blk * per);
  *hi = min(units, *lo + per);
}

// A step's codes: rint(y / scale) (half to even) clamped at code_max, in
// the true quotient's rounding. y is +0 or more, or NaN (every y comes out
// of nan_max(., 0), which turns a -0 into +0), and scale above 0 or NaN: so
// the quotient is +0 or more or NaN, and its clamp at 0 and a -0 code
// cannot happen. The division itself is the costly instruction of a pass
// that moves few bytes a code, so a code starts from y * (1 / scale): that
// product is within 2^-22 of y / scale relative (two roundings), and
// fl(y / scale) within 2^-24, so the two round to the same integer unless
// the product lies within 2^-20 (relative, 2^-20 absolute below 1) of a
// half-integer; there (and only there, a few in 10^5 values) the true
// quotient decides. A NaN stays NaN, an inf clamps as the quotient's does
// (inf * (1 / scale) is inf, or NaN where scale is inf, as inf / inf).
struct Coder {
  float scale, inv, top;        // scale, __frcp_rn(scale), code_max

  __device__ __forceinline__ float operator()(float y) const {
    float q = __fmul_rn(y, inv);
    float k = rintf(q);
    const float guard = __fmul_rn(fmaxf(q, 1.0f), 9.5367431640625e-07f);
    if (fabsf(fabsf(q - k) - 0.5f) < guard) {
      k = rintf(__fdiv_rn(y, scale));
    }
    return k > top ? top : k;
  }
};

// the m codes of y as the bytes of a word: a code k in 0..255 is the low
// byte of k + 2^23's bits; a NaN code is the byte 0
__device__ __forceinline__ uint32_t pack(const float y[4], int m,
                                         const Coder& code) {
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float q = code(y[j]);
    const uint32_t byte = q == q ? __float_as_uint(q + 8388608.0f) & 0xffu
                                 : 0u;
    word |= (m == 4 || j < m ? byte : 0u) << (8 * j);
  }
  return m > 0 ? word : 0u;
}

// y of operand word (r, s, channels c0..c0+3) of a frame one channel at a
// time (c % 4 != 0), stored (ys, the frame's y from element lo) or
// recomputed from x (ys null) -> the count of real channels
__device__ __forceinline__ int word_y(const Epi& e, const float* xb,
                                      const float* ys, int lo, int r, int s,
                                      int c0, float y[4]) {
  const int o = (r * e.w_out + s) * e.c + c0;
  const int m = min(4, e.c - c0);
  for (int j = 0; j < m; ++j) {
    if (ys != nullptr) {
      y[j] = ys[o + j - lo];
    } else {
      pooled<1>(e, xb, o + j, r, s, c0 + j, y + j);
    }
  }
  return m;
}

// the operand words [lo, hi) of a frame one at a time (c % 4 != 0)
template <int T>
__device__ __forceinline__ void words_by_channel(const Epi& e,
                                                 const Quant& q,
                                                 const float* xb,
                                                 const float* ys, int ylo,
                                                 int lo, int hi,
                                                 const Coder& code,
                                                 uint32_t* dst) {
  const int cw = q.cp / 4;
  Walk w = walk_at(lo + (int)threadIdx.x, q.wp, cw);
  const Walk d = walk_at(T, q.wp, cw);
  for (int u = lo + threadIdx.x; u < hi; u += T) {
    const int r = w.r - q.top, s = w.s - q.left, c0 = w.ch * 4;
    float y[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int m = 0;
    if (r >= 0 && r < q.h && s >= 0 && s < e.w_out && c0 < e.c) {
      m = word_y(e, xb, ys, ylo, r, s, c0, y);
    }
    dst[u] = pack(y, m, code);
    walk_step(w, d, q.wp, cw);
  }
}

// pass 1: each block's max of y over its units into partials[b][block],
// and y itself
template <int V, int P>
__global__ void __launch_bounds__(kThreads)
epi_reduce_kernel(const Epi e) {
  __shared__ float red[kThreads / 32];
  const int b = blockIdx.y;
  const float* xb = e.x + b * e.xs;
  int lo, hi;
  unit_range((int)e.n / V, blockIdx.x, e.nblk1, &lo, &hi);
  float m = 0.0f;                        // every y is >= 0
  for_units<V, P, kThreads>(e, xb, lo, hi, [&](int u, const float* y) {
#pragma unroll
    for (int j = 0; j < V; ++j) m = nan_max(m, y[j]);
    store<V>(e.y + b * e.n + u * V, y);
  });
  m = block_max<kThreads>(m, red);
  if (threadIdx.x == 0) e.partials[b * e.nblk1 + blockIdx.x] = m;
}

// pass 2: the scale from the partials, then the codes of the stored y (the
// pair), or of y pooled from x (e.y null: the fold, whose x is the conv's
// unpooled y)
template <int V, bool kOperand, int P>
__global__ void __launch_bounds__(kThreads)
epi_quant_kernel(const Epi e, const Quant q) {
  __shared__ float red[kThreads / 32];
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
    amax = block_max<kThreads>(m, red);
  }
  const float scale = __fdiv_rn(nan_max(amax, 1e-8f), q.aq);
  if (blockIdx.x == 0 && threadIdx.x == 0 && (q.per_frame || b == 0)) {
    q.scale_out[q.per_frame ? b : 0] = scale;
  }
  const Coder code{scale, __frcp_rn(scale), (float)q.code_max};
  const float* xb = e.x + b * e.xs;
  const float* yb = e.y != nullptr ? e.y + b * e.n : nullptr;
  if constexpr (!kOperand) {
    int lo, hi;
    unit_range((int)e.n / V, blockIdx.x, q.nblk2, &lo, &hi);
    float* dst = q.codes + b * e.n;
    auto write = [&](int u, const float* y) {
      float c[V];
#pragma unroll
      for (int j = 0; j < V; ++j) c[j] = code(y[j]);
      store<V>(dst + u * V, c);
    };
    if (yb != nullptr) {
      // the stored y, kUnroll units' loads in flight (one past hi loads
      // the last unit again, dropped)
      for (int u0 = lo + threadIdx.x; u0 < hi; u0 += kUnroll * kThreads) {
        float y[kUnroll][V];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          load<V>(yb + min(u0 + k * kThreads, hi - 1) * V, y[k]);
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          if (u0 + k * kThreads >= hi) break;
          write(u0 + k * kThreads, y[k]);
        }
      }
    } else {
      for_units<V, P, kThreads>(e, xb, lo, hi, write);
    }
  } else {
    // one 4-byte word (4 channels of a pixel) of the operand a unit
    const int words = q.hp * q.wp * (q.cp / 4);
    int lo, hi;
    unit_range(words, blockIdx.x, q.nblk2, &lo, &hi);
    uint32_t* dst = q.operand + (long long)b * words;
    if (V == 4 && (e.c & 3) == 0 && (P != 0 || yb != nullptr)) {
      for_words<P == 0 ? 1 : P, kThreads>(
          e, q, xb, yb, 0, lo, hi, [&](int u, const float* y, int m) {
            dst[u] = pack(y, m, code);
          });
    } else {
      words_by_channel<kThreads>(e, q, xb, yb, 0, lo, hi, code, dst);
    }
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// pixels of c channels whose elements fill whole units of V
// (ops.py::pixel_group)
__host__ __device__ __forceinline__ int pixel_group(int c, int v) {
  return (v == 1 || (c & 3) == 0) ? 1 : ((c & 1) ? 4 : 2);
}

// the padded operand pixel of y pixel `pix` of `npix` (0 and the end map
// to the operand's ends, so the ranges of consecutive slices tile it and
// each border pixel goes with the slice before the next interior one)
__device__ __forceinline__ int padded_pixel(const Epi& e, const Quant& q,
                                            int pix, int npix) {
  if (pix == 0) return 0;
  if (pix == npix) return q.hp * q.wp;
  const int r = pix / e.w_out;
  return (r + q.top) * q.wp + pix - r * e.w_out + q.left;
}

// One frame a cluster of gridDim.x CTAs (grid gridDim.x x batch): CTA
// `rank` computes its slice of the frame's y into its shared memory (whole
// pixels where it writes an operand), the frame's max goes through each
// CTA's slot behind one cluster barrier, and each CTA writes its slice's
// codes (for an operand, the words of its range of padded pixels).
template <int V, bool kOperand, int P>
__global__ void __launch_bounds__(kClusterThreads)
epi_cluster_kernel(const Epi e, const Quant q) {
  constexpr int T = kClusterThreads;
  extern __shared__ __align__(16) float smem[];
  const int ncl = gridDim.x;
  const int rank = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int n = (int)e.n;
  // the slice: [lo, hi) elements, whole units (and whole pixels)
  int lo, hi, cap;
  if constexpr (kOperand) {
    // whole groups of gp pixels, so a slice is whole units
    const int npix = n / e.c;
    const int gp = pixel_group(e.c, V);
    const int groups = (npix + gp - 1) / gp;
    lo = min(npix, (int)((long long)groups * rank / ncl) * gp) * e.c;
    hi = min(npix, (int)((long long)groups * (rank + 1) / ncl) * gp) * e.c;
    cap = (groups + ncl - 1) / ncl * gp * e.c;
  } else {
    const int units = n / V;
    lo = (int)((long long)units * rank / ncl) * V;
    hi = (int)((long long)units * (rank + 1) / ncl) * V;
    cap = (units + ncl - 1) / ncl * V;
  }
  float* ys = smem;
  float* scr = smem + (cap + 3) / 4 * 4;    // kClusterScratch floats
  float* slot = scr;                        // this CTA's max
  float* red = scr + 4;                     // [T / 32]
  float* frame_max = red + T / 32;
  const float* xb = e.x + b * e.xs;

  float m = 0.0f;                           // every y is >= 0
  for_units<V, P, T>(e, xb, lo / V, hi / V, [&](int u, const float* y) {
#pragma unroll
    for (int j = 0; j < V; ++j) m = nan_max(m, y[j]);
    store<V>(ys + u * V - lo, y);
  });
  m = block_max<T>(m, red);
  if (tid == 0) *slot = m;
  // every CTA has started and written its slot (release / acquire at
  // cluster scope: the one barrier before a peer's slot is read)
  cluster_arrive();
  cluster_wait();
  if (tid < 32) {
    cg::cluster_group cluster = cg::this_cluster();
    float v = tid < ncl ? *cluster.map_shared_rank(slot, tid) : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
    }
    if (tid == 0) *frame_max = v;
  }
  __syncthreads();
  // this CTA is done with its peers' slots; it waits below, before it
  // exits, until every peer is done with its own
  cluster_arrive();
  const float scale = __fdiv_rn(nan_max(*frame_max, 1e-8f), q.aq);
  if (rank == 0 && tid == 0) q.scale_out[q.per_frame ? b : 0] = scale;
  const Coder code{scale, __frcp_rn(scale), (float)q.code_max};
  if constexpr (!kOperand) {
    for (int o = lo + tid * V; o < hi; o += T * V) {
      float y[V];
      load_written<V>(ys + o - lo, y);
#pragma unroll
      for (int j = 0; j < V; ++j) y[j] = code(y[j]);
      store<V>(q.codes + b * e.n + o, y);
    }
  } else {
    const int npix = n / e.c;
    const int cw = q.cp / 4;
    const int wlo = padded_pixel(e, q, lo / e.c, npix) * cw;
    const int whi = padded_pixel(e, q, hi / e.c, npix) * cw;
    uint32_t* dst = q.operand + (long long)b * q.hp * q.wp * cw;
    if (V == 4 && (e.c & 3) == 0) {
      for_words<1, T>(e, q, xb, ys, lo, wlo, whi,
                      [&](int u, const float* y, int cnt) {
                        dst[u] = pack(y, cnt, code);
                      });
    } else {
      words_by_channel<T>(e, q, xb, ys, lo, wlo, whi, code, dst);
    }
  }
  cluster_wait();
}

// the kernels' pool size: 1, 2, or 0 (any)
int pool_inst(const Epi& e) {
  return e.p == 1 ? 1 : (e.p == 2 ? 2 : 0);
}

template <int V, int P>
cudaError_t reduce(const Epi& e, cudaStream_t stream) {
  epi_reduce_kernel<V, P><<<dim3(e.nblk1, e.batch), kThreads, 0, stream>>>(
      e);
  return cudaGetLastError();
}

template <int V>
cudaError_t reduce_p(const Epi& e, cudaStream_t stream) {
  switch (pool_inst(e)) {
    case 1: return reduce<V, 1>(e, stream);
    case 2: return reduce<V, 2>(e, stream);
    default: return reduce<V, 0>(e, stream);
  }
}

template <int V, bool kOperand, int P>
cudaError_t quant(const Epi& e, const Quant& q, cudaStream_t stream) {
  epi_quant_kernel<V, kOperand, P>
      <<<dim3(q.nblk2, e.batch), kThreads, 0, stream>>>(e, q);
  return cudaGetLastError();
}

template <int V, bool kOperand>
cudaError_t quant_p(const Epi& e, const Quant& q, cudaStream_t stream) {
  switch (pool_inst(e)) {
    case 1: return quant<V, kOperand, 1>(e, q, stream);
    case 2: return quant<V, kOperand, 2>(e, q, stream);
    default: return quant<V, kOperand, 0>(e, q, stream);
  }
}

template <int V, bool kOperand, int P>
cudaError_t cluster_quant(const Epi& e, const Quant& q, int ncl, int smem,
                          cudaStream_t stream) {
  auto kernel = epi_cluster_kernel<V, kOperand, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (ncl > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(ncl, e.batch);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr{};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ncl;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, e, q);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int V, bool kOperand>
cudaError_t cluster_p(const Epi& e, const Quant& q, int ncl, int smem,
                      cudaStream_t stream) {
  switch (pool_inst(e)) {
    case 1: return cluster_quant<V, kOperand, 1>(e, q, ncl, smem, stream);
    case 2: return cluster_quant<V, kOperand, 2>(e, q, ncl, smem, stream);
    default: return cluster_quant<V, kOperand, 0>(e, q, ncl, smem, stream);
  }
}

// the cluster sizes epilogue_config chooses from (ops.py::CLUSTERS)
bool cluster_ok(int cluster) {
  return cluster == 4 || cluster == 8 || cluster == 16;
}

bool frame_ok(const Epi& e) {
  return e.batch >= 1 && e.n >= 1 && e.c >= 1 && e.w_out >= 1 &&
         e.n * e.p * e.p < (1LL << 31) && e.n % e.c == 0;
}

}  // namespace

// Pass 1 over the Epi at `epi` (a host struct, passed by value): `vec` 4
// takes 4 elements a unit (16-byte aligned frames, and c % 4 == 0 or no
// pool), else 1. y is stored at epi->y.
extern "C" int epilogue_reduce_launch(const void* epi, int vec,
                                      void* stream) {
  const Epi& e = *(const Epi*)epi;
  cudaStream_t s = (cudaStream_t)stream;
  if (e.nblk1 < 1 || e.y == nullptr || !frame_ok(e) || e.n % vec) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)(vec == 4 ? reduce_p<4>(e, s) : reduce_p<1>(e, s));
}

// Pass 2 over the same Epi and the Quant at `qt`: float32 codes where
// qt->codes is set, else the uint8 operand at qt->operand; of the stored
// y where epi->y is set (the pair), else of y pooled from epi->x (the
// fold).
extern "C" int epilogue_quant_launch(const void* epi, const void* qt, int vec,
                                     void* stream) {
  const Epi& e = *(const Epi*)epi;
  const Quant& q = *(const Quant*)qt;
  cudaStream_t s = (cudaStream_t)stream;
  if (q.nblk2 < 1 || !frame_ok(e) || e.n % vec ||
      (q.operand && (q.cp % 4 || (long long)q.hp * q.wp * q.cp >=
                                     (1LL << 31)))) {
    return (int)cudaErrorInvalidValue;
  }
  const bool op = q.operand != nullptr;
  if (vec == 4) return (int)(op ? quant_p<4, true>(e, q, s)
                                : quant_p<4, false>(e, q, s));
  return (int)(op ? quant_p<1, true>(e, q, s) : quant_p<1, false>(e, q, s));
}

// The whole call in one launch: `cluster` CTAs a frame (4, 8 or 16; 16
// is one of the card's non-portable sizes) with `smem_bytes` of dynamic shared
// memory each, both from ops.py::epilogue_config. Per-frame calibration,
// or one frame; no host max (q.amax null).
extern "C" int epilogue_cluster_launch(const void* epi, const void* qt,
                                       int vec, int cluster, int smem_bytes,
                                       void* stream) {
  const Epi& e = *(const Epi*)epi;
  const Quant& q = *(const Quant*)qt;
  cudaStream_t s = (cudaStream_t)stream;
  if (!frame_ok(e) || e.n % vec || !cluster_ok(cluster) ||
      q.amax != nullptr || (!q.per_frame && e.batch != 1) ||
      (q.operand && (q.cp % 4 || (long long)q.hp * q.wp * q.cp >=
                                     (1LL << 31)))) {
    return (int)cudaErrorInvalidValue;
  }
  const int gp = pixel_group(e.c, vec);
  const long long per = q.operand != nullptr
      ? ((e.n / e.c + gp - 1) / gp + cluster - 1) / cluster * gp * e.c
      : (e.n / vec + cluster - 1) / cluster * vec;
  if (smem_bytes < ((per + 3) / 4 * 4 + kClusterScratch) * 4) {
    return (int)cudaErrorInvalidValue;
  }
  const bool op = q.operand != nullptr;
  if (vec == 4) return (int)(op ? cluster_p<4, true>(e, q, cluster,
                                                     smem_bytes, s)
                                : cluster_p<4, false>(e, q, cluster,
                                                      smem_bytes, s));
  return (int)(op ? cluster_p<1, true>(e, q, cluster, smem_bytes, s)
                  : cluster_p<1, false>(e, q, cluster, smem_bytes, s));
}
