// The int8 strip conv's store, shared by its kernels: the mma.sync ones
// (conv_strip.cu: conv_igemm_kernel, conv_igemm_fold_kernel) and the wgmma
// one (conv_strip_wgmma.cu: conv_igemm_wgmma_kernel). Each thread holds
// m16n8 C fragments of int32 sums (mma.sync's, or wgmma's m64nN
// accumulator, the same fragment N / 8 times) and stores them through a
// slot map of its kernel's own: the strip association's value
// (epilogue_int), or the plan's epilogue folded into the store (the fold:
// y = act(acc * (act_scale * ws) + bias) clamped at 0, unpooled, and each
// work item's max of y into partials[item]). Included once per .cu;
// kernels/_build.py hashes it into both libraries' names.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemMax = 232448;   // H100: 227 KB a block can opt into
constexpr int kIgFoldRed = 8;      // the fold's warp maxima (8 warps a CTA
                                   // at most)

// the activation (1 relu, 2 abs, 3 sign, else none) by selects, no switch:
// a jump table among the wgmma form's unrolled stores put its accumulators
// in local memory
__device__ __forceinline__ float activate_sel(float v, int act) {
  const float relu = v > 0.0f ? v : 0.0f;
  const float sign = v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : v);
  return act == 1 ? relu : act == 2 ? fabsf(v) : act == 3 ? sign : v;
}

// dequant -> bias -> act on an exact int32 accumulate, in the strip
// kernels' association (conv_strip.cu's float64 epilogue())
__device__ __forceinline__ float epilogue_int(int acc, const float* ws,
                                              const float* bias, int co,
                                              float act_scale, int act) {
  float v = __int2float_rn(acc);
  if (ws != nullptr) {
    v = __fmul_rn(__fmul_rn(v, act_scale), ws[co]);
    if (bias != nullptr) v = __fadd_rn(v, bias[co]);
    v = activate_sel(v, act);
  }
  return v;
}

// the plan's epilogue's max (csrc/epilogue.cu): a NaN is kept, as torch's
// clamp and max pool keep it
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// an int8 launch's geometry, its strip epilogue and its fold
struct Igemm {
  int hp, wp, c_in, c_out, k, stride;  // c_in a multiple of 16, or 4
  int kf;                   // folded: K = k*k*4 rounded up to 32; else 0
  int n_rows, w_out;        // output rows and columns
  int th, tw;               // a CTA's tile: th output rows x tw columns
  int tiles_w, tiles;       // tiles across a row, tiles a frame
  int n_blocks;             // output-channel blocks
  int rows_in, cols_in;     // the staged input patch, halo included
  int patch_bytes, stage_bytes;  // wgmma: patch_bytes is a plane's pitch
  // the wgmma form: input channels a stage, a weight plane's bytes (k*k x
  // bn rows of 16 channels), one TMA box of the patch (a plane unpadded)
  int ch, wplane_bytes, patch_box, stages;
  int batch;                // frames: the wgmma form walks every work item
  float act_scale;
  int act;
  // the fold (kFold): the plan's epilogue up to its pool, in its
  // association, and each work item's max into partials[item]
  const float* scale;       // act_scale: scale_n (1 or batch) values
  float* partials;          // [batch, tiles * n_blocks]
  int scale_n, ws_n, bias_n;  // 1 or batch; 1 or c_out; 1 or c_out
  int red_offset;           // bytes of dynamic shared memory before the
                            // fold's kIgFoldRed floats of warp maxima
};

// A work item's frame, first output pixel and first output channel: the
// items (a CTA's blockIdx.x, or the wgmma form's walk) take the channel
// blocks fastest, so neighbouring ones stage the same input tile while it
// is in L2
struct IgTile {
  int b, oh0, ow0, n0;
  __device__ __forceinline__ IgTile(const Igemm& g, int bn, int item) {
    const int nb = item % g.n_blocks;
    const int mtile = item / g.n_blocks;
    b = mtile / g.tiles;
    const int t = mtile - b * g.tiles;
    const int th_i = t / g.tiles_w;
    oh0 = th_i * g.th;
    ow0 = (t - th_i * g.tiles_w) * g.tw;
    n0 = nb * bn;
  }
};

// c0, c1 at the fragment's row lane / 4, channels 2 * (lane & 3) and + 1;
// c2, c3 at its row lane / 4 + 8: a lane writes 8 contiguous bytes where
// c_out is even, four lanes one 32-byte sector, and a pixel's channels in
// consecutive stores. `slot(i, h, tr, tc)` gives the tile row and column
// of m fragment i's row lane / 4 + 8 * h, false for a slot past the tile;
// `value.two(a0, a1, j, co)` is what goes out for the accumulates of
// channels co and co + 1 (n8 fragment j's), `value.one(a, j, co)` for
// channel co alone (the last of an odd c_out).
template <int MT, int NT, int WN, typename Slot, typename Value>
__device__ __forceinline__ void store_values(
    const int (&acc)[MT][NT][4], float* __restrict__ out, const Igemm& g,
    int b, int oh0, int ow0, int n0, int wn, int lane, const Slot& slot,
    Value& value) {
  const bool pairs = (g.c_out & 1) == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int tr, tc;
      if (!slot(i, h, tr, tc)) continue;
      const int oh = oh0 + tr;
      const int ow = ow0 + tc;
      if (oh >= g.n_rows || ow >= g.w_out) continue;
      float* o = out + (((size_t)b * g.n_rows + oh) * g.w_out + ow) *
                           g.c_out;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int co = n0 + (wn * NT + j) * 8 + (lane & 3) * 2;
        if (co >= g.c_out) continue;
        if (co + 1 >= g.c_out) {
          o[co] = value.one(acc[i][j][2 * h], j, co);
          continue;
        }
        const float2 v = value.two(acc[i][j][2 * h], acc[i][j][2 * h + 1], j,
                                   co);
        if (pairs) {
          *(float2*)(o + co) = v;
        } else {
          o[co] = v.x;
          o[co + 1] = v.y;
        }
      }
    }
  }
}

// the strip association's value (epilogue_int): the raw accumulate, or
// acc * act_scale * ws -> + bias -> the activation
struct StripValue {
  const float* ws;
  const float* bias;
  float act_scale;
  int act;
  __device__ __forceinline__ float one(int a, int, int co) const {
    return epilogue_int(a, ws, bias, co, act_scale, act);
  }
  __device__ __forceinline__ float2 two(int a0, int a1, int j,
                                        int co) const {
    return make_float2(one(a0, j, co), one(a1, j, co + 1));
  }
};

// the fold's value, for one activation ACT (fused::ACTS: 0 none, 1 relu, 2
// abs, 3 sign): the plan's y clamped at 0 -- none and relu both
// (v > 0 || v != v) ? v : 0, abs |v|, sign v > 0 (sign(NaN) is 0) -- from
// the lane's channels' act_scale * ws and bias, made once (2 NT floats
// each: the wgmma form's consumers hold them beside their accumulators),
// and the running max of y and whether a NaN was seen
template <int NT, int ACT>
struct FoldValue {
  const float* bias;
  float wsc[NT][2], bv[NT][2];
  float m = 0.0f;                // every y is >= 0
  bool nan = false;
  __device__ __forceinline__ FoldValue(const Igemm& g, const float* ws,
                                       const float* bias_, int b, int n0,
                                       int wn, int lane)
      : bias(bias_) {
    const float sb = __ldg(g.scale + (g.scale_n > 1 ? b : 0));
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int co = min(n0 + (wn * NT + j) * 8 + (lane & 3) * 2 + t,
                           g.c_out - 1);
        wsc[j][t] = __fmul_rn(sb, __ldg(ws + (g.ws_n > 1 ? co : 0)));
        bv[j][t] = bias != nullptr ? __ldg(bias + (g.bias_n > 1 ? co : 0))
                                   : 0.0f;
      }
    }
  }
  __device__ __forceinline__ float y(int a, int j, int t) {
    float v = __fmul_rn(__int2float_rn(a), wsc[j][t]);
    if (bias != nullptr) v = __fadd_rn(v, bv[j][t]);
    float r;
    if constexpr (ACT == 2) {
      r = fabsf(v);
    } else if constexpr (ACT == 3) {
      r = v > 0.0f ? 1.0f : 0.0f;
    } else {
      r = (v > 0.0f || v != v) ? v : 0.0f;
    }
    m = fmaxf(m, r);
    nan |= r != r;
    return r;
  }
  __device__ __forceinline__ float one(int a, int j, int) {
    return y(a, j, 0);
  }
  __device__ __forceinline__ float2 two(int a0, int a1, int j, int) {
    const float y0 = y(a0, j, 0);
    return make_float2(y0, y(a1, j, 1));
  }
};

// the fold's store: y out, the item's max of y into partials[item]. The
// `threads` storing threads (warps 0 .. threads / 32 - 1) meet on named
// barrier 1 (a producer warpgroup past them takes no part), and again once
// the maxima are read, so the next item's may overwrite them.
template <int MT, int NT, int WN, int ACT, typename Slot>
__device__ __forceinline__ void store_fold(
    const int (&acc)[MT][NT][4], const float* __restrict__ ws,
    const float* __restrict__ bias, float* __restrict__ out, const Igemm& g,
    int b, int oh0, int ow0, int n0, int wn, int lane, const Slot& slot,
    float* red, int threads, int item) {
  FoldValue<NT, ACT> value(g, ws, bias, b, n0, wn, lane);
  store_values<MT, NT, WN>(acc, out, g, b, oh0, ow0, n0, wn, lane, slot,
                           value);
  // a NaN anywhere makes the max NaN, as nan_max's chain would
  float m = value.nan ? __int_as_float(0x7fffffff) : value.m;
  for (int off = 16; off > 0; off >>= 1) {
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  if (lane == 0) red[threadIdx.x >> 5] = m;
  asm volatile("bar.sync 1, %0;\n" :: "r"(threads) : "memory");
  if (threadIdx.x == 0) {
    const int warps = threads >> 5;
    float r = red[0];
    for (int i = 1; i < warps; ++i) r = nan_max(r, red[i]);
    g.partials[item] = r;
  }
  asm volatile("bar.sync 1, %0;\n" :: "r"(threads) : "memory");
}

// A work item's output: epilogue_int's strip association (acc * act_scale
// * ws, the conv_bank op's and the ws API's); or, kFold, the plan's
// (csrc/epilogue.cu's pooled()): v = __fmul_rn(__int2float_rn(acc),
// __fmul_rn(scale[b], ws[co])), __fadd_rn(v, bias[co]), the activation,
// and y = max(v, 0), unpooled; the item's max of y goes to partials[item]
// (a work item -- a CTA of the mma.sync kernels -- is one frame's, and a
// frame's items are consecutive: partials[b][item within the frame]). The
// max of the unpooled clamped y equals the max of the max-pooled ones --
// the windows tile the frame, max is exact in any order, and a NaN
// anywhere makes both NaN -- so epilogue.cu's pass 2 takes these partials
// as its pass 1's and max-pools this y as it writes the codes.
template <int MT, int NT, int WN, bool kFold, typename Slot>
__device__ __forceinline__ void store_tile(
    const int (&acc)[MT][NT][4], const float* __restrict__ ws,
    const float* __restrict__ bias, float* __restrict__ out, const Igemm& g,
    int b, int oh0, int ow0, int n0, int wn, int lane, const Slot& slot,
    float* red, int threads, int item) {
  if constexpr (kFold) {
    switch (g.act) {
      case 2:
        store_fold<MT, NT, WN, 2>(acc, ws, bias, out, g, b, oh0, ow0, n0, wn,
                                  lane, slot, red, threads, item);
        return;
      case 3:
        store_fold<MT, NT, WN, 3>(acc, ws, bias, out, g, b, oh0, ow0, n0, wn,
                                  lane, slot, red, threads, item);
        return;
      default:
        store_fold<MT, NT, WN, 1>(acc, ws, bias, out, g, b, oh0, ow0, n0, wn,
                                  lane, slot, red, threads, item);
        return;
    }
  } else {
    StripValue value{ws, bias, g.act_scale, g.act};
    store_values<MT, NT, WN>(acc, out, g, b, oh0, ow0, n0, wn, lane, slot,
                             value);
  }
}

// one int8 launch: its operands (w the mma.sync forms' levels; null in the
// wgmma form's, which reads them through a tensor map), geometry and stream
struct IgLaunch {
  const void* x;
  const void* w;
  const void* ws;
  const void* bias;
  void* out;
  int batch, stages;
  Igemm g;
  cudaStream_t stream;
};

// the fold's arguments as a launch entry takes them: device pointers for
// ws, act_scale and the partials, one or C_out biases (or none), one or B
// scales, one or C_out ws, act 0..3
inline bool fold_args_ok(const void* ws, const void* bias,
                         const void* partials, const void* scale, int scale_n,
                         int ws_n, int bias_n, int batch, int c_out,
                         int act) {
  return ws != nullptr && scale != nullptr && partials != nullptr &&
         (scale_n == 1 || scale_n == batch) && (ws_n == 1 || ws_n == c_out) &&
         (bias == nullptr || bias_n == 1 || bias_n == c_out) && act >= 0 &&
         act <= 3;
}

inline void set_fold(Igemm* g, int act, const void* scale, void* partials,
                     int scale_n, int ws_n, int bias_n) {
  g->act = act;
  g->scale = (const float*)scale;
  g->partials = (float*)partials;
  g->scale_n = scale_n;
  g->ws_n = ws_n;
  g->bias_n = bias_n;
}

}  // namespace
