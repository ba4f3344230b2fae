// Strip conv: dense and depthwise k x k convs at any stride over a padded
// input, with the optional per-layer epilogue. Hopper (sm_90a) port of the
// TPU kernels in src/repro/kernels/conv_bank/strip_kernel.py:
//   conv_strip_launch    -> conv_strip_kernel (_conv_strip_kernel, _strip_dma,
//                           _tap_patch, _epilogue); the same entry, launched
//                           over a whole frame as one strip, stands in for
//                           kernel.py::conv_bank_kernel (_conv_kernel)
//   conv_strip_dw_launch -> conv_strip_depthwise_kernel (_conv_strip_dw_kernel)
//
// Contract (the TPU kernels'): x is [B, Hp, Wp, C_in], already padded, and
// the output is every row the padded input yields,
//   out[b, oh, ow, co] = sum_{di, dj, ci} x[b, oh*s + di, ow*s + dj, ci]
//                                          * w[di, dj, ci, co]
// (depthwise: ci = co, weights [k*k, C]), [B, (Hp-k)/s+1, (Wp-k)/s+1, C_out].
// With ws the epilogue follows, in the TPU kernel's association:
//   v = __fmul_rn(__fmul_rn(acc, act_scale), ws[co]); v = __fadd_rn(v, bias[co]);
//   v = act(v)                                (relu / abs / sign / none)
// Without ws the raw accumulate is written (the plan applies its own scales).
//
// The TPU geometry is not carried over. A TPU strip is 256 rows x 258
// columns x C_in f32 in VMEM; a block here has 227 KB of shared memory. So
// the caller's strips only fix the padded-rows contract, and each block
// takes a 16 x 16 tile of output pixels (one thread a pixel) for a block of
// CO_B output channels, stages the tile's input rows and columns plus the
// (k-1) halo in shared memory, C_in in chunks that fit, with the weights of
// the chunk beside them, and runs the tap loop out of shared memory.
//
// Numerics: the accumulate is float64 (staged values are converted once,
// at the copy into shared memory; every product of two float32 is exact in
// float64). For the integer codes x levels of the device path every partial
// sum is an exact integer far below 2^53, so the order of the taps cannot
// change a bit and the result equals the plain version's float64 tap loop
// (repro_torch/kernels/conv_bank/ref.py::conv_taps_int) rounded once to
// float32 -- bitwise, with no bound to check before the launch. Float
// inputs (the conv_bank op without a quantization spec) round differently
// from the plain version only through the order of float64 additions. The
// epilogue uses explicit _rn intrinsics, so nvcc cannot contract it into an
// FMA.
//
// What bounds it on an H100: bytes. The path's convs (1-4 input channels,
// k = 3 or 5, 256 x 256 frames) do 9-100 MACs for each 4-byte input read,
// below the card's ridge even at the float64 rate, so the least time is the
// input and output traffic over 3.35 TB/s. The design reads each input
// tile once per block from device memory (halo rows are re-read by the
// neighbouring tile, from L2), writes each output once, and keeps partial
// sums in registers. Tensor cores, TMA and a pipelined copy are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;                  // output tile: kTile x kTile pixels
constexpr int kThreads = kTile * kTile;    // one thread per output pixel
constexpr int kSmemDefault = 48 * 1024;    // without the opt-in attribute
constexpr int kSmemMax = 232448;           // H100: 227 KB a block can opt into

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1: return v > 0.0f ? v : 0.0f;                      // relu
    case 2: return fabsf(v);                                 // abs
    case 3: return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : v); // sign
    default: return v;                                       // none
  }
}

struct Geom {
  int hp, wp, c_in, c_out, k, stride;
  int n_rows, w_out;        // output rows and columns
  int tiles_w;              // output tiles across a row
  int ci_chunk;             // input channels staged at once (dense)
  float act_scale;
  int act;
};

// Shared memory, in doubles: the input tile as ci_chunk channel planes of
// rows_in x cols_in, then the chunk's weights as [k*k][ci_chunk][CO_B]
// (dense) or [k*k][CO_B] (depthwise: ci_chunk == CO_B).
template <int CO_B, bool kDepthwise>
__global__ void __launch_bounds__(kThreads)
conv_tile_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ ws, const float* __restrict__ bias,
                 float* __restrict__ out, const Geom g) {
  extern __shared__ double smem[];
  const int rows_in = (kTile - 1) * g.stride + g.k;
  const int cols_in = rows_in;
  const int plane = rows_in * cols_in;
  const int taps = g.k * g.k;
  double* xs = smem;
  double* wsm = smem + (size_t)g.ci_chunk * plane;

  const int th = blockIdx.x / g.tiles_w;
  const int tw = blockIdx.x % g.tiles_w;
  const int co0 = blockIdx.y * CO_B;
  const int b = blockIdx.z;
  const int ty = threadIdx.x / kTile;
  const int tx = threadIdx.x % kTile;
  const int oh = th * kTile + ty;
  const int ow = tw * kTile + tx;
  const int ih0 = th * kTile * g.stride;
  const int iw0 = tw * kTile * g.stride;
  const bool live = oh < g.n_rows && ow < g.w_out;

  double acc[CO_B];
#pragma unroll
  for (int j = 0; j < CO_B; ++j) acc[j] = 0.0;

  // depthwise: the input channels are this block's output channels
  const int ci_begin = kDepthwise ? co0 : 0;
  const int ci_end = kDepthwise ? min(co0 + CO_B, g.c_in) : g.c_in;
  for (int cb = ci_begin; cb < ci_end; cb += g.ci_chunk) {
    const int nc = min(g.ci_chunk, ci_end - cb);
    // input tile + halo; channels fastest for coalesced reads, planes in
    // shared memory so that neighbouring threads read neighbouring words;
    // pixels past the padded input are zero (they feed masked outputs
    // only), and so are a depthwise block's planes past the last channel
    const int planes = kDepthwise ? CO_B : nc;
    for (int i = threadIdx.x; i < planes * plane; i += kThreads) {
      const int c = i % planes;
      const int p = i / planes;
      const int gy = ih0 + p / cols_in;
      const int gx = iw0 + p % cols_in;
      float v = 0.0f;
      if (c < nc && gy < g.hp && gx < g.wp) {
        v = x[(((size_t)b * g.hp + gy) * g.wp + gx) * g.c_in + cb + c];
      }
      xs[c * plane + p] = (double)v;
    }
    if (kDepthwise) {
      for (int i = threadIdx.x; i < taps * CO_B; i += kThreads) {
        const int co = co0 + i % CO_B;
        wsm[i] = co < g.c_out ? (double)w[(i / CO_B) * g.c_out + co] : 0.0;
      }
    } else {
      for (int i = threadIdx.x; i < taps * nc * CO_B; i += kThreads) {
        const int co = co0 + i % CO_B;
        const int t = i / CO_B;
        const int c = t % nc;
        const int tap = t / nc;
        wsm[i] = co < g.c_out
                     ? (double)w[((size_t)tap * g.c_in + cb + c) * g.c_out + co]
                     : 0.0;
      }
    }
    __syncthreads();
    if (live) {
      for (int di = 0; di < g.k; ++di) {
        for (int dj = 0; dj < g.k; ++dj) {
          const int off = (ty * g.stride + di) * cols_in + tx * g.stride + dj;
          const int tap = di * g.k + dj;
          if (kDepthwise) {
#pragma unroll
            for (int j = 0; j < CO_B; ++j) {
              acc[j] = fma(xs[j * plane + off], wsm[tap * CO_B + j], acc[j]);
            }
          } else {
            const double* wt = wsm + (size_t)tap * nc * CO_B;
            for (int c = 0; c < nc; ++c) {
              const double xv = xs[c * plane + off];
#pragma unroll
              for (int j = 0; j < CO_B; ++j) {
                acc[j] = fma(xv, wt[c * CO_B + j], acc[j]);
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }

  if (!live) return;
  float* o = out + (((size_t)b * g.n_rows + oh) * g.w_out + ow) * g.c_out;
#pragma unroll
  for (int j = 0; j < CO_B; ++j) {
    const int co = co0 + j;
    if (co >= g.c_out) break;
    float v = __double2float_rn(acc[j]);
    if (ws != nullptr) {
      v = __fmul_rn(__fmul_rn(v, g.act_scale), ws[co]);
      if (bias != nullptr) v = __fadd_rn(v, bias[co]);
      v = activate(v, g.act);
    }
    o[co] = v;
  }
}

template <int CO_B, bool kDepthwise>
int launch_tiles(const void* x, const void* w, const void* ws,
                 const void* bias, void* out, int batch, Geom g,
                 cudaStream_t stream) {
  const int rows_in = (kTile - 1) * g.stride + g.k;
  const size_t plane = (size_t)rows_in * rows_in;
  const size_t taps = (size_t)g.k * g.k;
  size_t bytes;
  if (kDepthwise) {
    g.ci_chunk = CO_B;
    bytes = (CO_B * plane + taps * CO_B) * sizeof(double);
  } else {
    // as many input channels a chunk as fit the default 48 KB, at least one
    const size_t per_channel = (plane + taps * CO_B) * sizeof(double);
    size_t chunk = kSmemDefault / per_channel;
    if (chunk < 1) chunk = 1;
    if (chunk > (size_t)g.c_in) chunk = g.c_in;
    g.ci_chunk = (int)chunk;
    bytes = chunk * per_channel;
  }
  if (bytes > (size_t)kSmemMax) return (int)cudaErrorInvalidConfiguration;
  if (bytes > (size_t)kSmemDefault) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_tile_kernel<CO_B, kDepthwise>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  g.tiles_w = (g.w_out + kTile - 1) / kTile;
  const int tiles_h = (g.n_rows + kTile - 1) / kTile;
  const dim3 grid(tiles_h * g.tiles_w, (g.c_out + CO_B - 1) / CO_B, batch);
  conv_tile_kernel<CO_B, kDepthwise><<<grid, kThreads, bytes, stream>>>(
      (const float*)x, (const float*)w, (const float*)ws, (const float*)bias,
      (float*)out, g);
  return (int)cudaGetLastError();
}

// CO_B: the smallest of 1, 4, 16 that covers the output (depthwise: all)
// channels, so a 1-channel conv does no idle channel work
template <bool kDepthwise>
int launch(const void* x, const void* w, const void* ws, const void* bias,
           void* out, int batch, int hp, int wp, int c_in, int c_out, int k,
           int stride, float act_scale, int act, void* stream) {
  Geom g{};
  g.hp = hp;
  g.wp = wp;
  g.c_in = c_in;
  g.c_out = c_out;
  g.k = k;
  g.stride = stride;
  g.n_rows = (hp - k) / stride + 1;
  g.w_out = (wp - k) / stride + 1;
  g.act_scale = act_scale;
  g.act = act;
  cudaStream_t s = (cudaStream_t)stream;
  if (c_out <= 1) return launch_tiles<1, kDepthwise>(x, w, ws, bias, out, batch, g, s);
  if (c_out <= 4) return launch_tiles<4, kDepthwise>(x, w, ws, bias, out, batch, g, s);
  return launch_tiles<16, kDepthwise>(x, w, ws, bias, out, batch, g, s);
}

}  // namespace

// x [B, Hp, Wp, C_in], w [k, k, C_in, C_out] (float32, contiguous);
// ws, bias: [C_out] or null; out [B, (Hp-k)/stride+1, (Wp-k)/stride+1, C_out]
extern "C" int conv_strip_launch(const void* x, const void* w, const void* ws,
                                 const void* bias, void* out, int batch,
                                 int hp, int wp, int c_in, int c_out, int k,
                                 int stride, float act_scale, int act,
                                 void* stream) {
  return launch<false>(x, w, ws, bias, out, batch, hp, wp, c_in, c_out, k,
                       stride, act_scale, act, stream);
}

// depthwise, multiplier 1: w_taps [k*k, C], c_in == c_out == C
extern "C" int conv_strip_dw_launch(const void* x, const void* w_taps,
                                    const void* ws, const void* bias,
                                    void* out, int batch, int hp, int wp,
                                    int c, int k, int stride, float act_scale,
                                    int act, void* stream) {
  return launch<true>(x, w_taps, ws, bias, out, batch, hp, wp, c, c, k,
                      stride, act_scale, act, stream);
}
