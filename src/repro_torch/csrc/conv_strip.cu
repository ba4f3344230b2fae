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
// the caller's strips only fix the padded-rows contract, and each CTA takes
// a tile of output pixels for a block of CO_B output channels, staging the
// tile's input plus the (k-1) halo in shared memory, C_in in chunks.
//
// Dense (conv_dense_kernel<K, RUN, CO_B>): what bounds it on an H100 (the
// SXM data sheet's rates at its 700 W limit). The path's convs (1-4 input
// channels, k = 3 or 5, 256 x 256 frames at batch 8) do 9-100 MACs per
// 4-byte input, so bytes bound them (1.3 and 3.2 us at 3.35 TB/s); the
// conv_bank op (16 -> 32 channels, k <= 7, 32 x 32 frames) is bound by its
// float64 FMAs instead (12 us for k = 7 at 17 TFMA/s). The first design
// (16 x 16 tiles, one pixel
// a thread, scalar loads widened to doubles, one buffer) paid a fixed cost
// per block for little work, re-read a 1.56x halo at k = 5, and gave the
// conv_bank op 64 blocks. Now:
//   * each thread computes a run of RUN output rows of one column for CO_B
//     channels; lanes take neighbouring columns, so the tile is 32 or 64
//     wide (halo 1.2x at 64 x 32, k = 5) and every shared-memory read is a
//     conflict-free row of 32 floats. A thread converts the RUN + k - 1
//     inputs of a tap column to float64 once and slides them past the k
//     taps of that column;
//   * staging copies float32 (codes are exact in it) with cp.async: 16
//     bytes at a time along a 1-channel row when the rows are aligned, else
//     4 bytes with hardware zero fill; nested loops, no runtime division;
//     C_in chunks are double-buffered, so chunk i+1 is in flight while
//     chunk i is summed; the weights come in by cp.async too, as float32,
//     and are widened to float64 in shared memory once they land (one
//     synchronous load per tap made the CTA wait on latency k*k times);
//   * k = 3, 5, 7 at stride 1 are template instantiations (K), every other
//     k and stride runs the K = 0 instantiation with runtime loops;
//   * the tile, RUN, CO_B and the chunk come from the wrapper's plain
//     Python function (kernels/conv_bank/strip.py::strip_config), which
//     splits the output channels over more CTAs until the card's 132 SMs
//     each get one where the shape allows it.
// Depthwise (conv_dw_kernel<K, RUN, CB>): the path's two calls (denoise_gauss
// k = 5 and denoise_box k = 3, 3 channels, 8 x 256 x 256) do 9-25 MACs per
// 4-byte input, so bytes bound them (3.8 us each at 3.35 TB/s). The first
// design (16 x 16 tiles, one thread a pixel, 4 channels a block for 3, the
// tile widened to float64 in shared memory by scalar loads with a division
// per element) re-read a 1.56x halo and read ~800 B of shared memory per
// output pixel at k = 5. Now, as the dense kernel:
//   * each thread computes a run of RUN output rows of one column for all
//     CB channels of its block (CB = C for 1 and 3 channels, so none
//     idles; 4-channel blocks otherwise), from a float64 window per tap
//     column and channel converted once in registers;
//   * tiles are 32 or 64 columns wide (64 x 16 on the path: halo 1.33x at
//     k = 5), one tile a CTA, all CTAs of the path's calls in one wave;
//   * the tile is staged as float32, channel-interleaved as in device
//     memory, so a row segment of a C-channel input is one run of floats:
//     cp.async copies it 16 bytes at a time from its first 16-byte aligned
//     float (each staged row is shifted by its source's phase so the
//     shared words are aligned too), 4 bytes with zero fill for the rest;
//     lanes read neighbouring columns at a stride of CB floats, which for
//     an odd CB such as 3 hits 32 different banks;
//   * the outputs go back through shared memory and out a tile row at a
//     time, 16 bytes a store where aligned;
//   * K = 3, 5, 7 at stride 1 are instantiations with RUN = 8; every other
//     k and stride runs K = 0 with RUN = 4 and runtime loops;
//   * the tile comes from the wrapper's plain Python function
//     (kernels/conv_bank/strip.py::dw_config).
// All CTAs of a path call run in one wave, so the copies in, the tap loop
// and the stores out do not overlap. Three versions that walked several
// tiles a CTA with the next one in flight (widened once to float64 in
// shared memory; float32 slots; two loader warps beside four compute
// warps) were all bitwise and all slower on the path's calls (PERF.md,
// Findings).

// Numerics: the accumulate is float64. Every product of two float32 is
// exact in float64, and for the integer codes x levels of the device path
// every partial sum is an exact integer far below 2^53, so the order of
// the taps cannot change a bit and the result equals the plain version's
// float64 tap loop (repro_torch/kernels/conv_bank/ref.py::conv_taps_int)
// rounded once to float32 -- bitwise, with no bound to check before the
// launch. Float inputs (the conv_bank op without a quantization spec)
// round differently from the plain version only through the order of
// float64 additions. The epilogue uses explicit _rn intrinsics, so nvcc
// cannot contract it into an FMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemDefault = 48 * 1024;    // without the opt-in attribute
constexpr int kSmemMax = 232448;           // H100: 227 KB a block can opt into
constexpr int kDenseThreads = 128;         // most threads of a dense CTA
constexpr int kDwThreads = 128;            // most threads of a depthwise CTA
constexpr int kDwFastRun = 8;              // depthwise rows a thread, k 3/5/7
constexpr int kDwRun = 4;                  // the same, any other k or stride

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1: return v > 0.0f ? v : 0.0f;                      // relu
    case 2: return fabsf(v);                                 // abs
    case 3: return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : v); // sign
    default: return v;                                       // none
  }
}

// dequant -> bias -> act when ws is given; the raw accumulate otherwise
__device__ __forceinline__ float epilogue(double acc, const float* ws,
                                          const float* bias, int co,
                                          float act_scale, int act) {
  float v = __double2float_rn(acc);
  if (ws != nullptr) {
    v = __fmul_rn(__fmul_rn(v, act_scale), ws[co]);
    if (bias != nullptr) v = __fadd_rn(v, bias[co]);
    v = activate(v, act);
  }
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem));
}

// 4 bytes, or 4 zero bytes when `valid` is false (src-size 0: nothing read)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// ---------------------------------------------------------------------------
// dense
// ---------------------------------------------------------------------------

struct Dense {
  int hp, wp, c_in, c_out, k, stride;
  int n_rows, w_out;        // output rows and columns
  int tiles_w;              // output tiles across a row
  int cc;                   // input channels a stage holds
  int rows_in, cols_ld;     // a stage's input plane: rows x row length
  int x_bytes, wf_bytes;    // a stage: input planes, float32 weights,
  int stage_bytes;          // then the weights widened to float64
  int vec;                  // 1-channel rows copy 16 bytes at a time
  float act_scale;
  int act;
};

// blockDim = (TX, TYT): lane tx owns output column tw*TX + tx, thread row
// ty owns output rows th*TYT*RUN + ty*RUN .. + RUN - 1, for output channels
// blockIdx.y*CO_B ... Stage layout: float xs[cc][rows_in][cols_ld], float
// wf[k*k][cc][CO_B] as copied, double wd[k*k][cc][CO_B] widened from wf.
template <int K, int RUN, int CO_B>
__global__ void __launch_bounds__(kDenseThreads)
conv_dense_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ ws, const float* __restrict__ bias,
                  float* __restrict__ out, const Dense g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = K > 0 ? K : g.k;
  const int s = K > 0 ? 1 : g.stride;
  const int taps = k * k;
  const int TX = blockDim.x;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int nthr = TX * blockDim.y;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (nthr + 31) >> 5;
  const int th = blockIdx.x / g.tiles_w;
  const int tw = blockIdx.x - th * g.tiles_w;
  const int TH = blockDim.y * RUN;
  const int co0 = blockIdx.y * CO_B;
  const int b = blockIdx.z;
  const int ih0 = th * TH * s;
  const int iw0 = tw * TX * s;
  const int oh0 = th * TH + ty * RUN;
  const int ow = tw * TX + tx;
  const int plane = g.rows_in * g.cols_ld;
  const int n_chunks = (g.c_in + g.cc - 1) / g.cc;

  auto stage = [&](int slot, int cb) {
    float* xs = (float*)(smem + (size_t)slot * g.stage_bytes);
    float* wf = (float*)(smem + (size_t)slot * g.stage_bytes + g.x_bytes);
    const int nc = min(g.cc, g.c_in - cb);
    if (g.vec) {               // c_in == 1: rows of floats, 16-byte aligned
      const int quads = g.cols_ld >> 2;
      for (int row = warp; row < g.rows_in; row += nwarps) {
        const int gy = ih0 + row;
        const float* src = x + ((size_t)b * g.hp + gy) * g.wp + iw0;
        float* dst = xs + row * g.cols_ld;
        for (int q = lane; q < quads; q += 32) {
          const int gx = iw0 + 4 * q;
          if (gy < g.hp && gx + 4 <= g.wp) {
            cp_async16(dst + 4 * q, src + 4 * q);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const bool ok = gy < g.hp && gx + e < g.wp;
              cp_async4(dst + 4 * q + e, ok ? src + 4 * q + e : x, ok);
            }
          }
        }
      }
    } else {
      for (int c = 0; c < nc; ++c) {
        for (int row = warp; row < g.rows_in; row += nwarps) {
          const int gy = ih0 + row;
          const float* src = x + (((size_t)b * g.hp + gy) * g.wp + iw0) *
                                     g.c_in + cb + c;
          float* dst = xs + c * plane + row * g.cols_ld;
          for (int col = lane; col < g.cols_ld; col += 32) {
            const bool ok = gy < g.hp && iw0 + col < g.wp;
            cp_async4(dst + col, ok ? src + (size_t)col * g.c_in : x, ok);
          }
        }
      }
    }
    // the chunk's weights as float32, zero past c_out; widened to float64
    // once they have landed (widen below)
    for (int tap = 0; tap < taps; ++tap) {
      for (int i = tid; i < nc * CO_B; i += nthr) {
        const int c = i / CO_B;
        const int co = co0 + i - c * CO_B;
        const bool ok = co < g.c_out;
        cp_async4(wf + tap * g.cc * CO_B + i,
                  ok ? w + ((size_t)tap * g.c_in + cb + c) * g.c_out + co : w,
                  ok);
      }
    }
  };
  auto widen = [&](int slot, int nc) {
    const float* wf = (const float*)(smem + (size_t)slot * g.stage_bytes +
                                     g.x_bytes);
    double* wd = (double*)(smem + (size_t)slot * g.stage_bytes + g.x_bytes +
                           g.wf_bytes);
    for (int tap = 0; tap < taps; ++tap) {
      for (int i = tid; i < nc * CO_B; i += nthr) {
        wd[tap * g.cc * CO_B + i] = (double)wf[tap * g.cc * CO_B + i];
      }
    }
  };

  double acc[RUN][CO_B];
#pragma unroll
  for (int r = 0; r < RUN; ++r)
#pragma unroll
    for (int j = 0; j < CO_B; ++j) acc[r][j] = 0.0;

  stage(0, 0);
  cp_async_commit();
  for (int ci = 0; ci < n_chunks; ++ci) {
    if (ci + 1 < n_chunks) stage((ci + 1) & 1, (ci + 1) * g.cc);
    cp_async_commit();
    cp_async_wait<1>();        // chunk ci has landed
    __syncthreads();
    const int slot = ci & 1;
    const int nc = min(g.cc, g.c_in - ci * g.cc);
    widen(slot, nc);
    __syncthreads();
    const float* xs = (const float*)(smem + (size_t)slot * g.stage_bytes);
    const double* wd = (const double*)(smem + (size_t)slot * g.stage_bytes +
                                       g.x_bytes + g.wf_bytes);
    for (int c = 0; c < nc; ++c) {
      const float* base = xs + c * plane + (ty * RUN * s) * g.cols_ld + tx * s;
      if (K > 0) {
        // stride 1: the RUN + K - 1 inputs of tap column dj, converted once,
        // serve all K taps of that column
#pragma unroll
        for (int dj = 0; dj < K; ++dj) {
          double win[RUN + K - 1];
#pragma unroll
          for (int i = 0; i < RUN + K - 1; ++i) {
            win[i] = (double)base[i * g.cols_ld + dj];
          }
#pragma unroll
          for (int di = 0; di < K; ++di) {
            const double* wt = wd + ((di * K + dj) * g.cc + c) * CO_B;
#pragma unroll
            for (int j = 0; j < CO_B; ++j) {
              const double wv = wt[j];
#pragma unroll
              for (int r = 0; r < RUN; ++r) {
                acc[r][j] = fma(win[r + di], wv, acc[r][j]);
              }
            }
          }
        }
      } else {
        for (int di = 0; di < k; ++di) {
          for (int dj = 0; dj < k; ++dj) {
            const double* wt = wd + ((di * k + dj) * g.cc + c) * CO_B;
            double xv[RUN];
#pragma unroll
            for (int r = 0; r < RUN; ++r) {
              xv[r] = (double)base[(r * s + di) * g.cols_ld + dj];
            }
#pragma unroll
            for (int j = 0; j < CO_B; ++j) {
              const double wv = wt[j];
#pragma unroll
              for (int r = 0; r < RUN; ++r) {
                acc[r][j] = fma(xv[r], wv, acc[r][j]);
              }
            }
          }
        }
      }
    }
    __syncthreads();           // slot free for chunk ci + 2
  }

  if (ow >= g.w_out) return;
#pragma unroll
  for (int r = 0; r < RUN; ++r) {
    const int oh = oh0 + r;
    if (oh >= g.n_rows) break;
    float* o = out + (((size_t)b * g.n_rows + oh) * g.w_out + ow) * g.c_out;
#pragma unroll
    for (int j = 0; j < CO_B; ++j) {
      const int co = co0 + j;
      if (co >= g.c_out) break;
      o[co] = epilogue(acc[r][j], ws, bias, co, g.act_scale, g.act);
    }
  }
}

struct DenseLaunch {
  const void* x;
  const void* w;
  const void* ws;
  const void* bias;
  void* out;
  int batch, tx, tyt;
  Dense g;
  cudaStream_t stream;
};

template <int K, int RUN, int CO_B>
int launch_dense_k(const DenseLaunch& l) {
  const Dense& g = l.g;
  const int stages = g.c_in > g.cc ? 2 : 1;
  const size_t bytes = (size_t)stages * g.stage_bytes;
  if (bytes > (size_t)kSmemMax) return (int)cudaErrorInvalidConfiguration;
  if (bytes > (size_t)kSmemDefault) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_dense_kernel<K, RUN, CO_B>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int th = l.tyt * RUN;
  const dim3 grid((g.n_rows + th - 1) / th * g.tiles_w,
                  (g.c_out + CO_B - 1) / CO_B, l.batch);
  conv_dense_kernel<K, RUN, CO_B><<<grid, dim3(l.tx, l.tyt), bytes,
                                    l.stream>>>(
      (const float*)l.x, (const float*)l.w, (const float*)l.ws,
      (const float*)l.bias, (float*)l.out, g);
  return (int)cudaGetLastError();
}

template <int RUN, int CO_B>
int launch_dense_run(const DenseLaunch& l) {
  if (l.g.stride == 1 && l.g.k == 3) return launch_dense_k<3, RUN, CO_B>(l);
  if (l.g.stride == 1 && l.g.k == 5) return launch_dense_k<5, RUN, CO_B>(l);
  if (l.g.stride == 1 && l.g.k == 7) return launch_dense_k<7, RUN, CO_B>(l);
  return launch_dense_k<0, RUN, CO_B>(l);
}

// ---------------------------------------------------------------------------
// depthwise
// ---------------------------------------------------------------------------

struct Dw {
  int hp, wp, c, k, stride;
  int n_rows, w_out;        // output rows and columns
  int tiles_w;              // output tiles across a row
  int rows_in, cols_in;     // the staged input tile, halo included
  int ld;                   // floats a staged row takes
  int w_offset;             // bytes: the float64 taps after the rows
  int contiguous;           // CB == c: a row segment is one run of floats
  float act_scale;
  int act;
};

// blockDim = (TX, TYT): lane tx owns output column tw*TX + tx, thread row
// ty owns output rows th*TYT*RUN + ty*RUN .. + RUN - 1, for the channels
// blockIdx.y*CB .. + CB - 1. Shared memory: the input tile as float
// xs[rows_in][ld], channel-interleaved as in device memory (element e =
// col*CB + c of row r at xs[r*ld + rph[r] + e], where the row's phase
// rph[r] puts its 16-byte aligned source floats on 16-byte aligned shared
// words), int rph[rows_in], then double wd[k*k][CB]. The tile's outputs
// pass through xs on their way out.
template <int K, int RUN, int CB>
__global__ void __launch_bounds__(kDwThreads)
conv_dw_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ ws, const float* __restrict__ bias,
               float* __restrict__ out, const Dw g) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = (float*)smem;
  int* rph = (int*)(xs + g.rows_in * g.ld);
  double* wd = (double*)(smem + g.w_offset);
  const int k = K > 0 ? K : g.k;
  const int s = K > 0 ? 1 : g.stride;
  const int TX = blockDim.x;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int nthr = TX * blockDim.y;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (nthr + 31) >> 5;
  const int th = blockIdx.x / g.tiles_w;
  const int tw = blockIdx.x - th * g.tiles_w;
  const int TH = blockDim.y * RUN;
  const int c0 = blockIdx.y * CB;
  const int b = blockIdx.z;
  const int ih0 = th * TH * s;
  const int iw0 = tw * TX * s;
  const int n_el = g.cols_in * CB;

  // the tile, a warp a row: a contiguous row goes 16 bytes at a time from
  // its first 16-byte aligned float, 4 bytes (zero past the input) for the
  // head, the tail and anything past the padded input; a channel block of
  // a wider input goes 4 bytes a float
  for (int row = warp; row < g.rows_in; row += nwarps) {
    const int gy = ih0 + row;
    float* dst = xs + row * g.ld;
    if (g.contiguous) {
      const float* src = x + (((size_t)b * g.hp + min(gy, g.hp - 1)) *
                              g.wp + iw0) * CB;
      const int nv = gy < g.hp ? min(g.cols_in, g.wp - iw0) * CB : 0;
      const int ph = (int)(((uintptr_t)src >> 2) & 3);
      const int e0 = (4 - ph) & 3;
      dst += ph;
      for (int e = e0 + 4 * lane; e < n_el; e += 128) {
        if (e + 4 <= nv) {
          cp_async16(dst + e, src + e);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (e + j < n_el) {
              cp_async4(dst + e + j, e + j < nv ? src + e + j : x,
                        e + j < nv);
            }
          }
        }
      }
      if (lane < e0 && lane < n_el) {
        cp_async4(dst + lane, lane < nv ? src + lane : x, lane < nv);
      }
      if (lane == 0) rph[row] = ph;
    } else {
      for (int e = lane; e < n_el; e += 32) {
        const int col = e / CB;
        const int c = e - col * CB;
        const bool ok = gy < g.hp && iw0 + col < g.wp && c0 + c < g.c;
        cp_async4(dst + e,
                  ok ? x + (((size_t)b * g.hp + gy) * g.wp + iw0 + col) *
                               g.c + c0 + c
                     : x,
                  ok);
      }
      if (lane == 0) rph[row] = 0;
    }
  }
  cp_async_commit();
  // the block's taps widened to float64 (zero past the last channel)
  for (int i = tid; i < k * k * CB; i += nthr) {
    const int tap = i / CB;
    const int c = i - tap * CB;
    wd[i] = c0 + c < g.c ? (double)w[tap * g.c + c0 + c] : 0.0;
  }
  cp_async_wait<0>();
  __syncthreads();

  double acc[RUN][CB];
#pragma unroll
  for (int r = 0; r < RUN; ++r)
#pragma unroll
    for (int c = 0; c < CB; ++c) acc[r][c] = 0.0;

  const int r0 = ty * RUN * s;
  if (K > 0) {
    // stride 1: the RUN + K - 1 inputs of tap column dj of a channel,
    // converted once, serve all K taps of that column
    int rb[RUN + K - 1];
#pragma unroll
    for (int i = 0; i < RUN + K - 1; ++i) {
      rb[i] = (r0 + i) * g.ld + rph[r0 + i] + tx * CB;
    }
#pragma unroll
    for (int dj = 0; dj < K; ++dj) {
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        double win[RUN + K - 1];
#pragma unroll
        for (int i = 0; i < RUN + K - 1; ++i) {
          win[i] = (double)xs[rb[i] + dj * CB + c];
        }
#pragma unroll
        for (int di = 0; di < K; ++di) {
          const double wv = wd[(di * K + dj) * CB + c];
#pragma unroll
          for (int r = 0; r < RUN; ++r) {
            acc[r][c] = fma(win[r + di], wv, acc[r][c]);
          }
        }
      }
    }
  } else {
    for (int di = 0; di < k; ++di) {
      int rb[RUN];
#pragma unroll
      for (int r = 0; r < RUN; ++r) {
        const int row = r0 + r * s + di;
        rb[r] = row * g.ld + rph[row] + tx * s * CB;
      }
      for (int dj = 0; dj < k; ++dj) {
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          const double wv = wd[(di * k + dj) * CB + c];
#pragma unroll
          for (int r = 0; r < RUN; ++r) {
            acc[r][c] = fma((double)xs[rb[r] + dj * CB + c], wv, acc[r][c]);
          }
        }
      }
    }
  }

  // the tile's outputs into shared memory, channel-interleaved as in the
  // output (the input tile is no longer read), then out a row at a time:
  // a row of the tile is one run of floats when CB == C, written 16 bytes
  // at a time where the destination is aligned
  const int ldo = TX * CB;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RUN; ++r) {
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      const int co = min(c0 + c, g.c - 1);
      xs[(ty * RUN + r) * ldo + tx * CB + c] =
          epilogue(acc[r][c], ws, bias, co, g.act_scale, g.act);
    }
  }
  __syncthreads();
  const int ow0 = tw * TX;
  const int ncols = min(TX, g.w_out - ow0);
  for (int row = warp; row < TH; row += nwarps) {
    const int oh = th * TH + row;
    if (oh >= g.n_rows) break;
    const float* src = xs + row * ldo;
    float* dst = out + (((size_t)b * g.n_rows + oh) * g.w_out + ow0) * g.c;
    if (g.contiguous) {
      const int n_o = ncols * CB;
      const int e0 = (int)((4 - (((uintptr_t)dst >> 2) & 3)) & 3);
      for (int e = e0 + 4 * lane; e < n_o; e += 128) {
        if (e + 4 <= n_o) {
          *(float4*)(dst + e) = make_float4(src[e], src[e + 1], src[e + 2],
                                            src[e + 3]);
        } else {
          for (int j = e; j < n_o; ++j) dst[j] = src[j];
        }
      }
      if (lane < e0 && lane < n_o) dst[lane] = src[lane];
    } else {
      for (int e = lane; e < ncols * CB; e += 32) {
        const int col = e / CB;
        const int c = e - col * CB;
        if (c0 + c < g.c) dst[col * g.c + c0 + c] = src[e];
      }
    }
  }
}

struct DwLaunch {
  const void* x;
  const void* w;
  const void* ws;
  const void* bias;
  void* out;
  int batch, tx, tyt, bytes;
  Dw g;
  cudaStream_t stream;
};

template <int K, int RUN, int CB>
int launch_dw_k(const DwLaunch& l) {
  if (l.bytes > kSmemMax) return (int)cudaErrorInvalidConfiguration;
  if (l.bytes > kSmemDefault) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_dw_kernel<K, RUN, CB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, l.bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int th = l.tyt * RUN;
  const dim3 grid((l.g.n_rows + th - 1) / th * l.g.tiles_w,
                  (l.g.c + CB - 1) / CB, l.batch);
  conv_dw_kernel<K, RUN, CB><<<grid, dim3(l.tx, l.tyt), l.bytes,
                               l.stream>>>(
      (const float*)l.x, (const float*)l.w, (const float*)l.ws,
      (const float*)l.bias, (float*)l.out, l.g);
  return (int)cudaGetLastError();
}

template <int CB>
int launch_dw_cb(const DwLaunch& l, int run) {
  const bool fast = l.g.stride == 1 && (l.g.k == 3 || l.g.k == 5 ||
                                        l.g.k == 7);
  if (run != (fast ? kDwFastRun : kDwRun)) {
    return (int)cudaErrorInvalidValue;
  }
  if (!fast) return launch_dw_k<0, kDwRun, CB>(l);
  if (l.g.k == 3) return launch_dw_k<3, kDwFastRun, CB>(l);
  if (l.g.k == 5) return launch_dw_k<5, kDwFastRun, CB>(l);
  return launch_dw_k<7, kDwFastRun, CB>(l);
}

}  // namespace

// x [B, Hp, Wp, C_in], w [k, k, C_in, C_out] (float32, contiguous);
// ws, bias: [C_out] or null; out [B, (Hp-k)/stride+1, (Wp-k)/stride+1,
// C_out]. The tile is tx columns x tyt*run rows (tx 32 or 64, tx*tyt <=
// 128), co_b output channels a thread, cc input channels a stage, as
// kernels/conv_bank/strip.py::strip_config picks them; a (run, co_b) pair
// the kernel is not built for is refused with cudaErrorInvalidValue.
extern "C" int conv_strip_launch(const void* x, const void* w, const void* ws,
                                 const void* bias, void* out, int batch,
                                 int hp, int wp, int c_in, int c_out, int k,
                                 int stride, float act_scale, int act,
                                 int tx, int tyt, int run, int co_b, int cc,
                                 void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if ((tx != 32 && tx != 64) || tyt < 1 || tx * tyt > kDenseThreads ||
      cc < 1 || cc > c_in || k < 1 || stride < 1 || hp < k || wp < k) {
    return bad;
  }
  Dense g{};
  g.hp = hp;
  g.wp = wp;
  g.c_in = c_in;
  g.c_out = c_out;
  g.k = k;
  g.stride = stride;
  g.n_rows = (hp - k) / stride + 1;
  g.w_out = (wp - k) / stride + 1;
  g.tiles_w = (g.w_out + tx - 1) / tx;
  g.cc = cc;
  g.rows_in = (tyt * run - 1) * stride + k;
  g.cols_ld = ((tx - 1) * stride + k + 3) / 4 * 4;
  g.x_bytes = (cc * g.rows_in * g.cols_ld * 4 + 15) / 16 * 16;
  g.wf_bytes = (k * k * cc * co_b * 4 + 15) / 16 * 16;
  g.stage_bytes = g.x_bytes + g.wf_bytes + k * k * cc * co_b * 8;
  g.vec = c_in == 1 && wp % 4 == 0 && (uintptr_t)x % 16 == 0;
  g.act_scale = act_scale;
  g.act = act;
  const DenseLaunch l{x, w, ws, bias, out, batch, tx, tyt, g,
                      (cudaStream_t)stream};
  switch (run * 100 + co_b) {
    case 408: return launch_dense_run<4, 8>(l);
    case 804: return launch_dense_run<8, 4>(l);
    case 404: return launch_dense_run<4, 4>(l);
    case 801: return launch_dense_run<8, 1>(l);
    case 401: return launch_dense_run<4, 1>(l);
    default: return bad;
  }
}

// depthwise, multiplier 1: w_taps [k*k, C]. The tile is tx columns x
// tyt*run rows (tx 32 or 64, tx*tyt <= 256), cb channels a thread (1, 3 or
// 4), as kernels/conv_bank/strip.py::dw_config picks them; run is 8 for k
// = 3, 5, 7 at stride 1 and 4 otherwise, anything else is refused with
// cudaErrorInvalidValue.
extern "C" int conv_strip_dw_launch(const void* x, const void* w_taps,
                                    const void* ws, const void* bias,
                                    void* out, int batch, int hp, int wp,
                                    int c, int k, int stride, float act_scale,
                                    int act, int tx, int tyt, int run, int cb,
                                    void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if ((tx != 32 && tx != 64) || tyt < 1 || tx * tyt > kDwThreads ||
      k < 1 || stride < 1 || hp < k || wp < k || c < 1) {
    return bad;
  }
  Dw g{};
  g.hp = hp;
  g.wp = wp;
  g.c = c;
  g.k = k;
  g.stride = stride;
  g.n_rows = (hp - k) / stride + 1;
  g.w_out = (wp - k) / stride + 1;
  g.tiles_w = (g.w_out + tx - 1) / tx;
  g.rows_in = (tyt * run - 1) * stride + k;
  g.cols_in = (tx - 1) * stride + k;
  g.ld = (g.cols_in * cb + 3) / 4 * 4 + 4;
  g.w_offset = ((g.rows_in * g.ld + g.rows_in) * 4 + 7) / 8 * 8;
  g.contiguous = cb == c;
  g.act_scale = act_scale;
  g.act = act;
  const int bytes = g.w_offset + k * k * cb * 8;
  const DwLaunch l{x, w_taps, ws, bias, out, batch, tx, tyt, bytes, g,
                   (cudaStream_t)stream};
  switch (cb) {
    case 1: return launch_dw_cb<1>(l, run);
    case 3: return launch_dw_cb<3>(l, run);
    case 4: return launch_dw_cb<4>(l, run);
    default: return bad;
  }
}
