// Strip conv: dense and depthwise k x k convs at any stride over a padded
// input, with the optional per-layer epilogue. Hopper (sm_90a) port of the
// TPU kernels in src/repro/kernels/conv_bank/strip_kernel.py:
//   conv_strip_launch    -> conv_strip_kernel (_conv_strip_kernel, _strip_dma,
//                           _tap_patch, _epilogue); the same entry, launched
//                           over a whole frame as one strip, stands in for
//                           kernel.py::conv_bank_kernel (_conv_kernel)
//   conv_strip_dw_launch -> conv_strip_depthwise_kernel (_conv_strip_dw_kernel)
//   conv_strip_int_launch -> conv_strip_kernel again, and conv_bank_kernel
//                           over a whole frame, for integer operands: u8
//                           codes x s8 levels on the int8 tensor cores
//                           (conv_igemm_kernel and conv_igemm_fold_kernel,
//                           below; the wgmma form in conv_strip_wgmma.cu)
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
// Dense (conv_dense_kernel<K, RUN, CO_B>, the CUDA-core form): what bounds
// it on an H100 (the SXM data sheet's rates at its 700 W limit). The
// path's convs (1-4 input channels, k = 3 or 5, 256 x 256 frames at batch
// 8) do 9-100 MACs per 4-byte input, so bytes bound them (1.3 and 3.2 us
// at 3.35 TB/s), and this form keeps them. Convs of 8 or more input and
// output channels at stride 1 and k = 3, 5, 7 (the conv_bank op's float
// mode: 16 -> 32 channels, 32 x 32 frames) are bound by their float64
// operations instead (6.1 us for k = 7 at the FP64 tensor cores' 67
// TFLOP/s, twice this form's FMA rate): they take the tensor-core form,
// conv_f64mma_kernel in conv_strip_f64mma.cu (kernels/conv_bank/strip.py::
// dense_form picks, from the card's times of both). The first design
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

// Dense on the tensor cores (conv_igemm_kernel<KT, MT, NT, WM, WN>): VGG16's
// conv1-conv10 (3-512 input channels, 28-224 wide, batch 8) are about 112 G
// MACs a batch: 0.113 ms of int8 operations at 1,979 TOP/s. With its own
// operands (u8 in, s8 weights, float32 out) bytes bound conv1-conv5 and
// operations conv6-conv10: 0.182 ms in all (the float32 carriers the
// route had before would count 0.229). The float64 kernel above ran them
// on the FP64 units at ~25% of their rate, 26.6 ms a batch. This kernel
// is an implicit GEMM: M the output pixels, N the output channels,
// K = k*k*C_in, as
//   * a CTA takes a tile of th x tw output pixels (128 slots; the tile's
//     shape follows the conv's width: 8 x 16 at 224 and 112, 4 x 28 at 28)
//     for 16, 32 or 64 output channels, 4 warps of 64 x 32 (or 32 x 32,
//     32 x 16) slots x channels, 2 x 4 (2 x 2) m16n8 fragments each;
//   * K runs over C_in in 32-byte chunks. A chunk stages the tile's input
//     patch once, (k-1) halo included, as u8 [pixel][32 + 16 bytes], and
//     the chunk's weights as s8 [tap][channel][32 + 16 bytes], k contiguous,
//     by 16-byte cp.async (zero fill past the input, C_in and C_out) into a
//     ring of 2 stages, so chunk i+1 is in flight while chunk i is summed;
//   * the k*k taps are shifted views of the one staged patch: a lane's
//     ldmatrix row address for each fragment is computed once, a tap adds
//     a uniform offset. So each input byte is read from device memory
//     about once (the halo: 1.4x at 8 x 16, k = 3), not k*k times as an
//     im2col would; the 48-byte rows (3 16-byte units, odd) put the 8 rows
//     of an ldmatrix on 8 different bank groups;
//   * fragments by ldmatrix.x4, products by mma.sync.m16n8k32 u8 x s8 ->
//     s32; k = 3 is an instantiation with the taps unrolled;
//   * C_in of at most 4 (conv1's 3) folds the taps into K instead
//     (conv_igemm_fold_kernel): the caller pads the codes to 4 channels,
//     a tap's channels are one 32-bit word, K = k*k*4 rounded up to 32
//     (2 mma steps at k = 3, not 9 over 32-channel chunks of 3 real ones);
//     other C_in not a multiple of 16 are zero-filled up to 16 by the
//     caller and to 32 by the copies;
//   * the epilogue writes two channels a lane (8 bytes) where C_out is even;
//   * the plan executor's requant can fold its first pass into that store
//     (conv_strip_int_fold_launch, store_tile<..., kFold>; VGG16's
//     conv1-conv10, kernels/epilogue/ops.py::epilogue_fold): each value
//     goes out as the plan's y -- acc * (act_scale[b] * ws) + bias, the
//     activation, the clamp at 0, unpooled, act_scale read on the device
//     -- and each CTA writes its max of y, so csrc/epilogue.cu's pass 2
//     follows with nothing between them.
// The form (this kernel, its taps-folded twin, or the wgmma one in
// conv_strip_wgmma.cu), tile, channel block and stages come from the
// wrapper's plain Python function (kernels/conv_bank/strip.py::
// igemm_config); which dense shapes take the int8 kernels and which the
// float64 one is strip.py::dense_route, from the card's measurements of
// both (PERF.md). The store and the folded epilogue are int_store.cuh's,
// shared with the wgmma form.
// Numerics: codes 0..255 times levels |q| <= 127 are exact in int32 in any
// order while 255 * 127 * k * k * C_in < 2^31 (the launcher refuses the
// rest), and __int2float_rn of the exact sum is the float64 tap loop's
// exact sum rounded once to float32: bitwise the plain version, past 2^24
// too. The epilogue is the float64 kernel's, on explicit _rn intrinsics.

// Numerics: the accumulate is float64, in both forms of the dense conv
// (this file's CUDA-core one, conv_strip_f64mma.cu's tensor-core one).
// Every product of two float32 is exact in float64, and for the integer
// codes x levels of the device path every partial sum is an exact integer
// far below 2^53, so the order of the taps cannot change a bit and the
// result equals the plain version's float64 tap loop
// (repro_torch/kernels/conv_bank/ref.py::conv_taps_int) rounded once to
// float32 -- bitwise, in either form, with no bound to check before the
// launch. Float inputs (the conv_bank op without a quantization spec: on
// the tensor-core form from 8 channels, on this one below) round
// differently from the plain version only through the order of float64
// additions, which differs between the forms. The epilogue uses explicit
// _rn intrinsics, so nvcc cannot contract it into an FMA.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int_store.cuh"      // the int8 kernels' store and folded epilogue

namespace {

constexpr int kSmemDefault = 48 * 1024;    // without the opt-in attribute
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

// ---------------------------------------------------------------------------
// dense, int8 implicit GEMM on the tensor cores
// ---------------------------------------------------------------------------

// 16 bytes, or 16 zero bytes when `valid` is false (src-size 0: nothing read)
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0));
}

// four 8 x 16-byte matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_u8s8(int (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kIgCh = 32;          // input channels (bytes) a stage holds
constexpr int kIgLd = kIgCh + 16;  // bytes a staged pixel or weight row
                                   // takes: 3 16-byte units, odd, so the 8
                                   // rows of an ldmatrix hit 8 bank groups
constexpr int kIgBm = 128;         // output pixel slots of a CTA
constexpr int kIgFoldC = 4;        // channels (bytes) a folded tap carries
constexpr int kIgFoldK = 128;      // most K bytes of a folded conv

// the mma.sync kernels' slots: m16 fragment i of warp row wm holds slots
// (wm * MT + i) * 16 + 0..15, slot p at tile row p / tw, column p % tw
template <int MT>
struct RowMajorSlots {
  int base, tw, tile_px;
  __device__ __forceinline__ RowMajorSlots(const Igemm& g, int wm, int lane)
      : base(wm * MT * 16 + (lane >> 2)), tw(g.tw), tile_px(g.th * g.tw) {}
  __device__ __forceinline__ bool operator()(int i, int h, int& tr,
                                             int& tc) const {
    const int p = base + i * 16 + 8 * h;
    if (p >= tile_px) return false;
    tr = p / tw;
    tc = p - tr * tw;
    return true;
  }
};

// One CTA: the th x tw output pixels of one tile (at most kIgBm, in
// row-major slots) for BN = WN*NT*8 output channels; WM x WN warps, each
// MT m16 fragments of pixel slots x NT n8 fragments of channels. A stage
// holds a C_in chunk of 32 bytes: the patch as u8 [rows_in*cols_in][kIgLd]
// (a pixel's 32 channels, then 16 unused bytes), the chunk's weights as s8
// [k*k][BN][kIgLd] (an output channel's 32 input channels, k contiguous:
// the mma's "col" B operand). Tap (di, dj) reads the patch shifted by di
// rows and dj columns: one ldmatrix address a lane and fragment, plus a
// uniform offset a tap.
template <int KT, int MT, int NT, int WM, int WN, bool kFold>
__global__ void __launch_bounds__(32 * WM * WN)
conv_igemm_kernel(const uint8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ ws, const float* __restrict__ bias,
                  float* __restrict__ out, const Igemm g) {
  constexpr int THREADS = 32 * WM * WN;
  constexpr int BN = WN * NT * 8;
  static_assert(WM * MT * 16 == kIgBm, "a CTA has kIgBm pixel slots");
  static_assert(NT % 2 == 0, "B fragments load in pairs");
  static_assert(!kFold || WM * WN <= kIgFoldRed, "a warp max a slot");
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = KT > 0 ? KT : g.k;
  const int s = g.stride;
  const int taps = k * k;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / WN;
  const int wn = warp - wm * WN;
  const IgTile tl(g, BN, blockIdx.x);
  const int b = tl.b, oh0 = tl.oh0, ow0 = tl.ow0, n0 = tl.n0;
  const int ih0 = oh0 * s;
  const int iw0 = ow0 * s;
  const int tile_px = g.th * g.tw;
  const int n_chunks = (g.c_in + kIgCh - 1) / kIgCh;
  const unsigned sbase = (unsigned)__cvta_generic_to_shared(smem);

  // chunk `chunk` into stage `slot`: 16-byte copies, zero past the padded
  // input, past c_in and past c_out
  auto stage = [&](int slot, int chunk) {
    unsigned char* ps = smem + (size_t)slot * g.stage_bytes;
    unsigned char* wsm = ps + g.patch_bytes;
    const int c0 = chunk * kIgCh;
    const int pieces = g.rows_in * g.cols_in * 2;
    for (int q = tid; q < pieces; q += THREADS) {
      const int px = q >> 1;
      const int ch = c0 + 16 * (q & 1);
      const int r = px / g.cols_in;
      const int c = px - r * g.cols_in;
      const bool ok = ih0 + r < g.hp && iw0 + c < g.wp && ch < g.c_in;
      cp_async16_zfill(ps + px * kIgLd + 16 * (q & 1),
                       ok ? x + (((size_t)b * g.hp + ih0 + r) * g.wp +
                                 iw0 + c) * g.c_in + ch
                          : x,
                       ok);
    }
    const int wpieces = taps * BN * 2;
    for (int q = tid; q < wpieces; q += THREADS) {
      const int row = q >> 1;               // tap * BN + n
      const int tap = row / BN;
      const int n = row - tap * BN;
      const int ch = c0 + 16 * (q & 1);
      const bool ok = n0 + n < g.c_out && ch < g.c_in;
      cp_async16_zfill(wsm + row * kIgLd + 16 * (q & 1),
                       ok ? w + ((size_t)tap * g.c_out + n0 + n) * g.c_in + ch
                          : w,
                       ok);
    }
  };

  // the ldmatrix row a lane gives: A, pixel slot (lane & 15) of each
  // fragment (a slot past the tile reads pixel 0; its sums are dropped),
  // k half lane / 16; B, channel (lane & 7) + 8 * (lane / 16) of each pair
  // of n8 fragments, k half (lane / 8) & 1
  int a_off[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int p = (wm * MT + i) * 16 + (lane & 15);
    int px = 0;
    if (p < tile_px) {
      const int tr = p / g.tw;
      px = tr * s * g.cols_in + (p - tr * g.tw) * s;
    }
    a_off[i] = px * kIgLd + (lane >> 4) * 16;
  }
  const int b_off = (wn * NT * 8 + (lane & 7) + ((lane >> 4) << 3)) * kIgLd +
                    ((lane >> 3) & 1) * 16;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  stage(0, 0);
  cp_async_commit();
  for (int ci = 0; ci < n_chunks; ++ci) {
    if (ci + 1 < n_chunks) stage((ci + 1) & 1, ci + 1);
    cp_async_commit();
    cp_async_wait<1>();        // chunk ci has landed
    __syncthreads();
    const unsigned ps = sbase + (ci & 1) * g.stage_bytes;
    const unsigned wsm = ps + g.patch_bytes + b_off;
#pragma unroll
    for (int di = 0; di < k; ++di) {
#pragma unroll
      for (int dj = 0; dj < k; ++dj) {
        const unsigned pa = ps + (di * g.cols_in + dj) * kIgLd;
        const unsigned pb = wsm + (di * k + dj) * BN * kIgLd;
        uint32_t bf[NT / 2][4];
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) ldsm_x4(bf[j], pb + j * 16 * kIgLd);
        uint32_t af[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) ldsm_x4(af[i], pa + a_off[i]);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mma_u8s8(acc[i][j], af[i], bf[j / 2][2 * (j & 1)],
                     bf[j / 2][2 * (j & 1) + 1]);
      }
    }
    __syncthreads();           // slot free for chunk ci + 2
  }

  store_tile<MT, NT, WN, kFold>(
      acc, ws, bias, out, g, b, oh0, ow0, n0, wn, lane,
      RowMajorSlots<MT>(g, wm, lane),
      reinterpret_cast<float*>(smem + g.red_offset), THREADS, blockIdx.x);
}

// Small C_in (conv1's 3): the k*k taps folded into K. The codes carry 4
// channels (the caller's zero padding), so a tap's channels are one 32-bit
// word, and K = k*k*4 rounded up to 32 bytes (kf, at most 128): 2 mma
// steps for k = 3 instead of 9 over zero-filled 32-channel chunks. One
// stage: the patch as u32 [rows_in*cols_in], 4-byte cp.async a pixel, and
// the weights as s8 [BN][kf + 16] (k = tap*4 + c, zero past k*k*4). The A
// fragment's register for slot r and k = 4*t .. 4*t + 3 is the patch word
// of slot r's pixel shifted by tap t: one 32-bit shared load, no
// ldmatrix; taps past k*k read any word (their weights are zero).
template <int KT, int MT, int NT, int WM, int WN, bool kFold>
__global__ void __launch_bounds__(32 * WM * WN)
conv_igemm_fold_kernel(const uint8_t* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ ws,
                       const float* __restrict__ bias,
                       float* __restrict__ out, const Igemm g) {
  constexpr int THREADS = 32 * WM * WN;
  constexpr int BN = WN * NT * 8;
  static_assert(WM * MT * 16 == kIgBm, "a CTA has kIgBm pixel slots");
  static_assert(NT % 2 == 0, "B fragments load in pairs");
  static_assert(!kFold || WM * WN <= kIgFoldRed, "a warp max a slot");
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = KT > 0 ? KT : g.k;
  const int s = g.stride;
  const int taps = k * k;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / WN;
  const int wn = warp - wm * WN;
  const IgTile tl(g, BN, blockIdx.x);
  const int b = tl.b, oh0 = tl.oh0, ow0 = tl.ow0, n0 = tl.n0;
  const int ih0 = oh0 * s;
  const int iw0 = ow0 * s;
  const int tile_px = g.th * g.tw;
  const int ldw = g.kf + 16;
  uint32_t* patch = (uint32_t*)smem;
  unsigned char* wsm = smem + g.patch_bytes;

  for (int px = tid; px < g.rows_in * g.cols_in; px += THREADS) {
    const int r = px / g.cols_in;
    const int c = px - r * g.cols_in;
    const bool ok = ih0 + r < g.hp && iw0 + c < g.wp;
    cp_async4(patch + px,
              ok ? x + (((size_t)b * g.hp + ih0 + r) * g.wp + iw0 + c) *
                           kIgFoldC
                 : x,
              ok);
  }
  const int row_pieces = g.kf / 16;
  for (int q = tid; q < BN * row_pieces; q += THREADS) {
    const int n = q / row_pieces;
    const int j = q - n * row_pieces;
    const bool ok = n0 + n < g.c_out;
    cp_async16_zfill(wsm + n * ldw + 16 * j,
                     ok ? w + (size_t)(n0 + n) * g.kf + 16 * j : w, ok);
  }
  cp_async_commit();

  // the patch word of each fragment's slots lane / 4 and lane / 4 + 8
  int base[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (wm * MT + i) * 16 + (lane >> 2) + 8 * h;
      int px = 0;
      if (p < tile_px) {
        const int tr = p / g.tw;
        px = tr * s * g.cols_in + (p - tr * g.tw) * s;
      }
      base[i][h] = px;
    }
  }
  const unsigned b_addr = (unsigned)__cvta_generic_to_shared(wsm) +
                          (wn * NT * 8 + (lane & 7) + ((lane >> 4) << 3)) *
                              ldw +
                          ((lane >> 3) & 1) * 16;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  cp_async_wait<0>();
  __syncthreads();
  const int steps = g.kf / 32;
  for (int ks = 0; ks < steps; ++ks) {
    // this lane's two taps of the step: k = 4 * (8 * ks + lane % 4) and
    // 16 bytes further
    const int t0 = 8 * ks + (lane & 3);
    const int t1 = t0 + 4;
    const int o0 = t0 < taps ? (t0 / k) * g.cols_in + t0 % k : 0;
    const int o1 = t1 < taps ? (t1 / k) * g.cols_in + t1 % k : 0;
    uint32_t bf[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT / 2; ++j)
      ldsm_x4(bf[j], b_addr + j * 16 * ldw + ks * 32);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const uint32_t af[4] = {patch[base[i][0] + o0], patch[base[i][1] + o0],
                              patch[base[i][0] + o1], patch[base[i][1] + o1]};
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mma_u8s8(acc[i][j], af, bf[j / 2][2 * (j & 1)],
                 bf[j / 2][2 * (j & 1) + 1]);
    }
  }
  store_tile<MT, NT, WN, kFold>(
      acc, ws, bias, out, g, b, oh0, ow0, n0, wn, lane,
      RowMajorSlots<MT>(g, wm, lane),
      reinterpret_cast<float*>(smem + g.red_offset), THREADS, blockIdx.x);
}

template <typename Kernel>
int launch_igemm_fn(Kernel kernel, int threads, const IgLaunch& l) {
  const size_t bytes = (size_t)l.stages * l.g.stage_bytes +
                       (l.g.partials != nullptr ? kIgFoldRed * 4 : 0);
  if (bytes > (size_t)kSmemMax) return (int)cudaErrorInvalidConfiguration;
  if (bytes > (size_t)kSmemDefault) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const long long ctas = (long long)l.batch * l.g.tiles * l.g.n_blocks;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)ctas, threads, bytes, l.stream>>>(
      (const uint8_t*)l.x, (const int8_t*)l.w, (const float*)l.ws,
      (const float*)l.bias, (float*)l.out, l.g);
  return (int)cudaGetLastError();
}

template <int KT, int MT, int NT, int WM, int WN, bool kFold>
int launch_igemm_f(const IgLaunch& l) {
  if (l.g.kf > 0) {
    return launch_igemm_fn(conv_igemm_fold_kernel<KT, MT, NT, WM, WN, kFold>,
                           32 * WM * WN, l);
  }
  return launch_igemm_fn(conv_igemm_kernel<KT, MT, NT, WM, WN, kFold>,
                         32 * WM * WN, l);
}

template <int KT, int MT, int NT, int WM, int WN>
int launch_igemm_k(const IgLaunch& l) {
  if (l.g.partials != nullptr) {
    return launch_igemm_f<KT, MT, NT, WM, WN, true>(l);
  }
  return launch_igemm_f<KT, MT, NT, WM, WN, false>(l);
}

template <int MT, int NT, int WM, int WN>
int launch_igemm_bn(const IgLaunch& l) {
  if (l.g.k == 3) return launch_igemm_k<3, MT, NT, WM, WN>(l);
  return launch_igemm_k<0, MT, NT, WM, WN>(l);
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

namespace {

// The int8 launch's geometry into *g, or cudaErrorInvalidValue for a
// shape or configuration the kernel does not take (see below)
int igemm_geometry(Igemm* g, const void* x, const void* w, int batch, int hp,
                   int wp, int c_in, int c_out, int k, int stride, int th,
                   int tw, int bn, int stages) {
  const int bad = (int)cudaErrorInvalidValue;
  const int kf = c_in == kIgFoldC ? (k * k * kIgFoldC + 31) / 32 * 32 : 0;
  if ((kf == 0 && (c_in < 16 || c_in % 16 != 0)) || kf > kIgFoldK ||
      c_out < 1 || th < 1 || tw < 1 || th * tw > kIgBm || k < 1 ||
      stride < 1 || hp < k || wp < k || batch < 1 ||
      (uintptr_t)x % (kf > 0 ? 4 : 16) != 0 || (uintptr_t)w % 16 != 0 ||
      255LL * 127 * k * k * c_in >= (1LL << 31)) {
    return bad;
  }
  if (stages != ((c_in + kIgCh - 1) / kIgCh > 1 ? 2 : 1)) return bad;
  if (bn != 64 && bn != 32 && bn != 16) return bad;
  *g = Igemm{};
  g->kf = kf;
  g->hp = hp;
  g->wp = wp;
  g->c_in = c_in;
  g->c_out = c_out;
  g->k = k;
  g->stride = stride;
  g->n_rows = (hp - k) / stride + 1;
  g->w_out = (wp - k) / stride + 1;
  g->th = th;
  g->tw = tw;
  g->tiles_w = (g->w_out + tw - 1) / tw;
  g->tiles = (g->n_rows + th - 1) / th * g->tiles_w;
  g->n_blocks = (c_out + bn - 1) / bn;
  g->rows_in = (th - 1) * stride + k;
  g->cols_in = (tw - 1) * stride + k;
  if (kf > 0) {
    g->patch_bytes = (g->rows_in * g->cols_in * kIgFoldC + 15) / 16 * 16;
    g->stage_bytes = g->patch_bytes + bn * (kf + 16);
  } else {
    g->patch_bytes = g->rows_in * g->cols_in * kIgLd;
    g->stage_bytes = g->patch_bytes + k * k * bn * kIgLd;
  }
  g->red_offset = stages * g->stage_bytes;
  return 0;
}

int launch_igemm(const IgLaunch& l, int bn) {
  switch (bn) {
    case 64: return launch_igemm_bn<4, 4, 2, 2>(l);
    case 32: return launch_igemm_bn<2, 4, 4, 1>(l);
    default: return launch_igemm_bn<2, 2, 4, 1>(l);
  }
}

}  // namespace

// int8 implicit GEMM: x [B, Hp, Wp, C_in] u8 codes, w_t [k*k, C_out, C_in]
// s8 levels (C_in a multiple of 16, both 16-byte aligned); or, folded, C_in
// = 4 with k*k*4 <= 128, x 4-byte aligned and w_t [C_out, kf] (k = tap*4 +
// c, kf = k*k*4 rounded up to 32, zero past k*k*4); ws, bias: [C_out] or
// null; out [B, (Hp-k)/stride+1, (Wp-k)/stride+1, C_out] float32. The tile
// is th x tw output pixels (at most 128), bn output channels a CTA (16, 32
// or 64), stages 2 when C_in takes more than one 32-byte chunk and 1
// otherwise, as kernels/conv_bank/strip.py::igemm_config picks them;
// anything else, or a shape whose accumulate could leave int32 (255 * 127
// * k * k * C_in >= 2^31), is refused with cudaErrorInvalidValue.
extern "C" int conv_strip_int_launch(const void* x, const void* w,
                                     const void* ws, const void* bias,
                                     void* out, int batch, int hp, int wp,
                                     int c_in, int c_out, int k, int stride,
                                     float act_scale, int act, int th, int tw,
                                     int bn, int stages, void* stream) {
  Igemm g;
  const int err = igemm_geometry(&g, x, w, batch, hp, wp, c_in, c_out, k,
                                 stride, th, tw, bn, stages);
  if (err != 0) return err;
  g.act_scale = act_scale;
  g.act = act;
  const IgLaunch l{x, w, ws, bias, out, batch, stages, g,
                   (cudaStream_t)stream};
  return launch_igemm(l, bn);
}

// The same conv with the plan's epilogue folded into its store (kFold in
// store_tile): out is y, unpooled, activated and clamped at 0, and
// partials [B, tiles * n_blocks] each CTA's max of it. scale (act_scale,
// scale_n 1 or B values) and ws (ws_n 1 or C_out) are device pointers,
// bias (bias_n 1 or C_out) one or null: nothing is read on the host, so a
// CUDA graph captures the conv after the requant that wrote scale.
extern "C" int conv_strip_int_fold_launch(
    const void* x, const void* w, const void* ws, const void* bias, void* out,
    void* partials, const void* scale, int scale_n, int ws_n, int bias_n,
    int batch, int hp, int wp, int c_in, int c_out, int k, int stride,
    int act, int th, int tw, int bn, int stages, void* stream) {
  Igemm g;
  const int err = igemm_geometry(&g, x, w, batch, hp, wp, c_in, c_out, k,
                                 stride, th, tw, bn, stages);
  if (err != 0) return err;
  if (!fold_args_ok(ws, bias, partials, scale, scale_n, ws_n, bias_n, batch,
                    c_out, act)) {
    return (int)cudaErrorInvalidValue;
  }
  set_fold(&g, act, scale, partials, scale_n, ws_n, bias_n);
  const IgLaunch l{x, w, ws, bias, out, batch, stages, g,
                   (cudaStream_t)stream};
  return launch_igemm(l, bn);
}
