// The dense strip conv on the FP64 tensor cores: Hopper (sm_90a)
// counterpart, with conv_strip.cu's CUDA-core kernel, of the TPU kernels
// src/repro/kernels/conv_bank/strip_kernel.py::conv_strip_kernel and
// kernel.py::conv_bank_kernel (the same launch over a whole frame) for
// float operands:
//   out[b, oh, ow, co] = sum_{di, dj, ci} x[b, oh + di, ow + dj, ci]
//                                          * w[di, dj, ci, co]
// at stride 1, then the strip epilogue. Its own source, so nvcc builds it
// beside conv_strip.cu, not after it.
//
// What bounds it on an H100: the conv_bank op's float mode (16 -> 32
// channels, k = 3, 5, 7, 32 x 32 frames at batch 8) does 2 * 144 to
// 2 * 784 flops per 4-byte output, so operations bound it: 0.0104 ms for
// its three calls at the FP64 tensor cores' 67 TFLOP/s (the CUDA cores
// have half that). conv_strip.cu's CUDA-core kernel ran those calls at
// 6% of it, slower than F.conv2d (PERF.md, row 6): 64-thread CTAs that
// staged each input pixel once per 4-channel block and did a few FMAs
// per shared-memory read. This kernel is an implicit GEMM, M the output
// pixels of a tile, N the output channels, K = k*k*C_in, on
// mma.sync.aligned.m16n8k8 .f64 (wgmma has no f64 form):
//   * a CTA takes a tile of th x 8 output pixels (th 8 or 16) for bn
//     output channels (16 or 32); each warp one m16n8 block, 2 rows x 8
//     columns for 8 channels: th / 2 x bn / 8 warps, 16 at most. More,
//     smaller warps ran faster than fewer that each summed 2 or 4 blocks
//     (PERF.md);
//   * K runs over C_in in chunks of cc channels (a multiple of 8: one
//     m16n8k8 step per 8 channels of a tap). A chunk lands by cp.async
//     (16 bytes a copy where C_in, C_out and the pointers allow it, else
//     4; zero fill past the input, C_in and C_out) as float32 as it lies
//     in device memory: the tile's input patch once, halo included, and
//     the chunk's weights. It is then widened to float64 (exact) into the
//     stage the fragments are read from, [th + k - 1][8 + k - 1][cc + 4]
//     and [k*k][cc][bn + 4]: a widening per fragment load would cost one
//     conversion per 8 FMAs, on the FP64 pipe. The next chunk's copies
//     fly while this one is summed;
//   * the k*k taps are shifted views of the one staged patch: for each
//     tap column dj and 8-channel step, a lane loads the k + 1 patch
//     rows its m16 block meets (the A fragment's two channels a row) once
//     and slides them past the k taps of the column; so each input
//     float is read from device memory about once per channel block, not
//     k*k times as an im2col would;
//   * the pads of 4 doubles make a patch pixel's and a weight row's stride
//     4 mod 16 doubles: each half-warp's 8-byte fragment loads (4 rows x 4
//     channels of A, 4 channels x 4 columns of B) hit 16 different bank
//     pairs;
//   * the chunk leaves room for a second CTA on the SM where the launch
//     has more CTAs than SMs, so one stages while the other sums; else it
//     is as large as a CTA holds (all of C_in = 16 at k = 3, 5).
// What holds it now (PERF.md): at the conv_bank op's calls a launch takes
// as long at batch 1 as at batch 8, so each SM's own chain of copies,
// widening and mma bounds it; the mma run at about half the FP64 tensor
// rate, and more independent sums a warp did not help.
// The tile, block and chunk come from the wrapper's plain Python function
// (kernels/conv_bank/strip.py::f64mma_config), which also states the rule
// that gives this form a conv (strip.dense_form): stride 1, k 3, 5 or 7,
// at least 8 input and 8 output channels.
// Numerics: every product of two float32 is exact in float64. On integer
// operands (codes x levels) every partial sum is an exact integer below
// 2^53, so the sum's order cannot change a bit: bitwise the plain
// version's float64 tap loop (conv_bank/ref.py::conv_taps_int) rounded once
// to float32. Float operands (the conv_bank op without a quantization
// spec) round differently from it only through the order of float64
// additions. The epilogue is conv_strip.cu's, on explicit _rn intrinsics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemMax = 232448;           // H100: 227 KB a block can opt into
constexpr int kSmemDefault = 48 * 1024;    // without the opt-in attribute
constexpr int kTw = 8;                     // tile columns: an m16 block's
constexpr int kPad = 4;                    // doubles past a staged row
constexpr int kMaxThreads = 512;           // 16 warps a CTA at most

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1: return v > 0.0f ? v : 0.0f;                      // relu
    case 2: return fabsf(v);                                 // abs
    case 3: return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : v); // sign
    default: return v;                                       // none
  }
}

// dequant -> bias -> act when ws is given; the raw accumulate otherwise
// (conv_strip.cu's epilogue())
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

// d += a . b: a 16 x 8 row-major (a0 = A[g][t], a1 = A[g + 8][t], a2 =
// A[g][t + 4], a3 = A[g + 8][t + 4]), b 8 x 8 column-major (b0 = B[t][g],
// b1 = B[t + 4][g]), d 16 x 8 (d0, d1 = D[g][2t, 2t + 1], d2, d3 = D[g +
// 8][2t, 2t + 1]); g = lane / 4, t = lane % 4
__device__ __forceinline__ void mma_m16n8k8(double (&d)[4], double a0,
                                            double a1, double a2, double a3,
                                            double b0, double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

struct F64Conv {
  int hp, wp, c_in, c_out;
  int n_rows, w_out;        // output rows and columns
  int th, bn;               // a CTA's tile rows and output channels
  int tiles_w, n_blocks;    // column tiles, output-channel blocks
  int cc;                   // input channels a stage (a multiple of 8)
  int rows_in;              // staged patch rows (th + k - 1)
  int ps, wsd;              // doubles a staged pixel / weight row
  int patch_doubles;        // rows_in * cols_in * ps
  int patch_floats;         // rows_in * cols_in * cc (the landing area)
  int vec_x, vec_w;         // 16-byte loads of x / of w
  float act_scale;
  int act;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0));
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy chunk [cb, cb + cc8) of the tile at (b, oh0, ow0) and of the
// output-channel block at n0 into the float32 landing area as it lies in
// device memory: xl[p][j] (p = row * cols_in + col, j < cc8, rows cc
// floats) and wl[tap][j][n] (n < bn), zero past the input, C_in and C_out
// (src-size 0). cc8: the chunk's channels rounded up to 8.
template <int K>
__device__ __forceinline__ void copy_chunk(
    float* xl, float* wl, const float* __restrict__ x,
    const float* __restrict__ w, const F64Conv& g, int b, int oh0, int ow0,
    int n0, int cb, int cc8) {
  constexpr int cols_in = kTw + K - 1;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int pixels = g.rows_in * cols_in;
  const int vx = g.vec_x ? 4 : 1;          // floats a copy
  const int units = cc8 / vx;
  for (int i = tid; i < pixels * units; i += nthr) {
    const int p = i / units;
    const int j = (i - p * units) * vx;
    const int pr = p / cols_in;
    const int gy = oh0 + pr, gx = ow0 + p - pr * cols_in;
    const bool ok = gy < g.hp && gx < g.wp && cb + j < g.c_in;
    const float* src =
        ok ? x + (((size_t)b * g.hp + gy) * g.wp + gx) * g.c_in + cb + j : x;
    if (g.vec_x) cp_async16(xl + p * g.cc + j, src, ok);
    else cp_async4(xl + p * g.cc + j, src, ok);
  }
  const int vw = g.vec_w ? 4 : 1;
  const int wunits = g.bn / vw;
  for (int i = tid; i < K * K * cc8 * wunits; i += nthr) {
    const int row = i / wunits;            // tap * cc8 + j
    const int n = (i - row * wunits) * vw;
    const int tap = row / cc8;
    const int j = row - tap * cc8;
    const bool ok = cb + j < g.c_in && n0 + n < g.c_out;
    const float* src =
        ok ? w + ((size_t)tap * g.c_in + cb + j) * g.c_out + n0 + n : w;
    float* dst = wl + (tap * g.cc + j) * g.bn + n;
    if (g.vec_w) cp_async16(dst, src, ok);
    else cp_async4(dst, src, ok);
  }
}

// Widen the landed chunk to float64 into the stage the mma reads: the
// patch [p][cc + pad] and the weights [tap][cc][bn + pad], 4 floats a step
// (exact)
template <int K>
__device__ __forceinline__ void widen_chunk(double* patch, double* wts,
                                            const float* xl, const float* wl,
                                            const F64Conv& g, int cc8) {
  constexpr int cols_in = kTw + K - 1;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int units = cc8 >> 2;
  for (int i = tid; i < g.rows_in * cols_in * units; i += nthr) {
    const int p = i / units;
    const int j = (i - p * units) << 2;
    const float4 v = *reinterpret_cast<const float4*>(xl + p * g.cc + j);
    double2* dst = reinterpret_cast<double2*>(patch + p * g.ps + j);
    dst[0] = make_double2(v.x, v.y);
    dst[1] = make_double2(v.z, v.w);
  }
  const int wunits = g.bn >> 2;
  for (int i = tid; i < K * K * cc8 * wunits; i += nthr) {
    const int row = i / wunits;
    const int n = (i - row * wunits) << 2;
    const int tap = row / cc8;
    const int j = row - tap * cc8;
    const float4 v = *reinterpret_cast<const float4*>(
        wl + (tap * g.cc + j) * g.bn + n);
    double2* dst = reinterpret_cast<double2*>(wts + (tap * g.cc + j) *
                                              g.wsd + n);
    dst[0] = make_double2(v.x, v.y);
    dst[1] = make_double2(v.z, v.w);
  }
}

// blockIdx.x = tile * n_blocks + channel block (neighbouring CTAs stage the
// same input tile while it is in L2), blockIdx.y = frame. A warp takes one
// m16n8 block, 2 output rows x 8 columns for 8 channels: warp w the tile
// rows 2 (w / wpn) and 2 (w / wpn) + 1 and the block's channels 8 (w %
// wpn) .. + 7, wpn = bn / 8.
template <int K>
__global__ void __launch_bounds__(kMaxThreads, 1)
conv_f64mma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ ws,
                   const float* __restrict__ bias, float* __restrict__ out,
                   const F64Conv g) {
  constexpr int cols_in = kTw + K - 1;
  constexpr int WIN = K + 1;               // patch rows a warp's taps meet
  extern __shared__ __align__(16) double smem[];
  double* patch = smem;
  double* wts = smem + g.patch_doubles;
  float* xl = (float*)(wts + K * K * g.cc * g.wsd);
  float* wl = xl + g.patch_floats;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wpn = g.bn / 8;                // warps across the block
  const int wr0 = (warp / wpn) * 2;
  const int wn0 = (warp - (warp / wpn) * wpn) * 8;
  const int blk = blockIdx.x % g.n_blocks;
  const int tile = blockIdx.x / g.n_blocks;
  const int tr = tile / g.tiles_w;
  const int oh0 = tr * g.th;
  const int ow0 = (tile - tr * g.tiles_w) * kTw;
  const int n0 = blk * g.bn;
  const int b = blockIdx.y;
  const int row_stride = cols_in * g.ps;

  double acc[4] = {0.0, 0.0, 0.0, 0.0};

  copy_chunk<K>(xl, wl, x, w, g, b, oh0, ow0, n0, 0, min(g.cc,
                                                        (g.c_in + 7) & ~7));
  cp_async_commit();
  for (int cb = 0; cb < g.c_in; cb += g.cc) {
    const int cc8 = (min(g.cc, g.c_in - cb) + 7) & ~7;
    cp_async_wait_all();
    __syncthreads();                       // landed; the last chunk's
                                           // reads of the stage are done
    widen_chunk<K>(patch, wts, xl, wl, g, cc8);
    __syncthreads();                       // the stage is ready, the
    const int next = cb + g.cc;            // landing area free: the next
    if (next < g.c_in) {                   // chunk's copies fly while
      copy_chunk<K>(xl, wl, x, w, g, b, oh0, ow0, n0, next,  // this one
                    (min(g.cc, g.c_in - next) + 7) & ~7);    // is summed
    }
    cp_async_commit();
    for (int q = 0; q < cc8; q += 8) {
#pragma unroll
      for (int dj = 0; dj < K; ++dj) {
        // the A fragment's two channels (q + t, q + t + 4) of the patch
        // pixel (wr0 + r, gq + dj) for every row r the column's taps
        // meet, and the B fragments of the column's k taps, all loaded
        // before its mma
        const double* pa = patch + (wr0 * cols_in + gq + dj) * g.ps + q + tq;
        double win[WIN][2];
#pragma unroll
        for (int r = 0; r < WIN; ++r) {
          win[r][0] = pa[r * row_stride];
          win[r][1] = pa[r * row_stride + 4];
        }
        const double* pb = wts + (dj * g.cc + q + tq) * g.wsd + wn0 + gq;
        double bf[K][2];
#pragma unroll
        for (int di = 0; di < K; ++di) {
          bf[di][0] = pb[di * K * g.cc * g.wsd];
          bf[di][1] = pb[di * K * g.cc * g.wsd + 4 * g.wsd];
        }
#pragma unroll
        for (int di = 0; di < K; ++di) {
          mma_m16n8k8(acc, win[di][0], win[di + 1][0], win[di][1],
                      win[di + 1][1], bf[di][0], bf[di][1]);
        }
      }
    }
  }

  // D row gq is output row wr0, row gq + 8 the next; its columns 2t, 2t +
  // 1 are channels wn0 + 2t, + 1
  const int ow = ow0 + gq;
  const int co = n0 + wn0 + 2 * tq;
  if (ow >= g.w_out || co >= g.c_out) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int oh = oh0 + wr0 + h;
    if (oh >= g.n_rows) continue;
    float* o = out + (((size_t)b * g.n_rows + oh) * g.w_out + ow) * g.c_out;
    const float v0 = epilogue(acc[2 * h], ws, bias, co, g.act_scale, g.act);
    if (co + 1 >= g.c_out) {
      o[co] = v0;
      continue;
    }
    const float v1 = epilogue(acc[2 * h + 1], ws, bias, co + 1, g.act_scale,
                              g.act);
    if ((g.c_out & 1) == 0) {              // 8-byte aligned pairs
      *reinterpret_cast<float2*>(o + co) = make_float2(v0, v1);
    } else {
      o[co] = v0;
      o[co + 1] = v1;
    }
  }
}

template <int K>
int launch_f64(const float* x, const float* w, const float* ws,
               const float* bias, float* out, int batch, const F64Conv& g,
               cudaStream_t stream) {
  const size_t bytes =
      ((size_t)g.patch_doubles + (size_t)K * K * g.cc * g.wsd) * 8 +
      ((size_t)g.patch_floats + (size_t)K * K * g.cc * g.bn) * 4;
  if (bytes > (size_t)kSmemMax) return (int)cudaErrorInvalidConfiguration;
  if (bytes > (size_t)kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_f64mma_kernel<K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles = (g.n_rows + g.th - 1) / g.th * g.tiles_w;
  const dim3 grid(tiles * g.n_blocks, batch);
  const int threads = 32 * (g.th / 2) * (g.bn / 8);
  conv_f64mma_kernel<K><<<grid, threads, bytes, stream>>>(x, w, ws, bias,
                                                          out, g);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, Hp, Wp, C_in], w [k, k, C_in, C_out] (float32, contiguous); ws,
// bias: [C_out] or null; out [B, Hp - k + 1, Wp - k + 1, C_out]: every
// output row of the padded input, conv_strip_launch's contract at stride
// 1. The tile is th (8 or 16) x tw (8) output pixels for bn (16 or 32)
// output channels (th / 2 x bn / 8 warps, 16 at most), cc input channels
// a stage (a multiple of 8), as
// kernels/conv_bank/strip.py::f64mma_config picks them; anything else,
// another stride or a k other than 3, 5, 7, is refused with
// cudaErrorInvalidValue.
extern "C" int conv_strip_f64mma_launch(const void* x, const void* w,
                                        const void* ws, const void* bias,
                                        void* out, int batch, int hp, int wp,
                                        int c_in, int c_out, int k,
                                        int stride, float act_scale, int act,
                                        int th, int tw, int bn, int cc,
                                        void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (stride != 1 || (k != 3 && k != 5 && k != 7) || tw != kTw ||
      (th != 8 && th != 16) || (bn != 16 && bn != 32) ||
      32 * (th / 2) * (bn / 8) > kMaxThreads || cc < 8 ||
      cc % 8 != 0 || batch < 1 || c_in < 1 || c_out < 1 || hp < k ||
      wp < k || batch > 65535) {
    return bad;
  }
  F64Conv g{};
  g.hp = hp;
  g.wp = wp;
  g.c_in = c_in;
  g.c_out = c_out;
  g.n_rows = hp - k + 1;
  g.w_out = wp - k + 1;
  g.th = th;
  g.bn = bn;
  g.tiles_w = (g.w_out + kTw - 1) / kTw;
  g.n_blocks = (c_out + bn - 1) / bn;
  g.cc = cc;
  g.rows_in = th + k - 1;
  g.ps = cc + kPad;
  g.wsd = bn + kPad;
  g.patch_doubles = g.rows_in * (kTw + k - 1) * g.ps;
  g.patch_floats = g.rows_in * (kTw + k - 1) * cc;
  g.vec_x = c_in % 4 == 0 && (uintptr_t)x % 16 == 0;
  g.vec_w = c_out % 4 == 0 && (uintptr_t)w % 16 == 0;
  g.act_scale = act_scale;
  g.act = act;
  const float* xf = (const float*)x;
  const float* wf = (const float*)w;
  const float* wsf = (const float*)ws;
  const float* bf = (const float*)bias;
  float* of = (float*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  if (k == 3) return launch_f64<3>(xf, wf, wsf, bf, of, batch, g, s);
  if (k == 5) return launch_f64<5>(xf, wf, wsf, bf, of, batch, g, s);
  return launch_f64<7>(xf, wf, wsf, bf, of, batch, g, s);
}
