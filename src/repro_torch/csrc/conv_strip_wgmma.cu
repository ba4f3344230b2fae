// The int8 strip conv's wgmma form: Hopper (sm_90a) counterpart, with
// conv_strip.cu's mma.sync kernels, of the TPU kernel
// src/repro/kernels/conv_bank/strip_kernel.py::conv_strip_kernel (and
// kernel.py::conv_bank_kernel over a whole frame) for integer operands:
//   out[b, oh, ow, co] = sum_{di, dj, ci} x[b, oh + di, ow + dj, ci]
//                                          * w[di, dj, ci, co]
// over u8 codes x s8 levels, int32 sums, then the strip epilogue or the
// plan's folded one (int_store.cuh). Its own source, so nvcc builds it
// beside conv_strip.cu, not after it.
//
// conv_igemm_wgmma_kernel<MB, BN, kFold>: conv_strip.cu's implicit GEMM
// rebuilt for Hopper, at stride 1 with C_in a multiple of 16 (VGG16's
// conv2-conv10). conv_strip.cu's mma.sync kernel ran them at 12-18% of
// the int8 peak (conv2-conv10 0.753 ms a bucket-8 batch against a bound of
// 0.151): ldmatrix, cp.async and 4 warps cannot feed the tensor cores. Now:
//   * a work item is 128 or 256 output pixels in 8 x 8 blocks (16 x 16, 8 x
//     32, 32 x 8, 16 x 8, 8 x 16) for 64 or 128 output channels; a CTA is
//     two consumer warpgroups, each one or two m64 blocks x BN on
//     wgmma.m64nBNk32 u8 x s8 -> s32, and a producer warpgroup whose
//     registers the consumers take (setmaxnreg 40 / 232);
//   * one CTA an SM walks the items, and one thread of the producer
//     stages each C_in chunk (32 or 64 channels) by TMA into a ring of up
//     to 4 mbarrier-signalled stages across them, so the next item's
//     copies overlap this one's store: the tile's input patch, halo
//     included, as 16-channel planes u8 [rows_in][cols_in][16] (a 4-D
//     tensor map over the codes, built per call on the host), and all of
//     the chunk's levels in one box, planes s8 [k*k][BN][16] (a 3-D map of
//     8-byte elements over the levels laid out plane-major once, built
//     with them: boxes of 16-byte rows, one a plane, ran the chunk's
//     weights at half the speed); TMA zero-fills past the input, C_in and
//     C_out, so ragged tiles, the last block and C_in = 16 inside a 32-byte
//     k-step need no code;
//   * both operands are no-swizzle K-major wgmma tiles read in place: the
//     8 output columns of a block row are 8 consecutive patch pixels, one
//     core matrix, so each tap is a shifted view of the staged patch
//     (start + (di * cols_in + dj) * 16, the next output row cols_in * 16
//     bytes on, the next 16 channels a plane on) -- each input byte read
//     from memory about once, not k*k times as an im2col would;
//   * the store is the mma.sync kernels' (int_store.cuh's store_tile): the
//     accumulator of m64nBN is the m16n8 C fragment BN / 8 times, at the
//     block's pixels;
//     the folded store's item maxima meet on a named barrier of the
//     consumers alone, in the mma.sync kernels' CTA order.
// What bounds it now (PERF.md): conv2-conv5 write 4-byte outputs
// (bytes); conv6-conv10 run at 34-40% of the int8 rate, the patch planes'
// 16-byte rows (one TMA request a pixel and plane) the likely limit.
// The form, tile, channel block, chunk and stages come from the wrapper's
// plain Python function (kernels/conv_bank/strip.py::igemm_config, which
// gives this form stride 1 with C_in a multiple of 16, where a stage fits).
// Numerics: as conv_strip.cu's mma.sync kernels -- exact int32 sums in any
// order under the launcher's 255 * 127 * k * k * C_in < 2^31 guard,
// __int2float_rn once, the epilogue on explicit _rn intrinsics.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"         // mbarriers, TMA, wgmma's sync, the encoder
#include "int_store.cuh"      // the store and the folded epilogue

namespace {

constexpr int kWgConsumers = 2;             // consumer warpgroups a CTA
constexpr int kWgConsumerThreads = 128 * kWgConsumers;
constexpr int kWgThreads = kWgConsumerThreads + 128;  // + the producer's
constexpr int kWgAlign = 128;               // a TMA box's smem alignment
constexpr int kWgMaxStages = 4;

// d += A (64 x 32 bytes of u8 codes) . B (64 x 32 bytes of s8 levels)^T,
// both K-major in shared memory; d[j][e] is the m16n8 C fragment j's
// element e of this thread's rows
__device__ __forceinline__ void wgmma_u8s8_n64(int (&d)[8][4], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]), "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]), "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]), "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]), "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3])
      : "l"(da), "l"(db), "r"(1));
}

// d += A (64 x 32 bytes of u8 codes) . B (128 x 32 bytes of s8 levels)^T,
// both K-major in shared memory; d[j][e] is the m16n8 C fragment j's
// element e of this thread's rows
__device__ __forceinline__ void wgmma_u8s8_n128(int (&d)[16][4], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]), "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]), "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]), "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]), "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]), "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]), "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]), "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]), "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_u8s8(int (&d)[BN / 8][4], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 128) {
    wgmma_u8s8_n128(d, da, db);
  } else {
    wgmma_u8s8_n64(d, da, db);
  }
}

// the 16-channel planes chunk c stages: its channels rounded up to a
// 32-byte k-step (a plane past C_in comes back zero from TMA)
__device__ __forceinline__ int chunk_planes(const Igemm& g, int c) {
  return 2 * ((min(g.ch, g.c_in - c * g.ch) + 31) >> 5);
}

// the wgmma form's slots: m64 block blk = wg * MB + i is the tile's 8 x 8
// block blk (row-major, tw / 8 blocks a row); warp wq of warpgroup wg
// holds its output rows 2 wq (h = 0) and 2 wq + 1 (h = 1), column lane / 4
template <int MB>
struct BlockSlots {
  int wg, wq, bw, col;
  __device__ __forceinline__ BlockSlots(const Igemm& g, int wg, int wq,
                                        int lane)
      : wg(wg), wq(wq), bw(g.tw >> 3), col(lane >> 2) {}
  __device__ __forceinline__ bool operator()(int i, int h, int& tr,
                                             int& tc) const {
    const int blk = wg * MB + i;
    const int br = blk / bw;
    tr = 8 * br + 2 * wq + h;
    tc = 8 * (blk - br * bw) + col;
    return true;
  }
};

// A work item: a th x tw tile of output pixels (th, tw multiples of 8, th *
// tw = 128 * MB) for BN output channels, C_in in chunks of g.ch channels.
// Warps 0-7 are two consumer warpgroups, each MB m64 blocks (8 x 8 output
// pixels) x BN; warps 8-11 the producer warpgroup, one thread of which
// issues the copies. A CTA of 384 threads is budgeted 168 registers a
// thread (65,536 / 384); the producer gives its warpgroup's up (setmaxnreg
// 40) and the consumers take them (232: 128 x 40 + 256 x 232 = 168 x 384),
// so the accumulators and the fold's per-channel factors fit unspilled.
// Stage s of the ring holds chunk c's patch planes then its weight planes,
// all by TMA:
//   patch plane j: channels c*ch + 16j .. + 15 of the tile's input patch,
//     u8 [rows_in][cols_in][16 B] (the 4-D map's box; zero past the padded
//     input and C_in), pitch patch_bytes (a multiple of 128);
//   weight plane j: the same channels of the block's levels, s8 [k*k][BN]
//     [16 B], wplane_bytes each: all of a stage's in one box of the 3-D
//     map over the plane-major levels wp [C_k / 16, k*k, C_out, 16] (8-byte
//     elements, so a box row is a tap's BN * 16 contiguous bytes; zero past
//     C_out and C_in).
// A no-swizzle K-major wgmma operand is core matrices of 8 rows x 16
// contiguous bytes. Eight output pixels of a row are 8 consecutive patch
// pixels of a plane, so tap (di, dj) of the block at tile row r0, column
// c0 is the legal A tile starting at pixel (r0 + di, c0 + dj) of plane 2q
// (k-step q: channels 32q .. 32q + 31), its next 8 rows (the next output
// row) cols_in * 16 bytes on (SBO), its next 16 channels one plane on
// (LBO): the k*k taps are shifted views of one staged patch, each input
// byte read from memory about once. B for tap t is rows t*BN .. of weight
// plane 2q: SBO 128, LBO a weight plane. One wgmma group a stage in flight;
// a stage is released to the producer when the next one's group is
// issued. The grid is at most one CTA an SM, each walking work items
// blockIdx.x, + gridDim.x, ... (a tile's channel blocks fastest, then the
// frame's tiles, then the frames: the mma.sync kernels' CTA order); the
// ring runs on across them, so the producer stages the next item while
// the consumers store this one.
template <int MB, int BN, bool kFold>
__global__ void __launch_bounds__(kWgThreads, 1)
conv_igemm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap,
                        const float* __restrict__ ws,
                        const float* __restrict__ bias,
                        float* __restrict__ out, const Igemm g) {
  constexpr int NT = BN / 8;
  constexpr int CONSUMER_WARPS = kWgConsumerThreads / 32;
  static_assert(!kFold || CONSUMER_WARPS <= kIgFoldRed, "a warp max a slot");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = (unsigned char*)(((uintptr_t)smem + kWgAlign - 1) &
                                         ~(uintptr_t)(kWgAlign - 1));
  uint64_t* full = (uint64_t*)(ring + (size_t)g.stages * g.stage_bytes);
  uint64_t* empty = full + g.stages;
  float* red = (float*)(empty + g.stages);
  // warp-uniform to the compiler (a broadcast): wgmma on a path it cannot
  // prove uniform is serialized
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  const int planes = g.ch >> 4;
  const int n_chunks = (g.c_in + g.ch - 1) / g.ch;
  const int items = g.batch * g.tiles * g.n_blocks;
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    setmaxnreg_dec<40>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      // stage it (the CTA's it-th chunk, items after items) into slot
      // it % stages once the consumers released its previous use
      int it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const IgTile tl(g, BN, item);
        for (int c = 0; c < n_chunks; ++c, ++it) {
          const int slot = it % g.stages;
          if (it >= g.stages) {
            mbar_wait(&empty[slot], ((it / g.stages) - 1) & 1);
          }
          unsigned char* st = ring + (size_t)slot * g.stage_bytes;
          const int np = chunk_planes(g, c);
          mbar_expect_tx(&full[slot],
                         np * g.patch_box + planes * g.wplane_bytes);
          for (int j = 0; j < np; ++j) {
            tma_load_4d(st + j * g.patch_bytes, &xmap, &full[slot],
                        c * g.ch + 16 * j, tl.ow0, tl.oh0, tl.b);
          }
          // the chunk's weight planes in one box: bn rows of 16 bytes a
          // tap and plane, contiguous in the plane-major levels
          tma_load_3d(st + planes * g.patch_bytes, &wmap, &full[slot],
                      2 * tl.n0, 0, c * planes);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int wg = warp >> 2;
  const int wq = warp & 3;
  const int k = g.k;
  const int bw = g.tw >> 3;
  // each m64 block's first patch pixel, in bytes of a plane
  uint32_t a_off[MB];
#pragma unroll
  for (int i = 0; i < MB; ++i) {
    const int blk = wg * MB + i;
    const int br = blk / bw;
    a_off[i] = (uint32_t)((8 * br * g.cols_in + 8 * (blk - br * bw)) * 16);
  }
  const uint64_t da0 = kmajor_desc(g.patch_bytes, g.cols_in * 16);
  const uint64_t db0 = kmajor_desc(g.wplane_bytes, 128);
  const uint32_t ring_s = smem_u32(ring);

  int acc[MB][NT][4];
  // the accumulators stay put across the asynchronous products: no
  // instruction of the compiler's may move them in between
  auto fence_acc = [&] {
#pragma unroll
    for (int i = 0; i < MB; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          asm volatile("" : "+r"(acc[i][j][e]) :: "memory");
  };

  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
#pragma unroll
    for (int i = 0; i < MB; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    for (int c = 0; c < n_chunks; ++c, ++it) {
      const int slot = it % g.stages;
      mbar_wait(&full[slot], (it / g.stages) & 1);
      const uint32_t sa = ring_s + slot * g.stage_bytes;
      const uint32_t sb = sa + planes * g.patch_bytes;
      const int ksteps = chunk_planes(g, c) >> 1;
      fence_acc();
      wgmma_fence();
      for (int di = 0; di < k; ++di) {
        for (int dj = 0; dj < k; ++dj) {
          const uint32_t pa = sa + (di * g.cols_in + dj) * 16;
          const uint32_t pb = sb + (di * k + dj) * BN * 16;
          for (int q = 0; q < ksteps; ++q) {
            const uint64_t db = db0 + ((pb + 2 * q * g.wplane_bytes) >> 4);
            const uint32_t pq = pa + 2 * q * g.patch_bytes;
#pragma unroll
            for (int i = 0; i < MB; ++i) {
              wgmma_u8s8<BN>(acc[i], da0 + ((pq + a_off[i]) >> 4), db);
            }
          }
        }
      }
      wgmma_commit();
      wgmma_wait<1>();            // the previous chunk's products are done
      fence_acc();
      if (c > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % g.stages]);
    }
    wgmma_wait<0>();
    fence_acc();
    // the item's last stage is free: the producer fills it for the next
    // item while this one stores
    if (lane == 0) mbar_arrive(&empty[(it - 1) % g.stages]);
    const IgTile tl(g, BN, item);
    store_tile<MB, NT, 1, kFold>(acc, ws, bias, out, g, tl.b, tl.oh0, tl.ow0,
                                 tl.n0, 0, lane,
                                 BlockSlots<MB>(g, wg, wq, lane), red,
                                 kWgConsumerThreads, item);
  }
}

// The wgmma form's geometry into *g (see conv_igemm_wgmma_kernel), or
// cudaErrorInvalidValue for a shape or configuration it does not take
int wgmma_geometry(Igemm* g, const void* x, int batch, int hp, int wp,
                   int c_in, int c_out, int k, int stride, int th, int tw,
                   int bn, int ch, int stages) {
  const int bad = (int)cudaErrorInvalidValue;
  const int n_chunks = ch > 0 ? (c_in + ch - 1) / ch : 0;
  if (stride != 1 || c_in < 16 || c_in % 16 != 0 || c_out < 1 || k < 1 ||
      k * k > 256 || hp < k || wp < k || batch < 1 || th % 8 != 0 ||
      tw % 8 != 0 || (th * tw != 128 && th * tw != 256) ||
      th + k - 1 > 256 || tw + k - 1 > 256 || (bn != 64 && bn != 128) ||
      (ch != 32 && ch != 64 && ch != 128) || stages < 1 ||
      stages > kWgMaxStages || (n_chunks > 1 && stages < 2) ||
      (uintptr_t)x % 16 != 0 || 255LL * 127 * k * k * c_in >= (1LL << 31)) {
    return bad;
  }
  *g = Igemm{};
  g->hp = hp;
  g->wp = wp;
  g->c_in = c_in;
  g->c_out = c_out;
  g->k = k;
  g->stride = 1;
  g->n_rows = hp - k + 1;
  g->w_out = wp - k + 1;
  g->th = th;
  g->tw = tw;
  g->tiles_w = (g->w_out + tw - 1) / tw;
  g->tiles = (g->n_rows + th - 1) / th * g->tiles_w;
  g->n_blocks = (c_out + bn - 1) / bn;
  g->rows_in = th + k - 1;
  g->cols_in = tw + k - 1;
  g->patch_box = g->rows_in * g->cols_in * 16;
  g->patch_bytes = (g->patch_box + kWgAlign - 1) / kWgAlign * kWgAlign;
  g->wplane_bytes = k * k * bn * 16;
  g->ch = ch;
  g->stages = stages;
  g->batch = batch;
  g->stage_bytes = ch / 16 * (g->patch_bytes + g->wplane_bytes);
  return 0;
}

// the current device's SMs, asked once a device
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess) {
      return 0;
    }
    counts[dev] = n;
  }
  return counts[dev];
}

// dynamic shared memory of a wgmma launch: the alignment's slack, the
// stages, a full and an empty barrier a stage, the fold's warp maxima
size_t wgmma_smem(const Igemm& g) {
  return kWgAlign + (size_t)g.stages * (g.stage_bytes + 16) +
         (g.partials != nullptr ? kIgFoldRed * 4 : 0);
}

// the codes' map: x [B, Hp, Wp, C_in] u8, boxes of 16 channels x the
// patch's cols_in x rows_in pixels of one frame, zero past the input
int codes_map(CUtensorMap* map, const void* x, int batch, const Igemm& g) {
  const cuuint64_t dims[4] = {(cuuint64_t)g.c_in, (cuuint64_t)g.wp,
                              (cuuint64_t)g.hp, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)g.c_in,
                                 (cuuint64_t)g.wp * g.c_in,
                                 (cuuint64_t)g.hp * g.wp * g.c_in};
  const cuuint32_t box[4] = {16, (cuuint32_t)g.cols_in,
                             (cuuint32_t)g.rows_in, 1};
  return encode_int8_map(map, x, 4, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int MB, int BN, bool kFold>
int launch_wgmma_f(const IgLaunch& l, const CUtensorMap& wmap) {
  auto kernel = conv_igemm_wgmma_kernel<MB, BN, kFold>;
  const size_t bytes = wgmma_smem(l.g);
  if (bytes > (size_t)kSmemMax) return (int)cudaErrorInvalidConfiguration;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  alignas(64) CUtensorMap xmap;
  const int merr = codes_map(&xmap, l.x, l.batch, l.g);
  if (merr != 0) return merr;
  const long long items = (long long)l.batch * l.g.tiles * l.g.n_blocks;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  // one CTA an SM (its registers and shared memory), each walking items
  // blockIdx.x, + gridDim.x, ...
  const unsigned grid = (unsigned)(items < sms ? items : sms);
  kernel<<<grid, kWgThreads, bytes, l.stream>>>(
      xmap, wmap, (const float*)l.ws, (const float*)l.bias, (float*)l.out,
      l.g);
  return (int)cudaGetLastError();
}

template <int MB, int BN>
int launch_wgmma_k(const IgLaunch& l, const CUtensorMap& wmap) {
  if (l.g.partials != nullptr) return launch_wgmma_f<MB, BN, true>(l, wmap);
  return launch_wgmma_f<MB, BN, false>(l, wmap);
}

int launch_wgmma(const IgLaunch& l, int bn, const void* wmap_in) {
  if (wmap_in == nullptr) return (int)cudaErrorInvalidValue;
  alignas(64) CUtensorMap wmap;
  memcpy(&wmap, wmap_in, sizeof(wmap));
  const int mb = l.g.th * l.g.tw / 128;
  if (mb == 2) {
    return bn == 128 ? launch_wgmma_k<2, 128>(l, wmap)
                     : launch_wgmma_k<2, 64>(l, wmap);
  }
  return bn == 128 ? launch_wgmma_k<1, 128>(l, wmap)
                   : launch_wgmma_k<1, 64>(l, wmap);
}

}  // namespace

// The levels' tensor map for the wgmma form, written as 128 bytes into
// `map_out`: wp [C_k / 16, taps, C_out, 16] s8, the plane-major levels
// (C_k a multiple of 16, 16-byte aligned), as 8-byte elements: boxes of
// bn output channels (2 * bn elements) x every tap x ch / 16 planes, zero
// past C_out and C_k. Built once with the layout
// (kernels/conv_bank/strip.py::IntWeights), then handed to every launch.
extern "C" int conv_strip_int_tensor_map(void* map_out, const void* wp,
                                         int taps, int c_out, int c_k,
                                         int bn, int ch) {
  if (taps < 1 || taps > 256 || c_out < 1 || c_k < 16 || c_k % 16 != 0 ||
      bn < 8 || bn > 128 || ch < 16 || ch % 16 != 0 || ch > 16 * 256 ||
      (uintptr_t)wp % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cuuint64_t dims[3] = {(cuuint64_t)c_out * 2, (cuuint64_t)taps,
                              (cuuint64_t)c_k / 16};
  const cuuint64_t strides[2] = {(cuuint64_t)c_out * 16,
                                 (cuuint64_t)taps * c_out * 16};
  const cuuint32_t box[3] = {(cuuint32_t)bn * 2, (cuuint32_t)taps,
                             (cuuint32_t)ch / 16};
  alignas(64) CUtensorMap map;
  const int err = encode_map_of(&map, CU_TENSOR_MAP_DATA_TYPE_UINT64, wp, 3,
                                dims, strides, box,
                                CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == 0) memcpy(map_out, &map, sizeof(map));
  return err;
}

// The conv on the wgmma kernel: x [B, Hp, Wp, C_in] u8 codes (C_in a
// multiple of 16, 16-byte aligned; stride 1), `wmap` the plane-major
// levels' map with bn rows and ch / 16 planes (conv_strip_int_tensor_map),
// ws, bias, act_scale and act as
// conv_strip.cu's conv_strip_int_launch. th x tw a multiple of 8 each, 128
// or 256 pixels, bn 64 or 128, ch 32, 64 or 128 channels a stage, 1 to 4
// stages (2 at least over several chunks), as kernels/conv_bank/strip.py::
// igemm_config picks them; anything else, or a shape whose accumulate
// could leave int32 (255 * 127 * k * k * C_in >= 2^31), is refused with
// cudaErrorInvalidValue.
extern "C" int conv_strip_int_wgmma_launch(
    const void* x, const void* wmap, const void* ws, const void* bias,
    void* out, int batch, int hp, int wp, int c_in, int c_out, int k,
    int stride, float act_scale, int act, int th, int tw, int bn, int ch,
    int stages, void* stream) {
  Igemm g;
  const int err = wgmma_geometry(&g, x, batch, hp, wp, c_in, c_out, k,
                                 stride, th, tw, bn, ch, stages);
  if (err != 0) return err;
  g.act_scale = act_scale;
  g.act = act;
  const IgLaunch l{x, nullptr, ws, bias, out, batch, stages, g,
                   (cudaStream_t)stream};
  return launch_wgmma(l, bn, wmap);
}

// The same with the plan's epilogue folded into its store, as
// conv_strip.cu's conv_strip_int_fold_launch: partials [B, tiles *
// n_blocks] each work item's max of y.
extern "C" int conv_strip_int_wgmma_fold_launch(
    const void* x, const void* wmap, const void* ws, const void* bias,
    void* out, void* partials, const void* scale, int scale_n, int ws_n,
    int bias_n, int batch, int hp, int wp, int c_in, int c_out, int k,
    int stride, int act, int th, int tw, int bn, int ch, int stages,
    void* stream) {
  Igemm g;
  const int err = wgmma_geometry(&g, x, batch, hp, wp, c_in, c_out, k,
                                 stride, th, tw, bn, ch, stages);
  if (err != 0) return err;
  if (!fold_args_ok(ws, bias, partials, scale, scale_n, ws_n, bias_n, batch,
                    c_out, act)) {
    return (int)cudaErrorInvalidValue;
  }
  set_fold(&g, act, scale, partials, scale_n, ws_n, bias_n);
  const IgLaunch l{x, nullptr, ws, bias, out, batch, stages, g,
                   (cudaStream_t)stream};
  return launch_wgmma(l, bn, wmap);
}
