// Fused conv chain: a whole segment of convs in one launch, a thread-block
// cluster per frame. Hopper (sm_90a) port of the TPU kernel
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
//   amax = max of y over the whole frame         -- the stage barrier
//   scale' = __fdiv_rn(fmaxf(amax, 1e-8f), aq)
//   code = min(max(rintf(__fdiv_rn(y, scale')), 0), 15)   (half to even)
// which is ref.conv_chain_ref and the unfused per-layer epilogue op for op.
// No step is left to nvcc's FMA contraction: every rounding is an explicit
// _rn intrinsic. The accumulate is exact in any order: its operands are
// integers and a_qmax * max|level| * k*k*c_in/groups < 2^24, which the
// wrapper (fused.check_exact) checks for every stage before it launches,
// bounds every partial sum, however it is split.
//
// What bounds it on an H100: neither bytes nor flops. A frame is read and
// its codes written once (tens of KB per batch), and LeNet's segment is a
// few MFLOP a frame. Latency is the limit: the first design ran one block
// per frame (8 of 132 SMs at batch 8), read every weight from device
// memory inside a single dependent FMA chain per output, recomputed every
// index with divisions, and left half of its threads idle on LeNet's 400
// conv2 outputs.
//
// This design:
//   * a cluster of `n` CTAs per frame (cudaLaunchKernelEx with a cluster
//     dimension; n = 8, the portable size, from fused.py::chain_config), so
//     the grid is batch x n. Every CTA holds the whole inter-stage frames
//     (two ping-pong buffers, as before), and CTA r computes a contiguous
//     range of each stage's pooled outputs: a pool window is never split,
//     so the avg pool's row-major sum stays in one thread;
//   * the exchange between stages goes through distributed shared memory:
//     each CTA writes its range's max into a slot of every peer's shared
//     memory, and after cluster.sync() every CTA takes the max of the n
//     slots (max is exact and order-free, so the scale is the one block's
//     scale bit for bit); each CTA then requantizes its range and writes
//     the codes into every peer's next-stage buffer, and a second
//     cluster.sync() publishes the next stage's input. The last stage
//     writes its range to device memory;
//   * the conv sums of one pooled output are independent chains, one per
//     window position (up to kChains at once), and `split` lanes share one
//     output's reduction over k*k*c_in (as many as a CTA's 512 threads
//     allow), adding their exact partial sums with warp shuffles;
//   * each stage's weights, ws and bias are staged into shared memory once,
//     by cp.async, where they fit beside the frames (chain_config places
//     them stage by stage); a stage whose weights do not fit reads them from
//     device memory, so every segment the fusion rule admits still runs;
//   * the tap loop only adds and compares: the wrapper computes each
//     stage's steps of the reduction index, the frame offset and the output
//     index (fused.py::_set_steps), and padding is two unsigned compares a
//     window position (a zero tap adds nothing to the exact sum).
// Where the time goes (clock64 stamps of one CTA in a diagnostic build,
// LeNet at batch 8): most in the two tap loops, the rest in the frame and
// weight copies and the four cluster barriers with their DSMEM exchanges.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxStages = 16;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kChains = 4;       // window positions summed at once

struct Stage {
  const float* w;      // [k, k, c_in / groups, c_out] HWIO levels
  const float* ws;     // [c_out] weight scales
  const float* bias;   // [c_out] or null
  int h_in, w_in, c_in, c_out, k, stride, pad_top, pad_left;
  int h_out, w_out;    // after pooling
  int pool_kind;       // 0 none, 1 max, 2 avg
  int pool_size;       // 1 without pooling
  int depthwise, act, has_bias;
  int split;           // lanes sharing one output's reduction: 1..32, 2^i
  int w_off;           // floats: staged w, ws, bias in shared memory, or -1
  // the reduction index r = (di * k + dj) * cin_g + ci advanced by `split`:
  // its steps in ci, dj and di, and in the frame offset
  // xo = (di * w_in + dj) * c_in (+ ci when dense); a wrap of dj adds
  // wrap_xo to xo (a wrap of ci leaves it as it is)
  int step_ci, step_dj, step_di, step_xo, wrap_xo;
  // a thread's next output, kThreads / split outputs on: the steps in co,
  // pw and ph
  int d_co, d_pw, d_ph;
};

// shared memory, offsets in floats: buffer 0 (even inter-stage frames),
// buffer 1 (odd ones), 32 floats of scratch (kMaxCluster cluster slots,
// then kWarps warp maxima), then the staged weights of the stages that have
// a w_off. Stage descriptors are copied by value into registers before use:
// read by reference, their fields were reloaded from the parameter bank in
// every iteration of the tap loop.
struct Chain {
  int n_stages;
  int buf1_offset;
  int red_offset;
  int in_elems;
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(gmem));
}

__device__ __forceinline__ void copy_floats(float* dst, const float* src,
                                            int n, int tid) {
  for (int i = tid; i < n; i += kThreads) cp_async4(dst + i, src + i);
}

// One stage's pooled outputs lo..hi-1 of the frame x (shared memory) into
// y, pre-quantization; returns their max (0 where the range is empty).
// kStagedW: w, ws and bias lie in shared memory, else in device memory.
template <bool kStagedW>
__device__ __forceinline__ float stage_outputs(
    const Stage& s, const float* x, float* y, const float* w,
    const float* ws, const float* bias, float scale, int lo, int hi,
    int tid) {
  auto load = [](const float* p) { return kStagedW ? *p : __ldg(p); };
  const int S = s.split;
  const int part = tid & (S - 1);
  const int p = s.pool_size;
  const int pp = p * p;
  const int cin_g = s.depthwise ? 1 : s.c_in;
  const int fan = s.k * s.k * cin_g;
  const int wstep = S * s.c_out;
  // this lane's first reduction index
  const int tap0 = part / cin_g;
  const int ci0 = part - tap0 * cin_g;
  const int di0 = tap0 / s.k;
  const int dj0 = tap0 - di0 * s.k;
  const int xo0 = (di0 * s.w_in + dj0) * s.c_in + (s.depthwise ? 0 : ci0);
  // this thread's first output (co fastest, then pw, then ph)
  int o = lo + (tid >> (__ffs(S) - 1));
  int co = o % s.c_out;
  int t = o / s.c_out;
  int pw = t % s.w_out;
  int ph = t / s.w_out;

  float local_max = 0.0f;             // every y is >= 0 after the clamp
  for (int base = lo; base < hi; base += kThreads / S) {
    // the S lanes of an output are live or dead together; dead groups skip
    // the output, and the live ones shuffle among themselves
    const bool live = o < hi;
    const unsigned live_lanes = __ballot_sync(0xffffffffu, live);
    if (live) {
      const float wscale = __fmul_rn(scale, load(ws + co));
      const float b_co = s.has_bias ? load(bias + co) : 0.0f;
      const float* wp0 = w + co + part * s.c_out;
      const float* xc = x + (s.depthwise ? co : 0);
      float pooled = 0.0f;
      int pi = 0, pj = 0;               // the window position of chain 0
      for (int q0 = 0; q0 < pp; q0 += kChains) {
        // per chain: the frame offset of its window's corner, and the taps
        // (di in rlo .. rlo+rn-1, dj in clo .. clo+cn-1) inside the frame
        int xq[kChains], rlo[kChains], rn[kChains], clo[kChains], cn[kChains];
        bool inside = true;             // every window wholly in the frame
  #pragma unroll
        for (int q = 0; q < kChains; ++q) {
          const int ih = (ph * p + pi) * s.stride - s.pad_top;
          const int iw = (pw * p + pj) * s.stride - s.pad_left;
          const bool used = q0 + q < pp;
          rlo[q] = max(0, -ih);
          rn[q] = used ? max(0, min(s.k, s.h_in - ih) - rlo[q]) : 0;
          clo[q] = max(0, -iw);
          cn[q] = max(0, min(s.k, s.w_in - iw) - clo[q]);
          // a window position past the pool reads chain 0's window
          xq[q] = used ? (ih * s.w_in + iw) * s.c_in : xq[0];
          inside = inside && (!used || (rn[q] == s.k && cn[q] == s.k));
          if (++pj == p) { pj = 0; ++pi; }
        }
        float acc[kChains] = {0.0f, 0.0f, 0.0f, 0.0f};
        int di = di0, dj = dj0, ci = ci0, xo = xo0;
        const float* wp = wp0;
        if (inside) {
  #pragma unroll 2
          for (int r = part; r < fan; r += S) {
            const float wv = load(wp);
  #pragma unroll
            for (int q = 0; q < kChains; ++q) {
              acc[q] = fmaf(xc[xq[q] + xo], wv, acc[q]);
            }
            wp += wstep;
            ci += s.step_ci;
            dj += s.step_dj;
            xo += s.step_xo;
            if (ci >= cin_g) { ci -= cin_g; ++dj; }
            if (dj >= s.k) { dj -= s.k; xo += s.wrap_xo; }
          }
        } else {
  #pragma unroll 2
          for (int r = part; r < fan; r += S) {
            const float wv = load(wp);
  #pragma unroll
            for (int q = 0; q < kChains; ++q) {
              // zero outside the frame: 0 * level adds nothing to an exact
              // integer sum that starts at +0
              const bool in = (unsigned)(di - rlo[q]) < (unsigned)rn[q] &&
                              (unsigned)(dj - clo[q]) < (unsigned)cn[q];
              const float xv = in ? xc[xq[q] + xo] : 0.0f;
              acc[q] = fmaf(xv, wv, acc[q]);
            }
            wp += wstep;
            ci += s.step_ci;
            dj += s.step_dj;
            di += s.step_di;
            xo += s.step_xo;
            if (ci >= cin_g) { ci -= cin_g; ++dj; }
            if (dj >= s.k) { dj -= s.k; ++di; xo += s.wrap_xo; }
          }
        }
        // the S lanes' partial sums: exact integers, any order
        for (int off = S >> 1; off > 0; off >>= 1) {
  #pragma unroll
          for (int q = 0; q < kChains; ++q) {
            acc[q] += __shfl_xor_sync(live_lanes, acc[q], off);
          }
        }
        // window positions in row-major order, as the reference pools
  #pragma unroll
        for (int q = 0; q < kChains; ++q) {
          const int pos = q0 + q;
          if (pos >= pp) break;
          float v = __fmul_rn(acc[q], wscale);
          if (s.has_bias) v = __fadd_rn(v, b_co);
          v = activate(v, s.act);
          if (s.pool_kind == 1) {
            pooled = pos == 0 ? v : fmaxf(pooled, v);
          } else if (s.pool_kind == 2) {
            pooled = __fadd_rn(pooled, v);      // row-major, from 0
          } else {
            pooled = v;
          }
        }
      }
      if (s.pool_kind == 2) pooled = __fdiv_rn(pooled, (float)pp);
      pooled = fmaxf(pooled, 0.0f);
      if (part == 0) {
        y[o] = pooled;
        local_max = fmaxf(local_max, pooled);
      }
    }
    o += kThreads / S;
    co += s.d_co;
    if (co >= s.c_out) { co -= s.c_out; ++pw; }
    pw += s.d_pw;
    if (pw >= s.w_out) { pw -= s.w_out; ++ph; }
    ph += s.d_ph;
  }
  return local_max;
}

__global__ void __launch_bounds__(kThreads)
conv_chain_kernel(const float* __restrict__ codes,
                  const float* __restrict__ scale_in, float aq,
                  float* __restrict__ out, float* __restrict__ scale_out,
                  const Chain chain) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  float* slots = smem + chain.red_offset;     // [kMaxCluster]
  float* wmax = slots + kMaxCluster;          // [kWarps]

  float scale = scale_in[b];
  // the frame's codes (every CTA of the cluster holds the whole frame) and
  // the staged weights, all in flight at once
  const float* src = codes + (size_t)b * chain.in_elems;
  if (((uintptr_t)src & 15) == 0) {
    const int quads = chain.in_elems >> 2;
    for (int i = tid; i < quads; i += kThreads) {
      cp_async16(smem + 4 * i, src + 4 * i);
    }
    for (int i = 4 * quads + tid; i < chain.in_elems; i += kThreads) {
      cp_async4(smem + i, src + i);
    }
  } else {
    copy_floats(smem, src, chain.in_elems, tid);
  }
  for (int si = 0; si < chain.n_stages; ++si) {
    const Stage& s = chain.st[si];
    if (s.w_off < 0) continue;
    const int nw = s.k * s.k * (s.depthwise ? 1 : s.c_in) * s.c_out;
    float* dst = smem + s.w_off;
    copy_floats(dst, s.w, nw, tid);
    copy_floats(dst + nw, s.ws, s.c_out, tid);
    if (s.has_bias) copy_floats(dst + nw + s.c_out, s.bias, s.c_out, tid);
  }
  asm volatile("cp.async.wait_all;\n" ::);
  // every CTA of the cluster runs (its shared memory may be written) and
  // the copies have landed
  cluster.sync();

  for (int si = 0; si < chain.n_stages; ++si) {
    // by value: the fields live in registers, not reloaded from the
    // parameter bank inside the tap loop
    const Stage s = chain.st[si];
    const float* x = smem + ((si & 1) ? chain.buf1_offset : 0);
    float* y = smem + ((si & 1) ? 0 : chain.buf1_offset);
    const int n_out = s.h_out * s.w_out * s.c_out;
    // this CTA's range (n_out * n < 2^31: a frame fits shared memory)
    const int lo = n_out * rank / n;
    const int hi = n_out * (rank + 1) / n;
    float local_max;
    if (s.w_off >= 0) {
      const int nw = s.k * s.k * (s.depthwise ? 1 : s.c_in) * s.c_out;
      const float* w = smem + s.w_off;
      local_max = stage_outputs<true>(s, x, y, w, w + nw, w + nw + s.c_out,
                                      scale, lo, hi, tid);
    } else {
      local_max = stage_outputs<false>(s, x, y, s.w, s.ws, s.bias, scale, lo,
                                       hi, tid);
    }

    // the frame's max: warp, then CTA, then one slot per CTA in every
    // peer's shared memory
    for (int off = 16; off > 0; off >>= 1) {
      local_max = fmaxf(local_max,
                        __shfl_xor_sync(0xffffffffu, local_max, off));
    }
    if (lane == 0) wmax[tid >> 5] = local_max;
    __syncthreads();
    if (tid < n) {
      float m = wmax[0];
#pragma unroll
      for (int i = 1; i < kWarps; ++i) m = fmaxf(m, wmax[i]);
      cluster.map_shared_rank(slots, tid)[rank] = m;
    }
    cluster.sync();
    float amax = slots[0];
    for (int i = 1; i < n; ++i) amax = fmaxf(amax, slots[i]);
    scale = __fdiv_rn(fmaxf(amax, 1e-8f), aq);

    const bool last = si == chain.n_stages - 1;
    for (int i = lo + tid; i < hi; i += kThreads) {
      const float q = fminf(fmaxf(rintf(__fdiv_rn(y[i], scale)), 0.0f),
                            15.0f);
      if (last) {
        out[(size_t)b * n_out + i] = q;
      } else {
        for (int r = 0; r < n; ++r) cluster.map_shared_rank(y, r)[i] = q;
      }
    }
    // the next stage's input is whole in every CTA; no CTA touches a
    // peer's shared memory after the last stage's slots
    if (!last) cluster.sync();
  }
  if (rank == 0 && tid == 0) scale_out[b] = scale;
}

// A launch of `ctas` CTAs in clusters of `cluster` with `smem_bytes` of
// dynamic shared memory each (opted into above 48 KB); `attr` holds the
// cluster dimension and must outlive the returned config.
cudaError_t launch_config(int ctas, int cluster, int smem_bytes,
                          cudaStream_t stream, cudaLaunchAttribute* attr,
                          cudaLaunchConfig_t* cfg) {
  if (cluster < 1 || cluster > kMaxCluster) return cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(ctas);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem_bytes;
  cfg->stream = stream;
  *attr = cudaLaunchAttribute{};
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// codes [batch, in_elems] and scale_in [batch] float32; out [batch, last
// stage's pooled frame], scale_out [batch]. `chain` is the Chain the
// wrapper (kernels/conv_bank/fused.py) lays out; `cluster` CTAs a frame
// (1..8) and `smem_bytes` of dynamic shared memory, both from
// fused.py::chain_config.
extern "C" int conv_chain_launch(const void* codes, const void* scale_in,
                                 float aq, void* out, void* scale_out,
                                 const void* chain, int batch, int cluster,
                                 int smem_bytes, void* stream) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = launch_config(batch * cluster, cluster, smem_bytes,
                                  (cudaStream_t)stream, &attr, &cfg);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(
      &cfg, conv_chain_kernel, (const float*)codes, (const float*)scale_in,
      aq, (float*)out, (float*)scale_out, *(const Chain*)chain);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` CTAs with `smem_bytes` each the card can
// hold at once (cudaOccupancyMaxActiveClusters), into *active.
extern "C" int conv_chain_max_active_clusters(int cluster, int smem_bytes,
                                              int* active) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = launch_config(cluster, cluster, smem_bytes, nullptr,
                                  &attr, &cfg);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(active, conv_chain_kernel, &cfg);
}
