#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100, sm_90a).

    python3 chip_smoke.py              # on a machine with the card
    python3 chip_smoke.py --rehearse   # the same phases on the CPU, with the
                                       # kernels' plain versions; exits 2
    python3 chip_smoke.py --details PATH   # where the detail JSON goes
                                           # (default build/chip_smoke.json)
    python3 chip_smoke.py --reread DIR     # re-read the profiler traces a
                                           # run left in DIR; no card

The main paths, each with the kernel launch counts zeroed just before it
runs and read just after (all but the LM through ``serve.Server``):

  vision   LeNet (28x28x1) and VGG9-CA (32x32x3), full width, seeded random
           weights from numpy, W4A4: 32 mixed requests of 1-8 frames;
  imaging  the eight imaging pipelines at 256x256x3 (their fixed filter
           weights), W4A4: 3 requests of 1, 3 and 8 frames each;
  chain    the reference's acceptance chain denoise_gauss -> edge_detect
           -> sharpen at 256x256x3 as one program (``Program.then``): 3
           requests of 1, 3 and 8 frames;
  vgg16    VGG16 at 224x224x3, full width, seeded random weights from
           numpy, W4A4: 3 requests of 1, 3 and 8 frames, eager and bound
           (conv1-conv10 on the int8 strip kernel, ``conv_strip_int``);
  eager    LightatorDevice.run at bucket 8 (per-tensor calibration,
           ``plan._execute``): LeNet under W4A4, W3A4 and MX_43, VGG9-CA
           and VGG16 at 224x224x3, the vision paths' seeded weights;
  train    LeNet and VGG9-CA (full width) QAT-trained on the card under
           W4A4, their weights evaluated with the dense layers on
           photonic_mvm's float API and run per frame (eager), then served
           bound: 3 requests of 1, 3 and 8 held-out frames each;
  lm       tinyllama-1.1b and mamba2-1.3b at full width and depth, greedy
           decoding at batch 4 (``models/lm.py``; no port kernel on it);
  moe      grok-1-314b and kimi-k2-1t-a32b at full width, cut in depth
           (``MOE_RUNS``), greedy decoding at batch 4 (``models/lm.py``'s
           moe family over ``nn/moe.py``; no port kernel on it);
  lm_train smollm-360m at full width and depth trained through
           ``launch/train.py`` (quant none and W4A4, the restart drill) and
           the 100M example (no port kernel on it).
  roofline smollm-360m's [lm_train] step dry-run on a fake group of one
           rank, the roofline over [dist]'s dry-run records and the
           hillclimb's yi-decode variants at 32x8 (``launch/dryrun.py``,
           ``roofline.py``, ``hillclimb.py``; host processes, no port
           kernel and no card on it).

Phases, each fatal on failure:

  1. device: the card's name and count, and ``nvidia-smi``'s name and
     power limit;
  2. build: ``nvcc`` compiles every kernel from ``src/repro_torch/csrc``
     (one process per source, all at once);
  3. kernels: each kernel's wrapper runs on the card at the shapes the two
     paths give it at bucket 8, plus extra shapes (the edge lists of
     ``kernels/edge_shapes.py``: ragged GEMMs, strip tiles, depthwise
     tiles, fused chains and every ca_pool route; random chains,
     edge_detect's fused segment at 64x64, the 512x512 multi-strip
     geometries, a stride-2 VALID and a grouped conv, a VGG16-like layer,
     the conv_bank op in both strategies at k = 3, 5, 7; the int8 strip
     kernel at every strip edge on codes 0..255 and levels +-127 at every
     activation, at its extremes with |acc| past 2^24, its wgmma form
     forced at ``INT_WGMMA_EDGES`` (raw, every activation with and without bias, the
     folded store under both calibrations; C_in 7,360 at the int32
     edge), and through
     dispatch on a conv1-like, a stride-2 and a grouped conv; the dense
     float kernel's tensor-core form with every launch it takes forced at
     ``F64MMA_EDGES`` and the conv_bank op's calls at batches 8 and 1,
     bitwise on integer operands at every activation, within 1e-5 on
     float ones; ``strip_config``'s edges on the CUDA-core form, forced),
     and is held
     bitwise equal to its plain PyTorch version on the same inputs (the
     served path's ``ca_pool.ops.acquire``, and the public ``ca_pool`` op
     with a signed bank of its own on every weighted route's edges, in
     float32 and bfloat16, against ``ca_pool_ref_generic``; the executor's
     epilogue, in the form ``epilogue_config`` picks (the one-launch
     cluster per frame, the pair per tensor), at every requant of one
     per-frame run of each program and at ``EPILOGUE_EDGES``, codes and
     scale, per frame and per tensor). The
     conv_bank op, which no served path reaches, is driven once on its own
     with the counts zeroed around it, at its calls and at the narrow one
     (``CONV_BANK_NARROW``), in both strategies: quantized (the int8
     kernel, where ``strip.dense_route`` sends its shapes) and in float
     mode (the float kernel's tensor-core form where ``strip.dense_form``
     gives it, its ``conv_strip_f64mma`` count; the narrow call on the
     CUDA-core form over the whole frame, its ``conv_bank`` count), each
     counter held to the launches the rules give;
  4. timing: each kernel at its path shapes (the conv_bank op at its own;
     the epilogue at every requant of the two paths, and its device time
     there in each form it can take: the pair and clusters of 4, 8 and
     16 CTAs a frame, the ``[epilogue form]`` lines),
     beside its plain version, one library call as a yardstick where
     PyTorch has one (with TF32 off, and whether its answer was exact), the
     profiler's device time, the launch configuration (the chain kernel's
     cluster and CTAs, the depthwise kernel's tile, run, channel block and
     CTAs, ca_pool's route, run, threads and CTAs, the CTAs of the others),
     one ca_pool p = 1 call with the L2 cache flushed before each launch
     (``ca_pool.cold``; the path's calls find their input in L2), and the
     least time the card could take (bytes over 3.35 TB/s, operations over
     the dense tensor-core peak for their type: int8 for integer MACs,
     TF32 for ca_pool's float MACs, FP64 for the conv_bank op's float
     mode); the device times come from one
     profiler session, written as a Chrome trace beside the details file,
     with a range per path shape of photonic_mvm, the strip convs and
     ca_pool (kernel and library call). Then the route rule's numbers
     (``[route]`` lines): at each dense strip conv of the imaging path and
     each quantized call of the conv_bank op, the device time of the
     float64 route and of the int8 one from the same codes (each held
     equal to the other), beside what ``strip.dense_route`` picks; and at
     each of the op's float calls at batches 8 and 1 the float kernel's
     two forms, forced, beside ``F.conv2d`` (TF32 off) and the bound at
     the FP64 tensor rate, with what ``strip.dense_form`` picks. Each
     strip kernel's and the op's library call also by its device time;
  5. serve, eager: vision and imaging through each program's unbound
     executable (the ``Hooks.execute`` seam: eager ``run_padded``,
     pageable copies), every answer finite, of the right shape and bitwise
     equal to batch-1 ``run_per_frame`` on the card, to the reference
     backend on the card and to the port's CPU run on the first frames;
     every kernel of a path must have launched in it. The imaging answers'
     PSNR against the float oracle ``apply_float`` is printed, and the
     imaging burst is served once more under the profiler for the device's
     busy share (device ms by kind, by port kernel, and the 8 torch ops
     with the most device time by kernel symbol);
  6. serve, bound: all three paths behind one Server with ``devices=1``,
     ``max_inflight=2``, through ``Executable.bind`` views (own stream,
     pinned staging ring, one CUDA graph per bucket, captured at start),
     each path in its own window: answers held as in 5, each window's
     launch counts equal to what the graph replays credited (every kernel
     of the path launched), three batches of different content in flight
     on one bound view each giving its own answers; the imaging burst's
     busy share again, bound;
  7. load: LeNet, VGG9-CA, edge_detect, compress_recon and the chain,
     bound and eager: ``loadgen.saturate`` frames/s (single-frame
     requests, ~2 s) and ``loadgen.poisson_load`` p50/p99 at half the
     bound path's saturation rate (~2 s);
  8. obs: LeNet, VGG9-CA and edge_detect behind one bound server with a
     ``Trace`` enabled and the admin endpoint up: answers bitwise as in 5;
     the exported trace passes ``scripts/check_trace.py --min-devices 1``
     (run as a subprocess); ``/healthz`` ``/readyz`` ``/metrics``
     ``/statusz`` (JSON and text) answer 200, ``/metrics`` has each
     program's ``serve_`` lines, ``/tracez`` passes ``--flight``; LeNet's
     tight SLO (``p99_ms=0.001``) is breached, counted, logged and dumped,
     an injected ``WorkerError`` dumps, both dumps pass ``--flight
     --require-trigger``. The bound imaging burst once more under the
     profiler and a ``Trace``: the ``serve.device.execute`` spans sum to
     at least the card's busy time. Then what observability costs:
     ``loadgen.saturate`` frames/s of LeNet and edge_detect, bound, under
     A (no recorder), B (the default recorder), C (recorder + ``Trace``)
     and D (recorder, admin endpoint polled every 100 ms), in the order
     A B C D D C B A in one call (``[obs]`` lines: frames/s, the ratio to
     A, the recorder's records per request).
  9. vgg16: VGG16 compiled under W4A4 and MX_43 with ``Options(verify=
     "on")``, each report clean, the per-step accumulator headroom printed
     and the ``plan.verify`` span's time on the cold compile; the strip and
     photonic_mvm kernels bitwise equal to their plain versions at every
     distinct VGG16 shape (``edge_shapes.VGG16_SHAPES``) at buckets 1 and
     8, and the epilogue at every requant of VGG16's run at both (conv1-
     conv10's folded into the int8 conv's store, against the unfolded
     plain sequence); the eager window's epilogue launches by form (ten
     folds a batch, the other seven calls in ``epilogue_config``'s form);
     served eager and bound (``devices=1``, ``max_inflight=2``), every
     answer bitwise equal to batch-1 ``run_per_frame``, the reference
     backend on the card and the port's CPU run on the first 2 frames, the
     bound window's launch counts equal to the replays' credits; each conv
     and dense step timed at bucket 8 beside its plain version, its
     library call and its bound (each strip step also forced resident,
     and on the float64 strip kernel: per layer the int8 route's device
     ms -- cast, pad, weight layout and kernel -- beside the kernel's, the
     float64 kernel's, ``F.conv2d``'s, forced resident's and the bound,
     with the instantiation's ptxas registers, shared memory and spills;
     each photonic_mvm step on its levels laid out once, with its route,
     tile, CTAs, shared memory and ptxas line); the bound view's
     photonic_mvm levels checked laid out at bind;
     the int8 strip kernel's two forms at conv2-conv10 (and, for
     information, conv11-13 forced onto it, and the conv_bank op's calls:
     ``INT_FORM_SHAPES``) at buckets 1 and 8, each forced, by device time beside ``F.conv2d`` and the bound, with each
     form's launch and ptxas line (``[vgg16] int8 forms`` lines, and per
     bucket the shapes the rule gives the wgmma form where it is slower);
     each conv1-conv10 also with the epilogue folded into its store; each
     of its 17 epilogue calls (pass 2 alone after a folded store) timed
     beside the torch-op sequence it replaces (its plain version) and its
     bound, the others also per tensor as the pair (``[vgg16] epilogue``
     lines: pass 2, the cluster calls
     and the int8 strip kernels' increase with the folded store); the
     bound window's device busy share (its torch ops named)
     and a short saturation run's frames/s (``[vgg16]`` lines).
 10. train: photonic_mvm's float API on signed CRC codes held bitwise to
     ``photonic_mvm_ref`` at ``edge_shapes.SIGNED_MVM_SHAPES`` (every
     route); LeNet QAT-trained 40 steps at batch 64
     under fp32, W4A4, W3A4, W2A4 and MX_43, and VGG9-CA at full width 10
     steps under W4A4 (``launch/train_vision.py``), each fatal unless
     every loss is finite and the last below the first, with the step
     times (CUDA events) and the held-out accuracy of the QAT forward;
     the main path (counts zeroed before, read after): both W4A4 models
     evaluated with their dense layers on ``nn.layers.dense(mode=
     "kernel")`` (the float API; each output then held bitwise to
     ``photonic_mvm_ref`` on the same input) and run per frame, then
     served bound (3 requests of 1, 3 and 8 frames each),
     every answer bitwise equal to batch-1 ``run_per_frame``, the
     reference backend and the port's CPU run, served accuracy beside the
     QAT forward's; 5 more W4A4 steps of each model under the profiler
     (the device's busy share of the window, kernels a step, the top
     kernels by device time); the float API timed on the evaluation's
     dense inputs;
     ``fit_recon_head`` on the card at 32x32x3, PSNR before and after
     (``[train]`` lines).
 11. lm: the LM families served by ``models/lm.py::greedy_generate``
     (batch 4, an 8-token prompt from numpy, 24 tokens generated; no port
     kernel is on this path, as no Pallas kernel is in the reference's:
     the launch counts of the main path must stay 0). tinyllama-1.1b
     (22 layers) and mamba2-1.3b (48 layers) at their published width and
     depth, bf16, seeded weights from ``init_lm`` on the card, under quant
     none, W4A4 fake-quant and ``quantize_lm_params`` W4A4 storage: tokens
     identical over two runs, every logit finite, the prefill's logits
     against the stepped decode's, held to the reference test's rtol =
     atol = 5e-2 on a float32 copy of the weights in every mode and in
     bf16 under W4A4 (printed in bf16 under none and storage, where bf16
     rounding over full depth exceeds it as the reference's does); under
     W4A4 the decode replays the prefill's activation codes (``ActTape``),
     and the codes it would have taken itself are counted, each
     activation held within ``LM_TIE`` code steps of the prefill's,
     ms a decode step (CUDA events, median of the generated steps),
     tokens/s, kernels a step and the device busy share of a profiled
     5-step window, peak memory. Then the card against the CPU port,
     float32, TF32 off, weights made once and carried through numpy: both
     configs at full width with 2 layers, and the smoke variants of
     smollm, stablelm, hymba (ring cache), hubert (forward only) and
     internvl2 (patch frontend): every step's logits within 1e-4 of their
     largest, greedy tokens equal wherever the CPU's top-2 margin exceeds
     that; the two full-width configs also under W4A4, the card replaying
     the CPU's activation codes, each activation within ``LM_TIE``
     (float32) code steps of the CPU's (``[lm]`` lines).
 12. moe: the MoE family served by ``greedy_generate`` (batch 4, an
     8-token prompt, 24 generated; launch counts of the main path must
     stay 0): grok-1-314b at full width (d 6144, 8 experts of d_ff 32768,
     vocab 131072) with 4 of its 64 layers under quant none and W4A4
     storage and 2 under the W4A4 fake-quant, and kimi-k2-1t-a32b at full
     width (d 7168, 384 experts of d_ff 2048, top-8, vocab 163840) with 1
     of its 61 layers under none and storage, bf16, seeded weights from
     ``init_lm`` on the card, the FULL configs' grouped dispatch; storage
     quantizes expert by expert and then drops the float tree. Each run:
     tokens identical over two runs, logits finite, ms a decode step,
     tokens/s, kernels a step and busy share of a profiled 5-step window,
     peak memory, the prompt's forward's dropped fraction, and its logits
     against the stepped decode's, held to 5e-2 only where the two paths
     compute the same function (nothing dropped, every token routed to
     the same experts, no W4A4 codes), printed otherwise. The combine
     casts (float8_e4m3fn, bfloat16) bitwise on the card and the CPU.
     Then the card against the CPU port, float32, TF32 off: the smoke
     variants of both under the sorted and grouped dispatches and quant
     none, W4A4 (the card replaying the CPU's codes) and storage, and
     grok-1 at full width with 1 layer (batch 2, 4 prompt and 4 generated
     tokens; the host RAM printed first): logits within 1e-4 of their
     largest, the dropped fractions and the expert indices of every
     routing equal, greedy tokens equal wherever the CPU's margin exceeds
     1e-4 (``[moe]`` lines).

 13. lm_train: the LM trained through ``launch/train.py`` (its wiring:
     ``init_lm`` seeded, AdamW, ``steps.make_train_step``, the
     planted-bigram stream, ``CheckpointManager(keep=2)``,
     ``RestartableLoop``, ``StragglerMonitor``, ``FailureInjector``; no port
     kernel is on this path, as no Pallas kernel is in the reference's:
     the launch counts of the main path must stay 0): smollm-360m at full
     width and depth (32 layers, d 960, vocab 49152, remat full), bf16
     params with a float32 master, batch 8, seq 128, seed 0; quant none 30
     steps and the W4A4 fake-quant 10 steps: every loss finite, the none
     run's CE falling; ms a step (CUDA events, median after 2 warm-up
     steps), tokens/s, peak memory, loss and CE first -> last, grad norm,
     and kernels a step and the busy share of 3 more steps under the
     profiler (the window ends when the card is done). The restart drill:
     20 steps with ``--ckpt-every 10 --fail-at 12``, then the restart,
     which resumes from step 10; its losses at steps 10-19 and every leaf
     of its state at step 20 bitwise equal to the none run's (the
     uninterrupted run, its step-20 checkpoint restored: the continuation
     and the round trip at once; both runs under
     ``torch.use_deterministic_algorithms``, set around them and restored
     after; an op with no deterministic CUDA path is named and fails the
     phase). ``examples/train_lm_100m`` (82M params) 100 steps:
     the last-10 mean CE below the first-10. Then the card against the
     CPU port, float32, TF32 off, 3 train steps from one set of weights:
     the smoke variants of smollm, mamba2, hymba, grok-1 (sorted and
     grouped), hubert and internvl2, and smollm-360m at full width cut to
     2 layers: losses and grad norms within 1e-4 relative, every leaf of
     the params and AdamW state within 1e-4 of its largest, or (named)
     within 0.5 lr with at most 1% of its entries past 1e-4
     (``[lm_train]`` lines).
 14. dist: the distributed path (``[dist]`` lines). a. [lm_train]'s
     configuration, 5 steps through ``launch/train.py`` on an ``nccl``
     process group of one rank and a (1, 1) DeviceMesh, every param a
     DTensor, under deterministic algorithms: the losses against
     [lm_train]'s first five (bitwise, else within 1e-6 relative, printed
     which), ms a step, kernels a step and busy share as [lm_train]'s;
     the layers recomputed a step (``remat.recompute``, fatal unless
     [lm_train]'s), peak memory and the kernels a step by name against
     [lm_train]'s, both profiled under deterministic algorithms.
     b. The multi-rank checks of ``distributed/checks.py`` in spawned gloo
     worlds of 2, 4 and 1 ranks (one card: NCCL refuses two ranks on
     it), each check's tensors on cuda:0 where gloo moves CUDA tensors
     for all its collectives (all_reduce: the compressed all-reduce), on
     the CPU elsewhere, decided per check and printed: TP+DP and FSDP+TP
     train steps (2x2) against the unsharded step, the MoE's
     expert-parallel block (1x2; 2x1 under FSDP) against its fallback,
     the compressed all-reduce bitwise, GPipe (S = 4, M = 4 and 8)
     against the sequential loop, a checkpoint saved at world 2 restored
     bitwise at worlds 4 and 1, and the data pipeline's rank slices.
     c. ``Options(shard_batch=True, mesh=("cuda:0", "cuda:0"))``:
     LeNet, VGG9-CA, compress_recon_deconv and denoise_gauss at 256x256
     through ``Executable.run`` at 8 frames, the launch counts zeroed
     before and read after (this path's counts in the ``kernels`` line),
     each program bitwise the unsharded run and the reference backend
     (no kernel) on the same frames, and launching each kernel as two
     unsharded runs of a shard's frames do. d. ``launch/dryrun.py``
     on tinyllama-1.1b train_4k and prefill_32k and kimi-k2 decode_32k at
     the 32x8 production mesh (full configs, a fake process group of 256
     ranks, one process each, run alongside a-c): per-rank bytes against
     the card's memory, the memory record a rank (arguments, outputs,
     temp, peak), collective counts and bytes by kind, FLOPs.
     e. The card's constants: a bf16 8192^3 matmul's TFLOP/s and a 1 GiB
     device copy's GB/s (CUDA events over 20 launches), total_memory,
     beside ``nvidia-smi``'s name and power limit.
 15. roofline (``[roofline]`` lines; two host processes with CUDA hidden,
     started with phase 13 and read after phase 14). a. [lm_train]'s
     configuration (smollm-360m, full width and depth, remat full, batch
     8, seq 128) through ``dryrun.run_step`` on a fake group of one rank
     and a (1, 1) mesh: its memory record, the peak held within 10% of
     [lm_train]'s ``max_memory_allocated`` (the gap printed either way),
     the counted FLOPs against ``model_flops``, and the roofline terms on
     ``launch/mesh.py``'s constants (and on phase 14 e.'s) against
     [lm_train]'s measured ms a step: the step's share of its bound.
     b. ``roofline.build_table`` over phase 14 d.'s records: each of the
     three rows has its record, its terms and dominant term printed.
     c. ``launch/hillclimb.py --cell yi-decode --all-variants`` (yi-34b
     full, decode_32k, a fake group of 256 as 32x8): every variant
     completes; its three terms, serve_tp's collective term against
     base's, and the memory terms of the narrow carriers against
     serve_tp's (printed, not asserted).

 16. eager (``[eager]`` lines; run after phase 9, before phase 10):
     ``LightatorDevice`` on the card, each (model, scheme) of
     ``EAGER_RUNS`` on 8 frames: ``run_eager`` (the seed's per-layer
     interpreter: float64 tap-loop convs and products, no port kernel; its
     launch counts must stay 0) against ``run`` (the cached compile and
     ``plan._execute``, whose window's counts are the main path's and must
     equal a bare ``_execute``'s, every kernel of the plan launched):
     logits bitwise and reports equal field for field, both bitwise the
     CPU port's ``run_eager`` on the same frames and params; eager and
     compiled ms a batch (CUDA events, median of ``EAGER_ITERS``) beside
     ``nvidia-smi``'s name and power limit. Then the examples
     ``train_lenet_qat --steps 20`` (QAT under five schemes, each deployed
     on ``LightatorDevice.run``) and ``serve_quantized_lm --gen 8``.

``--rehearse`` runs every phase on the CPU with the plain versions: no
graphs, the bound phase on 2 emulated CPU workers, VGG16 at 32x32x3
(``vgg16_ir(in_hw=32)``, full channel widths, a conv budget that splits
its convs into strip and resident as 224x224x3 does), the LM configs'
smoke variants (the MoE ones at ``MOE_RUNS``' depths).

The last three lines of standard output are the ``kernels`` JSON object,
``nvidia-smi``'s name and power limit, and the result object
``{"ok": true, "device": {...}}``. Longer detail (per-call times, serving
stats) goes to the ``--details`` file. The script imports nothing of JAX
or of the reference package.

``--reread DIR`` reads the Chrome traces that a run of this script (of
this commit or an earlier one) wrote beside its details file, and prints
as JSON each timing range's device time per batch by kernel function and
the imaging serving windows' busy shares (eager, and bound where the run
wrote that trace), attributed as a run of this commit attributes them:
one yardstick for runs of different commits.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BUCKET = 8
IMAGING_HW = 256
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"int8": 1979e12,       # dense tensor-core int8
            "tf32": 495e12,        # dense tensor-core TF32
            "fp32": 67e12,         # float32 FMAs outside the tensor cores
            "fp64": 67e12}         # float64 on the tensor cores (mma.sync)
RAGGED_MVM = [(1, 1, 1), (37, 101, 53), (130, 777, 129), (300, 2304, 257)] + [
    (m, 4096 + 37 * m, 1000) for m in (1, 7, 13, 16)]
# extra strip convs through dispatch.conv_int: (name, x shape, w shape,
# stride, padding, groups)
STRIP_CONVS = [("stride2_valid", (2, 65, 63, 8), (3, 3, 8, 16), 2, "VALID", 1),
               ("groups2", (2, 40, 40, 8), (3, 3, 4, 12), 1, "SAME", 2),
               ("vgg16_like", (2, 56, 56, 64), (3, 3, 64, 128), 1, "SAME", 1),
               ("conv1_like", (2, 40, 40, 3), (3, 3, 3, 64), 1, "SAME", 1),
               ("stride2_int", (2, 65, 63, 32), (3, 3, 32, 16), 2, "VALID",
                1),
               ("groups2_int", (2, 40, 40, 32), (3, 3, 16, 24), 1, "SAME",
                2)]
# the int8 kernel at its extremes: (x shape, w shape, level): codes 255,
# levels +-127 (one tap's odd channels negated), |acc| past 2^24
STRIP_INT_EXTREMES = [((2, 30, 30, 512), (3, 3, 512, 64), 127),
                      ((2, 30, 30, 512), (3, 3, 512, 64), -127),
                      ((2, 30, 30, 3), (3, 3, 3, 64), 127),
                      ((2, 18, 20, 496), (3, 3, 496, 33), -127)]
SERVE_WINDOW = "chip_smoke.serve_window"
DEVICE_RANGE = "chip_smoke.device_time."
DEVICE_ITERS = 20                   # batches in each device-time range
L2_FLUSH_BYTES = 128 << 20          # written before each cold launch (the
                                    # H100's L2 holds 50 MB)
DEVICE_TRACE = "device_time_trace.json"
ROUTE_TRACE = "route_device_time_trace.json"
ROUTE_ITERS = 10                    # calls in each route's device-time range
SERVE_TRACE = "imaging_serve_trace.json"
BOUND_SERVE_TRACE = "imaging_bound_serve_trace.json"
BUCKETS = (1, 2, 4, 8)
VISION_REQUESTS = 32
# the reference's acceptance chain: (pipeline, input channels)
CHAIN = (("denoise_gauss", 3), ("edge_detect", 3), ("sharpen", 1))
# the programs whose served frames/s and latency are measured, and for how
# long (seconds; the rehearsal's on the CPU)
LOAD_PROGRAMS = ("lenet", "vgg9", "edge_detect", "compress_recon", "chain")
LOAD_S = {"saturate": 2.0, "poisson": 2.0}
REHEARSAL_LOAD_S = {"saturate": 0.2, "poisson": 0.2}
# the [obs] phase: its exported trace, the profiler trace of its bound
# imaging burst, the programs and variant order of its cost runs (A no
# recorder, B the default recorder, C recorder + Trace, D recorder + the
# admin endpoint polled every ADMIN_POLL_S), and each run's length
OBS_TRACE = "obs_serve_trace.json"
OBS_BUSY_TRACE = "obs_imaging_bound_serve_trace.json"
OBS_COST_PROGRAMS = ("lenet", "edge_detect")
OBS_VARIANTS = "ABCDDCBA"
ADMIN_POLL_S = 0.1
OBS_COST_S = 2.0
REHEARSAL_OBS_COST_S = 0.2
# the [vgg16] phase: frame size (the rehearsal's, with the conv budget that
# gives it 224x224x3's split: conv1-conv10 strip, conv11-13 resident), the
# frames of its requests, how many frames the CPU port is held to, the
# buckets its shapes are held at, the timing iterations a layer, its
# saturation run and its profiler trace
VGG16_HW = 224
REHEARSAL_VGG16_HW = 32
REHEARSAL_VGG16_BUDGET = 100_000
VGG16_REQUESTS = (1, 3, 8)
VGG16_CPU_FRAMES = 2
VGG16_SHAPE_BUCKETS = (1, BUCKET)
VGG16_ITERS = 10
VGG16_DEVICE_ITERS = 3
VGG16_WARM_LAUNCHES = 64
VGG16_SATURATE_S = 2.0
REHEARSAL_VGG16_SATURATE_S = 0.2
VGG16_TRACE = "vgg16_bound_serve_trace.json"
VGG16_DEVICE_TRACE = "vgg16_device_time_trace.json"
VGG16_FORMS_TRACE = "vgg16_int_forms_trace.json"
# the [eager] phase: (model, scheme) run through LightatorDevice at bucket
# 8, the timed calls of each pass (the rehearsal's on the CPU), and the
# two examples' settings
EAGER_RUNS = (("lenet", "w4a4"), ("lenet", "w3a4"), ("lenet", "mx43"),
              ("vgg9", "w4a4"), ("vgg16", "w4a4"))
EAGER_ITERS = 5
REHEARSAL_EAGER_ITERS = 2
EAGER_QAT_STEPS = 20
EAGER_LM_GEN = 8
# the [train] phase: the schemes LeNet trains under, (steps, batch) per
# model (the rehearsal's on the CPU), held-out frames per model, the served
# request sizes, fit_recon_head's frame size and frames, timing iterations
TRAIN_SCHEMES = ("fp32", "w4a4", "w3a4", "w2a4", "mx43")
TRAIN_RUNS = {"lenet": (40, 64), "vgg9": (10, 64)}
REHEARSAL_TRAIN_RUNS = {"lenet": (10, 32), "vgg9": (3, 16)}
TRAIN_TEST_FRAMES = 512
REHEARSAL_TRAIN_TEST_FRAMES = 32
TRAIN_REQUESTS = (1, 3, 8)
RECON_HW, RECON_FRAMES, RECON_STEPS = 32, 4, 150
TRAIN_ITERS = 20
TRAIN_WINDOW = "chip_smoke.train_window"
TRAIN_PROFILE_STEPS = 5
TRAIN_TRACE = "train_{}_trace.json"
# the [lm] phase: the two configs served at full width and depth (the
# rehearsal runs their smoke variants), the batch, prompt and generated
# tokens, the modes, the families held card against CPU at smoke size,
# the layers of the full-width card-vs-CPU run, its tolerance (of the
# largest |logit|), the prefill-vs-decode tolerance of the reference's
# test, and the profiled decode window
LM_ARCHS = ("tinyllama-1.1b", "mamba2-1.3b")
LM_BATCH, LM_PROMPT, LM_GEN = 4, 8, 24
LM_MODES = ("none", "w4a4", "storage")
LM_FAMILIES = ("smollm-360m", "stablelm-3b", "hymba-1.5b", "hubert-xlarge",
               "internvl2-26b")
LM_CPU_LAYERS = 2
LM_CARD_CPU_TOL = 1e-4
LM_PREFILL_TOL = 5e-2
# how far, in CRC code steps, an activation's x / step may lie from the
# one it is replayed against (``ActTape``): two runs' float32 sums are
# ulps apart; in bfloat16 the residual stream drifts by bf16 ulps between
# prefill and decode (2^-8 of |x| <= 1 is 0.06 of a step), and the bound
# is that a flipped code only ever moves to its neighbour
LM_TIE = {"float32": 1e-3, "bfloat16": 1.0}
LM_WINDOW = "chip_smoke.lm_window"
LM_PROFILE_STEPS = 5
LM_TRACE = "lm_trace.json"
# the [moe] phase: the MoE family at full width, each config cut in depth
# to what one 80 GB card holds beside its mode's temporaries (PERF.md §4),
# as (arch, layers, modes); "storage" runs last in its group and on the
# int levels alone (the float experts are dropped once quantized). The
# rehearsal runs the smoke variants at the same depths. Card against CPU:
# the smoke variants under both dispatches and three modes, and one
# config at full width (float32, ~26 GB a side) with its own depth, batch,
# prompt and generated tokens
MOE_ARCHS = ("grok-1-314b", "kimi-k2-1t-a32b")
MOE_RUNS = (("grok-1-314b", 4, ("none", "storage")),
            ("grok-1-314b", 2, ("w4a4",)),
            ("kimi-k2-1t-a32b", 1, ("none", "storage")))
MOE_DISPATCHES = ("sorted", "grouped")
MOE_CPU_MODES = ("none", "w4a4", "storage")
MOE_CPU_FULL = {"arch": "grok-1-314b", "layers": 1, "batch": 2, "prompt": 4,
                "gen": 4}
# the [lm_train] phase: smollm-360m (the reference trainer's default) at
# full width and depth through launch/train.py (the rehearsal: its smoke
# variant), the batch, sequence and lr, the steps a quant mode runs, the
# warm-up steps left out of the median,
# the restart drill, the 100M example's steps, the profiled window, and the
# card against the CPU port: each family's smoke variant and smollm-360m
# cut to LM_CPU_LAYERS layers, LM_TRAIN_CPU_STEPS steps, the params held to
# LM_CARD_CPU_TOL of their largest, or to LM_TRAIN_ADAM_TOL * lr absolute
# with at most LM_TRAIN_ADAM_SHARE of their entries past the first bound
LM_TRAIN_ARCH = "smollm-360m"
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_LR = 8, 128, 3e-4
LM_TRAIN_STEPS = {"none": 30, "w4a4": 10}
LM_TRAIN_WARMUP = 2
LM_TRAIN_DRILL = {"steps": 20, "every": 10, "fail_at": 12}
LM_TRAIN_100M_STEPS = 100
LM_TRAIN_PROFILE_STEPS = 3
LM_TRAIN_WINDOW = "chip_smoke.lm_train_window"
LM_TRAIN_TRACE = "lm_train_trace.json"
LM_TRAIN_FAMILIES = (("smollm-360m", {}), ("mamba2-1.3b", {}),
                     ("hymba-1.5b", {}),
                     ("grok-1-314b", {"moe_dispatch": "sorted"}),
                     ("grok-1-314b", {"moe_dispatch": "grouped"}),
                     ("hubert-xlarge", {}), ("internvl2-26b", {}))
LM_TRAIN_CPU_STEPS = 3
LM_TRAIN_ADAM_TOL, LM_TRAIN_ADAM_SHARE = 0.5, 1e-2
# the [dist] phase: the world-1 train steps (the [lm_train] configuration,
# held against that phase's first steps), the multi-rank worlds (checks
# of distributed/checks.py, and where each one's tensors live: gloo moves
# CUDA tensors for all_reduce and broadcast only, so a check whose
# collectives are all of those runs on cuda:0, every other on the CPU),
# the shard_batch programs at DIST_SHARD_BATCH frames over two shards of
# cuda:0, the dry-run cells (full configs at the 32x8 production mesh, one
# process each, run while the rest of the phase runs), and the card's
# constants (a DIST_GEMM^3 bf16 matmul, a DIST_COPY_BYTES device copy)
DIST_TRAIN_STEPS = 5
DIST_LOSS_REL = 1e-6
DIST_SHARD_BATCH = 8
DIST_SHARD_PROGRAMS = ("lenet", "vgg9", "compress_recon_deconv",
                       "denoise_gauss")
DIST_DRYRUN = (("tinyllama-1.1b", "train_4k"),
               ("tinyllama-1.1b", "prefill_32k"),
               ("kimi-k2-1t-a32b", "decode_32k"))
DIST_WORLD_TIMEOUT = 240.0
DIST_GEMM, DIST_COPY_BYTES, DIST_REPS = 8192, 1 << 30, 20
# check -> (its world, the check function, args, where its tensors live)
DIST_CHECKS = {
    "tp_dp_train": (4, "train_check", ("smollm-360m", (2, 2)), {}, "cpu"),
    "fsdp_tp_train": (4, "train_check", ("smollm-360m", (2, 2)),
                      {"fsdp": True}, "cpu"),
    "gpipe": (4, "pipeline_check", (), {}, "cpu"),
    "moe_ep": (2, "moe_check", ("kimi-k2-1t-a32b", (1, 2)), {}, "cpu"),
    "moe_ep_fsdp": (2, "moe_check", ("grok-1-314b", (2, 1)),
                    {"fsdp": True}, "cpu"),
    "compressed_allreduce": (2, "compression_check", (), {}, "cuda"),
    "elastic_save_w2": (2, "elastic_save", ("smollm-360m", (1, 2)), {},
                        "cpu"),
    "elastic_restore_w4": (4, "elastic_restore", ("smollm-360m", (2, 2)),
                           {}, "cpu"),
    "elastic_restore_w1": (1, "elastic_restore", ("smollm-360m", (1, 1)),
                           {}, "cpu"),
}
DIST_TRANSPORT = {
    "cuda": "gloo, every rank's tensors on cuda:0 (all_reduce only)",
    "cpu": "gloo, tensors on the CPU (gloo has no CUDA all_gather, "
           "reduce_scatter, send or recv)"}
# the [roofline] phase: [lm_train]'s step dry-run on a fake group of one
# rank (its peak held to ROOFLINE_PEAK_TOL of [lm_train]'s measured peak),
# the roofline over [dist] d.'s records, and the hillclimb's
# ROOFLINE_CELL with all its variants at 32x8; the two processes start
# with [lm_train] and are read after [dist], each killed at
# ROOFLINE_TIMEOUT seconds from its start
ROOFLINE_PEAK_TOL = 0.10
ROOFLINE_CELL = "yi-decode"
ROOFLINE_TIMEOUT = 900.0
ROOFLINE_STEP = """
import dataclasses, json, sys, time
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch import dryrun, shardings, specs
from repro_torch.launch import mesh as mesh_mod
arch, batch, seq, smoke, out = sys.argv[1:]
cfg = (smoke_variant if smoke == "1" else get_config)(arch)
cfg = dataclasses.replace(cfg, quant_scheme="none",
                          max_seq=max(cfg.max_seq, int(seq)))
t0 = time.time()
dryrun.fake_world(1)
mesh = mesh_mod.make_mesh((1, 1), ("data", "model"), device_type="cpu")
cell = specs.ShapeCell("lm_train", int(seq), int(batch), "train")
with FakeTensorMode(allow_non_fake_inputs=True):
    rec = dryrun.run_step(cfg, cell, mesh, shardings.build_rules(cfg, mesh))
rec["wall_s"] = round(time.time() - t0, 3)
with open(out, "w") as f:
    json.dump(rec, f)
"""
# the port's kernels are top-level functions of an anonymous namespace
PORT_KERNEL = r"^(void )?\(anonymous namespace\)::"
KERNELS = ("photonic_mvm", "conv_chain", "ca_pool", "conv_strip",
           "conv_strip_depthwise", "conv_bank", "conv_strip_int",
           "conv_strip_f64mma", "epilogue")
# the kernels only the conv_bank op's own run launches (no served path)
OP_KERNELS = ("conv_bank", "conv_strip_f64mma")
# the kernels each served path must launch
PATH_KERNELS = {"vision": ("photonic_mvm", "conv_chain", "ca_pool",
                           "epilogue"),
                "imaging": ("photonic_mvm", "ca_pool", "conv_strip",
                            "conv_strip_depthwise", "epilogue"),
                "chain": ("photonic_mvm", "ca_pool", "conv_strip_depthwise",
                          "epilogue"),
                "vgg16": ("photonic_mvm", "conv_strip_int", "epilogue"),
                "train": ("photonic_mvm", "conv_chain", "ca_pool",
                          "epilogue")}
# the kernels the [dist] phase's shard_batch path must launch (per-tensor
# calibration at batch > 1 runs the per-layer path: no fused chain)
SHARD_BATCH_KERNELS = ("photonic_mvm", "ca_pool", "conv_strip",
                       "conv_strip_depthwise", "epilogue")
SOURCES = {
    "photonic_mvm": ("src/repro_torch/csrc/photonic_mvm.cu",
                     "src/repro/kernels/photonic_mvm/kernel.py:81"),
    "conv_chain": ("src/repro_torch/csrc/conv_chain.cu",
                   "src/repro/kernels/conv_bank/fused_kernel.py:167"),
    "ca_pool": ("src/repro_torch/csrc/ca_pool.cu",
                "src/repro/kernels/ca_pool/kernel.py:52"),
    "conv_strip": ("src/repro_torch/csrc/conv_strip.cu",
                   "src/repro/kernels/conv_bank/strip_kernel.py:206"),
    "conv_strip_depthwise": ("src/repro_torch/csrc/conv_strip.cu",
                             "src/repro/kernels/conv_bank/strip_kernel.py:289"),
    "conv_bank": ("src/repro_torch/csrc/conv_strip.cu",
                  "src/repro/kernels/conv_bank/kernel.py:85"),
    # the dense float kernel's tensor-core form: the op's float mode in
    # both strategies (its resident launch and its strips); "replaces"
    # names the first
    "conv_strip_f64mma": ("src/repro_torch/csrc/conv_strip_f64mma.cu",
                          ("src/repro/kernels/conv_bank/kernel.py:85",
                           "src/repro/kernels/conv_bank/strip_kernel.py:206")),
    # the wgmma form (conv2-conv10) and the mma.sync forms (conv1's folded
    # taps among them): "source" names the first, "sources" both
    "conv_strip_int": (("src/repro_torch/csrc/conv_strip_wgmma.cu",
                        "src/repro_torch/csrc/conv_strip.cu"),
                       "src/repro/kernels/conv_bank/strip_kernel.py:206"),
    # no pallas_call: XLA's fusion of the jitted executor's epilogue (its
    # conv branch; _crc_requant_traced at plan.py:86)
    "epilogue": ("src/repro_torch/csrc/epilogue.cu",
                 "src/repro/core/plan.py:645")}
# device-time symbols (space-free regexes over the profiler's kernel names)
KERNEL_SYMBOLS = {"photonic_mvm":
                  r"mvm_(gemm|stream|wgmma|skinny|layout)_kernel",
                  "conv_chain": r"conv_chain_kernel",
                  "ca_pool": r"ca_(gray|mean|generic)_kernel",
                  "conv_strip": r"conv_dense_kernel",
                  "conv_strip_depthwise": r"conv_dw_kernel",
                  "conv_bank": r"conv_dense_kernel",
                  "conv_strip_int": r"conv_igemm_(fold_|wgmma_)?kernel",
                  "conv_strip_f64mma": r"conv_f64mma_kernel",
                  "epilogue": r"epi_(reduce|quant|cluster)_kernel"}


class SmokeFailure(RuntimeError):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    need(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log_text):
    """Per kernel function in an ``nvcc -Xptxas -v`` log: registers, static
    shared memory and spill bytes. Names are demangled enough to read:
    ``mvm_gemm_kernel<16,64,1,4>``."""
    out, cur = [], None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            # <length><identifier>: the first identifier ending in _kernel
            # (a hash's digits may run into the length)
            base = next((name[d.end():d.end() + int(name[i:d.end()])]
                         for d in re.finditer(r"\d+", name)
                         for i in range(d.start(), d.end())
                         if name[d.end():d.end() + int(name[i:d.end()])]
                         .endswith("_kernel")), None)
            args = re.findall(r"L[ib](\d+)E", name)
            label = (base or name) + (
                f"<{','.join(args)}>" if args else "")
            cur = {"function": label, "registers": None, "smem_bytes": 0,
                   "spill_stores": 0, "spill_loads": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(m.group(1)) if m else 0
    return out


def mvm_ptxas(by_function, cfg):
    """The ptxas line of the photonic_mvm instantiation that ``cfg`` (a
    ``photonic_mvm.ops.MvmConfig``) launches, from the .cu's own forms:
    ``mvm_stream_kernel<NT>`` (NT = bm / 8), ``mvm_wgmma_kernel``,
    ``mvm_gemm_kernel``, ``mvm_skinny_kernel<N>``; None where the build's
    log has no such line."""
    name = {"stream": f"mvm_stream_kernel<{cfg.bm // 8}>",
            "wgmma": "mvm_wgmma_kernel", "gemm": "mvm_gemm_kernel",
            "skinny": f"mvm_skinny_kernel<{cfg.bn}>"}[cfg.route]
    return by_function.get(name)


def int8_ptxas(ptxas):
    """The build's ptxas lines of the int8 strip kernels by function: the
    mma.sync forms' (``conv_strip``'s library) and the wgmma form's
    (``conv_strip_wgmma``'s)."""
    return {f["function"]: f for name in ("conv_strip", "conv_strip_wgmma")
            for f in (ptxas or {}).get(name, [])}


def igemm_ptxas(by_function, cfg, fold=False):
    """The ptxas line of the int8 strip kernel instantiation that
    ``cfg`` (a ``strip.IgemmConfig``) launches, with the epilogue folded
    into its store or not, from the .cu's own forms: the wgmma one
    ``conv_igemm_wgmma_kernel<MB, BN, kFold>`` (MB = th * tw / 128 m64
    blocks a warpgroup), the mma.sync ones ``conv_igemm[_fold]_kernel<KT,
    MT, NT, WM, WN, kFold>`` with ``BN = WN * NT * 8`` output channels:
    None where the build's log has no such line."""
    if cfg.form == "wgmma":
        return by_function.get(f"conv_igemm_wgmma_kernel<"
                               f"{cfg.th * cfg.tw // 128},{cfg.bn},"
                               f"{int(fold)}>")
    want = "conv_igemm_fold_kernel" if cfg.kf else "conv_igemm_kernel"
    for name, rep in by_function.items():
        m = re.fullmatch(r"(\w+)<(\d+),(\d+),(\d+),(\d+),(\d+),(\d)>",
                         name)
        if m and m.group(1) == want:
            kt, _, nt, _, wn, kfold = map(int, m.groups()[1:])
            if kt == cfg.k_inst and wn * nt * 8 == cfg.bn and \
                    kfold == int(fold):
                return rep
    return None


# ---------------------------------------------------------------------------
# programs and inputs, made from a seed with numpy
# ---------------------------------------------------------------------------

def numpy_params(layers, seed):
    """{layer: {"w", "b"}}: N(0, 1/fan_in) weights, small non-zero biases."""
    import numpy as np
    from repro_torch.core.accelerator import ConvSpec, DenseSpec
    rng = np.random.default_rng(seed)
    params = {}
    for layer in layers:
        if isinstance(layer, ConvSpec):
            shape = (layer.kernel, layer.kernel, layer.c_in, layer.c_out)
            fan_in, n = layer.kernel * layer.kernel * layer.c_in, layer.c_out
        elif isinstance(layer, DenseSpec):
            shape, fan_in, n = (layer.fan_in, layer.fan_out), layer.fan_in, \
                layer.fan_out
        else:
            continue
        w = rng.standard_normal(shape) / math.sqrt(fan_in)
        b = rng.standard_normal(n) * 0.05
        params[layer.name] = {"w": w.astype(np.float32),
                              "b": b.astype(np.float32)}
    return params


def vision_programs():
    from repro_torch import Program
    from repro_torch.models.vision import MODEL_INPUT_HWC, VISION_MODELS
    from repro_torch.weights import params_from_numpy
    out = {}
    for i, name in enumerate(("lenet", "vgg9")):
        layers = tuple(VISION_MODELS[name]())
        out[name] = Program(layers, params_from_numpy(
            numpy_params(layers, SEED + i), "cpu"), MODEL_INPUT_HWC[name],
            name=name)
    return out


def imaging_programs(hw=IMAGING_HW):
    from repro_torch import Program
    from repro_torch.imaging import PIPELINES
    return {name: Program.from_pipeline(name, hw, hw, 3)
            for name in sorted(PIPELINES)}


def frames_for(prog, n, seed):
    """Frames in [0, 1]: uniform noise for the CNNs; for the imaging
    pipelines, smooth gradients and waves with noise on top, so the filters
    see edges and texture. Every third frame is dimmed, so per-frame
    calibration matters."""
    import numpy as np
    rng = np.random.default_rng(seed)
    h, w, c = prog.input_hwc
    if prog.name in ("lenet", "vgg9", "vgg16"):
        f = rng.random((n, h, w, c))
    else:
        yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
        f = np.empty((n, h, w, c))
        for i in range(n):
            fx, fy, ph = rng.uniform(2, 12, 2).tolist() + [rng.uniform(0, 6)]
            base = 0.5 + 0.3 * np.sin(2 * np.pi * (fx * xx + ph)) \
                * np.cos(2 * np.pi * fy * yy) + 0.2 * (xx - yy)
            for ch in range(c):
                f[i, ..., ch] = base * (0.8 + 0.2 * ch / max(c - 1, 1))
        f = np.clip(f + rng.normal(0, 0.05, f.shape), 0, 1)
    f = f.astype(np.float32)
    f[::3] *= 0.1
    return f


# ---------------------------------------------------------------------------
# the kernels' calls on the served paths, from the compiled plans
# ---------------------------------------------------------------------------

def path_calls(exes, device, batch=BUCKET):
    """The inputs each kernel gets for one batch of each program, by kernel:
    photonic_mvm (a, wq), conv_chain (codes, scale, stages, aq), ca_pool
    (img, pool), conv_strip (x_padded, w, stride, strip_h, conv),
    conv_strip_depthwise (x_padded, w_taps, stride, strip_h, conv),
    conv_strip_int (x_padded uint8, w int8, stride, None, conv) and
    epilogue (its ``ops.epilogue`` arguments, label). Codes are random
    0..15, weights the programs' own quantized levels, and a strip conv's
    input is padded as dispatch pads it on the plan's route; the
    epilogue's calls are recorded from one per-frame run of each program
    on ``frames_for``'s frames (``edge_shapes.epilogue_calls``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.plan import CAStep, ConvStep, DenseStep
    from repro_torch.core.quant import quantize_weight
    from repro_torch.kernels.conv_bank.strip import (int_operands,
                                                     pad_rows_for_strips)
    from repro_torch.kernels.edge_shapes import epilogue_calls
    gen = torch.Generator().manual_seed(SEED + batch)
    calls = {k: [] for k in KERNELS if k != "conv_bank"}
    for name, exe in exes.items():
        plan, params = exe.plan, exe.params()
        frames = frames_on(frames_for(exe.program, batch, SEED + batch),
                           device)
        calls["epilogue"] += [(call, f"{name}#{j}") for j, call in
                              enumerate(epilogue_calls(exe, frames))]
        seg_at = {s.start: s for s in plan.fused_segments}
        h, w, c = plan.frame_shape
        i = 0
        while i < len(plan.steps):
            step = plan.steps[i]
            seg = seg_at.get(i)
            if seg is not None:
                stages = []
                for s in plan.steps[i:i + seg.length]:
                    wq, ws = quantize_weight(params[s.name]["w"], s.wa)
                    stages.append((s.geom, wq, ws, params[s.name].get("b")))
                g0 = stages[0][0]
                codes = torch.randint(0, 16, (batch, g0.h_in, g0.w_in,
                                              g0.c_in), generator=gen)
                scale = torch.rand((batch, 1, 1, 1), generator=gen) + 0.01
                calls["conv_chain"].append((
                    codes.float().to(device), scale.to(device), stages,
                    float(plan.consts["a_qmax"])))
                i += seg.length
                continue
            if isinstance(step, CAStep):
                need(i == 0, f"{name}: a CA step after step 0")
                img = torch.rand((batch, h, w, c), generator=gen)
                calls["ca_pool"].append((img.to(device), step.pool))
            elif isinstance(step, ConvStep):
                g = step.geom
                wq, _ = quantize_weight(params[step.name]["w"], step.wa)
                need(g.groups == 1 or g.depthwise,
                     f"{name}.{step.name}: a grouped conv on the path")
                if plan.strip_routes.get(step.name) == "int":
                    codes = torch.randint(0, 16, (batch, g.h_in, g.w_in,
                                                  g.c_in), generator=gen)
                    x8, w8 = int_operands(codes, wq, g.pads)
                    calls["conv_strip_int"].append((
                        x8.to(device), w8.to(device), g.stride, None,
                        f"{name}.{step.name}"))
                elif step.strategy.kind == "strip":
                    codes = torch.randint(0, 16, (batch, g.h_in, g.w_in,
                                                  g.c_in), generator=gen)
                    (plo, phi), (qlo, qhi) = g.pads
                    sh = step.strategy.strip_rows
                    xp = pad_rows_for_strips(
                        F.pad(codes.float(), (0, 0, qlo, qhi, plo, phi)),
                        g.kernel, g.stride, sh, step.strategy.n_strips)
                    wf = wq.float()
                    key = "conv_strip"
                    if g.depthwise:
                        key = "conv_strip_depthwise"
                        wf = wf.reshape(g.kernel * g.kernel, g.c_out)
                    calls[key].append((xp.to(device), wf, g.stride, sh,
                                       f"{name}.{step.name}"))
                else:
                    need(g.groups == 1, f"{name}.{step.name}: a resident "
                         f"depthwise conv")
                    hc, wc = g.conv_hw()
                    k = g.kernel * g.kernel * g.c_in
                    a = torch.randint(0, 16, (batch * hc * wc, k),
                                      generator=gen)
                    calls["photonic_mvm"].append((
                        a.to(torch.int8).to(device),
                        wq.reshape(k, g.c_out)))
            elif isinstance(step, DenseStep):
                wq, _ = quantize_weight(params[step.name]["w"], step.wa)
                a = torch.randint(0, 16, (batch, wq.shape[0]), generator=gen)
                calls["photonic_mvm"].append((a.to(torch.int8).to(device),
                                              wq))
            i += 1
    return calls


def conv_bank_calls(device, narrow=False):
    """(x, w, bias) of the conv_bank op's own calls (``CONV_BANK_CALLS``),
    or of the narrow one the float kernel's rule keeps on its CUDA-core
    form (``CONV_BANK_NARROW``)."""
    import torch
    from repro_torch.kernels.edge_shapes import (CONV_BANK_CALLS,
                                                 CONV_BANK_NARROW)
    gen = torch.Generator().manual_seed(SEED + (12 if narrow else 11))
    out = []
    for b, h, w, ci, co, k in CONV_BANK_NARROW if narrow else \
            CONV_BANK_CALLS:
        x = torch.rand((b, h, w, ci), generator=gen)
        wt = torch.randn((k, k, ci, co), generator=gen) * 0.2
        bias = torch.randn((co,), generator=gen) * 0.1
        out.append((x.to(device), wt.to(device), bias.to(device)))
    return out


def bank_kernel(x, w, strategy, quantized):
    """The counter the conv_bank op's call on x [B, H, W, C_in], w [k, k,
    C_in, C_out] (SAME) launches on: the int8 kernel's where
    ``strip.dense_route`` sends a quantized call there; else the float
    kernel's tensor-core form where ``strip.dense_form`` gives it, or its
    CUDA-core form, counted as the op's resident launch or the strips'."""
    from repro_torch.kernels.conv_bank import strip
    b, h, ww, ci = x.shape
    k, co = w.shape[0], w.shape[-1]
    if quantized and strip.dense_route(ci, co, k, 1) == "int":
        return "conv_strip_int"
    if strip.dense_form(b, h, ww, ci, co, k, 1) == "f64mma":
        return "conv_strip_f64mma"
    return "conv_bank" if strategy == "resident" else "conv_strip"


def dense_kernel(xp, w, stride):
    """The counter the dense float strip conv of xp [B, Hp, Wp, C_in] by
    w [k, k, C_in, C_out] launches on, by ``strip.dense_form``."""
    from repro_torch.kernels.conv_bank import strip
    k = w.shape[0]
    b, hp, wp, ci = xp.shape
    form = strip.dense_form(b, (hp - k) // stride + 1, (wp - k) // stride + 1,
                            ci, w.shape[-1], k, stride)
    return "conv_strip_f64mma" if form == "f64mma" else "conv_strip"


def bank_entries(device):
    """The conv_bank op's timed calls, as [timing] adds them: for each of
    its calls and then the narrow one, the quantized call (W4A4, relu,
    bias) and the float-mode call, resident: ``(kernel, fn, library)``,
    the kernel the call launches (:func:`bank_kernel`) and one PyTorch
    call for it (``F.conv2d`` in float, with the bias and relu where
    quantized; TF32 off where timed)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.quant import W4A4
    from repro_torch.kernels.conv_bank.ops import conv_bank
    out = []
    for x, w, bias in conv_bank_calls(device) + conv_bank_calls(device,
                                                                 True):
        k = w.shape[0]
        nchw = x.permute(0, 3, 1, 2)
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        kw = dict(spec=W4A4, strategy="resident", act="relu", bias=bias)
        out.append((bank_kernel(x, w, "resident", True),
                    lambda x=x, w=w, kw=kw: conv_bank(x, w, **kw),
                    lambda n=nchw, wo=w_oihw, k=k, b=bias: torch.relu(
                        F.conv2d(n, wo, b, padding=k // 2))))
        out.append((bank_kernel(x, w, "resident", False),
                    lambda x=x, w=w: conv_bank(x, w, strategy="resident"),
                    lambda n=nchw, wo=w_oihw, k=k: F.conv2d(
                        n, wo, padding=k // 2)))
    return out


def run_conv_bank_op(calls, strategies=("resident", "strip"),
                     quantized=True):
    """The conv_bank op on its own calls: W4A4 with relu and bias, or
    without a spec (its float mode)."""
    from repro_torch.core.quant import W4A4
    from repro_torch.kernels.conv_bank.ops import conv_bank
    if not quantized:
        return [conv_bank(x, w, strategy=s) for x, w, _ in calls
                for s in strategies]
    return [conv_bank(x, w, spec=W4A4, strategy=s, act="relu", bias=b)
            for x, w, b in calls for s in strategies]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def per_tensor(call):
    """An ``edge_shapes.EpilogueCall`` under per-tensor calibration: one
    act_scale (its first frame's) and ``per_frame`` False."""
    s = call.act_scale
    return dataclasses.replace(
        call, act_scale=None if s is None else s.reshape(-1)[0],
        per_frame=False)


def compare_epilogue(compare, call, what):
    """The epilogue kernels on ``call`` (an ``edge_shapes.EpilogueCall``:
    ``ops.epilogue``'s arguments, or a folded conv's
    ``ops.epilogue_fold``'s) against their plain version, codes and scale,
    bitwise, under the call's calibration and per-tensor."""
    from repro_torch.kernels.edge_shapes import epilogue_fns
    for a in (call, per_tensor(call)) if call.per_frame else (call,):
        kernel, plain = epilogue_fns(a)
        want, got = plain(), kernel()
        label = f"{what} per_frame={a.per_frame}"
        need(got[0].dtype == want[0].dtype, f"epilogue {label}: "
             f"{got[0].dtype} codes, plain {want[0].dtype}")
        compare("epilogue", got[0].float(), want[0].float(),
                f"{label} codes")
        compare("epilogue", got[1], want[1], f"{label} scale")


def phase_kernels(device, vision, imaging):
    """Every kernel against its plain version, bitwise."""
    import torch
    from repro_torch import Options, Program
    from repro_torch.core.compressive import compressive_acquire
    from repro_torch.core.plan import padtype_to_pads
    from repro_torch.core.quant import W4A4
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.ca_pool.ops import acquire, ca_pool
    from repro_torch.kernels.ca_pool.ref import ca_pool_ref_generic
    from repro_torch.kernels.conv_bank import strip
    from repro_torch.kernels.conv_bank.fused import conv_chain
    from repro_torch.kernels.conv_bank.ops import conv_bank, conv_bank_plain
    from repro_torch.kernels.conv_bank.ref import conv_chain_ref, conv_int_ref
    from repro_torch.kernels.edge_shapes import (CA_EDGES, CHAIN_EDGES,
                                                 CHAINS, DW_EDGES,
                                                 CONV_BANK_CALLS,
                                                 EPILOGUE_EDGES,
                                                 F64MMA_EDGES,
                                                 INT_WGMMA_EDGES, MVM_EDGES,
                                                 STRIP_EDGES, EpilogueCall,
                                                 chain_case, epilogue_case,
                                                 odd_offset)
    from repro_torch.kernels.photonic_mvm.ops import mvm_int, mvm_weights
    from repro_torch.kernels.photonic_mvm.ref import mvm_int_ref
    gen = torch.Generator().manual_seed(SEED + 7)
    errs = {k: [] for k in KERNELS}
    dev = str(device)

    def compare(kernel, got, want, what):
        need(got.shape == want.shape, f"{kernel} {what}: shape "
             f"{tuple(got.shape)} != {tuple(want.shape)}")
        need(bool(torch.isfinite(got).all()), f"{kernel} {what}: not finite")
        err = float((got - want).abs().max()) if got.numel() else 0.0
        errs[kernel].append(err)
        need(torch.equal(got, want), f"{kernel} {what}: differs from its "
             f"plain version (max abs err {err})")

    # extra geometries from compiled plans: edge_detect's fused segment at
    # 64x64, and the 512x512 multi-strip convs (batch 2)
    extra = path_calls({
        "edge64": Program.from_pipeline("edge_detect", 64, 64).compile(
            Options(device=dev)),
        **{f"{n}512": Program.from_pipeline(n, 512, 512).compile(
            Options(device=dev))
           for n in ("denoise_gauss", "compress_recon_deconv")}},
        device, batch=2)
    need(len(extra["conv_chain"]) == 1, "edge_detect at 64x64 did not fuse")
    strips = {c[4]: c[3] for k in ("conv_strip", "conv_strip_depthwise")
              for c in extra[k]}
    for conv, n_strips in (("denoise_gauss512.gauss", 2),
                           ("compress_recon_deconv512.rec2", 3)):
        rows = strips[conv]
        need(-(-512 // rows) == n_strips,
             f"{conv}: {rows}-row strips, expected {n_strips} strips")
    calls = {k: vision.get(k, []) + imaging.get(k, []) + extra.get(k, [])
             for k in KERNELS}

    ragged = []
    for m, k, n in RAGGED_MVM + [e[:3] for e in MVM_EDGES]:
        a = torch.randint(0, 16, (m, k), generator=gen).to(torch.int8)
        w = torch.randint(-127, 128, (k, n), generator=gen).to(torch.int8)
        ragged.append((a.to(device), w.to(device)))
        # the same operands one byte past an allocation: no aligned copy
        ragged.append((odd_offset(a.to(device)), odd_offset(w.to(device))))
    for a, w in calls["photonic_mvm"] + ragged:
        ws = (torch.rand((w.shape[1],), generator=gen) + 0.5).to(device)
        what = f"M,K,N={a.shape[0]},{a.shape[1]},{w.shape[1]}"
        for act_scale, scales in ((1.0, None), (0.37, ws)):
            compare("photonic_mvm", mvm_int(a, w, scales, act_scale),
                    mvm_int_ref(a, w, scales, act_scale), what)
        # the levels' layout kernel against its plain version (the CPU's)
        compare("photonic_mvm", mvm_weights(w).wt.float(),
                mvm_weights(w.cpu()).wt.to(w.device).float(),
                f"{what} layout")

    chains = list(calls["conv_chain"])
    for h, w, c, specs in CHAINS:
        codes, scale, stages = chain_case(3, h, w, c, specs, gen, device)
        chains.append((codes, scale, stages, 15.0))
        # per-tensor batch-1 form: a 0-d incoming scale
        chains.append((codes[:1], scale[0, 0, 0, 0], stages, 15.0))
    for b, h, w, c, specs in CHAIN_EDGES:
        codes, scale, stages = chain_case(b, h, w, c, specs, gen, device)
        chains.append((codes, scale, stages, 15.0))
    for codes, scale, stages, aq in chains:
        got = conv_chain(codes, scale, stages, aq)
        want = conv_chain_ref(codes, scale, stages, aq)
        names = "+".join(g.name for g, _, _, _ in stages)
        compare("conv_chain", got[0], want[0], f"{names} codes")
        compare("conv_chain", got[1], want[1], f"{names} scales")

    cases = [(img, p, True) for img, p in calls["ca_pool"]]
    for shape, p in (((8, 32, 32, 3), 4), ((8, 32, 32, 1), 2),
                     ((5, 28, 28, 1), 4), ((4, 16, 24, 3), 2)):
        img = torch.rand(shape, generator=gen).to(device)
        cases += [(img, p, True), (img, p, False)]
    for b, h, w, c, p, gray, odd, _ in CA_EDGES:
        img = torch.rand((b, h, w, c), generator=gen).to(device)
        cases.append((odd_offset(img) if odd else img, p, gray))
    for img, p, gray in cases:
        compare("ca_pool", acquire(img, p, gray),
                compressive_acquire(img, p, gray),
                f"{tuple(img.shape)} p={p} gray={gray}")
    # the public op with a bank of its own (signed, any [p, p, C]) on every
    # weighted route's edges, in float32 and in bfloat16 (widened, summed
    # in float32, rounded once), against its plain twin
    for b, h, w, c, p, gray, odd, _ in CA_EDGES:
        if not gray:
            continue
        img = torch.rand((b, h, w, c), generator=gen).to(device)
        img = odd_offset(img) if odd else img
        coeffs = (torch.rand((p, p, c), generator=gen) - 0.5).to(device)
        compare("ca_pool", ca_pool(img, p, coeffs=coeffs),
                ca_pool_ref_generic(img, coeffs, p),
                f"{tuple(img.shape)} p={p} coeffs=")
        half = img.to(torch.bfloat16)
        compare("ca_pool", ca_pool(half, p, coeffs=coeffs),
                ca_pool_ref_generic(half, coeffs, p).to(torch.bfloat16),
                f"{tuple(img.shape)} p={p} coeffs= bfloat16")

    # the strip kernels: raw accumulate (the path's form) and the fused
    # epilogue with act_scale != 1, relu and bias
    for kernel, run, plain in (
            ("conv_strip", strip.conv_strip, strip.conv_strip_ref),
            ("conv_strip_depthwise", strip.conv_strip_depthwise,
             strip.conv_strip_depthwise_ref),
            ("conv_strip_int", strip.conv_strip_int,
             strip.conv_strip_int_ref)):
        for xp, wf, stride, sh, conv in calls[kernel]:
            kw = (dict(stride=stride) if kernel == "conv_strip_int"
                  else dict(stride=stride, strip_h=sh))
            compare(kernel, run(xp, wf, **kw), plain(xp, wf, **kw), conv)
            co = wf.shape[-1]
            ws = (torch.rand((co,), generator=gen) + 0.5).to(device)
            bias = torch.randn((co,), generator=gen).to(device)
            kw.update(act_scale=0.37, act="relu", bias=bias)
            compare(kernel, run(xp, wf, ws, **kw), plain(xp, wf, ws, **kw),
                    f"{conv} with epilogue")
    for b, h_out, w_out, ci, co, k, stride in STRIP_EDGES:
        xp = torch.randint(0, 16, (b, (h_out - 1) * stride + k,
                                   (w_out - 1) * stride + k, ci),
                           generator=gen).float().to(device)
        wq = torch.randint(-127, 128, (k, k, ci, co),
                           generator=gen).float().to(device)
        ws = (torch.rand((co,), generator=gen) + 0.5).to(device)
        bias = torch.randn((co,), generator=gen).to(device)
        what = f"edge {xp.shape[1:3]} {ci}->{co} k{k} s{stride}"
        # strip_config's edges on the CUDA-core form, forced (the rule
        # gives those from 8 channels the tensor-core form)
        kw = dict(stride=stride, strip_h=h_out)
        compare("conv_strip", strip.conv_strip(xp, wq, form="fma", **kw),
                strip.conv_strip_ref(xp, wq, **kw), what)
        for act in ("relu", "abs", "sign"):
            kw.update(act_scale=0.37, act=act, bias=bias)
            compare("conv_strip", strip.conv_strip(xp, wq, ws, form="fma",
                                                   **kw),
                    strip.conv_strip_ref(xp, wq, ws, **kw), f"{what} {act}")
        # the int8 kernel on u8 codes over the whole byte range and s8
        # levels: raw, every act with ws and bias, ws alone
        x8 = torch.randint(0, 256, xp.shape, generator=gen).to(
            torch.uint8).to(device)
        w8 = wq.to(torch.int8)
        compare("conv_strip_int", strip.conv_strip_int(x8, w8, stride=stride),
                strip.conv_strip_int_ref(x8, w8, stride=stride), what)
        for act in ("none", "relu", "abs", "sign"):
            kw = dict(stride=stride, act_scale=0.37, act=act, bias=bias)
            compare("conv_strip_int", strip.conv_strip_int(x8, w8, ws, **kw),
                    strip.conv_strip_int_ref(x8, w8, ws, **kw),
                    f"{what} {act}")
        kw = dict(stride=stride, act_scale=0.37)
        compare("conv_strip_int", strip.conv_strip_int(x8, w8, ws, **kw),
                strip.conv_strip_int_ref(x8, w8, ws, **kw), f"{what} ws")
    # the dense float kernel's tensor-core form at its edges and at the
    # conv_bank op's calls (batches 8 and 1), every launch it takes
    # forced: integer operands bitwise (raw, every act with and without
    # bias), float operands within 1e-5 (float64 sums in its own order)
    f64_err = 0.0
    for b, h_out, w_out, ci, co, k in F64MMA_EDGES + [
            (bb, h, w, ci, co, k) for bb in (8, 1)
            for _, h, w, ci, co, k in CONV_BANK_CALLS]:
        shape = (b, h_out + k - 1, w_out + k - 1, ci)
        xq = torch.randint(0, 256, shape, generator=gen).float().to(device)
        wq = torch.randint(-127, 128, (k, k, ci, co),
                           generator=gen).float().to(device)
        xf = torch.rand(shape, generator=gen).to(device)
        wf = (torch.randn((k, k, ci, co), generator=gen) * 0.2).to(device)
        ws = (torch.rand((co,), generator=gen) + 0.5).to(device)
        bias = torch.randn((co,), generator=gen).to(device)
        kw = dict(stride=1, strip_h=h_out)
        what = f"f64mma edge {shape} {ci}->{co} k{k}"
        for cfg in strip.f64mma_launches(b, h_out, w_out, ci, co, k, 1):
            def run(x, w, ws=None, act_scale=1.0, act="none", bias=None,
                    cfg=cfg):
                if not x.is_cuda:
                    return strip.conv_strip_ref(x, w, ws, act_scale=act_scale,
                                                act=act, bias=bias, **kw)
                return strip.launch(x, w, ws, bias, act_scale, act, 1, False,
                                    strip.LAUNCHES, cfg=cfg)
            tile = f"{what} {cfg.th}x{cfg.tw} bn{cfg.bn} cc{cfg.cc}"
            compare("conv_strip_f64mma", run(xq, wq),
                    strip.conv_strip_ref(xq, wq, **kw), tile)
            for act in ("none", "relu", "abs", "sign"):
                for bb in (bias, None):
                    e = dict(act_scale=0.37, act=act, bias=bb)
                    compare("conv_strip_f64mma", run(xq, wq, ws, **e),
                            strip.conv_strip_ref(xq, wq, ws, **kw, **e),
                            f"{tile} {act} bias {bb is not None}")
            got, want = run(xf, wf), strip.conv_strip_ref(xf, wf, **kw)
            f64_err = max(f64_err, float((got - want).abs().max()))
            need(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                 f"conv_strip_f64mma {tile} float operands: off the plain "
                 f"version by {f64_err}")
    # the int8 kernel's wgmma form at its edges, forced (the rule gives
    # the narrower ones the mma.sync form): raw, every act with ws and
    # bias, and the folded store (y and each CTA's max) under both
    # calibrations; C_in 7,360 at codes 255 and levels +-127 (|acc| just
    # under 2^31)
    for b, h_out, w_out, ci, co, k in INT_WGMMA_EDGES:
        cfg = strip.igemm_config(b, h_out, w_out, ci, co, k, 1,
                                 form="wgmma")
        what = f"wgmma edge {(b, h_out, w_out)} {ci}->{co} k{k}"
        shape = (b, h_out + k - 1, w_out + k - 1, ci)
        if ci == 7360:
            x8 = torch.full(shape, 255, dtype=torch.uint8)
            w8 = torch.full((k, k, ci, co), 127, dtype=torch.int8)
            w8[1, 1, :, ::2] = -127
        else:
            x8 = torch.randint(0, 256, shape, generator=gen).to(torch.uint8)
            w8 = torch.randint(-127, 128, (k, k, ci, co),
                               generator=gen).to(torch.int8)
        x8, w8 = x8.to(device), w8.to(device)
        ws = (torch.rand((co,), generator=gen) + 0.5).to(device)
        bias = torch.randn((co,), generator=gen).to(device)
        acc = strip.conv_strip_int_ref(x8, w8)
        iw = strip.int_weights(w8, form="wgmma")
        compare("conv_strip_int", strip.conv_strip_int_laid(x8, iw, cfg=cfg),
                acc, what)
        for act in ("none", "relu", "abs", "sign"):
            for bb in (bias, None):
                compare("conv_strip_int", strip.conv_strip_int_laid(
                    x8, strip.int_weights(w8, ws, bb, form="wgmma"), 1,
                    0.37, act, cfg=cfg), strip.conv_strip_int_ref(
                        x8, w8, ws, act_scale=0.37, act=act, bias=bb),
                    f"{what} {act} bias {bb is not None}")
        for scale in (torch.rand((b, 1, 1, 1), generator=gen),
                      torch.rand((), generator=gen)):
            fold = strip.Fold(scale.to(device) * 0.01 + 1e-3, ws * 0.1,
                              bias, "relu")
            y, partials = strip.conv_strip_int_laid(x8, iw, fold=fold,
                                                    cfg=cfg)
            wy, wp = strip.fold_ref(acc, fold, cfg)
            compare("conv_strip_int", y, wy, f"{what} folded store")
            compare("conv_strip_int", partials, wp, f"{what} folded maxima")
    for xs, wshape, level in STRIP_INT_EXTREMES:
        x8 = torch.full(xs, 255, dtype=torch.uint8, device=device)
        w8 = torch.full(wshape, level, dtype=torch.int8, device=device)
        w8[1, 1, :, ::2] = -level
        co = wshape[-1]
        ws = (torch.rand((co,), generator=gen) + 0.5).to(device)
        bias = torch.randn((co,), generator=gen).to(device)
        what = f"extreme {xs} {wshape} {level}"
        got = strip.conv_strip_int(x8, w8)
        need(float(got.abs().max()) > 2 ** 24 or xs[-1] < 64,
             f"{what}: |acc| stays below 2^24")
        compare("conv_strip_int", got, strip.conv_strip_int_ref(x8, w8),
                what)
        kw = dict(act_scale=0.37, act="relu", bias=bias)
        compare("conv_strip_int", strip.conv_strip_int(x8, w8, ws, **kw),
                strip.conv_strip_int_ref(x8, w8, ws, **kw),
                f"{what} with epilogue")
    for b, h_out, w_out, c, k, stride in DW_EDGES:
        xp = torch.randint(0, 16, (b, (h_out - 1) * stride + k,
                                   (w_out - 1) * stride + k, c),
                           generator=gen).float().to(device)
        taps = torch.randint(-127, 128, (k * k, c),
                             generator=gen).float().to(device)
        ws = (torch.rand((c,), generator=gen) + 0.5).to(device)
        bias = torch.randn((c,), generator=gen).to(device)
        what = f"edge {xp.shape[1:3]} c{c} k{k} s{stride}"
        for x in (xp, odd_offset(xp)):      # aligned rows, then none
            kw = dict(stride=stride, strip_h=h_out)
            compare("conv_strip_depthwise",
                    strip.conv_strip_depthwise(x, taps, **kw),
                    strip.conv_strip_depthwise_ref(x, taps, **kw), what)
            kw.update(act_scale=0.37, act="sign", bias=bias)
            compare("conv_strip_depthwise",
                    strip.conv_strip_depthwise(x, taps, ws, **kw),
                    strip.conv_strip_depthwise_ref(x, taps, ws, **kw),
                    f"{what} sign")
    for call, label in calls["epilogue"]:
        compare_epilogue(compare, call, label)
    for i, edge in enumerate(EPILOGUE_EDGES):
        for per_frame in (True, False):
            call = EpilogueCall(*epilogue_case(edge, per_frame, gen,
                                               device))
            compare_epilogue(compare, call, f"edge {i} {edge[1]}")
    for name, xs, wshape, stride, padding, groups in STRIP_CONVS:
        x = torch.randint(0, 16, xs, generator=gen).float().to(device)
        wq = torch.randint(-7, 8, wshape, generator=gen).float().to(device)
        pads = padtype_to_pads(xs[1:3], wshape[0], stride, padding)
        h_out = (xs[1] + sum(pads[0]) - wshape[0]) // stride + 1
        w_out = (xs[2] + sum(pads[1]) - wshape[0]) // stride + 1
        strat = dispatch.select_conv_strategy(
            h_out, w_out, xs[3], wshape[3], wshape[0], stride, groups,
            mode="strip")
        route = dispatch.select_strip_route(xs[3], wshape[3], wshape[0],
                                            stride, groups)
        compare("conv_strip_int" if route == "int" else "conv_strip",
                dispatch.conv_int(x, wq, stride, pads, groups, strat),
                conv_int_ref(x, wq, stride, pads, groups),
                f"{name} {xs}x{wshape}")

    bank_calls = conv_bank_calls(device) + conv_bank_calls(device, True)
    float_err = f64_err
    for x, w, b in bank_calls:
        for strategy in ("resident", "strip"):
            kw = dict(spec=W4A4, strategy=strategy, act="relu", bias=b)
            compare(bank_kernel(x, w, strategy, True), conv_bank(x, w, **kw),
                    conv_bank_plain(x, w, **kw),
                    f"conv_bank {strategy} {x.shape[-1]}->{w.shape[-1]} "
                    f"k={w.shape[0]}")
            if strategy == "resident":
                # the op's whole-frame launch of the float kernel (in the
                # form its rule gives) on the same quantized operands,
                # bitwise its plain version
                from repro_torch.core.quant import quantize_weight, true_div
                from repro_torch.kernels.conv_bank import ops as bank_ops
                k = w.shape[0]
                codes = torch.clamp(torch.round(true_div(x, 1 / 15.0)), 0,
                                    15)
                wq, ws = quantize_weight(w, W4A4)
                xq = torch.nn.functional.pad(
                    codes, (0, 0, k // 2, k // 2, k // 2, k // 2))
                kw = dict(act_scale=1 / 15.0, act="relu", bias=b)
                compare(bank_kernel(x, w, strategy, False), strip.launch(
                    xq, wq.float(), ws.reshape(-1), b, 1 / 15.0, "relu", 1,
                    False, bank_ops.LAUNCHES) if x.is_cuda else
                    strip.conv_strip_ref(xq, wq.float(), ws.reshape(-1), 1,
                                         x.shape[1], **kw),
                    strip.conv_strip_ref(xq, wq.float(), ws.reshape(-1), 1,
                                         x.shape[1], **kw),
                    f"conv_bank whole frame, float kernel "
                    f"{x.shape[-1]}->{w.shape[-1]} k={k}")
            got = conv_bank(x, w, strategy=strategy)
            want = conv_bank_plain(x, w, strategy=strategy)
            float_err = max(float_err, float((got - want).abs().max()))
            need(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                 f"conv_bank float mode {strategy} {x.shape[-1]}->"
                 f"{w.shape[-1]} k={w.shape[0]}: off its plain version by "
                 f"{float_err}")
    return ({k: max(v) for k, v in errs.items()},
            {k: len(v) for k, v in errs.items()}, float_err)


def phase_conv_bank_op(device):
    """The conv_bank op's entry point on its own calls and the narrow one,
    counts zeroed around it (no served path reaches it): quantized (the
    int8 kernel where ``strip.dense_route`` sends the shape) and in float
    mode (the float kernel's tensor-core form where ``strip.dense_form``
    gives it, else its CUDA-core form over the whole frame or over
    strips), both strategies. Returns the counts, and the launches each
    counter should have made (:func:`bank_kernel`, one a call)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    calls = conv_bank_calls(device) + conv_bank_calls(device, True)
    strategies = ("resident", "strip")
    reset_launch_counts()
    outs = run_conv_bank_op(calls) + run_conv_bank_op(calls,
                                                      quantized=False)
    if device.type == "cuda":
        torch.cuda.synchronize()
    counts = launch_counts()
    expected = dict.fromkeys(counts, 0)
    for quantized in (True, False):
        for x, w, _ in calls:
            for strategy in strategies:
                expected[bank_kernel(x, w, strategy, quantized)] += 1
    for out, (x, w, _) in zip(outs, [c for c in calls for _ in strategies]
                              * 2):
        need(out.shape == (*x.shape[:3], w.shape[-1])
             and bool(torch.isfinite(out).all()),
             f"conv_bank op: bad answer {tuple(out.shape)}")
    return counts, expected


def timer(device):
    import torch

    def time_ms(fn, iters=50 if device.type == "cuda" else 2):
        for _ in range(3 if device.type == "cuda" else 1):
            fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    return time_ms


def bound_ms(nbytes, ops, kind):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def epilogue_accumulate(call):
    """An ``edge_shapes.EpilogueCall``'s input to the epilogue: its x, or
    for a folded conv's the conv's accumulate (an empty tensor of its
    shape: only the geometry is read)."""
    import torch
    if not call.folded:
        return call.x
    x8, w8, stride = call.x, call.levels.w8, call.stride
    k = w8.shape[0]
    return torch.empty((x8.shape[0], (x8.shape[1] - k) // stride + 1,
                        (x8.shape[2] - k) // stride + 1, w8.shape[-1]),
                       device=x8.device)


def epilogue_work(call):
    """(bytes, operations, launch) of one epilogue call (an
    ``edge_shapes.EpilogueCall``): its input -- for a folded conv
    the accumulate the conv would have written -- read once and its codes
    (or the operand) written once, with the scales; a product, a sum and
    an activation an input element, a quotient, a rounding and a clamp an
    output (fp32 work): the same work whichever form does it. The launch
    ``epilogue_config`` gives it: the form (cluster, pair or the fold's
    pass 2) and its CTAs."""
    import torch
    from repro_torch.kernels.epilogue.ops import epilogue_config, geometry
    g = geometry(epilogue_accumulate(call), call.pool, call.operand)
    fold = call.folded
    cfg = epilogue_config(g.b, g.n, g.c, g.aligned, g.op_words, g.p,
                          call.per_frame, False, fold)
    n_in, n_out = g.b * g.n * g.p * g.p, g.b * g.n
    nbytes = n_in * 4 + (g.b * g.op_words * 4 if call.operand
                         else n_out * 4) + \
        4 * sum(t.numel() for t in (call.act_scale, call.ws, call.bias)
                if isinstance(t, torch.Tensor)) + \
        4 * (g.b if call.per_frame else 1)
    form = "fold" if fold else "cluster" if cfg.cluster else "pair"
    return nbytes, 3 * n_in + 3 * n_out, dict(
        form=form, vec=cfg.vec, nblk1=cfg.nblk1, nblk2=cfg.nblk2,
        cluster=cfg.cluster,
        ctas=g.b * (cfg.cluster or (cfg.nblk2 if fold else
                                    cfg.nblk1 + cfg.nblk2)))


def epilogue_forms(call):
    """The launches an ``ops.epilogue`` call (an ``edge_shapes.
    EpilogueCall``, per frame) can take, by name: the pair (``pair``) and
    a cluster of each of ``ops.CLUSTERS`` CTAs a frame where its slices
    fit (``cluster4``, ``cluster8``, ``cluster16``)."""
    from repro_torch.kernels.epilogue import ops
    g = ops.geometry(ops._frames(call.x), call.pool, call.operand)
    base = ops.epilogue_config(g.b, g.n, g.c, g.aligned, g.op_words, g.p)
    vec = base.vec
    out = {"pair": ops.EpilogueConfig(vec, base.nblk1, base.nblk2)}
    for cl in ops.CLUSTERS:
        smem = ops.cluster_smem(g.n, g.c, vec, cl, g.op_words > 0)
        if smem <= ops.SMEM_MAX:
            out[f"cluster{cl}"] = ops.EpilogueConfig(vec, cluster=cl,
                                                     smem=smem)
    return out


def epilogue_launch(call, cfg):
    """``ops.epilogue``'s call on ``call`` (an ``edge_shapes.
    EpilogueCall``) in the launch ``cfg`` (on the CPU its plain
    version)."""
    from repro_torch.kernels.epilogue import ops
    if not call.x.is_cuda:
        return ops.epilogue_ref(call.x, **call.requant())
    return ops.launch(call.x, **call.requant(), config=cfg)


def mvm_library(a, w):
    """One PyTorch call for photonic_mvm's raw accumulate: ``torch._int_mm``
    where it is legal (M > 16, K and N multiples of 8), else a float32
    matmul of the same integers (exact: the sums stay below 2^24)."""
    import torch
    m, k = a.shape
    n = w.shape[1]
    if a.is_cuda and m > 16 and k % 8 == 0 and n % 8 == 0:
        return (lambda: torch._int_mm(a, w)), "torch._int_mm"
    af, wf = a.float(), w.float()
    return (lambda: af @ wf), "f32 matmul"


def strip_library(xp, wf, stride, dw):
    """``F.conv2d`` on the same padded codes (NCHW views; groups=C for the
    depthwise kernel): the strip kernels' one-call yardstick."""
    import torch.nn.functional as F
    co = wf.shape[-1]
    k = math.isqrt(wf.shape[0]) if dw else wf.shape[0]
    w_oihw = (wf.t().reshape(co, 1, k, k) if dw
              else wf.permute(3, 2, 0, 1)).contiguous()
    nchw = xp.permute(0, 3, 1, 2)
    groups = co if dw else 1
    return lambda: F.conv2d(nchw, w_oihw, stride=stride, groups=groups)


def phase_timing(device, vision, imaging):
    """Per kernel, its calls for one bucket-8 batch summed: the slice-1
    kernels on the vision path, the strip kernels on the imaging path, the
    conv_bank op on its own calls."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.compressive import ca_coefficients
    from repro_torch.core.compressive import compressive_acquire
    from repro_torch.core.quant import W4A4
    from repro_torch.kernels.ca_pool.ops import acquire, ca_config
    from repro_torch.kernels.conv_bank import strip
    from repro_torch.kernels.conv_bank.fused import conv_chain
    from repro_torch.kernels.conv_bank.ops import conv_bank, conv_bank_plain
    from repro_torch.kernels.conv_bank.ref import conv_chain_ref, float32_convs
    from repro_torch.kernels.photonic_mvm.ref import mvm_int_ref
    time_ms = timer(device)
    rows, detail = {}, {k: [] for k in KERNELS}
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else 132)

    def add(kernel, ms, plain, lib, nbytes, ops, kind, path=None, **shape):
        b, by = bound_ms(nbytes, ops, kind)
        detail[kernel].append(dict(shape, path=path, ms=ms, plain_ms=plain,
                                   library_ms=lib, bound_ms=b, bound_by=by,
                                   bytes=nbytes, ops=ops))
        r = rows.setdefault(kernel, {"ms": 0.0, "plain_ms": 0.0,
                                     "library_ms": 0.0, "bound_ms": 0.0,
                                     "t_bytes": 0.0, "t_ops": 0.0,
                                     "library_exact": None, "by_path": {}})
        p = r["by_path"].setdefault(path, {"ms": 0.0, "plain_ms": 0.0,
                                           "library_ms": 0.0,
                                           "bound_ms": 0.0, "calls": 0})
        for acc in (r, p):
            acc["ms"] += ms
            acc["plain_ms"] += plain
            acc["library_ms"] = None if lib is None or \
                acc["library_ms"] is None else acc["library_ms"] + lib
            acc["bound_ms"] += b
        p["calls"] += 1
        r["t_bytes"] += nbytes / HBM_BYTES_PER_S * 1e3
        r["t_ops"] += ops / PEAK_OPS[kind] * 1e3
        if "library_exact" in shape:       # None: not the same function
            r["library_exact"] = shape["library_exact"] and \
                r["library_exact"] is not False

    from repro_torch.kernels.conv_bank.fused import (chain_config,
                                                     max_active_clusters)
    from repro_torch.kernels.conv_bank.strip import dw_config, strip_config
    from repro_torch.kernels.photonic_mvm.ops import (mvm_config,
                                                      mvm_int_laid,
                                                      mvm_weights)
    mvm_calls = [("vision", a, w) for a, w in vision["photonic_mvm"]] + \
        [("imaging", a, w) for a, w in imaging["photonic_mvm"]]
    for path, a, w in mvm_calls:          # the path's form: no ws
        m, k = a.shape
        n = w.shape[1]
        cfg = mvm_config(m, k, n)
        lib_fn, lib_name = mvm_library(a, w)
        mw = mvm_weights(w)               # laid out once, as at bind
        add("photonic_mvm", time_ms(lambda: mvm_int_laid(a, mw)),
            time_ms(lambda: mvm_int_ref(a, w)), time_ms(lib_fn),
            m * k + k * n + 4 * m * n, 2 * m * n * k, "int8", path,
            M=m, K=k, N=n, library=lib_name, route=cfg.route,
            tile=[cfg.bm, cfg.bn], ctas=cfg.ctas)

    for codes, scale, stages, aq in vision["conv_chain"]:
        b = codes.shape[0]
        nbytes = codes.numel() * 4 + b * 4 * 2
        ops = 0
        for g, wq, ws, bias in stages:
            hc, wc = g.conv_hw()
            ops += 2 * b * hc * wc * g.c_out * g.kernel * g.kernel * (
                g.c_in // g.groups)
            nbytes += wq.numel() * 4 + 4 * g.c_out * (2 if bias is not None
                                                      else 1)
        h, w = stages[-1][0].out_hw()
        nbytes += b * h * w * stages[-1][0].c_out * 4
        cfg = chain_config(b, [g for g, _, _, _ in stages])
        active = (max_active_clusters(cfg.cluster, cfg.smem)
                  if device.type == "cuda" else None)
        add("conv_chain",
            time_ms(lambda: conv_chain(codes, scale, stages, aq)),
            time_ms(lambda: conv_chain_ref(codes, scale, stages, aq)), None,
            nbytes, ops, "int8", "vision", B=b,
            stages="+".join(g.name for g, _, _, _ in stages),
            cluster=cfg.cluster, ctas=cfg.ctas, splits=list(cfg.splits),
            weights_in_smem=[o >= 0 for o in cfg.w_offsets], smem=cfg.smem,
            active_clusters=active)

    ca_calls = [("vision", img, p) for img, p in vision["ca_pool"]] + \
        [("imaging", img, p) for img, p in imaging["ca_pool"]]
    for path, img, p in ca_calls:
        b, h, w, c = img.shape
        coef = ca_coefficients(p, c, device=device)
        bank = coef.permute(2, 0, 1)[None].contiguous()   # [1, C, p, p]
        nchw = img.permute(0, 3, 1, 2)
        out_n = b * (h // p) * (w // p)
        cfg = ca_config(b, h, w, c, p, True, sms, img.data_ptr() % 16 == 0)
        with float32_convs():
            lib = time_ms(lambda: F.conv2d(nchw, bank, stride=p))
        add("ca_pool", time_ms(lambda: acquire(img, p, True)),
            time_ms(lambda: compressive_acquire(img, p, True)), lib,
            img.numel() * 4 + coef.numel() * 4 + out_n * 4,
            2 * out_n * p * p * c, "tf32", path, B=b, H=h, W=w, C=c,
            pool=p, library="F.conv2d with the coefficient bank",
            route=cfg.route, r=cfg.r, threads=cfg.threads, ctas=cfg.ctas)

    # the epilogue at each requant of the two paths; no one PyTorch call
    # computes it (its plain version is the torch-op sequence)
    from repro_torch.kernels.edge_shapes import epilogue_fns
    for path in ("vision", "imaging"):
        for call, label in {"vision": vision,
                            "imaging": imaging}[path]["epilogue"]:
            nbytes, ops, launch = epilogue_work(call)
            kernel, plain = epilogue_fns(call)
            add("epilogue", time_ms(kernel), time_ms(plain), None, nbytes,
                ops, "fp32", path, conv=label, x=list(call.x.shape),
                act=call.act, epi_pool=call.pool,
                operand=call.operand is not None, **launch)

    # the strip kernels: F.conv2d (TF32 off; groups=C for depthwise) on the
    # same padded codes is the yardstick; record whether cuDNN was exact
    for kernel, run, plain in (
            ("conv_strip", strip.conv_strip, strip.conv_strip_ref),
            ("conv_strip_depthwise", strip.conv_strip_depthwise,
             strip.conv_strip_depthwise_ref)):
        for xp, wf, stride, sh, conv in imaging[kernel]:
            b, hp, wp, c_in = xp.shape
            dw = kernel == "conv_strip_depthwise"
            k = math.isqrt(wf.shape[0]) if dw else wf.shape[0]
            co = wf.shape[-1]
            lib_fn = strip_library(xp, wf, stride, dw)
            kw = dict(stride=stride, strip_h=sh)
            out = run(xp, wf, **kw)
            with float32_convs():
                lib = time_ms(lib_fn)
                exact = torch.equal(lib_fn().permute(0, 2, 3, 1), out)
            n_out = out.numel()
            macs = n_out * k * k * (1 if dw else c_in)
            if dw:
                cfg = dw_config(b, out.shape[1], out.shape[2], c_in, k,
                                stride)
                launch = dict(tile=[cfg.tx, cfg.tyt * cfg.run], run=cfg.run,
                              cb=cfg.cb, ctas=cfg.ctas)
            else:
                launch = dict(ctas=strip_config(
                    b, out.shape[1], out.shape[2], c_in, co, k, stride).ctas)
            add(kernel, time_ms(lambda: run(xp, wf, **kw)),
                time_ms(lambda: plain(xp, wf, **kw)), lib,
                (xp.numel() + wf.numel() + n_out) * 4, 2 * macs, "int8",
                "imaging", conv=conv, x_padded=list(xp.shape),
                w=list(wf.shape), stride=stride, library="F.conv2d" + (
                    f" groups={co}" if dw else ""), library_exact=exact,
                **launch)

    # the conv_bank op: its quantized calls (on the kernel
    # ``strip.dense_route`` picks) and its float mode (the float kernel's
    # tensor-core form, ``strip.dense_form``), and the narrow call, whose
    # whole-frame launch is the CUDA-core form's "conv_bank" count
    for x, w, bias in conv_bank_calls(device) + conv_bank_calls(device,
                                                                 True):
        b, h, ww, ci = x.shape
        k, co = w.shape[0], w.shape[-1]
        kw = dict(spec=W4A4, strategy="resident", act="relu", bias=bias)
        nchw = x.permute(0, 3, 1, 2)
        w_oihw = w.permute(3, 2, 0, 1).contiguous()

        def lib_fn(nchw=nchw, w_oihw=w_oihw, k=k, bias=bias):
            return torch.relu(F.conv2d(nchw, w_oihw, bias, padding=k // 2))

        def float_lib(nchw=nchw, w_oihw=w_oihw, k=k):
            return F.conv2d(nchw, w_oihw, padding=k // 2)
        with float32_convs():
            lib = time_ms(lib_fn)
            flib = time_ms(float_lib)
        n_out = b * h * ww * co
        route = strip.dense_route(ci, co, k, 1)
        launch = (dict(ctas=strip.igemm_config(b, h, ww, ci, co, k, 1).ctas)
                  if route == "int" else
                  dict(ctas=strip.dense_config(b, h, ww, ci, co, k, 1).ctas))
        add(bank_kernel(x, w, "resident", True),
            time_ms(lambda: conv_bank(x, w, **kw)),
            time_ms(lambda: conv_bank_plain(x, w, **kw)), lib,
            (x.numel() + w.numel() + 2 * co + n_out) * 4,
            2 * n_out * k * k * ci, "int8", "conv_bank_op", x=list(x.shape),
            w=list(w.shape), strategy="resident", quantized=True,
            library="F.conv2d + bias + relu (float)", **launch)
        cfg = strip.dense_config(b, h, ww, ci, co, k, 1)
        add(bank_kernel(x, w, "resident", False),
            time_ms(lambda: conv_bank(x, w, strategy="resident")),
            time_ms(lambda: conv_bank_plain(x, w, strategy="resident")),
            flib, (x.numel() + w.numel() + n_out) * 4,
            2 * n_out * k * k * ci, "fp64", "conv_bank_op_float",
            x=list(x.shape), w=list(w.shape), strategy="resident",
            quantized=False, library="F.conv2d (float, TF32 off)",
            form=cfg.form, ctas=cfg.ctas)
    return rows, detail


def load_trace(prof, path):
    """Export a finished profiler session as a Chrome trace at ``path``
    and return its events."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


def host_range(events, name):
    """(start, end) in µs of the one host annotation ``name``."""
    found = [e for e in events if e.get("name") == name
             and e.get("cat") == "user_annotation"]
    need(len(found) == 1, f"trace: {len(found)} ranges named {name}")
    return found[0]["ts"], found[0]["ts"] + found[0]["dur"]


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_work(events, name, cats=DEVICE_CATS):
    """The device events (of the categories ``cats``) that the host called
    for inside the host range ``name``, and how many launches of a kernel
    it made there. Matched by CUPTI correlation id to the runtime or
    driver call that issued them, not by timestamp: the trace's device
    clock can sit further from the host clock than a range is long."""
    lo, hi = host_range(events, name)
    calls = [e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and lo <= e["ts"] <= hi and "correlation" in e.get("args", {})]
    ids = {e["args"]["correlation"] for e in calls}
    launches = sum("LaunchKernel" in e["name"] for e in calls)
    return [e for e in events if e.get("cat") in cats
            and e.get("args", {}).get("correlation") in ids], launches


def phase_device_time(device, vision, imaging, trace_path,
                      iters=DEVICE_ITERS):
    """Device time of each kernel per bucket-8 batch (all its calls), from
    one ``torch.profiler`` session: each kernel's batches run in a host
    range that ends in a synchronize, so its device work lies inside the
    range; the kernel's own device time there is summed. photonic_mvm's
    imaging calls are their own range (``photonic_mvm.imaging``), and each
    path shape of photonic_mvm and of the dense strip conv is timed alone,
    beside its library call (``<kernel>.shape<i>``, ``library.<kernel>.
    shape<i>``: every kernel the library launched); ``ca_pool.cold`` is
    the first p = 1 imaging call with ``L2_FLUSH_BYTES`` written before
    each launch, so it reads its input from HBM. None where the profiler
    shows no device time."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.core.compressive import ca_coefficients
    from repro_torch.kernels.ca_pool.ops import acquire
    from repro_torch.kernels.conv_bank import strip
    from repro_torch.kernels.conv_bank.fused import conv_chain
    from repro_torch.kernels.conv_bank.ref import float32_convs
    from repro_torch.kernels.edge_shapes import epilogue_fns
    from repro_torch.kernels.photonic_mvm.ops import mvm_int_laid, mvm_weights
    if device.type != "cuda":
        return {k: None for k in KERNELS + ("photonic_mvm.imaging",
                                          "ca_pool.imaging", "ca_pool.cold",
                                          "epilogue.imaging")}
    bank = conv_bank_calls(device)
    narrow = conv_bank_calls(device, True)
    # the levels laid out once, as a bound view lays them out at bind
    laid = {path: [(a, mvm_weights(w)) for a, w in calls["photonic_mvm"]]
            for path, calls in (("vision", vision), ("imaging", imaging))}
    batches = {
        "photonic_mvm": lambda: [mvm_int_laid(a, mw)
                                 for a, mw in laid["vision"]],
        "photonic_mvm.imaging": lambda: [mvm_int_laid(a, mw)
                                         for a, mw in laid["imaging"]],
        "conv_chain": lambda: [conv_chain(*c) for c in vision["conv_chain"]],
        "ca_pool": lambda: [acquire(img, p, True)
                            for img, p in vision["ca_pool"]],
        "ca_pool.imaging": lambda: [acquire(img, p, True)
                                    for img, p in imaging["ca_pool"]],
        "conv_strip": lambda: [strip.conv_strip(xp, w, stride=s, strip_h=sh)
                               for xp, w, s, sh, _ in imaging["conv_strip"]],
        "conv_strip_depthwise": lambda: [
            strip.conv_strip_depthwise(xp, w, stride=s, strip_h=sh)
            for xp, w, s, sh, _ in imaging["conv_strip_depthwise"]],
        "conv_bank": lambda: run_conv_bank_op(narrow, ("resident",)) +
        run_conv_bank_op(narrow, ("resident",), quantized=False),
        "conv_strip_f64mma": lambda: run_conv_bank_op(
            bank, ("resident",), quantized=False),
        "conv_strip_int.conv_bank_op": lambda: run_conv_bank_op(
            bank, ("resident",)),
        "epilogue": lambda: [epilogue_fns(a)[0]()
                             for a, _ in vision["epilogue"]],
        "epilogue.imaging": lambda: [epilogue_fns(a)[0]()
                                     for a, _ in imaging["epilogue"]]}
    # each requant of the two paths in every form it can take (the rule's
    # numbers: epilogue_config picks among them)
    for i, (call, _) in enumerate(vision["epilogue"] + imaging["epilogue"]):
        for form, cfg in epilogue_forms(call).items():
            batches[f"epilogue.form.{form}.{i}"] = \
                lambda a=call, c=cfg: epilogue_launch(a, c)
    # per path shape of the two redesigned kernels: the kernel, and the
    # library call on the same inputs (all of its kernels)
    mvm_calls = vision["photonic_mvm"] + imaging["photonic_mvm"]
    for i, ((a, w), (_, mw)) in enumerate(zip(
            mvm_calls, laid["vision"] + laid["imaging"])):
        batches[f"photonic_mvm.shape{i}"] = \
            lambda a=a, mw=mw: mvm_int_laid(a, mw)
        batches[f"library.photonic_mvm.shape{i}"] = mvm_library(a, w)[0]
    for kernel, run in (("conv_strip", strip.conv_strip),
                        ("conv_strip_depthwise", strip.conv_strip_depthwise)):
        for i, (xp, w, s, sh, _) in enumerate(imaging[kernel]):
            batches[f"{kernel}.shape{i}"] = \
                lambda xp=xp, w=w, s=s, sh=sh, run=run: run(
                    xp, w, stride=s, strip_h=sh)
            batches[f"library.{kernel}.shape{i}"] = strip_library(
                xp, w, s, kernel == "conv_strip_depthwise")
    # each of the conv_bank op's timed calls, beside its library call
    seen = {}
    for kernel, fn, lib in bank_entries(device):
        i = seen[kernel] = seen.get(kernel, -1) + 1
        batches[f"{kernel}.shape{i}"] = fn
        batches[f"library.{kernel}.shape{i}"] = lib
    for i, (img, p) in enumerate(vision["ca_pool"] + imaging["ca_pool"]):
        coef = ca_coefficients(p, img.shape[-1], device=device)
        coef_bank = coef.permute(2, 0, 1)[None].contiguous()
        batches[f"ca_pool.shape{i}"] = lambda img=img, p=p: acquire(img, p,
                                                                  True)
        batches[f"library.ca_pool.shape{i}"] = \
            lambda nchw=img.permute(0, 3, 1, 2), cb=coef_bank, p=p: F.conv2d(
                nchw, cb, stride=p)
    img1 = next(img for img, p in imaging["ca_pool"] if p == 1)
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=device)
    batches["ca_pool.cold"] = lambda: (flush.zero_(), acquire(img1, 1, True))
    with float32_convs():                # F.conv2d without TF32
        for batch in batches.values():
            batch()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for name, batch in batches.items():
                with record_function(DEVICE_RANGE + name):
                    for _ in range(iters):
                        batch()
                    torch.cuda.synchronize()
    events = load_trace(prof, trace_path)
    out = {}
    for name in batches:
        kernels, launches = device_work(events, DEVICE_RANGE + name,
                                        ("kernel",))
        head = name.split(".")[0]
        symbol = ".*" if head == "library" else KERNEL_SYMBOLS[head]
        total = sum(e["dur"] for e in kernels
                    if re.search(symbol, e["name"].replace(" ", "")))
        if len(kernels) < launches:       # the profiler lost a record
            log(f"[device time] {name}: {len(kernels)} kernel records for "
                f"{launches} launches; not measured")
            total = 0
        # microseconds over `iters` batches -> ms per batch
        out[name] = total / iters / 1e3 if total > 0 else None
    return out


def profile_ranges(device, fns, trace_path, iters):
    """Device ms per call of each of ``fns`` (every kernel it launched),
    from one profiler session: each runs ``iters`` times in its own host
    range ending in a synchronize. None where the profiler lost a
    record."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels.conv_bank.ref import float32_convs
    with float32_convs():
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # a range nobody reads first (a session can lose the records
            # of its first launches)
            with record_function(f"{DEVICE_RANGE}warm"):
                for _ in range(VGG16_WARM_LAUNCHES):
                    torch.zeros(1, device=device)
                torch.cuda.synchronize()
            for name, fn in fns.items():
                with record_function(DEVICE_RANGE + name):
                    for _ in range(iters):
                        fn()
                    torch.cuda.synchronize()
    events = load_trace(prof, trace_path)
    out = {}
    for name in fns:
        kernels, launches = device_work(events, DEVICE_RANGE + name,
                                        ("kernel",))
        measured = kernels and len(kernels) >= launches
        if not measured:
            log(f"[route] {name}: {len(kernels)} kernel records for "
                f"{launches} launches; not measured")
        out[name] = (sum(e["dur"] for e in kernels) / iters / 1e3
                     if measured else None)
    return out


def phase_routes(device, imaging_exes, trace_path):
    """The route rule's numbers: at each dense strip conv of the imaging
    path (bucket 8) and each of the conv_bank op's quantized calls, the
    device time of the float64 route and of the int8 one, from the same
    codes and levels (float: the f32 border pad and the float64 kernel,
    or the op's strip; int: the uint8 cast, the pad and the int8 kernel
    with its weight layout), beside what ``strip.dense_route`` picks.
    VGG16's conv1-conv10 are timed both ways in [vgg16]. Then the float
    kernel's form rule's: at each of the op's float calls at batches 8
    and 1, the device time of its CUDA-core form and of its tensor-core
    form, each forced, beside ``F.conv2d`` (TF32 off), the bound at the
    FP64 tensor rate and what ``strip.dense_form`` picks."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.plan import ConvStep
    from repro_torch.core.quant import W4A4, quantize_weight, true_div
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.conv_bank import strip
    gen = torch.Generator().manual_seed(SEED + 25)
    cases = []
    for name, exe in imaging_exes.items():
        plan, params = exe.plan, exe.params()
        for step in plan.steps:
            if not isinstance(step, ConvStep) or \
                    step.strategy.kind != "strip" or step.geom.depthwise:
                continue
            g = step.geom
            wq, _ = quantize_weight(params[step.name]["w"], step.wa)
            codes = torch.randint(0, 16, (BUCKET, g.h_in, g.w_in, g.c_in),
                                  generator=gen).float().to(device)
            args = (codes, wq.to(device), g.stride, g.pads, g.groups,
                    step.strategy)
            cases.append(dict(
                shape=f"{name}.{step.name} {BUCKET}x{g.h_in}x{g.w_in} "
                      f"{g.c_in}->{g.c_out} k{g.kernel}",
                c_in=g.c_in, c_out=g.c_out, k=g.kernel, stride=g.stride,
                float=lambda a=args: dispatch.conv_int(*a, route="float"),
                int=lambda a=args: dispatch.conv_int(*a, route="int")))
    for x, w, bias in conv_bank_calls(device):
        k, ci, co = w.shape[0], w.shape[2], w.shape[3]
        p = k // 2
        codes = torch.clamp(torch.round(true_div(x, 1.0 / 15.0)), 0, 15)
        wq, ws = quantize_weight(w, W4A4)
        kw = dict(act_scale=1.0 / 15.0, act="relu", bias=bias)
        h = x.shape[1]
        cases.append(dict(
            shape=f"conv_bank op {tuple(x.shape)} {ci}->{co} k{k}",
            c_in=ci, c_out=co, k=k, stride=1,
            float=lambda c=codes, wf=wq.float(), ws=ws.reshape(-1), p=p,
            h=h, kw=kw: strip.conv_strip(F.pad(c, (0, 0, p, p, p, p)), wf,
                                         ws, strip_h=h, **kw),
            int=lambda c=codes, wq=wq, ws=ws.reshape(-1), p=p, kw=kw:
            strip.conv_strip_int(*strip.int_operands(c, wq, ((p, p), (p, p))),
                                 ws, **kw)))
    for c in cases:
        need(torch.equal(c["float"](), c["int"]()),
             f"[route] {c['shape']}: the two routes differ")
    # the float kernel's two forms, forced, at the op's float calls at
    # batches 8 and 1, beside F.conv2d (TF32 off): the rule's numbers
    forms = []
    for x, w, _ in conv_bank_calls(device):
        for b in (8, 1):
            k, ci, co = w.shape[0], w.shape[2], w.shape[3]
            xp = F.pad(x[:b], (0, 0, k // 2, k // 2, k // 2, k // 2))
            h = x.shape[1]
            fns = {form: lambda xp=xp, w=w, h=h, form=form: strip.conv_strip(
                xp, w, strip_h=h, form=form) for form in ("fma", "f64mma")}
            fns["library"] = lambda n=xp.permute(0, 3, 1, 2), \
                wo=w.permute(3, 2, 0, 1).contiguous(): F.conv2d(n, wo)
            need(torch.allclose(fns["fma"](), fns["f64mma"](), rtol=1e-5,
                                atol=1e-5),
                 f"[route] conv_bank op float {b} {ci}->{co} k{k}: the two "
                 f"forms differ")
            n_out = b * h * x.shape[2] * co
            bound, by = bound_ms((xp.numel() + w.numel() + n_out) * 4,
                                 2 * n_out * k * k * ci, "fp64")
            forms.append(dict(
                shape=f"conv_bank op float {b}x{h}x{x.shape[2]} {ci}->{co} "
                      f"k{k}", batch=b, c_in=ci, c_out=co, k=k, fns=fns,
                rule=strip.dense_form(b, h, x.shape[2], ci, co, k, 1),
                bound_ms=bound, bound_by=by))
    if device.type != "cuda":
        times = {}
    else:
        ranges = {f"route.{i}.{r}": c[r] for i, c in enumerate(cases)
                  for r in ("float", "int")}
        ranges.update({f"form.{i}.{f}": fn for i, c in enumerate(forms)
                       for f, fn in c["fns"].items()})
        times = profile_ranges(device, ranges, trace_path, ROUTE_ITERS)
    rows = []
    for i, c in enumerate(cases):
        f_ms, i_ms = (times.get(f"route.{i}.{r}") for r in ("float", "int"))
        rows.append(dict(
            shape=c["shape"], c_in=c["c_in"], c_out=c["c_out"], k=c["k"],
            float_device_ms=f_ms, int_device_ms=i_ms,
            rule=strip.dense_route(c["c_in"], c["c_out"], c["k"],
                                   c["stride"]),
            faster=None if None in (f_ms, i_ms) else
            ("int" if i_ms < f_ms else "float")))
    for i, c in enumerate(forms):
        ms = {f: times.get(f"form.{i}.{f}") for f in c.pop("fns")}
        rows.append(dict(c, **{f"{f}_device_ms": v for f, v in ms.items()},
                         faster=None if None in (ms["fma"], ms["f64mma"])
                         else min(("fma", "f64mma"), key=ms.get)))
    return rows


def check_served(name, prog, frames, served, dev, out_shape):
    """Served answers against batch-1 runs, the reference backend and the
    CPU port, all bitwise."""
    import numpy as np
    from repro_torch import Options
    from repro_torch.core.quant import W4A4
    need(served.shape == (frames.shape[0], *out_shape),
         f"{name}: answer shape {served.shape}")
    need(bool(np.isfinite(served).all()), f"{name}: non-finite answer")
    exe = prog.compile(Options(scheme=W4A4, device=dev))
    singles = np.concatenate([exe.run_per_frame(frames[i:i + 1]).cpu()
                              .numpy() for i in range(len(frames))])
    need(np.array_equal(served, singles),
         f"{name}: served answers differ from batch-1 run_per_frame")
    ref = prog.compile(Options(scheme=W4A4, device=dev, backend="reference"))
    need(np.array_equal(served, ref.run_per_frame(frames).cpu().numpy()),
         f"{name}: served answers differ from the reference backend")
    cpu = prog.compile(Options(scheme=W4A4, device="cpu"))
    need(np.array_equal(served[:4], cpu.run_per_frame(frames[:4]).numpy()),
         f"{name}: served answers differ from the port's CPU run")


def make_server(device, progs, bound, devices=1, hooks=None, slo=None,
                options=None, **config):
    """A ``serve.Server`` on ``device`` with buckets 1/2/4/8 and two batches
    in flight per device, hosting ``progs``; returns it started, with its
    hosted programs by name. ``bound``: every batch goes through the bound
    views (pinned staging ring, one CUDA graph per bucket, captured while
    the server warms), past ``hooks`` if given. Otherwise every batch goes,
    through the ``Hooks.execute`` seam, to the unbound executable's eager
    ``run_padded``, as the port served before ``Executable.bind`` (each
    bucket warmed; pageable copies). ``slo`` maps program names to their
    SLOs; ``options`` replaces the W4A4 ``Options`` on ``device``;
    ``config`` adds ``ServeConfig`` fields."""
    from repro_torch import Options, serve
    from repro_torch.core.quant import W4A4
    dev = str(device)
    hosted = {}

    def eager(program, index, frames, bucket, default):
        return hosted[program].executable.run_padded(frames, bucket)

    server = serve.Server(
        serve.ServeConfig(max_batch=BUCKET, max_wait_ms=2.0, device=dev,
                          devices=devices, max_inflight=2,
                          batch_buckets=BUCKETS, **config),
        hooks=hooks if bound else serve.Hooks(execute=eager))
    for name, prog in progs.items():
        hosted[name] = server.register(
            name, prog, options or Options(scheme=W4A4, device=dev),
            slo=(slo or {}).get(name))
    server.start(warm=bound)
    if not bound:
        for h in hosted.values():
            h.executable.warm(BUCKETS)
    return server, hosted


def credited(hosted):
    """Launches credited so far by the replays of every captured graph of
    the hosted programs' bound views, by kernel."""
    out = dict.fromkeys(KERNELS, 0)
    for h in hosted.values():
        for exe in h.bound:
            for g in exe._binding.graphs.values():
                for k, n in g.launches.items():
                    out[k] += g.replays * n
    return out


def mvm_levels_not_laid(hosted):
    """The dense layers and one-group resident convs whose photonic_mvm
    levels a bound view of ``hosted`` did not lay out at bind (each would
    be laid out on every call of the bound path); empty when none."""
    from repro_torch.core.plan import ConvStep, DenseStep
    from repro_torch.kernels.photonic_mvm.ops import MvmWeights
    out = []
    for h in hosted.values():
        for exe in h.bound:
            b = exe._binding
            for st in b.plan.steps:
                mvm = isinstance(st, DenseStep) or (
                    isinstance(st, ConvStep) and st.groups == 1
                    and st.strategy is not None
                    and st.strategy.kind == "resident")
                if mvm and not isinstance(b.weights[st.name][2], MvmWeights):
                    out.append(st.name)
    return out


def serve_window(server, reqs, window=SERVE_WINDOW):
    """The requests submitted at once, the launch counts zeroed just before
    and read just after. Returns (answers, counts, wall seconds)."""
    import torch.profiler
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    t0 = time.perf_counter()
    # the window a profiler trace reads the device's busy share in
    with torch.profiler.record_function(window):
        futs = [server.submit(name, f) for name, f in reqs]
        outs = [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    return outs, launch_counts(), wall


def serve_path(device, progs, reqs, bound=False, devices=1):
    """``reqs`` served once by a fresh :func:`make_server`. Returns
    (answers, counts, stats, wall seconds)."""
    server, _ = make_server(device, progs, bound, devices)
    try:
        outs, counts, wall = serve_window(server, reqs)
    finally:
        server.stop()
    return outs, counts, server.stats(), wall


def by_program(reqs, outs):
    import numpy as np
    grouped = {}
    for (name, f), out in zip(reqs, outs):
        fs, os_ = grouped.setdefault(name, ([], []))
        fs.append(f)
        os_.append(np.asarray(out))
    return {name: (np.concatenate(fs), np.concatenate(os_))
            for name, (fs, os_) in grouped.items()}


def vision_requests(progs, n=VISION_REQUESTS):
    sizes = [1, 2, 3, 1, 5, 1, 2, 8]
    return [(("lenet", "vgg9")[i % 2],
             frames_for(progs[("lenet", "vgg9")[i % 2]],
                        sizes[(i // 2) % len(sizes)], 100 + i))
            for i in range(n)]


def out_shape(name, prog):
    """The answer's per-frame shape: classes, or the output image."""
    if name in ("lenet", "vgg9", "vgg16"):
        return {"lenet": (10,), "vgg9": (100,), "vgg16": (1000,)}[name]
    return prog.output_hwc


def phase_serve_vision(device, progs):
    """LeNet and VGG9-CA behind one Server on the card, eager (unbound)."""
    reqs = vision_requests(progs)
    outs, counts, stats, wall = serve_path(device, progs, reqs)
    for name, (frames, served) in by_program(reqs, outs).items():
        check_served(name, progs[name], frames, served, str(device),
                     out_shape(name, progs[name]))
    return counts, stats, wall, sum(f.shape[0] for _, f in reqs)


def imaging_requests(progs, sizes=(1, 3, 8)):
    return [(name, frames_for(progs[name], n, 200 + 10 * i + j))
            for i, n in enumerate(sizes)
            for j, name in enumerate(progs)]


def psnr_db(prog, frames, served, device):
    from repro_torch.imaging import apply_float, psnr
    ref = apply_float(prog.layers, prog.params, frames_on(frames, device))
    return float(psnr(ref, frames_on(served, device)))


def phase_serve_imaging(device, progs):
    """The eight imaging pipelines at 256x256x3 behind one Server on the
    card, eager (unbound); PSNR of the served answers against the float
    oracle."""
    reqs = imaging_requests(progs)
    outs, counts, stats, wall = serve_path(device, progs, reqs)
    quality = {}
    for name, (frames, served) in by_program(reqs, outs).items():
        prog = progs[name]
        check_served(name, prog, frames, served, str(device),
                     out_shape(name, prog))
        quality[name] = psnr_db(prog, frames, served, device)
    return counts, stats, wall, sum(f.shape[0] for _, f in reqs), quality


def chain_program(hw=IMAGING_HW):
    """The reference's acceptance chain, denoise_gauss -> edge_detect ->
    sharpen, as one program at hw x hw x 3."""
    from repro_torch import Program
    first, second, third = (Program.from_pipeline(n, hw, hw, c)
                            for n, c in CHAIN)
    return first.then(second).then(third)


def triple_in_flight(hosted):
    """Three batches of different content at bucket 4 through the hosted
    program's bound view, none waited on until all three are enqueued: the
    static output is overwritten twice and a staging slot reused before
    the first answer is read. Each must be its own batch-1 answers."""
    import numpy as np
    prog, exe = hosted.program, hosted.executable
    frames = [frames_for(prog, 4, 900 + i) for i in range(3)]
    pending = [hosted.bound[0].run_padded(f, 4) for f in frames]
    outs = [np.asarray(p) for p in pending]
    for i, (f, out) in enumerate(zip(frames, outs)):
        want = np.concatenate([exe.run_per_frame(f[j:j + 1]).cpu().numpy()
                               for j in range(len(f))])
        need(np.array_equal(out, want), f"{hosted.name}: batch {i} of three "
             f"in flight differs from its batch-1 answers")
    need(not any(np.shares_memory(a, b) for a in outs for b in outs
                 if a is not b), f"{hosted.name}: two answers share memory")
    need(not np.array_equal(outs[0], outs[1]),
         f"{hosted.name}: different frames gave one answer")


def phase_serve_bound(device, vision_progs, imaging_progs, chain, devices):
    """Every path through bound views: LeNet, VGG9-CA, the eight pipelines
    and the chain behind one Server (``devices`` workers, two batches in
    flight each), each path in its own window with the launch counts
    zeroed before and read after. Every answer is held against batch-1
    runs, the reference backend and the CPU port; each window's counts must
    equal what the replays of the captured graphs credited; three batches
    in flight on one bound view must each give their own answers."""
    progs = {**vision_progs, **imaging_progs, "chain": chain}
    windows = {"vision": vision_requests(vision_progs),
               "imaging": imaging_requests(imaging_progs),
               "chain": imaging_requests({"chain": chain})}
    t0 = time.perf_counter()
    server, hosted = make_server(device, progs, True, devices)
    bind_s = time.perf_counter() - t0
    out = {"bind_and_capture_s": bind_s, "windows": {}}
    try:
        for path, reqs in windows.items():
            before = credited(hosted)
            outs, counts, wall = serve_window(server, reqs)
            after = credited(hosted)
            need(counts == {k: after[k] - before[k] for k in KERNELS},
                 f"bound {path}: launch counts {counts} are not the "
                 f"replays' credits")
            quality = {}
            for name, (frames, served) in by_program(reqs, outs).items():
                check_served(name, progs[name], frames, served, str(device),
                             out_shape(name, progs[name]))
                if path != "vision":
                    quality[name] = psnr_db(progs[name], frames, served,
                                            device)
            out["windows"][path] = {
                "counts": counts, "wall_s": wall, "psnr_db": quality,
                "frames": sum(f.shape[0] for _, f in reqs)}
        for name in ("lenet", "edge_detect", "chain"):
            triple_in_flight(hosted[name])
        out["graphs"] = {name: {
            str(b): g.launches
            for b, g in h.bound[0]._binding.graphs.items()}
            for name, h in hosted.items()}
    finally:
        server.stop()
    out["stats"] = server.stats()
    return out


def saturate_for(server, name, pool, seconds, cap=200000):
    """``loadgen.saturate`` with single-frame requests, the count grown
    until one run lasts at least 0.8 * ``seconds`` (or reaches ``cap``);
    returns that run's report."""
    from repro_torch import serve
    n = 64
    while True:
        rep = serve.saturate(server, name, pool, n_requests=n)
        need(rep.served == n, f"{name}: saturate served {rep.served} of {n}")
        if rep.duration_s >= 0.8 * seconds or n >= cap:
            return rep
        n = min(cap, max(2 * n, int(n * seconds / rep.duration_s)))


def phase_load(device, progs, saturate_s, poisson_s):
    """Served frames/s at saturation (``loadgen.saturate``, single-frame
    requests for about ``saturate_s`` seconds) and p50/p99 under open-loop
    Poisson load at half the bound path's saturation rate (about
    ``poisson_s`` seconds), each program bound (graphs) and eager
    (unbound), bound first."""
    from repro_torch import serve
    out = {name: {} for name in progs}
    for mode in ("bound", "eager"):
        server, _ = make_server(device, progs, mode == "bound")
        try:
            for i, (name, prog) in enumerate(progs.items()):
                pool = frames_for(prog, 16, 700 + i)
                sat = saturate_for(server, name, pool, saturate_s)
                n = sat.submitted
                rate = 0.5 * out[name]["bound"]["saturate_fps"] \
                    if mode == "eager" else 0.5 * sat.achieved_fps
                m = int(min(max(rate * poisson_s, 32), 20000))
                load = serve.poisson_load(server, name, pool, rate_rps=rate,
                                          n_requests=m, seed=i)
                out[name][mode] = {
                    "saturate_fps": sat.achieved_fps,
                    "saturate_requests": n,
                    "poisson_rate_rps": rate, "poisson_requests": m,
                    "poisson_served": load.served,
                    "poisson_shed": load.shed,
                    "poisson_rejected": load.rejected,
                    "poisson_behind_schedule": load.behind_schedule,
                    "poisson_achieved_fps": load.achieved_fps,
                    "latency_ms": load.latency_ms}
        finally:
            server.stop()
    return out


def phase_busy_share(device, progs, trace_path, bound=False):
    """The imaging requests served once more under ``torch.profiler``, eager
    or through the bound views: the share of the serving window in which
    the card ran anything (the union of the kernel, copy and memset
    intervals that the window's host calls issued, over the window's
    length), with the device time summed by kind of work. None on the
    CPU."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if device.type != "cuda":
        return None
    reqs = imaging_requests(progs)
    server, _ = make_server(device, progs, bound)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            serve_window(server, reqs)
            torch.cuda.synchronize()
    finally:
        server.stop()
    return dict(busy_share(load_trace(prof, trace_path)),
                frames=sum(f.shape[0] for _, f in reqs))


def busy_share(events, window=SERVE_WINDOW):
    """The window's length, the union of the device intervals its host
    calls issued, their share of the window, and the device time by kind
    of work (copies, memsets, the port's kernels, torch ops), by port
    kernel, and of the 8 torch ops that took the most (by kernel symbol,
    with their launches)."""
    lo, hi = host_range(events, window)
    spans, by_kind, by_kernel, torch_ops = [], {}, {}, {}
    for e in device_work(events, window)[0]:
        a, b = e["ts"], e["ts"] + e["dur"]
        spans.append((a, b))
        kind = e["cat"] if e["cat"] != "kernel" else (
            "port kernels" if re.search(PORT_KERNEL, e["name"])
            else "torch ops")
        by_kind[kind] = by_kind.get(kind, 0.0) + (b - a) / 1e3
        if kind == "torch ops":
            op = torch_ops.setdefault(torch_op_name(e["name"]), [0.0, 0])
            op[0] += (b - a) / 1e3
            op[1] += 1
        if kind == "port kernels":
            name = e["name"].replace(" ", "")
            # conv_bank shares conv_strip's kernel: named by conv_strip
            k = next((k for k in KERNELS if k != "conv_bank"
                      and re.search(KERNEL_SYMBOLS[k], name)), "other")
            by_kernel[k] = by_kernel.get(k, 0.0) + (b - a) / 1e3
    busy, end = 0.0, None
    for a, b in sorted(spans):
        busy += max(0.0, b - (a if end is None else max(a, end)))
        end = b if end is None else max(end, b)
    top = sorted(torch_ops.items(), key=lambda kv: -kv[1][0])[:8]
    return {"window_ms": (hi - lo) / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / (hi - lo), "device_ms_by_kind": by_kind,
            "port_kernel_ms": by_kernel,
            "torch_ops_by_name": [{"name": n, "ms": ms, "launches": c}
                                  for n, (ms, c) in top],
            "torch_op_launches": sum(c for _, c in torch_ops.values())}


def torch_op_name(name):
    """A torch op's kernel symbol, short: the function with its template
    arguments (``vectorized_elementwise_kernel<4, CUDAFunctor_add<float>,
    ...>``), without namespaces or the argument list."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    name = re.sub(r"\b[A-Za-z_]\w*::", "", name)
    return re.sub(r"\s+", " ", name)[:200]


def check_trace_cli(path, *flags):
    """``scripts/check_trace.py`` on ``path`` in a subprocess (the script
    is stdlib only and not imported here); fails unless it exits 0."""
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "scripts", "check_trace.py"),
         path, *flags], capture_output=True, text=True, timeout=300)
    need(out.returncode == 0, f"check_trace.py {os.path.basename(path)} "
         f"{' '.join(flags)}: {(out.stderr or out.stdout).strip()}")


def http_get(url):
    """(status, body) of a GET on the admin endpoint (loopback)."""
    import urllib.request
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read()


def phase_obs_serve(device, vision_progs, imaging_progs, out_dir):
    """LeNet, VGG9-CA and edge_detect behind one bound server with a
    ``Trace`` enabled, the admin endpoint up, LeNet under a tight SLO and
    an execute hook that can fail one batch: the answers bitwise as in the
    serve phases; the five admin routes answer 200, ``/metrics`` has each
    program's ``serve_`` lines and ``/tracez`` passes ``check_trace.py
    --flight``; the SLO breach is counted, logged and dumped, an injected
    ``WorkerError`` dumps, both dumps pass ``--flight --require-trigger``;
    the exported trace passes ``check_trace.py --min-devices 1``."""
    from repro_torch import obs, serve
    progs = {**vision_progs, "edge_detect": imaging_progs["edge_detect"]}
    armed = {"edge_detect": False}

    def execute(program, index, frames, bucket, default):
        if armed.get(program):
            armed[program] = False
            raise RuntimeError("injected device fault")
        return default()

    out = {}
    breaches0 = obs.counter("slo.breach.lenet").get()
    dump_dir = os.path.join(out_dir, "flight")
    trace = obs.enable()
    try:
        server, _ = make_server(
            device, progs, True, hooks=serve.Hooks(execute=execute),
            slo={"lenet": obs.SLO(p99_ms=0.001, min_count=1)},
            admin_port=0, flight_dump_dir=dump_dir,
            flight_dump_interval_s=0.0, flight_dump_keep=16)
        try:
            ready = server.readiness()
            need(ready["ready"], f"[obs] not ready after start: {ready}")
            reqs = vision_requests(vision_progs) + imaging_requests(
                {"edge_detect": progs["edge_detect"]})
            outs, counts, wall = serve_window(server, reqs)
            for name, (frames, served) in by_program(reqs, outs).items():
                check_served(name, progs[name], frames, served, str(device),
                             out_shape(name, progs[name]))
            out["window"] = {"frames": sum(f.shape[0] for _, f in reqs),
                             "wall_s": wall, "launches": counts}

            url = server.admin.url
            sizes = {}
            for route in ("/healthz", "/readyz", "/metrics", "/statusz",
                          "/statusz?format=text"):
                code, body = http_get(url + route)
                need(code == 200, f"[obs] {route} answered {code}")
                sizes[route] = len(body)
            metrics = http_get(url + "/metrics")[1].decode()
            for name in progs:
                need(f"serve_{name}_served " in metrics,
                     f"[obs] /metrics has no serve_{name}_served line")
            tracez = os.path.join(out_dir, "obs_tracez.json")
            with open(tracez, "wb") as f:
                f.write(http_get(url + "/tracez")[1])
            check_trace_cli(tracez, "--flight")
            out["admin"] = {"url": url, "bytes": sizes}

            need(obs.counter("slo.breach.lenet").get() > breaches0,
                 "[obs] the tight SLO was not breached")
            need(any(r["event"] == "serve.slo.breach"
                     and r["program"] == "lenet"
                     for r in server.log.recent()),
                 "[obs] no structured-log line for the SLO breach")
            slo_dump = next((d for d in server.flight_dumps()
                             if d["reason"].startswith("slo:lenet:")), None)
            need(slo_dump is not None and slo_dump["path"] is not None,
                 "[obs] the SLO breach left no dump")
            check_trace_cli(slo_dump["path"], "--flight",
                            "--require-trigger")

            armed["edge_detect"] = True
            fut = server.submit("edge_detect",
                                frames_for(progs["edge_detect"], 1, 999))
            try:
                fut.result(timeout=120)
                need(False, "[obs] the injected fault did not fail a batch")
            except serve.WorkerError:
                pass
            t0 = time.perf_counter()
            while not any(d["reason"] == "worker_error:edge_detect"
                          for d in server.flight_dumps()):
                need(time.perf_counter() - t0 < 60,
                     "[obs] the WorkerError left no dump")
                time.sleep(0.01)
            err_dump = next(d for d in server.flight_dumps()
                            if d["reason"] == "worker_error:edge_detect")
            check_trace_cli(err_dump["path"], "--flight",
                            "--require-trigger")
            out["dumps"] = [{k: v for k, v in d.items() if k != "dump"}
                            for d in server.flight_dumps()]
            out["stats"] = server.stats(verbose=True)
        finally:
            server.stop()
    finally:
        obs.disable()
    path = os.path.join(out_dir, OBS_TRACE)
    trace.export(path)
    check_trace_cli(path, "--min-devices", "1")
    summary = trace.summary()
    out["trace"] = {"records": len(trace.records()),
                    "device_spans": summary.get("serve.device.execute"),
                    "request_device_spans": summary.get(
                        "serve.request.device")}
    return out


def phase_obs_busy(device, progs, trace_path):
    """The bound imaging burst once more, under ``torch.profiler`` and a
    ``Trace`` at once: the ``serve.device.execute`` spans (each ends when
    the worker's wait on the batch's answer returned) must sum to at least
    the card's busy time in the window. None on the CPU."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import obs
    if device.type != "cuda":
        return None
    reqs = imaging_requests(progs)
    server, _ = make_server(device, progs, True)
    try:
        trace = obs.enable()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                serve_window(server, reqs)
                torch.cuda.synchronize()
        finally:
            obs.disable()
    finally:
        server.stop()
    busy = busy_share(load_trace(prof, trace_path))
    spans = trace.spans("serve.device.execute")
    span_ms = sum(s["t1_ns"] - s["t0_ns"] for s in spans) / 1e6
    need(span_ms >= busy["busy_ms"],
         f"[obs] device spans sum to {span_ms:.3f} ms, less than the "
         f"{busy['busy_ms']:.3f} ms the card was busy")
    return {"device_span_ms": span_ms, "device_spans": len(spans),
            "cupti_busy_ms": busy["busy_ms"], "window_ms": busy["window_ms"]}


def run_variant(server, name, pool, n, variant, recorder):
    """One ``loadgen.saturate`` run of ``n`` single-frame requests under an
    observability variant: A no recorder, B the default recorder, C the
    recorder and a ``Trace``, D the recorder with the admin endpoint
    polled every ``ADMIN_POLL_S``. Returns (frames/s, recorder records
    per request)."""
    import threading
    from repro_torch import obs, serve
    stop, errors = threading.Event(), []

    def poll():
        while not stop.wait(ADMIN_POLL_S):
            for route in ("/metrics", "/healthz"):
                try:
                    code, _ = http_get(server.admin.url + route)
                    if code != 200:
                        errors.append(f"{route}: {code}")
                except OSError as e:
                    errors.append(f"{route}: {e}")

    if variant == "A":
        obs.uninstall()
    trace = obs.enable() if variant == "C" else None
    poller = threading.Thread(target=poll) if variant == "D" else None
    if poller is not None:
        poller.start()
    rec0 = recorder.stats()["recorded_total"]
    try:
        rep = serve.saturate(server, name, pool, n_requests=n)
    finally:
        stop.set()
        if poller is not None:
            poller.join(60)
        if trace is not None:
            obs.disable()
        obs.install(recorder)
    need(not errors, f"[obs] admin polling failed: {errors[:3]}")
    need(poller is None or not poller.is_alive(), "[obs] poller hung")
    need(rep.served == n, f"[obs] {name} {variant}: served {rep.served} of "
         f"{n}")
    per_req = (recorder.stats()["recorded_total"] - rec0) / n
    return rep.achieved_fps, per_req


def phase_obs_cost(device, progs, seconds):
    """What observability costs the bound path: for each program,
    ``loadgen.saturate`` with single-frame requests under the variants in
    the order ``OBS_VARIANTS`` (A B C D D C B A), every run the same
    request count (sized once to last about ``seconds`` with the default
    recorder); frames/s per run and each variant's mean over A's."""
    from repro_torch import obs
    recorder = obs.get_flight()
    need(recorder is not None, "[obs] no default flight recorder")
    server, _ = make_server(device, progs, True, admin_port=0)
    out = {}
    try:
        for i, (name, prog) in enumerate(progs.items()):
            pool = frames_for(prog, 16, 800 + i)
            n = saturate_for(server, name, pool, seconds).submitted
            runs = {v: [] for v in "ABCD"}
            per_req = {v: [] for v in "ABCD"}
            for v in OBS_VARIANTS:
                fps, puts = run_variant(server, name, pool, n, v, recorder)
                runs[v].append(fps)
                per_req[v].append(puts)
            mean = {v: sum(r) / len(r) for v, r in runs.items()}
            out[name] = {"requests": n, "fps": runs,
                         "records_per_request": per_req,
                         "ratio_to_A": {v: mean[v] / mean["A"]
                                        for v in "BCD"}}
    finally:
        server.stop()
        obs.install(recorder)
    return out


# ---------------------------------------------------------------------------
# the [vgg16] phase
# ---------------------------------------------------------------------------

def vgg16_program(hw=VGG16_HW):
    """VGG16 at hw x hw x 3, full channel widths, seeded numpy weights."""
    from repro_torch import Program
    from repro_torch.models.vision import vgg16_ir
    from repro_torch.weights import params_from_numpy
    layers = tuple(vgg16_ir(in_hw=hw))
    return Program(layers, params_from_numpy(numpy_params(layers, SEED + 2),
                                             "cpu"), (hw, hw, 3),
                   name="vgg16")


def plan_kernels(plan):
    """The kernels a plan's steps launch through the kernel backend."""
    from repro_torch.core.plan import CAStep, ConvStep, DenseStep
    fused = {i for s in plan.fused_segments
             for i in range(s.start, s.start + s.length)}
    out = {"conv_chain", "epilogue"} if fused else {"epilogue"}
    for i, step in enumerate(plan.steps):
        if i in fused:
            continue
        if isinstance(step, CAStep):
            out.add("ca_pool")
        elif isinstance(step, ConvStep) and step.strategy.kind == "strip":
            out.add("conv_strip_depthwise" if step.geom.depthwise
                    else "conv_strip_int"
                    if plan.strip_routes.get(step.name) == "int"
                    else "conv_strip")
        elif isinstance(step, (ConvStep, DenseStep)):
            out.add("photonic_mvm")
    return out


def vgg16_compile(prog, device, budget):
    """VGG16 compiled cold under W4A4 and MX_43 with ``verify="on"``: each
    report clean and the plan's kernels ``PATH_KERNELS["vgg16"]``; the
    ``plan.verify`` span's time, and the per-step headroom
    (``verify_plan(include_info=True)``'s LTR003 findings)."""
    from repro_torch import Options, analysis, obs
    from repro_torch.core.quant import MX_43, W4A4
    out, exes = {}, {}
    for label, scheme in (("w4a4", W4A4), ("mx43", MX_43)):
        opts = Options(scheme=scheme, device=str(device),
                       conv_vmem_budget=budget, verify="on")
        trace = obs.enable()
        try:
            t0 = time.perf_counter()
            exe = prog.compile(opts)
            compile_ms = (time.perf_counter() - t0) * 1e3
        finally:
            obs.disable()
        span = trace.summary().get("plan.verify")
        need(span is not None and span["count"] == 1,
             f"[vgg16] {label}: the cold compile ran {span} plan.verify spans")
        need(exe.report.verification == [],
             f"[vgg16] {label}: verification {exe.report.verification}")
        need(exe.plan.exact_proven, f"[vgg16] {label}: not proven exact")
        kernels = plan_kernels(exe.plan)
        need(kernels == set(PATH_KERNELS["vgg16"]),
             f"[vgg16] {label}: the plan launches {sorted(kernels)}")
        diags = analysis.verify_plan(exe.plan, budget=budget)
        need(not analysis.errors(diags), f"[vgg16] {label}: errors")
        out[label] = {
            "compile_ms": compile_ms, "verify_span_ms": span["total_ms"],
            "headroom_bits": {
                d.step: float(d.message.split("headroom ")[1].split(" ")[0])
                for d in diags if d.code == "LTR003"},
            "strategies": {n: v["kind"] for n, v in
                           exe.report.conv_strategy.items()}}
        exes[label] = (exe, opts)
    return out, exes


def vgg16_kernels(device, buckets, exe):
    """The strip and photonic_mvm kernels at every ``VGG16_SHAPES`` entry
    and bucket, raw and with the epilogue, bitwise against their plain
    versions: conv1-conv10 on the float64 strip kernel (the strips' rows)
    and on the int8 one (the conv's own rows, as the int route launches
    it); and the epilogue pair at every call of ``exe``'s (VGG16's) run at
    each bucket, both designs, both calibrations. Returns ({kernel: max
    abs err}, {kernel: comparisons})."""
    import torch
    from repro_torch.kernels.conv_bank import strip
    from repro_torch.kernels.edge_shapes import VGG16_SHAPES, vgg16_case
    from repro_torch.kernels.photonic_mvm.ops import mvm_int
    from repro_torch.kernels.photonic_mvm.ref import mvm_int_ref
    gen = torch.Generator(device=device).manual_seed(SEED + 16)
    from repro_torch.kernels.edge_shapes import epilogue_calls
    errs = {"conv_strip": [], "photonic_mvm": [], "conv_strip_int": [],
            "conv_strip_f64mma": [], "epilogue": []}

    def compare(kernel, got, want, what):
        need(got.shape == want.shape and bool(torch.isfinite(got).all()),
             f"[vgg16] {kernel} {what}: shape {tuple(got.shape)} or not "
             f"finite")
        err = float((got - want).abs().max()) if got.numel() else 0.0
        errs[kernel].append(err)
        need(torch.equal(got, want), f"[vgg16] {kernel} {what}: differs "
             f"from its plain version (max abs err {err})")

    for b in buckets:
        frames = frames_on(frames_for(exe.program, b, SEED + 18), device)
        for j, call in enumerate(epilogue_calls(exe, frames)):
            compare_epilogue(compare, call, f"[vgg16] call {j} batch {b}")

    for kernel, shapes in VGG16_SHAPES.items():
        for shape in shapes:
            for b in buckets:
                args = vgg16_case(kernel, shape, b, gen, device)
                what = f"{shape[0]} batch {b}"
                if kernel == "conv_strip":
                    xp, w, stride, sh = args
                    kw = dict(stride=stride, strip_h=sh)
                    dense = dense_kernel(xp, w, stride)
                    compare(dense, strip.conv_strip(xp, w, **kw),
                            strip.conv_strip_ref(xp, w, **kw), what)
                    co = w.shape[-1]
                    ws = torch.rand((co,), generator=gen, device=device) + .5
                    bias = torch.randn((co,), generator=gen, device=device)
                    kw.update(act_scale=0.37, act="relu", bias=bias)
                    compare(dense, strip.conv_strip(xp, w, ws, **kw),
                            strip.conv_strip_ref(xp, w, ws, **kw),
                            f"{what} with epilogue")
                    own = shape[3] + w.shape[0] - 1       # square frames
                    x8 = xp[:, :own].to(torch.uint8)
                    w8 = w.to(torch.int8)
                    compare("conv_strip_int", strip.conv_strip_int(x8, w8),
                            strip.conv_strip_int_ref(x8, w8), what)
                    kw = dict(act_scale=0.37, act="relu", bias=bias)
                    compare("conv_strip_int",
                            strip.conv_strip_int(x8, w8, ws, **kw),
                            strip.conv_strip_int_ref(x8, w8, ws, **kw),
                            f"{what} with epilogue")
                else:
                    a, wq = args
                    compare(kernel, mvm_int(a, wq), mvm_int_ref(a, wq), what)
                    ws = torch.rand((wq.shape[1],), generator=gen,
                                    device=device) + 0.5
                    compare(kernel, mvm_int(a, wq, ws, 0.37),
                            mvm_int_ref(a, wq, ws, 0.37),
                            f"{what} with epilogue")
    return ({k: max(v) for k, v in errs.items()},
            {k: len(v) for k, v in errs.items()})


def vgg16_expected(prog, frames, device, options):
    """VGG16's answers to ``frames`` by the three oracles: batch-1
    ``run_per_frame`` on the card, the reference backend on the card, and
    the port's CPU run of the first ``VGG16_CPU_FRAMES`` frames."""
    import dataclasses
    import numpy as np
    exe = prog.compile(options)
    singles = np.concatenate([exe.run_per_frame(frames[i:i + 1]).cpu()
                              .numpy() for i in range(len(frames))])
    ref = prog.compile(dataclasses.replace(options, backend="reference"))
    cpu = prog.compile(dataclasses.replace(options, device="cpu"))
    return (singles, ref.run_per_frame(frames).cpu().numpy(),
            cpu.run_per_frame(frames[:VGG16_CPU_FRAMES]).numpy())


def vgg16_check(window, frames, served, expected):
    import numpy as np
    singles, ref, cpu = expected
    need(served.shape == (frames.shape[0], 1000)
         and bool(np.isfinite(served).all()),
         f"[vgg16] {window}: answers {served.shape}, or not finite")
    need(np.array_equal(served, singles), f"[vgg16] {window}: answers "
         f"differ from batch-1 run_per_frame")
    need(np.array_equal(served, ref), f"[vgg16] {window}: answers differ "
         f"from the reference backend")
    need(np.array_equal(served[:VGG16_CPU_FRAMES], cpu), f"[vgg16] "
         f"{window}: answers differ from the port's CPU run")


def vgg16_timing(device, exe, trace_path, ptxas=None):
    """Each conv and dense step of VGG16 at bucket 8 on random codes and
    its own levels: the kernel, its route through dispatch (the plan's:
    pads, casts and slicing included), its plain version and its library
    call, timed by CUDA events over ``VGG16_ITERS`` calls (``<name>_ms``);
    the kernel, its route, the library call, the forced-resident route
    and, for a strip step, the float64 strip kernel (its CUDA-core form,
    forced) also by their device
    time in one profiler session (``<name>_device_ms``: every kernel the
    call launched, the kernel's own symbol alone for ``kernel`` and
    ``float_kernel``); and the bound (the conv's own output, not the strip
    padding's surplus rows; bytes over 3.35 TB/s or operations over the
    int8 peak; an int8 strip row's from the kernel's own operands, u8
    codes, s8 levels and f32 output, its f32 carriers' in
    ``carrier_bound_ms``).
    Each strip step is also forced resident (im2col + photonic_mvm: the
    route, and the GEMM alone), and each resident conv forced onto the
    int8 strip route (``strip_int``). ``ptxas``: the build's report, whose
    line for each int8 instantiation is attached to its rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.plan import ConvStep, DenseStep
    from repro_torch.core.quant import quantize_weight
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.conv_bank import strip
    from repro_torch.kernels.conv_bank.ref import float32_convs
    from repro_torch.kernels.photonic_mvm.ops import (mvm_config,
                                                      mvm_int_laid,
                                                      mvm_weights)
    from repro_torch.kernels.photonic_mvm.ref import mvm_int_ref
    cuda = device.type == "cuda"
    time_ms = timer(device)
    iters = VGG16_ITERS if cuda else 1
    by_function = int8_ptxas(ptxas)
    mvm_functions = {f["function"]: f for f in (ptxas or {}).get(
        "photonic_mvm", [])}
    gen = torch.Generator(device=device).manual_seed(SEED + 17)
    plan, params = exe.plan, exe.params()
    b, rows = BUCKET, []
    resident = dispatch.ConvStrategy("resident")
    for step in plan.steps:
        if not isinstance(step, (ConvStep, DenseStep)):
            continue
        wq, ws_q = quantize_weight(params[step.name]["w"], step.wa)
        if isinstance(step, DenseStep):
            a = torch.randint(0, 16, (b, wq.shape[0]), generator=gen,
                              device=device, dtype=torch.int8)
            w2 = wq.to(torch.int8)
            m, k, n = a.shape[0], wq.shape[0], wq.shape[1]
            lib_fn, lib_name = mvm_library(a, w2)
            # the path's form: the levels laid out once, as at bind
            kernel = lambda a=a, mw=mvm_weights(w2): mvm_int_laid(a, mw)
            row = dict(layer=step.name, kernel="photonic_mvm",
                       library=lib_name, fns=dict(
                           kernel=kernel, route=kernel, library=lib_fn,
                           plain=lambda a=a, w2=w2: mvm_int_ref(a, w2)))
            nbytes, macs = m * k + k * n + 4 * m * n, m * n * k
        else:
            g = step.geom
            codes = torch.randint(0, 16, (b, g.h_in, g.w_in, g.c_in),
                                  generator=gen, device=device).float()
            hc, wc = g.conv_hw()
            macs = b * hc * wc * g.c_out * g.kernel * g.kernel * g.c_in
            nbytes = (codes.numel() + wq.numel() + b * hc * wc * g.c_out) * 4
            (plo, phi), (qlo, qhi) = g.pads
            xp_real = F.pad(codes, (0, 0, qlo, qhi, plo, phi))
            wf = wq.float()
            a = dispatch._im2col(codes, g.kernel, g.stride, g.pads)[0] \
                .to(torch.int8)
            w2 = wq.reshape(-1, g.c_out).to(torch.int8)
            mw = mvm_weights(w2)
            m, k, n = a.shape[0], a.shape[1], g.c_out
            route = plan.strip_routes.get(step.name)
            # a resident conv's route on its levels laid out once, as at
            # bind (a strip conv's lays its own out per call)
            laid = mw if step.strategy.kind == "resident" and \
                g.groups == 1 else None
            fns = dict(
                route=lambda codes=codes, wq=wq, g=g, st=step.strategy,
                route=route, laid=laid: dispatch.conv_int(
                    codes, wq, g.stride, g.pads, strategy=st, route=route,
                    levels=laid),
                library=strip_library(xp_real, wf, g.stride, False),
                resident=lambda codes=codes, wq=wq, g=g: dispatch.conv_int(
                    codes, wq, g.stride, g.pads, strategy=resident),
                resident_gemm=lambda a=a, mw=mw: mvm_int_laid(a, mw))
            row = dict(layer=step.name, strategy=step.strategy.kind,
                       x=[b, g.h_in, g.w_in, g.c_in], c_out=g.c_out,
                       library="F.conv2d (TF32 off)", fns=fns)
            if step.strategy.kind == "strip":
                st = step.strategy
                xp = strip.pad_rows_for_strips(xp_real, g.kernel, g.stride,
                                               st.strip_rows, st.n_strips)
                kw = dict(stride=g.stride, strip_h=st.strip_rows)
                launch_rows = (xp.shape[1] - g.kernel) // g.stride + 1
                cfg = strip.strip_config(b, launch_rows, wc, g.c_in, g.c_out,
                                         g.kernel, g.stride)
                # the CUDA-core form forced, as every run before the
                # tensor-core one timed it (the rule gives conv2-conv10
                # that form on the float route)
                float_kernel = lambda xp=xp, wf=wf, kw=kw: strip.conv_strip(
                    xp, wf, form="fma", **kw)
                fns.update(
                    kernel=float_kernel,
                    plain=lambda xp=xp, wf=wf, kw=kw: strip.conv_strip_ref(
                        xp, wf, **kw))
                row.update(kernel="conv_strip", launch_rows=launch_rows,
                           ctas=cfg.ctas, tile=[cfg.tx, cfg.tyt * cfg.run],
                           co_b=cfg.co_b, cc=cfg.cc)
                if route == "int":
                    x8, w8 = strip.int_operands(codes, wq, g.pads)
                    icfg = strip.igemm_config(b, hc, wc, g.c_in, g.c_out,
                                              g.kernel, g.stride)
                    fns.update(
                        kernel=lambda x8=x8, w8=w8, s=g.stride:
                        strip.conv_strip_int(x8, w8, stride=s),
                        plain=lambda x8=x8, w8=w8, s=g.stride:
                        strip.conv_strip_int_ref(x8, w8, stride=s),
                        float_kernel=float_kernel)
                    if step.name in plan.folded_epilogues:
                        # the same conv with its requant's first pass in
                        # its store (the path's form), on laid-out levels
                        fold = strip.Fold(
                            torch.rand((b, 1, 1, 1), generator=gen,
                                       device=device) * 0.01 + 1e-3,
                            ws_q, params[step.name].get("b"), step.act)
                        lv = strip.int_weights(w8, stride=g.stride)
                        fns["fold_kernel"] = (
                            lambda x8=x8, lv=lv, s=g.stride, f=fold:
                            strip.conv_strip_int_laid(x8, lv, s, fold=f))
                        row["fold_ptxas"] = igemm_ptxas(by_function, icfg,
                                                        True)
                    row.update(
                        kernel="conv_strip_int", launch_rows=hc,
                        float_launch_rows=launch_rows, ctas=icfg.ctas,
                        tile=[icfg.tw, icfg.th], bn=icfg.bn,
                        stages=icfg.stages, smem=icfg.smem,
                        float_ctas=cfg.ctas,
                        ptxas=igemm_ptxas(by_function, icfg),
                        carrier_bound_ms=bound_ms(nbytes, 2 * macs,
                                                  "int8")[0])
                    nbytes = x8.numel() + w8.numel() + \
                        b * hc * wc * g.c_out * 4
            else:
                fns.update(kernel=fns["resident_gemm"],
                           plain=lambda a=a, w2=w2: mvm_int_ref(a, w2))
                row.update(kernel="photonic_mvm")
                if g.groups == 1:
                    # the same conv forced onto the int8 strip kernel
                    fns["strip_int"] = lambda codes=codes, wq=wq, g=g, \
                        st=dispatch.ConvStrategy("strip", hc, 1): \
                        dispatch.conv_int(codes, wq, g.stride, g.pads,
                                          strategy=st, route="int")
            with float32_convs():
                row["library_exact"] = torch.equal(
                    fns["library"]().permute(0, 2, 3, 1), fns["route"]())
        if row["kernel"] == "photonic_mvm":
            cfg = mvm_config(m, k, n)
            row.update(route=cfg.route, tile=[cfg.bm, cfg.bn],
                       ctas=cfg.ctas, smem=cfg.smem,
                       ptxas=mvm_ptxas(mvm_functions, cfg))
        row.update(M=m, K=k, N=n, macs=macs)
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 2 * macs, "int8")
        with float32_convs():
            for name, fn in row["fns"].items():
                row[f"{name}_ms"] = time_ms(fn, iters)
        rows.append(row)
    rows += vgg16_epilogue_rows(device, exe, time_ms, iters)
    for row in rows:
        row["ms"] = row.pop("kernel_ms")
    if cuda:
        from torch.profiler import ProfilerActivity, profile, record_function
        timed = ("kernel", "route", "float_kernel", "library", "resident",
                 "strip_int", "torch_ops", "fold_kernel", "pair_store",
                 "pass2_per_tensor")
        with float32_convs(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # a range nobody reads first: on the card this session lost
            # the kernel records of its first ~10 launches (conv1's range
            # had none with one warm launch before it)
            with record_function(f"{DEVICE_RANGE}vgg16.warm"):
                for _ in range(VGG16_WARM_LAUNCHES):
                    torch.zeros(1, device=device)
                rows[0]["fns"]["kernel"]()
                torch.cuda.synchronize()
            for row in rows:
                for name in timed:
                    if name in row["fns"]:
                        with record_function(
                                f"{DEVICE_RANGE}vgg16.{row['layer']}.{name}"):
                            for _ in range(VGG16_DEVICE_ITERS):
                                row["fns"][name]()
                            torch.cuda.synchronize()
        events = load_trace(prof, trace_path)
        for row in rows:
            for name in timed:
                if name not in row["fns"]:
                    continue
                kernels, launches = device_work(
                    events, f"{DEVICE_RANGE}vgg16.{row['layer']}.{name}",
                    ("kernel",))
                measured = kernels and len(kernels) >= launches
                if not measured:
                    log(f"[vgg16] {row['layer']} {name}: {len(kernels)} "
                        f"kernel records for {launches} launches; not "
                        f"measured")
                symbol = {"kernel": KERNEL_SYMBOLS[row["kernel"]],
                          "float_kernel": KERNEL_SYMBOLS["conv_strip"],
                          "fold_kernel": KERNEL_SYMBOLS["conv_strip_int"],
                          "pair_store": KERNEL_SYMBOLS["epilogue"],
                          "pass2_per_tensor": KERNEL_SYMBOLS["epilogue"]}.get(
                              name, ".*")
                row[f"{name}_device_ms"] = (
                    sum(e["dur"] for e in kernels
                        if re.search(symbol, e["name"].replace(" ", "")))
                    / VGG16_DEVICE_ITERS / 1e3 if measured else None)
    for row in rows:
        del row["fns"]
    return rows


def vgg16_int_forms(device, trace_path, ptxas=None, rehearse=False):
    """The int8 strip conv's two forms at ``edge_shapes.INT_FORM_SHAPES``:
    VGG16's conv2-conv10 (as the int route launches them), conv11-13
    (which the plan runs as im2col GEMMs) forced onto the int8 kernel and
    the conv_bank op's own calls, at buckets 1 and 8 on W4A4's codes and
    levels: the wgmma form and the mma.sync form, each forced on the
    levels laid out for it, and ``F.conv2d`` on the same codes (TF32 off),
    by device time (CUPTI, ``VGG16_DEVICE_ITERS`` calls a range); the
    rule's form; the bound (u8 codes, s8 levels, f32 output once; or the
    int8 operations). The two forms are held bitwise to each other, off
    VGG16's strip convs to the plain version too. Returns one row a shape
    and bucket (``served``: one of VGG16's strip convs). A CPU rehearsal
    runs the plain version at 8x8 frames of at most 64 channels, batch
    1."""
    import torch
    from repro_torch.kernels.conv_bank import strip
    from repro_torch.kernels.conv_bank.ref import float32_convs
    from repro_torch.kernels.edge_shapes import INT_FORM_SHAPES, VGG16_SHAPES
    cuda = device.type == "cuda"
    served = {name for name, *_ in VGG16_SHAPES["conv_strip"]}
    shapes = INT_FORM_SHAPES
    buckets = VGG16_SHAPE_BUCKETS
    if rehearse:
        shapes = [(n, 8, min(ci, 64), min(co, 64), k)
                  for n, _, ci, co, k in shapes]
        buckets = (1,)
    by_function = int8_ptxas(ptxas)
    gen = torch.Generator().manual_seed(SEED + 23)
    rows = []
    for name, h, ci, co, k in shapes:
        for b in buckets:
            x8 = torch.randint(0, 16, (b, h + k - 1, h + k - 1, ci),
                               generator=gen).to(torch.uint8).to(device)
            w8 = torch.randint(-7, 8, (k, k, ci, co), generator=gen).to(
                torch.int8).to(device)
            cfgs = {form: strip.igemm_config(b, h, h, ci, co, k, 1,
                                             form=form)
                    for form in ("wgmma", "mma")}
            fns = {form: lambda c=c, x8=x8, iw=strip.int_weights(
                w8, form=form): strip.conv_strip_int_laid(x8, iw, cfg=c)
                for form, c in cfgs.items()}
            fns["library"] = strip_library(x8.float(), w8.float(), 1, False)
            got = fns["wgmma"]()
            need(torch.equal(got, fns["mma"]()), f"[vgg16] int8 forms "
                 f"{name} batch {b}: the wgmma form differs from the "
                 f"mma.sync form")
            if name not in served:
                need(torch.equal(got, strip.conv_strip_int_ref(x8, w8)),
                     f"[vgg16] int8 forms {name} batch {b}: the wgmma "
                     f"form differs from the plain version")
            macs = b * h * h * co * k * k * ci
            bound, by = bound_ms(x8.numel() + w8.numel() + b * h * h * co * 4,
                                 2 * macs, "int8")
            rule = strip.igemm_config(b, h, h, ci, co, k, 1)
            rows.append(dict(
                layer=name, batch=b, layers=name.count("+") + 1,
                served=name in served, rule=rule.form, bound_ms=bound,
                bound_by=by, macs=macs, fns=fns,
                **{f"{form}_cfg": dataclasses.asdict(c)
                   for form, c in cfgs.items()},
                **{f"{form}_ptxas": igemm_ptxas(by_function, c)
                   for form, c in cfgs.items()}))
    if cuda:
        from torch.profiler import ProfilerActivity, profile, record_function
        with float32_convs(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(f"{DEVICE_RANGE}int_forms.warm"):
                for _ in range(VGG16_WARM_LAUNCHES):
                    torch.zeros(1, device=device)
                for fn in rows[0]["fns"].values():
                    fn()
                torch.cuda.synchronize()
            for r in rows:
                for fn_name, fn in r["fns"].items():
                    fn()
                    torch.cuda.synchronize()
                    with record_function(f"{DEVICE_RANGE}int_forms."
                                         f"{r['layer']}.b{r['batch']}."
                                         f"{fn_name}"):
                        for _ in range(VGG16_DEVICE_ITERS):
                            fn()
                        torch.cuda.synchronize()
        events = load_trace(prof, trace_path)
    for r in rows:
        for fn_name in r.pop("fns"):
            r[f"{fn_name}_device_ms"] = None
            if not cuda:
                continue
            kernels, launches = device_work(
                events, f"{DEVICE_RANGE}int_forms.{r['layer']}.b"
                f"{r['batch']}.{fn_name}", ("kernel",))
            if not kernels or len(kernels) < launches:
                log(f"[vgg16] int8 forms {r['layer']} b{r['batch']} "
                    f"{fn_name}: {len(kernels)} kernel records for "
                    f"{launches} launches; not measured")
                continue
            symbol = (".*" if fn_name == "library"
                      else KERNEL_SYMBOLS["conv_strip_int"])
            r[f"{fn_name}_device_ms"] = sum(
                e["dur"] for e in kernels
                if re.search(symbol, e["name"].replace(" ", ""))) \
                / VGG16_DEVICE_ITERS / 1e3
    return rows


def int_forms_line(r):
    """One ``[vgg16] int8 forms`` line of a ``vgg16_int_forms`` row."""
    def form(f):
        c, px = r[f"{f}_cfg"], r[f"{f}_ptxas"] or {}
        return (f"{c['th']}x{c['tw']} x {c['bn']} ch, {c['ch']}-channel "
                f"chunks, {c['stages']} stages, {c['ctas']} CTAs, "
                f"{c['smem']} B smem, ptxas {px.get('registers')} regs, "
                f"spills {px.get('spill_stores')}/{px.get('spill_loads')} "
                f"B: device {r[f'{f}_device_ms']} ms")
    w, m = r["wgmma_device_ms"], r["mma_device_ms"]
    ratio = f"{w / m:.3f}" if w and m else None
    return (f"[vgg16] int8 forms {r['layer']} b{r['batch']}: wgmma "
            f"{form('wgmma')}; mma.sync {form('mma')}; F.conv2d device "
            f"{r['library_device_ms']} ms; bound {r['bound_ms']:.6f} by "
            f"{r['bound_by']}; the rule takes {r['rule']}; wgmma / mma "
            f"{ratio}")


def epilogue_labels(plan):
    """Each epilogue call of a plan's run in order, named by the step whose
    output it requantizes ("frames" first); a fused segment's steps make
    none, a no-act dense head none."""
    from repro_torch.core.plan import (CAStep, ConvStep, DenseStep,
                                       FlattenStep, UpsampleStep)
    fused = {i for s in plan.fused_segments
             for i in range(s.start, s.start + s.length)}
    out = ["frames"]
    for i, st in enumerate(plan.steps):
        if i in fused or (isinstance(st, DenseStep) and st.act == "none"):
            continue
        out.append(st.name if isinstance(st, (ConvStep, DenseStep)) else
                   {CAStep: "ca", UpsampleStep: "upsample",
                    FlattenStep: "flatten"}[type(st)])
    return out


def vgg16_epilogue_rows(device, exe, time_ms, iters):
    """The epilogue at each of VGG16's requants at bucket 8 (its calls on
    a per-frame run of ``frames_for``'s frames), as ``vgg16_timing`` rows:
    the kernel -- for a conv whose requant folds into its store, pass 2
    alone on that store's y and maxima (the store's cost is the conv
    row's ``fold_kernel`` against its ``kernel``) --, the plain version
    -- the torch-op sequence the epilogue replaces, on the conv's
    accumulate, also profiled as ``torch_ops`` --, the bound
    (``epilogue_work``), and for every other call the pair under
    per-tensor calibration (``pair_store``)."""
    from repro_torch.kernels.conv_bank import strip
    from repro_torch.kernels.edge_shapes import epilogue_calls, epilogue_fns
    from repro_torch.kernels.epilogue import ops
    from repro_torch.kernels.epilogue.ref import epilogue_ref
    frames = frames_on(frames_for(exe.program, BUCKET, SEED + 19), device)
    calls = epilogue_calls(exe, frames)
    labels = epilogue_labels(exe.plan)
    need(len(labels) == len(calls), f"[vgg16] {len(calls)} epilogue calls "
         f"for the plan's {len(labels)} requants")
    rows = []
    for label, call in zip(labels, calls):
        nbytes, work, launch = epilogue_work(call)
        bound, by = bound_ms(nbytes, work, "fp32")
        if call.folded:
            c = call
            y, partials = strip.conv_strip_int_laid(
                c.x, c.levels, c.stride,
                fold=strip.Fold(c.act_scale, c.ws, c.bias, c.act))
            acc = strip.conv_strip_int_laid(c.x, c.levels, c.stride)
            fns = dict(kernel=lambda y=y, pt=partials, c=c:
                       ops.quant_folded(y, pt, c.pool, c.a_qmax,
                                        c.per_frame, None, c.operand),
                       plain=lambda acc=acc, kw=c.requant():
                       epilogue_ref(acc, **kw),
                       # per tensor: each block reduces the batch's maxima
                       pass2_per_tensor=lambda y=y, pt=partials, c=c:
                       ops.quant_folded(y, pt, c.pool, c.a_qmax, False,
                                        None, c.operand))
        else:
            fns = dict(zip(("kernel", "plain"), epilogue_fns(call)))
            pt = per_tensor(call)
            fns["pair_store"] = lambda a=pt, c=epilogue_forms(pt)["pair"]: \
                epilogue_launch(a, c)
        fns["torch_ops"] = fns["plain"]
        # a range of its own: "conv1.epilogue", not the conv's "conv1"
        row = dict(layer=f"{label}.epilogue", after=label,
                   kernel="epilogue", library=None,
                   x=list(epilogue_accumulate(call).shape), act=call.act,
                   epi_pool=call.pool, operand=call.operand is not None,
                   bytes=nbytes, bound_ms=bound, bound_by=by, fns=fns,
                   **launch)
        for name, fn in fns.items():
            row[f"{name}_ms"] = time_ms(fn, iters)
        rows.append(row)
    return rows


def vgg16_epilogue_forms(plan):
    """The epilogue launches of one per-frame run of ``plan`` by form:
    each folded conv's, and the form ``epilogue_config`` gives every other
    requant (the verifier's walk of the plan's requant shapes)."""
    from repro_torch.analysis.verifier import _epilogue_requants
    from repro_torch.kernels.epilogue.ops import epilogue_config
    out = {"pair": 0, "cluster": 0, "fold": len(plan.folded_epilogues)}
    for _, n, c, p, words in _epilogue_requants(plan):
        cfg = epilogue_config(BUCKET, n, c, True, words, p, True)
        out["cluster" if cfg.cluster else "pair"] += 1
    return out


def phase_vgg16(device, rehearse, out_dir, ptxas=None):
    """VGG16 end to end (the module docstring's phase 9). Returns its
    detail, the launch counts of its eager and bound windows, and its
    kernels' max abs errors and comparison counts."""
    import numpy as np
    from repro_torch.kernels.epilogue import ops as epi_ops
    hw = REHEARSAL_VGG16_HW if rehearse else VGG16_HW
    budget = REHEARSAL_VGG16_BUDGET if rehearse else None
    prog = vgg16_program(hw)
    out = {"hw": hw}
    out["compile"], exes = vgg16_compile(prog, device, budget)
    for label, c in out["compile"].items():
        log(f"[vgg16] {label} at {hw}x{hw}x3: verify=on clean, compile "
            f"{c['compile_ms']:.2f} ms of which plan.verify "
            f"{c['verify_span_ms']:.3f} ms; strategies {c['strategies']}")
    log(f"[vgg16] accumulator headroom, bits (w4a4): "
        f"{out['compile']['w4a4']['headroom_bits']}")
    exe, opts = exes["w4a4"]
    # MX_43 on two frames; W4A4 is served below
    mx_exe, mx_opts = exes["mx43"]
    f2 = frames_for(prog, 2, 1600)
    vgg16_check("mx43 run_per_frame", f2,
                mx_exe.run_per_frame(f2).cpu().numpy(),
                vgg16_expected(prog, f2, device, mx_opts))

    t0 = time.perf_counter()
    err, n_cmp = vgg16_kernels(device, (1,) if rehearse
                               else VGG16_SHAPE_BUCKETS, exe)
    log(f"[vgg16] kernels at VGG16_SHAPES, buckets "
        f"{(1,) if rehearse else VGG16_SHAPE_BUCKETS}: bitwise equal to "
        f"their plain versions ({n_cmp} comparisons, max abs err {err}) in "
        f"{time.perf_counter() - t0:.1f}s")

    reqs = imaging_requests({"vgg16": prog}, VGG16_REQUESTS)
    frames = np.concatenate([f for _, f in reqs])
    expected = vgg16_expected(prog, frames, device, opts)
    counts = {}
    for window, bound in (("vgg16", False), ("bound vgg16", True)):
        t0 = time.perf_counter()
        server, hosted = make_server(device, {"vgg16": prog}, bound,
                                     options=opts)
        start_s = time.perf_counter() - t0
        try:
            if bound:
                missing = mvm_levels_not_laid(hosted)
                need(not missing, f"[vgg16] bound: the photonic_mvm "
                     f"levels of {missing} are not laid out at bind")
            before = credited(hosted)
            forms0 = {f: n.value for f, n in epi_ops.FORMS.items()}
            outs, c, wall = serve_window(server, reqs)
            forms = {f: n.value - forms0[f]
                     for f, n in epi_ops.FORMS.items()}
            after = credited(hosted)
        finally:
            server.stop()
        if bound:
            need(c == {k: after[k] - before[k] for k in KERNELS},
                 f"[vgg16] bound: launch counts {c} are not the replays' "
                 f"credits")
        elif device.type == "cuda":
            # a batch: the frames, 13 convs, the flatten, fc1, fc2; conv1-10
            # folded into their stores (no epi_reduce_kernel for them), the
            # other 7 in the form epilogue_config gives them per frame
            want = vgg16_epilogue_forms(exe.plan)
            batches = c["epilogue"] // sum(want.values())
            need(len(exe.plan.folded_epilogues) == 10 and want["fold"] == 10
                 and forms == {f: n * batches for f, n in want.items()},
                 f"[vgg16] {window}: epilogue launches by form {forms} "
                 f"for {c['epilogue']} calls; a batch takes {want}")
            log(f"[vgg16] {window}: epilogue launches by form {forms} "
                f"({batches} batches of {want}; folded: "
                f"{', '.join(exe.plan.folded_epilogues)})")
        vgg16_check(window, frames, np.concatenate(
            [np.asarray(o) for o in outs]), expected)
        counts[window] = c
        out[window] = {"start_s": start_s, "wall_s": wall, "counts": c,
                       "frames": len(frames)}
        log(f"[vgg16] served {window}: {len(frames)} frames in {wall:.3f}s "
            f"wall (start {start_s:.2f}s), bitwise equal to batch-1 "
            f"run_per_frame, the reference backend and the CPU port "
            f"({VGG16_CPU_FRAMES} frames); launches {c}")

    out["layers"] = vgg16_timing(device, exe, os.path.join(
        out_dir, VGG16_DEVICE_TRACE), ptxas)
    for r in out["layers"]:
        if r["kernel"] == "epilogue":
            pair = (f"; per tensor, pass 2 device "
                    f"{r.get('pass2_per_tensor_device_ms')}"
                    if r["form"] == "fold" else
                    f"; per tensor, the pair device "
                    f"{r.get('pair_store_device_ms')}")
            log(f"[vgg16] epilogue after {r['after']} {r['x']} act "
                f"{r['act']} pool {r['epi_pool']} -> "
                f"{'int8 operand' if r['operand'] else 'float codes'}, "
                f"{'pass 2 after the folded store' if r['form'] == 'fold' else r['form']}: "
                f"{r['ms']:.4f} ms (device {r.get('kernel_device_ms')}; "
                f"the torch ops it replaces "
                f"{r['plain_ms']:.4f} ms, device "
                f"{r.get('torch_ops_device_ms')}; bound "
                f"{r['bound_ms']:.6f} by {r['bound_by']}; launch "
                f"{launch_label(r)}){pair}")
            continue
        extra = (f"; forced resident: route {r['resident_ms']:.4f} "
                 f"(device {r.get('resident_device_ms')}) gemm "
                 f"{r['resident_gemm_ms']:.4f}; library exact "
                 f"{r['library_exact']}" if "strategy" in r else "")
        if "strip_int_ms" in r:
            extra += (f"; forced onto the int8 strip route "
                      f"{r['strip_int_ms']:.4f} (device "
                      f"{r.get('strip_int_device_ms')})")
        if r["kernel"] == "conv_strip_int":
            px, fpx = r["ptxas"] or {}, r.get("fold_ptxas") or {}
            if "fold_kernel_ms" in r:
                extra += (f"; with the epilogue folded into its store "
                          f"{r['fold_kernel_ms']:.4f} ms (device "
                          f"{r.get('fold_kernel_device_ms')}; ptxas "
                          f"{fpx.get('registers')} regs, spills "
                          f"{fpx.get('spill_stores')}/"
                          f"{fpx.get('spill_loads')} B)")
            extra += (f"; route device {r.get('route_device_ms')}, float64 "
                      f"kernel {r['float_kernel_ms']:.4f} (device "
                      f"{r.get('float_kernel_device_ms')}, "
                      f"{r['float_ctas']} CTAs over "
                      f"{r['float_launch_rows']} rows); int8 tile "
                      f"{r['tile']} x {r['bn']} channels, {r['stages']} "
                      f"stages, {r['smem']} B smem, {r['ctas']} CTAs, ptxas "
                      f"{px.get('registers')} regs, spills "
                      f"{px.get('spill_stores')}/{px.get('spill_loads')} B; "
                      f"f32 carriers' bound {r['carrier_bound_ms']:.6f}")
        if r["kernel"] == "photonic_mvm":
            px = r["ptxas"] or {}
            extra += (f"; {r['route']} route, tile {r['tile'][0]}x"
                      f"{r['tile'][1]}, {r['ctas']} "
                      f"CTAs, {r['smem']} B smem, ptxas "
                      f"{px.get('registers')} regs, spills "
                      f"{px.get('spill_stores')}/{px.get('spill_loads')} B")
        log(f"[vgg16] {r['layer']} {r['kernel']}: {r['ms']:.4f} ms "
            f"(device {r.get('kernel_device_ms')}; route "
            f"{r['route_ms']:.4f}, plain {r['plain_ms']:.4f}, library "
            f"{r['library']} {r['library_ms']:.4f} device "
            f"{r.get('library_device_ms')}, bound {r['bound_ms']:.6f} by "
            f"{r['bound_by']}){extra}")

    out["int_forms"] = vgg16_int_forms(device, os.path.join(
        out_dir, VGG16_FORMS_TRACE), ptxas, rehearse)
    for r in out["int_forms"]:
        log(int_forms_line(r))
    for b in sorted({r["batch"] for r in out["int_forms"]}):
        rows = [r for r in out["int_forms"] if r["batch"] == b]
        for group, what in (("", "conv2-conv10"),
                            ("bank", "the conv_bank op's calls")):
            convs = [r for r in rows if r["served"] == (group == "") and
                     r["layer"].startswith("conv_bank") == bool(group)]
            sums = {key: None if any(r[key] is None for r in convs) else
                    sum(r[key] * r["layers"] for r in convs)
                    for key in ("wgmma_device_ms", "mma_device_ms",
                                "library_device_ms", "bound_ms")}
            out[f"int_forms{'_' + group if group else ''}_b{b}"] = sums
            log(f"[vgg16] int8 forms, {what} at bucket {b}: {sums}")
        slower = [r["layer"] for r in rows if r["rule"] == "wgmma" and
                  None not in (r["wgmma_device_ms"], r["mma_device_ms"])
                  and r["wgmma_device_ms"] > r["mma_device_ms"]]
        out[f"int_forms_b{b}"]["slower_on_the_rule"] = slower
        log(f"[vgg16] int8 forms at bucket {b}: shapes the rule gives the "
            f"wgmma form where it is slower than the mma.sync form: "
            f"{slower}")

    def total(rows, key):
        vals = [r.get(key) for r in rows]
        return None if None in vals else sum(vals)

    out["by_kernel"] = {}
    for k in PATH_KERNELS["vgg16"]:
        rows = [r for r in out["layers"] if r["kernel"] == k]
        out["by_kernel"][k] = {
            key: total(rows, key)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        out["by_kernel"][k].update(
            calls=len(rows), device_ms=total(rows, "kernel_device_ms"),
            library_device_ms=total(rows, "library_device_ms"),
            route_device_ms=total(rows, "route_device_ms"),
            library_exact=all(r.get("library_exact", True) for r in rows),
            bound_by=("bytes" if sum(r["bound_ms"] for r in rows
                                     if r["bound_by"] == "bytes") * 2 >
                      sum(r["bound_ms"] for r in rows) else "operations"))
    epi = [r for r in out["layers"] if r["kernel"] == "epilogue"]
    out["epilogue"] = {key: total(epi, key) for key in (
        "ms", "plain_ms", "bound_ms", "kernel_device_ms",
        "torch_ops_device_ms")}
    convs = [r for r in out["layers"] if "fold_kernel_ms" in r]
    delta = [None if None in (r.get("fold_kernel_device_ms"),
                              r.get("kernel_device_ms"))
             else r["fold_kernel_device_ms"] - r["kernel_device_ms"]
             for r in convs]
    out["epilogue"].update(
        pass2_device_ms=total([r for r in epi if r["form"] == "fold"],
                              "kernel_device_ms"),
        other_device_ms=total([r for r in epi if r["form"] != "fold"],
                              "kernel_device_ms"),
        fold_store_delta_device_ms=None if None in delta else sum(delta),
        int8_strip_device_ms=total(convs, "kernel_device_ms"),
        int8_strip_fold_device_ms=total(convs, "fold_kernel_device_ms"),
        forms={f: sum(r["form"] == f for r in epi)
               for f in ("fold", "cluster", "pair")})
    e = out["epilogue"]
    e["device_ms_with_store_delta"] = None if None in (
        e["kernel_device_ms"], e["fold_store_delta_device_ms"]) else \
        e["kernel_device_ms"] + e["fold_store_delta_device_ms"]
    log(f"[vgg16] epilogue per bucket-8 batch ({len(epi)} calls, forms "
        f"{e['forms']}): device {e['kernel_device_ms']} ms (pass 2 after "
        f"the {len(convs)} folded stores {e['pass2_device_ms']}, the other "
        f"calls {e['other_device_ms']}) + the int8 strip kernels' increase "
        f"with the folded store {e['fold_store_delta_device_ms']} (raw "
        f"{e['int8_strip_device_ms']}, folded "
        f"{e['int8_strip_fold_device_ms']}) = "
        f"{e['device_ms_with_store_delta']}; bound {e['bound_ms']:.6f}; "
        f"{out['epilogue']}")
    strips = [r for r in out["layers"] if r.get("strategy") == "strip"]
    log(f"[vgg16] per bucket-8 batch: {out['by_kernel']}; strip layers "
        f"on their route {total(strips, 'route_ms'):.4f} ms (device "
        f"{total(strips, 'route_device_ms')}; kernels "
        f"{total(strips, 'ms'):.4f}, device "
        f"{total(strips, 'kernel_device_ms')}), the float64 strip kernel "
        f"{total(strips, 'float_kernel_ms')} ms (device "
        f"{total(strips, 'float_kernel_device_ms')}), F.conv2d device "
        f"{total(strips, 'library_device_ms')}, forced resident "
        f"{total(strips, 'resident_ms'):.4f} ms (device "
        f"{total(strips, 'resident_device_ms')}; gemm "
        f"{total(strips, 'resident_gemm_ms'):.4f}), bound "
        f"{total(strips, 'bound_ms'):.6f} (f32 carriers "
        f"{total(strips, 'carrier_bound_ms')})")

    progs = {"vgg16": prog}
    out["busy"] = None
    if device.type == "cuda":
        server, _ = make_server(device, progs, True, options=opts)
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                serve_window(server, reqs)
                torch.cuda.synchronize()
        finally:
            server.stop()
        out["busy"] = busy_share(load_trace(
            prof, os.path.join(out_dir, VGG16_TRACE)))
    log(f"[vgg16] bound window, profiled: {out['busy']}")

    server, _ = make_server(device, progs, True, options=opts)
    try:
        rep = saturate_for(server, "vgg16", frames_for(prog, 16, 1700),
                           REHEARSAL_VGG16_SATURATE_S if rehearse
                           else VGG16_SATURATE_S)
    finally:
        server.stop()
    out["saturate"] = {"fps": rep.achieved_fps, "requests": rep.submitted,
                       "seconds": rep.duration_s}
    log(f"[vgg16] bound saturate: {rep.achieved_fps:.2f} frames/s "
        f"({rep.submitted} single-frame requests in {rep.duration_s:.2f}s)")
    return out, counts, err, n_cmp


# ---------------------------------------------------------------------------
# the [eager] phase
# ---------------------------------------------------------------------------

def per_call_ms(device, fn, iters):
    """Each of ``iters`` calls of ``fn`` in ms (CUDA events on the card,
    the host clock on the CPU), after one warm-up call."""
    import torch
    fn()
    out = []
    for _ in range(iters):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_eager(device, rehearse, vision_progs, smi):
    """LightatorDevice on the card (the module docstring's phase 16).
    Returns its detail and the launch counts of its ``run`` windows."""
    import dataclasses
    import statistics
    import warnings
    import torch
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.accelerator import LightatorDevice
    from repro_torch.core.quant import MX_43, W3A4, W4A4
    from repro_torch.examples import serve_quantized_lm, train_lenet_qat
    from repro_torch.kernels import launch_counts, reset_launch_counts
    t_phase = time.perf_counter()
    schemes = {"w4a4": W4A4, "w3a4": W3A4, "mx43": MX_43}
    hw = REHEARSAL_VGG16_HW if rehearse else VGG16_HW
    progs = {**vision_progs, "vgg16": vgg16_program(hw)}
    iters = REHEARSAL_EAGER_ITERS if rehearse else EAGER_ITERS
    out, counts = {"runs": {}}, {}
    for name, key in EAGER_RUNS:
        prog, scheme = progs[name], schemes[key]
        label = f"{name} {key}"
        budget = REHEARSAL_VGG16_BUDGET if rehearse and name == "vgg16" \
            else None
        dev = LightatorDevice(device=str(device), conv_vmem_budget=budget)
        f = frames_for(prog, BUCKET, 1800)
        params = dev._params(prog.params)
        frames = dev._tensor(f)
        reset_launch_counts()
        eager, erep = dev.run_eager(prog.layers, params, frames, scheme)
        if device.type == "cuda":
            torch.cuda.synchronize()
        eager_counts = launch_counts()
        need(sum(eager_counts.values()) == 0, f"[eager] {label}: run_eager "
             f"launched port kernels {eager_counts}")
        reset_launch_counts()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            got, rep = dev.run(prog.layers, params, frames, scheme)
        if device.type == "cuda":
            torch.cuda.synchronize()
        run_counts = launch_counts()
        plan = dev.compile(prog.layers, frames.shape, scheme)
        reset_launch_counts()
        plan_mod._execute(plan, params, frames)
        if device.type == "cuda":
            torch.cuda.synchronize()
        need(run_counts == launch_counts(), f"[eager] {label}: run launched "
             f"{run_counts}, _execute {launch_counts()}")
        # per-tensor calibration at batch 8: no fused chain runs
        want = plan_kernels(plan) - {"conv_chain"}
        need(rehearse or all(run_counts[k] > 0 for k in want),
             f"[eager] {label}: run "
             f"launched {run_counts}; its plan's kernels are {sorted(want)}")
        counts[f"eager {label}"] = run_counts
        need(tuple(got.shape) == (BUCKET, plan.out_features)
             and bool(torch.isfinite(got).all()),
             f"[eager] {label}: logits {tuple(got.shape)} or not finite")
        need(torch.equal(eager, got), f"[eager] {label}: run_eager differs "
             f"from run in {int((eager != got).sum())} logits")
        need(dataclasses.asdict(erep) == dataclasses.asdict(rep),
             f"[eager] {label}: the reports differ")
        t0 = time.perf_counter()
        cpu_dev = LightatorDevice(device="cpu", conv_vmem_budget=budget)
        cpu, cpu_rep = cpu_dev.run_eager(prog.layers, prog.params, f, scheme)
        cpu_s = time.perf_counter() - t0
        need(torch.equal(eager.cpu(), cpu) and torch.equal(got.cpu(), cpu),
             f"[eager] {label}: the card's logits differ from the CPU "
             f"port's run_eager in {int((eager.cpu() != cpu).sum())}")
        need(dataclasses.asdict(cpu_rep) == dataclasses.asdict(rep),
             f"[eager] {label}: the CPU's report differs")
        eager_ms = per_call_ms(device, lambda: dev.run_eager(
            prog.layers, params, frames, scheme), iters)
        run_ms = per_call_ms(device, lambda: dev.run(
            prog.layers, params, frames, scheme), iters)
        r = {"eager_ms": statistics.median(eager_ms),
             "run_ms": statistics.median(run_ms), "eager_runs_ms": eager_ms,
             "run_runs_ms": run_ms, "launches": run_counts,
             "cpu_eager_s": cpu_s, "frame_hwc": list(prog.input_hwc),
             "strategies": sorted({v["kind"] for v in
                                   rep.conv_strategy.values()})}
        out["runs"][label] = r
        log(f"[eager] {label} at {'x'.join(map(str, prog.input_hwc))}, "
            f"batch {BUCKET}: run_eager bitwise run and the CPU port's "
            f"run_eager (CPU {cpu_s:.2f}s), reports equal; eager "
            f"{r['eager_ms']:.3f} ms, compiled {r['run_ms']:.3f} ms a batch "
            f"(median of {iters}, {smi}); run launched "
            f"{ {k: v for k, v in run_counts.items() if v} }")

    t0 = time.perf_counter()
    rows = train_lenet_qat.main(["--steps", str(EAGER_QAT_STEPS),
                                 "--device", str(device)])
    for row in rows:
        need(all(math.isfinite(x) for x in row["losses"]),
             f"[eager] train_lenet_qat {row['scheme']}: a loss is not finite")
        if "logits" in row:
            need(bool(torch.isfinite(row["logits"]).all()),
                 f"[eager] train_lenet_qat {row['scheme']}: logits")
    out["train_lenet_qat"] = {
        "seconds": time.perf_counter() - t0,
        "rows": [{k: row[k] for k in ("scheme", "acc")} | (
            {"device_acc": row["device_acc"],
             "avg_power_w": row["report"].avg_power_w,
             "kfps_per_w": row["report"].kfps_per_w} if "report" in row
            else {}) for row in rows]}
    log(f"[eager] train_lenet_qat --steps {EAGER_QAT_STEPS}: "
        f"{out['train_lenet_qat']['seconds']:.1f}s")
    t0 = time.perf_counter()
    toks = serve_quantized_lm.main(["--gen", str(EAGER_LM_GEN), "--device",
                                    str(device)])
    for quant, t in toks.items():
        need(tuple(t.shape) == (4, serve_quantized_lm.PROMPT_LEN
                                + EAGER_LM_GEN),
             f"[eager] serve_quantized_lm {quant}: tokens {tuple(t.shape)}")
    out["serve_quantized_lm_s"] = time.perf_counter() - t0
    log(f"[eager] serve_quantized_lm --gen {EAGER_LM_GEN}: "
        f"{out['serve_quantized_lm_s']:.1f}s")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[eager] phase {out['phase_s']:.1f}s")
    return out, counts


# ---------------------------------------------------------------------------
# the [train] phase
# ---------------------------------------------------------------------------

def train_signed_mvm(device):
    """photonic_mvm's float API on signed CRC codes at every
    ``SIGNED_MVM_SHAPES`` entry (every route), W4A4
    and W2A4, against ``photonic_mvm_ref`` on the same tensors. Returns
    (max abs err, comparisons)."""
    import torch
    from repro_torch.core.quant import W2A4, W4A4
    from repro_torch.kernels.edge_shapes import SIGNED_MVM_SHAPES
    from repro_torch.kernels.photonic_mvm.ops import mvm_config, photonic_mvm
    from repro_torch.kernels.photonic_mvm.ref import (photonic_mvm_ref,
                                                      signed_codes)
    err, n_cmp = 0.0, 0
    for m, k, n, route in SIGNED_MVM_SHAPES:
        cfg = mvm_config(m, k, n)
        need(cfg.route == route,
             f"[train] mvm_config{(m, k, n)} is {cfg}")
        g = torch.Generator().manual_seed(m * 5 + k + n)
        x = (torch.randn((m, k), generator=g) * 0.6).to(device)
        w = torch.randn((k, n), generator=g).to(device)
        codes = signed_codes(x, W4A4, 1.0 / 15.0)
        need(int(codes.min()) < 0 < int(codes.max()) or m * k < 30,
             f"[train] {(m, k, n)}: codes not signed")
        for spec in (W4A4, W2A4):
            got, want = photonic_mvm(x, w, spec), photonic_mvm_ref(x, w, spec)
            need(got.shape == want.shape and torch.equal(got, want),
                 f"[train] photonic_mvm float API {(m, k, n)} {spec.name} "
                 f"differs from photonic_mvm_ref")
            err = max(err, float((got - want).abs().max()))
            n_cmp += 1
    return err, n_cmp


def train_summary(run, acc):
    """One training run's numbers: losses, step times, accuracy."""
    import numpy as np
    ms = np.asarray(run.step_ms)
    return {"losses": run.losses, "loss_first": run.losses[0],
            "loss_last": run.losses[-1], "step_ms": run.step_ms,
            "step_ms_first": float(ms[0]),
            "step_ms_median": float(np.median(ms[1:] if len(ms) > 1 else ms)),
            "clock": run.clock, "acc": acc}


def train_checked(tv, model, key, steps, batch, device):
    """``train_vision.train`` once; fatal unless every loss is finite and
    the last is below the first."""
    run = tv.train(model, tv.SCHEMES[key], steps, batch, seed=SEED,
                   device=device)
    need(all(math.isfinite(v) for v in run.losses),
         f"[train] {model} {key}: a loss is not finite: {run.losses}")
    need(run.losses[-1] < run.losses[0], f"[train] {model} {key}: the loss "
         f"did not fall ({run.losses[0]:.4f} -> {run.losses[-1]:.4f})")
    return run


def kernel_head(run, frames):
    """The kernel-mode evaluation of a trained run: its QAT forward up to
    the first dense layer, then each dense layer through
    ``nn.layers.dense(mode="kernel")`` (photonic_mvm's float API: signed
    CRC codes of the layer's real activations). Returns the logits and,
    per dense layer, (name, input, spec, output)."""
    import torch
    from repro_torch.core.accelerator import ConvSpec, DenseSpec
    from repro_torch.core.quant import resolve_layer_specs
    from repro_torch.models.vision import apply_vision
    from repro_torch.nn import layers as L
    compute = [l for l in run.layers if isinstance(l, (ConvSpec, DenseSpec))]
    specs = dict(zip((l.name for l in compute),
                     resolve_layer_specs(len(compute), run.scheme)))
    first = next(i for i, l in enumerate(run.layers)
                 if isinstance(l, DenseSpec))
    dev = run.params[compute[0].name]["w"].device
    with torch.no_grad():
        h = apply_vision(run.params, run.layers[:first],
                         torch.as_tensor(frames).to(dev, torch.float32),
                         run.scheme)
        cases = []
        for layer in run.layers[first:]:
            y = L.dense(run.params[layer.name], h, quant=specs[layer.name],
                        mode="kernel")
            cases.append((layer.name, h, specs[layer.name], y))
            h = torch.relu(y) if layer.act == "relu" else y
    return h, cases


def check_kernel_head(model, run, cases):
    """Each kernel-mode dense output bitwise equal to ``photonic_mvm_ref``
    (plus the bias) on the same input. Returns (max abs err, cases)."""
    import torch
    from repro_torch.kernels.photonic_mvm.ref import photonic_mvm_ref
    err = 0.0
    for name, x, spec, got in cases:
        p = run.params[name]
        want = photonic_mvm_ref(x, p["w"], spec, 1.0 / 15.0) + p["b"]
        need(got.shape == want.shape and torch.equal(got, want),
             f"[train] {model} {name}: dense(mode='kernel') on "
             f"{tuple(x.shape)} differs from photonic_mvm_ref")
        err = max(err, float((got - want).abs().max()))
    return err, len(cases)


def train_float_api_timing(device, runs, heads):
    """The float API at the kernel-mode evaluation's dense layers, on their
    recorded inputs (M = the held-out frames): its time beside its plain
    version, a float32 matmul of the same operands (the library yardstick:
    not the same function) and the bound (f32 x and w read, f32 out
    written; 2MKN int8 ops)."""
    from repro_torch.kernels.photonic_mvm.ops import photonic_mvm
    from repro_torch.kernels.photonic_mvm.ref import photonic_mvm_ref
    time_ms = timer(device)
    rows = []
    for model, run in runs.items():
        for name, x, spec, _ in heads[model]:
            w = run.params[name]["w"]
            (m, k), n = x.shape, w.shape[1]
            nbytes, ops = 4 * (m * k + k * n + m * n), 2 * m * k * n
            bound, by = bound_ms(nbytes, ops, "int8")
            rows.append({
                "model": model, "layer": name, "shape": (m, k, n),
                "ms": time_ms(lambda: photonic_mvm(x, w, spec), TRAIN_ITERS),
                "plain_ms": time_ms(lambda: photonic_mvm_ref(x, w, spec),
                                    TRAIN_ITERS),
                "library_ms": time_ms(lambda: x @ w, TRAIN_ITERS),
                "bound_ms": bound, "bound_by": by})
    return rows


def train_profile(tv, run, batch, device, path):
    """``TRAIN_PROFILE_STEPS`` more QAT steps of a trained run under the
    profiler (one warm-up step first): the window's device busy share,
    device ms by kind, and the kernels that took the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.optim.adamw import adamw_init
    xs, ys = tv.dataset(run.model, batch, seed=11)
    xb, yb = torch.from_numpy(xs).to(device), \
        torch.from_numpy(ys).long().to(device)
    params, opt = run.params, adamw_init(run.params, tv.OPT)
    params, opt, _ = tv.qat_step(params, opt, run.layers, run.scheme, xb, yb)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(TRAIN_WINDOW):
            for _ in range(TRAIN_PROFILE_STEPS):
                params, opt, _ = tv.qat_step(params, opt, run.layers,
                                             run.scheme, xb, yb)
        torch.cuda.synchronize()
    events = load_trace(prof, path)
    out = busy_share(events, TRAIN_WINDOW)
    by_name = {}
    for e in device_work(events, TRAIN_WINDOW)[0]:
        if e["cat"] == "kernel":
            name = e["name"][:60]
            by_name[name] = by_name.get(name, 0.0) + e["dur"] / 1e3
    out["launches_per_step"] = sum(
        1 for e in device_work(events, TRAIN_WINDOW)[0]
        if e["cat"] == "kernel") / TRAIN_PROFILE_STEPS
    out["top_kernels_ms"] = dict(sorted(by_name.items(),
                                        key=lambda kv: -kv[1])[:6])
    return out


def phase_train(device, rehearse, out_dir):
    """QAT on the card, then the trained weights served (the module
    docstring's phase 10). Returns its detail, the launch counts of its
    two main-path windows, and photonic_mvm's max abs error and
    comparisons on signed codes."""
    import numpy as np
    import torch
    from repro_torch import Program
    from repro_torch.imaging import (PIPELINES, apply_float, fit_recon_head,
                                     gray_target, psnr)
    from repro_torch.data.synthetic import synthetic_textures
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train_vision as tv
    plan = REHEARSAL_TRAIN_RUNS if rehearse else TRAIN_RUNS
    n_test = REHEARSAL_TRAIN_TEST_FRAMES if rehearse else TRAIN_TEST_FRAMES
    out = {"runs": {}}
    err, n_cmp = train_signed_mvm(device)
    log(f"[train] photonic_mvm float API, signed codes: bitwise equal to "
        f"photonic_mvm_ref at {n_cmp} shape x scheme cases (every route, "
        f"split-K on and off), max abs err {err}")

    tests = {m: tv.dataset(m, n_test, seed=9) for m in plan}
    runs = {}
    for model, keys in (("lenet", TRAIN_SCHEMES), ("vgg9", ("w4a4",))):
        steps, batch = plan[model]
        for key in keys:
            t0 = time.perf_counter()
            run = train_checked(tv, model, key, steps, batch, device)
            wall = time.perf_counter() - t0
            r = train_summary(run, tv.evaluate(run, *tests[model]))
            r["wall_s"] = wall
            out["runs"][f"{model} {key}"] = r
            if key == "w4a4":
                runs[model] = run
            log(f"[train] {model} {tv.SCHEME_LABELS[key]}: {steps} steps at "
                f"batch {batch}, loss {r['loss_first']:.4f} -> "
                f"{r['loss_last']:.4f}; step ms ({run.clock}) first "
                f"{r['step_ms_first']:.3f} median {r['step_ms_median']:.3f}; "
                f"QAT-forward accuracy {r['acc']:.3f} on {n_test} held-out "
                f"frames; {wall:.2f}s wall")

    out["profile"] = {}
    if device.type == "cuda":
        for model, run in runs.items():
            p = train_profile(tv, run, plan[model][1], device, os.path.join(
                out_dir, TRAIN_TRACE.format(model)))
            out["profile"][model] = p
            log(f"[train] {model} W4A4, {TRAIN_PROFILE_STEPS} steps "
                f"profiled: window {p['window_ms']:.3f} ms, device busy "
                f"{p['busy_ms']:.3f} ms ({p['busy_share']:.1%}), "
                f"{p['launches_per_step']:.0f} kernels a step; by kind "
                f"{p['device_ms_by_kind']}; top kernels "
                f"{p['top_kernels_ms']}")

    # the main path: the trained W4A4 weights through the kernels, eagerly
    # (kernel-mode evaluation, run_per_frame) and then served bound
    reset_launch_counts()
    deployed, heads = {}, {}
    for model, run in runs.items():
        frames, y = tests[model]
        logits, heads[model] = kernel_head(run, frames)
        deployed[model] = {"kernel_acc": float(np.mean(
            logits.argmax(-1).cpu().numpy() == y))}
        deployed[model].update(tv.deploy(run, frames, y))
    counts = {"train": launch_counts()}
    for model, run in runs.items():
        e, n = check_kernel_head(model, run, heads[model])
        err, n_cmp = max(err, e), n_cmp + n
    log(f"[train] kernel-mode evaluation: every dense layer's float-API "
        f"output bitwise equal to photonic_mvm_ref on its real inputs "
        f"({sum(len(h) for h in heads.values())} layers, M = {n_test})")
    progs = {m: Program.from_model(m, params=run.params)
             for m, run in runs.items()}
    reqs, labels = [], {}
    for model in progs:
        frames, y = tests[model]
        at = 0
        for size in TRAIN_REQUESTS:
            reqs.append((model, frames[at:at + size]))
            at += size
        labels[model] = y[:at]
    server, hosted = make_server(device, progs, True)
    try:
        before = credited(hosted)
        outs, c, wall = serve_window(server, reqs)
        after = credited(hosted)
    finally:
        server.stop()
    if device.type == "cuda":
        need(c == {k: after[k] - before[k] for k in KERNELS},
             f"[train] bound: launch counts {c} are not the replays' credits")
    counts["bound train"] = c
    for model, (frames, served) in by_program(reqs, outs).items():
        check_served(model, progs[model], frames, served, str(device),
                     out_shape(model, progs[model]))
        d = deployed[model]
        d["served_acc"] = float(np.mean(served.argmax(-1) == labels[model]))
        d["served_frames"] = len(frames)
        log(f"[train] {model} W4A4 deployed: QAT forward "
            f"{out['runs'][model + ' w4a4']['acc']:.3f}, dense layers on "
            f"photonic_mvm {d['kernel_acc']:.3f}, run_per_frame "
            f"{d['acc']:.3f} on {n_test} frames; served bound "
            f"{d['served_acc']:.3f} on {len(frames)} frames, bitwise equal to "
            f"batch-1 run_per_frame, the reference backend and the CPU port; "
            f"power model {d['avg_power_w']:.3f} W, "
            f"{d['kfps_per_w']:.1f} kFPS/W")
    out["deployed"] = deployed
    out["counts"] = counts
    log(f"[train] launches: eager (kernel-mode evaluation + run_per_frame) "
        f"{counts['train']}; bound serve window {wall:.3f}s "
        f"{counts['bound train']}")

    out["float_api"] = train_float_api_timing(device, runs, heads)
    for r in out["float_api"]:
        log(f"[train] float API {r['model']} {r['layer']} {r['shape']}: "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, f32 matmul "
            f"{r['library_ms']:.4f}, bound {r['bound_ms']:.6f} by "
            f"{r['bound_by']})")

    frames, _ = synthetic_textures(RECON_FRAMES, seed=3, hw=RECON_HW)
    layers, params = PIPELINES["compress_recon_deconv"].build(
        RECON_HW, RECON_HW, 3)
    x = torch.from_numpy(frames).to(device)
    target = gray_target(x)
    t0 = time.perf_counter()
    fitted = fit_recon_head(layers, params, x, steps=RECON_STEPS)
    fit_s = time.perf_counter() - t0
    before = float(psnr(target, apply_float(layers, params, x), 1.0))
    after = float(psnr(target, apply_float(layers, fitted, x), 1.0))
    need(math.isfinite(after) and after > before,
         f"[train] fit_recon_head did not raise the PSNR: {before} -> {after}")
    out["recon"] = {"psnr_before_db": before, "psnr_after_db": after,
                    "fit_s": fit_s}
    log(f"[train] fit_recon_head at {RECON_HW}x{RECON_HW}x3 "
        f"({RECON_FRAMES} frames, {RECON_STEPS} SGD steps on "
        f"{device.type}): PSNR "
        f"{before:.3f} -> {after:.3f} dB in {fit_s:.2f}s wall")
    return out, counts, err, n_cmp


# ---------------------------------------------------------------------------
# the [lm] phase
# ---------------------------------------------------------------------------

def lm_decode(lm, params, cfg, prompt, steps, cache_dtype=None, forced=None):
    """The greedy loop of ``lm.greedy_generate`` (decode_step, then the
    argmax) with each step timed: CUDA events on the card, the host clock
    on the CPU. ``forced`` [B, T0+steps] feeds its tokens instead of the
    argmax (teacher forcing). Returns (tokens [B, T0+steps] int32, logits
    [B, T0+steps, V] float32 of every step, step ms)."""
    import torch
    device = prompt.device
    b, t0 = prompt.shape
    kw = {} if cache_dtype is None else {"dtype": cache_dtype}
    cache = lm.init_cache(cfg, b, t0 + steps + 1, device=device, **kw)
    toks, outs, marks = prompt.to(torch.int32), [], []
    logits = None
    for i in range(t0 + steps):
        if i >= t0:
            nxt = (forced[:, i:i + 1] if forced is not None else
                   torch.argmax(logits, -1)[:, None].to(torch.int32))
            toks = torch.cat([toks, nxt], 1)
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logits, cache = lm.decode_step(params, cache, toks[:, i:i + 1],
                                           cfg)
            end.record()
            marks.append((start, end))
        else:
            t = time.perf_counter()
            logits, cache = lm.decode_step(params, cache, toks[:, i:i + 1],
                                           cfg)
            marks.append((t, time.perf_counter()))
        outs.append(logits.float())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        ms = [a.elapsed_time(z) for a, z in marks]
    else:
        ms = [(z - a) * 1e3 for a, z in marks]
    return toks, torch.stack(outs, 1), ms


def lm_profile(lm, params, cfg, prompt, path):
    """``LM_PROFILE_STEPS`` greedy decode steps (after one warm step on the
    prompt's first token) under the profiler: the window (until the card
    is done) and its device busy share, kernels a step, the kernels that
    took the most device time. The trace is read and deleted (tens of
    MB)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    cache = lm.init_cache(cfg, prompt.shape[0], LM_PROFILE_STEPS + 2,
                          device=prompt.device)
    logits, cache = lm.decode_step(params, cache, prompt[:, :1], cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the window ends when the card has finished the steps, so that a
        # step the card bounds (the MoE's) counts whole in its length
        with record_function(LM_WINDOW):
            for _ in range(LM_PROFILE_STEPS):
                tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
                logits, cache = lm.decode_step(params, cache, tok, cfg)
            torch.cuda.synchronize()
    events = load_trace(prof, path)
    os.remove(path)
    out = busy_share(events, LM_WINDOW)
    kernels = [e for e in device_work(events, LM_WINDOW)[0]
               if e["cat"] == "kernel"]
    out["kernels_per_step"] = len(kernels) / LM_PROFILE_STEPS
    by_name = {}
    for e in kernels:
        name = e["name"][:60]
        by_name[name] = by_name.get(name, 0.0) + e["dur"] / 1e3
    out["top_kernels_ms"] = dict(sorted(by_name.items(),
                                        key=lambda kv: -kv[1])[:5])
    return out


class ActTape:
    """The W4A4 fake-quant's activations of one run, taped, to replay in
    another. ``record()`` keeps, call by call, what
    ``nn.layers._signed_fake_act`` gives (the signed CRC level) and x /
    step before rounding, clipped to the codes' range. ``replay()`` makes
    a later run take the taped levels in place of its own, call by call,
    and measures its own against the tape: ``flipped`` of ``codes``
    differ, and ``gap`` is the largest |x / step - taped x / step| over
    every activation, in code steps. A code can differ only where the two
    runs' x / step straddle a rounding point, so every flip lies within
    ``gap`` of a tie. ``per_step`` replays a prefill's [B, T, ...] tape
    one position per round of calls, as ``decode_step`` meets the same
    call sites once per token."""

    def __init__(self):
        self.tape, self.flipped, self.codes, self.gap = [], 0, 0, 0.0

    @contextlib.contextmanager
    def _patch(self, wrap):
        from repro_torch.nn import layers
        orig = layers._signed_fake_act
        layers._signed_fake_act = wrap(orig)
        try:
            yield self
        finally:
            layers._signed_fake_act = orig

    @staticmethod
    def _scaled(x, scale, a_bits):
        qmax = float((1 << a_bits) - 1)
        return (x.float() / scale).clamp(-qmax, qmax)

    def record(self):
        def wrap(orig):
            def taped(x, scale, a_bits):
                out = orig(x, scale, a_bits)
                self.tape.append((out, self._scaled(x, scale, a_bits)))
                return out
            return taped
        return self._patch(wrap)

    def replay(self, per_step=False):
        import torch
        calls = [0]
        flipped, gap = [], []

        def wrap(orig):
            def replayed(x, scale, a_bits):
                out = orig(x, scale, a_bits)
                t, j = divmod(calls[0], len(self.tape)) if per_step else \
                    (None, calls[0])
                calls[0] += 1
                ref, ref_xs = (a.to(out.device) if t is None else
                               a[:, t:t + 1].to(out.device)
                               for a in self.tape[j])
                need(ref.shape == out.shape, f"the activation tape is out "
                     f"of step: call {calls[0] - 1} has {tuple(out.shape)}, "
                     f"the tape {tuple(ref.shape)}")
                flipped.append((out != ref).sum())
                gap.append((self._scaled(x, scale, a_bits) - ref_xs).abs()
                           .max())
                self.codes += out.numel()
                return ref
            return replayed

        @contextlib.contextmanager
        def replaying():
            self.flipped, self.codes, self.gap = 0, 0, 0.0
            with self._patch(wrap):
                yield self
            want = len(self.tape) * (self.tape[0][0].shape[1]
                                     if per_step and self.tape else 1)
            need(calls[0] == want, f"the run made {calls[0]} fake-quant "
                 f"calls where the tape has {want}")
            if flipped:
                self.flipped = int(torch.stack(flipped).sum())
                self.gap = float(torch.stack(gap).max())
        return replaying()


def lm_allclose_ratio(got, want, tol):
    """max |got - want| / (tol + tol |want|): at most 1 where
    ``torch.allclose(got, want, rtol=tol, atol=tol)`` holds."""
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


def lm_prefill_check(lm, params, cfg, prompt, label, hold=True):
    """lm_forward's logits over the prompt against the stepped decode_step
    logits, held (with ``hold``) to the reference test's rtol = atol =
    ``LM_PREFILL_TOL``. Under the W4A4 fake-quant the prompt's decode
    steps replay the prefill's activation codes (``ActTape``), and the
    codes they would have taken themselves are counted: the gap of its
    own codes (unforced) is printed, the replayed one held, and every
    activation's x / step must agree with the prefill's within the
    ``LM_TIE`` of the dtype, so that each flipped code is a rounding tie
    between the two paths' sums. Returns the detail."""
    import torch
    tape = ActTape()
    with tape.record():
        prefill = lm.lm_forward(params, {"tokens": prompt}, cfg)[0].float()
    _, own, _ = lm_decode(lm, params, cfg, prompt, 0, cfg.torch_dtype)
    out = {"max_abs": float((own - prefill).abs().max()),
           "ratio": lm_allclose_ratio(own, prefill, LM_PREFILL_TOL),
           "held": hold}
    held = own
    if tape.tape:
        with tape.replay(per_step=True):
            _, held, _ = lm_decode(lm, params, cfg, prompt, 0,
                                   cfg.torch_dtype)
        out.update(replayed_max_abs=float((held - prefill).abs().max()),
                   replayed_ratio=lm_allclose_ratio(held, prefill,
                                                    LM_PREFILL_TOL),
                   flipped=tape.flipped, codes=tape.codes,
                   gap_steps=tape.gap)
        if hold:
            need(tape.gap <= LM_TIE[cfg.dtype], f"{label}: a decode "
                 f"activation lies {tape.gap:.3g} code steps from the "
                 f"prefill's (bound {LM_TIE[cfg.dtype]} in {cfg.dtype})")
    if hold:
        need(bool(torch.allclose(held, prefill, rtol=LM_PREFILL_TOL,
                                 atol=LM_PREFILL_TOL)),
             f"{label}: lm_forward's logits over the prompt and the stepped "
             f"decode_step's differ beyond rtol=atol={LM_PREFILL_TOL} in "
             f"{cfg.dtype} ({out})")
    return out


def lm_mode(lm, params, cfg, mode, prompt, device, out_dir):
    """One config under one mode on the main path: greedy_generate and the
    timed greedy loop (identical tokens, every logit finite), prefill
    against decode in the config's dtype and on a float32 copy of the
    weights, and on the card the profiled window and the peak memory."""
    import torch
    from repro_torch.core.quant import W4A4
    from repro_torch.nn.module import cast_tree
    if mode == "w4a4":
        cfg = dataclasses.replace(cfg, quant_scheme="w4a4")
    elif mode == "storage":
        params = lm.quantize_lm_params(params, cfg, W4A4)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = lm.greedy_generate(params, cfg, prompt, LM_GEN)
    if cuda:
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    toks, logits, ms = lm_decode(lm, params, cfg, prompt, LM_GEN)
    label = f"[lm] {cfg.name} {mode}"
    need(torch.equal(first, toks), f"{label}: the tokens differ between "
         f"runs")
    need(bool(torch.isfinite(logits).all()), f"{label}: a logit is not "
         f"finite")
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    # the config's own dtype, with its cache dtype, then a float32 copy of
    # the same weights with float32 caches. In bf16 the two paths' GEMMs
    # (other shapes) round apart by bf16 ulps, which 22 and 48 layers carry
    # past the reference test's bound (its 2-layer setting): the gap is
    # printed, as the reference's own gap is that size
    # (tests/test_torch_lm_generate.py); under W4A4 the replayed one is held
    bf16 = cfg.dtype == "bfloat16"
    prefill = {cfg.dtype: lm_prefill_check(
        lm, params, cfg, prompt, f"{label} {cfg.dtype}",
        hold=not bf16 or mode == "w4a4")}
    f32 = dataclasses.replace(cfg, dtype="float32")
    p32 = cast_tree(params, torch.float32)
    prefill["float32"] = lm_prefill_check(lm, p32, f32, prompt,
                                          f"{label} float32")
    del p32
    gen_ms = sorted(ms[LM_PROMPT:])
    med = gen_ms[len(gen_ms) // 2]
    out = {"ms_per_step_median": med, "ms_first_generated": ms[LM_PROMPT],
           "ms_prefill_steps": ms[:LM_PROMPT],
           "tokens_per_s": LM_BATCH * 1e3 / med,
           "first_call_s": first_s, "prefill_vs_decode": prefill,
           "tokens": first[0, LM_PROMPT:].tolist()}
    if cuda:
        out["peak_memory_gb"] = peak
        out.update(lm_profile(lm, params, cfg, prompt,
                              os.path.join(out_dir, LM_TRACE)))
    return out


@contextlib.contextmanager
def moe_routes():
    """Records the expert indices of every MoE routing made in the block
    (``nn.moe._route``), as CPU tensors in call order."""
    from repro_torch.nn import moe
    route, seen = moe._route, []

    def recorded(logits, k):
        probs, top_w, top_i = route(logits, k)
        seen.append(top_i.cpu())
        return probs, top_w, top_i

    moe._route = recorded
    try:
        yield seen
    finally:
        moe._route = route


def lm_card_vs_cpu(lm, cfg, device, seed, batch=LM_BATCH,
                   prompt_len=LM_PROMPT, gen=LM_GEN, made_on="cpu",
                   storage=False):
    """Weights made once (on ``made_on``; under ``storage`` then put in
    ``quantize_lm_params`` W4A4 storage there), carried through numpy
    (``lm_params_to_numpy`` / ``lm_params_from_numpy``) to the devices
    that lack them; float32, TF32 off, float32 caches. The forward's
    logits (encoders: the only check), then a greedy run on the CPU, the
    card teacher-forced along the CPU's tokens (every step's logits within
    ``LM_CARD_CPU_TOL`` of the largest), and the card's own greedy tokens
    equal to the CPU's up to the first step whose top-2 margin on the CPU
    is within that. Under the W4A4 fake-quant the card replays the CPU's
    activation codes (``ActTape``) in the forward and the teacher-forced
    run, where every activation's x / step must agree with the CPU's
    within ``LM_TIE["float32"]``; the codes that differ are counted, and
    the forward's error with the card's own codes is printed. For the MoE
    family the expert indices of every routing of the forward and the
    teacher-forced run must be equal, and the forward's dropped
    fractions."""
    import numpy as np
    import torch
    from repro_torch.core.quant import W4A4
    from repro_torch.data.synthetic import modality_batch
    from repro_torch.kernels.conv_bank.ref import float32_convs
    from repro_torch.weights import lm_params_from_numpy, lm_params_to_numpy
    cpu = torch.device("cpu")
    made = torch.device(made_on)
    params = lm.init_lm(torch.Generator(device=made).manual_seed(seed), cfg,
                        device=made)
    if storage:
        params = lm.quantize_lm_params(params, cfg, W4A4)
    tree = lm_params_to_numpy(params)
    on = {made: params}
    del params
    for d in (cpu, device):
        if d not in on:
            on[d] = lm_params_from_numpy(tree, d, cfg)
    del tree
    mode = "storage" if storage else cfg.quant_scheme
    label = f"[lm] card vs CPU {cfg.name} {mode} ({cfg.n_layers} layers)"
    out = {}
    fwd_tape, dec_tape = ActTape(), ActTape()
    moe = cfg.family == "moe"

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def held_tape(tape, what):
        if not tape.tape:
            return
        out[what] = {"flipped": tape.flipped, "codes": tape.codes,
                     "gap_steps": tape.gap}
        need(tape.gap <= LM_TIE["float32"], f"{label}: a {what} activation "
             f"on the card lies {tape.gap:.3g} code steps from the CPU's "
             f"(bound {LM_TIE['float32']})")

    def same_routes(cpu_routes, card_routes, what):
        need(len(card_routes) == len(cpu_routes) > 0, f"{label}: {what} "
             f"routed {len(card_routes)} times on the card, "
             f"{len(cpu_routes)} on the CPU")
        need(all(torch.equal(a, b) for a, b in zip(card_routes, cpu_routes)),
             f"{label}: the {what}'s expert indices differ between the card "
             f"and the CPU")
        out[f"{what}_routings_equal"] = len(cpu_routes)

    with float32_convs():
        arrays = modality_batch(cfg, batch, prompt_len if cfg.frontend !=
                                "vision" else cfg.n_patches + prompt_len,
                                seed=seed)
        inputs = {d: {k: torch.from_numpy(v).to(d) for k, v in arrays.items()}
                  for d in (cpu, device)}
        with fwd_tape.record(), moe_routes() as cpu_routes:
            want_fwd, want_aux = lm.lm_forward(on[cpu], inputs[cpu], cfg)
            want_fwd = want_fwd.float()
        with fwd_tape.replay(), moe_routes() as card_routes:
            got_fwd, got_aux = lm.lm_forward(on[device], inputs[device], cfg)
            got_fwd = got_fwd.float().cpu()
        held_tape(fwd_tape, "forward")
        if moe:
            same_routes(cpu_routes, card_routes, "forward")
            out["forward_dropped"] = float(want_aux["dropped"])
            need(float(got_aux["dropped"]) == out["forward_dropped"],
                 f"{label}: the forward's dropped fraction differs: "
                 f"{float(got_aux['dropped'])} on the card, "
                 f"{out['forward_dropped']} on the CPU")
        out["forward_rel_err"] = rel(got_fwd, want_fwd)
        if fwd_tape.tape:
            own_fwd = lm.lm_forward(on[device], inputs[device],
                                    cfg)[0].float().cpu()
            out["forward_own_codes_rel_err"] = rel(own_fwd, want_fwd)
        need(out["forward_rel_err"] <= LM_CARD_CPU_TOL, f"{label}: the "
             f"forward's logits differ by {out['forward_rel_err']:.3g} of "
             f"their largest")
        if cfg.family == "encoder":
            return out
        prompt = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab, (batch, prompt_len)).astype(np.int32))
        with dec_tape.record(), moe_routes() as cpu_routes:
            toks, want, _ = lm_decode(lm, on[cpu], cfg, prompt, gen,
                                      torch.float32)
        with dec_tape.replay(), moe_routes() as card_routes:
            _, got, _ = lm_decode(lm, on[device], cfg, prompt.to(device),
                                  gen, torch.float32, forced=toks.to(device))
        held_tape(dec_tape, "decode")
        if moe:
            same_routes(cpu_routes, card_routes, "decode")
        # the card's own greedy run, on the CPU's codes while its tokens
        # follow the CPU's (the only steps compared)
        with dec_tape.replay():
            own, _, _ = lm_decode(lm, on[device], cfg, prompt.to(device),
                                  gen, torch.float32)
    scale = want.abs().amax(-1)                          # [B, steps]
    err = ((got.cpu() - want).abs().amax(-1) / scale).max()
    out["decode_rel_err"] = float(err)
    need(out["decode_rel_err"] <= LM_CARD_CPU_TOL, f"{label}: decode logits "
         f"differ by {out['decode_rel_err']:.3g} of their largest")
    top2 = want.topk(2, -1).values
    margin = ((top2[..., 0] - top2[..., 1]) / scale).amin(0)   # [steps]
    close = [i for i in range(prompt_len - 1, prompt_len + gen - 1)
             if margin[i] <= LM_CARD_CPU_TOL]
    n = (close[0] if close else prompt_len + gen - 1) - (prompt_len - 1)
    need(torch.equal(own.cpu()[:, :prompt_len + n],
                     toks[:, :prompt_len + n]),
         f"{label}: the card's greedy tokens leave the CPU's within "
         f"{n} steps, where the CPU's margins are above {LM_CARD_CPU_TOL}")
    out["tokens_compared"] = n
    return out


def phase_lm(device, rehearse, out_dir, smi):
    """The LM families served by greedy decoding (the module docstring's
    phase 11). Returns its detail and the port's kernel launches of the
    main path (none expected: no LM product runs through a port kernel,
    as none runs through a Pallas kernel in the reference)."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import lm
    out = {"device": smi, "runs": {}, "card_vs_cpu": {}}
    t_phase = time.perf_counter()
    log(f"[lm] on {smi}: batch {LM_BATCH}, prompt {LM_PROMPT} tokens "
        f"(numpy seed {SEED}), {LM_GEN} generated, modes {LM_MODES}")
    reset_launch_counts()
    for arch in LM_ARCHS:
        cfg = (configs.smoke_variant if rehearse else configs.get_config)(
            arch)
        params = lm.init_lm(torch.Generator(device=device).manual_seed(SEED),
                            cfg, device=device)
        prompt = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, cfg.vocab, (LM_BATCH, LM_PROMPT)).astype(np.int32)).to(device)
        for mode in LM_MODES:
            r = lm_mode(lm, params, cfg, mode, prompt, device, out_dir)
            out["runs"][f"{arch} {mode}"] = r
            prof = ("" if "busy_share" not in r else
                    f"; {r['kernels_per_step']:.0f} kernels a step, device "
                    f"busy {r['busy_ms']:.3f} of a {r['window_ms']:.3f} ms "
                    f"{LM_PROFILE_STEPS}-step window "
                    f"({r['busy_share']:.1%}); peak memory "
                    f"{r['peak_memory_gb']:.3f} GB; top kernels "
                    f"{r['top_kernels_ms']}")
            pvd = "; ".join(
                f"{dt} ({'held' if v['held'] else 'printed'}) "
                f"{v['max_abs']:.4g} (x{v['ratio']:.3g} of the bound)"
                + ("" if "flipped" not in v else
                   f", on the prefill's codes {v['replayed_max_abs']:.4g} "
                   f"(x{v['replayed_ratio']:.3g}), {v['flipped']} of "
                   f"{v['codes']} codes flipped, activations within "
                   f"{v['gap_steps']:.3g} code steps")
                for dt, v in r["prefill_vs_decode"].items())
            log(f"[lm] {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, "
                f"{cfg.dtype}) {mode}: decode {r['ms_per_step_median']:.3f} "
                f"ms a step median of {LM_GEN} (first generated "
                f"{r['ms_first_generated']:.3f}), {r['tokens_per_s']:.1f} "
                f"tokens/s at batch {LM_BATCH}; first greedy_generate "
                f"{r['first_call_s']:.2f}s; tokens identical over 2 runs, "
                f"logits finite; prefill vs decode max |diff| (bound "
                f"rtol=atol={LM_PREFILL_TOL}): {pvd}{prof}; tokens "
                f"{r['tokens']}")
        del params
    counts = {"lm": launch_counts()}
    need(not any(counts["lm"].values()), f"[lm] a port kernel launched on "
         f"the LM path: {counts['lm']}")
    log(f"[lm] port kernel launches on the LM path: {counts['lm']} (none "
        f"expected)")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    cases = [(dataclasses.replace(
        (configs.smoke_variant if rehearse else configs.get_config)(a),
        n_layers=LM_CPU_LAYERS, dtype="float32", quant_scheme=q),
        "smoke" if rehearse else "full width")
        for a in LM_ARCHS for q in ("none", "w4a4")]
    cases += [(dataclasses.replace(configs.smoke_variant(a),
                                   dtype="float32"), "smoke")
              for a in LM_FAMILIES]
    for cfg, size in cases:
        t0 = time.perf_counter()
        r = lm_card_vs_cpu(lm, cfg, device, SEED)
        r["wall_s"] = time.perf_counter() - t0
        out["card_vs_cpu"][f"{cfg.name} {cfg.quant_scheme}"] = r
        codes = "".join(
            f"; {what}: {r[what]['flipped']} of {r[what]['codes']} codes "
            f"flipped, activations within {r[what]['gap_steps']:.3g} code "
            f"steps of the CPU's" for what in ("forward", "decode")
            if what in r)
        log(f"[lm] card vs CPU port, {cfg.name} {size} ({cfg.family}, "
            f"{cfg.n_layers} layers, d {cfg.d_model}, float32, TF32 off, "
            f"quant {cfg.quant_scheme}): forward logits within "
            f"{r['forward_rel_err']:.3g} of their largest"
            + ("" if "forward_own_codes_rel_err" not in r else
               f" on the CPU's codes ({r['forward_own_codes_rel_err']:.3g} "
               f"on the card's own)")
            + codes + ("" if "decode_rel_err" not in r else
                          f", {LM_PROMPT + LM_GEN} decode steps within "
                          f"{r['decode_rel_err']:.3g} (bound "
                          f"{LM_CARD_CPU_TOL}), greedy tokens equal over "
                          f"{r['tokens_compared']} of {LM_GEN}")
            + f"; {r['wall_s']:.2f}s")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[lm] phase {out['phase_s']:.1f}s")
    return out, counts


def host_memory_gb():
    """(total, available) host RAM in GB, from /proc/meminfo."""
    with open("/proc/meminfo") as f:
        info = {line.split(":")[0]: int(line.split()[1]) for line in f}
    return info["MemTotal"] / 1e6, info["MemAvailable"] / 1e6


def moe_prefill_check(lm, params, cfg, prompt):
    """The prompt's forward (S = 8) against its stepped decode (one token a
    step), with the expert indices of every routing of both. Returns the
    forward's aux and the gap: held to ``LM_PREFILL_TOL`` only where the
    two paths compute the same function, i.e. the forward dropped no slot
    (its capacity is per prompt, the decode's per token), every token went
    to the same experts in both (a bf16 ulp between the paths' hidden
    states can flip a near-tie of the router), and no W4A4 activation code
    is in play (the [lm] phase shows those flip between the paths too)."""
    import torch
    with moe_routes() as fwd_routes:
        fwd, aux = lm.lm_forward(params, {"tokens": prompt}, cfg)
    with moe_routes() as dec_routes:
        _, stepped, _ = lm_decode(lm, params, cfg, prompt, 0)
    b, t = prompt.shape
    layers = cfg.n_layers
    moved = 0
    for i, r in enumerate(fwd_routes):
        want = r.reshape(b, t, -1).sort(-1).values
        got = torch.stack([dec_routes[s * layers + i].reshape(b, -1)
                           for s in range(t)], 1).sort(-1).values
        moved += int((want != got).any(-1).sum())
    prefill = fwd.float()
    dropped = float(aux["dropped"])
    why = [w for w, c in (("slots dropped", dropped > 0),
                          (f"{moved} token-layers routed apart", moved > 0),
                          ("w4a4 codes", cfg.quant_scheme == "w4a4")) if c]
    gap = {"max_abs": float((stepped - prefill).abs().max()),
           "ratio": lm_allclose_ratio(stepped, prefill, LM_PREFILL_TOL),
           "routed_apart": moved, "held": not why,
           "not_held_for": ", ".join(why)}
    need(bool(torch.isfinite(prefill).all()), f"[moe] {cfg.name}: a logit of "
         f"the prompt's forward is not finite")
    if gap["held"]:
        need(bool(torch.allclose(stepped, prefill, rtol=LM_PREFILL_TOL,
                                 atol=LM_PREFILL_TOL)),
             f"[moe] {cfg.name}: the prompt's forward and the stepped decode "
             f"route alike, yet differ beyond rtol=atol={LM_PREFILL_TOL} "
             f"({gap})")
    return aux, gap


def moe_mode(lm, params, cfg, mode, prompt, device, out_dir):
    """One MoE config under one mode on the main path (``params`` already
    in storage for "storage"): greedy_generate and the timed greedy loop
    (identical tokens, every logit finite), the prompt's forward against
    its stepped decode (``moe_prefill_check``), the port's launch counts
    (none expected), and on the card the profiled window and the peak
    memory."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.nn.module import tree_bytes
    if mode == "w4a4":
        cfg = dataclasses.replace(cfg, quant_scheme="w4a4")
    cuda = device.type == "cuda"
    label = f"[moe] {cfg.name} {mode}"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    first = lm.greedy_generate(params, cfg, prompt, LM_GEN)
    if cuda:
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    toks, logits, ms = lm_decode(lm, params, cfg, prompt, LM_GEN)
    aux, gap = moe_prefill_check(lm, params, cfg, prompt)
    counts = launch_counts()
    need(torch.equal(first, toks), f"{label}: the tokens differ between "
         f"runs")
    need(bool(torch.isfinite(logits).all()), f"{label}: a logit is not "
         f"finite")
    need(not any(counts.values()), f"{label}: a port kernel launched on "
         f"the MoE path: {counts}")
    gen_ms = sorted(ms[LM_PROMPT:])
    med = gen_ms[len(gen_ms) // 2]
    out = {"ms_per_step_median": med, "ms_first_generated": ms[LM_PROMPT],
           "ms_prefill_steps": ms[:LM_PROMPT],
           "tokens_per_s": LM_BATCH * 1e3 / med, "first_call_s": first_s,
           "prompt_dropped": float(aux["dropped"]),
           "prompt_balance": float(aux["balance"]),
           "prompt_z": float(aux["z"]), "prefill_vs_decode": gap,
           "launches": counts, "tokens": first[0, LM_PROMPT:].tolist()}
    # a decode step reads every weight but the embedding table (grouped
    # at S = 1: capacity 1 a row, so every expert runs on every row)
    out["weights_read_gb"] = (tree_bytes(params) -
                              tree_bytes(params["embed"])) / 1e9
    out["hbm_bound_ms"] = out["weights_read_gb"] * 1e9 / HBM_BYTES_PER_S * 1e3
    if cuda:
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out.update(lm_profile(lm, params, cfg, prompt,
                              os.path.join(out_dir, LM_TRACE)))
        out["device_ms_per_step"] = out["busy_ms"] / LM_PROFILE_STEPS
    return out


def moe_combine_cast(device):
    """``nn.moe.to_combine_dtype`` to float8_e4m3fn and bfloat16 on the card
    and on the CPU, from float32 and bfloat16, over every float8 value,
    every midpoint of two (ties), values past +-448 and infinities: the
    same bits (NaN where ml_dtypes gives NaN). Returns the values held."""
    import torch
    from repro_torch.nn import moe
    f8 = torch.arange(256, dtype=torch.uint8).view(torch.float8_e4m3fn)
    fin = f8.float()[torch.isfinite(f8.float())].unique()
    mids = ((fin[1:].double() + fin[:-1].double()) / 2).float()
    v = torch.cat([fin, mids, torch.tensor([449.0, 464.0, 464.5, 480.0,
                                            1e4, float("inf")])])
    v = torch.cat([v, -v])
    for dtype in (torch.float8_e4m3fn, torch.bfloat16):
        for src in (torch.float32, torch.bfloat16):
            x = v.to(src)
            want = moe.to_combine_dtype(x, dtype).float()
            got = moe.to_combine_dtype(x.to(device), dtype).float().cpu()
            need(torch.equal(got.isnan(), want.isnan()) and
                 torch.equal(got[~got.isnan()], want[~want.isnan()]),
                 f"[moe] the {src} -> {dtype} combine cast differs between "
                 f"the card and the CPU")
    return v.numel()


def phase_moe(device, rehearse, out_dir, smi):
    """The MoE family served by greedy decoding (the module docstring's
    phase 12). Returns its detail and the port's kernel launches of the
    main path (none expected: the reference's MoE reaches no Pallas
    kernel, and the port's runs none)."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core.quant import W4A4
    from repro_torch.models import lm
    out = {"device": smi, "runs": {}, "card_vs_cpu": {}}
    t_phase = time.perf_counter()
    log(f"[moe] on {smi}: batch {LM_BATCH}, prompt {LM_PROMPT} tokens "
        f"(numpy seed {SEED}), {LM_GEN} generated; runs (arch, layers, "
        f"modes) {MOE_RUNS}")
    total = {}
    for arch, layers, modes in MOE_RUNS:
        base = (configs.smoke_variant if rehearse else configs.get_config)(
            arch)
        cfg = dataclasses.replace(base, n_layers=layers)
        params = lm.init_lm(torch.Generator(device=device).manual_seed(SEED),
                            cfg, device=device)
        prompt = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, cfg.vocab, (LM_BATCH, LM_PROMPT)).astype(np.int32)).to(device)
        for mode in modes:
            if mode == "storage":
                # the float tree goes: the storage run holds its levels only
                params = lm.quantize_lm_params(params, cfg, W4A4)
            r = moe_mode(lm, params, cfg, mode, prompt, device, out_dir)
            out["runs"][f"{arch} {layers}L {mode}"] = r
            for k, n in r["launches"].items():
                total[k] = total.get(k, 0) + n
            prof = ("" if "busy_share" not in r else
                    f"; {r['kernels_per_step']:.0f} kernels a step, device "
                    f"busy {r['busy_ms']:.3f} of a {r['window_ms']:.3f} ms "
                    f"{LM_PROFILE_STEPS}-step window "
                    f"({r['busy_share']:.1%}; "
                    f"{r['device_ms_per_step']:.3f} ms a step); peak memory "
                    f"{r['peak_memory_gb']:.3f} GB; top kernels "
                    f"{r['top_kernels_ms']}")
            g = r["prefill_vs_decode"]
            log(f"[moe] {cfg.name} ({layers} of {base.n_layers} layers, d "
                f"{cfg.d_model}, {cfg.n_experts} experts top-{cfg.top_k} of "
                f"d_ff {cfg.d_ff}, {cfg.moe_dispatch}, {cfg.dtype}) {mode}: "
                f"decode {r['ms_per_step_median']:.3f} ms a step median of "
                f"{LM_GEN} (first generated {r['ms_first_generated']:.3f}), "
                f"{r['tokens_per_s']:.1f} tokens/s at batch {LM_BATCH}; "
                f"weights read a step {r['weights_read_gb']:.3f} GB, bound "
                f"{r['hbm_bound_ms']:.3f} ms at "
                f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; "
                f"first greedy_generate {r['first_call_s']:.2f}s; tokens "
                f"identical over 2 runs, logits finite; the prompt's forward "
                f"dropped {r['prompt_dropped']:.4g} of its slots; prefill vs "
                f"decode max |diff| {g['max_abs']:.4g} (x{g['ratio']:.3g} of "
                f"rtol=atol={LM_PREFILL_TOL}, "
                f"{'held' if g['held'] else 'printed: ' + g['not_held_for']})"
                f"; port "
                f"kernel launches {r['launches']}{prof}; tokens "
                f"{r['tokens']}")
        del params
        if device.type == "cuda":
            torch.cuda.empty_cache()
    counts = {"moe": total}
    log(f"[moe] port kernel launches on the MoE path: {total} (none "
        f"expected)")
    out["combine_cast_values"] = moe_combine_cast(device)
    log(f"[moe] combine casts (float8_e4m3fn, bfloat16) bitwise equal on the "
        f"card and the CPU over {out['combine_cast_values']} values")
    cases = [(dataclasses.replace(
        configs.smoke_variant(arch), dtype="float32", moe_dispatch=disp,
        quant_scheme="w4a4" if mode == "w4a4" else "none"), mode, {})
        for arch in MOE_ARCHS for disp in MOE_DISPATCHES
        for mode in MOE_CPU_MODES]
    full = MOE_CPU_FULL
    cases.append((dataclasses.replace(
        (configs.smoke_variant if rehearse else configs.get_config)(
            full["arch"]), n_layers=full["layers"], dtype="float32"), "none",
        {"batch": full["batch"], "prompt_len": full["prompt"],
         "gen": full["gen"], "made_on": device}))
    for cfg, mode, kw in cases:
        if kw:
            total_gb, avail_gb = host_memory_gb()
            log(f"[moe] host RAM before the full-width card vs CPU run: "
                f"{avail_gb:.1f} of {total_gb:.1f} GB available")
        t0 = time.perf_counter()
        r = lm_card_vs_cpu(lm, cfg, device, SEED, storage=mode == "storage",
                           **kw)
        r["wall_s"] = time.perf_counter() - t0
        out["card_vs_cpu"][f"{cfg.name} {cfg.n_layers}L {cfg.moe_dispatch} "
                           f"{mode}"] = r
        gen = kw.get("gen", LM_GEN)
        steps = kw.get("prompt_len", LM_PROMPT) + gen
        codes = "".join(
            f"; {what}: {r[what]['flipped']} of {r[what]['codes']} codes "
            f"flipped, activations within {r[what]['gap_steps']:.3g} code "
            f"steps of the CPU's" for what in ("forward", "decode")
            if what in r)
        size = "full width" if kw and not rehearse else "smoke"
        log(f"[moe] card vs CPU port, {cfg.name} {size} ({cfg.n_layers} "
            f"layers, d "
            f"{cfg.d_model}, {cfg.moe_dispatch}, float32, TF32 off, {mode}, "
            f"batch {kw.get('batch', LM_BATCH)}): forward logits within "
            f"{r['forward_rel_err']:.3g} of their largest, dropped "
            f"{r['forward_dropped']:.4g} on both, expert indices equal over "
            f"{r['forward_routings_equal']} routings"
            + ("" if "forward_own_codes_rel_err" not in r else
               f" (on the CPU's codes; {r['forward_own_codes_rel_err']:.3g} "
               f"on the card's own)")
            + codes + f"; {steps} decode steps within "
            f"{r['decode_rel_err']:.3g} (bound {LM_CARD_CPU_TOL}), expert "
            f"indices equal over {r['decode_routings_equal']} routings, "
            f"greedy tokens equal over {r['tokens_compared']} of {gen}; "
            f"{r['wall_s']:.2f}s")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[moe] phase {out['phase_s']:.1f}s")
    return out, counts


# ---------------------------------------------------------------------------
# the [lm_train] phase
# ---------------------------------------------------------------------------

def lm_train_args(steps, ckpt_dir, rehearse, quant="none", every=None,
                  fail_at=None):
    """``launch/train.py``'s command line for one run of the phase."""
    args = ["--arch", LM_TRAIN_ARCH, "--steps", str(steps), "--batch",
            str(LM_TRAIN_BATCH), "--seq", str(LM_TRAIN_SEQ), "--quant", quant,
            "--ckpt-dir", ckpt_dir, "--seed", str(SEED),
            "--ckpt-every", str(every or 10 * steps),
            "--device", "cpu" if rehearse else "cuda"]
    if rehearse:
        args.append("--smoke")
    if fail_at is not None:
        args += ["--fail-at", str(fail_at)]
    return args


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)`` for the block, restored
    after. ``warn_only``: cuBLAS asks for ``CUBLAS_WORKSPACE_CONFIG`` to
    be deterministic across streams, and the drill runs on one stream,
    where cuBLAS is bitwise reproducible; that warning is dropped, every
    other one (an op with no deterministic CUDA path) is collected and
    named."""
    import warnings
    import torch
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            seen = []
            yield seen
        seen.extend(sorted({str(w.message).split("\n")[0][:160]
                            for w in caught
                            if "CuBLAS" not in str(w.message)
                            and "deterministic" in str(w.message)}))
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def lm_train_run(train, args, device):
    """One training run through the driver: its ``TrainRun``, with the
    peak memory and the losses' CE and grad norms read back."""
    import torch
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    run = train.train(args)
    run.peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    run.ce = [float(m["ce"]) for m in run.history]
    run.grad_norms = [float(m["grad_norm"]) for m in run.history]
    return run


def lm_train_summary(run, label):
    """Fatal unless every loss is finite; the step-time figures (median
    after the warm-up steps)."""
    need(all(math.isfinite(x) for x in run.losses + run.grad_norms),
         f"{label}: a loss or grad norm is not finite")
    timed = sorted(run.step_ms[LM_TRAIN_WARMUP:])
    med = timed[len(timed) // 2]
    return {"steps": len(run.losses), "first_step": run.first_step,
            "ms_per_step_median": med, "ms_first_steps":
            run.step_ms[:LM_TRAIN_WARMUP],
            "tokens_per_s": LM_TRAIN_BATCH * LM_TRAIN_SEQ * 1e3 / med,
            "loss_first": run.losses[0], "loss_last": run.losses[-1],
            "ce_first": run.ce[0], "ce_last": run.ce[-1],
            "grad_norm_first": run.grad_norms[0],
            "grad_norm_last": run.grad_norms[-1], "peak_memory_gb":
            run.peak_gb, "losses": run.losses}


def lm_train_profile(run, path):
    """``LM_TRAIN_PROFILE_STEPS`` more steps of the run's train step from
    its final state under the profiler, the window ending when the card is
    done: its device busy share, kernels a step, the top kernels, the
    kernels a step by name and the layers recomputed a step (the ``obs``
    counter ``remat.recompute``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch import obs
    recomputes = obs.counter("remat.recompute")
    state = run.state
    batches = [run.batch_fn(run.last_step + i)
               for i in range(LM_TRAIN_PROFILE_STEPS)]
    torch.cuda.synchronize()
    before = recomputes.get()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(LM_TRAIN_WINDOW):
            for b in batches:
                params, opt, _ = run.train_step(state["params"],
                                                state["opt"], b)
                state = {"params": params, "opt": opt}
            torch.cuda.synchronize()
    del state
    out_recomputes = (recomputes.get() - before) / LM_TRAIN_PROFILE_STEPS
    events = load_trace(prof, path)
    os.remove(path)
    out = busy_share(events, LM_TRAIN_WINDOW)
    kernels = [e for e in device_work(events, LM_TRAIN_WINDOW)[0]
               if e["cat"] == "kernel"]
    out["kernels_per_step"] = len(kernels) / LM_TRAIN_PROFILE_STEPS
    out["remat_recomputes_per_step"] = out_recomputes
    by_name, count = {}, {}
    for e in kernels:
        name = e["name"][:60]
        by_name[name] = by_name.get(name, 0.0) + e["dur"] / 1e3
        count[name] = count.get(name, 0) + 1
    out["top_kernels_ms"] = dict(sorted(by_name.items(),
                                        key=lambda kv: -kv[1])[:5])
    out["kernels_by_name"] = {k: v / LM_TRAIN_PROFILE_STEPS
                              for k, v in count.items()}
    return out


def same_state(got, want):
    """The leaves of two training states that differ (none: bitwise)."""
    import torch
    from repro_torch.nn.module import tree_flatten_with_paths
    want = dict(tree_flatten_with_paths(want))
    return [p for p, leaf in tree_flatten_with_paths(got)
            if not torch.equal(leaf, want[p])]


def lm_train_card_vs_cpu(cfg, device, seed):
    """``LM_TRAIN_CPU_STEPS`` train steps (``steps.make_train_step``) on
    the card and on the CPU from one set of weights made on the CPU and
    carried through numpy, over the driver's batches (the text stream, or
    ``modality_batch`` for a frontend), float32, TF32 off. Losses and grad
    norms within ``LM_CARD_CPU_TOL`` relative; each leaf of the params and
    the AdamW state within ``LM_CARD_CPU_TOL`` of its largest |entry|, or
    for params and master within ``LM_TRAIN_ADAM_TOL`` * lr absolute with
    at most ``LM_TRAIN_ADAM_SHARE`` of its entries past the first bound
    (the leaves that need it are named: where |g| is within a few of
    AdamW's eps, 1e-8, its normalized update m / (sqrt(v) + eps) follows
    the gradient's float32 error; the tied embedding's rows of tokens
    absent from the batch get gradients of that size)."""
    import torch
    from repro_torch.data.synthetic import (SyntheticTextConfig,
                                            modality_batch,
                                            synthetic_lm_batch)
    from repro_torch.kernels.conv_bank.ref import float32_convs
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.nn.module import tree_flatten_with_paths
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.weights import lm_params_from_numpy, lm_params_to_numpy
    cpu = torch.device("cpu")
    opt_cfg = AdamWConfig(lr=LM_TRAIN_LR)
    tree = lm_params_to_numpy(lm.init_lm(
        torch.Generator().manual_seed(seed), cfg, device="cpu"))
    text = SyntheticTextConfig(vocab=cfg.vocab, seq=LM_TRAIN_SEQ,
                               batch=LM_TRAIN_BATCH, seed=seed)

    def batch(step):
        if cfg.frontend == "none":
            return synthetic_lm_batch(text, step)
        return modality_batch(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                              seed=seed * 1_000_003 + step)

    runs = {}
    with float32_convs():
        for d in (cpu, device):
            params = lm_params_from_numpy(tree, d, cfg)
            state = {"params": params, "opt": adamw_init(params, opt_cfg)}
            step = make_train_step(cfg, opt_cfg, LM_TRAIN_SEQ)
            metrics = []
            for i in range(LM_TRAIN_CPU_STEPS):
                b = {k: torch.from_numpy(v).to(d)
                     for k, v in batch(i).items()}
                p, o, m = step(state["params"], state["opt"], b)
                state = {"params": p, "opt": o}
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            runs[d.type] = (metrics, state)
    label = f"[lm_train] card vs CPU {cfg.name} ({cfg.n_layers} layers)"
    out = {"losses": [], "grad_norms": [], "needs_adam_bound": {}}
    for (gl, gn), (wl, wn) in zip(runs[device.type][0], runs["cpu"][0]):
        out["losses"].append((gl, wl))
        out["grad_norms"].append((gn, wn))
        for g, w, what in ((gl, wl, "loss"), (gn, wn, "grad norm")):
            need(math.isfinite(g) and abs(g - w) <= LM_CARD_CPU_TOL * abs(w),
                 f"{label}: the {what} differs: {g} on the card, {w} on the "
                 f"CPU")
    want = dict(tree_flatten_with_paths(runs["cpu"][1]))
    worst = 0.0
    for path, leaf in tree_flatten_with_paths(runs[device.type][1]):
        w = want[path].double()
        err = float((leaf.cpu().double() - w).abs().max())
        scale = float(w.abs().max())
        ratio = err / scale if scale else (0.0 if err == 0 else math.inf)
        if ratio > LM_CARD_CPU_TOL:
            adam = path.startswith(("params/", "opt/master/"))
            over = float(((leaf.cpu().double() - w).abs()
                          > LM_CARD_CPU_TOL * scale).double().mean())
            need(adam and err <= LM_TRAIN_ADAM_TOL * LM_TRAIN_LR
                 and over <= LM_TRAIN_ADAM_SHARE,
                 f"{label}: {path} differs by {err:.3g} ({ratio:.3g} of its "
                 f"largest, {over:.3g} of its entries past "
                 f"{LM_CARD_CPU_TOL})")
            out["needs_adam_bound"][path] = {"abs": err, "rel": ratio,
                                             "of_lr": err / LM_TRAIN_LR,
                                             "share_over": over}
        else:
            worst = max(worst, ratio)
    out["worst_leaf_rel_err"] = worst
    out["leaves"] = len(want)
    return out


def phase_lm_train(device, rehearse, out_dir, smi):
    """The LM families trained (the module docstring's phase 13). Returns
    its detail and the port's kernel launches of the main path (none
    expected: no training product runs through a port kernel, as none
    runs through a Pallas kernel in the reference)."""
    import shutil
    import torch
    from repro_torch import configs
    from repro_torch.checkpoint.ckpt import restore_checkpoint
    from repro_torch.examples import train_lm_100m
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train
    from repro_torch.models import lm
    out = {"device": smi, "runs": {}, "card_vs_cpu": {}}
    t_phase = time.perf_counter()
    cuda = device.type == "cuda"
    ckpt_root = os.path.join(HERE, "build", "lm_train_ckpt")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    os.makedirs(ckpt_root)
    free_gb = shutil.disk_usage(ckpt_root).free / 1e9
    base = (configs.smoke_variant if rehearse else configs.get_config)(
        LM_TRAIN_ARCH)
    log(f"[lm_train] on {smi}: {base.name} ({base.n_layers} layers, d "
        f"{base.d_model}, {base.n_heads}/{base.n_kv_heads} heads, d_ff "
        f"{base.d_ff}, vocab {base.vocab}, remat {base.remat}, "
        f"{base.dtype}), batch {LM_TRAIN_BATCH}, seq {LM_TRAIN_SEQ}, lr "
        f"{LM_TRAIN_LR}, seed {SEED}, the planted-bigram stream; "
        f"{free_gb:.1f} GB free for checkpoints")
    steps = LM_TRAIN_STEPS
    try:
        reset_launch_counts()
        # quant none: the drill's uninterrupted run, so under deterministic
        # algorithms; it keeps its step-20 checkpoint (keep=2: 20 and 30)
        dirs = {k: os.path.join(ckpt_root, k)
                for k in ("none", "drill", "w4a4", "lm100m")}
        parts = out["parts_s"] = {}
        t0 = time.perf_counter()
        with deterministic_algorithms() as nondet:
            run = lm_train_run(train, lm_train_args(
                steps["none"], dirs["none"], rehearse,
                every=LM_TRAIN_DRILL["steps"]), device)
            r = lm_train_summary(run, "[lm_train] none")
            need(r["ce_last"] < r["ce_first"], f"[lm_train] none: the CE did "
                 f"not fall ({r['ce_first']:.4f} -> {r['ce_last']:.4f})")
            parts["none"] = time.perf_counter() - t0
            if cuda:
                t0 = time.perf_counter()
                r.update(lm_train_profile(run, os.path.join(
                    out_dir, LM_TRAIN_TRACE)))
                parts["none_profile"] = time.perf_counter() - t0
            out["runs"]["none"] = r
            uninterrupted = run.losses
            del run
            # the failure drill: a crash, then the restart
            drill = LM_TRAIN_DRILL
            t0 = time.perf_counter()
            try:
                train.train(lm_train_args(drill["steps"], dirs["drill"],
                                          rehearse, every=drill["every"],
                                          fail_at=drill["fail_at"]))
            except RuntimeError as e:
                need("injected failure" in str(e), f"[lm_train] drill: {e}")
            else:
                need(False, "[lm_train] drill: the injected failure did not "
                     "fire")
            resumed = lm_train_run(train, lm_train_args(
                drill["steps"], dirs["drill"], rehearse,
                every=drill["every"]), device)
            drill_s = time.perf_counter() - t0
        need(resumed.first_step == drill["every"], f"[lm_train] drill: the "
             f"restart resumed from step {resumed.first_step}, not "
             f"{drill['every']}")
        losses_equal = resumed.losses == uninterrupted[drill["every"]:
                                                       drill["steps"]]
        # the uninterrupted run's state at the drill's last step, saved and
        # restored: equal to the resumed run's in memory, it shows both the
        # continuation and the checkpoint round trip bitwise
        want = restore_checkpoint(dirs["none"], resumed.state,
                                  step=drill["steps"])
        differ = same_state(resumed.state, want)
        del want, resumed
        out["drill"] = {"losses_equal": losses_equal, "leaves_differ": differ,
                        "nondeterministic_ops": nondet, "wall_s": drill_s}
        need(not nondet, f"[lm_train] drill: ops with no deterministic CUDA "
             f"path: {nondet}")
        need(losses_equal and not differ, f"[lm_train] drill: the resumed "
             f"run differs from the uninterrupted one's restored checkpoint "
             f"(losses equal {losses_equal}; leaves {differ[:5]})")
        shutil.rmtree(dirs["drill"])
        shutil.rmtree(dirs["none"])
        log(f"[lm_train] {base.name} none (deterministic algorithms; the "
            f"drill's uninterrupted run): {r['ms_per_step_median']:.3f} ms a "
            f"step median of {r['steps'] - LM_TRAIN_WARMUP} after "
            f"{LM_TRAIN_WARMUP} warm-up ({r['ms_first_steps']}), "
            f"{r['tokens_per_s']:.0f} tokens/s; loss {r['loss_first']:.4f} "
            f"-> {r['loss_last']:.4f}, CE {r['ce_first']:.4f} -> "
            f"{r['ce_last']:.4f}, grad norm {r['grad_norm_first']:.4f} -> "
            f"{r['grad_norm_last']:.4f}"
            + ("" if not cuda else
               f"; peak memory {r['peak_memory_gb']:.3f} GB; "
               f"{r['kernels_per_step']:.0f} kernels a step, device busy "
               f"{r['busy_ms']:.3f} of a {r['window_ms']:.3f} ms "
               f"{LM_TRAIN_PROFILE_STEPS}-step window "
               f"({r['busy_share']:.1%}); top kernels "
               f"{r['top_kernels_ms']}"))
        log(f"[lm_train] restart drill ({drill['steps']} steps, "
            f"--ckpt-every {drill['every']}, --fail-at {drill['fail_at']}, "
            f"deterministic algorithms): resumed from step "
            f"{drill['every']}; losses of steps {drill['every']}-"
            f"{drill['steps'] - 1} bitwise equal to the uninterrupted run's, "
            f"and every leaf of the state at step {drill['steps']} to its "
            f"checkpoint restored (continuation and round trip bitwise); "
            f"ops without a deterministic path: {nondet or 'none'}; "
            f"{drill_s:.1f}s")
        parts["drill"] = drill_s
        # quant w4a4: the fake-quant with its STE gradients
        t0 = time.perf_counter()
        run = lm_train_run(train, lm_train_args(
            steps["w4a4"], dirs["w4a4"], rehearse, quant="w4a4"), device)
        r = lm_train_summary(run, "[lm_train] w4a4")
        parts["w4a4"] = time.perf_counter() - t0
        if cuda:
            t0 = time.perf_counter()
            r.update(lm_train_profile(run, os.path.join(out_dir,
                                                        LM_TRAIN_TRACE)))
            parts["w4a4_profile"] = time.perf_counter() - t0
        out["runs"]["w4a4"] = r
        del run
        shutil.rmtree(dirs["w4a4"])
        log(f"[lm_train] {base.name} W4A4 fake-quant: "
            f"{r['ms_per_step_median']:.3f} ms a step median of "
            f"{r['steps'] - LM_TRAIN_WARMUP} after {LM_TRAIN_WARMUP} warm-up "
            f"({r['ms_first_steps']}), {r['tokens_per_s']:.0f} tokens/s; "
            f"loss {r['loss_first']:.4f} -> {r['loss_last']:.4f}, CE "
            f"{r['ce_first']:.4f} -> {r['ce_last']:.4f}, grad norm "
            f"{r['grad_norm_first']:.4f} -> {r['grad_norm_last']:.4f}"
            + ("" if not cuda else
               f"; peak memory {r['peak_memory_gb']:.3f} GB; "
               f"{r['kernels_per_step']:.0f} kernels a step, device busy "
               f"{r['busy_ms']:.3f} of a {r['window_ms']:.3f} ms "
               f"{LM_TRAIN_PROFILE_STEPS}-step window "
               f"({r['busy_share']:.1%}); top kernels "
               f"{r['top_kernels_ms']}"))
        # the 100M example
        t0 = time.perf_counter()
        if rehearse:
            cfg100, _ = train_lm_100m.config_100m()
            narrow = dataclasses.replace(cfg100, n_layers=2, d_model=64,
                                         n_heads=4, n_kv_heads=2,
                                         head_dim=16, d_ff=128, vocab=256)
            made = train_lm_100m.config_100m
            train_lm_100m.config_100m = lambda: (narrow, narrow)
        try:
            run = train_lm_100m.run(["--steps", str(LM_TRAIN_100M_STEPS),
                                     "--ckpt-dir", dirs["lm100m"],
                                     "--device", device.type])
        finally:
            if rehearse:
                train_lm_100m.config_100m = made
        head, tail = run.losses[:10], run.losses[-10:]
        r = {"first10_mean_ce": sum(head) / len(head),
             "last10_mean_ce": sum(tail) / len(tail),
             "params": lm.count_params(run.cfg), "steps": len(run.losses),
             "ms_per_step_median": sorted(run.step_ms[LM_TRAIN_WARMUP:])[
                 (len(run.step_ms) - LM_TRAIN_WARMUP) // 2]}
        need(all(math.isfinite(x) for x in run.losses), "[lm_train] "
             "train_lm_100m: a loss is not finite")
        need(r["last10_mean_ce"] < r["first10_mean_ce"], f"[lm_train] "
             f"train_lm_100m: the CE did not fall ({r['first10_mean_ce']:.4f}"
             f" -> {r['last10_mean_ce']:.4f})")
        out["runs"]["train_lm_100m"] = r
        del run
        shutil.rmtree(dirs["lm100m"])
        parts["train_lm_100m"] = time.perf_counter() - t0
        log(f"[lm_train] train_lm_100m ({r['params'] / 1e6:.1f}M params, "
            f"{r['steps']} steps, batch 4, seq 128, lr 1e-3): first-10 mean "
            f"CE {r['first10_mean_ce']:.4f} -> last-10 mean CE "
            f"{r['last10_mean_ce']:.4f}; {r['ms_per_step_median']:.3f} ms a "
            f"step median")
        counts = {"lm_train": launch_counts()}
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    need(not any(counts["lm_train"].values()), f"[lm_train] a port kernel "
         f"launched on the LM training path: {counts['lm_train']}")
    log(f"[lm_train] port kernel launches on the LM training path: "
        f"{counts['lm_train']} (none expected)")
    if cuda:
        torch.cuda.empty_cache()
    cases = [dataclasses.replace(configs.smoke_variant(a), dtype="float32",
                                 **kw) for a, kw in LM_TRAIN_FAMILIES]
    cases.append(dataclasses.replace(
        base, n_layers=LM_CPU_LAYERS, dtype="float32"))
    t_cases = time.perf_counter()
    for cfg in cases:
        t0 = time.perf_counter()
        r = lm_train_card_vs_cpu(cfg, device, SEED)
        r["wall_s"] = time.perf_counter() - t0
        out["card_vs_cpu"][f"{cfg.name} {cfg.moe_dispatch}"] = r
        size = ("full width" if cfg.d_model == base.d_model and not rehearse
                else "smoke")
        named = "; ".join(f"{p} {v['abs']:.3g} ({v['of_lr']:.3g} lr, "
                          f"{v['share_over']:.3g} of its entries)"
                          for p, v in r["needs_adam_bound"].items())
        log(f"[lm_train] card vs CPU port, {cfg.name} {size} ({cfg.family}"
            + (f", {cfg.moe_dispatch}" if cfg.family == "moe" else "")
            + f", {cfg.n_layers} layers, d {cfg.d_model}, float32, TF32 "
            f"off), {LM_TRAIN_CPU_STEPS} steps: losses "
            f"{[round(g, 6) for g, _ in r['losses']]} within "
            f"{LM_CARD_CPU_TOL} of the CPU's, grad norms too; "
            f"{r['leaves'] - len(r['needs_adam_bound'])} of {r['leaves']} "
            f"leaves within {r['worst_leaf_rel_err']:.3g} of their largest"
            + (f"; within {LM_TRAIN_ADAM_TOL} lr (AdamW's eps-sensitive "
               f"update; at most {LM_TRAIN_ADAM_SHARE} of the entries past "
               f"{LM_CARD_CPU_TOL}): {named}" if named else "")
            + f"; {r['wall_s']:.2f}s")
    out["parts_s"]["card_vs_cpu"] = time.perf_counter() - t_cases
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[lm_train] phase {out['phase_s']:.1f}s ("
        + ", ".join(f"{k} {v:.1f}s" for k, v in out["parts_s"].items())
        + ")")
    return out, counts


# ---------------------------------------------------------------------------
# the [dist] phase
# ---------------------------------------------------------------------------

def dist_worlds(store, ckpt_dir, rehearse):
    """The multi-rank checks, grouped into one world a size (the save of
    the world-2 checkpoint before its restores). -> {check: result of
    rank 0, plus every rank's agreement} and the worlds' wall seconds."""
    from repro_torch.distributed import checks, world
    out, walls = {}, {}
    for size in (2, 4, 1):
        items = []
        for name, (w, fn, args, kw, where) in DIST_CHECKS.items():
            if w != size:
                continue
            if fn.startswith("elastic"):
                args = (ckpt_dir,) + args
            items.append((name, fn, args, dict(kw, device_type=(
                "cpu" if rehearse else where))))
        t0 = time.perf_counter()
        ranks = world.run_world(checks.suite, size, store, args=(items,),
                                timeout=DIST_WORLD_TIMEOUT)
        walls[size] = time.perf_counter() - t0
        for name, *_ in items:
            out[name] = {"rank0": ranks[0][name],
                         "ranks": [r[name] for r in ranks]}
    return out, walls


def dist_hold(results):
    """Fatal unless every multi-rank check held on every rank."""
    for r in results["tp_dp_train"]["ranks"] + \
            results["fsdp_tp_train"]["ranks"]:
        need(r["grad_loss_rel"] <= DIST_LOSS_REL and r["loss_rel"]
             <= DIST_LOSS_REL and r["grad_err"] <= 1e-4
             and r["placements_kept"] and r["param_err"] <= 1e-4,
             f"[dist] a sharded train step left the unsharded one: {r}")
    for name in ("moe_ep", "moe_ep_fsdp"):
        for r in results[name]["ranks"]:
            need(r["expert_parallel"] and r["indices_equal"]
                 and r["slots_equal"] and r["dropped"][0] == r["dropped"][1]
                 and r["y_err"] <= 1e-5 * max(1.0, r["y_max"])
                 and r["x_grad_err"] <= 1e-5 and r["w_grad_err"] <= 1e-5,
                 f"[dist] {name}: the expert-parallel block left the "
                 f"fallback: {r}")
    for r in results["compressed_allreduce"]["ranks"]:
        need(r["bitwise"] and r["error_bitwise"], f"[dist] compressed "
             f"all-reduce not bitwise: {r}")
    for r in results["gpipe"]["ranks"]:
        need(r["err_4"] <= 1e-5 and r["err_8"] <= 1e-5, f"[dist] GPipe "
             f"left the sequential loop: {r['err_4']}, {r['err_8']}")
    for name in ("elastic_restore_w4", "elastic_restore_w1"):
        for r in results[name]["ranks"]:
            need(r["bitwise"] and r["placements"] and r["data"]["equal"],
                 f"[dist] {name}: {r['bitwise']}, {r['placements']}, "
                 f"{r['data']}")


def dist_world1_train(train, device, rehearse, store, ckpt_dir, want,
                      out_dir):
    """[lm_train]'s configuration for ``DIST_TRAIN_STEPS`` steps through
    ``launch/train.py`` on a process group of one rank (``nccl`` on the
    card) and a (1, 1) DeviceMesh, under deterministic algorithms as
    [lm_train]'s run; held against that run's first losses ``want``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.nn.module import tree_flatten_with_paths
    backend = "gloo" if rehearse else "nccl"
    dist.init_process_group(backend, init_method=f"file://{store}/w1",
                            rank=0, world_size=1)
    try:
        # the profile too, as [lm_train]'s: deterministic algorithms
        # change the kernels a step
        with deterministic_algorithms() as nondet:
            run = lm_train_run(train, lm_train_args(
                DIST_TRAIN_STEPS, ckpt_dir, rehearse) + ["--mesh", "1x1"],
                device)
            leaves = list(tree_flatten_with_paths(run.state["params"]))
            need(run.mesh is not None and all(isinstance(x, DTensor)
                                              for _, x in leaves),
                 "[dist] world 1: the params are not DTensors")
            r = lm_train_summary(run, "[dist] world-1 train")
            r["backend"] = backend
            r["bitwise"] = run.losses == want
            r["loss_rel"] = max(abs(a - b) / abs(b)
                                for a, b in zip(run.losses, want))
            need(r["loss_rel"] <= DIST_LOSS_REL, f"[dist] world-1 losses "
                 f"{run.losses} left [lm_train]'s {want}")
            if device.type == "cuda":
                r.update(lm_train_profile(run, os.path.join(
                    out_dir, LM_TRAIN_TRACE)))
        r["nondeterministic_ops"] = nondet
        del run
        return r
    finally:
        dist.destroy_process_group()


def kernel_gap(got, want, top=8):
    """The ``top`` largest differences of two kernels-a-step-by-name
    tables, ``got`` - ``want``."""
    gap = {k: got.get(k, 0) - want.get(k, 0) for k in {*got, *want}}
    return dict(sorted(((k, v) for k, v in gap.items() if v),
                       key=lambda kv: -abs(kv[1]))[:top])


def dist_shard_batch(device, rehearse):
    """``Executable.run`` at ``DIST_SHARD_BATCH`` frames with
    ``Options(shard_batch=True, mesh=(dev, dev))``: the main path's launch
    counts (zeroed before, read after), then each program held bitwise to
    the unsharded run and to the reference backend (the plain PyTorch
    oracles, no kernel) on the same frames, so every kernel call at the
    shards' shapes is held against a plain version, and its launches equal
    to two unsharded runs of a shard's frames (each kernel once a shard)."""
    import numpy as np
    import torch
    from repro_torch import Options, Program
    from repro_torch.core.quant import W4A4
    from repro_torch.kernels import launch_counts, reset_launch_counts
    dev = str(device) if device.type == "cpu" else "cuda:0"
    plain = Options(scheme=W4A4, device=dev)
    sharded = dataclasses.replace(plain, shard_batch=True, mesh=(dev, dev))
    progs = {**vision_programs(), **{n: Program.from_pipeline(
        n, IMAGING_HW, IMAGING_HW, 3) for n in DIST_SHARD_PROGRAMS[2:]}}
    oracle = dataclasses.replace(plain, backend="reference")
    exes = {n: (progs[n].compile(sharded), progs[n].compile(plain))
            for n in DIST_SHARD_PROGRAMS}
    frames = {n: frames_for(progs[n], DIST_SHARD_BATCH, SEED + 7)
              for n in DIST_SHARD_PROGRAMS}
    for n, (exe, _) in exes.items():           # build and warm
        exe.run(frames[n])
    if device.type == "cuda":
        torch.cuda.synchronize()
    reset_launch_counts()
    got = {n: exes[n][0].run(frames[n]) for n in DIST_SHARD_PROGRAMS}
    if device.type == "cuda":
        torch.cuda.synchronize()
    counts = launch_counts()
    out = {"counts": counts, "programs": {}}
    half = DIST_SHARD_BATCH // 2
    for n in DIST_SHARD_PROGRAMS:
        exe, base = exes[n]
        want = base.run(frames[n])
        ref = progs[n].compile(oracle).run(frames[n])
        reset_launch_counts()
        exe.run(frames[n])
        shard_counts = launch_counts()
        reset_launch_counts()
        base.run(frames[n][:half])
        base.run(frames[n][half:])
        two_halves = launch_counts()
        equal = torch.equal(got[n], want)
        equal_ref = torch.equal(got[n], ref)
        out["programs"][n] = {"bitwise": equal, "bitwise_reference": equal_ref,
                              "launches": shard_counts,
                              "two_unsharded_halves": two_halves}
        need(equal, f"[dist] shard_batch {n}: not bitwise the unsharded run"
             f" (max abs {(got[n] - want).abs().max().item()})")
        need(equal_ref, f"[dist] shard_batch {n}: not bitwise the reference "
             f"backend (max abs {(got[n] - ref).abs().max().item()})")
        need(shard_counts == two_halves, f"[dist] shard_batch {n}: "
             f"launches {shard_counts} against {two_halves} for its two "
             f"shards run unsharded")
    return out


def dist_constants(device):
    """bf16 GEMM TFLOP/s and HBM GB/s, by CUDA events over ``DIST_REPS``
    launches after a warm-up, and the card's total memory."""
    import torch
    n = DIST_GEMM
    a = torch.randn(n, n, device=device, dtype=torch.bfloat16)
    b = torch.randn(n, n, device=device, dtype=torch.bfloat16)
    src = torch.empty(DIST_COPY_BYTES, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    out = {}
    for name, fn, work in (
            ("gemm", lambda: torch.matmul(a, b), 2 * n ** 3),
            ("copy", lambda: dst.copy_(src), 2 * DIST_COPY_BYTES)):
        for _ in range(3):
            fn()
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        for _ in range(DIST_REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        s = start.elapsed_time(end) / 1e3 / DIST_REPS
        out[name] = {"s": s, "rate": work / s}
    props = torch.cuda.get_device_properties(device)
    return {"peak_flops_bf16": out["gemm"]["rate"],
            "hbm_bw": out["copy"]["rate"],
            "gemm_ms": out["gemm"]["s"] * 1e3,
            "copy_ms": out["copy"]["s"] * 1e3,
            "hbm_per_chip": props.total_memory}


def host_env():
    """The environment of a host process of the port: CUDA hidden, the
    package on its path."""
    return dict(os.environ, CUDA_VISIBLE_DEVICES="",
                PYTHONPATH=os.pathsep.join(
                    [os.path.join(HERE, "src")]
                    + os.environ.get("PYTHONPATH", "").split(os.pathsep)))


def dist_dryrun_start(out_dir, rehearse):
    """The dry-run cells, one process each (no card: CUDA hidden)."""
    env = host_env()
    procs = []
    for arch, shape in DIST_DRYRUN:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", out_dir]
        if rehearse:
            cmd.append("--smoke")
        procs.append(((arch, shape), subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    return procs


def dist_dryrun_wait(procs, out_dir, timeout):
    """The cells' records; a cell's process is killed at ``timeout``."""
    from repro_torch.launch import mesh as mesh_mod
    recs = {}
    mesh = "x".join(map(str, mesh_mod.production_shape(False)[0]))
    deadline = time.monotonic() + timeout
    for (arch, shape), p in procs:
        try:
            text, _ = p.communicate(timeout=max(1.0, deadline
                                                - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            need(False, f"[dist] dry run {arch} x {shape} did not finish "
                 f"in {timeout:.0f}s")
        path = os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json")
        need(os.path.exists(path), f"[dist] dry run {arch} x {shape} wrote "
             f"no record (exit {p.returncode}): {text[-2000:]}")
        with open(path) as f:
            rec = recs[f"{arch} x {shape}"] = json.load(f)
        need(p.returncode == 0 and rec["status"] == "ok", f"[dist] dry run "
             f"{arch} x {shape}: {rec['status']}\n"
             f"{rec.get('traceback', '')[-3000:]}")
    return recs


def phase_dist(device, rehearse, out_dir, smi, lm_train_ref):
    """The distributed path (the module docstring's phase 14). Returns its
    detail and the port's kernel launches of the shard_batch path."""
    import shutil
    import tempfile
    import threading
    import torch
    from repro_torch.launch import train
    out = {"device": smi}
    t_phase = time.perf_counter()
    cuda = device.type == "cuda"
    root = os.path.join(HERE, "build", "dist")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    store = tempfile.mkdtemp(dir=root)
    dry_dir = os.path.join(out_dir, "dryrun")    # kept beside the details
    dry = dist_dryrun_start(dry_dir, rehearse)
    worlds = {}

    def run_worlds():
        try:
            worlds["out"] = dist_worlds(store, os.path.join(root, "elastic"),
                                        rehearse)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            worlds["error"] = e

    thread = threading.Thread(target=run_worlds, name="dist-worlds")
    thread.start()
    try:
        parts = out["parts_s"] = {}
        t0 = time.perf_counter()
        want = lm_train_ref["losses"][:DIST_TRAIN_STEPS]
        r = out["world1_train"] = dist_world1_train(
            train, device, rehearse, store, os.path.join(root, "w1_ckpt"),
            want, out_dir)
        parts["world1_train"] = time.perf_counter() - t0
        width = "smoke" if rehearse else "full width and depth"
        log(f"[dist] a. {LM_TRAIN_ARCH} ({width}) "
            f"{DIST_TRAIN_STEPS} steps through launch/train.py on a "
            f"{r['backend']} process group of 1 and a (1, 1) DeviceMesh, "
            f"every param a DTensor: losses {r['losses']} against "
            f"[lm_train]'s {want}: "
            + ("bitwise" if r["bitwise"] else
               f"within {r['loss_rel']:.3g} relative (<= {DIST_LOSS_REL})")
            + f"; {r['ms_per_step_median']:.3f} ms a step median of "
            f"{r['steps'] - LM_TRAIN_WARMUP} after {LM_TRAIN_WARMUP} "
            f"warm-up ({r['ms_first_steps']})"
            + ("" if not cuda else
               f"; {r['kernels_per_step']:.0f} kernels a step, device busy "
               f"{r['busy_ms']:.3f} of a {r['window_ms']:.3f} ms "
               f"{LM_TRAIN_PROFILE_STEPS}-step window "
               f"({r['busy_share']:.1%}); nondeterministic ops "
               f"{r['nondeterministic_ops'] or 'none'}"))
        if cuda:
            gap = kernel_gap(r["kernels_by_name"],
                             lm_train_ref["kernels_by_name"])
            r["kernels_by_name_gap"] = gap
            log(f"[dist] a. world 1 against [lm_train]: layers recomputed "
                f"a step {r['remat_recomputes_per_step']:g} against "
                f"{lm_train_ref['remat_recomputes_per_step']:g}; peak memory "
                f"{r['peak_memory_gb']:.3f} GB against "
                f"{lm_train_ref['peak_memory_gb']:.3f} GB; kernels a step "
                f"{r['kernels_per_step']:.0f} against "
                f"{lm_train_ref['kernels_per_step']:.0f}, the largest gaps "
                f"by name (world 1 - [lm_train]): {gap}")
            need(r["remat_recomputes_per_step"]
                 == lm_train_ref["remat_recomputes_per_step"],
                 "[dist] world 1: the layers recomputed a step differ from "
                 "[lm_train]'s")
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        sb = out["shard_batch"] = dist_shard_batch(device, rehearse)
        parts["shard_batch"] = time.perf_counter() - t0
        for n, p in sb["programs"].items():
            log(f"[dist] c. shard_batch {n}, {DIST_SHARD_BATCH} frames over "
                f"two shards of {device}: bitwise the unsharded run "
                f"{p['bitwise']}, bitwise the reference backend (no kernel) "
                f"{p['bitwise_reference']}; launches {p['launches']} = two unsharded "
                f"runs of a shard's frames {p['two_unsharded_halves']}")
        log(f"[dist] c. shard_batch main path launches {sb['counts']}")
        if cuda:
            t0 = time.perf_counter()
            c = out["constants"] = dist_constants(device)
            parts["constants"] = time.perf_counter() - t0
            log(f"[dist] e. constants on {smi}: bf16 GEMM {DIST_GEMM}^3 "
                f"{c['peak_flops_bf16'] / 1e12:.1f} TFLOP/s "
                f"({c['gemm_ms']:.3f} ms), device copy of {DIST_COPY_BYTES >> 20} MiB "
                f"{c['hbm_bw'] / 1e9:.1f} GB/s read+write "
                f"({c['copy_ms']:.3f} ms), total_memory "
                f"{c['hbm_per_chip']} bytes; NVLink 900 GB/s is the data "
                f"sheet's, not measured (one card)")
    finally:
        thread.join()
        recs = dist_dryrun_wait(dry, dry_dir, DIST_WORLD_TIMEOUT)
    if "error" in worlds:
        raise worlds["error"]
    results, walls = worlds["out"]
    dist_hold(results)
    out["checks"] = {k: v["rank0"] for k, v in results.items()}
    out["worlds_s"] = walls
    for name, (w, fn, *_rest, where) in DIST_CHECKS.items():
        r = results[name]["rank0"]
        shown = {k: v for k, v in r.items()
                 if k not in ("sequential", 4, 8, "losses",
                              "sharded_losses")}
        log(f"[dist] b. {name} (world {w}, {fn}; "
            f"{DIST_TRANSPORT['cpu' if rehearse else where]}): {shown}")
    log(f"[dist] b. worlds' wall seconds {walls}")
    for cell, rec in recs.items():
        bpr = rec["bytes_per_rank"]
        per_rank = sum(bpr.values())
        coll = rec["collectives"]
        mem = rec["memory"]
        log(f"[dist] d. dry run {cell} at {rec['mesh']} ({rec['wall_s']}s): "
            f"per-rank bytes {bpr} = {per_rank / 1e9:.3f} GB against the "
            f"card's {(c['hbm_per_chip'] if cuda else 80e9) / 1e9:.1f} GB; "
            f"memory a rank: arguments "
            f"{mem['argument_size_bytes'] / 1e9:.3f} GB, outputs "
            f"{mem['output_size_bytes'] / 1e9:.3f}, temp "
            f"{mem['temp_size_bytes'] / 1e9:.3f}, peak "
            f"{mem['peak_bytes'] / 1e9:.3f}; "
            f"{rec['flops']:.4g} FLOPs "
            f"({rec['flops_scope']}); collectives per rank: counts "
            f"{coll['counts']}, bytes {coll['bytes']}")
    out["dryrun"] = recs
    shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[dist] phase {out['phase_s']:.1f}s ("
        + ", ".join(f"{k} {v:.1f}s" for k, v in out["parts_s"].items())
        + ")")
    return out, {"shard_batch": sb["counts"]}


def roofline_start(out_dir, rehearse):
    """The [roofline] phase's two host processes (CUDA hidden): a.'s dry
    run of [lm_train]'s step and c.'s hillclimb. -> {name: (process,
    its output path, its start)}."""
    root = os.path.join(out_dir, "roofline")
    os.makedirs(root, exist_ok=True)
    step = os.path.join(root, "lm_train_step.json")
    cmds = {"step": ([sys.executable, "-c", ROOFLINE_STEP, LM_TRAIN_ARCH,
                      str(LM_TRAIN_BATCH), str(LM_TRAIN_SEQ),
                      "1" if rehearse else "0", step], step),
            "hillclimb": ([sys.executable, "-m",
                           "repro_torch.launch.hillclimb", "--cell",
                           ROOFLINE_CELL, "--all-variants", "--out", root],
                          os.path.join(root, f"{ROOFLINE_CELL}.json"))}
    procs = {}
    for name, (cmd, path) in cmds.items():
        if os.path.exists(path):
            os.remove(path)
        with open(os.path.join(root, f"{name}.log"), "w") as log_file:
            procs[name] = (subprocess.Popen(
                cmd, env=host_env(), stdout=log_file,
                stderr=subprocess.STDOUT), path, time.monotonic())
    return procs


def roofline_stop(procs):
    """Kill whichever of the phase's processes still runs."""
    for p, _, _ in procs.values():
        if p.poll() is None:
            p.kill()
        p.wait()


def roofline_wait(name, procs):
    """The JSON one of the phase's processes wrote, and its wall seconds;
    the process is killed ``ROOFLINE_TIMEOUT`` s after its start."""
    p, path, t0 = procs[name]
    try:
        p.wait(timeout=max(1.0, t0 + ROOFLINE_TIMEOUT - time.monotonic()))
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
        need(False, f"[roofline] {name} did not finish in "
             f"{ROOFLINE_TIMEOUT:.0f}s")
    wall = time.monotonic() - t0
    if p.returncode != 0 or not os.path.exists(path):
        with open(os.path.join(os.path.dirname(path), f"{name}.log")) as f:
            need(False, f"[roofline] {name} failed (exit {p.returncode}): "
                 f"{f.read()[-3000:]}")
    with open(path) as f:
        return json.load(f), wall


def phase_roofline(procs, rehearse, out_dir, smi, lm_train_ref, dist_out):
    """The roofline and the hillclimb over the dry run (the module
    docstring's phase 15)."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import roofline
    from repro_torch.launch.specs import ShapeCell
    out = {"device": smi}
    t_phase = time.perf_counter()
    # a. [lm_train]'s step, dry-run
    rec, wall = roofline_wait("step", procs)
    out["step"] = rec
    mem = rec["memory"]
    cfg = (smoke_variant if rehearse else get_config)(LM_TRAIN_ARCH)
    cell = ShapeCell("lm_train", LM_TRAIN_SEQ, LM_TRAIN_BATCH, "train")
    flops = roofline.cell_flops(cfg, cell)
    hbm = roofline.cell_hbm_bytes(cfg, cell)
    real = lm_train_ref["peak_memory_gb"]
    gap = None if real is None else mem["peak_bytes"] / (real * 1e9) - 1
    out["peak_gap"] = gap
    log(f"[roofline] a. {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model},"
        f" remat {cfg.remat}), batch {LM_TRAIN_BATCH}, seq {LM_TRAIN_SEQ}: "
        f"dryrun.run_step on a fake group of 1 and a (1, 1) mesh "
        f"({rec['wall_s']}s in the process, {wall:.1f}s from its start): "
        f"arguments {mem['argument_size_bytes'] / 1e9:.4f} GB, outputs "
        f"{mem['output_size_bytes'] / 1e9:.4f}, temp "
        f"{mem['temp_size_bytes'] / 1e9:.4f}, peak "
        f"{mem['peak_bytes'] / 1e9:.4f} GB against [lm_train]'s "
        + ("max_memory_allocated: not measured (no card)" if gap is None
           else f"max_memory_allocated {real:.4f} GB on {smi}: "
           f"{gap:+.2%} (within {ROOFLINE_PEAK_TOL:.0%})")
        + f"; counted FLOPs {rec['flops']:.6g} ({rec['flops_scope']}) "
        f"against model_flops {flops:.6g} ({rec['flops'] / flops:.4f}x)")
    if gap is not None:
        need(abs(gap) <= ROOFLINE_PEAK_TOL, f"[roofline] a. the dry run's "
             f"peak {mem['peak_bytes']} bytes is {gap:+.2%} off [lm_train]'s"
             f" measured {real} GB")
    step_ms = lm_train_ref["ms_per_step_median"]
    consts = {"launch/mesh.py": (mesh_mod.PEAK_FLOPS_BF16, mesh_mod.HBM_BW)}
    if "constants" in dist_out:
        c = dist_out["constants"]
        consts["[dist] e."] = (c["peak_flops_bf16"], c["hbm_bw"])
    out["terms"] = {}
    for name, (peak, bw) in consts.items():
        t = {"compute_ms": flops / peak * 1e3, "memory_ms": hbm / bw * 1e3}
        t["bound_ms"] = max(t.values())
        t["share_of_step"] = t["bound_ms"] / step_ms
        out["terms"][name] = t
        log(f"[roofline] a. roofline on {name}'s constants "
            f"({peak / 1e12:.1f} TFLOP/s, {bw / 1e9:.1f} GB/s): compute "
            f"{t['compute_ms']:.4f} ms ({flops:.6g} FLOPs), memory "
            f"{t['memory_ms']:.4f} ms ({hbm:.6g} bytes), bound "
            f"{t['bound_ms']:.4f} ms against [lm_train]'s "
            f"{step_ms:.3f} ms a step: the step at {t['share_of_step']:.2%}"
            f" of its roofline")
    # b. the roofline table over [dist] d.'s records
    dry_dir = os.path.join(out_dir, "dryrun")      # [dist] d.'s records
    mesh = "x".join(map(str, mesh_mod.production_shape(False)[0]))
    table = roofline.build_table(dry_dir, meshes=(mesh,))
    out["table"] = table
    out["cells"] = {}
    for arch, shape in DIST_DRYRUN:
        r = roofline.roofline_terms(arch, shape, mesh, dry_dir)
        need(r["status"] == "ok" and r["dryrun"] == "ok",
             f"[roofline] b. {arch} x {shape}: no usable record "
             f"({r['status']}, {r.get('dryrun')})")
        need(any(line.startswith(f"| {arch} | {shape} | {mesh} |")
                 for line in table.splitlines()),
             f"[roofline] b. {arch} x {shape} is not in the table")
        out["cells"][f"{arch} x {shape}"] = r
        log(f"[roofline] b. {arch} x {shape} at {mesh} ({r['chips']} "
            f"chips): compute {r['t_compute_s']:.6g} s, memory "
            f"{r['t_memory_s']:.6g} s, collective {r['t_collective_s']:.6g}"
            f" s ({r['collective_bytes_per_dev'] / 1e9:.3f} GB a rank over "
            f"NVLink's 900 GB/s), dominant {r['dominant']}, roofline "
            f"fraction {r['roofline_fraction']:.4f}; memory a rank temp "
            f"{r['memory_per_dev_gib']:.3f} GiB, arguments "
            f"{r['args_per_dev_gib']:.3f} GiB; counted FLOPs "
            f"{r['counted_flops_global']:.4g} against analytic "
            f"{r['flops_global']:.4g}")
    # c. the hillclimb's cell, every variant
    log_recs, wall = roofline_wait("hillclimb", procs)
    out["hillclimb"] = log_recs
    by = {r["variant"]: r for r in log_recs}
    from repro_torch.launch.hillclimb import CELLS, VARIANTS
    names = [v.name for v in VARIANTS[ROOFLINE_CELL]]
    need(sorted(by) == sorted(names), f"[roofline] c. {ROOFLINE_CELL}: "
         f"variants {sorted(by)}, expected {names}")
    arch, shape = CELLS[ROOFLINE_CELL]
    for name in names:
        r = by[name]
        log(f"[roofline] c. {ROOFLINE_CELL}/{name} ({arch} {shape}, 32x8, "
            f"{r['step_wall_s']}s): compute {r['t_compute_s']:.6g} s, "
            f"memory {r['t_memory_s']:.6g} s, collective "
            f"{r['t_collective_s']:.6g} s, dominant {r['dominant']}, "
            f"fraction {r['roofline_fraction']:.4f}; temp "
            f"{r['temp_gib_per_dev']:.3f} GiB, arguments "
            f"{r['args_gib_per_dev']:.3f} GiB a rank; collectives "
            f"{r['collectives']}")
    tp = by["serve_tp"]
    log(f"[roofline] c. serve_tp's collective term "
        f"{tp['t_collective_s']:.6g} s against base's "
        f"{by['base']['t_collective_s']:.6g} s "
        f"({tp['t_collective_s'] / by['base']['t_collective_s']:.4f}x); "
        "memory terms against serve_tp's " + ", ".join(
            f"{n} {by[n]['t_memory_s'] / tp['t_memory_s']:.4f}x"
            for n in names if n.startswith("serve_tp_"))
        + f" (the hillclimb {wall:.1f}s from its start)")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[roofline] phase {out['phase_s']:.1f}s after [dist] (its two "
        f"processes ran from [lm_train]'s start)")
    return out


def reread(trace_dir):
    """Each device-time range of the run whose traces lie in ``trace_dir``:
    its launches, kernel records and device ms per batch by kernel
    function; and the busy share (by kind, by port kernel, the torch ops
    by name) of the imaging serving window and, where the run left their
    traces, of the bound imaging burst and VGG16's bound window."""
    def events(name):
        with open(os.path.join(trace_dir, name)) as f:
            return json.load(f)["traceEvents"]
    timed = events(DEVICE_TRACE)
    ranges = sorted({e["name"] for e in timed
                     if e.get("cat") == "user_annotation"
                     and e["name"].startswith(DEVICE_RANGE)})
    out = {}
    for name in ranges:
        kernels, launches = device_work(timed, name, ("kernel",))
        by_fn = {}
        for e in kernels:
            fn = e["name"].replace("(anonymous namespace)::", "")
            fn = fn.removeprefix("void ").split("(")[0]
            by_fn[fn] = by_fn.get(fn, 0.0) + e["dur"] / DEVICE_ITERS / 1e3
        out[name[len(DEVICE_RANGE):]] = {
            "launches": launches, "kernel_records": len(kernels),
            "ms_per_batch": by_fn}
    shares = {"imaging_busy_share": busy_share(events(SERVE_TRACE))}
    for key, name in (("imaging_bound_busy_share", BOUND_SERVE_TRACE),
                      ("vgg16_bound_busy_share", VGG16_TRACE)):
        if os.path.exists(os.path.join(trace_dir, name)):
            shares[key] = busy_share(events(name))
    return {"device_time": out, **shares}


def call_label(d):
    """A per-call detail's shape, as the timing lines print it."""
    if "stages" in d:
        return f"{d['stages']} B={d['B']}"
    if "pool" in d:
        return f"{d['B']}x{d['H']}x{d['W']}x{d['C']} p={d['pool']}"
    return d.get("conv") or d.get("x") or (d["M"], d["K"], d["N"])


def launch_label(d):
    """A per-call detail's launch configuration: cluster and CTAs of the
    chain kernel, tile, run, channel block and CTAs of the depthwise one,
    route, run, threads and CTAs of ca_pool, CTAs of the others."""
    keys = ("form", "cluster", "splits", "weights_in_smem", "smem",
            "active_clusters", "tile", "run", "cb", "route", "r", "threads",
            "split", "vec", "nblk1", "nblk2", "store", "ctas")
    return ", ".join(f"{k} {d[k]}" for k in keys if k in d) or "-"


def frames_on(a, device):
    import torch
    return torch.from_numpy(a).to(device)


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run every phase on the CPU; exits 2, no result")
    ap.add_argument("--details", default=os.path.join(HERE, "build",
                                                      "chip_smoke.json"),
                    help="where to write the detail JSON")
    ap.add_argument("--reread", metavar="DIR",
                    help="print the device times and busy share of the "
                         "traces a run left in DIR, and exit")
    args = ap.parse_args(argv)
    if args.reread:
        print(json.dumps(reread(args.reread), indent=1))
        return 0
    rehearse = args.rehearse
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke test needs the card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        import repro_torch  # noqa: F401
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not next to this "
              f"script ({e})", file=sys.stderr)
        return 1
    device = torch.device("cpu" if rehearse else "cuda")
    os.makedirs(os.path.dirname(os.path.abspath(args.details)), exist_ok=True)
    roofline_procs = {}
    t_start = time.perf_counter()
    try:
        ptxas = {}
        if rehearse:
            smi, kind, count = "rehearsal (no card)", "cpu", 0
        else:
            smi = nvidia_smi()
            kind, count = torch.cuda.get_device_name(0), \
                torch.cuda.device_count()
            log(f"[device] {kind} x{count}; nvidia-smi: {smi}; torch "
                f"{torch.__version__} cuda {torch.version.cuda}")
            t0 = time.perf_counter()
            built = _build.build()
            log(f"[build] {time.perf_counter() - t0:.1f}s wall for "
                f"{sorted(built)} (per kernel: "
                f"{ {k: round(v, 1) for k, v in built.items()} })")
            ptxas = {name: ptxas_report(_build.library_path(name)
                                        .with_suffix(".log").read_text())
                     for name in _build.KERNELS}
            for name, fns in ptxas.items():
                log(f"[build] {name}: " + "; ".join(
                    f"{f['function']} {f['registers']} regs, "
                    f"{f['smem_bytes']} B smem, spills "
                    f"{f['spill_stores']}/{f['spill_loads']} B"
                    for f in fns))

        from repro_torch import Options
        from repro_torch.core.quant import W4A4
        from repro_torch.kernels.conv_bank import strip
        vision_progs, imaging_progs = vision_programs(), imaging_programs()
        opts = Options(scheme=W4A4, device=str(device))
        vision = path_calls({n: p.compile(opts)
                             for n, p in vision_progs.items()}, device)
        imaging = path_calls({n: p.compile(opts)
                              for n, p in imaging_progs.items()}, device)
        for path, calls in (("vision", vision), ("imaging", imaging)):
            log(f"[path] {path}, bucket {BUCKET}: photonic_mvm "
                f"{[(a.shape[0], a.shape[1], w.shape[1]) for a, w in calls['photonic_mvm']]}"
                f"; conv_chain {[tuple(c.shape) for c, _, _, _ in calls['conv_chain']]}"
                f"; ca_pool {[(tuple(i.shape), p) for i, p in calls['ca_pool']]}"
                f"; conv_strip {[(c[4], tuple(c[0].shape)) for c in calls['conv_strip']]}"
                f"; conv_strip_depthwise "
                f"{[(c[4], tuple(c[0].shape)) for c in calls['conv_strip_depthwise']]}"
                f"; epilogue {[(l, tuple(a.x.shape)) for a, l in calls['epilogue']]}")

        max_err, n_cmp, bank_float_err = phase_kernels(device, vision,
                                                       imaging)
        log(f"[kernels] bitwise equal to their plain versions: {n_cmp} "
            f"comparisons, max abs err {max_err}; conv_bank float mode "
            f"within {bank_float_err:.3g} of its plain version")
        bank_counts, bank_expected = phase_conv_bank_op(device)
        log(f"[conv_bank op] launches {bank_counts} (the rule's: "
            f"{ {k: v for k, v in bank_expected.items() if v} })")

        rows, detail = phase_timing(device, vision, imaging)
        out_dir = os.path.dirname(os.path.abspath(args.details))
        device_ms = phase_device_time(device, vision, imaging, os.path.join(
            out_dir, DEVICE_TRACE))
        ca_cold = device_ms.pop("ca_pool.cold")
        device_ms["conv_strip_int"] = device_ms.pop(
            "conv_strip_int.conv_bank_op", None)
        if "conv_bank_op" in rows.get("conv_strip_int", {}).get("by_path",
                                                                 {}):
            rows["conv_strip_int"]["by_path"]["conv_bank_op"][
                "device_ms"] = device_ms["conv_strip_int"]
        routes = phase_routes(device, {
            n: p.compile(opts) for n, p in imaging_progs.items()},
            os.path.join(out_dir, ROUTE_TRACE))
        for r in routes:
            if "fma_device_ms" in r:
                log(f"[route] {r['shape']}: float kernel device ms, "
                    f"CUDA-core form {r['fma_device_ms']}, tensor-core "
                    f"form {r['f64mma_device_ms']}; F.conv2d (TF32 off) "
                    f"{r['library_device_ms']}; bound {r['bound_ms']:.6f} "
                    f"({r['bound_by']}, FP64 tensor rate); the rule takes "
                    f"{r['rule']}, faster {r['faster']}")
                continue
            log(f"[route] {r['shape']}: float64 route device "
                f"{r['float_device_ms']} ms, int8 route device "
                f"{r['int_device_ms']} ms; the rule takes {r['rule']}, "
                f"faster {r['faster']}")
        # photonic_mvm's and ca_pool's rows are both paths' calls; each
        # path's device time is its own profiler range
        for k in ("photonic_mvm", "ca_pool", "epilogue"):
            dev = (device_ms[k], device_ms.pop(f"{k}.imaging"))
            rows[k]["by_path"]["vision"]["device_ms"] = dev[0]
            rows[k]["by_path"]["imaging"]["device_ms"] = dev[1]
            device_ms[k] = None if None in dev else sum(dev)
        for k, r in rows.items():
            log(f"[timing] {k}: {r['ms']:.4f} ms per call sequence (plain "
                f"{r['plain_ms']:.4f}, library {r['library_ms']} exact "
                f"{r['library_exact']}, bound {r['bound_ms']:.6f}, device "
                f"{device_ms[k]}); by path {r['by_path']}")
        for k in ("photonic_mvm", "conv_strip", "conv_strip_depthwise",
                  "ca_pool", "conv_bank", "conv_strip_int",
                  "conv_strip_f64mma"):
            for i, d in enumerate(detail[k]):
                if k == "conv_strip_int" and d["path"] != "conv_bank_op":
                    continue
                d["device_ms"] = device_ms.pop(f"{k}.shape{i}", None)
                d["library_device_ms"] = device_ms.pop(
                    f"library.{k}.shape{i}", None)
            # the library call's device ms beside its wall figure, by path
            # and (where every path has it) in all
            lib_dev = {}
            for d in detail[k]:
                lib_dev.setdefault(d["path"], []).append(
                    d.get("library_device_ms"))
            for path, ms in lib_dev.items():
                rows[k]["by_path"][path]["library_device_ms"] = (
                    None if None in ms else sum(ms))
            every = [m for ms in lib_dev.values() for m in ms]
            rows[k]["library_device_ms"] = (
                None if None in every or set(lib_dev) != set(
                    rows[k]["by_path"]) else sum(every))
            by_path = {path: b.get("library_device_ms")
                       for path, b in rows[k]["by_path"].items()}
            log(f"[timing] {k}: library device ms by path {by_path} (wall "
                f"{rows[k]['library_ms']})")
        # the epilogue's forms at each requant of the two paths
        totals = {}
        for i, d in enumerate(detail["epilogue"]):
            d["forms"] = {key.split(".")[2]: device_ms.pop(key)
                          for key in [k for k in device_ms
                                      if k.startswith(f"epilogue.form.")
                                      and k.endswith(f".{i}")]}
            for form, ms in d["forms"].items():
                t = totals.setdefault(d["path"], {}).setdefault(form, 0.0)
                totals[d["path"]][form] = None if None in (t, ms) else t + ms
            log(f"[epilogue form] {d['path']} {call_label(d)}: device ms "
                f"{d['forms']}; the rule takes {d['form']}"
                f"{d['cluster'] or ''}")
        for path, t in totals.items():
            log(f"[epilogue form] {path} per bucket-8 batch, device ms by "
                f"form: {t}")
        for k in KERNELS:
            for d in detail[k]:
                log(f"[timing] {k} {d['path']} {call_label(d)}: device "
                    f"{d.get('device_ms')} ms (library "
                    f"{d.get('library_device_ms')}), per call {d['ms']:.4f} "
                    f"ms, plain {d['plain_ms']:.4f}, library "
                    f"{d['library_ms']}, bound {d['bound_ms']:.6f}; launch "
                    f"{launch_label(d)}")
        cold = next(d for d in detail["ca_pool"] if d["path"] == "imaging"
                    and d["pool"] == 1)
        log(f"[timing] ca_pool cold L2 ({L2_FLUSH_BYTES >> 20} MiB written "
            f"before each launch) {call_label(cold)}: device {ca_cold} ms, "
            f"warm {cold.get('device_ms')} ms, bound {cold['bound_ms']:.6f}")

        served = {}
        counts, stats, wall, n_frames = phase_serve_vision(device,
                                                           vision_progs)
        served["vision"] = counts
        log(f"[serve vision] {n_frames} frames in {wall:.3f}s wall; "
            f"launches {counts}")
        for name, p in stats["programs"].items():
            lat = p["latency_ms"]
            log(f"[serve vision] {name}: {p['requests']['served']} requests,"
                f" {p['frames_served']} frames in {p['batches']} batches; "
                f"p50 {lat.get('p50', 0):.3f} ms p99 {lat.get('p99', 0):.3f}"
                f" ms; {p['achieved_fps']:.1f} frames/s")
        counts, istats, iwall, n_iframes, quality = phase_serve_imaging(
            device, imaging_progs)
        served["imaging"] = counts
        log(f"[serve imaging] {n_iframes} frames in {iwall:.3f}s wall; "
            f"launches {counts}")
        for name, p in istats["programs"].items():
            lat = p["latency_ms"]
            log(f"[serve imaging] {name}: {p['requests']['served']} "
                f"requests, {p['frames_served']} frames in {p['batches']} "
                f"batches; p50 {lat.get('p50', 0):.3f} ms p99 "
                f"{lat.get('p99', 0):.3f} ms; {p['achieved_fps']:.1f} "
                f"frames/s; PSNR vs apply_float {quality[name]:.2f} dB")

        busy = phase_busy_share(device, imaging_progs, os.path.join(
            out_dir, SERVE_TRACE))
        log(f"[serve imaging, profiled] device busy share {busy}")

        chain = chain_program()
        t0 = time.perf_counter()
        bound = phase_serve_bound(device, vision_progs, imaging_progs, chain,
                                  devices=2 if rehearse else 1)
        log(f"[serve bound] bind and capture "
            f"{bound['bind_and_capture_s']:.2f}s for "
            f"{len(bound['graphs'])} programs x {len(BUCKETS)} buckets; "
            f"phase {time.perf_counter() - t0:.1f}s")
        for path, w in bound["windows"].items():
            served[f"bound {path}"] = w["counts"]
            log(f"[serve bound] {path}: {w['frames']} frames in "
                f"{w['wall_s']:.3f}s wall, bitwise equal to batch-1 "
                f"run_per_frame; launches {w['counts']} (= the replays' "
                f"credits); PSNR {w['psnr_db']}")
        log("[serve bound] three batches in flight on one bound view: each "
            "its own answer (lenet, edge_detect, chain)")
        bound_busy = phase_busy_share(device, imaging_progs, os.path.join(
            out_dir, BOUND_SERVE_TRACE), bound=True)
        log(f"[serve imaging bound, profiled] device busy share "
            f"{bound_busy}")

        load_s = REHEARSAL_LOAD_S if rehearse else LOAD_S
        load = phase_load(device, {
            name: {**vision_progs, **imaging_progs, "chain": chain}[name]
            for name in LOAD_PROGRAMS}, load_s["saturate"],
            load_s["poisson"])
        for name, modes in load.items():
            b, e = modes["bound"], modes["eager"]
            log(f"[load] {name}: saturate {e['saturate_fps']:.1f} -> "
                f"{b['saturate_fps']:.1f} frames/s (eager -> bound); "
                f"poisson at {b['poisson_rate_rps']:.1f} req/s: eager p50 "
                f"{e['latency_ms'].get('p50', float('nan')):.3f} p99 "
                f"{e['latency_ms'].get('p99', float('nan')):.3f} ms (served "
                f"{e['poisson_served']}/{e['poisson_requests']}, rejected "
                f"{e['poisson_rejected']}, behind {e['poisson_behind_schedule']})"
                f", bound p50 {b['latency_ms'].get('p50', float('nan')):.3f} "
                f"p99 {b['latency_ms'].get('p99', float('nan')):.3f} ms "
                f"(served {b['poisson_served']}/{b['poisson_requests']}, "
                f"rejected {b['poisson_rejected']}, behind "
                f"{b['poisson_behind_schedule']})")

        obs_out = {"serve": phase_obs_serve(device, vision_progs,
                                            imaging_progs, out_dir)}
        o = obs_out["serve"]
        log(f"[obs] traced bound server (LeNet, VGG9-CA, edge_detect): "
            f"{o['window']['frames']} frames bitwise equal to batch-1 "
            f"run_per_frame; trace {o['trace']['records']} records, device "
            f"spans {o['trace']['device_spans']}; check_trace.py "
            f"--min-devices 1 passed")
        log(f"[obs] admin {o['admin']['url']}: /healthz /readyz /metrics "
            f"/statusz /statusz?format=text answered 200 "
            f"({o['admin']['bytes']} bytes); /tracez passed --flight")
        log(f"[obs] dumps (each passed --flight --require-trigger where "
            f"triggered): {[(d['reason'], d['records']) for d in o['dumps']]}")
        obs_out["busy"] = phase_obs_busy(device, imaging_progs, os.path.join(
            out_dir, OBS_BUSY_TRACE))
        log(f"[obs] bound imaging burst, traced and profiled: "
            f"serve.device.execute spans vs CUPTI busy {obs_out['busy']}")
        obs_out["cost"] = phase_obs_cost(device, {
            name: {**vision_progs, **imaging_progs}[name]
            for name in OBS_COST_PROGRAMS},
            REHEARSAL_OBS_COST_S if rehearse else OBS_COST_S)
        for name, c in obs_out["cost"].items():
            fps = {v: sum(r) / len(r) for v, r in c["fps"].items()}
            recs = {v: sum(r) / len(r)
                    for v, r in c["records_per_request"].items()}
            log(f"[obs] {name} bound, saturate x{c['requests']} single-frame"
                f" requests, {OBS_VARIANTS}: A (no recorder) {fps['A']:.1f}"
                f" frames/s; " + "; ".join(
                    f"{v} {fps[v]:.1f} ({c['ratio_to_A'][v]:.4f} of A, "
                    f"{recs[v]:.2f} records/request)" for v in "BCD")
                + f"; runs {c['fps']}")

        vgg16, vgg16_counts, vgg16_err, vgg16_cmp = phase_vgg16(
            device, rehearse, out_dir, ptxas)
        served.update(vgg16_counts)
        for k in vgg16_err:
            max_err[k] = max(max_err[k], vgg16_err[k])
            n_cmp[k] += vgg16_cmp[k]
        for k, v in vgg16["by_kernel"].items():
            rows.setdefault(k, {"library_exact": None, "by_path": {}})
            rows[k]["by_path"]["vgg16"] = v
        # the int8 kernel's line is its main path's: VGG16's conv1-conv10
        # (the conv_bank op's calls stay under by_path)
        v = vgg16["by_kernel"]["conv_strip_int"]
        rows["conv_strip_int"].update(
            {key: v[key] for key in ("ms", "plain_ms", "library_ms",
                                     "bound_ms", "library_exact")},
            library_device_ms=v.get("library_device_ms"),
            t_bytes=float(v["bound_by"] == "bytes"),
            t_ops=float(v["bound_by"] != "bytes"))
        device_ms["conv_strip_int"] = v["device_ms"]

        eager_out, eager_counts = phase_eager(device, rehearse, vision_progs,
                                              smi)
        served.update(eager_counts)

        train, train_counts, train_err, train_cmp = phase_train(
            device, rehearse, out_dir)
        served.update(train_counts)
        max_err["photonic_mvm"] = max(max_err["photonic_mvm"], train_err)
        n_cmp["photonic_mvm"] += train_cmp
        rows["photonic_mvm"]["by_path"]["train"] = {
            key: sum(r[key] for r in train["float_api"])
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        rows["photonic_mvm"]["by_path"]["train"]["calls"] = \
            len(train["float_api"])

        lm_out, lm_counts = phase_lm(device, rehearse, out_dir, smi)
        served.update(lm_counts)
        moe_out, moe_counts = phase_moe(device, rehearse, out_dir, smi)
        served.update(moe_counts)
        roofline_procs = roofline_start(out_dir, rehearse)
        lm_train_out, lm_train_counts = phase_lm_train(device, rehearse,
                                                       out_dir, smi)
        served.update(lm_train_counts)
        dist_out, dist_counts = phase_dist(
            device, rehearse, out_dir, smi,
            lm_train_out["runs"]["none"])
        served.update(dist_counts)
        roofline_out = phase_roofline(roofline_procs, rehearse, out_dir, smi,
                                      lm_train_out["runs"]["none"],
                                      dist_out)

        launches = {k: {path: served[path][k] for path in served}
                    for k in KERNELS}
        for k in KERNELS:
            launches[k]["conv_bank_op"] = bank_counts[k]
        kernels = []
        for name in KERNELS:
            src, replaces = SOURCES[name]
            srcs = (src,) if isinstance(src, str) else src
            replaced = (replaces,) if isinstance(replaces, str) else replaces
            r = rows[name]
            n = bank_counts[name] if name in OP_KERNELS else \
                sum(served[path][name] for path in served)
            kernels.append({
                "name": name, "route": "cuda", "source": srcs[0],
                "sources": list(srcs), "replaces": replaced[0],
                "replaces_all": list(replaced), "launches": n,
                "launches_by_path": launches[name],
                "max_abs_err": max_err[name],
                "bitwise_equal": max_err[name] == 0.0, "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": ("bytes" if r["t_bytes"] >= r["t_ops"]
                             else "operations"),
                "library_ms": r["library_ms"],
                "library_device_ms": r.get("library_device_ms"),
                "library_exact": r["library_exact"],
                "device_ms": device_ms[name], "by_path": r["by_path"]})
        with open(args.details, "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi, "kernels": kernels,
                       "ptxas": ptxas,
                       "per_call": detail, "serve_stats": stats,
                       "imaging_serve_stats": istats, "psnr_db": quality,
                       "imaging_busy_share": busy,
                       "serve_bound": bound,
                       "imaging_bound_busy_share": bound_busy,
                       "load": load, "obs": obs_out, "vgg16": vgg16,
                       "eager": eager_out,
                       "train": train, "lm": lm_out, "moe": moe_out,
                       "lm_train": lm_train_out, "dist": dist_out,
                       "roofline": roofline_out,
                       "ca_pool_cold_device_ms": ca_cold,
                       "comparisons": n_cmp,
                       "conv_bank_float_err": bank_float_err,
                       "seconds": time.perf_counter() - t_start}, f,
                      indent=1, default=str)
        if not rehearse:
            # the eager windows and the bound ones (counted through the
            # captured graphs' credited replays)
            for path, names in PATH_KERNELS.items():
                for window in (path, f"bound {path}"):
                    for k in names:
                        if window in served:
                            need(served[window][k] > 0, f"{k} never "
                                 f"launched on the {window} serving path")
                need(f"bound {path}" in served, f"no bound {path} window")
            # the op's run: every call on the kernel the rules give it,
            # one launch a call (the float mode's 16 -> 32 calls on the
            # tensor-core form in both strategies, the narrow call on the
            # CUDA-core form, the quantized 16 -> 32 calls on the int8
            # kernel)
            for k in OP_KERNELS + ("conv_strip_int",):
                need(bank_counts[k] > 0, f"{k} never launched by the "
                     f"conv_bank op")
            need(bank_counts == bank_expected,
                 f"conv_bank op: launches {bank_counts}, the rules give "
                 f"{bank_expected}")
            for k in SHARD_BATCH_KERNELS:
                need(served["shard_batch"][k] > 0, f"{k} never launched on "
                     f"the shard_batch path")
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        roofline_stop(roofline_procs)
    if rehearse:
        log(f"[rehearsal] all phases ran on the CPU in "
            f"{time.perf_counter() - t_start:.1f}s; no card, no result")
        return 2
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
