#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. the card: ``nvidia-smi`` name and power limit;
2. build: compiles every CUDA kernel of ``voiceactivityprojection_tpu_torch/csrc``;
3. kernels vs their plain PyTorch versions on the card at main-path shapes,
   in float32 with TF32 off and in bfloat16: the conv stack (R=8 x 320000
   samples and a ragged length) and, in float32, its backward against
   autograd of the plain stack; GRU+downsample (2B=8 x 2000 steps and an
   odd length), inference attention (B=8, H=4, T=1000 and T=3000) and its
   backward, the GRU recurrence (R=32 x 2000 steps, R=3 x 1999), the GRU
   backward (R=32 x 2000, R=3 x 1999, R=32 x 128, and in bfloat16 R=9 x
   333; in float32 also against autograd of the plain forward), the
   training attention forward (out and lse) and backward (dq, dk, dv) at
   B=16, H=4, T=1000 and B=2, T=3000 with dropout 0, 0.1 and 0.5; the offset attention (B=1, H=4, Tq=1500 at
   offsets 0, 1500, 4500 of Tk=6000, and Tq=1000 at 2337 of 3337); conv0 +
   conv1 (R=8 x 320000 and a ragged length, R=1 x 161, R=2 at a length one
   conv1 output past a tile edge, and the 600 s call's shard shape) and, in
   float32, its backward
   against autograd of the plain layers (R=2); the float32 routes at H =
   256 (conv1-conv4 on the 3xTF32 wgmma kernel, K2 and K3 on their f32
   cluster kernels) at their edges (K2 at R = 1, 2, 3, 9, 17, 128 and T =
   1, 2, 33, 485, 3000; K3 at R = 1, 2, 3, 9, 17, 32, 128, 512 by T = 1, 2,
   33, 1999, 2000, h0 zero and nonzero; the conv stack at ragged lengths),
   with the kernel each launch took by the launch ledger
   (``f32_routes``: K1, K2, K3 and the training forward, whose float32
   launches in this phase all took the 3xTF32 kernel; ``routes``: K9 at
   its shapes on the cluster design of each dtype, K11 on its dtype's
   tensor-core kernel); and the kernels
   without a backward (K2, K10) refusing a grad-requiring input;
4. the inference slice: ``VapModel(VapConfig())`` on the card with weights
   drawn from a seed in the JAX params layout, serving requests of
   (B, 2, 320000) through ``probs`` in float32 and bfloat16, with the
   launch ledger read around each run (and, in float32, the kernels K1 and
   K2 took: 3xTF32 and the f32 cluster), one request checked against the
   same port on the CPU (plain path, float32), and a bfloat16 request
   profiled;
5. the training slice: the frozen-encoder train step at ``VapConfig()``
   widths (dropout 0.1, AdamW) on B=16 x 20 s batches, three steps in
   bfloat16 and three in float32 with the launch ledger read around each
   step, the frozen weights checked unchanged and the trained ones moved,
   then one more step of each checked finite and profiled; one eval step; one
   float32 step on the card against the same step on the CPU at dropout 0
   and at 0.1 (the elementwise masks drawn on the CPU for both), each
   running the training attention kernels; every float32 step's K3 on the
   f32 cluster kernel and its K6 on 3xTF32 by the ledger
   (``f32_routes``);
6. the encoder-training slice: the unfrozen train step
   (``VapConfig(freeze_encoder=False)``) on B=16 x 20 s batches, three
   steps in bfloat16 with the launch ledger read around each (the GRU
   backward once a step) and every weight moved, then one more step
   checked finite and profiled; one float32 unfrozen step on the card against the CPU
   at dropout 0 (B=1 x 2 s); CPC pretraining (``train/cpc_pretrain.py``)
   at B=32 x 20480 samples, dim 256, 12 predicted steps, 128 negatives,
   float32: three checked steps (launch ledger, a finite loss, the
   encoder moved and its unused downsample not; K3 on the f32 cluster
   kernel), one more checked finite and profiled, and one step on the card
   against the CPU at B=4;
7. the long-audio slice: ``probs_context_parallel`` (and
   ``forward_context_parallel``) on 600 s of stereo over a 4-shard mesh
   that repeats the one card, float32 and bfloat16, with the default conv
   stage and with ``VAP_CONV_IMPL=fused``, the launch ledger read around
   each call (the offset attention at 14 sites x 4 shards, the GRU
   recurrence once per shard, in float32 on its f32 cluster kernel, conv0
   + conv1 once per shard under ``fused``) and the logits held against the
   single-device forward on the card; the bfloat16 single shot profiled;
8. the conv0 + conv1 kernel in stereo inference: ``probs`` at B=64 x 20 s
   bfloat16 under ``VAP_CONV_IMPL=fused`` (its launch per request, no conv
   stack kernel) against the default path, then one fused request
   profiled;
9. the mono model (``VapMonoModel``, with the history conditioning) at B=8
   x 20 s float32 on the card, its launches, against the CPU;
10. the attention routes, after the main paths' phases: ``VapConfig(attn_impl=
   "xla")`` on the card (no attention launch, p within the float32 bar of
   ``"auto"``); the attention kernels at head widths 32 and 128 against
   their plain versions (K4 at B=8 x 1000, the training pair at B=16 x
   1000 with dropout 0.1, K10 at Tq=1500 from 1500 of 6000 keys); and
   ``VapConfig(num_heads=8)`` and ``num_heads=2`` through those kernels,
   the forward in float32 and bfloat16 against the CPU and one bfloat16
   train step, with the launch ledger read around each;
11. kernel times: each kernel's time with CUDA events
   beside its bound, its plain version's time and one PyTorch library call
   that computes the same function (timed as a yardstick only; the port
   never calls it; cuDNN's GRU yardsticks of K2 and K9, which swing, as the
   median of five separate timings with their spread); the conv stack's
   five launches one by one; the GRU recurrence also at the 600 s call's
   shard shape (R=2 x 15,000 steps) and at the streamers' (T = 1 and 2),
   in float32 the cluster kernel beside the block kernel it took over from
   (``f32_block_ms``, through the library's entry), and a
   ``gru_rows_sweep`` line (its microseconds a step at R = 2, 8, 32, 128,
   bf16 cluster kernel, float32 cluster and block kernels); the GRU
   backward at the unfrozen step's and the CPC step's shapes (each launch
   of the cluster design timed alone as ``per_phase_ms``; the float32
   cluster design at the train shape as ``f32_ms`` and
   ``f32_per_phase_ms`` beside cuDNN's float32 backward, the ``-Xptxas -v``
   lines as ``registers`` and ``f32_registers``); the
   inference attention kernel also at K5's shape (B=1, T=3000); the offset
   attention at one site of the 600 s call; conv0 + conv1 at the B=64
   request's shape (the kernel a launch of each dtype took, by the
   library's own launch counts, in ``design``; the float32 3xTF32 kernel
   as ``f32_ms`` and ``f32_design``; K1's conv0 and
   conv1 of this run as ``per_layer_ms``; the ``-Xptxas -v`` lines as
   ``registers``) and at the 600 s call's shard shape. Every kernel also
   in float32: ``f32_ms``, ``f32_bound_ms`` (67 TFLOP/s, 4-byte elements),
   ``f32_library_ms`` (the same PyTorch call in float32; cuDNN with TF32
   off) and ``f32_launches`` (its launches on the default float32 paths of
   phases 4-7); K1's ``f32_bound_ms`` takes conv1-conv4's three TF32
   products at 495 TFLOP/s (``f32_ffma_bound_ms``: all at 67), and so do
   the 3xTF32 attention kernels' (K4, K5, K10, K6, K7/K8, which add their
   float32 error against the plain version at the timed shape,
   ``max_abs_err_f32``, and their ``-Xptxas -v`` lines as ``registers``);
   K1 each float32 layer, K2 each f32 tiling at R=128 and R=2
   (``f32_ms_by_tiling``); the KV attention row (K12, float32 only) at the
   stream cell's S=512 and one dialog's S=1, 1,000 full slots, the write
   cursor on the card as the streamers pass it: ms and TB/s
   against its bound (bytes), the plain row, the library yardstick
   (``F.scaled_dot_product_attention`` at query length 1 with a float
   ALiBi and validity bias, never called by the port), the route of each
   shape, the device ms a call from a profile (at S=1 the events time the
   host's pace), and a KV hop's launches by route; and, last in the line,
   the projections' GEMM (K13, float32 only) at the inference cell's
   M=128,000 x (N, K) = (768, 256), (256, 256), (256, 768), its GELU
   epilogue at (768, 256) and residual epilogue at (256, 256), and dX, dW
   at the frozen step's 16,000 rows at the same three (N, K): ms and
   device ms (stream held) against its bound (three TF32 products) and the
   FFMA bound, the plain version, ``F.linear`` / ``torch.addmm`` /
   ``torch.mm`` as ``library_ms``, each against float64 beside one TF32
   pass. K13's launches follow the dtype: every phase that runs
   the GPTs expects its GEMMs in float32 and none in bfloat16 or in a KV
   tick, and phases 4, 5 and 15 (e) check its kernels one by one
   (``routes``: the GEMM, the weights' splits, dW's slice sums);
12. offline extraction, the ``run`` CLI as a user runs it
   (``python -m voiceactivityprojection_tpu_torch.run``: (a) on the card in
   a process of its own, every other mode through the CLI's ``main`` in
   this process), on WAV files and reference checkpoints written here from the
   seeded weights (``export_vap_state_dict``): (a) 30 s single shot in
   float32 against the same CLI with ``--device cpu``; (b) in bfloat16
   against that; (c) 200 s, chunked (over 160 s), 10,000 frames, its first
   window against one direct ``probs``; (d) ``--context_parallel`` on it
   against one direct ``probs`` of the whole file; (e) a legacy Lightning
   ``.ckpt`` giving the ``.pt``'s JSON; (f) 10 s of mono at 22,050 Hz, with
   the decoder and resampler that ran. Then the same extraction in this
   process with the launch ledger read around each mode (single shot,
   chunked, context parallel on the card's one shard and on 4 shards of
   it) and profiles of two CLI calls.
13. evaluation of a test split as a user runs it: a synthetic corpus
   (``examples/make_synthetic_corpus.py``, 8 sessions of 60 s: 24 windows
   of 20 s) and a reference ``.pt`` of the seeded weights written here;
   ``train/evaluation.py`` ``evaluate()`` over every window at B=16
   (batches of 16 and 8) in float32 and bfloat16, the launch ledger read
   at each batch (K1 x 5, K2 x 1, attention x 14, nothing else), and its
   region counts; the card against the
   CPU on one batch of 4 (regions and targets identical, pooled
   predictions and losses within the vs-CPU bars, metrics equal apart from
   predictions within the bar of a threshold, ``tests/_torch_eval.py``);
   one ``python -m voiceactivityprojection_tpu_torch.evaluate`` process
   whose ``metrics.csv`` equals the in-process float32 call's; a profile
   of one call in each dtype.
14. training as a user runs it, bfloat16 at ``VapConfig()`` widths on a
   synthetic corpus (10 sessions of 170 s: 4 batches of 16 windows of 20 s
   an epoch, one validation batch): (a) ``python -m
   voiceactivityprojection_tpu_torch.train`` process for one epoch, then
   ``--resume_from ckpt_last`` to a second through the CLI's ``main`` here
   (epochs and steps continue; the checkpoint restored here equals the
   saved weights and optimizer bit for bit); (b) the launch ledger around one Trainer step
   (K1 x 5, K3, the training attention x 14) and one validation batch (K1 x
   5, K2, attention x 14); (c) two epochs of ``Trainer.fit`` in this
   process, its ms a step and host stages, its
   trajectory against the resumed CLI run's, the vocoder pitch shift's and
   the other augmentation branches' ms a batch, a profile of one epoch;
   (d) one float32 augmented step at each effect and each pitch step on the
   card against the CPU (B=1 x 2 s, dropout 0, the draws made on the CPU),
   within phase 5's bars; (e) ``pretrain_cpc --export_blob`` for a few steps
   at its defaults, then ``train --init_encoder_from`` the blob; (f) ``run
   --checkpoint`` and ``evaluate --checkpoint`` on the trained checkpoint
   against the model built in this process ((e) and (f) through the CLIs'
   ``main`` in this process).
15. streaming and serving as a spoken-dialogue system and a server run
   them, at ``VapConfig()`` widths in float32 with TF32 off (the batch
   server in bfloat16): (a) the GRU recurrence at the streamers' shapes
   (R=2 x T=1, 2, 10; R=128 and 512 x T=2, h0 nonzero) against its plain
   version, and two launches carrying h_last against one, every float32
   launch of (a)-(e) on the f32 cluster kernel by the launch ledger; (b)
   the exact
   streaming encoder over 5 s in 1-frame hops against the CPU port and
   the card's batch encoder; (c) ``StreamingVap`` for 1,020 hops, its
   launches a hop (the GRU recurrence once, attention x 14), ms a hop and
   its first 5 hops against the CPU port; (d) ``KVStreamingVap`` for
   1,020 hops on its CUDA-graph route (launches a hop, replays counted:
   the GRU recurrence once, the KV row x 7; the graph sets replayed a
   hop), ms a hop, its first 60 hops against the eager route bit for bit,
   the pre-fill frames against the card's ``probs``, and a profile of 25
   hops (every device launch a hop, the idle share, and K12's and K3's
   kernels a hop by name: 7 and 1, whatever the ledger adds at each
   replay); (e)
   ``BatchedKVStreamer`` at S = 1, 16, 64, 256 (ms a tick, stream-hops/s,
   peak memory, launches and graph replays a tick, the warm-up ticks
   against the eager route bit for bit) and a recycled stream against a
   fresh one; (f)
   ``VapServer._run_batch`` at B=16 x 20 s bfloat16 (the inference kernels'
   launches, ms a batch) and ``VapStreamServer._tick`` at S=64 (K3 once,
   the KV row x 7), then, where
   pyzmq imports (a line says whether), a socket round trip of 2 stream and
   4 batch clients on ports the OS picks; (g) one ``python -m
   voiceactivityprojection_tpu_torch.run_sds --wav`` process over 4 s in
   kv mode. Each kernel's entry in the kernels line gains
   ``launches_streaming``: its launches a hop, tick or batch on each path.
16. the prosody probe as analysis runs it, on a synthetic phrase corpus in
   the reference's schema (20 phrases at 22,050 Hz, padded to one length)
   written under ``voiceactivityprojection_tpu_torch/build/``, a line
   saying whether matplotlib imports (nothing is plotted): (a) K2 at R=2
   and R=20 x the corpus's frame count and the next one, K4 at B=1 and 10 x
   the phrase T, against their plain versions; (b)
   ``PhraseProbe.extract_stats`` in float32 and bfloat16 against the CPU
   port (2e-4, 2e-3 bf16 vs f32), its launches a batch (K1 x 5, K2, K4 x
   14) and ms a batch, the mono model with its VAD history likewise; (c)
   one ``python -m voiceactivityprojection_tpu_torch.evaluate_phrases``
   process on the card over the corpus's first 10 phrases with all seven
   permutations, its first two phrases against the CLI's ``main`` with
   ``--device cpu`` in this process (2e-4), its
   wall s by stage; (d) ``forward(attention=True)`` at B=1 x 20 s float32
   against the CPU port (weights and logits 2e-4), its launches (K1 x 5,
   K2, no attention kernel), ms and peak memory; (e) a Trainer in
   ``pitch_mode="psola"`` with the probe at validation: one step's
   launches, TD-PSOLA's host ms a B=4 x 20 s batch beside the vocoder's on
   the card, one epoch with finite ``val_p*`` scalars; (f) a
   ``utils/profiling.trace`` of one ``probs`` call in a process of its own
   naming K1, K2 and K4 and the ``profiling.span`` (one in this process,
   after phases 1-15, is recorded beside it: F5, the profiler loses records
   late in a long process), ``activation_stats`` against the CPU. Each
   kernel's entry gains ``launches_prosody_probe``.
17. data and tensor parallelism over processes as a trainer runs them:
   two processes share the card over gloo (``parallel.mesh.spawn_local``
   running ``chip_smoke.py --parallel-rank``; NCCL takes one rank a card).
   (a) data parallel, B=16 x 20 s split 8 + 8: two f32 and two bf16 frozen
   steps at dropout 0 and one unfrozen f32 step (K9's dW_hh all-reduced),
   each rank's weights and gradients against one process on the whole
   batch on the card (f32 at the card's step bars, bf16 at the bf16 step
   bars); a bf16 step at
   dropout 0.1 whose attention masks at every site equal the global
   batch's ``keep_mask`` rows; launches a step (K1 x 5, K3, training
   attention x 14; unfrozen K3, K9). (b) tensor parallel, 2 of the 4 heads
   a rank: the f32 and bf16 forward at B=8 against the unsharded forward
   (2e-4, 2e-3 on p_now / p_future; K1 x 5, K2, K4 x 14 a rank) and an f32
   frozen step against the unsharded step at the card's step bars. (c) one
   ``python -m voiceactivityprojection_tpu_torch.train`` process under
   ``torchrun --nproc_per_node 1`` (NCCL, world size 1) for one epoch. (d)
   ``python -m voiceactivityprojection_tpu_torch.tools.dryrun_multichip --n
   2 --device cuda``. Each line gives ms on the host clock and the card.
   Each kernel's entry gains ``launches_parallel``.
18. the tools beside the package (``voiceactivityprojection_tpu_torch/tools``
   and ``analyzes``), each through its function in this process: (a)
   ``soak_sds`` at live 20 ms pacing, kv mode for 1,050 hops, window mode
   for 75 and a ``BatchedKVStreamer`` of 64 dialogs for 75 ticks (float32:
   launches a hop, the KV row x 7 in kv mode; latency p50 / p90 / p99 /
   max, deadline misses, jitter; every p in [0,
   1]; the first 100 paced kv hops against an unpaced run, 1e-6); (b)
   ``soak_churn`` over real ZMQ where pyzmq imports: 16 slots, 8 s of churn
   (sessions of 3-10 s) in 40 ms hops at live pace, no session in error,
   one eligible session replayed solo under the 0.05 contamination bar;
   (c) ``profile_stages`` at B=64 x 20 s bfloat16; (d) ``profile_train_step`` at B=16 x 20 s
   bfloat16, ``--deep`` frozen and unfrozen and the unfrozen step under
   ``VAP_CONV_IMPL=fused_stack``, each stage's ms and launches; (e)
   ``model_params_grad`` on the card against the CPU (2e-4 of each leaf's
   largest magnitude) and ``label_frequency`` on a synthetic corpus, the
   card's counts equal to the CPU's; (f) ``multihost_rehearsal`` with one
   process and two sharing the card over gloo. Each kernel's entry gains
   ``launches_scripts_beside``.

A ``phase_times`` line gives each numbered phase's wall time. The
attention kernels, conv1-conv4 of the conv stack and the GRU forward
kernels (K2, K3: the thread-block-cluster kernel of ``gru_cluster.cuh``)
run in bfloat16 on the tensor cores (wgmma); in float32 every attention
kernel (K4/K5/K10, K6, K7/K8) and conv1-conv4 run on the tensor cores in
3xTF32, K2 and K3 at H=256 on their f32 cluster kernels
(``gru_cluster_f32.cuh``), the rest on the CUDA cores: their entries in
the kernels line add ``design``
(per dtype; for the GRU the tiling its rule picked) and ``f32_ms`` (the
float32 kernels at the same shapes). So does the GRU backward (K9: in bfloat16 the
coefficient and weight products on wgmma and the reverse recurrence on a
cluster, ``gru_bwd_cluster.cuh``; in float32 the same three phases in f32
FFMA, ``gru_bwd_cluster_f32.cuh``), and conv0 + conv1 (K11: in bfloat16
both convs on wgmma with W1 streamed by TMA into an mbarrier ring,
``conv01_wgmma.cuh``; in float32 conv0 in FFMA and conv1 in 3xTF32 on
wgmma, ``conv01_tf32x3.cuh``). The build line counts ``HGMMA`` in each
library's SASS.
The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device.
A full report goes to ``chiprun_out/chip_smoke_report.json``.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from voiceactivityprojection_tpu_torch.ops import _build

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_F32_FLOPS = 67e12    # H100 SXM float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core peak
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
CHUNK_S = 20.0
SR = 16_000
REPORT: dict = {}
# the running numbered phase, and each finished one's wall time
CLOCK = {"phase": None, "phase_t0": 0.0}
PHASE_SECONDS: dict = {}


def emit(phase: str, **fields) -> None:
    REPORT.setdefault(phase, []).append(fields)
    print(json.dumps({"phase": phase, **fields}), flush=True)


def start_phase(name) -> None:
    """Closes the running numbered phase into PHASE_SECONDS and starts ``name``
    (None closes the last)."""
    now = time.perf_counter()
    if CLOCK["phase"] is not None:
        PHASE_SECONDS[CLOCK["phase"]] = now - CLOCK["phase_t0"]
    CLOCK["phase"], CLOCK["phase_t0"] = name, now


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def sync() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Mean device time of fn() over reps, after warm-up (CUDA events)."""
    for _ in range(warmup):
        fn()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    check(a.shape == b.shape, f"shapes {tuple(a.shape)} vs {tuple(b.shape)}")
    check(bool(torch.isfinite(a).all()), "kernel output is finite")
    return float((a.float() - b.float()).abs().max())


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def hgmma_counts(build) -> dict:
    """``HGMMA`` instructions in each built library's SASS (cuobjdump), or
    "not measured" where the toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.isfile(tool):
        return "not measured"
    procs = {n: subprocess.Popen([tool, "-sass", str(build.library_path(n))], stdout=subprocess.PIPE,
                                 stderr=subprocess.DEVNULL, text=True) for n in build.SOURCES}  # all at once
    return {n: p.communicate(timeout=120)[0].count("HGMMA") for n, p in procs.items()}


def gru_design(tiling, f32_tiling) -> dict:
    """The GRU forward kernels' route at a timed shape: the bf16 and the
    float32 tilings the rule picked, and the rule itself by dtype
    (``ops/gru_cluster.py`` ``DESIGN``)."""
    from voiceactivityprojection_tpu_torch.ops.gru_cluster import DESIGN

    return {"bfloat16": f"cluster kernel: {tiling.tiles} clusters of {tiling.cluster} CTAs x {tiling.rows} rows, "
                        f"{tiling.waves} wave(s), {tiling.smem} B shared a CTA",
            "float32": f"f32 cluster kernel: {f32_tiling.tiles} clusters of {f32_tiling.cluster} CTAs x "
                       f"{f32_tiling.rows} rows, {f32_tiling.waves} wave(s), {f32_tiling.smem} B shared a CTA",
            "rule": DESIGN}


# the kernels a float32 launch of an op takes at the model's widths, by
# their names in the launch ledger (K11: the 3xTF32 kernel after one split
# of W1)
F32_ROUTE = {"gru_downsample": ("cluster float32",), "gru_recurrence": ("cluster float32",),
             "gru_backward": ("cluster float32",), "flash_train_forward": ("wgmma 3xtf32",),
             "conv01": ("wgmma 3xtf32", "split tf32")}


def check_f32_routes(what: str, before: dict, **want) -> dict:
    """The launches by kernel since ``before`` (``_build.launch_counts()``),
    emitted as an ``f32_routes`` line; each op named in ``want`` launched
    exactly that many times (None: at least once), every one on its float32
    route."""
    ran = _build.launches_since(before)
    emit("f32_routes", path=what, launches=ran)
    for name, n in want.items():
        expected = dict.fromkeys(ran[name], 0)
        first = F32_ROUTE[name][0]
        expected.update(dict.fromkeys(F32_ROUTE[name], max(ran[name][first], 1) if n is None else n))
        check(ran[name] == expected, f"{what}: {name} launches by kernel {ran[name]}, expected {expected}")
    return ran


def check_routes(what: str, before: dict, name: str, want: dict) -> None:
    """Op ``name``'s launches by kernel since ``before``
    (``_build.launch_counts()``), emitted as a ``routes`` line, are exactly
    ``want`` (zero elsewhere)."""
    ran = _build.launches_since(before)[name]
    expected = dict(dict.fromkeys(ran, 0), **want)
    emit("routes", path=what, kernel=name, launches=ran)
    check(ran == expected, f"{what}: {name} launches by kernel {ran}, expected {expected}")


# K9's route rule (ops/gru_cluster.py backward_tiling)
GRU_BACKWARD_RULE = ("H=256: the cluster design of the dtype (bf16: coefficients and dW_hh on wgmma; float32: "
                     "coefficients and dW_hh as f32 FFMA tiles), the recurrence on 8-CTA clusters, rows a cluster "
                     "by ops/gru_cluster.py backward_tiling; other H: the block kernel")


def gru_backward_design(tiling, splits, dtype) -> str:
    """K9's cluster design at a timed shape: the tiling its rule picked."""
    clusters = (f"the recurrence on {tiling.tiles} clusters of {tiling.cluster} CTAs x {tiling.rows} rows, "
                f"{tiling.waves} wave(s), {tiling.smem} B shared a CTA")
    if dtype == torch.bfloat16:
        return f"coefficients and dW_hh on wgmma, {clusters}; dW_hh in {splits} K slices summed in order"
    return (f"coefficients and dW_hh as f32 FFMA tiles of 64 x 192, {clusters} (thread i of a CTA holds W_hh[i, "
            f"the CTA's 96 gate columns]); dW_hh in {splits} slices summed in order")


def kernel_registers(build, name: str) -> dict:
    """Registers, spill bytes and shared bytes of each kernel of a library,
    from the ``-Xptxas -v`` log its build wrote ({mangled-name fragment:
    line})."""
    path = build.library_path(name).with_suffix(".log")
    if not path.exists():
        return "not measured"
    out, fn = {}, None
    for line in path.read_text().splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and ("registers" in line or "spill" in line):
            out.setdefault(fn[:90], []).append(line.split(":", 1)[-1].strip())
    return out


def profile(fn, what: str, **fields) -> dict:
    """One call of fn under torch.profiler: device busy time per kernel
    name and the device's idle share of the call's wall time. Returns the
    device operations counted (kernels, copies and fills), the kernel
    launches among them, the wall ms, the idle share and the device
    operations by name (``by_name``: name, first 80 characters -> count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    sync()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            entry = by_name.setdefault(e.name[:80], [0.0, 0])
            entry[0] += e.time_range.elapsed_us() / 1e3
            entry[1] += 1
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]
    ops = sum(c for _, c in by_name.values())
    copies = sum(c for k, (_, c) in by_name.items() if k.startswith(("Memcpy", "Memset")))
    emit("profile", what=what, **fields, wall_ms=wall_ms,
         device_busy_ms=busy_ms if busy_ms else "not measured",
         idle_share=1 - busy_ms / wall_ms if busy_ms else "not measured",
         device_ops=ops, kernel_launches=ops - copies,
         top_kernels=[{"name": k, "ms": ms, "count": c} for k, (ms, c) in top])
    return {"device_ops": ops, "kernel_launches": ops - copies, "wall_ms": wall_ms,
            "idle_share": 1 - busy_ms / wall_ms if busy_ms else "not measured",
            "by_name": {k: c for k, (_, c) in by_name.items()}}


# ------------------------------------------------------------------ kernels --
# Tolerances, kernel vs plain version on the same inputs (max abs error).
# float32: the same arithmetic summed in another order (measured on an
# H100: conv 5.5e-6, GRU+downsample 5.6e-6, attention 4.8e-7, GRU
# recurrence 2.2e-7, training attention forward 7.2e-7 and lse 9.5e-7;
# the training backward against its plain version 0 at T >= 77, where
# cuBLAS sums in the kernel's order, and 6.3e-7 at T=1).
F32_TOL = {"conv_stack": 1e-4, "gru_downsample": 5e-5, "flash_alibi": 5e-6,
           "gru_recurrence": 5e-6, "flash_train_forward": 5e-6, "lse": 5e-6,
           "flash_train_backward": 5e-5, "flash_alibi_offset": 5e-6, "conv01": 1e-4}
# float32, held relative to the output's largest magnitude (at least 1):
# the GRU backward's dW_hh / db_hh sum R*T terms in another order, and its
# carry runs through T steps; the conv stack's backward is the plain
# stack's autograd on either side, apart from the kernel's forward sums;
# the KV row (K12) sums a row's slots in another order than the einsums
F32_REL = {"gru_backward": 1e-5, "conv_stack_backward": 1e-4, "conv01_backward": 1e-4, "kv_attention": 2e-6,
           "linear": 2e-6}
# bfloat16: a sum that lands on the other side of a rounding boundary moves
# an output by one bf16 step (2^-7 of its magnitude's power of two). The
# tolerance is that many steps at the largest output magnitude: attention
# rounds p and the output (2); GRU+downsample the LayerNorm output before
# GELU and the output (2); the conv stack rounds every layer's output and,
# in the plain version, each conv sum before its ChannelNorm, and a step
# moves the next layer's statistics (4); the GRU recurrence rounds only
# its output, from an f32 carry (2); the training forward rounds p and the
# output (2); the backward rounds Y, dS and its outputs (3); the offset
# attention as attention (2); conv0 + conv1 as the conv stack (4). lse is f32
# in either mode and keeps the float32 bar.
BF16_STEPS = {"conv_stack": 4, "gru_downsample": 2, "flash_alibi": 2, "gru_recurrence": 2,
              "flash_train_forward": 2, "flash_train_backward": 3, "gru_backward": 2,
              "flash_alibi_offset": 2, "conv01": 4}
# the backward against autograd through the masked dense forward, float32:
# another algorithm (dP = dO V^T and the softmax gradient from lse and
# delta), held relative to the largest gradient; the GRU backward against
# autograd of the plain forward loop likewise
VS_AUTOGRAD_REL = 2e-5
# The attention kernels' bf16 instantiations run on the tensor cores (timed
# as ms); in float32 (timed as f32_ms) every attention kernel (K4/K5/K10,
# the training forward K6 and backward K7/K8) runs on the tensor cores in
# 3xTF32.
DESIGN = {"bfloat16": "wgmma",
          "float32": "wgmma 3xTF32 (q, k, v, p and the backward's operands split into tf32 hi and lo, three "
                     "m64n64k8 products a product; V, and the backward's dO, Q, K as B operands, written "
                     "transposed)"}
ATTN_F32_NOTE = ("f32_bound_ms: three TF32 products a product at 495 TFLOP/s; f32_ffma_bound_ms: the products "
                 "at 67 TFLOP/s (the CUDA cores); f32_library_ms: the same PyTorch call in float32, TF32 off; "
                 "registers: -Xptxas -v of the library's kernels")
# the conv stack in bfloat16: conv0 (Cin = 1, a 10-deep contraction) stays
# on the CUDA cores, conv1-conv4 run on the tensor cores
CONV_DESIGN = {"bfloat16": "wgmma (conv1-conv4), cuda cores (conv0)",
               "float32": "wgmma 3xTF32 (conv1-conv4), cuda cores (conv0)"}
# samples whose conv1 output count is one past a tile edge of the bf16
# conv0 + conv1 kernel (128 outputs a CTA): n1 = 257 = 2 * 128 + 1
CONV01_EDGE_N = 5139
# separate timings of a library yardstick whose runs swing (cuDNN's GRU)
YARDSTICK_CALLS = 5
# the float32 routes at H = 256: K1's conv1-conv4 on the 3xTF32
# wgmma kernel, K2 on the f32 cluster kernel. Their edges, beside R = 8 at
# T = 2000 and 1999 (the loop over dtypes): rows past a tiling's last tile
# at R = 1, 2, 3, 9, 17 and the inference batch's 128 (9 rows a cluster);
# T = 1, 2, the probe's odd 485, 33 and 3000; the conv stack at ragged
# lengths (161 samples: one conv4 frame; CONV01_EDGE_N: a conv1 output
# count one past a 128-position block)
F32_GRU_EDGES = ((1, 1), (2, 2), (3, 485), (9, 33), (17, 3000), (128, 485))
# K3 in float32 at H = 256 (the f32 cluster kernel, 2 to 32 rows a cluster):
# rows past a tile's last row, the frozen and CPC steps' R = 32, the batched
# streamers' R = 128 and 512; T = 1 and 2 (the streamers' hops), 33, an odd
# 1999 and the step's 2000; h0 zero and nonzero at the short T, and at the
# long ones h0 nonzero at 1999 and zero at 2000 (the step's)
F32_K3_ROWS = (1, 2, 3, 9, 17, 32, 128, 512)
F32_K3_STEPS = (1, 2, 33, 1999, 2000)
F32_K3_H0 = {1: (False, True), 2: (False, True), 33: (False, True), 1999: (False,), 2000: (True,)}
F32_CONV_EDGES = ((1, 161), (3, CONV01_EDGE_N), (2, 12_345))
CONV_DESIGN_F32 = "wgmma 3xTF32 (conv1-conv4: x and w split into tf32 hi and lo, three products), cuda cores (conv0)"


def yardstick(runs) -> dict:
    """The median of a yardstick's separate timings, with their spread."""
    return {"library_ms": float(np.median(runs)), "library_ms_min": min(runs), "library_ms_max": max(runs),
            "library_runs_ms": list(runs)}


def compare(name, got, want, shape, dtype, **fields) -> float:
    sync()
    err = max_err(got, want)
    top = max(float(want.float().abs().max()), 1.0)
    if name in F32_REL and dtype == torch.float32:
        tol = F32_REL[name] * top
    elif dtype == torch.float32 or name == "lse":
        tol = F32_TOL[name]
    else:
        tol = BF16_STEPS[name] * 2.0 ** (math.floor(math.log2(top)) - 7)
    emit("kernel_check", kernel=name, shape=shape, dtype=str(dtype), **fields, max_abs_err=err, tol=tol)
    check(err <= tol, f"{name} {dtype} {shape} {fields}: {err} > {tol}")
    return err


def conv_stack_case(port, layers, R, n, dtype, gen):
    k1 = port["k1"]
    x = (0.1 * torch.randn(R, n, generator=gen)).to("cuda", dtype)
    lw = [tuple(t.to(dtype) for t in l) for l in layers]
    return compare("conv_stack", k1.fused_conv_stack(lw, x), k1.reference_stack(lw, x), [R, n], dtype)


def f32_route_case(port, enc, layers, gen, since: dict, train_attention_cases: int) -> dict:
    """The float32 routes at their edges against the plain versions, and the
    kernel each launch took by the launch ledger: conv0 on the CUDA
    cores and conv1-conv4 on the 3xTF32 kernel, K2 and K3 on their f32
    cluster kernels with the tiling their rule picked (K3 at every R and T of
    its edges); and the training forward's launches in this phase since
    ``since`` (``_build.launch_counts()``), each dtype's ``train_attention_cases`` on
    its tensor-core kernel (3xTF32 in float32)."""
    k2, k3 = port["k2"], port["k3"]
    ft_ran = _build.launches_since(since)["flash_train_forward"]
    before = _build.launch_counts()
    for R, n in F32_CONV_EDGES:
        conv_stack_case(port, layers, R, n, torch.float32, gen)
    tilings = {}
    for R, T in F32_GRU_EDGES:
        gru_ds_case(port, enc, R, T, torch.float32, gen)
        t = k2.fused_tiling(R, 256, torch.float32)
        tilings[f"{R}x{T}"] = {"rows": t.rows, "clusters": t.tiles, "waves": t.waves}
    k3_tilings, k3_errs = {}, {}
    for R in F32_K3_ROWS:
        t = k3.forward_tiling(R, 256, torch.float32)
        k3_tilings[R] = {"rows": t.rows, "clusters": t.tiles, "waves": t.waves}
        for T in F32_K3_STEPS:
            for h0_zero in F32_K3_H0[T]:
                k3_errs[f"{R}x{T} h0 {'zero' if h0_zero else 'nonzero'}"] = gru_recurrence_case(
                    port, enc, R, T, torch.float32, gen, h0_zero)
            torch.cuda.empty_cache()
    ran = check_f32_routes("phase 3 edges", before, gru_downsample=len(F32_GRU_EDGES),
                           gru_recurrence=len(F32_K3_ROWS) * sum(map(len, F32_K3_H0.values())))
    emit("f32_edges", gru_tilings=tilings, k3_tilings=k3_tilings, k3_max_abs_err=k3_errs,
         tol=F32_TOL["gru_recurrence"], conv_edges=[list(e) for e in F32_CONV_EDGES],
         gru_edges=[list(e) for e in F32_GRU_EDGES], flash_train_forward_phase3=ft_ran)
    n_conv = len(F32_CONV_EDGES)
    check(ran["conv_stack"] == {"cuda cores": n_conv, "wgmma bfloat16": 0, "wgmma 3xtf32": 4 * n_conv,
                                "split tf32": 4 * n_conv},
          f"float32 conv stack: conv0 on the CUDA cores, conv1-conv4 on 3xTF32: {ran['conv_stack']}")
    check(ft_ran == {"wgmma bfloat16": train_attention_cases, "wgmma 3xtf32": train_attention_cases},
          f"the training forward in phase 3: each dtype on its tensor-core kernel: {ft_ran}")
    return ran


def gru_ds_case(port, enc, R, T, dtype, gen):
    k2 = port["k2"]
    H = enc.gAR.w_hh.shape[0]
    x_proj = (0.5 * torch.randn(R, T, 3 * H, generator=gen)).to("cuda", dtype)
    g, d = enc.gAR, enc.downsample
    args = [x_proj, g.w_hh, g.b_hh, torch.zeros(R, H, device="cuda"), d.conv.w, d.conv.b, d.ln.w, d.ln.b]
    args = [a.to(dtype).contiguous() for a in args]
    return compare("gru_downsample", k2.gru_downsample_fused(*args), k2.gru_downsample_reference(*args),
                   [R, T, 3 * H], dtype)


def gru_ds_block_case(port, gen) -> dict:
    """K2 at H = 128, where both dtypes take the block kernel
    ``gru_ds_kernel``, against the plain version (random weights), each
    call counted on the block kernel."""
    k2, H = port["k2"], 128
    before = _build.launch_counts()
    cases = [(R, T, dtype) for dtype in (torch.bfloat16, torch.float32) for R, T in ((3, 1), (3, 485), (8, 2000))]
    for R, T, dtype in cases:
        args = [0.5 * torch.randn(R, T, 3 * H, generator=gen), torch.randn(H, 3 * H, generator=gen) / 12,
                0.1 * torch.randn(3 * H, generator=gen), 0.1 * torch.randn(R, H, generator=gen),
                torch.randn(5, H, H, generator=gen) / 25, 0.1 * torch.randn(H, generator=gen),
                1 + 0.1 * torch.randn(H, generator=gen), 0.1 * torch.randn(H, generator=gen)]
        args = [a.to("cuda", dtype).contiguous() for a in args]
        compare("gru_downsample", k2.gru_downsample_fused(*args), k2.gru_downsample_reference(*args),
                [R, T, 3 * H], dtype, route="block")
    ran = _build.launches_since(before)["gru_downsample"]["block"]
    emit("block_route", kernel="gru_downsample", hidden=H, launches=ran, cases=[[R, T, str(d)] for R, T, d in cases])
    check(ran == len(cases), f"K2 at H = {H}: {ran} block-kernel launches for {len(cases)} calls")
    return ran


def attention_case(port, B, H, T, Dh, dtype, gen):
    k4 = port["k4"]
    q, k, v = ((torch.randn(B, H, T, Dh, generator=gen)).to("cuda", dtype) for _ in range(3))
    slopes = port["alibi_slopes"](H).to("cuda")
    scale = 1.0 / math.sqrt(H * Dh)
    compare("flash_alibi", k4.flash_alibi_attention(q, k, v, slopes, scale),
            k4.dense_reference(q, k, v, slopes, scale), [B, H, T, Dh], dtype)


def offset_attention_case(port, Tq, Tk, off, dtype, gen, Dh=64):
    """K10 for the Tq query rows at global offset ``off`` of Tk keys (B=1,
    256 / Dh heads; Dh=64 is the context-parallel shard shape) against its
    plain version."""
    k4 = port["k4"]
    H = 256 // Dh
    q = torch.randn(1, H, Tq, Dh, generator=gen).to("cuda", dtype)
    k, v = (torch.randn(1, H, Tk, Dh, generator=gen).to("cuda", dtype) for _ in range(2))
    slopes = port["alibi_slopes"](H).to("cuda")
    compare("flash_alibi_offset", k4.flash_alibi_attention_offset(q, k, v, slopes, 1 / 16, off),
            k4.dense_offset_reference(q, k, v, slopes, 1 / 16, off), [1, H, Tq, Dh], dtype, Tk=Tk, offset=off)


def conv01_case(port, layers, R, n, dtype, gen):
    k11 = port["k11"]
    x = (0.1 * torch.randn(R, n, generator=gen)).to("cuda", dtype)
    lw = [tuple(t.to(dtype) for t in l) for l in layers[:2]]
    compare("conv01", k11.fused_conv01(lw, x), k11.reference_unfused(lw, x), [R, n], dtype)


def conv01_backward_case(port, layers, R, n, gen):
    """K11's backward (autograd through the plain layers on the saved inputs,
    as JAX ``_vjp_bwd``) against autograd through ``reference_unfused``,
    float32. Returns the largest error."""
    k11 = port["k11"]
    lw = [tuple(t.detach().clone().requires_grad_() for t in l) for l in layers[:2]]
    x = (0.1 * torch.randn(R, n, generator=gen)).to("cuda").requires_grad_()
    leaves = [x, *(t for l in lw for t in l)]
    cot = torch.randn(R, k11.out_len(n), 256, generator=gen).to("cuda")
    got = torch.autograd.grad(k11.fused_conv01(lw, x), leaves, cot)
    want = torch.autograd.grad(k11.reference_unfused(lw, x), leaves, cot)
    names = ["x"] + [f"layer{i}.{p}" for i in range(2) for p in ("conv.w", "conv.b", "norm.w", "norm.b")]
    return max(compare("conv01_backward", g, w, [R, n], torch.float32, grad=nm)
               for nm, g, w in zip(names, got, want))


def attention_backward_case(port, B, H, T, Dh, gen):
    """The inference kernel's backward (a dense recompute under autograd)
    against autograd through ``dense_reference``, float32."""
    k4 = port["k4"]
    leaves = [torch.randn(B, H, T, Dh, generator=gen).to("cuda").requires_grad_() for _ in range(3)]
    cot = torch.randn(B, H, T, Dh, generator=gen).to("cuda")
    slopes = port["alibi_slopes"](H).to("cuda")
    scale = 1.0 / math.sqrt(H * Dh)
    got = torch.autograd.grad(k4.flash_alibi_attention(*leaves, slopes, scale), leaves, cot)
    want = torch.autograd.grad(k4.dense_reference(*leaves, slopes, scale), leaves, cot)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        compare("flash_alibi", g, w, [B, H, T, Dh], torch.float32, grad=name)


def gru_recurrence_case(port, enc, R, T, dtype, gen, h0_zero=False):
    k3 = port["k3"]
    H = enc.gAR.w_hh.shape[0]
    # drawn on the card (up to 3 GB at R = 512 x 2000) from a seed of gen
    card_gen = torch.Generator(device="cuda").manual_seed(int(torch.randint(0, 2**31 - 1, (), generator=gen)))
    x_proj = (0.5 * torch.randn(R, T, 3 * H, generator=card_gen, device="cuda")).to(dtype)
    h0 = ((0.0 if h0_zero else 0.1) * torch.randn(R, H, generator=card_gen, device="cuda")).to(dtype)
    args = [x_proj, enc.gAR.w_hh.to(dtype).contiguous(), enc.gAR.b_hh.to(dtype), h0]
    ys, h_last = k3.gru_recurrence(*args)
    want, _ = k3.gru_recurrence_reference(*args)
    check(torch.equal(h_last, ys[:, -1]), "gru_recurrence h_last is ys[:, -1]")
    return compare("gru_recurrence", ys, want, [R, T, 3 * H], dtype, **({"h0": "zero"} if h0_zero else {}))


def train_attention_case(port, B, H, T, Dh, rate, dtype, gen):
    """The training forward (out, lse) and backward (dq, dk, dv) against the
    plain versions; in float32 the backward also against autograd through
    the masked dense forward. Returns the largest bf16/f32 errors."""
    ft = port["ft"]
    q, k, v, do = ((torch.randn(B, H, T, Dh, generator=gen)).to("cuda", dtype) for _ in range(4))
    slopes = port["alibi_slopes"](H).to(dtype).to("cuda")
    seed = int(torch.randint(0, 2**31 - 1, (), generator=gen))
    scale = 1.0 / math.sqrt(H * Dh)
    shape = [B, H, T, Dh]
    out, lse = ft.flash_train_forward(q, k, v, slopes, seed, scale, rate)
    want, want_lse = ft.train_forward_reference(q, k, v, slopes, seed, scale, rate)
    e_fwd = compare("flash_train_forward", out, want, shape, dtype, rate=rate, output="out")
    compare("lse", lse, want_lse, shape, dtype, rate=rate)
    got = ft.flash_train_backward(q, k, v, slopes, seed, out, lse, do, scale, rate)
    delta = (do.float() * out.float()).sum(-1).reshape(B * H, T)
    plain = ft.train_backward_reference(q, k, v, do, lse, delta, slopes, seed, scale, rate)
    e_bwd = max(compare("flash_train_backward", g, w, shape, dtype, rate=rate, grad=n)
                for n, g, w in zip(("dq", "dk", "dv"), got, plain))
    del plain
    if dtype == torch.float32:
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ref, _ = ft.train_forward_reference(*leaves, slopes, seed, scale, rate)
        for n, g, w in zip(("dq", "dk", "dv"), got, torch.autograd.grad(ref, leaves, do)):
            err = max_err(g, w)
            tol = VS_AUTOGRAD_REL * max(float(w.abs().max()), 1.0)
            emit("kernel_check", kernel="flash_train_backward", vs="autograd of the masked dense forward",
                 shape=shape, dtype=str(dtype), rate=rate, grad=n, max_abs_err=err, tol=tol)
            check(err <= tol, f"flash_train_backward vs autograd {n} {shape} rate {rate}: {err} > {tol}")
    return e_fwd, e_bwd


def refuses_grad_case(port, enc, layers):
    """K2 and K10, which have no backward (nor have JAX's), raise on a
    grad-requiring CUDA input instead of returning a result cut from the
    autograd graph; K1, K3 and K11 record their backward."""
    k1, k2, k3, k4, k11 = port["k1"], port["k2"], port["k3"], port["k4"], port["k11"]
    lw = [tuple(t.detach().requires_grad_() for t in l) for l in layers]
    x = torch.zeros(2, 3200, device="cuda")
    g, d = enc.gAR, enc.downsample
    H = g.w_hh.shape[0]
    xp = torch.zeros(2, 8, 3 * H, device="cuda")
    w_hh = g.w_hh.detach().clone().requires_grad_()
    args = [xp, w_hh, g.b_hh, torch.zeros(2, H, device="cuda"), d.conv.w, d.conv.b, d.ln.w, d.ln.b]
    q = torch.zeros(1, 4, 64, 64, device="cuda", requires_grad=True)
    slopes = port["alibi_slopes"](4).to("cuda")
    raised = {}
    for name, call in (("gru_downsample", lambda: k2.gru_downsample_fused(*args)),
                       ("flash_alibi_offset", lambda: k4.flash_alibi_attention_offset(q, q, q, slopes, 0.1, 0))):
        try:
            call()
            raised[name] = None
        except RuntimeError as e:
            raised[name] = str(e)[:100]
    graphs = {"conv_stack": k1.fused_conv_stack(lw, x).grad_fn is not None,
              "gru_recurrence": k3.gru_recurrence(*args[:4])[0].grad_fn is not None,
              "conv01": k11.fused_conv01(lw, x).grad_fn is not None}
    emit("refuses_grad", raised=raised, records_backward=graphs)
    check(all(r is not None for r in raised.values()), f"a kernel without a backward ran: {raised}")
    check(all(graphs.values()), f"a kernel with a backward left the graph: {graphs}")


def conv_stack_backward_case(port, layers, R, n, gen):
    """K1's backward (autograd through the plain stack on the saved inputs,
    as JAX ``_vjp_bwd``) against autograd through ``reference_stack``,
    float32. Returns the largest error and both routes' forward+backward
    times."""
    k1 = port["k1"]
    lw = [tuple(t.detach().clone().requires_grad_() for t in l) for l in layers]
    x = (0.1 * torch.randn(R, n, generator=gen)).to("cuda").requires_grad_()
    leaves = [x, *(t for l in lw for t in l)]
    cot = torch.randn(R, n // 160, 256, generator=gen).to("cuda")
    got = torch.autograd.grad(k1.fused_conv_stack(lw, x), leaves, cot)
    want = torch.autograd.grad(k1.reference_stack(lw, x), leaves, cot)
    names = ["x"] + [f"layer{i}.{p}" for i in range(len(lw)) for p in ("conv.w", "conv.b", "norm.w", "norm.b")]
    err = max(compare("conv_stack_backward", g, w, [R, n], torch.float32, grad=nm)
              for nm, g, w in zip(names, got, want))
    del got, want
    ms = cuda_ms(lambda: torch.autograd.grad(k1.fused_conv_stack(lw, x), leaves, cot), reps=2, warmup=1)
    plain = cuda_ms(lambda: torch.autograd.grad(k1.reference_stack(lw, x), leaves, cot), reps=2, warmup=1)
    return err, ms, plain


def gru_backward_case(port, enc, R, T, dtype, gen):
    """K9 against its plain version on the same inputs (ys from K3); in
    float32 also K3 + K9 through ``gru_recurrence`` against autograd of the
    plain forward loop. Returns the largest error against the plain version."""
    k3 = port["k3"]
    H = enc.gAR.w_hh.shape[0]
    x_proj = (0.5 * torch.randn(R, T, 3 * H, generator=gen)).to("cuda", dtype)
    h0 = (0.1 * torch.randn(R, H, generator=gen)).to("cuda", dtype)
    dys = torch.randn(R, T, H, generator=gen).to("cuda", dtype)
    args = [x_proj, enc.gAR.w_hh.to(dtype).contiguous(), enc.gAR.b_hh.to(dtype), h0]
    ys, _ = k3.gru_recurrence(*args)
    got = k3.gru_backward(*args, ys, dys)
    want = k3.gru_backward_reference(*args, ys, dys)
    names = ("dx_proj", "dw_hh", "db_hh", "dh0")
    err = max(compare("gru_backward", g, w, [R, T, 3 * H], dtype, grad=nm)
              for nm, g, w in zip(names, got, want))
    if dtype == torch.float32:
        leaves = [a.clone().requires_grad_() for a in args]
        dh = torch.randn(R, H, generator=gen).to("cuda")
        ys_k, h_k = k3.gru_recurrence(*leaves)
        got = torch.autograd.grad((ys_k * dys).sum() + (h_k * dh).sum(), leaves)
        ys_p, h_p = k3.gru_recurrence_reference(*leaves)
        want = torch.autograd.grad((ys_p * dys).sum() + (h_p * dh).sum(), leaves)
        for nm, g, w in zip(names, got, want):
            e = max_err(g, w)
            tol = VS_AUTOGRAD_REL * max(float(w.abs().max()), 1.0)
            emit("kernel_check", kernel="gru_backward", vs="autograd of the plain forward",
                 shape=[R, T, 3 * H], dtype=str(dtype), grad=nm, max_abs_err=e, tol=tol)
            check(e <= tol, f"gru_backward vs autograd {nm} {[R, T]}: {e} > {tol}")
    return err


# the port on the card vs the same port on the CPU (float32, plain path):
# the JAX package's bars against the reference; bf16 on the card vs f32 on
# the CPU is held to the bf16 slice test's bound (tests/test_torch_model.py)
VS_CPU_TOL = {"logits": 1e-3, "p_now": 2e-4, "p_future": 2e-4, "H": 1e-3}
VS_CPU_BF16_TOL = 2e-3
# context parallelism on the card vs the single-device forward on the card,
# float32 (the JAX package's bar against its single-device forward)
CP_F32_TOL = 2e-4
LONG_S = 600.0  # seconds of stereo audio in one context-parallel call
CP_SHARDS = 4  # time shards of that call, all on the one card
# the mono model on the card vs the CPU, float32 (the JAX package's bar)
MONO_VS_CPU_TOL = 2e-4
# one dropout-free float32 train step on the card vs the CPU: losses, each
# gradient relative to its leaf's largest, updated weights where the
# gradient is clear of that bound and of 1e-6 (Adam's first step is about
# lr * sign(g), so an update flips with a gradient near 0); measured on an
# H100: 4.8e-7, 6.4e-6, and 6.0e-8 / 3.1e-7 in two runs before the 1e-6 floor
TRAIN_VS_CPU_TOL = {"loss": 1e-5, "grad_rel": 1e-4, "update": 5e-7}
FROZEN = ("encoder.gEncoder.", "encoder.gAR.")


def grads_vs_cpu(pairs, metrics_cpu, metrics_card, keys, tol=TRAIN_VS_CPU_TOL, step_grads=()):
    """Largest loss error, gradient error relative to each leaf's largest
    and updated-weight error where the gradient is clear of the ``tol``
    bound and of 1e-6, over (name, cpu param, card param) ``pairs``. After
    several steps, ``step_grads`` (the reference's gradients of each step,
    by name) narrows the update comparison to the elements whose gradient
    was clear at every step: Adam normalises a gradient near 0 into an
    update of its sign."""
    loss_err = max(abs(metrics_cpu[k] - metrics_card[k]) for k in keys)
    grad_rel, upd = 0.0, 0.0
    for name, cp, gp in pairs:
        scale = max(float(cp.grad.abs().max()), 1e-30)
        grad_rel = max(grad_rel, float((gp.grad.cpu() - cp.grad).abs().max()) / scale)
        clear = cp.grad.abs() > max(1e-6, 2 * tol["grad_rel"] * scale)
        for g in step_grads:
            clear &= g[name].abs() > max(1e-6, 2 * tol["grad_rel"] * max(float(g[name].abs().max()), 1e-30))
        if bool(clear.any()):
            upd = max(upd, float((gp.detach().cpu() - cp.detach())[clear].abs().max()))
    return {"loss": loss_err, "grad_rel": grad_rel, "update": upd}


@contextlib.contextmanager
def masks_drawn_on_cpu():
    """For the card-vs-CPU train step only: the elementwise dropout masks
    drawn on the CPU from the seed of the step's masks generator and moved
    to the activations' device. On the CPU these are the port's own masks;
    on the card they replace the device generator's, whose stream differs,
    so both steps drop the same elements. The attention masks are the
    kernels' coordinate hash on either device and stay as they are."""
    from voiceactivityprojection_tpu_torch.ops.dropout import DropoutRng

    on_device = DropoutRng.dropout

    def dropout(self, x, rate, tp=None):  # unsharded nets: no model shard
        if rate <= 0.0:
            return x
        if not hasattr(self, "cpu_masks"):
            self.cpu_masks = torch.Generator().manual_seed(self.masks.initial_seed())
        keep = (torch.rand(x.shape, generator=self.cpu_masks) >= rate).to(x.device)
        return torch.where(keep, x / (1.0 - rate), 0.0)

    DropoutRng.dropout = dropout
    try:
        yield
    finally:
        DropoutRng.dropout = on_device


# offline extraction: the run CLI on WAV files (seconds of audio) and a
# reference-format checkpoint of the seeded weights
OFFLINE_SHORT_S = 30.0  # single shot
OFFLINE_LONG_S = 200.0  # over the 160 s single-shot limit: chunked
OFFLINE_MONO_S = 10.0  # one channel at 22,050 Hz: resampled, a silent channel added
OFFLINE_MONO_SR = 22_050


def _write_wav(path: str, seconds: float, sr: int, channels: int, rng) -> None:
    from scipy.io import wavfile

    x = (0.1 * rng.standard_normal((int(seconds * sr), channels))).clip(-1, 1)
    wavfile.write(path, sr, (x * 32767).astype(np.int16))


def _save_reference(sd: dict, path: str, legacy: bool) -> None:
    """A reference state dict as a ``.pt``, or as an older Lightning
    ``.ckpt``: ``net.`` prefixes, the head under ``projection_head``, the
    codebook and hyperparameters beside the weights."""
    weights = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    if legacy:
        weights = {"net." + k.replace("vap_head", "vap_head.projection_head"): v for k, v in weights.items()}
        weights["net.VAP.codebook.emb.weight"] = torch.zeros(256, 8)
        weights = {"state_dict": weights, "hyper_parameters": {"conf": {}}, "epoch": 0}
    torch.save(weights, path)


def offline_extraction(state, smi, per_forward, per_cp_call, reset_counts, read_counts) -> dict:
    """Phase 12: ``python -m voiceactivityprojection_tpu_torch.run`` as a
    user runs it on the card ((a) in a process of its own, the other modes
    through its ``main`` in this process), on WAV files and reference
    checkpoints written from the seeded weights, checked (a)-(f); then the
    same extraction in this process with the launch ledger read around
    each mode, and profiles. Returns the launches by mode."""
    import tempfile

    from voiceactivityprojection_tpu_torch import run as run_cli
    from voiceactivityprojection_tpu_torch.config import VapConfig
    from voiceactivityprojection_tpu_torch.models.checkpoint import export_vap_state_dict
    from voiceactivityprojection_tpu_torch.models.vap import VapModel
    from voiceactivityprojection_tpu_torch.ops.audio import load_waveform
    from voiceactivityprojection_tpu_torch.parallel.mesh import make_mesh

    root = os.path.dirname(os.path.abspath(__file__))
    build = os.path.join(root, "voiceactivityprojection_tpu_torch", "build")
    os.makedirs(build, exist_ok=True)
    rng = np.random.default_rng(12)
    conf = VapConfig()
    hz, sr = conf.frame_hz, conf.sample_rate
    launches: dict = {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        f = lambda name: os.path.join(tmp, name)
        sd = export_vap_state_dict(state)
        _save_reference(sd, f("w.pt"), legacy=False)
        _save_reference(sd, f("w.ckpt"), legacy=True)
        _write_wav(f("short.wav"), OFFLINE_SHORT_S, sr, 2, rng)
        _write_wav(f("long.wav"), OFFLINE_LONG_S, sr, 2, rng)
        _write_wav(f("mono.wav"), OFFLINE_MONO_S, OFFLINE_MONO_SR, 1, rng)

        cli_s, cli_timings = {}, {}

        def cli(mode, wav, *extra, weights="w.pt", process=False):
            """One run of the CLI, in a process of its own or through its
            ``main`` in this process (the same entry point without the
            interpreter's start); its JSON outputs and stdout lines."""
            out = f(f"{mode}.json")
            argv = ["-a", f(wav), "-sd", f(weights), "-o", out, *extra]
            t0 = time.perf_counter()
            if process:
                r = subprocess.run([sys.executable, "-m", "voiceactivityprojection_tpu_torch.run", *argv],
                                   cwd=root, capture_output=True, text=True, timeout=600)
                check(r.returncode == 0, f"run CLI {mode}: exit {r.returncode}\n{r.stderr[-3000:]}")
                stdout = r.stdout
            else:
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    run_cli.main(argv)
                stdout = buf.getvalue()
            cli_s[mode] = time.perf_counter() - t0
            lines = stdout.strip().splitlines()
            cli_timings[mode] = json.loads(lines[-1])["timings"]
            with open(out) as fh:
                data = {k: np.asarray(v, dtype=np.float32) for k, v in json.load(fh).items()}
            return data, lines

        # (a) 30 s single shot, float32, card against the CPU
        n_short = int(OFFLINE_SHORT_S * sr)
        a, _ = cli("short_f32", "short.wav", process=True)
        a_cpu, _ = cli("short_f32_cpu", "short.wav", "--device", "cpu")
        check(a["p_now"].shape == (1, n_short // 320, 2), f"(a) frames {a['p_now'].shape}")
        err_a = {k: float(np.abs(a[k] - a_cpu[k]).max()) for k in ("p_now", "p_future", "H")}
        emit("offline_vs_cpu", check="a", mode="single shot", dtype="float32", audio_s=OFFLINE_SHORT_S,
             max_abs_err=err_a, tol=VS_CPU_TOL)
        for k, e in err_a.items():
            check(e <= VS_CPU_TOL[k], f"(a) CLI card vs CPU {k}: {e}")
        # (b) the same file in bfloat16 against the CPU's float32
        b, _ = cli("short_bf16", "short.wav", "--vap_dtype", "bfloat16")
        err_b = {k: float(np.abs(b[k] - a_cpu[k]).max()) for k in ("p_now", "p_future")}
        emit("offline_vs_cpu", check="b", mode="single shot", dtype="bfloat16", audio_s=OFFLINE_SHORT_S,
             max_abs_err=err_b, tol=VS_CPU_BF16_TOL)
        for k, e in err_b.items():
            check(e <= VS_CPU_BF16_TOL, f"(b) CLI bf16 card vs CPU float32 {k}: {e}")
        # (e) the legacy .ckpt gives the .pt's JSON
        e_out, _ = cli("short_f32_ckpt", "short.wav", weights="w.ckpt")
        same = set(e_out) == set(a) and all(np.array_equal(e_out[k], a[k]) for k in a)
        emit("offline_checkpoint", check="e", identical_json=same, keys=sorted(a))
        check(same, "(e) the .ckpt and the .pt give identical JSON")

        # (c) 200 s: chunked; its first window against one direct forward
        long_wave = load_waveform(f("long.wav"), sample_rate=sr)[0][None]
        n_long = long_wave.shape[-1]
        c, c_lines = cli("long_f32_chunked", "long.wav")
        check(any(l.startswith("Chunked extraction") for l in c_lines), "(c) the 200 s file ran chunked")
        check(c["p_now"].shape == (1, int(OFFLINE_LONG_S * hz), 2), f"(c) frames {c['p_now'].shape}")
        m32 = VapModel(conf, state, device="cuda")
        first = m32.probs(long_wave[..., : int(25 * sr)])
        w_frames = first["p_now"].shape[1]
        err_c = {k: float(np.abs(c[k][:, :w_frames] - first[k].cpu().numpy()).max()) for k in ("p_now", "p_future")}
        emit("offline_chunked", check="c", audio_s=OFFLINE_LONG_S, frames=c["p_now"].shape[1],
             first_window_frames=w_frames, max_abs_err_vs_direct=err_c, tol=CP_F32_TOL)
        for k, e in err_c.items():
            check(e <= CP_F32_TOL, f"(c) first window vs direct probs {k}: {e}")
        # (d) --context_parallel against one direct forward of the whole file
        d, d_lines = cli("long_f32_context_parallel", "long.wav", "--context_parallel")
        whole = m32.probs(long_wave)
        check(d["p_now"].shape == tuple(whole["p_now"].shape), f"(d) frames {d['p_now'].shape}")
        err_d = {k: float(np.abs(d[k] - whole[k].cpu().numpy()).max()) for k in ("p_now", "p_future")}
        emit("offline_context_parallel", check="d", audio_s=OFFLINE_LONG_S, shards=torch.cuda.device_count(),
             line=[l for l in d_lines if l.startswith("Context-parallel")], max_abs_err_vs_direct=err_d,
             tol=CP_F32_TOL)
        for k, e in err_d.items():
            check(e <= CP_F32_TOL, f"(d) context parallel vs direct probs {k}: {e}")
        direct = {k: whole[k].cpu().numpy() for k in ("p_now", "p_future")}
        # (f) 22,050 Hz mono: resampled, a silent channel added; which
        # decoder and resampler ran
        mono, mono_lines = cli("mono_22050", "mono.wav")
        check(mono["p_now"].shape == (1, int(OFFLINE_MONO_S * sr) // 320, 2), f"(f) frames {mono['p_now'].shape}")
        backends = [l for l in mono_lines if l.startswith("Audio decoder")]
        print(backends[0], flush=True)
        emit("offline_mono", check="f", audio_s=OFFLINE_MONO_S, sample_rate=OFFLINE_MONO_SR, backends=backends[0],
             finite=bool(np.isfinite(mono["p_now"]).all()))
        check(bool(np.isfinite(mono["p_now"]).all()), "(f) finite outputs")
        emit("offline_cli", card=smi, wall_s_by_mode=cli_s, cli_timings_by_mode=cli_timings,
             note="short_f32 one process (import, weights, decode, extraction, JSON); the other modes "
                  "through run's main in this process")
        del whole, first, a, a_cpu, b, c, d, e_out, mono

        # the same extraction in this process, launches read around each mode
        short_wave = load_waveform(f("short.wav"), sample_rate=sr)[0][None]
        chunk, step = int(25 * sr), int(5 * sr)  # the CLI's windows
        starts = range(0, n_long - chunk + 1, step)
        windows = len(starts) + (starts[-1] + chunk < n_long)
        n_calls = -(-windows // 8)  # 8 windows to a model call
        # float32 (m32): K13's GEMMs besides
        f32_forward = f32_gemms(per_forward, linear_per_forward(conf))
        modes = (
            ("single_shot", short_wave, {}, f32_forward),
            ("chunked", long_wave, {"chunk": True}, {k: v * n_calls for k, v in f32_forward.items()}),
            ("context_parallel_1_card", long_wave, {"mesh": make_mesh()}, f32_forward),
            ("context_parallel_4_shards", long_wave,
             {"mesh": make_mesh(n_data=CP_SHARDS, devices=[torch.device("cuda")] * CP_SHARDS)},
             f32_gemms(per_cp_call, linear_per_cp_call(conf, CP_SHARDS))),
        )
        for mode, wave, kw, want in modes:
            reset_counts()
            out, _ = run_cli.extract_waveform(m32, wave, **kw)
            sync()
            launches[mode] = read_counts()
            check(launches[mode] == want, f"offline {mode}: launches {launches[mode]}, expected {want}")
            if mode == "context_parallel_4_shards":
                err = {k: float(np.abs(out[k] - direct[k]).max()) for k in direct}
                emit("offline_context_parallel", check="4 shards on one card", audio_s=OFFLINE_LONG_S,
                     shards=CP_SHARDS, max_abs_err_vs_direct=err, tol=CP_F32_TOL, launches=launches[mode])
                for k, e in err.items():
                    check(e <= CP_F32_TOL, f"offline {CP_SHARDS}-shard context parallel vs direct {k}: {e}")
        emit("offline_launches", launches_by_mode=launches, windows=windows, calls_of_8_windows=n_calls)

        # where one CLI call's time goes: device busy against the wall time
        profile(lambda: run_cli.main(["-a", f("long.wav"), "-sd", f("w.pt"), "-o", f("p.json"),
                                      "--vap_dtype", "bfloat16"]),
                "run CLI in process, 200 s chunked", dtype="bfloat16")
        profile(lambda: run_cli.main(["-a", f("short.wav"), "-sd", f("w.pt"), "-o", f("p.json")]),
                "run CLI in process, 30 s single shot", dtype="float32")
        del m32
    torch.cuda.empty_cache()
    return launches


# evaluation: the test split of a synthetic corpus (examples/
# make_synthetic_corpus.py) in 20 s windows with 2 s of VAD horizon
EVAL_SESSIONS = 8
EVAL_SESSION_S = 60.0
EVAL_BATCH = 16  # the DataConfig default: 24 windows are batches of 16 and 8
EVAL_VS_CPU_BATCH = 4  # the card against the CPU: one batch of 4 windows


def evaluation(state, smi, reset_counts, read_counts) -> dict:
    """Phase 13: ``evaluate()`` over every window of a synthetic corpus on
    the card, float32 and bfloat16, with the launch ledger read at each
    batch; the card against the CPU on one batch (regions and targets
    identical, pooled predictions and losses within the vs-CPU bars,
    metrics equal apart from predictions within the bar of a threshold);
    one ``python -m voiceactivityprojection_tpu_torch.evaluate`` process
    against the in-process float32 call; a profile. Returns the launches
    of each batch by dtype."""
    import tempfile

    from voiceactivityprojection_tpu_torch.config import EventConfig, VapConfig
    from voiceactivityprojection_tpu_torch.data.dataset import SlidingWindowDataset, VapDataLoader, write_manifest
    from voiceactivityprojection_tpu_torch.models.checkpoint import export_vap_state_dict
    from voiceactivityprojection_tpu_torch.models.vap import VapModel
    from voiceactivityprojection_tpu_torch.train import evaluation as teval

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "tests"))
    from _torch_eval import compare_evaluations, pooled, recording

    build = os.path.join(root, "voiceactivityprojection_tpu_torch", "build")
    os.makedirs(build, exist_ok=True)
    per_batch_want = dict(dict.fromkeys(read_counts(), 0), conv_stack=5, gru_downsample=1, flash_alibi=14)
    launches: dict = {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        f = lambda *name: os.path.join(tmp, *name)
        subprocess.run([sys.executable, os.path.join(root, "examples", "make_synthetic_corpus.py"), "--out",
                        f("corpus"), "--n", str(EVAL_SESSIONS), "--duration", str(EVAL_SESSION_S)],
                       check=True, capture_output=True, timeout=300)
        write_manifest([{"audio_path": f("corpus", f"s{i:03d}.wav"), "vad_path": f("corpus", f"s{i:03d}_vad.json")}
                        for i in range(EVAL_SESSIONS)], f("test.csv"))
        _save_reference(export_vap_state_dict(state), f("w.pt"), legacy=False)

        def loader(batch):
            return VapDataLoader(SlidingWindowDataset(f("test.csv")), batch_size=batch, shuffle=False,
                                 drop_last=False)

        windows = len(SlidingWindowDataset(f("test.csv")))
        check(windows == EVAL_SESSIONS * int(EVAL_SESSION_S // 20), f"evaluation windows: {windows}")
        results = {}
        for dtype in ("float32", "bfloat16"):
            model = VapModel(VapConfig(dtype=dtype), state, device="cuda")
            per_batch = []

            class Counting(teval.EvaluationCollector):
                def update(self, *a, **kw):  # the batch's forward has launched its kernels
                    per_batch.append(read_counts())
                    reset_counts()
                    super().update(*a, **kw)

            base, teval.EvaluationCollector = teval.EvaluationCollector, Counting
            try:
                reset_counts()
                with recording(teval) as seen:
                    teval.evaluate(model, loader(EVAL_BATCH), EventConfig(), out_dir=f(f"warm_{dtype}"))
            finally:
                teval.EvaluationCollector = base
            launches[dtype] = per_batch
            want = f32_gemms(per_batch_want, linear_per_forward(VapConfig()), dtype)
            check(len(per_batch) == 2 and all(c == want for c in per_batch),
                  f"evaluation {dtype}: launches per batch {per_batch}, expected {want}")
            regions = {k: sum(len(r) for ev in seen[0].events for r in ev[k]) for k in seen[0].events[0]}
            # the same evaluation again, outside the counting collector
            results[dtype] = teval.evaluate(model, loader(EVAL_BATCH), EventConfig(), out_dir=f(f"in_{dtype}"))
            check(all(math.isfinite(v) for k, v in results[dtype].items() if k.startswith("test_loss")),
                  f"evaluation {dtype}: finite losses")
            emit("evaluation", dtype=dtype, windows=windows, batch=EVAL_BATCH, launches_per_batch=per_batch,
                 regions=regions, result=results[dtype], card=smi)
            del model

        # the card against the CPU on one batch of 4 windows
        runs = {}
        for name, device, dtype in (("cpu", "cpu", "float32"), ("float32", "cuda", "float32"),
                                    ("bfloat16", "cuda", "bfloat16")):
            model = VapModel(VapConfig(dtype=dtype), state, device=device)
            with recording(teval) as seen:
                res = teval.evaluate(model, loader(EVAL_VS_CPU_BATCH), EventConfig(), out_dir=f(f"vs_{name}"),
                                     limit_batches=1)
            runs[name] = (res, seen[0])
            del model
        cpu_res, cpu_coll = runs["cpu"]
        for dtype, bar in (("float32", VS_CPU_TOL["p_now"]), ("bfloat16", VS_CPU_BF16_TOL)):
            res, coll = runs[dtype]
            check(coll.events == cpu_coll.events and coll.debts == cpu_coll.debts,
                  f"evaluation {dtype}: regions identical to the CPU's")
            report = compare_evaluations(res, cpu_res, pooled(coll), pooled(cpu_coll), bar, bar)
            emit("evaluation_vs_cpu", dtype=dtype, batch=EVAL_VS_CPU_BATCH, bar=bar, **report,
                 regions_identical=True)
            check(not report["mismatches"], f"evaluation {dtype} card vs CPU: {report['mismatches']}")

        # one CLI process on the card (float32, B=16): its metrics.csv equals
        # the in-process float32 call's row
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "voiceactivityprojection_tpu_torch.evaluate", "--data_test_path",
                            f("test.csv"), "--state_dict", f("w.pt"), "--out_dir", f("cli")],
                           cwd=root, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        check(r.returncode == 0, f"evaluate CLI: exit {r.returncode}\n{r.stderr[-3000:]}")
        cli_line = json.loads(r.stdout.strip().splitlines()[-1])
        with open(f("cli", "metrics.csv")) as fh:
            header, values = fh.read().splitlines()
        cli_row = dict(zip(header.split(","), map(float, values.split(","))))
        same = cli_row == results["float32"]
        emit("evaluation_cli", wall_s=cli_s, timings=cli_line["timings"], device=cli_line["device"],
             equals_in_process_float32=same, card=smi)
        check(same, f"evaluate CLI metrics.csv {cli_row} vs in process {results['float32']}")

        # where one in-process evaluation's time goes
        for dtype in ("float32", "bfloat16"):
            model = VapModel(VapConfig(dtype=dtype), state, device="cuda")
            profile(lambda: teval.evaluate(model, loader(EVAL_BATCH), EventConfig(), out_dir=f("profile")),
                    "evaluate in process", dtype=dtype, windows=windows, batch=EVAL_BATCH)
            del model
    torch.cuda.empty_cache()
    return launches


# training as a user runs it: a synthetic corpus (examples/
# make_synthetic_corpus.py, its 80/20 split) in 20 s windows at the
# DataConfig default batch of 16
TRAIN_SESSIONS = 10  # 8 train sessions, 2 validation sessions
TRAIN_SESSION_S = 170.0  # 8 windows each: 4 full batches an epoch, 1 validation batch of 16
TB_TRAIN = 16  # the DataConfig default batch
TRAIN_RUN = "VapGPT_50Hz_ad20s_134"  # the run name of VapConfig() on 20 s windows
CPC_CLI_STEPS = 4  # pretrain_cpc steps at its defaults (B=32 x 20480 samples, float32)
EXCERPT_S = 30.0  # the run CLI's input: the first 30 s of a validation session
AUG_PITCH_STEPS = (0, 1, 2, -1, -2)  # the Trainer's vocoder branches


@contextlib.contextmanager
def augment_draws_on_cpu():
    """For the card-vs-CPU augmented step only: the augmentation's noise
    drawn on the CPU (from the same seed) and moved to the batch's device,
    so that both steps add the same noise. The flip and mask bits and the
    band come from the step's CPU generator on either device."""
    from voiceactivityprojection_tpu_torch.train import augment as taug

    on_device = taug.draw_augment

    def draw(*a, **kw):
        return on_device(*a, **dict(kw, noise_device=torch.device("cpu")))

    taug.draw_augment = draw
    try:
        yield
    finally:
        taug.draw_augment = on_device


def training_run(state, smi, reset_counts, read_counts, per_train_step, per_forward, small) -> dict:
    """Phase 14: training as a user runs it, bfloat16 at ``VapConfig()``
    widths on a synthetic corpus. (a) ``python -m
    voiceactivityprojection_tpu_torch.train`` process for one epoch, then
    ``--resume_from ckpt_last`` to a second through its ``main``: epochs and steps
    continue, the restored weights and optimizer state equal the saved ones
    bit for bit. (b) The launch ledger around one Trainer step and one
    validation batch. (c) The Trainer's ms a step and host stages over two
    epochs in this process, its trajectory
    against the resumed CLI run's, the vocoder and frequency-mask branches'
    ms a batch, a profile of one epoch. (d) One float32 augmented step at
    each effect and each pitch step on the card against the CPU, the draws
    made on the CPU. (e) ``pretrain_cpc --export_blob``, then ``train
    --init_encoder_from`` the blob. (f) ``run --checkpoint`` and ``evaluate
    --checkpoint`` on the trained checkpoint against the model built in this
    process. Returns the launches of (b)."""
    import tempfile

    from scipy.io import wavfile

    from voiceactivityprojection_tpu_torch import run as run_cli
    from voiceactivityprojection_tpu_torch.config import DataConfig, EventConfig, OptConfig, VapConfig
    from voiceactivityprojection_tpu_torch.data.dataset import SlidingWindowDataset, VapDataLoader
    from voiceactivityprojection_tpu_torch.models.checkpoint import load_cpc_blob, restore_checkpoint
    from voiceactivityprojection_tpu_torch.models.vap import VapModel, VapNet
    from voiceactivityprojection_tpu_torch.ops.audio import load_waveform
    from voiceactivityprojection_tpu_torch.ops.pitchshift import pitch_shift_semitones
    from voiceactivityprojection_tpu_torch.train import augment as taug
    from voiceactivityprojection_tpu_torch.train import evaluation as teval
    from voiceactivityprojection_tpu_torch.train import loop as tloop
    from voiceactivityprojection_tpu_torch.train import step as tstep
    from voiceactivityprojection_tpu_torch.utils.io import tensor_dict_to_json

    root = os.path.dirname(os.path.abspath(__file__))
    build = os.path.join(root, "voiceactivityprojection_tpu_torch", "build")
    os.makedirs(build, exist_ok=True)
    launches: dict = {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        f = lambda *name: os.path.join(tmp, *name)
        t0 = time.perf_counter()
        subprocess.run([sys.executable, os.path.join(root, "examples", "make_synthetic_corpus.py"), "--out",
                        f("corpus"), "--n", str(TRAIN_SESSIONS), "--duration", str(TRAIN_SESSION_S)],
                       check=True, capture_output=True, timeout=300)
        train_csv, val_csv = f("corpus", "train.csv"), f("corpus", "val.csv")
        setup_s = time.perf_counter() - t0
        n_train, n_val = len(SlidingWindowDataset(train_csv)), len(SlidingWindowDataset(val_csv))
        steps = n_train // TB_TRAIN
        check(steps >= 3 and n_val >= 1, f"training corpus: {n_train} train, {n_val} validation windows")
        data = DataConfig(train_path=train_csv, val_path=val_csv, phrases_probe=0)
        conf16 = VapConfig(dtype="bfloat16")
        data_flags = ["--data_train_path", train_csv, "--data_val_path", val_csv, "--data_phrases_probe", "0"]
        proc_s: dict = {}

        def cli(name, module, *args, process=False):
            """One CLI run on the card, in a process of its own or through
            the module's ``main`` in this process; its stdout."""
            t0 = time.perf_counter()
            if process:
                r = subprocess.run([sys.executable, "-m", f"voiceactivityprojection_tpu_torch.{module}", *args],
                                   cwd=root, capture_output=True, text=True, timeout=900)
                check(r.returncode == 0, f"{name}: exit {r.returncode}\n{r.stderr[-3000:]}")
                out = r.stdout
            else:
                mod = importlib.import_module(f"voiceactivityprojection_tpu_torch.{module}"
                                              + (".__main__" if module == "train" else ""))
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = mod.main(list(args))
                check(rc in (None, 0), f"{name}: main returned {rc}")
                out = buf.getvalue()
            proc_s[name] = time.perf_counter() - t0
            return out

        def rows(run_dir):
            with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
                return [json.loads(line) for line in fh]

        def sidecar(run_dir, tag):
            with open(os.path.join(run_dir, f"ckpt_{tag}.json")) as fh:
                return json.load(fh)

        # (a) one epoch in a process, a resume to the second -------------------
        cli("train_1_epoch", "train", "--max_epochs", "1", "--out_dir", f("runs"), "--vap_dtype", "bfloat16",
            *data_flags, process=True)
        run = f("runs", TRAIN_RUN)
        first = rows(run)
        meta = sidecar(run, "last")
        check([r["epoch"] for r in first] == [0] and all(r["steps"] == steps for r in first),
              f"(a) one epoch of {steps} steps: {[(r['epoch'], r['steps']) for r in first]}")
        check(meta["step"] == steps and meta["trainer"]["next_epoch"] == 1, f"(a) sidecar {meta['step']}")
        check(all(math.isfinite(r["loss"]) and math.isfinite(r["val_loss"]) for r in first), "(a) finite losses")
        # the restore in this process: weights and optimizer equal the file's
        saved = torch.load(os.path.join(run, "ckpt_last", "state.pt"), map_location="cpu", weights_only=True)
        trainer = tloop.Trainer(model_conf=conf16, data_conf=data, max_epochs=2, out_dir=f("restore"), device="cuda")
        net = trainer.init_net()
        restored, next_epoch, _ = trainer._restore_full(tstep.TrainState(net, trainer._optimizer(net)),
                                                        os.path.abspath(os.path.join(run, "ckpt_last")), meta, None)
        same_params = all(torch.equal(v.cpu(), saved["params"][k]) for k, v in restored.net.state_dict().items())
        opt_now = restored.opt.state_dict()
        same_opt = opt_now["param_groups"] == saved["opt_state"]["param_groups"] and all(
            torch.equal(v.cpu(), saved["opt_state"]["state"][i][k])
            for i, st in opt_now["state"].items() for k, v in st.items())
        check(same_params and same_opt and restored.step == steps and next_epoch == 1,
              f"(a) restored bit for bit: params {same_params}, optimizer {same_opt}")
        del trainer, net, restored
        cli("train_resume", "train", "--max_epochs", "2", "--out_dir", f("resumed"), "--resume_from",
            os.path.join(run, "ckpt_last"), "--vap_dtype", "bfloat16", *data_flags)
        resumed = rows(f("resumed", TRAIN_RUN))
        check([r["epoch"] for r in resumed] == [1] and sidecar(f("resumed", TRAIN_RUN), "last")["step"] == 2 * steps,
              f"(a) the resume continues: epochs {[r['epoch'] for r in resumed]}")
        emit("training_cli", check="a", epochs=first + resumed, steps_per_epoch=steps, train_windows=n_train,
             val_windows=n_val, restored_params_equal=same_params, restored_optimizer_equal=same_opt,
             process_s=dict(proc_s), card=smi)

        # (b) launches around one Trainer step and one validation batch -------
        trainer = tloop.Trainer(model_conf=conf16, data_conf=data, max_epochs=1, out_dir=f("counts"), device="cuda")
        train_loader, val_loader = trainer.make_loaders()
        net = trainer.init_net()
        st = tstep.TrainState(net, trainer._optimizer(net))
        batch = next(iter(train_loader))
        reset_counts()
        prepared, choice = trainer._prepare(batch)
        st, m = trainer.train_step(st, prepared, trainer.seed + 1, choice)
        sync()
        launches["train_step"] = read_counts()
        check(math.isfinite(float(m["loss"])), "(b) Trainer step loss finite")
        trainer.limit_batches = 1
        reset_counts()
        val = trainer.validate(st.net, val_loader)
        sync()
        launches["validation_batch"] = read_counts()
        emit("training_launches", check="b", choice=choice, launches=launches, val_loss=val["val_loss"])
        check(launches["train_step"] == per_train_step,
              f"(b) Trainer step launches {launches['train_step']}, expected {per_train_step}")
        check(launches["validation_batch"] == per_forward,
              f"(b) validation batch launches {launches['validation_batch']}, expected {per_forward}")
        del trainer, net, st, prepared
        torch.cuda.empty_cache()

        # (c) the Trainer's step in this process, two epochs -------------------
        trainer = tloop.Trainer(model_conf=conf16, data_conf=data, max_epochs=2, out_dir=f("straight"),
                                device="cuda")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer.fit()
        sync()
        fit_s = time.perf_counter() - t0
        straight = rows(f("straight", TRAIN_RUN))
        warm = straight[1:]  # the first epoch pays the first calls (allocator, cuFFT plans)
        step_ms = [1e3 * r["train_s"] / r["steps"] for r in warm]
        stages = {k: [1e3 * r[k] / r["steps"] for r in warm] for k in ("data_wait_s", "prep_s", "dispatch_s")}
        # the resumed CLI run against this straight one: equal on a card whose
        # kernels sum in a fixed order
        traj = [(a["loss"], a["val_loss"], b["loss"], b["val_loss"]) for a, b in zip(first + resumed, straight)]
        diff = max(max(abs(a - c), abs(b - d)) for a, b, c, d in traj)
        emit("trainer_step", check="c", dtype="bfloat16", batch=TB_TRAIN, chunk_s=CHUNK_S, ms_per_step=step_ms,
             host_ms_per_step=stages, epochs=straight, fit_s=fit_s,
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, card=smi,
             resumed_vs_straight_max_abs_diff=diff, resumed_equals_straight=diff == 0.0,
             note="train_s / steps of epoch 2 (host clock, ending in the fetch of the epoch's losses)")
        check(all(math.isfinite(r["loss"]) for r in straight), "(c) finite losses")
        del trainer
        torch.cuda.empty_cache()
        # the augmentation's device branches on one B=16 x 20 s batch
        x = (0.1 * torch.randn(TB_TRAIN, 2, int(CHUNK_S * SR), generator=torch.Generator().manual_seed(14))).cuda()
        torch.cuda.reset_peak_memory_stats()
        branch_ms = {f"pitch_{s:+d}": cuda_ms(lambda s=s: pitch_shift_semitones(x, s), reps=3, warmup=1)
                     for s in AUG_PITCH_STEPS[1:]}
        pitch_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        branch_ms["frequency_mask"] = cuda_ms(lambda: taug.frequency_mask(x, 20, 60), reps=3, warmup=1)
        noise = taug.draw_noise(torch.Generator().manual_seed(1), x.shape, x.device)
        branch_ms["noise"] = cuda_ms(lambda: taug.add_gaussian_noise(x, noise, 0.01), reps=5, warmup=1)
        branch_ms["flip"] = cuda_ms(lambda: taug.flip_channels({"waveform": x, "vad": x[:, :, :1100].transpose(1, 2)},
                                                               torch.ones(TB_TRAIN, dtype=torch.bool)), reps=5)
        emit("augment_branches", check="c", batch=TB_TRAIN, chunk_s=CHUNK_S, ms=branch_ms,
             pitch_peak_memory_gb=pitch_peak_gb, card=smi, note="CUDA events, one call on a B=16 stereo batch")
        del x, noise
        torch.cuda.empty_cache()
        trainer = tloop.Trainer(model_conf=conf16, data_conf=data, max_epochs=1, out_dir=f("profile"), device="cuda")
        profile(lambda: trainer.fit(), "trainer epoch", dtype="bfloat16", batch=TB_TRAIN, steps=steps,
                val_windows=n_val)
        del trainer
        torch.cuda.empty_cache()

        # (d) augmented float32 steps, card against the CPU -------------------
        conf0 = VapConfig(dropout=0.0)
        step = tstep.make_train_step_augmented(
            conf0, do_flip=True, flip_prob=0.5, do_mask=True, mask_prob=0.5, noise_amplitude=0.01,
            sample_rate=SR, frame_hz=conf0.frame_hz, pitch_steps=AUG_PITCH_STEPS)
        augmented = []
        with augment_draws_on_cpu():
            for choice in [1, 2, 3] + [4 * p for p in range(1, len(AUG_PITCH_STEPS))]:
                nets = {}
                for device in ("cpu", "cuda"):
                    net = VapNet(conf0)
                    net.load_state_dict(state)
                    net.to(device)
                    reset_counts()
                    _, m = step(tstep.TrainState(net, tstep.make_optimizer(OptConfig(), net, True)), small, 0,
                                choice)
                    nets[device] = (net, {k: float(v) for k, v in m.items()})
                card_counts = read_counts()
                (cnet, cm), (gnet, gm) = nets["cpu"], nets["cuda"]
                pairs = [(n_, cp, gp) for (n_, cp), gp in zip(cnet.named_parameters(), gnet.parameters())
                         if not n_.startswith(FROZEN)]
                err = grads_vs_cpu(pairs, cm, gm, cm)
                augmented.append({"choice": choice, "effect": choice % 4, "pitch": AUG_PITCH_STEPS[choice // 4],
                                  "max_err": err, "launches_card": card_counts})
                want = f32_gemms(per_train_step, 3 * linear_per_forward(conf0))
                check(card_counts == want, f"(d) choice {choice}: card launches {card_counts}, expected {want}")
                for k, bar in TRAIN_VS_CPU_TOL.items():
                    check(err[k] <= bar, f"(d) augmented step choice {choice} card vs CPU {k}: {err[k]} > {bar}")
        emit("augmented_vs_cpu", check="d", dtype="float32", batch=1, chunk_s=2.0, dropout=0.0, steps=augmented,
             tol=TRAIN_VS_CPU_TOL)
        torch.cuda.empty_cache()

        # (e) CPC pretraining, its blob into a train run ------------------------
        cli("pretrain_cpc", "pretrain_cpc", "--data_train_path", train_csv, "--steps", str(CPC_CLI_STEPS),
            "--log_every", "1", "--out_dir", f("cpc"), "--export_blob")
        with open(f("cpc", "cpc_metrics.jsonl")) as fh:
            cpc_rows = [json.loads(line) for line in fh]
        check(len(cpc_rows) == CPC_CLI_STEPS and all(math.isfinite(r["cpc_loss"]) for r in cpc_rows),
              f"(e) CPC losses {cpc_rows}")
        cli("train_from_blob", "train", "--max_epochs", "1", "--limit_batches", "1", "--out_dir", f("from_blob"),
            "--init_encoder_from", f("cpc", "cpc_blob.pt"), "--vap_dtype", "bfloat16", "--data_train_path",
            train_csv, "--data_phrases_probe", "0")
        blob = load_cpc_blob(f("cpc", "cpc_blob.pt"))
        params = restore_checkpoint(f("from_blob", TRAIN_RUN, "ckpt_last"), {"params": None})["params"]
        loaded = all(torch.equal(params[f"encoder.{k}"], v) for k, v in blob.items())
        emit("cpc_cli", check="e", steps=cpc_rows, blob_weights=len(blob), encoder_is_the_blob=loaded,
             process_s={k: proc_s[k] for k in ("pretrain_cpc", "train_from_blob")}, card=smi)
        check(loaded, "(e) the trained checkpoint's frozen encoder is the pretrained blob")

        # (f) run and evaluate --checkpoint on the trained checkpoint ----------
        ckpt_best = os.path.join(run, "ckpt_best")
        model = VapModel(VapConfig(), restore_checkpoint(ckpt_best, {"params": None})["params"], device="cuda")
        wav, sr = load_waveform(f("corpus", f"s{TRAIN_SESSIONS - 1:03d}.wav"), sample_rate=SR)
        wav = wav[:, : int(EXCERPT_S * sr)]
        wavfile.write(f("excerpt.wav"), sr, (np.clip(wav.T, -1, 1) * 32767).astype(np.int16))
        cli("run_checkpoint", "run", "-a", f("excerpt.wav"), "--checkpoint", ckpt_best, "-o", f("run.json"))
        with open(f("run.json")) as fh:
            got = {k: np.asarray(v, dtype=np.float32) for k, v in json.load(fh).items()}
        excerpt, _ = load_waveform(f("excerpt.wav"), sample_rate=SR)
        want, _ = run_cli.extract_waveform(model, excerpt[None])
        want = {k: np.asarray(v, dtype=np.float32) for k, v in tensor_dict_to_json(want).items()}
        run_err = {k: float(np.abs(got[k] - want[k]).max()) for k in ("p_now", "p_future", "H")}
        cli("evaluate_checkpoint", "evaluate", "--data_test_path", val_csv, "--checkpoint", ckpt_best, "--out_dir",
            f("eval_cli"), "--data_phrases_probe", "0")
        loader = VapDataLoader(SlidingWindowDataset(val_csv), batch_size=TB_TRAIN, shuffle=False, drop_last=False)
        in_process = teval.evaluate(model, loader, EventConfig(), out_dir=f("eval_in"))
        with open(f("eval_cli", "metrics.csv")) as fh:
            header, values = fh.read().splitlines()
        cli_row = dict(zip(header.split(","), map(float, values.split(","))))
        emit("checkpoint_cli", check="f", run_max_abs_err=run_err, run_identical=all(v == 0.0 for v in run_err.values()),
             evaluate_equal=cli_row == in_process, process_s={k: proc_s[k] for k in ("run_checkpoint",
                                                                                    "evaluate_checkpoint")}, card=smi)
        for k, e in run_err.items():
            check(e <= VS_CPU_TOL[k], f"(f) run --checkpoint vs the model in process {k}: {e}")
        check(cli_row == in_process, f"(f) evaluate --checkpoint {cli_row} vs in process {in_process}")
        del model
        emit("training_run", process_s=proc_s, setup_s=setup_s, card=smi)
    torch.cuda.empty_cache()
    return launches


STREAM_HOPS = 1020  # 20.4 s of 20 ms hops: past the 1,000-frame context of VapConfig()
STREAM_ENC_S = 5.0  # seconds of the exact streaming encoder's 1-frame hops, card and CPU
STREAM_CPU_HOPS = 5  # window-mode hops held against the CPU port
GRAPH_EAGER_HOPS = 60  # KV hops of the graph route held to the eager route, bit for bit
PROFILE_HOPS = 25  # KV hops under the profiler
# the KV frame's kernels that the launch ledger counts, by the names the
# profiler gives them: K12's row and K3's float32 cluster recurrence
KV_TRACED_KERNELS = {"kv_attention": r"\bkv_row_kernel\b", "gru_recurrence": r"\bgru_f32_cluster_kernel\b"}
SWEEP_STREAMS = (1, 16, 64, 256)  # BatchedKVStreamer streams
SWEEP_WARMUP, SWEEP_TICKS = 10, 40  # ticks at each S: untimed, then timed
REALTIME_MS = 20.0  # one hop of audio
SERVE_BATCH = 16  # serve --mode batch's default batch
TICK_STREAMS = 64  # VapStreamServer._tick's slots
SDS_WAV_S = 4.0  # the run_sds process's WAV
# float32, TF32 off: the exact streaming encoder's frames (plain convs, K3,
# the plain downsample) against the same encoder on the CPU and against the
# card's batch encoder (K1, K2: other summation orders); a batched stream
# against a single one (cuBLAS at another row count)
STREAM_ENC_TOL = 1e-4
STREAM_BATCHED_TOL = 2e-5
# a streamer's outputs on the card against the CPU port, float32: the
# inference bars (VS_CPU_TOL) and the VAD probabilities at p_now's
STREAM_VS_CPU_TOL = {"p_now": 2e-4, "p_future": 2e-4, "vad": 2e-4, "H": 1e-3}


def _percentiles(ms) -> dict:
    return {"median": float(np.median(ms)), "p99": float(np.percentile(ms, 99)), "max": float(max(ms)),
            "first": float(ms[0])}


# K12's timed shapes: the stream cell's 512 dialogs and one dialog, at the
# 20 s context (1,000 slots), every slot valid
KV_TIMED_STREAMS = (512, 1)
KV_DEVICE_CALLS = 20
# cycles of the sleep kernel that holds the stream while the host enqueues
# (about 100 ms at the H100's 1.98 GHz)
HOLD_CYCLES = 200_000_000


def device_ms_per_call(fn, calls: int = KV_DEVICE_CALLS) -> float:
    """Device ms a call of fn with the host's pace left out: a sleep kernel
    holds the stream while the host enqueues ``calls`` calls, then CUDA
    events around those calls time the device alone (where the host paces
    the launches, events around calls in a free stream time the host)."""
    fn()
    sync()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    marks[0].record()
    torch.cuda._sleep(HOLD_CYCLES)
    marks[1].record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    enqueue_ms = 1e3 * (time.perf_counter() - t0)
    marks[2].record()
    sync()
    held_ms = marks[0].elapsed_time(marks[1])
    check(enqueue_ms < held_ms, f"device_ms_per_call: enqueue {enqueue_ms:.1f} ms outlasted the hold {held_ms:.1f} ms")
    return marks[1].elapsed_time(marks[2]) / calls


def kv_attention_entry(port, conf, state, reset_counts, read_counts) -> dict:
    """The kernels line's K12 entry (float32): a KV hop's launches at S=1,
    then at each of ``KV_TIMED_STREAMS`` dialogs over full rings the kernel
    (self and cross rows, the write cursor a (1,) int64 on the card as the
    streamers pass it) against the plain row, its ms (CUDA events around
    back-to-back calls) and device ms (``device_ms_per_call``) beside its
    bound (bytes), the plain row's and the library yardstick's."""
    from voiceactivityprojection_tpu_torch.inference.streaming_kv import KVStreamingVap
    from voiceactivityprojection_tpu_torch.models.vap import VapModel

    k12 = port["k12"]
    H, Dh = conf.num_heads, conf.dim // conf.num_heads
    T = int(CHUNK_S * conf.frame_hz)
    rows_a_frame = conf.channel_layers + 2 * conf.cross_layers
    kv = KVStreamingVap(VapModel(conf, state, device="cuda"), context_time=CHUNK_S)
    hop = (0.1 * np.random.default_rng(12).standard_normal((2, 320))).astype(np.float32)
    kv.push(hop)
    sync()
    reset_counts()
    kv.push(hop)
    sync()
    hop_launches = read_counts()["kv_attention"]
    check(hop_launches == rows_a_frame, f"K12 a KV hop: {hop_launches} launches, expected {rows_a_frame}")
    del kv
    g = torch.Generator(device="cuda").manual_seed(12)
    slopes = port["alibi_slopes"](H).float().cuda()
    scale = 1.0 / math.sqrt(conf.dim)
    timed = {}
    for S in KV_TIMED_STREAMS:
        q = torch.randn(S, 2, H, Dh, device="cuda", generator=g)
        k, v = (torch.randn(S, 2, H, T, Dh, device="cuda", generator=g) for _ in range(2))
        n = torch.full((S,), T, dtype=torch.int32, device="cuda")
        pos = torch.full((1,), T // 3, dtype=torch.int64, device="cuda")  # the streamers' device cursor
        dist = k12.slot_ages(pos, T, "cuda")
        kernel = lambda: k12.kv_attention_row(q, k, v, slopes, pos, n, conf.dim)  # noqa: E731
        plain = lambda: k12.attn_row_reference(q, k, v, slopes, k12.slot_ages(pos, T, "cuda"), n,  # noqa: E731
                                               conf.dim)
        shape = [S, 2, H, T, Dh]
        err = compare("kv_attention", kernel(), plain(), shape, torch.float32)
        err_cross = compare("kv_attention", k12.kv_attention_row(q, k, v, slopes, pos, n, conf.dim, swap=True),
                            k12.attn_row_reference(q, k.flip(1), v.flip(1), slopes, dist, n, conf.dim), shape,
                            torch.float32, swap=True)
        bias = -(slopes[:, None] * dist[None, :])  # (H, T): every slot valid
        bias = bias[None, None, :, None, :].expand(S, 2, H, 1, T)
        library = lambda: F.scaled_dot_product_attention(q[..., None, :], k, v, attn_mask=bias,  # noqa: E731
                                                         scale=scale)
        lib_err = max_err(library()[..., 0, :].reshape(S, 2, H * Dh), plain())
        reps = 20 if S > 1 else 200
        ms = cuda_ms(kernel, reps=reps, warmup=3)
        ring_bytes = 4.0 * 2 * k.numel()
        nbytes = ring_bytes + 4.0 * 2 * q.numel()  # the rings read once, q read and the row written
        bnd, by = bound_ms(2.0 * 2 * S * 2 * H * T * Dh, nbytes, PEAK_F32_FLOPS)
        timed[S] = dict(
            shape=shape, ms=ms, device_ms=device_ms_per_call(kernel), rings_tb_per_s=ring_bytes / ms / 1e9,
            bound_ms=bnd, bound_by=by, plain_ms=cuda_ms(plain, reps=reps // 2, warmup=2),
            plain_device_ms=device_ms_per_call(plain), library_ms=cuda_ms(library, reps=reps // 2, warmup=2),
            library_max_abs_err=lib_err, max_abs_err=err, max_abs_err_cross=err_cross)
        del q, k, v, bias
        torch.cuda.empty_cache()
    main_shape = timed[KV_TIMED_STREAMS[0]]
    return dict(
        name="kv_attention", route="cuda", source="voiceactivityprojection_tpu_torch/csrc/kv_attention.cu",
        replaces="no TPU kernel: the JAX package's KV row is two XLA einsums "
                 "(voiceactivityprojection_tpu/inference/streaming_kv.py:147, :156)",
        launches=hop_launches, dtype="float32", **{k_: main_shape[k_] for k_ in (
            "shape", "ms", "device_ms", "rings_tb_per_s", "bound_ms", "bound_by", "plain_ms",
            "library_ms", "max_abs_err", "max_abs_err_cross")},
        at_one_dialog=timed[1], registers=kernel_registers(_build, "kv_attention"),
        design="one CTA of 128 threads a (stream, channel, head) row at every S; 16-byte streaming loads of K "
               "and V, an online softmax in f32 FFMA; only valid slots read",
        launches_note="launches a KV frame at S=1, one a row (7 at VapConfig()) in any streamer",
        cursor_note="the write cursor a (1,) int64 on the card, read there by the kernel, as the streamers pass it",
        library_note="F.scaled_dot_product_attention at query length 1 with a float ALiBi bias (every slot valid), "
                     "float32; never called by the port")


# K13's timed shapes: the inference cell's rows of a site's two launches
# (B = 64 x 1,000 frames x 2) at q/k/v, the output projection and the FFN's
# down-projection, and its two epilogues (the FFN's up-projection with the
# GELU, an output projection with the residual); dX and dW at the frozen
# step's 16,000 rows a launch at q/k/v, an output projection and the FFN's
# down-projection
LINEAR_FORWARD = ((128_000, 768, 256), (128_000, 256, 256), (128_000, 256, 768))
LINEAR_GELU = (128_000, 768, 256)
LINEAR_RESIDUAL = (128_000, 256, 256)
LINEAR_BACKWARD = ((16_000, 768, 256), (16_000, 256, 256), (16_000, 256, 768))


def linear_entry(launches: dict) -> dict:
    """The kernels line's K13 entry (float32): at each shape the kernel
    against the plain version (``x @ w.T``, FFMA; then the GELU or the
    residual where the epilogue has them) and both against a float64
    product beside one TF32 pass, its ms (CUDA events around back-to-back
    calls) and device ms with the stream held, beside its bound (three TF32
    products at 495 TFLOP/s, or the bytes), the FFMA bound, the plain
    version's ms and ``F.linear`` / ``torch.mm``'s (``library_ms``).
    ``launches``: its GEMMs on this run's float32 paths (``f32_launches``)."""
    from voiceactivityprojection_tpu_torch.ops import linear as k13

    g = torch.Generator(device="cuda").manual_seed(13)

    def rel64(got, want64):
        return float((got.double() - want64).abs().max() / want64.abs().max())

    def tf32_pass(fn):
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return fn()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    def timed(what, shape, kernel, plain, library, want64, flops, nbytes):
        err = compare("linear", kernel(), plain(), list(shape), torch.float32, what=what)
        bnd, by = bound_ms(3 * flops, nbytes, PEAK_TF32_FLOPS)
        return dict(what=what, shape=list(shape), ms=cuda_ms(kernel, reps=20, warmup=3),
                    device_ms=device_ms_per_call(kernel), bound_ms=bnd, bound_by=by,
                    ffma_bound_ms=bound_ms(flops, nbytes, PEAK_F32_FLOPS)[0],
                    plain_ms=cuda_ms(plain, reps=20, warmup=3), library_ms=cuda_ms(library, reps=20, warmup=3),
                    max_abs_err=err, rel_err_f64=rel64(kernel(), want64), plain_rel_err_f64=rel64(plain(), want64),
                    tf32_rel_err_f64=rel64(tf32_pass(plain), want64), tflops=flops / cuda_ms(kernel, reps=10) / 1e9)

    def operands(M, N, K):
        return (torch.randn(M, K, device="cuda", generator=g), torch.randn(N, K, device="cuda", generator=g) * 0.05)

    rows = []
    for M, N, K in LINEAR_FORWARD:
        x, w = operands(M, N, K)
        rows.append(timed("forward", (M, N, K), lambda: k13.linear_tf32x3(x, w), lambda: x @ w.T,
                          lambda: F.linear(x, w), x.double() @ w.double().T, 2.0 * M * N * K,
                          4.0 * (M * K + M * N + N * K)))
        del x, w
        torch.cuda.empty_cache()
    M, N, K = LINEAR_GELU
    x, w = operands(M, N, K)
    rows.append(timed("forward gelu", (M, N, K), lambda: k13.linear_tf32x3(x, w, gelu=True),
                      lambda: F.gelu(x @ w.T), lambda: F.gelu(F.linear(x, w)),
                      F.gelu(x.double() @ w.double().T), 2.0 * M * N * K, 4.0 * (M * K + M * N + N * K)))
    del x, w
    torch.cuda.empty_cache()
    M, N, K = LINEAR_RESIDUAL
    x, w = operands(M, N, K)
    r = torch.randn(M, N, device="cuda", generator=g)
    rows.append(timed("forward residual", (M, N, K), lambda: k13.linear_tf32x3(x, w, residual=r),
                      lambda: r + x @ w.T, lambda: torch.addmm(r, x, w.t()),
                      r.double() + x.double() @ w.double().T, 2.0 * M * N * K,
                      4.0 * (M * K + 2 * M * N + N * K)))
    del x, w, r
    torch.cuda.empty_cache()
    for M, N, K in LINEAR_BACKWARD:
        x, w = operands(M, N, K)
        gy = torch.randn(M, N, device="cuda", generator=g)
        g64 = gy.double()
        rows.append(timed("dX", (M, N, K), lambda: k13._input_grad(gy, [w]), lambda: gy @ w,
                          lambda: torch.mm(gy, w), g64 @ w.double(), 2.0 * M * N * K,
                          4.0 * (M * N + M * K + N * K)))
        rows.append(timed("dW", (M, N, K), lambda: k13._weight_grad(gy, x), lambda: gy.T @ x,
                          lambda: torch.mm(gy.t(), x), g64.T @ x.double(), 2.0 * M * N * K,
                          4.0 * (M * N + M * K + N * K)))
        del x, w, gy, g64
        torch.cuda.empty_cache()
    for r in rows:
        check(r["rel_err_f64"] <= F32_REL["linear"] and 10 * r["rel_err_f64"] <= r["tf32_rel_err_f64"],
              f"K13 {r['what']} {r['shape']}: {r['rel_err_f64']} of the largest from float64, one TF32 pass "
              f"{r['tf32_rel_err_f64']}")
    main = rows[0]
    return dict(
        name="linear", route="cuda", source="voiceactivityprojection_tpu_torch/csrc/linear_tf32x3.cu",
        replaces="no TPU kernel: the JAX package leaves the projections to XLA "
                 "(voiceactivityprojection_tpu/models/transformer.py, ops/attention.py)",
        launches=launches.get("per_f32_request", 0), dtype="float32", f32_launches=launches,
        **{k_: main[k_] for k_ in ("shape", "ms", "device_ms", "bound_ms", "bound_by", "plain_ms", "library_ms",
                                   "max_abs_err")},
        shapes=rows, registers=kernel_registers(_build, "linear_tf32x3"),
        design="3xTF32 on wgmma m64nBNk8 (BN 128, or 64 for a width of 64 x odd): one producer warp, TMA into a "
               "ring of 32-float chunks, two consumer warpgroups of 64 rows splitting A in registers, each chunk's "
               "products promoted into a float32 sum; persistent CTAs; dW with dY and X as they lie, X transposed "
               "and split in shared memory, the rows in slices summed in a fixed order",
        launches_note="GEMM launches (forward, dX, dW) on this run's float32 paths, read from the launch "
                      "ledger; the splits of the weights and dW's slice sums apart (its auxiliary kernels); "
                      "none in bfloat16 (torch.matmul)",
        bound_note="bound_ms: three TF32 products at 495 TFLOP/s or the bytes (inputs, weights, residual and output "
                   "once) at 3.35 TB/s; ffma_bound_ms: the float32 operations once at 67 TFLOP/s",
        library_note="F.linear / torch.addmm / torch.mm in float32, TF32 off (cuBLAS on the CUDA cores); never "
                     "called by the port")


def streaming_serving(state, smi, port, enc, per_forward, reset_counts, read_counts) -> dict:
    """Phase 15: streaming and serving as a user runs them, at ``VapConfig()``
    widths, float32 with TF32 off unless stated: (a) the GRU recurrence (K3)
    against its plain version at the streamers' shapes, and two launches
    carrying h_last against one; (b) the exact streaming encoder over 5 s
    in 1-frame hops against the CPU port and the card's batch encoder; (c)
    ``StreamingVap`` for 1,020 hops (launches, ms a hop with the SDS loop's
    fetch, the first hops against the CPU port); (d) ``KVStreamingVap`` for
    1,020 hops on its CUDA graphs (launches with the replays, graph sets a
    hop, ms a hop, the first 60 hops against the eager route bit for bit,
    the pre-fill frames against the card's ``probs``), and a profile of 25
    hops (every device launch a hop, the idle share, K12's and K3's kernels
    a hop by name); (e)
    ``BatchedKVStreamer`` at S = 1, 16, 64, 256 (ms a tick with the
    server's one fetch, stream-hops/s, peak memory, graph sets a tick, the
    warm-up ticks against the eager route bit for bit) and a
    ``reset_stream`` against a fresh stream; (f) ``VapServer._run_batch`` at
    B=16 x 20 s bfloat16 and ``VapStreamServer._tick`` at S=64, their
    launches and times, then, where pyzmq imports, a socket round trip of 2
    stream and 4 batch clients; (g) one ``run_sds --wav`` process over 4 s
    in kv mode. Returns the launches of each path, a hop or a call."""
    import tempfile

    from voiceactivityprojection_tpu_torch.config import VapConfig
    from voiceactivityprojection_tpu_torch.inference.server import (
        VapServer,
        VapStreamServer,
        _Request,
        _to_host,
    )
    from voiceactivityprojection_tpu_torch.inference.streaming import StreamingVap
    from voiceactivityprojection_tpu_torch.inference.streaming_kv import BatchedKVStreamer, KVStreamingVap
    from voiceactivityprojection_tpu_torch.models.encoder import apply_encoder
    from voiceactivityprojection_tpu_torch.models.encoder_streaming_exact import ExactStreamingEncoder
    from voiceactivityprojection_tpu_torch.models.vap import VapModel

    conf = VapConfig()
    hop = 320
    sites = 2 * conf.channel_layers + 4 * conf.cross_layers
    clock = [time.perf_counter()]

    def lap() -> float:
        """Seconds since the previous lap: each check's share of the phase."""
        clock.append(time.perf_counter())
        return clock[-1] - clock[-2]

    rng = np.random.default_rng(15)
    gen = torch.Generator().manual_seed(15)
    n20 = int(CHUNK_S * SR)
    launches: dict = {}

    def per(counts: dict, calls: int, what: str) -> dict:
        check(all(v % calls == 0 for v in counts.values()), f"{what}: launches {counts} over {calls} calls")
        return {k: v // calls for k, v in counts.items()}

    def expect(counts: dict, what: str, **nonzero) -> None:
        want = dict.fromkeys(counts, 0)
        want.update(nonzero)
        check(counts == want, f"{what}: launches {counts}, expected {want}")

    kv_rows = conf.channel_layers + 2 * conf.cross_layers  # KV attention rows a frame (K12)

    # (a) K3 at the streaming shapes -----------------------------------------
    routes = _build.launch_counts()
    shapes = ((2, 1), (2, 2), (2, 10), (128, 2), (512, 2))
    k3_errs = {f"R={R} T={T}": gru_recurrence_case(port, enc, R, T, torch.float32, gen) for R, T in shapes}
    k3 = port["k3"]
    H = enc.gAR.w_hh.shape[0]
    w_hh, b_hh = enc.gAR.w_hh.float().contiguous(), enc.gAR.b_hh.float()
    xp = (0.5 * torch.randn(2, 4, 3 * H, generator=gen)).cuda()
    h0 = (0.1 * torch.randn(2, H, generator=gen)).cuda()
    ys_a, h_a = k3.gru_recurrence(xp[:, :2].contiguous(), w_hh, b_hh, h0)
    ys_b, _ = k3.gru_recurrence(xp[:, 2:].contiguous(), w_hh, b_hh, h_a.contiguous())
    ys_ab, _ = k3.gru_recurrence(xp, w_hh, b_hh, h0)
    chain_err = max_err(torch.cat([ys_a, ys_b], dim=1), ys_ab)
    emit("stream_gru", check="a", max_abs_err_by_shape=k3_errs, tol=F32_TOL["gru_recurrence"],
         chained_vs_one_launch=chain_err, design=k3.forward_tiling(512, H, torch.float32).route,
         note="float32, h0 nonzero; chained: T=2 then T=2 from its h_last, against T=4", seconds=lap())
    check(chain_err <= F32_TOL["gru_recurrence"], f"(a) K3 chained over h_last: {chain_err}")
    check_f32_routes("(a) K3 at the streamers' shapes", routes, gru_recurrence=len(shapes) + 3)
    routes = _build.launch_counts()

    # (b) the exact streaming encoder ------------------------------------------
    m32 = VapModel(conf, state, device="cuda")
    cpu = VapModel(conf, state, device="cpu")
    n_enc = int(STREAM_ENC_S * SR)
    w_enc = (0.1 * rng.standard_normal((2, n_enc))).astype(np.float32)
    frames = {}
    for name, model in (("card", m32), ("cpu", cpu)):
        e = ExactStreamingEncoder(model.net.encoder, batch=2)
        frames[name] = torch.cat([e.push(w_enc[:, i:i + hop]).cpu() for i in range(0, n_enc, hop)], dim=1)
    with torch.inference_mode():
        batch_frames = apply_encoder(m32.net.encoder, torch.from_numpy(w_enc).cuda(), fused_auto=True).cpu()
    n = min(frames["card"].shape[1], batch_frames.shape[1]) - 2  # the batch's last frames see end padding
    enc_err = {"vs_cpu_stream": max_err(frames["card"][:, :n], frames["cpu"][:, :n]),
               "vs_card_batch": max_err(frames["card"][:, :n], batch_frames[:, :n]),
               "cpu_stream_vs_cpu_batch": None}
    with torch.inference_mode():
        cpu_batch = apply_encoder(cpu.net.encoder, torch.from_numpy(w_enc))
    enc_err["cpu_stream_vs_cpu_batch"] = max_err(frames["cpu"][:, :n], cpu_batch[:, :n])
    emit("stream_encoder", check="b", hops=n_enc // hop, frames=frames["card"].shape[1], compared=n,
         max_abs_err=enc_err, tol=STREAM_ENC_TOL, tf32=False,
         note="card stream: plain convs, K3, plain downsample; card batch: K1 x 5, K2", seconds=lap())
    for k, e_ in enc_err.items():
        check(e_ <= STREAM_ENC_TOL, f"(b) exact streaming encoder {k}: {e_}")
    del frames, batch_frames, cpu_batch

    wav = (0.1 * rng.standard_normal((2, STREAM_HOPS * hop))).astype(np.float32)
    chunks = [np.ascontiguousarray(wav[:, i * hop:(i + 1) * hop]) for i in range(STREAM_HOPS)]

    def drive(streamer, hops: int, keep: int = 0):
        """Push ``hops`` chunks, each fetched as the SDS loop fetches it (the
        newest p_now to the host); ms a hop on the host clock and the first
        ``keep`` hops' outputs."""
        streamer.reset()
        sync()
        ms, kept = [], []
        for i in range(hops):
            t0 = time.perf_counter()
            out = streamer.push(chunks[i])
            out["p_now"][-1].cpu()
            ms.append(1e3 * (time.perf_counter() - t0))
            if i < keep:
                kept.append(out)
        return ms, [{k: v.cpu() for k, v in o.items()} for o in kept]

    # (c) StreamingVap, window mode ----------------------------------------------
    win = StreamingVap(m32, context_time=CHUNK_S, hop_frames=1)
    reset_counts()
    win_ms, win_out = drive(win, STREAM_HOPS, keep=STREAM_CPU_HOPS)
    sync()
    launches["window_hop"] = per(read_counts(), STREAM_HOPS, "(c) window")
    cpu_win = StreamingVap(cpu, context_time=CHUNK_S, hop_frames=1)
    cpu_win.reset()
    win_err: dict = {}
    for i in range(STREAM_CPU_HOPS):
        want = cpu_win.push(chunks[i])
        for k in ("p_now", "p_future", "vad", "H"):
            win_err[k] = max(win_err.get(k, 0.0), max_err(win_out[i][k], want[k]))
    emit("stream_window", check="c", hops=STREAM_HOPS, context_frames=win.context_frames,
         launches_per_hop=launches["window_hop"], ms_per_hop=_percentiles(win_ms),
         realtime_share=float(np.mean(np.asarray(win_ms) < REALTIME_MS)), vs_cpu_hops=STREAM_CPU_HOPS,
         vs_cpu_max_abs_err=win_err, tol=STREAM_VS_CPU_TOL, card=smi,
         note="host clock a hop: the push and the fetch of its newest p_now", seconds=lap())
    expect(launches["window_hop"], "(c) window hop", gru_recurrence=1, flash_alibi=sites,
           linear=linear_per_forward(conf))
    for k, e_ in win_err.items():
        check(e_ <= STREAM_VS_CPU_TOL[k], f"(c) window mode card vs CPU {k}: {e_}")
    del win, cpu_win, win_out

    # (d) KVStreamingVap, and (h) its profile -------------------------------------
    kv = KVStreamingVap(m32, context_time=CHUNK_S, hop_frames=1)
    reset_counts()
    kv_ms, kv_out = drive(kv, STREAM_HOPS, keep=STREAM_HOPS)
    sync()
    launches["kv_hop"] = per(read_counts(), STREAM_HOPS, "(d) kv")
    graphs = {"captures": kv._graphs.captures, "replays_per_hop": kv._graphs.replays / STREAM_HOPS}
    eager = KVStreamingVap(m32, context_time=CHUNK_S, hop_frames=1)
    eager._graphs = eager._staging = None  # the route of the CPU and of the prime hop
    eager.reset()
    graph_vs_eager = 0.0
    for i in range(GRAPH_EAGER_HOPS):
        want = eager.push(chunks[i])
        graph_vs_eager = max([graph_vs_eager] + [max_err(kv_out[i][k], want[k].cpu()) for k in want])
    del eager
    filled = kv.context_frames  # frames before the rings wrap: the batch forward's on the prefix
    got = torch.cat([o["p_now"] for o in kv_out])  # (frames, 2)
    check(got.shape[0] == STREAM_HOPS, f"(d) kv frames {got.shape}")
    check(bool(torch.isfinite(got).all()), "(d) kv p_now finite")
    ref = m32.probs(torch.from_numpy(wav[None, :, : filled * hop]))
    n = filled - 2
    kv_err = {k: max_err(torch.cat([o[k] for o in kv_out])[:n], ref[k][0, :n].cpu()) for k in ("p_now", "p_future")}
    kv.reset()
    replays = kv._graphs.replays
    prof = profile(lambda: [kv.push(c)["p_now"][-1].cpu() for c in chunks[:PROFILE_HOPS]], "kv hops",
                   hops=PROFILE_HOPS, streams=1)
    # the kernels the card ran, by name: the ledger adds a capture's launches at each replay
    traced = {k: sum(c for name, c in prof["by_name"].items() if re.search(pat, name)) / PROFILE_HOPS
              for k, pat in KV_TRACED_KERNELS.items()}
    graphs["replays_per_hop_profiled"] = (kv._graphs.replays - replays) / PROFILE_HOPS
    emit("stream_kv", check="d", hops=STREAM_HOPS, context_frames=filled,
         launches_per_hop=launches["kv_hop"], graphs=graphs, graph_vs_eager_hops=GRAPH_EAGER_HOPS,
         graph_vs_eager_max_abs_err=graph_vs_eager, device_ops_per_hop=prof["device_ops"] / PROFILE_HOPS,
         kernel_launches_per_hop=prof["kernel_launches"] / PROFILE_HOPS, traced_per_hop=traced,
         idle_share=prof["idle_share"],
         ms_per_hop=_percentiles(kv_ms), realtime_share=float(np.mean(np.asarray(kv_ms) < REALTIME_MS)),
         vs_card_probs_frames=n, vs_card_probs_max_abs_err=kv_err, tol=VS_CPU_TOL, card=smi,
         note="host clock a hop: the push and the fetch of its p_now; launches from the profile of "
              f"{PROFILE_HOPS} hops (kernels; device_ops adds copies and fills)", seconds=lap())
    expect(launches["kv_hop"], "(d) kv hop", gru_recurrence=1, kv_attention=kv_rows)
    check(graph_vs_eager == 0.0, f"(d) kv graph route against the eager route: {graph_vs_eager}")
    check(traced == {"kv_attention": kv_rows, "gru_recurrence": 1}
          and graphs["replays_per_hop_profiled"] > 1.9, f"(d) kv kernels traced a hop {traced}, graphs {graphs}")
    check(graphs["captures"] == 2 and graphs["replays_per_hop"] > 1.99, f"(d) kv graphs {graphs}")
    for k, e_ in kv_err.items():
        check(e_ <= VS_CPU_TOL[k], f"(d) kv against the card's probs on the prefix {k}: {e_}")
    del kv, kv_out, ref

    # (e) BatchedKVStreamer ------------------------------------------------------
    sweep = []
    for S in SWEEP_STREAMS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        b = BatchedKVStreamer(m32, streams=S, context_time=CHUNK_S, hop_frames=1)
        b.reset()
        e = BatchedKVStreamer(m32, streams=S, context_time=CHUNK_S, hop_frames=1)
        e._graphs = e._staging = None  # the eager route, for the warm-up ticks
        e.reset()
        x = (0.1 * rng.standard_normal((S, 2, hop))).astype(np.float32)
        ms, gap = [], 0.0
        for i in range(SWEEP_WARMUP + SWEEP_TICKS):
            if i == SWEEP_WARMUP:
                reset_counts()
                linear_before = _build.launch_counts()
                replays = b._graphs.replays
                del e
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = b.push(torch.from_numpy(x))
            _to_host(out)
            ms.append(1e3 * (time.perf_counter() - t0))
            if i < SWEEP_WARMUP:
                want = e.push(torch.from_numpy(x))
                gap = max([gap] + [float((out[k] - want[k]).abs().max()) for k in want])
        counts = per(read_counts(), SWEEP_TICKS, f"(e) S={S}")
        expect(counts, f"(e) batched tick S={S}", gru_recurrence=1, kv_attention=kv_rows)
        check_routes(f"(e) batched ticks S={S}", linear_before, "linear", {})  # the KV frame: torch.matmul
        check(gap == 0.0, f"(e) S={S}: the graph route against the eager route over {SWEEP_WARMUP} ticks: {gap}")
        launches[f"batched_tick_s{S}"] = counts
        ms = ms[SWEEP_WARMUP:]
        med = float(np.median(ms))
        sweep.append({"streams": S, "ms_per_tick": _percentiles(ms), "stream_hops_per_s": S / med * 1e3,
                      "realtime": med < REALTIME_MS, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "graph_replays_per_tick": (b._graphs.replays - replays) / SWEEP_TICKS,
                      "graph_vs_eager_max_abs_err": gap})
        del b
    realtime = [r["streams"] for r in sweep if r["realtime"]]
    # a recycled slot against a fresh stream, on features (the K/V state restarts exactly)
    S, C = 4, conf.dim
    a_f = (0.5 * torch.randn(S, 2, 10, C, generator=gen)).cuda()
    c_f = (0.5 * torch.randn(S, 2, 12, C, generator=gen)).cuda()
    b = BatchedKVStreamer(m32, streams=S, context_time=CHUNK_S)
    b.push_features(a_f)
    b.reset_stream(1)
    got = b.push_features(c_f)
    fresh = KVStreamingVap(m32, context_time=CHUNK_S)
    want = fresh.push_features(c_f[1])
    reset_err = {k: max_err(got[k][:, 1], want[k]) for k in ("p_now", "p_future", "vad")}
    emit("stream_batched", check="e", sweep=sweep, largest_realtime_streams=max(realtime) if realtime else 0,
         reset_stream_vs_fresh_max_abs_err=reset_err, tol=STREAM_BATCHED_TOL, card=smi,
         note="host clock a tick: the push of (S, 2, 320) host chunks and the one fetch of every output",
         seconds=lap())
    for k, e_ in reset_err.items():
        check(e_ <= STREAM_BATCHED_TOL, f"(e) reset_stream against a fresh stream {k}: {e_}")
    del b, fresh, got, want
    torch.cuda.empty_cache()

    # the streamers' K3 in (b)-(e): every launch on the f32 cluster kernel
    check_f32_routes("(b)-(e) the streamers' hops and ticks", routes, gru_recurrence=None)

    # (f) the servers in process, then over sockets --------------------------------
    m16 = VapModel(VapConfig(dtype="bfloat16"), state, device="cuda")
    srv = VapServer(m16, batch_size=SERVE_BATCH, chunk_time=CHUNK_S)
    reqs = [_Request(b"c%d" % i, i, (0.1 * rng.standard_normal((2, n20))).astype(np.float32), n20 // hop)
            for i in range(SERVE_BATCH)]
    srv._run_batch(reqs)  # warm-up
    sync()
    reset_counts()
    results = srv._run_batch(reqs)
    launches["run_batch"] = read_counts()
    check(launches["run_batch"] == per_forward, f"(f) _run_batch launches {launches['run_batch']}")
    check(all(r["p_now"].shape == (n20 // hop, 2) and np.isfinite(r["p_now"]).all() for r in results),
          "(f) _run_batch outputs")
    batch_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        srv._run_batch(reqs)
        batch_ms.append(1e3 * (time.perf_counter() - t0))
    ss = VapStreamServer(m32, streams=TICK_STREAMS, context_time=CHUNK_S, hop_frames=1)
    ss.streamer.reset()
    chunk = (0.1 * rng.standard_normal((2, hop))).astype(np.float32)
    tick_ms = []
    for i in range(SWEEP_WARMUP + SWEEP_TICKS):
        with ss._lock:
            for slot in range(TICK_STREAMS):
                ss.sessions[slot] = b"s%d" % slot
                ss.pending[slot] = [(i, chunk)]
        if i == SWEEP_WARMUP:
            reset_counts()
        t0 = time.perf_counter()
        replies = ss._tick()
        tick_ms.append(1e3 * (time.perf_counter() - t0))
    launches["stream_tick"] = per(read_counts(), SWEEP_TICKS, "(f) tick")
    expect(launches["stream_tick"], "(f) stream tick", gru_recurrence=1, kv_attention=kv_rows)
    check(len(replies) == TICK_STREAMS and ss.stats["underruns"] == 0, "(f) tick replies")
    emit("serve_in_process", check="f", run_batch={"batch": SERVE_BATCH, "chunk_s": CHUNK_S, "dtype": "bfloat16",
                                                    "launches": launches["run_batch"], "ms": _percentiles(batch_ms)},
         stream_tick={"streams": TICK_STREAMS, "launches_per_tick": launches["stream_tick"],
                      "ms": _percentiles(tick_ms[SWEEP_WARMUP:])}, card=smi, seconds=lap())
    del srv, ss, reqs, results
    try:
        import zmq  # noqa: F401  (the sockets need pyzmq; the paths above do not)
        have_zmq = True
    except ImportError:
        have_zmq = False
    emit("serve_sockets_available", zmq=have_zmq, runs=have_zmq)
    if have_zmq:
        sockets = serve_sockets(m16, m32, rng)
        emit("serve_sockets", check="f", **sockets, card=smi, seconds=lap())

    # (g) one run_sds process --------------------------------------------------------
    root = os.path.dirname(os.path.abspath(__file__))
    build = os.path.join(root, "voiceactivityprojection_tpu_torch", "build")
    os.makedirs(build, exist_ok=True)
    hops = int(SDS_WAV_S * conf.frame_hz)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = os.path.join(tmp, "sds.wav")
        _write_wav(path, SDS_WAV_S, SR, 2, rng)
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "voiceactivityprojection_tpu_torch.run_sds", "--wav", path,
                            "--sds_transformer_mode", "kv", "--sds_zmq_port", "0", "--max_chunks", str(hops)],
                           cwd=root, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
    check(r.returncode == 0, f"(g) run_sds: exit {r.returncode}\n{r.stderr[-3000:]}")
    last = json.loads(r.stdout.strip().splitlines()[-1])
    check(last["hops"] == hops, f"(g) run_sds hops {last['hops']}")
    ps = [float(line.split("=")[1]) for line in r.stdout.splitlines() if line.startswith("p_now(A)=")]
    check(len(ps) == hops and all(0.0 <= p <= 1.0 for p in ps), "(g) run_sds p_now lines")
    emit("run_sds_cli", check="g", audio_s=SDS_WAV_S, mode="kv", hops=hops, wall_s=wall, timings=last["timings"],
         loop_ms_per_hop=1e3 * last["timings"]["loop_s"] / hops, card=smi, seconds=lap())
    del m16, m32, cpu
    torch.cuda.empty_cache()
    return launches


def serve_sockets(m16, m32, rng) -> dict:
    """Phase 15 (f) over sockets, on ports the OS picks: two stream clients
    pushing 20 hops together against single streams on the card, and four
    batch clients at once against the bfloat16 batch server."""
    import threading

    import zmq

    from voiceactivityprojection_tpu_torch.inference.server import (
        VapClient,
        VapServer,
        VapStreamClient,
        VapStreamServer,
    )
    from voiceactivityprojection_tpu_torch.inference.streaming_kv import KVStreamingVap

    hops, hop = 20, 320
    n20 = int(CHUNK_S * SR)
    out: dict = {}
    ctx = zmq.Context()
    ss = VapStreamServer(m32, streams=4, context_time=CHUNK_S, hop_frames=1, max_wait_ms=400)
    ss.start(port=0)
    clients = [VapStreamClient(port=ss.port, timeout_s=120, ctx=ctx) for _ in range(2)]
    try:
        for c in clients:
            c.open()
        waves = [(0.1 * rng.standard_normal((2, hops * hop))).astype(np.float32) for _ in clients]
        got = [[None] * hops for _ in clients]
        t0 = time.perf_counter()
        for i in range(hops):
            threads = [threading.Thread(target=lambda j=j: got[j].__setitem__(
                i, clients[j].push(waves[j][:, i * hop:(i + 1) * hop]))) for j in range(len(clients))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            check(all(g[i] is not None for g in got), f"stream clients hop {i}")
        stream_s = time.perf_counter() - t0
        errs = []
        for j, w in enumerate(waves):
            single = KVStreamingVap(m32, context_time=CHUNK_S)
            want = np.concatenate([single.push(w[:, i * hop:(i + 1) * hop])["p_now"].cpu().numpy()
                                   for i in range(hops)])
            errs.append(float(np.abs(np.concatenate([g["p_now"] for g in got[j]]) - want).max()))
        closes = [c.close() for c in clients]
        out["stream"] = {"clients": len(clients), "hops": hops, "seconds": stream_s,
                         "vs_single_max_abs_err": errs, "underruns": ss.stats["underruns"],
                         "close_replies": closes}
        check(max(errs) <= STREAM_BATCHED_TOL, f"stream sessions against single streams: {errs}")
        check(ss.stats["underruns"] == 0, f"stream underruns {ss.stats['underruns']}")
    finally:
        ss.stop()
    bs = VapServer(m16, batch_size=4, chunk_time=CHUNK_S, max_wait_ms=200)
    bs.start(port=0)
    try:
        waves = [(0.1 * rng.standard_normal((2, n20))).astype(np.float32) for _ in range(4)]
        res = [None] * 4

        def call(i):
            c = VapClient(port=bs.port, timeout_s=120, ctx=ctx)
            try:
                res[i] = c.infer(waves[i])
            finally:
                c.close()

        t0 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        batch_s = time.perf_counter() - t0
        check(all(r_ is not None and r_["p_now"].shape == (n20 // hop, 2) and np.isfinite(r_["p_now"]).all()
                  for r_ in res), "batch clients' replies")
        out["batch"] = {"clients": 4, "seconds": batch_s, "batches": bs.stats["batches"]}
    finally:
        bs.stop()
        ctx.term()
    return out


# the prosody probe (phase 16): a synthetic phrase corpus in the reference's
# CSV schema (tests/_torch_phrases.py: WAVs at 22,050 Hz, padded to one
# length, the longest phrase's end + 2 s), probed in batches of 10, and a
# small synthetic dialog corpus for the psola Trainer
PROBE_PHRASES = 20  # two probe batches of 10 (PhraseProbe's default batch)
PROBE_BATCH = 10
PROBE_CLI_VS_CPU = 2  # phrases of the evaluate_phrases process held against --device cpu
PROBE_CLI_PHRASES = 10  # phrases of the evaluate_phrases process on the card (one probe batch)
PROBE_REL = 2e-4  # activation_stats card vs CPU, relative to each stage's largest magnitude
PSOLA_SESSIONS = 3  # 2 train sessions (6 windows: a step of 4), 1 validation session
PSOLA_SESSION_S = 60.0
PSOLA_BATCH = 4
# the ported kernels' function names in a trace of a float32 probs call:
# the stack's conv0 and its 3xTF32 conv1-conv4, K2's f32 cluster kernel,
# K4's 3xTF32 kernel
TRACE_KERNELS = {"conv_stack": ("conv_cn_relu_kernel", "conv_cn_relu_tf32x3_kernel"),
                 "gru_downsample": ("gru_ds_f32_cluster_kernel",), "flash_alibi": ("flash_alibi_tf32x3_kernel",)}
# phase 16 (f): one float32 probs call of the seed-0 VapConfig() model under
# utils/profiling.trace, in a process of its own (argv: batch .npy, trace dir)
TRACE_CHILD = """
import sys
import numpy as np
import torch
from voiceactivityprojection_tpu_torch import VapConfig, VapModel
from voiceactivityprojection_tpu_torch.utils import profiling
w = np.load(sys.argv[1])
model = VapModel(VapConfig(), device="cuda")
model.probs(w)
torch.cuda.synchronize()
with profiling.trace(sys.argv[2]):
    with profiling.span("probe_probs_call"):
        model.probs(w)
"""
def prosody_probe(state, smi, port, enc, per_forward, per_train_step, reset_counts, read_counts) -> dict:
    """Phase 16: the prosody probe on the card. (a) K2 at R=2 and R=20 (one
    and ten phrases, two channels each) at the corpus's frame count and an
    odd one, K4 at the phrase T at B=1 and B=10, against their plain
    versions. (b) ``PhraseProbe.extract_stats`` on the card in float32 and
    bfloat16 against the CPU port, its launches a batch and ms a batch; the
    mono model with its VAD history likewise. (c) One ``python -m
    voiceactivityprojection_tpu_torch.evaluate_phrases`` process on the card
    over the corpus with all seven permutations, its first phrases against
    the same CLI's ``main`` with ``--device cpu`` in this process; the
    process's wall s by stage. (d)
    ``forward(attention=True)`` at B=1 x 20 s float32 against the CPU port,
    its launches (no attention kernel), ms and peak memory. (e) A Trainer
    in ``pitch_mode="psola"`` with the probe at validation: one step's
    launches, the TD-PSOLA host ms a batch beside the vocoder's on the card,
    then one epoch and its ``val_p*`` scalars. (f) ``utils/profiling.trace``
    around one ``VapModel.probs`` call (the ported kernels and the
    ``profiling.span`` in the trace file) and ``activation_stats`` against
    the CPU. Returns the launches of each path."""
    import csv
    import glob
    import importlib.util
    import tempfile

    from voiceactivityprojection_tpu_torch.config import DataConfig, VapConfig, VapMonoConfig
    from voiceactivityprojection_tpu_torch.data import phrases as tph
    from voiceactivityprojection_tpu_torch.models import checkpoint as ckpt
    from voiceactivityprojection_tpu_torch.models.vap import VapModel, VapMonoModel
    from voiceactivityprojection_tpu_torch.ops.pitchshift import pitch_shift_semitones
    from voiceactivityprojection_tpu_torch.train import loop as tloop
    from voiceactivityprojection_tpu_torch.train import step as tstep
    from voiceactivityprojection_tpu_torch.utils import profiling

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "tests"))
    from _torch_phrases import write_phrase_corpus

    # matplotlib is absent on the card's machine: the phase plots nothing
    emit("probe_matplotlib", importable=importlib.util.find_spec("matplotlib") is not None,
         note="utils/plot imports it only when a figure is made; phase 16 makes none")
    build = os.path.join(root, "voiceactivityprojection_tpu_torch", "build")
    os.makedirs(build, exist_ok=True)
    no_launch = dict.fromkeys(read_counts(), 0)
    launches: dict = {}
    lap = {"t": time.perf_counter()}

    def seconds():
        """Seconds since the previous lap: each check's share of the phase."""
        now = time.perf_counter()
        dt, lap["t"] = now - lap["t"], now
        return dt

    with tempfile.TemporaryDirectory(dir=build) as tmp:
        f = lambda *name: os.path.join(tmp, *name)
        write_phrase_corpus(f("phrases"), n=PROBE_PHRASES, seed=16)
        dset = tph.PhraseDataset(root=f("phrases"))
        n = dset.n_samples
        gen = torch.Generator().manual_seed(16)

        # (a) K2 and K4 at the probe's shapes ------------------------------------
        # float32 whatever dtype an earlier phase left the encoder in
        lw = [tuple(t.to("cuda", torch.float32) for t in layer) for layer in
              ((l.conv.w, l.conv.b, l.norm.w, l.norm.b) for l in enc.gEncoder)]
        t100 = port["k1"].reference_stack(lw, torch.zeros(1, n, device="cuda")).shape[1]
        t50 = (t100 + 1) // 2
        shapes = []
        for dtype in (torch.float32, torch.bfloat16):
            for R in (2, 2 * PROBE_BATCH):
                for T in (t100, t100 + 1):  # the corpus's count and the other parity
                    gru_ds_case(port, enc, R, T, dtype, gen)
                    shapes.append(("gru_downsample", R, T, str(dtype)))
            for B in (1, PROBE_BATCH):
                attention_case(port, B, 4, t50, 64, dtype, gen)
                shapes.append(("flash_alibi", B, t50, str(dtype)))
        emit("probe_kernel_shapes", check="a", samples=n, t100=t100, t50=t50, cases=shapes, seconds=seconds())

        # (b) the probe on the card against the CPU port --------------------------
        conf = VapConfig()
        models = {"cpu": VapModel(conf, state, device="cpu"), "float32": VapModel(conf, state, device="cuda"),
                  "bfloat16": VapModel(VapConfig(dtype="bfloat16"), state, device="cuda")}

        def probe_run(probe, model, sink):
            base = probe._probs

            def counted(m, batch):
                reset_counts()
                out = base(m, batch)
                sink.append(read_counts())
                return out

            probe._probs = counted
            try:
                sync()
                t0 = time.perf_counter()
                means, stds = probe.extract_stats(model)
                sync()
                return means, stds, time.perf_counter() - t0
            finally:
                probe._probs = base

        probe = tph.PhraseProbe(root=f("phrases"), batch_size=PROBE_BATCH)
        n_batches = -(-len(probe.dset) // PROBE_BATCH)
        cpu_means, _, cpu_s = probe_run(probe, models["cpu"], [])
        means, ms_per_batch, per_batch = {}, {}, {}
        for dtype in ("float32", "bfloat16"):
            probe_run(probe, models[dtype], [])  # warm: the kernels' first calls
            per_batch[dtype] = []
            means[dtype], _, wall = probe_run(probe, models[dtype], per_batch[dtype])
            ms_per_batch[dtype] = 1e3 * wall / n_batches
            want = f32_gemms(per_forward, linear_per_forward(conf), dtype)
            check(len(per_batch[dtype]) == n_batches and all(c == want for c in per_batch[dtype]),
                  f"(b) probe {dtype}: launches per batch {per_batch[dtype]}, expected {want}")
        err32 = max(abs(means["float32"][k] - v) for k, v in cpu_means.items())
        err16 = max(abs(means["bfloat16"][k] - v) for k, v in means["float32"].items())
        check(set(means["float32"]) == set(cpu_means) == set(means["bfloat16"]), "(b) probe keys")
        # the mono model with its VAD history
        mconf = VapMonoConfig(va_history=True)
        mstate = ckpt.params_from_jax(ckpt.random_params_tree(mconf, seed=0), mconf)
        mprobe = tph.PhraseProbe(root=f("phrases"), batch_size=PROBE_BATCH, mono=True)
        mcpu, _, _ = probe_run(mprobe, VapMonoModel(mconf, mstate, device="cpu"), [])
        mono_model = VapMonoModel(mconf, mstate, device="cuda")
        probe_run(mprobe, mono_model, [])
        mono_batches = []
        mcard, _, mwall = probe_run(mprobe, mono_model, mono_batches)
        per_mono = dict(no_launch, conv_stack=5, gru_downsample=1, flash_alibi=mconf.channel_layers + mconf.cross_layers,
                        linear=linear_per_mono_forward(mconf))
        check(all(c == per_mono for c in mono_batches), f"(b) mono probe launches {mono_batches}, expected {per_mono}")
        mono_err = max(abs(mcard[k] - v) for k, v in mcpu.items())
        launches.update(probe_batch_float32=per_batch["float32"][0], probe_batch_bfloat16=per_batch["bfloat16"][0],
                        mono_probe_batch=mono_batches[0])
        emit("probe", check="b", phrases=len(probe.dset), batch=PROBE_BATCH, batches=n_batches, samples=n, frames=t50,
             ms_per_batch=ms_per_batch, cpu_s=cpu_s, launches_per_batch=per_batch,
             max_abs_err_vs_cpu_float32=err32, max_abs_err_bfloat16_vs_float32=err16, tol=(2e-4, 2e-3),
             mono={"va_history": True, "ms_per_batch": 1e3 * mwall / n_batches, "launches_per_batch": mono_batches,
                   "max_abs_err_vs_cpu": mono_err, "tol": 2e-4},
             val_log_stats=probe.val_log_stats(means["float32"]), seconds=seconds(), card=smi,
             note="host clock around extract_stats after a warm call, ending in the batch's copy to the host; "
                  "the WAVs are decoded once and cached")
        check(err32 <= 2e-4, f"(b) probe float32 vs CPU: {err32}")
        check(err16 <= 2e-3, f"(b) probe bfloat16 vs float32: {err16}")
        check(mono_err <= 2e-4, f"(b) mono probe vs CPU: {mono_err}")
        del mono_model
        torch.cuda.empty_cache()

        # (c) one evaluate_phrases process on the card, its head against the CPU --
        _save_reference(ckpt.export_vap_state_dict(state), f("w.pt"), legacy=False)
        common = ["--state_dict", f("w.pt"), "--phrases_root", f("phrases"), "--perm_cache", f("perm_cache")]
        procs = {}
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "voiceactivityprojection_tpu_torch.evaluate_phrases", *common,
                            "--out_dir", f("ep_card"), "--limit", str(PROBE_CLI_PHRASES)], cwd=root,
                           capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        check(r.returncode == 0, f"(c) evaluate_phrases card: exit {r.returncode}\n{r.stderr[-3000:]}")
        procs["card"] = {"wall_s": wall, "line": json.loads(r.stdout.strip().splitlines()[-1])}
        # the CPU's head through the CLI's main in this process (a second process only adds its start)
        from voiceactivityprojection_tpu_torch import evaluate_phrases as tevp

        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            tevp.main([*common, "--out_dir", f("ep_cpu"), "--device", "cpu", "--limit", str(PROBE_CLI_VS_CPU)])
        procs["cpu"] = {"wall_s": time.perf_counter() - t0, "line": json.loads(out.getvalue().strip().splitlines()[-1])}
        for name in procs:
            with open(f(f"ep_{name}", "phrases_scores.csv")) as fh:
                procs[name]["rows"] = list(csv.DictReader(fh))
        card_rows, cpu_rows = procs["card"]["rows"], procs["cpu"]["rows"]
        check(len(card_rows) == 7 * PROBE_CLI_PHRASES and len(cpu_rows) == 7 * PROBE_CLI_VS_CPU, "(c) rows")
        keys = ("phrase", "long_short", "gender", "phrase_idx", "permutation")
        cli_err = 0.0
        for a, b in zip(card_rows, cpu_rows):
            check(all(a[k] == b[k] for k in keys) and a.keys() == b.keys(), "(c) the same samples")
            for k in a.keys() - set(keys):
                if b[k] != "":
                    cli_err = max(cli_err, abs(float(a[k]) - float(b[k])))
        timings = procs["card"]["line"]["timings"]
        emit("evaluate_phrases_cli", check="c", phrases=PROBE_CLI_PHRASES, permutations=7, rows=len(card_rows),
             wall_s=procs["card"]["wall_s"], stages_s=timings,
             outside_stages_s=procs["card"]["wall_s"] - sum(timings.values()), device=procs["card"]["line"]["device"],
             cpu_in_process={"phrases": PROBE_CLI_VS_CPU, "wall_s": procs["cpu"]["wall_s"],
                             "stages_s": procs["cpu"]["line"]["timings"]},
             max_abs_err_vs_cpu=cli_err, tol=2e-4, seconds=seconds(), card=smi,
             note="host DSP is the seven permutations' numpy (the card process fills the permutation cache, the "
                  "CPU run, the CLI's main in this process, reads it); outside_stages_s is the interpreter, torch "
                  "and CUDA start")
        check(cli_err <= 2e-4, f"(c) evaluate_phrases card vs CPU: {cli_err}")

        # (d) the attention weights of one 20 s forward --------------------------
        w20 = (0.1 * np.random.default_rng(16).standard_normal((1, 2, int(CHUNK_S * SR)))).astype(np.float32)
        m32 = models["float32"]
        m32.forward(w20, attention=True)  # warm
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        sync()
        t0 = time.perf_counter()
        got = m32.forward(w20, attention=True)
        sync()
        first_ms = 1e3 * (time.perf_counter() - t0)
        launches["attention_weights_call"] = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        call_ms = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            m32.forward(w20, attention=True)
            sync()
            call_ms.append(1e3 * (time.perf_counter() - t0))
        want = models["cpu"].forward(w20, attention=True)
        weights_err = {k: max_err(got[k].cpu(), want[k]) for k in ("self_attn", "cross_attn", "cross_self_attn",
                                                                   "logits")}
        rows_sum = max(float((got[k].sum(-1) - 1).abs().max()) for k in ("self_attn", "cross_attn"))
        want_launch = dict(no_launch, conv_stack=5, gru_downsample=1, linear=linear_per_forward(conf))
        emit("attention_weights", check="d", batch=1, chunk_s=CHUNK_S, dtype="float32",
             shapes={k: list(got[k].shape) for k in ("self_attn", "cross_attn", "cross_self_attn")},
             launches=launches["attention_weights_call"], ms=[first_ms] + call_ms, peak_memory_gb=peak_gb,
             max_abs_err_vs_cpu=weights_err, tol=2e-4, rows_sum_to_one_max_err=rows_sum, seconds=seconds(),
             card=smi, note="host clock around forward(attention=True) ending in a synchronize; dense attention "
                            "(the weights are materialised), so no attention kernel runs")
        check(launches["attention_weights_call"] == want_launch,
              f"(d) attention weights launches {launches['attention_weights_call']}, expected {want_launch}")
        for k, e in weights_err.items():
            check(e <= 2e-4, f"(d) {k} card vs CPU: {e}")
        del got, want
        torch.cuda.empty_cache()

        # (e) the psola Trainer, with the probe at validation ---------------------
        subprocess.run([sys.executable, os.path.join(root, "examples", "make_synthetic_corpus.py"), "--out",
                        f("dialogs"), "--n", str(PSOLA_SESSIONS), "--duration", str(PSOLA_SESSION_S)],
                       check=True, capture_output=True, timeout=300)
        data = DataConfig(train_path=f("dialogs", "train.csv"), val_path=f("dialogs", "val.csv"),
                          batch_size=PSOLA_BATCH, pitch_mode="psola", augment_probability=1.0, phrases_probe=1,
                          phrases_root=f("phrases"))
        conf16 = VapConfig(dtype="bfloat16")
        trainer = tloop.Trainer(model_conf=conf16, data_conf=data, max_epochs=1, seed=1, out_dir=f("psola_step"),
                                device="cuda")
        train_loader, _ = trainer.make_loaders()
        net = trainer.init_net()
        st = tstep.TrainState(net, trainer._optimizer(net))
        batch = next(iter(train_loader))
        psola_ms = []
        for semis in (2.0,):
            t0 = time.perf_counter()
            shifted = trainer.augment.apply_pitch_host(batch["waveform"], semis)
            psola_ms.append(1e3 * (time.perf_counter() - t0))
        reset_counts()
        prepared = trainer._to_device(dict(batch, waveform=shifted))
        st, m = trainer.train_step(st, prepared, trainer.seed + 1, 0)
        sync()
        launches["psola_train_step"] = read_counts()
        check(math.isfinite(float(m["loss"])), "(e) psola step loss finite")
        x = torch.from_numpy(np.ascontiguousarray(batch["waveform"])).cuda()
        vocoder_ms = cuda_ms(lambda: pitch_shift_semitones(x, 2), reps=3, warmup=1)
        del trainer, net, st, prepared, x
        torch.cuda.empty_cache()
        trainer = tloop.Trainer(model_conf=conf16, data_conf=data, max_epochs=1, seed=1, out_dir=f("psola_fit"),
                                device="cuda")
        pitched = []
        real = trainer.augment.apply_pitch_host
        trainer.augment.apply_pitch_host = lambda w, s: pitched.append(s) or real(w, s)
        t0 = time.perf_counter()
        trainer.fit()
        sync()
        fit_s = time.perf_counter() - t0
        with open(os.path.join(trainer.out_dir, "metrics.jsonl")) as fh:
            row = json.loads(fh.readline())
        probe_scalars = {k: row.get(k) for k in ("val_ps_hold", "val_ps_pred", "val_ps_react", "val_pl_hold",
                                                  "val_pl_pred", "val_pl_react", "val_pls_hold", "val_pls_pred",
                                                  "val_pls_react")}
        emit("psola_trainer", check="e", batch=PSOLA_BATCH, chunk_s=CHUNK_S, dtype="bfloat16",
             launches_per_step=launches["psola_train_step"], psola_host_ms_per_batch=psola_ms,
             vocoder_ms_per_batch=vocoder_ms, epoch=row, pitched_steps=len(pitched), fit_s=fit_s,
             probe_scalars=probe_scalars, seconds=seconds(), card=smi,
             note="psola: host clock of Augmentation.apply_pitch_host on one B=4 x 20 s stereo batch (8 channels, "
                  "numpy); vocoder: CUDA events of ops/pitchshift on the same batch on the card")
        check(launches["psola_train_step"] == per_train_step,
              f"(e) psola step launches {launches['psola_train_step']}, expected {per_train_step}")
        check(all(v is not None and math.isfinite(v) for v in probe_scalars.values()),
              f"(e) val_p* present and finite: {probe_scalars}")
        check(math.isfinite(row["loss"]) and pitched, "(e) the epoch ran and shifted pitch")
        del trainer
        torch.cuda.empty_cache()

        # (f) a trace around one probs call, activation statistics ----------------
        # F5: in a process that has run many profiler sessions, the profiler
        # itself loses kernel records (tools/trace_sessions.py: one K1 of 5
        # after 16-20 sessions, once every kernel of a trace, PyTorch's own
        # too, with or without a synchronize around the window and with the
        # kernel libraries on PyTorch's shared CUDA runtime). So the trace
        # this phase holds to K1, K2 and K4 runs in a process of its own; one
        # in this process, after phases 1-15, is recorded beside it.
        def kernels_in(trace_dir):
            files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
            check(len(files) == 1, f"(f) one trace file: {files}")
            with open(files[0]) as fh:
                names = {e.get("name", "") for e in json.load(fh).get("traceEvents", [])}
            return files[0], names, {k: all(any(v in nm for nm in names) for v in vs) for k, vs in TRACE_KERNELS.items()}

        batch_w = next(dset.batches(PROBE_BATCH))["waveform"]
        m32.probs(batch_w)  # warm at this shape
        with profiling.trace(f("trace_here")):
            with profiling.span("probe_probs_call"):
                m32.probs(batch_w)
        _, _, found_here = kernels_in(f("trace_here"))
        np.save(f("batch.npy"), batch_w)
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", TRACE_CHILD, f("batch.npy"), f("trace")], cwd=root,
                           capture_output=True, text=True, timeout=300)
        trace_process_s = time.perf_counter() - t0
        check(r.returncode == 0, f"(f) trace process: exit {r.returncode}\n{r.stderr[-3000:]}")
        trace_file, names, found = kernels_in(f("trace"))
        span = "probe_probs_call" in names
        one = batch_w[:1]
        act_card = profiling.activation_stats(m32, one)
        act_cpu = profiling.activation_stats(models["cpu"], one)
        act_err = {k: max(abs(act_card[k][s] - act_cpu[k][s]) / max(act_cpu[k]["absmax"], 1e-30)
                          for s in ("mean", "std", "absmax")) for k in act_cpu}
        emit("profiling_trace", check="f", trace_bytes=os.path.getsize(trace_file), events=len(names),
             traced_in="a process of its own (F5: the profiler loses records late in a long process)",
             trace_process_s=trace_process_s, kernels_in_trace_in_this_process=found_here,
             kernels_in_trace=found, span_in_trace=span, activation_rel_err_vs_cpu=act_err, tol=PROBE_REL,
             seconds=seconds(), card=smi)
        check(all(found.values()) and span, f"(f) the trace names the kernels {found} and the span {span}")
        for k, e in act_err.items():
            check(e <= PROBE_REL, f"(f) activation_stats {k} card vs CPU: {e}")
    del models
    torch.cuda.empty_cache()
    return launches


# data and tensor parallelism (phase 17): two processes share the one card
# over gloo (NCCL takes one rank a card), at VapConfig() widths
PAR_RANKS = 2
PAR_DP_BATCH = 16  # B=16 x 20 s, split 8 + 8
PAR_TP_BATCH = 8
PAR_RATE = 0.1
PAR_TIMEOUT_S = 600.0
# the tensor-parallel forward against the unsharded forward on the card:
# the JAX package's bar in float32, the bf16 bar of phase 4 in bfloat16
TP_FWD_TOL = {"float32": 2e-4, "bfloat16": 2e-3}
# data-parallel steps against one process on the card: float32 at the
# card's step bars (TRAIN_VS_CPU_TOL); bfloat16 at the bf16 step bars of
# tests/test_torch_train.py (losses 1e-3, gradients 0.1 of a leaf's
# largest), since a batch of 8 rows and one of 16 round the bf16
# activations at other places, and the weights after two AdamW steps within
# 1e-5 (3 % of one step at lr 3.63e-4) where the gradient is clear of that
# bound (CPU rehearsal at a narrow width: 2.4e-6, 2.2e-2, 2.0e-6)
PAR_STEP_TOL = {"float32": TRAIN_VS_CPU_TOL, "bfloat16": {"loss": 1e-3, "grad_rel": 0.1, "update": 1e-5}}
PAR_CLI_SESSIONS, PAR_CLI_SESSION_S, PAR_CLI_BATCH = 4, 60.0, 4


def linear_per_forward(conf) -> int:
    """K13's GEMMs in one float32 stereo forward: q/k/v, output projection
    and the FFN's two a channel layer and channel; q/k/v, projection, cross
    q, cross k/v, projection and the FFN's two a cross layer and side; the
    combinator's two. A train step takes three times as many (forward, dX,
    dW); bfloat16 takes none (``torch.matmul``)."""
    return 4 * 2 * conf.channel_layers + 7 * 2 * conf.cross_layers + 2


def linear_per_mono_forward(conf) -> int:
    """K13's GEMMs in one float32 mono forward: q/k/v, output projection
    and the FFN's two a layer of either GPT (no cross-attention)."""
    return 4 * (conf.channel_layers + conf.cross_layers)


def linear_per_cp_call(conf, shards: int) -> int:
    """K13's GEMMs in one float32 ``forward_context_parallel`` call: on each
    shard k/v, q and the output projection an attention site (three), the
    FFN's two, the combinator's two."""
    return shards * (2 * 5 * conf.channel_layers + 2 * 8 * conf.cross_layers + 2)


def f32_gemms(per: dict, gemms: int, dtype="float32") -> dict:
    """``per`` with K13's GEMMs of a run in ``dtype``: ``gemms`` in
    float32, none in bfloat16."""
    return dict(per, linear=gemms if str(dtype).replace("torch.", "") == "float32" else 0)


def linear_weight_groups(conf) -> int:
    """The weight groups K13 splits (each once a weight version): the same
    as a forward's GEMMs, with the two channels' and the two sides'
    weights shared."""
    return 4 * conf.channel_layers + 7 * conf.cross_layers + 2


def parallel_rank(tmp: str) -> int:
    """One rank of phase 17 (``chip_smoke.py --parallel-rank DIR``, started
    by ``parallel.mesh.spawn_local``): (a) data parallelism, rows [8r, 8r +
    8) of the B=16 batch: two f32 and two bf16 frozen steps at dropout 0, a
    bf16 step at 0.1 recording its attention seeds, an unfrozen f32 step;
    (b) tensor parallelism, 2 of the 4 heads and half of each FFN: the f32
    and bf16 forward at B=8 and an f32 frozen step at dropout 0. Writes its
    launches, ms, metrics, weights and gradients to ``DIR/rank<r>.pt``."""
    import torch.distributed as dist

    from voiceactivityprojection_tpu_torch.config import OptConfig, VapConfig
    from voiceactivityprojection_tpu_torch.models import checkpoint as ckpt
    from voiceactivityprojection_tpu_torch.models.vap import VapNet, forward
    from voiceactivityprojection_tpu_torch.ops import attention as attn
    from voiceactivityprojection_tpu_torch.ops.codebook import get_probs
    from voiceactivityprojection_tpu_torch.parallel.mesh import ProcessLayout, init_distributed, make_mesh, shard_batch
    from voiceactivityprojection_tpu_torch.parallel.tp import shard_params_tp
    from voiceactivityprojection_tpu_torch.train import step as tstep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed("cuda", backend="gloo", timeout_s=PAR_TIMEOUT_S)
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=True)
    state = ckpt.params_from_jax(ckpt.random_params_tree(VapConfig(), seed=0), VapConfig())
    seeds: list = []
    real = attn.flash_alibi_attention_train
    attn.flash_alibi_attention_train = lambda q, k, v, m, seed, *a: seeds.append(seed) or real(q, k, v, m, seed, *a)

    def net_of(conf):
        net = VapNet(conf)
        net.load_state_dict(state)
        return net.cuda()

    def run(fn):
        """fn's result, its ms on the host clock and the launches it made."""
        before = _build.launch_counts()
        sync()
        t0 = time.perf_counter()
        r = fn()
        sync()
        return r, (time.perf_counter() - t0) * 1e3, _build.launch_totals(_build.launches_since(before))

    def weights(net):
        return ({k: p.detach().cpu() for k, p in net.named_parameters()},
                {k: p.grad.cpu() for k, p in net.named_parameters() if p.grad is not None})

    out = {"rank": dist.get_rank()}
    layout = ProcessLayout()
    local = {k: v.cuda() for k, v in shard_batch(inputs["dp"], layout).items()}
    for name, conf, steps in (("dp_f32", VapConfig(dropout=0.0), 2),
                              ("dp_bf16", VapConfig(dtype="bfloat16", dropout=0.0), 2),
                              ("dp_unfrozen_f32", VapConfig(dropout=0.0, freeze_encoder=False), 1),
                              ("dp_bf16_rate", VapConfig(dtype="bfloat16", dropout=PAR_RATE), 1)):
        net = net_of(conf)
        step = tstep.make_train_step(conf, tstep.make_optimizer(OptConfig(), net, conf.freeze_encoder), layout)
        seeds.clear()
        rec = {"ms": [], "metrics": [], "launches": [], "step_grads": []}
        for i in range(steps):
            m, ms, counts = run(lambda: {k: float(v) for k, v in step(net, local, torch.Generator().manual_seed(i)).items()})
            rec["ms"].append(ms)
            rec["metrics"].append(m)
            rec["launches"].append(counts)
            if conf.dropout == 0.0:
                rec["step_grads"].append(weights(net)[1])
        rec["seeds"] = list(seeds)
        if conf.dropout == 0.0:
            rec["params"], rec["grads"] = weights(net)
        out[name] = rec
        del net, step
        torch.cuda.empty_cache()

    tp = make_mesh(n_data=1, n_model=PAR_RANKS)
    wave = inputs["tp"]["waveform"].cuda()
    for dtype in ("float32", "bfloat16"):
        conf = VapConfig(dtype=dtype)
        net = shard_params_tp(net_of(VapConfig()), tp.model_rank, PAR_RANKS, tp.model_group)
        with torch.no_grad():
            forward(net, wave, conf)  # warm-up
            o, ms, counts = run(lambda: forward(net, wave, conf))
            probs = get_probs(o["logits"])
        out[f"tp_forward_{dtype}"] = {"ms": ms, "launches": counts,
                                      **{k: probs[k].cpu() for k in ("p_now", "p_future")}}
        del net, o
    conf = VapConfig(dropout=0.0)
    net = shard_params_tp(net_of(conf), tp.model_rank, PAR_RANKS, tp.model_group)
    step = tstep.make_train_step(conf, tstep.make_optimizer(OptConfig(), net, True))
    tb = {k: v.cuda() for k, v in inputs["tp"].items()}
    m, ms, counts = run(lambda: {k: float(v) for k, v in step(net, tb, torch.Generator().manual_seed(0)).items()})
    out["tp_step_f32"] = {"ms": [ms], "metrics": [m], "launches": [counts]}
    out["tp_step_f32"]["params"], out["tp_step_f32"]["grads"] = weights(net)
    torch.save(out, os.path.join(tmp, f"rank{dist.get_rank()}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


class _Leaf:
    """A weight and its gradient as ``grads_vs_cpu`` reads a parameter."""

    def __init__(self, value, grad):
        self.value, self.grad = value, grad

    def detach(self):
        return self.value


def parallel_training(state, smi, per_forward, per_train_step, per_unfrozen_step) -> dict:
    """Phase 17: data and tensor parallelism over two processes on the card
    (``parallel_rank``), each held against one process on the card: (a)
    data parallel steps (f32 and bf16 weights after two frozen steps at
    dropout 0 at the card's step bars, one unfrozen step likewise; at
    dropout 0.1 every attention site's mask rows against the plain
    ``keep_mask`` of the global batch); (b) tensor parallel forward (f32 2e-4,
    bf16 2e-3 on p_now / p_future) and an f32 frozen step against the
    unsharded ones; (c) one ``train`` process under ``torchrun
    --nproc_per_node 1`` (NCCL, world size 1) for one epoch; (d)
    ``tools/dryrun_multichip --n 2 --device cuda``. Returns each path's
    launches a step or a call."""
    import tempfile

    from voiceactivityprojection_tpu_torch.config import OptConfig, VapConfig
    from voiceactivityprojection_tpu_torch.models.vap import VapNet, forward
    from voiceactivityprojection_tpu_torch.ops import attention as attn
    from voiceactivityprojection_tpu_torch.ops.codebook import get_probs
    from voiceactivityprojection_tpu_torch.ops.flash_alibi_train import keep_mask
    from voiceactivityprojection_tpu_torch.parallel.mesh import spawn_local
    from voiceactivityprojection_tpu_torch.parallel.tp import shard_params_tp
    from voiceactivityprojection_tpu_torch.train import step as tstep

    root = os.path.dirname(os.path.abspath(__file__))
    build = os.path.join(root, "voiceactivityprojection_tpu_torch", "build")
    os.makedirs(build, exist_ok=True)
    sites = 2 * VapConfig().channel_layers + 4 * VapConfig().cross_layers
    rng = np.random.default_rng(17)
    n20, n_vad = int(CHUNK_S * SR), int((CHUNK_S + 2) * 50)
    batch = {"waveform": torch.from_numpy((0.1 * rng.standard_normal((PAR_DP_BATCH, 2, n20))).astype(np.float32)),
             "vad": torch.from_numpy((rng.random((PAR_DP_BATCH, n_vad, 2)) < 0.5).astype(np.float32))}
    tp_batch = {k: v[:PAR_TP_BATCH].clone() for k, v in batch.items()}
    launches: dict = {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        torch.save({"dp": batch, "tp": tp_batch}, os.path.join(tmp, "inputs.pt"))
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rc = spawn_local([sys.executable, os.path.abspath(__file__), "--parallel-rank", tmp], PAR_RANKS,
                         timeout_s=PAR_TIMEOUT_S)
        ranks_s = time.perf_counter() - t0
        check(rc == 0, f"phase 17 ranks: exit {rc}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True) for r in range(PAR_RANKS)]

    # one process on the card, the same steps on the whole batch
    seeds: list = []
    real = attn.flash_alibi_attention_train
    attn.flash_alibi_attention_train = lambda q, k, v, m, seed, *a: seeds.append(seed) or real(q, k, v, m, seed, *a)
    try:
        def net_of(conf):
            net = VapNet(conf)
            net.load_state_dict(state)
            return net.cuda()

        # (a) data parallelism
        whole = {k: v.cuda() for k, v in batch.items()}
        for name, conf, steps in (("dp_f32", VapConfig(dropout=0.0), 2),
                                  ("dp_bf16", VapConfig(dtype="bfloat16", dropout=0.0), 2),
                                  ("dp_unfrozen_f32", VapConfig(dropout=0.0, freeze_encoder=False), 1),
                                  ("dp_bf16_rate", VapConfig(dtype="bfloat16", dropout=PAR_RATE), 1)):
            net = net_of(conf)
            step = tstep.make_train_step(conf, tstep.make_optimizer(OptConfig(), net, conf.freeze_encoder))
            seeds.clear()
            ms, step_grads = [], []
            for i in range(steps):
                sync()
                t0 = time.perf_counter()
                m = {k: float(v) for k, v in step(net, whole, torch.Generator().manual_seed(i)).items()}
                ms.append((time.perf_counter() - t0) * 1e3)
                step_grads.append({k: p.grad.cpu() for k, p in net.named_parameters() if p.grad is not None})
            want_counts = f32_gemms(per_unfrozen_step if not conf.freeze_encoder else per_train_step,
                                    3 * linear_per_forward(conf), conf.dtype)
            for r in ranks:
                for c in r[name]["launches"]:
                    check(c == want_counts, f"(a) {name} rank {r['rank']}: launches {c}, expected {want_counts}")
                check(all(math.isfinite(v) for mm in r[name]["metrics"] for v in mm.values()), f"(a) {name} finite")
            line = {"check": "a", "path": name, "batch": PAR_DP_BATCH, "ranks": PAR_RANKS, "backend": "gloo",
                    "ms_per_step_ranks": [r[name]["ms"] for r in ranks], "ms_per_step_one_process": ms,
                    "launches_per_step": ranks[0][name]["launches"][-1], "card": smi}
            if conf.dropout == 0.0:
                tol = PAR_STEP_TOL[conf.dtype]
                errs = []
                for r in ranks:
                    pairs = [(k, _Leaf(p.detach().cpu(), p.grad.cpu()), _Leaf(r[name]["params"][k], r[name]["grads"][k]))
                             for k, p in net.named_parameters() if p.grad is not None]
                    check({k for k, *_ in pairs} == set(r[name]["grads"]), f"(a) {name}: the trained weights")
                    errs.append(grads_vs_cpu(pairs, m, r[name]["metrics"][-1], m, tol, step_grads))
                    # every step's gradients, not only the last one's
                    for i, g in enumerate(step_grads[:-1]):
                        errs[-1][f"grad_rel_step{i + 1}"] = max(
                            float((r[name]["step_grads"][i][k] - g[k]).abs().max()) / max(float(g[k].abs().max()),
                                                                                           1e-30) for k in g)
                line.update(max_err_vs_one_process=errs, tol=tol)
                emit("parallel_dp", **line)
                for e in errs:
                    for k, v in e.items():
                        bar = tol["grad_rel" if k.startswith("grad_rel") else k]
                        check(v <= bar, f"(a) {name} two ranks vs one process {k}: {v} > {bar}")
            else:
                # every site's mask rows: the rank's (its seeds) against the global batch's
                b = PAR_DP_BATCH // PAR_RANKS
                T = n20 // 320
                H = conf.num_heads
                check(all(len(r[name]["seeds"]) == len(seeds) == sites for r in ranks),
                      f"(a) attention seeds {[len(r[name]['seeds']) for r in ranks]}, one process {len(seeds)}")
                equal = []
                for site, s1 in enumerate(seeds):
                    full = keep_mask(PAR_DP_BATCH, H, T, s1, PAR_RATE, "cuda")
                    equal.append(all(bool(torch.equal(keep_mask(b, H, T, r[name]["seeds"][site], PAR_RATE, "cuda"),
                                                      full[r["rank"] * b:(r["rank"] + 1) * b])) for r in ranks))
                    del full
                line.update(sites=sites, masks_equal_global_rows=equal,
                            loss_ranks=[r[name]["metrics"][-1]["loss"] for r in ranks], loss_one_process=m["loss"],
                            note="elementwise masks fold the data rank: the losses differ from one process")
                emit("parallel_dp", **line)
                check(all(equal), f"(a) attention mask rows at rate {PAR_RATE}: {equal}")
            launches[name] = ranks[0][name]["launches"][-1]
            del net, step
            torch.cuda.empty_cache()

        # (b) tensor parallelism
        wave = tp_batch["waveform"].cuda()
        for dtype in ("float32", "bfloat16"):
            conf = VapConfig(dtype=dtype)
            with torch.no_grad():
                probs = get_probs(forward(net_of(VapConfig()), wave, conf)["logits"])
            name = f"tp_forward_{dtype}"
            err = [{k: max_err(r[name][k], probs[k].cpu()) for k in ("p_now", "p_future")} for r in ranks]
            emit("parallel_tp", check="b", path=name, batch=PAR_TP_BATCH, heads_per_rank=conf.num_heads // PAR_RANKS,
                 ms_ranks=[r[name]["ms"] for r in ranks], launches=ranks[0][name]["launches"],
                 max_abs_err_vs_unsharded=err, tol=TP_FWD_TOL[dtype], card=smi)
            for r, e in zip(ranks, err):
                want = f32_gemms(per_forward, linear_per_forward(conf), dtype)
                check(r[name]["launches"] == want, f"(b) {name} rank {r['rank']}: {r[name]['launches']}, "
                      f"expected {want}")
                check(max(e.values()) <= TP_FWD_TOL[dtype], f"(b) {name} rank {r['rank']} vs unsharded: {e}")
            launches[name] = ranks[0][name]["launches"]
        conf = VapConfig(dropout=0.0)
        net = net_of(conf)
        step = tstep.make_train_step(conf, tstep.make_optimizer(OptConfig(), net, True))
        tb = {k: v.cuda() for k, v in tp_batch.items()}
        sync()
        t0 = time.perf_counter()
        m = {k: float(v) for k, v in step(net, tb, torch.Generator().manual_seed(0)).items()}
        ms1 = (time.perf_counter() - t0) * 1e3
        want_p = {k: p.detach().cpu() for k, p in net.named_parameters()}
        errs = []
        for r in ranks:
            ref_p = shard_params_tp(want_p, r["rank"], PAR_RANKS)
            ref_g = shard_params_tp({k: p.grad.cpu() for k, p in net.named_parameters() if p.grad is not None},
                                    r["rank"], PAR_RANKS)
            got = r["tp_step_f32"]
            check(set(ref_g) == set(got["grads"]), "(b) tp step: the trained weights")
            pairs = [(k, _Leaf(ref_p[k], ref_g[k]), _Leaf(got["params"][k], got["grads"][k])) for k in ref_g]
            errs.append(grads_vs_cpu(pairs, m, got["metrics"][0], m))
            want = f32_gemms(per_train_step, 3 * linear_per_forward(VapConfig()))
            check(got["launches"][0] == want, f"(b) tp step rank {r['rank']}: {got['launches'][0]}, expected {want}")
        emit("parallel_tp", check="b", path="tp_step_f32", batch=PAR_TP_BATCH, heads_per_rank=2,
             ms_ranks=[r["tp_step_f32"]["ms"] for r in ranks], ms_one_process=ms1,
             launches=ranks[0]["tp_step_f32"]["launches"][0], max_err_vs_unsharded=errs, tol=TRAIN_VS_CPU_TOL,
             ranks_s=ranks_s, card=smi)
        for e in errs:
            for k, bar in TRAIN_VS_CPU_TOL.items():
                check(e[k] <= bar, f"(b) tp step vs unsharded {k}: {e[k]} > {bar}")
        launches["tp_step_f32"] = ranks[0]["tp_step_f32"]["launches"][0]
        del net, step
        torch.cuda.empty_cache()
    finally:
        attn.flash_alibi_attention_train = real

    # (c) the train CLI under torchrun, NCCL at world size 1
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        subprocess.run([sys.executable, os.path.join(root, "examples", "make_synthetic_corpus.py"), "--out",
                        os.path.join(tmp, "corpus"), "--n", str(PAR_CLI_SESSIONS), "--duration",
                        str(PAR_CLI_SESSION_S)], check=True, capture_output=True, timeout=300)
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
                            "-m", "voiceactivityprojection_tpu_torch.train", "--max_epochs", "1", "--limit_batches",
                            "2", "--out_dir", os.path.join(tmp, "runs"), "--vap_dtype", "bfloat16",
                            "--data_batch_size", str(PAR_CLI_BATCH), "--data_train_path",
                            os.path.join(tmp, "corpus", "train.csv"), "--data_val_path",
                            os.path.join(tmp, "corpus", "val.csv"), "--data_phrases_probe", "0"],
                           cwd=root, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        check(r.returncode == 0, f"(c) torchrun train: exit {r.returncode}\n{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
        with open(os.path.join(tmp, "runs", "VapGPT_50Hz_ad20s_134", "metrics.jsonl")) as fh:
            rows = [json.loads(line) for line in fh]
        emit("parallel_torchrun", check="c", process_s=cli_s, epochs=rows, batch=PAR_CLI_BATCH,
             ranked="(rank 0 of 1)" in r.stdout, card=smi)
        check(len(rows) == 1 and math.isfinite(rows[0]["loss"]) and "(rank 0 of 1)" in r.stdout,
              f"(c) one epoch over one NCCL rank: {rows}")

    # (d) the dryrun tool over two ranks on the card
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "voiceactivityprojection_tpu_torch.tools.dryrun_multichip", "--n",
                        str(PAR_RANKS), "--device", "cuda"], cwd=root, capture_output=True, text=True, timeout=600)
    check(r.returncode == 0, f"(d) dryrun: exit {r.returncode}\n{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
    report = json.loads([line for line in r.stdout.splitlines() if line.startswith("{")][-1])
    emit("parallel_dryrun", check="d", process_s=time.perf_counter() - t0, **report, card=smi)
    check(report["dryrun_multichip"] == "ok" and report["grad_max_diff"] < report["grad_tol"], f"(d) dryrun {report}")
    return launches


SOAK_KV_HOPS = 1050  # 21 s of live 20 ms hops: past the 1,000-frame context of VapConfig()
SOAK_WINDOW_HOPS = 75
SOAK_BATCHED_HOPS = 75
SOAK_BATCHED_STREAMS = 64
SOAK_UNPACED_HOPS = 100  # the paced kv soak's first hops, run again without pacing
SOAK_PACED_TOL = 1e-6
CHURN_STREAMS, CHURN_DURATION_S, CHURN_HOP_FRAMES = 16, 8.0, 2
# sessions of 3-10 s (the tool's CLI: 8-30 s), so that slots are recycled
# within the 8 s and the soak ends a session's life after them
CHURN_SESSION_S = (3.0, 10.0)
# a tick waits up to 2.5 hops for the cohort, so that a client back on its
# clock after a burst is not advanced with silence (the tool's --max_wait_ms
# advice for underrun-free sessions); a vanished client's slot is reclaimed
# after 5 s of silence
CHURN_MAX_WAIT_MS, CHURN_SESSION_TIMEOUT_S = 100.0, 5.0
CHURN_CHECK_SESSIONS = 1  # eligible sessions replayed solo (a replay is about 8 s of 1-hop pushes)
PROFILE_ITERS = 3  # profile_train_step --iters (frozen and unfrozen --deep)
PROFILE_FUSED_ITERS = 2  # the unfrozen step under VAP_CONV_IMPL=fused_stack
MPG_SECONDS = 1.0  # model_params_grad --seconds
MPG_REL = 2e-4  # card vs CPU, float32: relative to each leaf's largest magnitude
LABEL_SESSIONS, LABEL_SESSION_S, LABEL_WINDOW_S = 4, 30.0, 10.0
REHEARSAL_PROCS, REHEARSAL_STEPS = (1, 2), 2


def _stage_lines(records: dict) -> dict:
    """A profile tool's stages as {name: ms, launches, TFLOP/s, peak share}."""
    return {k: {f: v[f] for f in ("ms", "launches", "tflops", "peak_pct") if f in v} for k, v in records.items()}


def _stats_vs_cpu(card: dict, cpu: dict, raw: list, rel: float) -> dict:
    """model_params_grad's statistics on the card against the CPU's: the
    largest difference of mean, std, min and max (the outer bin edges) and
    of the largest magnitude, relative to each leaf's largest magnitude, and
    the histogram counts moved against the card's values within that bar of
    a bin edge (each such value may fall on either side)."""
    worst, moved_over, values = 0.0, [], iter(raw)
    for part in ("params", "activations", "gradients"):
        check(list(card[part]) == list(cpu[part]), f"(e) {part}: the same leaves")
        for k, c in card[part].items():
            w, x = cpu[part][k], next(values)
            scale = max(abs(w["absmax"]), 1e-30)
            stats = [(c["mean"], w["mean"]), (c["std"], w["std"]), (c["absmax"], w["absmax"]),
                     (c["bin_edges"][0], w["bin_edges"][0]), (c["bin_edges"][-1], w["bin_edges"][-1])]
            worst = max(worst, max(abs(a - b) for a, b in stats) / scale)
            edges = np.asarray(w["bin_edges"])
            near = int((np.abs(x[:, None] - edges[None, :]) <= rel * scale).sum())
            moved = int(np.abs(np.asarray(c["hist"]) - np.asarray(w["hist"])).sum())
            if moved > 2 * near:
                moved_over.append((part, k, moved, near))
    return {"max_rel_diff": worst, "hist_moved_past_edges": moved_over}


def scripts_beside(state, smi, per_forward, per_train_step, per_unfrozen_step, reset_counts, read_counts) -> dict:
    """Phase 18: the package's tools beside it, each through its function in
    this process. (a) ``tools/soak_sds.py`` at live 20 ms pacing: kv mode
    for 1,050 hops (past the 1,000-frame fill), window mode for 75, a
    ``BatchedKVStreamer`` of 64 dialogs for 75 ticks; the kv soak's first
    100 paced hops against an unpaced run over the same audio (1e-6). (b)
    ``tools/soak_churn.py`` over real ZMQ, 16 slots for 8 s of churn
    (sessions of 3-10 s) in 40 ms hops at live pace, with the solo replay
    of one eligible session.
    (c) ``tools/profile_stages.py`` at B=64 x 20 s bfloat16. (d)
    ``tools/profile_train_step.py`` at B=16 x 20 s bfloat16: ``--deep``
    frozen, ``--unfrozen --deep``, and the unfrozen step under
    ``VAP_CONV_IMPL=fused_stack``. (e) ``analyzes/model_params_grad.py``
    on the card against the CPU, and ``analyzes/label_frequency.py`` on a
    synthetic corpus, card and CPU counts equal. (f)
    ``tools/multihost_rehearsal.py`` with one process and two sharing the
    card over gloo. Launches read around each path; returns them."""
    import importlib.util
    import tempfile

    from voiceactivityprojection_tpu_torch.analyzes import label_frequency, model_params_grad
    from voiceactivityprojection_tpu_torch.config import VapConfig
    from voiceactivityprojection_tpu_torch.models.vap import VapModel
    from voiceactivityprojection_tpu_torch.tools import multihost_rehearsal, profile_stages, profile_train_step
    from voiceactivityprojection_tpu_torch.tools import soak_churn, soak_sds
    from voiceactivityprojection_tpu_torch.utils import profiling

    root = os.path.dirname(os.path.abspath(__file__))
    build = os.path.join(root, "voiceactivityprojection_tpu_torch", "build")
    os.makedirs(build, exist_ok=True)
    no_launch = dict.fromkeys(read_counts(), 0)
    launches: dict = {}
    lap = {"t": time.perf_counter()}

    def seconds():
        """Seconds since the previous lap: each check's share of the phase."""
        now = time.perf_counter()
        dt, lap["t"] = now - lap["t"], now
        return dt

    def expect(counts: dict, what: str, **nonzero) -> None:
        want = dict(no_launch, **nonzero)
        check(counts == want, f"{what}: launches {counts}, expected {want}")

    def around(fn):
        """fn()'s result and the launches it made."""
        reset_counts()
        out = fn()
        sync()
        return out, read_counts()

    conf = VapConfig()
    sites = 2 * conf.channel_layers + 4 * conf.cross_layers
    kv_rows = conf.channel_layers + 2 * conf.cross_layers  # KV attention rows a frame (K12)
    m32 = VapModel(conf, state, device="cuda")

    # (a) the SDS soak at live pacing -------------------------------------------
    soaks = {}
    for key, kw, hops in (("kv", dict(mode="kv"), SOAK_KV_HOPS), ("window", dict(mode="window"), SOAK_WINDOW_HOPS),
                          (f"batched_s{SOAK_BATCHED_STREAMS}", dict(batched=SOAK_BATCHED_STREAMS), SOAK_BATCHED_HOPS)):
        rec, counts = around(lambda: soak_sds.soak(m32, hops, **kw))
        pushes = soak_sds.WARM_HOPS + hops
        expect(counts, f"(a) soak {key}", gru_recurrence=pushes,
               flash_alibi=sites * pushes if key == "window" else 0,
               kv_attention=0 if key == "window" else kv_rows * pushes,  # one frame a hop
               linear=linear_per_forward(conf) * pushes if key == "window" else 0)  # float32 (m32)
        launches[f"soak_{key}_hop"] = {k: v // pushes for k, v in counts.items()}
        check(rec["p_in_range"] and len(rec["p"]) == hops, f"(a) soak {key}: p in [0, 1] at every hop")
        soaks[key] = rec
    unpaced = soak_sds.soak(m32, SOAK_UNPACED_HOPS, "kv", paced=False)
    paced_err = float(np.max(np.abs(np.asarray(soaks["kv"]["p"][:SOAK_UNPACED_HOPS]) - np.asarray(unpaced["p"]))))
    keys = ("hops", "latency_ms", "misses", "miss_pct", "jitter_p99_ms")
    emit("soak_sds", check="a", modes={k: {f: r[f] for f in keys} for k, r in soaks.items()},
         unpaced_kv={f: unpaced[f] for f in keys}, paced_vs_unpaced_max_abs_diff=paced_err, tol=SOAK_PACED_TOL,
         launches_per_hop={k: v for k, v in launches.items() if k.startswith("soak_")}, dtype="float32",
         card=smi, seconds=seconds(),
         note="host clock: each hop's push and the fetch of its p (a synchronize), paced every 20 ms against a "
              "wall-clock target after 50 warm hops; a miss is a hop finished after its deadline")
    check(paced_err <= SOAK_PACED_TOL, f"(a) paced kv hops against unpaced: {paced_err}")
    del soaks, unpaced

    # (b) the churn soak over ZMQ -----------------------------------------------
    if importlib.util.find_spec("zmq") is None:
        emit("churn_soak", check="b", ran=False, note="pyzmq does not import here: the churn soak was not run")
    else:
        s, counts = around(lambda: soak_churn.churn_soak(
            m32, streams=CHURN_STREAMS, duration=CHURN_DURATION_S, hop_frames=CHURN_HOP_FRAMES, pace=1.0,
            check_sessions=CHURN_CHECK_SESSIONS, max_wait_ms=CHURN_MAX_WAIT_MS,
            session_timeout=CHURN_SESSION_TIMEOUT_S, seed=0, session_s=CHURN_SESSION_S))
        # a push (a tick, or a hop of the solo replay): K3 once, the KV rows of its frames
        expect(counts, "(b) churn soak", gru_recurrence=counts["gru_recurrence"],
               kv_attention=kv_rows * CHURN_HOP_FRAMES * counts["gru_recurrence"])
        launches["churn_soak"] = counts
        c = s["contamination"]
        emit("churn_soak", check="b", ran=True, **{k: v for k, v in s.items() if k != "contamination"},
             contamination={k: v for k, v in c.items() if k != "per_session"}, max_wait_ms=CHURN_MAX_WAIT_MS,
             session_timeout_s=CHURN_SESSION_TIMEOUT_S, launches=counts, card=smi, seconds=seconds(),
             note="latency: each push's round trip at the client (host clock); the solo replay skips 8 hops")
        check(counts["gru_recurrence"] > 0, "(b) the server ticked on the card")
        check(s["sessions_error"] == 0, f"(b) sessions in error: {s['errors']}")
        check(c["checked"] >= 1, "(b) at least one eligible session replayed")
        check(c["max_abs_diff"] < soak_churn.CONTAMINATION_BAR, f"(b) contamination {c['max_abs_diff']}")
    del m32
    torch.cuda.empty_cache()

    # (c) the forward's stages ----------------------------------------------------
    stages, counts = around(lambda: profile_stages.profile_stages(64, "cuda"))
    launches["profile_stages"] = counts
    emit("profile_stages", check="c", batch=64, chunk_s=CHUNK_S, dtype="bfloat16", stages=_stage_lines(stages),
         card=smi, seconds=seconds(), note="CUDA events over 10 chained calls after 3; launches a call")
    check(stages["full forward+probs"]["launches"] == {k: v for k, v in per_forward.items() if v},
          f"(c) the full forward's launches {stages['full forward+probs']['launches']}")
    torch.cuda.empty_cache()

    # (d) the train step's stages -------------------------------------------------
    runs = {}
    for key, kw, env in (("frozen_deep", dict(deep=True, iters=PROFILE_ITERS), None),
                         ("unfrozen_deep", dict(deep=True, unfrozen=True, iters=PROFILE_ITERS), None),
                         ("unfrozen_fused_stack", dict(unfrozen=True, iters=PROFILE_FUSED_ITERS), "fused_stack")):
        old = os.environ.get("VAP_CONV_IMPL")
        if env:
            os.environ["VAP_CONV_IMPL"] = env
        try:
            runs[key], counts = around(lambda: profile_train_step.profile_train_step(16, device="cuda", **kw))
        finally:
            if old is None:
                os.environ.pop("VAP_CONV_IMPL", None)
            else:
                os.environ["VAP_CONV_IMPL"] = old
        launches[f"profile_train_step_{key}"] = counts
        torch.cuda.empty_cache()
    emit("profile_train_step", check="d", batch=16, chunk_s=CHUNK_S, dtype="bfloat16",
         runs={k: {"stages": _stage_lines(r["stages"]), "summary": r["summary"]} for k, r in runs.items()},
         card=smi, seconds=seconds(),
         note=f"CUDA events over --iters {PROFILE_ITERS} ({PROFILE_FUSED_ITERS} under fused_stack) chained calls; "
              "launches a call")
    step_launches = lambda key: runs[key]["stages"]["step"]["launches"]
    nonzero = lambda d: {k: v for k, v in d.items() if v}
    check(step_launches("frozen_deep") == nonzero(per_train_step), f"(d) frozen step {step_launches('frozen_deep')}")
    check(step_launches("unfrozen_deep") == nonzero(per_unfrozen_step),
          f"(d) unfrozen step {step_launches('unfrozen_deep')}")
    check(step_launches("unfrozen_fused_stack") == nonzero(dict(per_unfrozen_step, conv_stack=5)),
          f"(d) unfrozen step under fused_stack {step_launches('unfrozen_fused_stack')}")
    del runs

    # (e) model_params_grad, card against CPU; label_frequency ---------------------
    batch = model_params_grad.input_batch(conf, seconds=MPG_SECONDS)
    raw, base = [], profiling._leaf_stats

    def record(x, bins):
        raw.append(np.asarray(x.detach().float().cpu() if isinstance(x, torch.Tensor) else x, np.float64).ravel())
        return base(x, bins)

    profiling._leaf_stats = record
    try:
        card, counts = around(lambda: model_params_grad.collect(VapModel(conf, state, device="cuda"), batch))
    finally:
        profiling._leaf_stats = base
    launches["model_params_grad"] = counts
    cpu = model_params_grad.collect(VapModel(conf, state, device="cpu"), batch)
    vs_cpu = _stats_vs_cpu(card, cpu, raw, MPG_REL)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        subprocess.run([sys.executable, os.path.join(root, "examples", "make_synthetic_corpus.py"), "--out", tmp,
                        "--n", str(LABEL_SESSIONS), "--duration", str(LABEL_SESSION_S)], check=True,
                       capture_output=True, timeout=300)
        man = os.path.join(tmp, "train.csv")
        labels_card, counts = around(lambda: label_frequency.label_frequency(man, conf, LABEL_WINDOW_S, "cuda"))
        labels_cpu = label_frequency.label_frequency(man, conf, LABEL_WINDOW_S, "cpu")
    emit("model_params_grad", check="e", seconds_audio=MPG_SECONDS, leaves={k: len(v) for k, v in card.items()},
         launches=launches["model_params_grad"], vs_cpu=vs_cpu, tol=MPG_REL,
         label_frequency={"windows": labels_card["n_windows"], "total": labels_card["total"],
                          "entropy_bits": labels_card["entropy_bits"], "equal_to_cpu": labels_card == labels_cpu,
                          "launches": counts},
         card=smi, seconds=seconds(),
         note="float32; the bar relative to each leaf's largest magnitude on mean, std, largest magnitude and the "
              "outer bin edges; histogram counts may move only by values within the bar of an edge")
    check(launches["model_params_grad"]["conv_stack"] > 0 and launches["model_params_grad"]["flash_train_backward"] > 0,
          f"(e) model_params_grad launches {launches['model_params_grad']}")
    check(vs_cpu["max_rel_diff"] <= MPG_REL and not vs_cpu["hist_moved_past_edges"],
          f"(e) model_params_grad card vs CPU {vs_cpu}")
    check(labels_card == labels_cpu and labels_card["total"] > 0, "(e) label_frequency card counts equal the CPU's")
    del card, cpu, raw
    torch.cuda.empty_cache()

    # (f) the multi-process rehearsal -----------------------------------------------
    table, counts = around(lambda: multihost_rehearsal.rehearse(REHEARSAL_PROCS, REHEARSAL_STEPS, "cuda"))
    launches["multihost_rehearsal_one_process"] = counts
    emit("multihost_rehearsal", check="f", **table, launches_one_process=counts, card=smi, seconds=seconds(),
         note="the one-process run in this process, the two ranks in processes of their own over gloo; ms a step "
              "on the host clock, the slowest rank's")
    check(counts["conv_stack"] > 0 and counts["flash_train_forward"] > 0, f"(f) rehearsal launches {counts}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 2

    from voiceactivityprojection_tpu_torch import VapConfig, VapModel
    from voiceactivityprojection_tpu_torch.config import OptConfig
    from voiceactivityprojection_tpu_torch.models import checkpoint as ckpt
    from voiceactivityprojection_tpu_torch.models.vap import VapNet
    from voiceactivityprojection_tpu_torch.config import VapMonoConfig
    from voiceactivityprojection_tpu_torch.models.vap import VapMonoModel, forward
    from voiceactivityprojection_tpu_torch.ops import conv_fused as k11
    from voiceactivityprojection_tpu_torch.ops import conv_stack_fused as k1
    from voiceactivityprojection_tpu_torch.ops import flash_alibi as k4
    from voiceactivityprojection_tpu_torch.ops import flash_alibi_train as ft
    from voiceactivityprojection_tpu_torch.ops import gru_cluster
    from voiceactivityprojection_tpu_torch.ops import gru_downsample as k2
    from voiceactivityprojection_tpu_torch.ops import gru_recurrence as k3
    from voiceactivityprojection_tpu_torch.ops import kv_attention as k12
    from voiceactivityprojection_tpu_torch.ops.attention import alibi_slopes
    from voiceactivityprojection_tpu_torch.ops.conv import channel_norm, layer_norm
    from voiceactivityprojection_tpu_torch.parallel.context import (
        MARGIN_FRAMES as cp_margin,
        forward_context_parallel,
        probs_context_parallel,
    )
    from voiceactivityprojection_tpu_torch.parallel.mesh import make_mesh
    from voiceactivityprojection_tpu_torch.train import cpc_pretrain as cpc
    from voiceactivityprojection_tpu_torch.train import step as tstep

    port = {"k1": k1, "k2": k2, "k3": k3, "k4": k4, "k11": k11, "k12": k12, "ft": ft, "alibi_slopes": alibi_slopes}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. the card ------------------------------------------------------------
    start_phase("1. card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("card", nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build ---------------------------------------------------------------
    start_phase("2. build")
    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = {n: [l.strip() for l in log.splitlines() if "registers" in l or "spill" in l]
             for n, log in logs.items()}
    emit("build", seconds=build_s, built=sorted(logs), ptxas=ptxas, hgmma_in_sass=hgmma_counts(_build))
    check(all(_build.library_path(s).exists() for s in _build.SOURCES), "every source built")

    conf = VapConfig()
    state = ckpt.params_from_jax(ckpt.random_params_tree(conf, seed=0), conf)
    net = VapNet(conf)
    net.load_state_dict(state)
    net.requires_grad_(False)  # the inference phases: the weights carry no grad
    enc = net.encoder.to("cuda")
    layers = [(l.conv.w, l.conv.b, l.norm.w, l.norm.b) for l in enc.gEncoder]
    gen = torch.Generator().manual_seed(0)

    # 3. kernels vs plain ------------------------------------------------------
    start_phase("3. kernels vs plain")
    errs = {}
    routes_phase3 = _build.launch_counts()
    train_attention_shapes = ((16, 1000), (2, 3000))
    train_attention_rates = (0.1, 0.5, 0.0)
    for dtype in (torch.float32, torch.bfloat16):
        for n in (320_000, 12_345):
            errs.setdefault(("conv_stack", dtype), conv_stack_case(port, layers, 8, n, dtype, gen))
        for T in (2000, 1999):
            errs.setdefault(("gru_downsample", dtype), gru_ds_case(port, enc, 8, T, dtype, gen))
        for T in (1000, 3000):
            attention_case(port, 8, 4, T, 64, dtype, gen)
        for R, T in ((32, 2000), (3, 1999)):
            e = gru_recurrence_case(port, enc, R, T, dtype, gen)
            errs.setdefault(("gru_recurrence", dtype), e)
        k9_shapes = ((32, 2000), (3, 1999), (32, 128)) + (((9, 333),) if dtype == torch.bfloat16 else ())
        before = _build.launch_counts()
        for R, T in k9_shapes:
            e = gru_backward_case(port, enc, R, T, dtype, gen)
            errs.setdefault(("gru_backward", dtype), e)
            torch.cuda.empty_cache()
        # each shape on its dtype's cluster design (float32: also the
        # autograd comparison's launch)
        check_routes(f"phase 3 K9 {dtype}", before, "gru_backward",
                     {f"cluster {str(dtype)[6:]}": len(k9_shapes) * (2 if dtype == torch.float32 else 1)})
        for B, T in train_attention_shapes:
            for rate in train_attention_rates:
                e_fwd, e_bwd = train_attention_case(port, B, 4, T, 64, rate, dtype, gen)
                if (B, rate) == (16, 0.1):
                    errs[("flash_train_forward", dtype)] = e_fwd
                    errs[("flash_train_backward", dtype)] = e_bwd
                torch.cuda.empty_cache()
        for Tq, Tk, off in ((1500, 6000, 0), (1500, 6000, 1500), (1500, 6000, 4500), (1000, 3337, 2337)):
            offset_attention_case(port, Tq, Tk, off, dtype, gen)
        before = _build.launch_counts()
        for R_, n in ((8, 320_000), (8, 12_345), (1, 161), (2, CONV01_EDGE_N)):
            conv01_case(port, layers, R_, n, dtype, gen)
        # the shape one shard of the long-audio call gives it: both channels
        # of its 100 Hz frames plus the margin frames on each side
        t100_shard = 2 * int(LONG_S * SR) // 320 // CP_SHARDS
        conv01_case(port, layers, 2, (t100_shard + 2 * cp_margin) * 160, dtype, gen)
        # K11 on its dtype's tensor-core kernel (float32 after one W1 split)
        check_routes(f"phase 3 K11 {dtype}", before, "conv01",
                     {"wgmma 3xtf32": 5, "split tf32": 5} if dtype == torch.float32 else {"wgmma bfloat16": 5})
        torch.cuda.empty_cache()
    f32_route_case(port, enc, layers, gen, routes_phase3, len(train_attention_shapes) * len(train_attention_rates))
    gru_ds_block_case(port, gen)
    attention_backward_case(port, 16, 4, 1000, 64, gen)
    conv_bwd = conv_stack_backward_case(port, layers, 8, 320_000, gen)
    conv01_bwd = conv01_backward_case(port, layers, 2, 320_000, gen)
    refuses_grad_case(port, enc, layers)
    torch.cuda.empty_cache()

    # 4. the inference slice ---------------------------------------------------
    start_phase("4. inference")
    mark = [_build.launch_counts()]
    no_launch = dict.fromkeys(mark[0], 0)
    sites = 2 * conf.channel_layers + 4 * conf.cross_layers
    per_forward = dict(no_launch, conv_stack=5, gru_downsample=1, flash_alibi=sites)
    # the frozen-encoder train step: the conv stack kernel, the recurrence
    # kernel, the plain downsample, the training attention at every site
    per_train_step = dict(no_launch, conv_stack=5, gru_recurrence=1, flash_train_forward=sites,
                          flash_train_backward=sites)
    # the unfrozen step: the plain conv stack, K3 forward and K9 backward
    per_unfrozen_step = dict(per_train_step, conv_stack=0, gru_backward=1)
    # the CPC step: the plain conv stack and the GRU, no attention
    per_cpc_step = dict(per_unfrozen_step, flash_train_forward=0, flash_train_backward=0)
    # the same in float32: K13's GEMMs besides (bfloat16 projections take
    # torch.matmul; a step runs each projection's forward, dX and dW)
    gemms = linear_per_forward(conf)
    f32_forward = f32_gemms(per_forward, gemms)
    f32_train_step = f32_gemms(per_train_step, 3 * gemms)
    f32_unfrozen_step = f32_gemms(per_unfrozen_step, 3 * gemms)
    n = int(CHUNK_S * SR)
    T50 = n // 320
    rng = np.random.default_rng(1)

    def reset_counts():
        mark[0] = _build.launch_counts()

    def read_counts():
        """Each op's launches since ``reset_counts``, without its auxiliary
        kernels."""
        return _build.launch_totals(_build.launches_since(mark[0]))

    def requests(B, count):
        return [(0.1 * rng.standard_normal((B, 2, n))).astype(np.float32) for _ in range(count)]

    def check_probs(out, B, what, T=T50):
        check(out["p_now"].shape == (B, T, 2) and out["H"].shape == (B, T), f"{what} shapes")
        for key in ("probs", "vad", "p_now", "p_future", "H"):
            check(bool(torch.isfinite(out[key]).all()), f"{what} {key} finite")
        s = out["probs"].sum(-1)
        check(float((s - 1).abs().max()) < 1e-3, f"{what} probs sum to 1")
        check(float(out["p_now"].min()) >= 0 and float(out["p_now"].max()) <= 1, f"{what} p_now in [0, 1]")

    def serve(model, reqs, B, what, per_call=per_forward):
        reset_counts()
        t0 = time.perf_counter()
        outs = [model.probs(w) for w in reqs]
        sync()
        dt = time.perf_counter() - t0
        launches = read_counts()
        for out in outs:
            check_probs(out, B, what)
        for k, per in per_call.items():
            check(launches[k] == per * len(reqs), f"{what}: {k} launched {launches[k]} times, "
                  f"expected {per} per forward")
        emit("serve", model=what, requests=len(reqs), batch=B, seconds=dt, launches=launches)
        return outs, launches

    # float32: 3 requests at B=8, then one request checked against the CPU
    m32 = VapModel(conf, state, device="cuda")
    linear_before = _build.launch_counts()
    _, f32_serve_counts = serve(m32, requests(8, 3), 8, "float32", f32_forward)
    # K13: every projection, the weights split in the first request
    check_routes("float32 requests, B=8, 3 requests", linear_before, "linear",
                 {"gemm 3xtf32": 3 * linear_per_forward(conf), "split tf32": linear_weight_groups(conf)})
    f32_kernels = {k: v for k, v in _build.launches_since(linear_before).items()
                   if k in ("conv_stack", "gru_downsample")}
    emit("f32_routes", path="float32 requests, B=8, 3 requests", launches=f32_kernels)
    check(f32_kernels["conv_stack"]["wgmma 3xtf32"] == f32_kernels["conv_stack"]["split tf32"] == 12
          and f32_kernels["conv_stack"]["cuda cores"] == 3,
          f"float32 requests: conv1-conv4 on 3xTF32, conv0 on the CUDA cores: {f32_kernels}")
    check(f32_kernels["gru_downsample"]["cluster float32"] == 3, f"float32 requests: K2's cluster kernel: {f32_kernels}")
    one = requests(1, 1)[0]
    g32 = m32.forward(one)
    p32 = m32.probs(one)
    cpu = VapModel(conf, state, device="cpu")
    c_out = cpu.forward(one)
    c_probs = cpu.probs(one)
    vs_cpu = {
        "logits": max_err(g32["logits"].cpu(), c_out["logits"]),
        **{k: max_err(p32[k].cpu(), c_probs[k]) for k in ("p_now", "p_future", "H")},
    }
    emit("vs_cpu", dtype="float32", max_abs_err=vs_cpu, tol=VS_CPU_TOL)
    for k, bar in VS_CPU_TOL.items():
        check(vs_cpu[k] <= bar, f"float32 card vs CPU {k}: {vs_cpu[k]} > {bar}")
    del m32, cpu

    # bfloat16: the main path (counts read around it) and its profile
    conf16 = VapConfig(dtype="bfloat16")
    m16 = VapModel(conf16, state, device="cuda")
    B = 64
    reqs = requests(B, 3)
    m16.probs(reqs[0])  # warm-up (allocator, library heuristics)
    sync()
    linear_before = _build.launch_counts()
    _, launches = serve(m16, reqs, B, "bfloat16")
    check_routes("bfloat16 requests, B=64", linear_before, "linear", {})  # torch.matmul in bfloat16
    p16 = m16.probs(one)
    vs_cpu16 = {k: max_err(p16[k].cpu(), c_probs[k]) for k in ("p_now", "p_future")}
    emit("vs_cpu", dtype="bfloat16", max_abs_err=vs_cpu16, tol=VS_CPU_BF16_TOL)
    for k, e in vs_cpu16.items():
        check(e <= VS_CPU_BF16_TOL, f"bfloat16 card vs CPU float32 {k}: {e}")

    x = torch.as_tensor(reqs[0], device="cuda")  # the waveform's copy stays out of the window
    profile(lambda: m16.probs(x), "probs", batch=B)
    del m16, reqs, x
    torch.cuda.empty_cache()

    # 5. the training slice ----------------------------------------------------
    start_phase("5. frozen training")
    TB = 16
    n_vad = int((CHUNK_S + 2) * 50)

    def train_batch(b, chunk_samples=n, vad_frames=n_vad):
        return {"waveform": (0.1 * rng.standard_normal((b, 2, chunk_samples))).astype(np.float32),
                "vad": (rng.random((b, vad_frames, 2)) < 0.4).astype(np.float32)}

    def train_net(c):
        tnet = VapNet(c)
        tnet.load_state_dict(state)
        tnet.to("cuda")
        opt = tstep.make_optimizer(OptConfig(), tnet, c.freeze_encoder)
        return tnet, tstep.make_train_step(c, opt)

    def train_steps(c, b, steps, what, expected):
        tnet, step = train_net(c)
        before = {k: p.detach().clone() for k, p in tnet.named_parameters()}
        batches = [{k: torch.as_tensor(v, device="cuda") for k, v in train_batch(b).items()}
                   for _ in range(2)]
        metrics, counts = [], []
        for i in range(steps):
            reset_counts()
            m = step(tnet, batches[i % 2], torch.Generator().manual_seed(i))
            sync()
            counts.append(read_counts())
            metrics.append({k: float(v) for k, v in m.items()})
        emit("train", dtype=c.dtype, batch=b, chunk_s=CHUNK_S, steps=steps, metrics=metrics,
             launches_per_step=counts, note=what)
        for i, (m, cnt) in enumerate(zip(metrics, counts)):
            check(all(math.isfinite(v) for v in m.values()), f"{c.dtype} step {i} loss finite: {m}")
            check(cnt == expected, f"{c.dtype} {what} step {i} launches {cnt}, expected {expected}")
        moved = {}
        for name, p in tnet.named_parameters():
            same = torch.equal(p.detach(), before[name])
            if c.freeze_encoder and name.startswith(FROZEN):
                check(same, f"{c.dtype}: frozen {name} changed")
            elif not c.freeze_encoder or name.startswith(("encoder.downsample.", "vap_head.")):
                moved[name] = not same
        check(all(moved.values()), f"{c.dtype} {what}: weights that did not move: "
              f"{[k for k, v in moved.items() if not v]}")
        return tnet, step, batches, counts

    def profiled_step(tnet, step, batches, what, dtype="bfloat16"):
        """One more step after the checked ones, its loss finite, then a
        profile of one."""
        m = step(tnet, batches[0], torch.Generator().manual_seed(100))
        check(math.isfinite(float(m["loss"])), f"{dtype} {what} train step after the checked ones: loss finite")
        profile(lambda: step(tnet, batches[0], torch.Generator().manual_seed(7)), "train_step",
                batch=TB, dtype=dtype, encoder=what)

    def step_vs_cpu(conf_c, batch, expected, what):
        """One float32 step on the CPU and on the card from the same weights
        and batch (elementwise dropout masks drawn alike)."""
        nets = {}
        before = _build.launch_counts()
        with masks_drawn_on_cpu():
            for device in ("cpu", "cuda"):
                tnet = VapNet(conf_c)
                tnet.load_state_dict(state)
                tnet.to(device)
                reset_counts()
                opt = tstep.make_optimizer(OptConfig(), tnet, conf_c.freeze_encoder)
                m = tstep.make_train_step(conf_c, opt)(tnet, batch, torch.Generator().manual_seed(0))
                nets[device] = (tnet, {k: float(v) for k, v in m.items()})
        card_counts = read_counts()
        (cnet, cm), (gnet, gm) = nets["cpu"], nets["cuda"]
        pairs = []
        for (name, cp), gp in zip(cnet.named_parameters(), gnet.parameters()):
            if conf_c.freeze_encoder and name.startswith(FROZEN):
                check(cp.grad is None and gp.grad is None, f"no gradient on frozen {name}")
                continue
            check(cp.grad is not None and gp.grad is not None, f"{what}: a gradient reaches {name}")
            pairs.append((name, cp, gp))
        err = grads_vs_cpu(pairs, cm, gm, cm)
        emit("train_vs_cpu", dtype="float32", batch=1, chunk_s=2.0, dropout=conf_c.dropout, encoder=what,
             metrics_cpu=cm, metrics_card=gm, launches_card=card_counts, max_err=err, tol=TRAIN_VS_CPU_TOL)
        check(card_counts == expected, f"{what} dropout {conf_c.dropout} card step launches "
              f"{card_counts}, expected {expected}")
        check_f32_routes(f"float32 {what} step vs CPU, dropout {conf_c.dropout}", before,
                         gru_recurrence=expected["gru_recurrence"], gru_backward=expected["gru_backward"],
                         flash_train_forward=expected["flash_train_forward"])
        for k, bar in TRAIN_VS_CPU_TOL.items():
            check(err[k] <= bar, f"{what} dropout {conf_c.dropout} train step card vs CPU {k}: "
                  f"{err[k]} > {bar}")
        return card_counts

    # bfloat16 (the main path): three checked steps, then the profiled one
    conf_t16 = VapConfig(dtype="bfloat16")
    tnet16, step16, batches16, train_counts = train_steps(conf_t16, TB, 3, "frozen", per_train_step)
    profiled_step(tnet16, step16, batches16, "frozen")

    # one eval step: the inference kernels
    reset_counts()
    ev = tstep.make_eval_step(conf_t16)(tnet16, batches16[0])
    sync()
    eval_counts = read_counts()
    emit("eval", dtype="bfloat16", batch=TB, vap_loss=float(ev["vap_loss"]),
         vad_loss=float(ev["vad_loss"]), launches=eval_counts)
    check(math.isfinite(float(ev["vap_loss"])) and math.isfinite(float(ev["vad_loss"])), "eval losses")
    check(eval_counts == per_forward, f"eval step launches {eval_counts}, expected {per_forward}")
    del tnet16, step16, batches16, ev
    torch.cuda.empty_cache()

    # float32: three checked steps at the same batch, each on the f32 routes
    # (K3 on the f32 cluster kernel, K6 on 3xTF32), then the profiled one
    before = _build.launch_counts()
    tnet32, step32, batches32, f32_train_counts = train_steps(VapConfig(), TB, 3, "frozen", f32_train_step)
    check_f32_routes("float32 frozen steps, B=16 x 20 s, 3 steps", before, gru_recurrence=3,
                     flash_train_forward=3 * sites)
    # K13 a step: each projection's forward, dX and dW (dW's row slices
    # summed by one more launch), its weights split again after each update
    check_routes("float32 frozen steps, B=16 x 20 s, 3 steps", before, "linear",
                 {"gemm 3xtf32": 9 * linear_per_forward(conf), "split tf32": 3 * linear_weight_groups(conf),
                  "slice sum": 3 * linear_per_forward(conf)})
    profiled_step(tnet32, step32, batches32, "frozen", dtype="float32")
    del tnet32, step32, batches32
    torch.cuda.empty_cache()

    # one float32 step on the card against the CPU, without dropout and with
    # it (elementwise masks drawn alike, see masks_drawn_on_cpu); with or
    # without dropout, the step's attention runs the training kernels
    small = train_batch(1, chunk_samples=2 * SR, vad_frames=2 * 50 + 100)
    for drop in (0.0, conf.dropout):
        step_vs_cpu(VapConfig(dropout=drop), small, f32_train_step, "frozen")
        torch.cuda.empty_cache()

    # 6. the encoder-training slice ------------------------------------------
    start_phase("6. unfrozen training and CPC")
    # the unfrozen step in bfloat16 (this slice's main path, with the CPC
    # step below): three checked steps, then the profiled one
    conf_u16 = VapConfig(dtype="bfloat16", freeze_encoder=False)
    unet16, ustep16, ubatches16, unfrozen_counts = train_steps(
        conf_u16, TB, 3, "unfrozen", per_unfrozen_step)
    profiled_step(unet16, ustep16, ubatches16, "unfrozen")
    del unet16, ustep16, ubatches16
    torch.cuda.empty_cache()
    f32_unfrozen_counts = step_vs_cpu(VapConfig(dropout=0.0, freeze_encoder=False), small, f32_unfrozen_step,
                                      "unfrozen")
    torch.cuda.empty_cache()

    # CPC pretraining at the pretrain_cpc.py defaults, float32
    CB, CN, K_PRED, N_NEG = 32, 20_480, 12, 128
    cpc_tree = ckpt.random_params_tree(conf, seed=0)["encoder"]

    def cpc_state(device):
        heads = cpc.init_cpc_heads(torch.Generator().manual_seed(0), K_PRED, conf.encoder_dim,
                                   conf.encoder_dim)
        return cpc.init_cpc_train_state(ckpt.encoder_from_jax(cpc_tree), heads, device=device)

    cstate = cpc_state("cuda")
    cstep = cpc.make_cpc_train_step(K_PRED, N_NEG)
    cwaves = [torch.as_tensor((0.1 * rng.standard_normal((CB, CN))).astype(np.float32), device="cuda")
              for _ in range(2)]
    before = {k: p.detach().clone() for k, p in cstate.encoder.named_parameters()}
    cpc_routes = _build.launch_counts()
    cpc_metrics, cpc_counts = [], []
    for i in range(3):
        reset_counts()
        m = cstep(cstate, cwaves[i % 2], torch.Generator().manual_seed(i))
        sync()
        cpc_counts.append(read_counts())
        cpc_metrics.append({k: float(v) for k, v in m.items()})
    emit("cpc", dtype="float32", batch=CB, samples=CN, n_predicts=K_PRED, n_negatives=N_NEG, steps=3,
         metrics=cpc_metrics, launches_per_step=cpc_counts)
    check_f32_routes("CPC steps, B=32 x 20480, 3 steps", cpc_routes, gru_recurrence=3, gru_backward=3)
    for i, (m, cnt) in enumerate(zip(cpc_metrics, cpc_counts)):
        check(all(math.isfinite(v) for v in m.values()), f"CPC step {i} finite: {m}")
        check(cnt == per_cpc_step, f"CPC step {i} launches {cnt}, expected {per_cpc_step}")
    for name, p in cstate.encoder.named_parameters():
        same = torch.equal(p.detach(), before[name])
        check(same if name.startswith("downsample.") else not same,
              f"CPC: {name} {'changed' if not same else 'did not move'}")
    check(cstate.step == 3, "CPC step count")
    m = cstep(cstate, cwaves[0], torch.Generator().manual_seed(100))
    check(math.isfinite(float(m["cpc_loss"])), "CPC step after the checked ones: loss finite")
    profile(lambda: cstep(cstate, cwaves[0], torch.Generator().manual_seed(7)), "cpc_step",
            batch=CB, dtype="float32")
    del cstate, cwaves
    torch.cuda.empty_cache()

    # one CPC step on the card against the CPU: the same weights, waveform
    # and negatives (drawn from the step's CPU generator on both devices)
    small_w = (0.1 * rng.standard_normal((4, CN))).astype(np.float32)
    res = {}
    cpc_routes = _build.launch_counts()
    for device in ("cpu", "cuda"):
        st = cpc_state(device)
        reset_counts()
        m = cstep(st, small_w, torch.Generator().manual_seed(5))
        res[device] = (st, {k: float(v) for k, v in m.items()})
    card_counts = read_counts()
    (cst, cm), (gst, gm) = res["cpu"], res["cuda"]
    pairs = [(f"encoder.{n}", cp, gp) for (n, cp), gp in zip(cst.encoder.named_parameters(),
                                                            gst.encoder.parameters())
             if not n.startswith("downsample.")] + [("heads.W", cst.heads.W, gst.heads.W)]
    err = grads_vs_cpu(pairs, cm, gm, ["cpc_loss"])
    emit("cpc_vs_cpu", dtype="float32", batch=4, samples=CN, metrics_cpu=cm, metrics_card=gm,
         launches_card=card_counts, max_err=err, tol=TRAIN_VS_CPU_TOL)
    check(card_counts == per_cpc_step, f"CPC card step launches {card_counts}, expected {per_cpc_step}")
    check_f32_routes("CPC step vs CPU", cpc_routes, gru_recurrence=1, gru_backward=1)
    for k, bar in TRAIN_VS_CPU_TOL.items():
        check(err[k] <= bar, f"CPC step card vs CPU {k}: {err[k]} > {bar}")
    del res, cst, gst
    torch.cuda.empty_cache()

    # 7. long audio: exact single-shot inference over four time shards ------
    start_phase("7. long audio")
    # 600 s of stereo (T50 = 30,000) on a mesh that repeats the one card, so
    # every shard runs the offset attention kernel at its own offset
    shards = CP_SHARDS
    n_long = int(LONG_S * SR)
    T50_long = n_long // 320
    mesh = make_mesh(n_data=shards, devices=[torch.device("cuda")] * shards)
    per_cp_call = dict(no_launch, gru_recurrence=shards, flash_alibi_offset=sites * shards)
    lnet = VapNet(conf)
    lnet.load_state_dict(state)
    lnet.to("cuda").requires_grad_(False)
    long_wave = torch.as_tensor((0.1 * rng.standard_normal((1, 2, n_long))).astype(np.float32), device="cuda")
    with torch.inference_mode():
        single = {c.dtype: forward(lnet, long_wave, c) for c in (conf, conf16)}

    def long_call(c, impl, expected):
        """forward_context_parallel, held against the single-device forward
        on the card, and probs_context_parallel, each with the ledger read
        around it. Returns the probs call's counts."""
        if impl:
            os.environ["VAP_CONV_IMPL"] = impl
        routes = _build.launch_counts()
        try:
            reset_counts()
            out = forward_context_parallel(lnet, long_wave, c, mesh)
            sync()
            fwd_counts = read_counts()
            reset_counts()
            probs = probs_context_parallel(lnet, long_wave, c, mesh)
            sync()
            counts = read_counts()
        finally:
            os.environ.pop("VAP_CONV_IMPL", None)
        what = f"context parallel {c.dtype} conv {impl or 'default'}"
        check_probs(probs, 1, what, T=T50_long)
        want = single[c.dtype]
        errs = {k: max_err(out[k], want[k]) for k in ("logits", "vad")}
        if c.dtype == "float32":
            ok = all(e <= CP_F32_TOL for e in errs.values())
        else:  # the JAX bf16 bar: |got - want| <= 0.05 + 0.1 |want|
            ok = all(bool(((out[k] - want[k]).abs() <= 0.05 + 0.1 * want[k].abs()).all()) for k in errs)
        emit("context_parallel", dtype=c.dtype, conv_impl=impl or "default", audio_s=LONG_S, shards=shards,
             t50=T50_long, launches=counts, max_abs_err_vs_single_device=errs,
             tol=CP_F32_TOL if c.dtype == "float32" else "0.05 + 0.1 |want|")
        check(fwd_counts == expected and counts == expected,
              f"{what}: launches {fwd_counts} / {counts}, expected {expected}")
        if c.dtype == "float32":  # the shards' K3 on the f32 cluster kernel, K11 on 3xTF32
            check_f32_routes(f"{what}, forward and probs", routes, gru_recurrence=2 * shards,
                             conv01=2 * shards if impl else 0)
        check(ok, f"{what}: against the single-device forward {errs}")
        return counts

    cp_counts = {}
    for c in (conf, conf16):
        want_cp = f32_gemms(per_cp_call, linear_per_cp_call(conf, shards), c.dtype)
        cp_counts[c.dtype] = long_call(c, None, want_cp)
        cp_counts[(c.dtype, "fused")] = long_call(c, "fused", dict(want_cp, conv01=shards))
        torch.cuda.empty_cache()
    profile(lambda: probs_context_parallel(lnet, long_wave, conf16, mesh), "probs_context_parallel",
            audio_s=LONG_S, shards=shards, dtype="bfloat16")
    del single, long_wave
    torch.cuda.empty_cache()

    # 8. the conv0 + conv1 kernel in stereo inference (VAP_CONV_IMPL=fused) --
    start_phase("8. VAP_CONV_IMPL=fused")
    m16 = VapModel(conf16, state, device="cuda")
    reqs = requests(B, 2)
    per_fused = dict(per_forward, conv_stack=0, conv01=1)

    def served(impl):
        """The requests' outputs under ``impl`` and the launches they made."""
        if impl:
            os.environ["VAP_CONV_IMPL"] = impl
        try:
            reset_counts()
            outs = [m16.probs(w) for w in reqs]
            sync()
            return outs, read_counts()
        finally:
            os.environ.pop("VAP_CONV_IMPL", None)

    served_by_impl = {impl: served(impl) for impl in ("fused", None)}
    for impl, (outs, counts) in served_by_impl.items():
        expected = per_fused if impl else per_forward
        check(counts == {k: v * len(reqs) for k, v in expected.items()},
              f"conv impl {impl}: launches {counts}, expected {expected} per request")
    (fused_outs, fused_counts), (default_outs, _) = served_by_impl["fused"], served_by_impl[None]
    p_err = max(max_err(f[k], d[k]) for f, d in zip(fused_outs, default_outs) for k in ("p_now", "p_future"))
    emit("conv_impl", batch=B, chunk_s=CHUNK_S, dtype="bfloat16", launches=fused_counts,
         max_abs_err_p_vs_default=p_err, tol=VS_CPU_BF16_TOL, card=smi)
    check(p_err <= VS_CPU_BF16_TOL, f"VAP_CONV_IMPL=fused p_now/p_future vs the default path: {p_err}")
    os.environ["VAP_CONV_IMPL"] = "fused"
    try:  # where the fused route's request time goes
        profile(lambda: m16.probs(reqs[0]), "probs VAP_CONV_IMPL=fused", batch=B, dtype="bfloat16")
    finally:
        os.environ.pop("VAP_CONV_IMPL", None)
    del m16, reqs, fused_outs, default_outs, served_by_impl
    torch.cuda.empty_cache()

    # 9. the mono (VAD-conditioned) model, with the history conditioning ---
    start_phase("9. mono")
    mconf = VapMonoConfig(va_history=True)
    mstate = ckpt.params_from_jax(ckpt.random_params_tree(mconf, seed=0), mconf)
    MB = 8
    mwave = (0.1 * rng.standard_normal((MB, 1, n))).astype(np.float32)
    mva = (rng.random((MB, T50 + 100, 2)) < 0.4).astype(np.float32)
    mvah = rng.random((MB, T50 + 100, mconf.va_history_bins)).astype(np.float32)
    reset_counts()
    mono_card = VapMonoModel(mconf, mstate, device="cuda").probs(mwave, mva, mvah)
    sync()
    mono_counts = read_counts()
    mono_cpu = VapMonoModel(mconf, mstate, device="cpu").probs(mwave, mva, mvah)
    mono_err = {k: max_err(mono_card[k].cpu(), mono_cpu[k]) for k in ("p_now", "p_future")}
    per_mono = dict(no_launch, conv_stack=5, gru_downsample=1, flash_alibi=mconf.channel_layers + mconf.cross_layers,
                    linear=linear_per_mono_forward(mconf))
    emit("mono", dtype="float32", batch=MB, chunk_s=CHUNK_S, va_history=True, launches=mono_counts,
         max_abs_err_vs_cpu=mono_err, tol=MONO_VS_CPU_TOL)
    check(mono_card["p_now"].shape == (MB, T50, 2), "mono shapes")
    check(mono_counts == per_mono, f"mono launches {mono_counts}, expected {per_mono}")
    for k, e in mono_err.items():
        check(e <= MONO_VS_CPU_TOL, f"mono card vs CPU {k}: {e}")
    del mono_card, mono_cpu
    torch.cuda.empty_cache()

    # 10. attention routes and head widths ------------------------------------
    start_phase("10. attention routes")
    # attn_impl="xla" takes the dense path on the card: no attention launch,
    # p_now / p_future within the float32 bar of "auto"
    reset_counts()
    pxla = VapModel(VapConfig(attn_impl="xla"), state, device="cuda").probs(one)
    sync()
    xla_counts = read_counts()
    xla_err = {k: max_err(pxla[k], p32[k]) for k in ("p_now", "p_future")}
    emit("attn_impl", impl="xla", dtype="float32", batch=1, launches=xla_counts,
         max_abs_err_vs_auto=xla_err, tol=VS_CPU_TOL["p_now"])
    check(xla_counts == dict(f32_forward, flash_alibi=0), f"attn_impl=xla launches {xla_counts}")
    for k, e in xla_err.items():
        check(e <= VS_CPU_TOL[k], f"attn_impl=xla vs auto {k}: {e}")
    del pxla
    # the attention kernels at head widths 32 and 128 (8 and 2 heads)
    # against their plain versions
    for Dh in (32, 128):
        for dtype in (torch.float32, torch.bfloat16):
            attention_case(port, 8, conf.dim // Dh, 1000, Dh, dtype, gen)
            train_attention_case(port, 16, conf.dim // Dh, 1000, Dh, 0.1, dtype, gen)
            offset_attention_case(port, 1500, 6000, 1500, dtype, gen, Dh=Dh)
            torch.cuda.empty_cache()
    # 8 and 2 heads through the kernels: the forward in float32 and bfloat16
    # against the CPU, and one bfloat16 train step
    for heads in (8, 2):
        conf_h = VapConfig(num_heads=heads)
        state_h = ckpt.params_from_jax(ckpt.random_params_tree(conf_h, seed=0), conf_h)
        want_h = VapModel(conf_h, state_h, device="cpu").probs(one)
        for dt, tol in (("float32", VS_CPU_TOL["p_now"]), ("bfloat16", VS_CPU_BF16_TOL)):
            reset_counts()
            got_h = VapModel(VapConfig(num_heads=heads, dtype=dt), state_h, device="cuda").probs(one)
            sync()
            counts_h = read_counts()
            check_probs(got_h, 1, f"{heads} heads {dt}")
            err_h = {k: max_err(got_h[k].cpu(), want_h[k]) for k in ("p_now", "p_future")}
            emit("head_width", num_heads=heads, head_dim=conf.dim // heads, dtype=dt, batch=1,
                 launches=counts_h, max_abs_err_vs_cpu=err_h, tol=tol)
            per_h = f32_gemms(per_forward, gemms, dt)
            check(counts_h == per_h, f"{heads} heads {dt} launches {counts_h}, expected {per_h}")
            for k, e in err_h.items():
                check(e <= tol, f"{heads} heads {dt} card vs CPU {k}: {e} > {tol}")
        conf_t = VapConfig(num_heads=heads, dtype="bfloat16")
        hnet = VapNet(conf_t)
        hnet.load_state_dict(state_h)
        hnet.to("cuda")
        hstep = tstep.make_train_step(conf_t, tstep.make_optimizer(OptConfig(), hnet, True))
        hbatch = {k: torch.as_tensor(v, device="cuda") for k, v in train_batch(2).items()}
        reset_counts()
        mh = {k: float(v) for k, v in hstep(hnet, hbatch, torch.Generator().manual_seed(0)).items()}
        sync()
        counts_h = read_counts()
        emit("head_width_train", num_heads=heads, head_dim=conf.dim // heads, dtype="bfloat16", batch=2,
             metrics=mh, launches=counts_h)
        check(all(math.isfinite(v) for v in mh.values()), f"{heads}-head bf16 step finite: {mh}")
        check(counts_h == per_train_step,
              f"{heads}-head bf16 step launches {counts_h}, expected {per_train_step}")
        del hnet, hstep, hbatch, got_h, want_h
        torch.cuda.empty_cache()

    # 11. kernel times -----------------------------------------------------------
    start_phase("11. kernel times")
    kernels = []

    def f32_launches(counter):
        """A kernel's launches on the default float32 paths of this run (the
        B=8 requests of phase 4, the frozen step of phase 5, the CPC step
        and the unfrozen step against the CPU of phase 6, the 600 s call of
        phase 7 by default and under fused)."""
        paths = {"per_f32_request": f32_serve_counts[counter] // 3,
                 "per_f32_frozen_train_step": f32_train_counts[0][counter],
                 "per_cpc_step": cpc_counts[0][counter],
                 "per_f32_600s_call": cp_counts["float32"][counter],
                 "per_f32_unfrozen_step": f32_unfrozen_counts[counter],
                 "per_f32_600s_call_fused": cp_counts[("float32", "fused")][counter]}
        return {k: v for k, v in paths.items() if v}

    net16 = net.to("cuda", torch.bfloat16)
    enc16 = net16.encoder
    R = 2 * B
    dt16 = torch.bfloat16

    # conv stack at R=128 x 320000
    lw16 = [(l.conv.w, l.conv.b, l.norm.w, l.norm.b) for l in enc16.gEncoder]
    x = (0.1 * torch.randn(R, n, generator=gen)).to("cuda", dt16)
    # kernel vs plain at the main path's shape, on the inputs timed below
    err = compare("conv_stack", k1.fused_conv_stack(lw16, x), k1.reference_stack(lw16, x),
                  [R, n], dt16)
    ms = cuda_ms(lambda: k1.fused_conv_stack(lw16, x))
    plain = cuda_ms(lambda: k1.reference_stack(lw16, x), reps=2, warmup=1)
    torch.cuda.empty_cache()
    specs = k1.CPC_CONV_SPECS

    def conv1d_lib(lw, xin):
        zt = xin[:, None, :]
        for (w, b, nw, nb), (_, s, p) in zip(lw, specs):
            zt = F.conv1d(zt, w.permute(2, 1, 0), b, stride=s, padding=p)
            zt = torch.relu(channel_norm(zt.transpose(1, 2), nw, nb)).transpose(1, 2)
        return zt

    lib = cuda_ms(lambda: conv1d_lib(lw16, x), reps=2, warmup=1)
    # each layer's launch timed on its own, on the layer inputs of this x
    zs = [x]
    for layer, (_, st, pd) in zip(lw16, specs):
        zs.append(k1.conv_cn_relu(zs[-1], layer, st, pd))
    per_layer = [cuda_ms(lambda i=i: k1.conv_cn_relu(zs[i], lw16[i], specs[i][1], specs[i][2]), reps=3, warmup=1)
                 for i in range(len(specs))]
    del zs
    torch.cuda.empty_cache()
    # float32: the stack (conv1-conv4 on 3xTF32), each layer alone; cuDNN
    # in float32 with TF32 off as the yardstick
    x32, lw32 = x.float(), [tuple(t.float() for t in l) for l in lw16]
    f32_ms = cuda_ms(lambda: k1.fused_conv_stack(lw32, x32), reps=3, warmup=1)
    zs = [x32]
    for layer, (_, st, pd) in zip(lw32, specs):
        zs.append(k1.conv_cn_relu(zs[-1], layer, st, pd))
    f32_per_layer = [cuda_ms(lambda i=i: k1.conv_cn_relu(zs[i], lw32[i], specs[i][1], specs[i][2]), reps=3,
                             warmup=1) for i in range(len(specs))]
    del zs
    torch.cuda.empty_cache()
    f32_lib = cuda_ms(lambda: conv1d_lib(lw32, x32), reps=1, warmup=1)
    del x32, lw32
    torch.cuda.empty_cache()
    layer_flops, n_l, c_in = [], n, 1
    for k, s, p in specs:
        n_l = (n_l + 2 * p - k) // s + 1
        layer_flops.append(2.0 * R * n_l * 256 * k * c_in)
        c_in = 256
    flops = sum(layer_flops)
    weights = sum(t.numel() for l in lw16 for t in l) * 2
    bnd, by = bound_ms(flops, R * n * 2 + R * n_l * 256 * 2 + weights)
    f32_bytes = 2 * (R * n * 2 + R * n_l * 256 * 2 + weights)
    # float32: conv0 at the FFMA rate; conv1-conv4 three TF32 products each,
    # at the TF32 tensor-core rate (in FFMA-rate FLOPs, for bound_ms)
    f32_ops = layer_flops[0] + 3 * sum(layer_flops[1:]) * PEAK_F32_FLOPS / PEAK_TF32_FLOPS
    f32_bnd, f32_by = bound_ms(f32_ops, f32_bytes, PEAK_F32_FLOPS)
    f32_ffma_bnd, _ = bound_ms(flops, f32_bytes, PEAK_F32_FLOPS)
    kernels.append(dict(
        name="conv_stack", route="cuda", source="voiceactivityprojection_tpu_torch/csrc/conv_stack.cu",
        replaces="voiceactivityprojection_tpu/ops/conv_stack_fused.py:101",
        launches=launches["conv_stack"], launches_per_train_step=train_counts[0]["conv_stack"],
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib,
        design=CONV_DESIGN, f32_ms=f32_ms, per_layer_ms=per_layer,
        max_abs_err_f32=errs[("conv_stack", torch.float32)], f32_design=CONV_DESIGN_F32,
        f32_per_layer_ms=f32_per_layer, f32_bound_ms=f32_bnd, f32_bound_by=f32_by, f32_ffma_bound_ms=f32_ffma_bnd,
        f32_library_ms=f32_lib, f32_launches=f32_launches("conv_stack"),
        f32_kernel_launches_per_request={k: v // 3 for k, v in f32_kernels["conv_stack"].items()},
        f32_note="f32_ms: conv1-conv4 on 3xTF32 wgmma (w's hi/lo split launch included), conv0 on the CUDA "
                 "cores; f32_bound_ms: conv0 at 67 TFLOP/s, conv1-conv4 three TF32 products at 495 TFLOP/s; "
                 "f32_ffma_bound_ms: every layer at the FFMA rate; f32_library_ms: cuDNN F.conv1d x 5 with "
                 "TF32 off + ChannelNorm + ReLU",
        backward_max_abs_err_f32=conv_bwd[0], backward_ms=conv_bwd[1], backward_plain_ms=conv_bwd[2],
        backward_note="float32, R=8 x 320000, forward + backward: autograd through the plain stack "
                      "on the saved inputs (JAX conv_stack_fused.py:467-470), against autograd of "
                      "reference_stack; on no main path"))
    del x
    torch.cuda.empty_cache()

    # GRU + downsample at R=128 x 2000 steps
    H = 256
    g, d = enc16.gAR, enc16.downsample
    T100 = 2 * T50
    xp = (0.5 * torch.randn(R, T100, 3 * H, generator=gen)).to("cuda", dt16)
    h0 = torch.zeros(R, H, device="cuda", dtype=dt16)
    args = [xp, g.w_hh, g.b_hh, h0, d.conv.w, d.conv.b, d.ln.w, d.ln.b]
    err = compare("gru_downsample", k2.gru_downsample_fused(*args),
                  k2.gru_downsample_reference(*args), [R, T100, 3 * H], dt16)
    ms = cuda_ms(lambda: k2.gru_downsample_fused(*args), reps=3, warmup=1)
    plain = cuda_ms(lambda: k2.gru_downsample_reference(*args), reps=1, warmup=1)
    gru_lib = torch.nn.GRU(H, H, batch_first=True).to("cuda", dt16).requires_grad_(False)
    with torch.no_grad():
        gru_lib.weight_ih_l0.copy_(g.w_ih.T)
        gru_lib.weight_hh_l0.copy_(g.w_hh.T)
        gru_lib.bias_ih_l0.copy_(g.b_ih)
        gru_lib.bias_hh_l0.copy_(g.b_hh)
    z = torch.relu(torch.randn(R, T100, H, generator=gen)).to("cuda", dt16)
    w_d = d.conv.w.permute(2, 1, 0)

    def gru_ds_lib():
        ys, _ = gru_lib(z)
        y = F.conv1d(F.pad(ys.transpose(1, 2), (4, 0)), w_d, d.conv.b, stride=2)
        return F.gelu(layer_norm(y.transpose(1, 2), d.ln.w, d.ln.b))

    with torch.no_grad():
        lib_runs = [cuda_ms(gru_ds_lib, reps=3, warmup=1) for _ in range(YARDSTICK_CALLS)]
    flops = R * T100 * 2.0 * H * 3 * H + R * T50 * 2.0 * 5 * H * H
    nbytes = (xp.numel() + R * T50 * H) * 2 + (3 * H * H + 5 * H * H) * 2
    bnd, by = bound_ms(flops, nbytes)
    # float32: the cluster kernel at the tiling its rule picks; every f32
    # tiling at this R and at the run CLI's R=2 (timing only, through the
    # library's entry)
    k2_f32 = [a.float().contiguous() for a in args]
    out32 = torch.empty(R, T50, H, device="cuda")
    ptrs32 = [a.data_ptr() for a in k2_f32] + [out32.data_ptr()]
    lib2 = k2._lib()

    def k2_entry(rows, ptrs, steps, tiling_rows):
        rc = lib2.vap_gru_downsample_cluster_f32(*ptrs, rows, steps, 8, tiling_rows, _build.stream_handle(out32))
        check(rc == 0, f"gru_downsample float32 entry: CUDA error {rc}")

    f32_ms = cuda_ms(lambda: k2.gru_downsample_fused(*k2_f32), reps=3, warmup=1)
    f32_tiling = k2.fused_tiling(R, H, torch.float32)
    by_rows = {f"R={R} N={nr}": cuda_ms(lambda nr=nr: k2_entry(R, ptrs32, T100, nr), reps=2, warmup=1)
               for _, nr in gru_cluster.F32_DOWNSAMPLE_TILINGS if nr >= 8}
    x2 = k2_f32[0][:2].contiguous()
    h2 = k2_f32[3][:2].contiguous()
    out2 = torch.empty(2, T50, H, device="cuda")
    ptrs2 = [x2.data_ptr(), k2_f32[1].data_ptr(), k2_f32[2].data_ptr(), h2.data_ptr(),
             *[a.data_ptr() for a in k2_f32[4:]], out2.data_ptr()]
    by_rows.update({f"R=2 N={nr}": cuda_ms(lambda nr=nr: k2_entry(2, ptrs2, T100, nr), reps=3, warmup=1)
                    for _, nr in gru_cluster.F32_DOWNSAMPLE_TILINGS})
    gru_lib32 = torch.nn.GRU(H, H, batch_first=True).to("cuda").requires_grad_(False)
    with torch.no_grad():
        gru_lib32.weight_ih_l0.copy_(g.w_ih.float().T)
        gru_lib32.weight_hh_l0.copy_(g.w_hh.float().T)
        gru_lib32.bias_ih_l0.copy_(g.b_ih.float())
        gru_lib32.bias_hh_l0.copy_(g.b_hh.float())
    z32 = z.float()
    d32 = [t.float() for t in (d.conv.w, d.conv.b, d.ln.w, d.ln.b)]

    def gru_ds_lib32():
        ys, _ = gru_lib32(z32)
        y = F.conv1d(F.pad(ys.transpose(1, 2), (4, 0)), d32[0].permute(2, 1, 0), d32[1], stride=2)
        return F.gelu(layer_norm(y.transpose(1, 2), d32[2], d32[3]))

    with torch.no_grad():
        lib_runs32 = [cuda_ms(gru_ds_lib32, reps=3, warmup=1) for _ in range(YARDSTICK_CALLS)]
    f32_bnd, f32_by = bound_ms(flops, 2 * nbytes, PEAK_F32_FLOPS)
    del k2_f32, out32, x2, h2, out2, z32, gru_lib32
    kernels.append(dict(
        name="gru_downsample", route="cuda", source="voiceactivityprojection_tpu_torch/csrc/gru_downsample.cu",
        cluster_source="voiceactivityprojection_tpu_torch/csrc/gru_cluster.cuh",
        f32_cluster_source="voiceactivityprojection_tpu_torch/csrc/gru_cluster_f32.cuh",
        replaces="voiceactivityprojection_tpu/ops/gru_pallas.py:94",
        launches=launches["gru_downsample"], launches_per_train_step=train_counts[0]["gru_downsample"],
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, **yardstick(lib_runs),
        design=gru_design(k2.fused_tiling(R, H, dt16), f32_tiling), us_per_step=ms * 1e3 / T100,
        f32_ms=f32_ms, f32_us_per_step=f32_ms * 1e3 / T100, f32_ms_by_tiling=by_rows, max_abs_err_f32=errs[("gru_downsample", torch.float32)],
        f32_bound_ms=f32_bnd, f32_bound_by=f32_by,
        f32_library_ms=float(np.median(lib_runs32)), f32_library_ms_min=min(lib_runs32),
        f32_library_ms_max=max(lib_runs32), f32_launches=f32_launches("gru_downsample"),
        library_note="torch.nn.GRU (includes the x @ W_ih projection) + F.conv1d downsample + LN + GELU; "
                     f"the median of {YARDSTICK_CALLS} separate timings (f32_library_ms the same in float32, "
                     "TF32 off)",
        f32_note="f32_ms: the f32 cluster kernel at the tiling its rule picks; f32_ms_by_tiling: "
                 "each f32 tiling forced through vap_gru_downsample_cluster_f32 (timing only) at R=128 and at "
                 "the run CLI's R=2"))
    del xp, z
    torch.cuda.empty_cache()

    # GRU recurrence at the train step's R=32 x 2000 steps
    RT = 2 * TB
    xp = (0.5 * torch.randn(RT, T100, 3 * H, generator=gen)).to("cuda", dt16)
    h0 = torch.zeros(RT, H, device="cuda", dtype=dt16)
    args = [xp, g.w_hh, g.b_hh, h0]
    ms = cuda_ms(lambda: k3.gru_recurrence(*args), reps=3, warmup=1)
    plain = cuda_ms(lambda: k3.gru_recurrence_reference(*args), reps=1, warmup=1)
    # float32: the f32 cluster kernel, and the block kernel it took over from
    # on the same inputs (timing only, through the library's entry: the
    # wrapper does not count it)
    k3_f32 = [a.float().contiguous() for a in args]
    f32_ms = cuda_ms(lambda: k3.gru_recurrence(*k3_f32), reps=3, warmup=1)
    lib3 = k3._lib()

    def k3_block(a, ys):
        rc = lib3.vap_gru_recurrence(*(t.data_ptr() for t in a), ys.data_ptr(), a[0].shape[0], a[0].shape[1], H,
                                     0, _build.stream_handle(ys))
        check(rc == 0, f"gru_recurrence block entry: CUDA error {rc}")

    ys_block = torch.empty(RT, T100, H, device="cuda")
    f32_block_ms = cuda_ms(lambda: k3_block(k3_f32, ys_block), reps=2, warmup=1)
    del ys_block
    w32, b32 = k3_f32[1], k3_f32[2]
    zt = torch.relu(torch.randn(RT, T100, H, generator=gen)).to("cuda", dt16)
    with torch.no_grad():
        lib = cuda_ms(lambda: gru_lib(zt), reps=3, warmup=1)

    def gru_bound(rows, steps, esize=2, peak=PEAK_BF16_FLOPS):
        flops = rows * steps * 2.0 * H * 3 * H
        nbytes = (rows * steps * 3 * H + rows * steps * H + rows * H) * esize + (3 * H * H + 3 * H) * esize
        return bound_ms(flops, nbytes, peak)

    bnd, by = gru_bound(RT, T100)
    # the 600 s call's shard shape: both channels of one shard, 15,000 steps,
    # in bf16 and in float32 (the f32 cluster kernel, the block kernel)
    T_shard = 2 * T50_long // shards
    xs = (0.5 * torch.randn(2, T_shard, 3 * H, generator=gen)).to("cuda", dt16)
    hs = torch.zeros(2, H, device="cuda", dtype=dt16)
    ms_shard = cuda_ms(lambda: k3.gru_recurrence(xs, g.w_hh, g.b_hh, hs), reps=2, warmup=1)
    zs = torch.relu(torch.randn(2, T_shard, H, generator=gen)).to("cuda", dt16)
    with torch.no_grad():
        lib_shard = cuda_ms(lambda: gru_lib(zs), reps=2, warmup=1)
    bnd_shard, by_shard = gru_bound(2, T_shard)
    shard32 = [xs.float(), w32, b32, hs.float()]
    f32_ms_shard = cuda_ms(lambda: k3.gru_recurrence(*shard32), reps=2, warmup=1)
    ys_block = torch.empty(2, T_shard, H, device="cuda")
    f32_block_shard = cuda_ms(lambda: k3_block(shard32, ys_block), reps=1, warmup=1)
    del xs, ys_block, shard32
    # the streamers' shapes (a hop: T = 1 or 2, h0 nonzero): the f32 cluster
    # kernel and the block kernel each through its library entry, and a call
    # of the wrapper (its checks, tiling and allocation) beside them
    at_streaming = {}
    for Rs, Ts in ((2, 1), (2, 2), (128, 2), (512, 2)):
        sa = [(0.5 * torch.randn(Rs, Ts, 3 * H, generator=gen)).cuda(), w32, b32,
              (0.1 * torch.randn(Rs, H, generator=gen)).cuda()]
        ys_s = torch.empty(Rs, Ts, H, device="cuda")
        tl = k3.forward_tiling(Rs, H, torch.float32)

        def k3_cluster():
            rc = lib3.vap_gru_recurrence_cluster_f32(*(t.data_ptr() for t in sa), ys_s.data_ptr(), Rs, Ts,
                                                     tl.cluster, tl.rows, _build.stream_handle(ys_s))
            check(rc == 0, f"gru_recurrence f32 cluster entry: CUDA error {rc}")

        at_streaming[f"R={Rs} T={Ts}"] = {
            "f32_cluster_ms": cuda_ms(k3_cluster, reps=50, warmup=5),
            "f32_block_ms": cuda_ms(lambda: k3_block(sa, ys_s), reps=50, warmup=5),
            "f32_wrapper_ms": cuda_ms(lambda: k3.gru_recurrence(*sa), reps=50, warmup=5),
            "f32_tiling": {"rows": tl.rows, "clusters": tl.tiles, "waves": tl.waves}}
        del sa, ys_s
    # float32: cuDNN's GRU in float32 at R=32 and at the shard shape
    gru_lib.float()  # in place: its bf16 timings are done
    zt32, zs32 = zt.float(), zs.float()
    with torch.no_grad():
        lib32 = cuda_ms(lambda: gru_lib(zt32), reps=3, warmup=1)
        lib32_shard = cuda_ms(lambda: gru_lib(zs32), reps=2, warmup=1)
        # the streamers' shapes: cuDNN's float32 GRU on a hop's frames, and
        # the bound (W_hh and the hop's tensors at the HBM rate)
        for key, entry in at_streaming.items():
            Rs, Ts = (int(v.split("=")[1]) for v in key.split())
            zh = torch.relu(torch.randn(Rs, Ts, H, generator=gen)).cuda()
            entry["f32_library_ms"] = cuda_ms(lambda: gru_lib(zh), reps=50, warmup=5)
            entry["f32_bound_ms"], entry["f32_bound_by"] = gru_bound(Rs, Ts, 4, PEAK_F32_FLOPS)
    bnd32, by32 = gru_bound(RT, T100, 4, PEAK_F32_FLOPS)
    bnd32_shard, by32_shard = gru_bound(2, T_shard, 4, PEAK_F32_FLOPS)
    del zt32, zs32, zs
    kernels.append(dict(
        name="gru_recurrence", route="cuda", source="voiceactivityprojection_tpu_torch/csrc/gru_recurrence.cu",
        replaces="voiceactivityprojection_tpu/ops/gru_pallas.py:49",
        launches=train_counts[0]["gru_recurrence"] * len(train_counts), launches_per_train_step=train_counts[0]["gru_recurrence"],
        max_abs_err=errs[("gru_recurrence", dt16)], max_abs_err_f32=errs[("gru_recurrence", torch.float32)],
        ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib,
        us_per_step=ms * 1e3 / T100, f32_ms=f32_ms, f32_us_per_step=f32_ms * 1e3 / T100, f32_block_ms=f32_block_ms,
        design=gru_design(k3.forward_tiling(RT, H, dt16), k3.forward_tiling(RT, H, torch.float32)),
        f32_bound_ms=bnd32, f32_bound_by=by32, f32_library_ms=lib32, f32_launches=f32_launches("gru_recurrence"),
        registers=kernel_registers(_build, "gru_recurrence"),
        cluster_source="voiceactivityprojection_tpu_torch/csrc/gru_cluster.cuh",
        f32_cluster_source="voiceactivityprojection_tpu_torch/csrc/gru_cluster_f32.cuh",
        at_600s_shard_shape=dict(shape=[2, T_shard, 3 * H], dtype="bfloat16", ms=ms_shard,
                                 us_per_step=ms_shard * 1e3 / T_shard, bound_ms=bnd_shard, bound_by=by_shard,
                                 library_ms=lib_shard, launches_per_call=cp_counts["bfloat16"]["gru_recurrence"],
                                 f32_ms=f32_ms_shard, f32_us_per_step=f32_ms_shard * 1e3 / T_shard,
                                 f32_block_ms=f32_block_shard, f32_bound_ms=bnd32_shard, f32_bound_by=by32_shard,
                                 f32_library_ms=lib32_shard,
                                 f32_launches_per_call=cp_counts["float32"]["gru_recurrence"],
                                 design=gru_design(k3.forward_tiling(2, H, dt16),
                                                   k3.forward_tiling(2, H, torch.float32))),
        f32_at_streaming_shapes=at_streaming,
        f32_note="f32_ms: the f32 cluster kernel at the tiling its rule picks; f32_block_ms: the block kernel it "
                 "took over from, on the same inputs through vap_gru_recurrence (timing only); "
                 "f32_at_streaming_shapes: both kernels through their library entries, and the wrapper",
        library_note="torch.nn.GRU forward (includes the x @ W_ih projection); f32_library_ms the same in "
                     "float32, TF32 off"))
    del xp, zt, gru_lib, k3_f32
    torch.cuda.empty_cache()

    # the GRU step's time against the rows it carries: the bf16 cluster
    # kernel, the float32 cluster kernel and the float32 block kernel (one
    # block a row, W_hh from L2; timing only, through the library's entry)
    sweep = []
    for rows in (2, 8, 32, 128):
        xw = (0.5 * torch.randn(rows, T100, 3 * H, generator=gen)).to("cuda", dt16)
        hw = torch.zeros(rows, H, device="cuda", dtype=dt16)
        w16 = [xw, g.w_hh, g.b_hh, hw]
        w32 = [a.float().contiguous() for a in w16]
        ys_block = torch.empty(rows, T100, H, device="cuda")
        t16 = cuda_ms(lambda: k3.gru_recurrence(*w16), reps=2, warmup=1)
        t32 = cuda_ms(lambda: k3.gru_recurrence(*w32), reps=2, warmup=1)
        t32_block = cuda_ms(lambda: k3_block(w32, ys_block), reps=2, warmup=1)
        tl = k3.forward_tiling(rows, H, dt16)
        tl32 = k3.forward_tiling(rows, H, torch.float32)
        sweep.append({"rows": rows, "steps": T100, "bf16_cluster_us_per_step": t16 * 1e3 / T100,
                      "f32_cluster_us_per_step": t32 * 1e3 / T100, "f32_block_us_per_step": t32_block * 1e3 / T100,
                      "tiling": {"cluster": tl.cluster, "rows": tl.rows, "clusters": tl.tiles, "waves": tl.waves},
                      "f32_tiling": {"cluster": tl32.cluster, "rows": tl32.rows, "clusters": tl32.tiles,
                                     "waves": tl32.waves}})
        del xw, w16, w32, ys_block
    emit("gru_rows_sweep", card=smi, sweep=sweep)
    torch.cuda.empty_cache()

    # GRU backward at the unfrozen step's R=32 x 2000 (bfloat16) and the CPC
    # step's R=32 x 128 (float32)
    def gru_backward_times(Rb, Tb, dtype):
        w_hh = state["encoder.gAR.w_hh"].to("cuda", dtype)
        b_hh = state["encoder.gAR.b_hh"].to("cuda", dtype)
        xpb = (0.5 * torch.randn(Rb, Tb, 3 * H, generator=gen)).to("cuda", dtype)
        h0b = torch.zeros(Rb, H, device="cuda", dtype=dtype)
        ys, _ = k3.gru_recurrence(xpb, w_hh, b_hh, h0b)
        dys = torch.randn(Rb, Tb, H, generator=gen).to("cuda", dtype)
        args = [xpb, w_hh, b_hh, h0b, ys, dys]
        ms = cuda_ms(lambda: k3.gru_backward(*args), reps=3, warmup=1)
        plain = cuda_ms(lambda: k3.gru_backward_reference(*args), reps=1, warmup=1)
        # yardstick: cuDNN's GRU backward with the same weights (forward +
        # backward less forward; it also computes dW_ih and dx, which the
        # port leaves to torch.matmul outside the kernel)
        lib_gru = torch.nn.GRU(H, H, batch_first=True).to("cuda", dtype)
        with torch.no_grad():
            lib_gru.weight_hh_l0.copy_(w_hh.T)
            lib_gru.bias_hh_l0.copy_(b_hh)
        zb = torch.relu(torch.randn(Rb, Tb, H, generator=gen)).to("cuda", dtype).requires_grad_()
        lib_leaves = [zb, *lib_gru.parameters()]
        lib_runs = []
        for _ in range(YARDSTICK_CALLS):
            fwd = cuda_ms(lambda: lib_gru(zb)[0], reps=3, warmup=1)
            fwd_bwd = cuda_ms(lambda: torch.autograd.grad(lib_gru(zb)[0], lib_leaves, dys), reps=3, warmup=1)
            lib_runs.append(fwd_bwd - fwd)
        esize = torch.finfo(dtype).bits // 8
        # each step recomputes h @ W_hh, forms dgates @ W_hh^T and adds h^T dgates
        flops = 3 * Rb * Tb * 2.0 * H * 3 * H
        nbytes = esize * (2 * Rb * Tb * 3 * H + 2 * Rb * Tb * H + 2 * (3 * H * H + 3 * H) + 2 * Rb * H)
        bnd, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS if dtype == dt16 else PEAK_F32_FLOPS)
        out = dict(shape=[Rb, Tb, 3 * H], dtype=str(dtype), ms=ms, plain_ms=plain, bound_ms=bnd,
                   bound_by=by, **yardstick(lib_runs), us_per_step=ms * 1e3 / Tb)

        def phases(a, dt):
            """Each launch of the dtype's cluster design alone on the buffers
            of one call (timing only: these launches are not the wrapper's,
            nor counted), the recurrence's us a step and the design."""
            tiling = k3.backward_tiling(Rb, H, dt)
            launch, _ = k3.cluster_backward_launcher(*a, tiling)
            launch(sum(k3.BACKWARD_PHASES.values()))
            per = {name: cuda_ms(lambda bit=bit: launch(bit), reps=3, warmup=1)
                   for name, bit in k3.BACKWARD_PHASES.items()}
            splits = (k3.cluster_weight_splits if dt == dt16 else k3.f32_cluster_weight_splits)(Rb * Tb)
            return per, per["recurrence"] * 1e3 / Tb, gru_backward_design(tiling, splits, dt)

        out["per_phase_ms"], out["recurrence_us_per_step"], out["design"] = phases(args, dtype)
        if dtype == dt16:
            # the float32 cluster design at the same shape, and cuDNN's
            # float32 GRU backward there (TF32 off; the median of five timings)
            f32_args = [a.float() for a in args]
            out["f32_ms"] = cuda_ms(lambda: k3.gru_backward(*f32_args), reps=3, warmup=1)
            out["f32_per_phase_ms"], out["f32_recurrence_us_per_step"], out["f32_design"] = phases(
                f32_args, torch.float32)
            out["f32_bound_ms"], out["f32_bound_by"] = bound_ms(flops, 2 * nbytes, PEAK_F32_FLOPS)
            lib_gru.float()
            zb32 = zb.detach().float().requires_grad_()
            dys32 = dys.float()
            leaves32 = [zb32, *lib_gru.parameters()]
            runs32 = []
            for _ in range(YARDSTICK_CALLS):
                fwd = cuda_ms(lambda: lib_gru(zb32)[0], reps=2, warmup=1)
                fwd_bwd = cuda_ms(lambda: torch.autograd.grad(lib_gru(zb32)[0], leaves32, dys32), reps=2, warmup=1)
                runs32.append(fwd_bwd - fwd)
            out.update({f"f32_{k}": v for k, v in yardstick(runs32).items()})
            del f32_args, zb32, dys32, leaves32
        return out

    k9_train = gru_backward_times(RT, T100, dt16)
    torch.cuda.empty_cache()
    k9_cpc = gru_backward_times(CB, cpc.encoded_frames(CN), torch.float32)
    torch.cuda.empty_cache()
    regs_k9 = kernel_registers(_build, "gru_backward")
    kernels.append(dict(
        name="gru_backward", route="cuda", source="voiceactivityprojection_tpu_torch/csrc/gru_backward.cu",
        cluster_source="voiceactivityprojection_tpu_torch/csrc/gru_bwd_cluster.cuh",
        f32_source="voiceactivityprojection_tpu_torch/csrc/gru_bwd_cluster_f32.cuh",
        replaces="voiceactivityprojection_tpu/ops/gru_pallas.py:300",
        launches=sum(c["gru_backward"] for c in unfrozen_counts),
        launches_cpc=sum(c["gru_backward"] for c in cpc_counts),
        max_abs_err=errs[("gru_backward", dt16)], max_abs_err_f32=errs[("gru_backward", torch.float32)],
        **{k: k9_train[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_ms_min",
                                    "library_ms_max", "us_per_step", "per_phase_ms", "recurrence_us_per_step",
                                    "f32_ms", "f32_per_phase_ms", "f32_recurrence_us_per_step", "f32_design",
                                    "f32_bound_ms", "f32_bound_by", "f32_library_ms",
                                    "f32_library_ms_min", "f32_library_ms_max", "f32_library_runs_ms")},
        design={"bfloat16": k9_train["design"], "float32": k9_train["f32_design"], "rule": GRU_BACKWARD_RULE},
        f32_launches=f32_launches("gru_backward"),
        f32_note="float32 runs the f32 cluster design (csrc/gru_bwd_cluster_f32.cuh); its default paths are the "
                 "CPC step (at_cpc_shape: ms, per phase, bound, cuDNN's float32 GRU backward as library_ms) and "
                 "the unfrozen f32 step (per_f32_unfrozen_step: phase 6's step against the CPU); f32_ms, "
                 "f32_per_phase_ms, f32_bound_ms and f32_library_ms (cuDNN in float32, TF32 off, the median of "
                 "five) at the train shape",
        registers=regs_k9,
        f32_registers={k: v for k, v in regs_k9.items() if "3gbf" in k} if isinstance(regs_k9, dict) else regs_k9,
        at_cpc_shape=k9_cpc,
        library_note="cuDNN torch.nn.GRU, forward + backward less forward (also computes dW_ih and dx); "
                     f"the median of {YARDSTICK_CALLS} separate timings"))

    # training attention at the train step's B=16, H=4, T=1000, Dh=64, rate 0.1
    Hh, Dh, T = conf.num_heads, conf.dim // conf.num_heads, T50
    rate = conf.dropout
    q, kk, v, do = (torch.randn(TB, Hh, T, Dh, generator=gen).to("cuda", dt16) for _ in range(4))
    slopes = alibi_slopes(Hh).to(dt16).to("cuda")
    scale = 1.0 / math.sqrt(conf.dim)
    out, lse = ft.flash_train_forward(q, kk, v, slopes, 5, scale, rate)
    pairs = T * (T + 1) / 2
    ms_f = cuda_ms(lambda: ft.flash_train_forward(q, kk, v, slopes, 5, scale, rate), reps=10)
    f32_fwd_args = [t.float() for t in (q, kk, v)] + [slopes.float()]
    f32_f = cuda_ms(lambda: ft.flash_train_forward(*f32_fwd_args, 5, scale, rate), reps=5)
    del f32_fwd_args
    plain_f = cuda_ms(lambda: ft.train_forward_reference(q, kk, v, slopes, 5, scale, rate), reps=3)
    ms_b = cuda_ms(lambda: ft.flash_train_backward(q, kk, v, slopes, 5, out, lse, do, scale, rate), reps=10)
    f32_args = [t.float() for t in (q, kk, v)] + [slopes.float(), 5, out.float(), lse, do.float()]
    f32_b = cuda_ms(lambda: ft.flash_train_backward(*f32_args, scale, rate), reps=5)
    del f32_args
    delta = (do.float() * out.float()).sum(-1).reshape(TB * Hh, T)
    plain_b = cuda_ms(lambda: ft.train_backward_reference(q, kk, v, do, lse, delta, slopes, 5, scale, rate),
                      reps=3)
    i = torch.arange(T, device="cuda")
    rel = (i[None, :] - i[:, None]).float()
    mask = (slopes.float()[:, None, None] * rel).masked_fill(rel > 0, float("-inf")).to(dt16)
    leaves = [t.clone().requires_grad_() for t in (q, kk, v)]
    sdpa = lambda: F.scaled_dot_product_attention(*leaves, attn_mask=mask, dropout_p=rate, scale=scale)
    lib_f = cuda_ms(lambda: sdpa().detach(), reps=10)
    o_lib = sdpa()
    lib_b = cuda_ms(lambda: torch.autograd.grad(o_lib, leaves, do, retain_graph=True), reps=10)
    # the same calls in float32 (the mask made in float32)
    mask32 = (slopes.float()[:, None, None] * rel).masked_fill(rel > 0, float("-inf"))
    leaves32 = [t.float().requires_grad_() for t in leaves]
    sdpa32 = lambda: F.scaled_dot_product_attention(*leaves32, attn_mask=mask32, dropout_p=rate, scale=scale)
    lib_f32 = cuda_ms(lambda: sdpa32().detach(), reps=5)
    o_lib32 = sdpa32()
    do32 = do.float()
    lib_b32 = cuda_ms(lambda: torch.autograd.grad(o_lib32, leaves32, do32, retain_graph=True), reps=5)
    del leaves32, o_lib32, do32
    io = TB * Hh * T * Dh * 2
    bnd_f, by_f = bound_ms(TB * Hh * 2.0 * 2 * Dh * pairs, 4 * io + TB * Hh * T * 4)
    # float32 forward: S and P V, three TF32 products each at the TF32 rate
    # (in FFMA-rate operations, for bound_ms), and all at the FFMA rate beside it
    bnd_f32, by_f32 = bound_ms(3 * TB * Hh * 2.0 * 2 * Dh * pairs * PEAK_F32_FLOPS / PEAK_TF32_FLOPS,
                               8 * io + TB * Hh * T * 4, PEAK_F32_FLOPS)
    ffma_f32, _ = bound_ms(TB * Hh * 2.0 * 2 * Dh * pairs, 8 * io + TB * Hh * T * 4, PEAK_F32_FLOPS)
    # S = QK^T recomputed, dP, dV, dQ, dK: five products over the causal pairs
    bnd_b, by_b = bound_ms(TB * Hh * 5 * 2.0 * Dh * pairs, 7 * io + 2 * TB * Hh * T * 4)
    # float32 backward: three TF32 products a product at the TF32 rate (in
    # FFMA-rate operations, for bound_ms), and all at the FFMA rate beside it
    bnd_b32, by_b32 = bound_ms(3 * TB * Hh * 5 * 2.0 * Dh * pairs * PEAK_F32_FLOPS / PEAK_TF32_FLOPS,
                               14 * io + 2 * TB * Hh * T * 4, PEAK_F32_FLOPS)
    ffma_b32, _ = bound_ms(TB * Hh * 5 * 2.0 * Dh * pairs, 14 * io + 2 * TB * Hh * T * 4, PEAK_F32_FLOPS)
    kernels.append(dict(
        name="flash_train_forward", route="cuda",
        source="voiceactivityprojection_tpu_torch/csrc/flash_alibi_train.cu",
        replaces="voiceactivityprojection_tpu/ops/flash_alibi_train.py:122",
        launches=train_counts[0]["flash_train_forward"] * len(train_counts),
        launches_per_train_step=train_counts[0]["flash_train_forward"],
        max_abs_err=errs[("flash_train_forward", dt16)], max_abs_err_f32=errs[("flash_train_forward", torch.float32)],
        ms=ms_f, plain_ms=plain_f, bound_ms=bnd_f, bound_by=by_f, library_ms=lib_f,
        design=DESIGN, f32_ms=f32_f, f32_bound_ms=bnd_f32, f32_bound_by=by_f32, f32_ffma_bound_ms=ffma_f32,
        f32_library_ms=lib_f32, f32_launches=f32_launches("flash_train_forward"), f32_note=ATTN_F32_NOTE,
        registers=kernel_registers(_build, "flash_alibi_train"),
        library_note="F.scaled_dot_product_attention, float ALiBi + causal mask, dropout_p=0.1"))
    kernels.append(dict(
        name="flash_train_backward", route="cuda",
        source="voiceactivityprojection_tpu_torch/csrc/flash_alibi_train.cu",
        replaces="voiceactivityprojection_tpu/ops/flash_alibi_train.py:366",
        also_replaces=["voiceactivityprojection_tpu/ops/flash_alibi_train.py:242",
                       "voiceactivityprojection_tpu/ops/flash_alibi_train.py:297"],
        launches=train_counts[0]["flash_train_backward"] * len(train_counts),
        launches_per_train_step=train_counts[0]["flash_train_backward"],
        max_abs_err=errs[("flash_train_backward", dt16)], max_abs_err_f32=errs[("flash_train_backward", torch.float32)],
        ms=ms_b, plain_ms=plain_b, bound_ms=bnd_b, bound_by=by_b, library_ms=lib_b,
        design=DESIGN, f32_ms=f32_b, f32_bound_ms=bnd_b32, f32_bound_by=by_b32, f32_ffma_bound_ms=ffma_b32,
        f32_library_ms=lib_b32, f32_launches=f32_launches("flash_train_backward"), f32_note=ATTN_F32_NOTE,
        registers=kernel_registers(_build, "flash_alibi_train"),
        library_note="autograd backward of the same F.scaled_dot_product_attention call"))
    del q, kk, v, do, out, lse, leaves, o_lib, delta
    torch.cuda.empty_cache()

    # inference attention at B=64, H=4, T=1000, Dh=64
    q, kk, v = (torch.randn(B, Hh, T, Dh, generator=gen).to("cuda", dt16) for _ in range(3))
    err = compare("flash_alibi", k4.flash_alibi_attention(q, kk, v, slopes, scale),
                  k4.dense_reference(q, kk, v, slopes, scale), [B, Hh, T, Dh], dt16)
    ms = cuda_ms(lambda: k4.flash_alibi_attention(q, kk, v, slopes, scale), reps=10)
    plain = cuda_ms(lambda: k4.dense_reference(q, kk, v, slopes, scale), reps=5)
    q32, k32, v32 = q.float(), kk.float(), v.float()
    err32 = compare("flash_alibi", k4.flash_alibi_attention(q32, k32, v32, slopes.float(), scale),
                    k4.dense_reference(q32, k32, v32, slopes.float(), scale), [B, Hh, T, Dh], torch.float32)
    f32_ms = cuda_ms(lambda: k4.flash_alibi_attention(q32, k32, v32, slopes.float(), scale), reps=5)
    del q32, k32, v32
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, kk, v, attn_mask=mask, scale=scale), reps=10)
    q32, k32, v32 = q.float(), kk.float(), v.float()
    lib32 = cuda_ms(lambda: F.scaled_dot_product_attention(q32, k32, v32, attn_mask=mask32, scale=scale), reps=5)
    del q32, k32, v32
    bnd, by = bound_ms(B * Hh * 2.0 * 2 * Dh * pairs, 4.0 * B * Hh * T * Dh * 2)
    bnd32, by32 = bound_ms(3 * B * Hh * 2.0 * 2 * Dh * pairs * PEAK_F32_FLOPS / PEAK_TF32_FLOPS,
                           4.0 * B * Hh * T * Dh * 4, PEAK_F32_FLOPS)
    ffma32, _ = bound_ms(B * Hh * 2.0 * 2 * Dh * pairs, 4.0 * B * Hh * T * Dh * 4, PEAK_F32_FLOPS)
    regs_k4 = kernel_registers(_build, "flash_alibi")
    kernels.append(dict(
        name="flash_alibi", route="cuda", source="voiceactivityprojection_tpu_torch/csrc/flash_alibi.cu",
        replaces="voiceactivityprojection_tpu/ops/flash_alibi.py:122",
        launches=launches["flash_alibi"], launches_per_train_step=train_counts[0]["flash_alibi"],
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib,
        design=DESIGN, f32_ms=f32_ms, max_abs_err_f32=err32, f32_bound_ms=bnd32, f32_bound_by=by32,
        f32_ffma_bound_ms=ffma32, f32_library_ms=lib32, f32_launches=f32_launches("flash_alibi"),
        f32_note=ATTN_F32_NOTE, registers=regs_k4))
    del q, kk, v
    torch.cuda.empty_cache()

    # K5 (the TPU's streaming schedule, one kernel here) at its own shape:
    # B=1, H=4, T=3000, Dh=64
    T5 = 3000
    q, kk, v = (torch.randn(1, Hh, T5, Dh, generator=gen).to("cuda", dt16) for _ in range(3))
    err = compare("flash_alibi", k4.flash_alibi_attention(q, kk, v, slopes, scale),
                  k4.dense_reference(q, kk, v, slopes, scale), [1, Hh, T5, Dh], dt16)
    ms = cuda_ms(lambda: k4.flash_alibi_attention(q, kk, v, slopes, scale), reps=10)
    plain = cuda_ms(lambda: k4.dense_reference(q, kk, v, slopes, scale), reps=5)
    q32, k32, v32 = q.float(), kk.float(), v.float()
    err32 = compare("flash_alibi", k4.flash_alibi_attention(q32, k32, v32, slopes.float(), scale),
                    k4.dense_reference(q32, k32, v32, slopes.float(), scale), [1, Hh, T5, Dh], torch.float32)
    f32_ms = cuda_ms(lambda: k4.flash_alibi_attention(q32, k32, v32, slopes.float(), scale), reps=5)
    del q32, k32, v32
    i5 = torch.arange(T5, device="cuda")
    rel5 = (i5[None, :] - i5[:, None]).float()
    mask5 = (slopes.float()[:, None, None] * rel5).masked_fill(rel5 > 0, float("-inf")).to(dt16)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, kk, v, attn_mask=mask5, scale=scale), reps=10)
    q32, k32, v32 = q.float(), kk.float(), v.float()
    mask5_32 = (slopes.float()[:, None, None] * rel5).masked_fill(rel5 > 0, float("-inf"))
    lib32 = cuda_ms(lambda: F.scaled_dot_product_attention(q32, k32, v32, attn_mask=mask5_32, scale=scale), reps=5)
    del q32, k32, v32, mask5_32
    bnd, by = bound_ms(Hh * 2.0 * 2 * Dh * T5 * (T5 + 1) / 2, 4.0 * Hh * T5 * Dh * 2)
    flops5 = Hh * 2.0 * 2 * Dh * T5 * (T5 + 1) / 2
    bnd32, by32 = bound_ms(3 * flops5 * PEAK_F32_FLOPS / PEAK_TF32_FLOPS, 4.0 * Hh * T5 * Dh * 4, PEAK_F32_FLOPS)
    ffma32, _ = bound_ms(flops5, 4.0 * Hh * T5 * Dh * 4, PEAK_F32_FLOPS)
    kernels.append(dict(
        name="flash_alibi_t3000", route="cuda", source="voiceactivityprojection_tpu_torch/csrc/flash_alibi.cu",
        replaces="voiceactivityprojection_tpu/ops/flash_alibi.py:54",
        launches=launches["flash_alibi"], max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
        library_ms=lib, design=DESIGN, f32_ms=f32_ms, max_abs_err_f32=err32, shape=[1, Hh, T5, Dh],
        f32_bound_ms=bnd32, f32_bound_by=by32, f32_ffma_bound_ms=ffma32, f32_library_ms=lib32,
        f32_launches=f32_launches("flash_alibi"), f32_note=ATTN_F32_NOTE, registers=regs_k4,
        launches_note="K5 runs the K4 kernel (flash_alibi_attention): its launches on the main path",
        library_note="F.scaled_dot_product_attention, float ALiBi + causal mask"))
    del q, kk, v, mask5
    torch.cuda.empty_cache()

    # offset attention: one attention site of the 600 s call, the four
    # shards' launches (Tq = 7,500 rows at offsets 0, 7,500, 15,000, 22,500
    # of Tk = 30,000 keys)
    Tk = T50_long
    Tq = Tk // shards
    offs = [d * Tq for d in range(shards)]
    qs = [torch.randn(1, Hh, Tq, Dh, generator=gen).to("cuda", dt16) for _ in offs]
    kk, v = (torch.randn(1, Hh, Tk, Dh, generator=gen).to("cuda", dt16) for _ in range(2))
    err = max(compare("flash_alibi_offset", k4.flash_alibi_attention_offset(q, kk, v, slopes, scale, off),
                      k4.dense_offset_reference(q, kk, v, slopes, scale, off), [1, Hh, Tq, Dh], dt16,
                      Tk=Tk, offset=off)
              for q, off in zip(qs, offs))
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: [k4.flash_alibi_attention_offset(q, kk, v, slopes, scale, o) for q, o in zip(qs, offs)],
                 reps=5)
    plain = cuda_ms(lambda: [k4.dense_offset_reference(q, kk, v, slopes, scale, o) for q, o in zip(qs, offs)],
                    reps=2, warmup=1)
    torch.cuda.empty_cache()
    qs32, k32, v32 = [q.float() for q in qs], kk.float(), v.float()
    err32 = max(compare("flash_alibi_offset", k4.flash_alibi_attention_offset(q, k32, v32, slopes.float(), scale, o),
                        k4.dense_offset_reference(q, k32, v32, slopes.float(), scale, o), [1, Hh, Tq, Dh],
                        torch.float32, Tk=Tk, offset=o)
                for q, o in zip(qs32, offs))
    torch.cuda.empty_cache()
    f32_ms = cuda_ms(lambda: [k4.flash_alibi_attention_offset(q, k32, v32, slopes.float(), scale, o)
                              for q, o in zip(qs32, offs)], reps=2, warmup=1)
    del qs32, k32, v32
    j = torch.arange(Tk, device="cuda")

    def offset_mask(off):
        rel = (j[None, :] - (off + torch.arange(Tq, device="cuda"))[:, None]).float()
        return (slopes.float()[:, None, None] * rel).masked_fill(rel > 0, float("-inf")).to(dt16)

    masks = [offset_mask(o) for o in offs]
    lib = cuda_ms(lambda: [F.scaled_dot_product_attention(q, kk, v, attn_mask=m, scale=scale)
                           for q, m in zip(qs, masks)], reps=5)
    del masks
    torch.cuda.empty_cache()
    qs32, k32, v32 = [q.float() for q in qs], kk.float(), v.float()
    masks32 = [offset_mask(o).float() for o in offs]
    lib32 = cuda_ms(lambda: [F.scaled_dot_product_attention(q, k32, v32, attn_mask=m, scale=scale)
                             for q, m in zip(qs32, masks32)], reps=2, warmup=1)
    del qs32, k32, v32, masks32
    torch.cuda.empty_cache()
    flops = sum(4.0 * Dh * Hh * (Tq * o + Tq * (Tq + 1) / 2) for o in offs)
    nbytes = sum((Tq + 2 * Tk) * Hh * Dh * 2 + Tq * Hh * Dh * 2 for _ in offs)
    bnd, by = bound_ms(flops, nbytes)
    bnd32, by32 = bound_ms(3 * flops * PEAK_F32_FLOPS / PEAK_TF32_FLOPS, 2 * nbytes, PEAK_F32_FLOPS)
    ffma32, _ = bound_ms(flops, 2 * nbytes, PEAK_F32_FLOPS)
    kernels.append(dict(
        name="flash_alibi_offset", route="cuda", source="voiceactivityprojection_tpu_torch/csrc/flash_alibi.cu",
        replaces="voiceactivityprojection_tpu/ops/flash_alibi.py:590",
        launches=cp_counts["bfloat16"]["flash_alibi_offset"], max_abs_err=err, ms=ms, plain_ms=plain,
        bound_ms=bnd, bound_by=by, library_ms=lib,
        design=DESIGN, f32_ms=f32_ms, max_abs_err_f32=err32, f32_bound_ms=bnd32, f32_bound_by=by32,
        f32_ffma_bound_ms=ffma32, f32_library_ms=lib32, f32_launches=f32_launches("flash_alibi_offset"),
        f32_note=ATTN_F32_NOTE, registers=regs_k4,
        shape=f"one site of the {LONG_S:.0f} s call: {shards} launches, Tq={Tq} at offsets {offs} of Tk={Tk}, "
              f"H={Hh}, bf16", launches_per_call_note="per probs_context_parallel call (14 sites x 4 shards)",
        library_note="F.scaled_dot_product_attention per shard, float offset-ALiBi + causal mask"))
    del qs, kk, v
    torch.cuda.empty_cache()

    # conv0 + conv1 at R=128 x 320000 (the B=64 request of VAP_CONV_IMPL=fused)
    lw01 = lw16[:2]
    x = (0.1 * torch.randn(R, n, generator=gen)).to("cuda", dt16)
    err = compare("conv01", k11.fused_conv01(lw01, x), k11.reference_unfused(lw01, x), [R, n], dt16)
    torch.cuda.empty_cache()
    # which kernel a launch of each dtype takes, by the library's own counts
    x32, lw32 = x.float(), [tuple(t.float() for t in l) for l in lw01]
    launched = {}
    for dt, xin, lwin in ((dt16, x, lw01), (torch.float32, x32, lw32)):
        before = k11.kernel_launches()
        k11.fused_conv01(lwin, xin)
        sync()
        after = k11.kernel_launches()
        launched[str(dt)[6:]] = {k: after[k] - before[k] for k in after}
        want = dict.fromkeys(after, 0)
        want[k11.route(dt)] = 1
        check(launched[str(dt)[6:]] == want, f"{dt} fused_conv01 ran its kernel: {launched}")
    torch.cuda.empty_cache()
    err32 = compare("conv01", k11.fused_conv01(lw32, x32), k11.reference_unfused(lw32, x32), [R, n], torch.float32)
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: k11.fused_conv01(lw01, x))
    plain = cuda_ms(lambda: k11.reference_unfused(lw01, x), reps=2, warmup=1)
    torch.cuda.empty_cache()

    lib = cuda_ms(lambda: conv1d_lib(lw01, x), reps=2, warmup=1)
    torch.cuda.empty_cache()
    f32_ms = cuda_ms(lambda: k11.fused_conv01(lw32, x32), reps=3, warmup=1)
    f32_lib = cuda_ms(lambda: conv1d_lib(lw32, x32), reps=1, warmup=1)
    del x32, lw32
    torch.cuda.empty_cache()

    def conv01_bound(rows, samples, esize=2, peak=PEAK_BF16_FLOPS):
        n0 = (samples + 2 * k11.P0 - k11.K0) // k11.S0 + 1
        n1 = k11.out_len(samples)
        flops = 2.0 * rows * (n0 * k11.K0 * 256 + n1 * k11.K1 * 256 * 256)
        weights = sum(t.numel() for l in lw01 for t in l) * esize
        return bound_ms(flops, (rows * samples + rows * n1 * 256) * esize + weights, peak)

    bnd, by = conv01_bound(R, n)
    bnd32, by32 = conv01_bound(R, n, 4, PEAK_F32_FLOPS)
    # the float32 route: conv1 as three TF32 products, conv0 in f32 FFMA
    n0_ = (n + 2 * k11.P0 - k11.K0) // k11.S0 + 1
    f32_conv0_ms = 2.0 * R * n0_ * k11.K0 * 256 / PEAK_F32_FLOPS * 1e3
    f32_conv1_ms = 3 * 2.0 * R * k11.out_len(n) * k11.K1 * 256 * 256 / PEAK_TF32_FLOPS * 1e3
    bnd_tf32 = max(f32_conv0_ms + f32_conv1_ms, (R * n + R * k11.out_len(n) * 256) * 4 / PEAK_BYTES * 1e3)
    # the 600 s call's shard shape: both channels, the shard's frames and the
    # margins, as phase 3 checks it
    n_shard = (t100_shard + 2 * cp_margin) * 160
    xs = (0.1 * torch.randn(2, n_shard, generator=gen)).to("cuda", dt16)
    shard_ms = cuda_ms(lambda: k11.fused_conv01(lw01, xs), reps=5, warmup=2)
    shard_bound, shard_by = conv01_bound(2, n_shard)
    del xs
    kernels.append(dict(
        name="conv01", route="cuda", source="voiceactivityprojection_tpu_torch/csrc/conv_fused.cu",
        wgmma_source="voiceactivityprojection_tpu_torch/csrc/conv01_wgmma.cuh",
        replaces="voiceactivityprojection_tpu/ops/conv_fused.py:82",
        launches=cp_counts[("bfloat16", "fused")]["conv01"], launches_per_request=fused_counts["conv01"] // 2,
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib,
        design={**k11.DESIGN, "route_bfloat16": k11.route(dt16), **k11.kernel_info(dt16),
                "cluster": 1,  # launched with no cluster attribute: each CTA loads all of W1
                "launched": launched,
                "rule": "by dtype: bfloat16 the wgmma kernel, float32 the 3xTF32 kernel after one split of W1 "
                        "(K1's split kernel); a refused launch raises"},
        f32_design={"route": k11.route(torch.float32), **k11.kernel_info(torch.float32),
                    "text": k11.DESIGN["float32"]},
        max_abs_err_f32=err32, f32_ms=f32_ms, f32_bound_ms=bnd_tf32, f32_bound_by="operations",
        f32_ffma_bound_ms=bnd32, f32_library_ms=f32_lib,
        f32_note="f32_bound_ms: conv0 at 67 TFLOP/s and conv1 as three TF32 products at 495; f32_ffma_bound_ms: "
                 "all at 67 TFLOP/s (the CUDA cores); f32_library_ms: the same PyTorch calls in float32, TF32 off",
        f32_launches=f32_launches("conv01"), registers=kernel_registers(_build, "conv_fused"),
        per_layer_ms={"conv_stack_conv0": per_layer[0], "conv_stack_conv1": per_layer[1],
                      "sum": per_layer[0] + per_layer[1]},
        at_shard_shape={"shape": [2, n_shard], "ms": shard_ms, "bound_ms": shard_bound, "bound_by": shard_by,
                        "launches_per_600s_call": shards},
        backward_max_abs_err_f32=conv01_bwd,
        launches_note="per probs_context_parallel call under VAP_CONV_IMPL=fused (one per shard)",
        library_note="cuDNN F.conv1d x 2 + ChannelNorm + ReLU"))
    del x
    kernels.append(kv_attention_entry(port, conf, state, reset_counts, read_counts))
    # K13: float32 only (bfloat16 projections take torch.matmul)
    kernels.append(linear_entry(f32_launches("linear")))
    torch.cuda.empty_cache()
    for kern in kernels:
        counter = "flash_alibi" if kern["name"] == "flash_alibi_t3000" else kern["name"]
        kern["launches_per_unfrozen_step"] = unfrozen_counts[0][counter]
        kern["launches_per_cpc_step"] = cpc_counts[0][counter]
        check(kern["launches"] > 0, f"{kern['name']} ran on the main path")
    emit("timing", card=smi, dtype="bfloat16", batch=B, train_batch=TB,
         per_forward={k: launches[k] // 3 for k in launches}, per_train_step=train_counts[0],
         per_unfrozen_step=unfrozen_counts[0], per_cpc_step=cpc_counts[0],
         per_context_parallel_call=cp_counts["bfloat16"],
         seconds_total=time.perf_counter() - t_start)
    torch.cuda.empty_cache()

    # 12. offline extraction: the run CLI, as a user runs it ------------------
    start_phase("12. offline extraction")
    offline = offline_extraction(state, smi, per_forward, per_cp_call, reset_counts, read_counts)
    for kern in kernels:
        counter = "flash_alibi" if kern["name"] == "flash_alibi_t3000" else kern["name"]
        kern["launches_offline_extraction"] = {mode: counts[counter] for mode, counts in offline.items()}

    # 13. evaluation: the test split of a corpus, as a user evaluates --------
    start_phase("13. evaluation")
    evaluated = evaluation(state, smi, reset_counts, read_counts)
    for kern in kernels:
        counter = "flash_alibi" if kern["name"] == "flash_alibi_t3000" else kern["name"]
        kern["launches_evaluation"] = {dtype: [c[counter] for c in per_batch]
                                       for dtype, per_batch in evaluated.items()}

    # 14. training: the train CLI, resume, the Trainer's step, as a user trains
    start_phase("14. training")
    trained = training_run(state, smi, reset_counts, read_counts, per_train_step, per_forward, small)
    for kern in kernels:
        counter = "flash_alibi" if kern["name"] == "flash_alibi_t3000" else kern["name"]
        kern["launches_training_run"] = {what: counts[counter] for what, counts in trained.items()}

    # 15. streaming and serving, as an SDS and a server run them -------------
    start_phase("15. streaming and serving")
    streamed = streaming_serving(state, smi, port, enc, per_forward, reset_counts, read_counts)
    for kern in kernels:
        counter = "flash_alibi" if kern["name"] == "flash_alibi_t3000" else kern["name"]
        kern["launches_streaming"] = {path: counts[counter] for path, counts in streamed.items()}

    # 16. the prosody probe: the phrase corpus, evaluate_phrases, the attention
    # weights, the psola Trainer and the profiler, as analysis runs them -----
    start_phase("16. prosody probe")
    probed = prosody_probe(state, smi, port, enc, per_forward, per_train_step, reset_counts, read_counts)
    for kern in kernels:
        counter = "flash_alibi" if kern["name"] == "flash_alibi_t3000" else kern["name"]
        kern["launches_prosody_probe"] = {path: counts[counter] for path, counts in probed.items()}

    # 17. data and tensor parallelism over two processes on the card, torchrun,
    # the dryrun tool ---------------------------------------------------------
    start_phase("17. parallel")
    parallel = parallel_training(state, smi, per_forward, per_train_step, per_unfrozen_step)
    for kern in kernels:
        counter = "flash_alibi" if kern["name"] == "flash_alibi_t3000" else kern["name"]
        kern["launches_parallel"] = {path: counts[counter] for path, counts in parallel.items()}

    # 18. the tools beside the package: the soaks, the profilers, the analyzers,
    # the multi-process rehearsal ---------------------------------------------
    start_phase("18. scripts beside")
    beside = scripts_beside(state, smi, per_forward, per_train_step, per_unfrozen_step, reset_counts, read_counts)
    for kern in kernels:
        counter = "flash_alibi" if kern["name"] == "flash_alibi_t3000" else kern["name"]
        kern["launches_scripts_beside"] = {path: counts[counter] for path, counts in beside.items()}
    start_phase(None)
    emit("phase_times", seconds_by_phase=PHASE_SECONDS, seconds_total=time.perf_counter() - t_start)

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_report.json"), "w") as f:
        json.dump({"report": REPORT, "kernels": kernels, "build_logs": logs}, f, indent=1)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(parallel_rank(sys.argv[2]))
    sys.exit(main())
