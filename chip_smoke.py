#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths.  The paper's loop: the §III estimator picks
the launch configuration from the address expressions alone, then the
chosen hand-written CUDA kernel runs; and every configuration it ranks,
timed, to check its ranking.  Beside it, GQA flash attention at
Qwen2.5-14B's width and the chunked RWKV6 WKV at RWKV6-1.6B's width, each
with the tile or chunk fixed by measurement, and one model of every family
served at full width, and OLMo-1B and RWKV6-1.6B trained at full width.
Phases, one JSON line each:

1. device  — the card, its count, and ``nvidia-smi``'s name and power limit;
2. build   — the six kernels built from ``src/repro_torch/csrc`` (one
   ``nvcc`` each, and one for each of the stencil probe's three variants,
   all started together), with build seconds, registers and spills per
   thread of every instantiation (the staged and the direct stencil kernel
   each; the WKV forward's state walk and output kernel, with their shared
   bytes, at every compiled (chunk, K); beside the IR's assumption for the
   two paper kernels) and the
   count of tensor-core instructions in each kernel's SASS (``cuobjdump
   -sass``): ``HMMA`` (``mma.sync``) and ``HGMMA`` (``wgmma``).  A bf16
   flash forward instantiation (``flash_fwd_wgmma_kernel``, every bf16 tile
   at every head dim it compiles) or a backward one of Hopper's path
   (``BWD_WGMMA_HEAD_DIMS``) without ``HGMMA``, or a head-dim-160 backward
   one without ``HMMA``, fails the run;
3. check   — every kernel against its plain PyTorch version at small sizes:
   all 162 stencil configurations in f64 and a few in f32/bf16 on both
   stencil kernels (staged and direct), all 49 LBM configurations in f64
   and a few in f32; the stencil's yardstick ``conv3d`` on the interior;
   every compiled flash (tile, head dim, dtype), head dims 16, 32, 64, 112,
   128 and 160, at four head groupings,
   causal and not, at S = 256 and in bf16 also at S = 96 (the last q and kv
   tiles of Hopper's kernel reach past S), and every bf16 tile at S = 2048,
   D = 128, (Hq, Hkv) = (10, 2), causal, where rows from 1024 on exist; every
   compiled WKV (chunk, K), output and final state, at S = 128 and at
   S = 1024 (64 chunks of 16, so the state walk's stages turn over many
   times), each also with the chunk-start states kept (held against the
   f64 recurrence's, and out and the final state the same bits as the
   call without them).  Every compiled WKV (chunk, K) again, both ways, with
   a bonus per head and a random
   initial state (the models' form), and the model's own kernel calls at
   S = 100 (padded to 128 for attention, 112 for WKV) against the plain
   versions on the unpadded inputs.  The flash backward kernel at every
   compiled head dim, f32 and bf16, four head groupings, causal and not, at
   S = 256 and 96, and in bf16 at Qwen2.5-14B's group, (1, 40, 8, 2048,
   128), and OLMo-1B's shape, (1, 16, 16, 4096, 128), against autograd
   through the plain version, with the plain version's own f32 reading
   against its f64 one and the backward's time against its bound and SDPA's
   backward.  The WKV backward kernel at every compiled (chunk, K), with a
   bonus per head, an initial state and the final state's gradient given,
   at S = 1024, all six gradients (dr, dk, dv, dwlog, du, ds0) against
   autograd through the plain version, with the plain version's own f32
   reading against its f64 one.  Limits: max abs error f64 1e-10, f32
   3e-5, bf16 4e-2, and elementwise ``|a - b| <= atol + rtol |b|`` for bf16
   attention (``ATTN_RULE``) and WKV (``WKV_RULE``), and
   ``|a - b| <= atol rms(b) + rtol |b|`` for the attention gradients
   (``ATTN_GRAD_RULE``; ``F32_GRAD_RULE`` in f32) and the WKV gradients
   (``WKV_GRAD_RULE``);
4. main    — ``stencil25(src)`` at (512, 512, 640) f64 and ``lbm_step`` at
   (256, 256, 512) f64, each with ``block=None``; then ``flash_attention``
   at (B, Hq, Hkv, S, D) = (1, 40, 8, 4096, 128) bf16 causal and ``wkv`` at
   (BH, S, K) = (64, 4096, 64) f32, with ``block_q/block_kv/chunk = None``.
   Launch counts are zeroed just before each path and read just after;
   the direct stencil kernel must not have launched.  Then kernel,
   plain-version and yardstick times from CUDA events, over launches back
   to back (``ms``; for the attention and WKV paths, every compiled tile or
   chunk at the main shape), each against its bound, and the kernel's
   median single launch, as the port's earlier times were taken
   (``ms_one_launch``, beside the attention and WKV kernels' times before
   their redesign, ``pr12_ms``; both also beside the kernels that Hopper's
   designs replaced, ``pr26_ms``; attention with TFLOP/s at 4 D and at
   6 D flops a pair, the design's bound at 6 D beside the 4 D one, and the
   registers, spills and shared bytes of the tile it ran; the WKV with the
   design's bound at each chunk (the states written and read, k, v and wlog
   read twice) beside the function's, and the registers, spills and shared
   bytes of its state walk and output kernel).  The stencil's staged and direct kernels
   are timed in turns (direct, staged, staged, direct), beside the staged
   block's shared memory, the card's blocks per SM for it and the
   estimator's wave.  The paper line also carries ``select_block``'s host
   seconds for both kernels, cold (its ranking's cache cleared) and cached;
5. probe   — ``benchmarks/torch_stencil_probe.py`` at the stencil's main
   shape: direct, copy-only, unclamped direct and staged kernels in turns;
6. rank    — ``benchmarks/torch_rank_check.py``: at the paper grids in
   f64, all 162 stencil configurations on both stencil kernels and all 49
   LBM ones, each held against the plain version (1e-10) and then timed
   in two passes; Kendall tau and Spearman rho between predicted and
   measured GLup/s, the passes' own tau, the predicted winner's measured
   rank, its time over the fastest one's and the top-5 overlap per kernel
   (every configuration's figures in ``results/rank_check.json``);
7. explore — the exploration (``repro_torch.explore``) on the H100 model
   (``"h100"``): ``Study`` over the 162 stencil and the 49 LBM
   configurations of the paper spaces, each cold into a JSONL store and an
   alias store under ``build/explore/``, then warm, with the host seconds of
   each; fails unless the warm run serves every configuration from the
   store and opens no ``study.trace_ir`` span, and unless each
   configuration's predicted GLup/s equals ``ops.rank_configs``' at the main
   path's grid and the ``Study``'s order is that ranking's, best first (the
   line counts the groups of equal GLup/s, where the ``Study`` orders by
   descending IR fingerprint and ``select_block`` takes the first in space
   order).  A ``SuccessiveHalving`` search (budget 54, seed 0) of the
   stencil space: its configurations estimated, host seconds and Pareto
   recall against the sweep's front, and whether its best is the sweep's.
   Then the path on the card: the stencil ``Study``'s top 1, the search's
   best and the LBM ``Study``'s top 1, each launched once at the paper grid
   through ``stencil25_cuda`` or ``lbm_d3q15_cuda`` (counts zeroed before,
   read after: each must launch), held against the plain version over the
   whole grid (f64, 1e-10) and timed as phase ``main`` times, beside phase
   ``rank``'s fastest configuration (``pick_over_best``) and beside the
   seconds phase ``rank`` spent checking and timing every configuration.
   Last, the estimation daemon on 127.0.0.1 (a free port): the 162 stencil
   configurations posted cold, then warm ten times, its records held equal
   to the sweep's, the warm queries per second, and the daemon stopped;
8. audit   — the static auditor (``repro_torch.analysis``) and the TPU
   backend.  ``analysis.analyze_ir`` on ``"h100"`` over the 162 stencil and
   49 LBM configurations the port launches at the paper grids, cold and then
   warm (which must be all ``lint.cache_hits``), with the findings by rule
   and severity; fails where any has an ``error`` finding.  Each perf lint
   (``perf.uncoalesced``, ``perf.bank_conflict``, ``perf.occupancy``,
   ``perf.capacity``) beside phase ``rank``'s times of the same
   configurations (``results/rank_check.json``): how many it flags, the
   median ms of those and of the rest, and how many of the ten fastest it
   flags (no limit: the lints stay the JAX package's).  The lint gate,
   ``Study(kernel, machines=["h100"], lint="error")`` over both spaces, cold:
   its host seconds and whether its top is phase ``explore``'s; each top
   launched through ``stencil25_cuda`` or ``lbm_d3q15_cuda`` at the paper
   grid (counts zeroed before, read after: each must launch), held against
   the plain version (f64, 1e-10 over the whole grid) and timed as phase
   ``main`` times, beside phase ``rank``'s fastest.  ``Study.explain`` of
   each pick and of phase ``rank``'s fastest configuration: limiter,
   runner-up, margin, per-level volumes, predicted ms and DRAM bytes per LUP
   beside the measured ms and effective bytes per LUP.  ``graph.step_time``
   of OLMo-1B's train step (batch 4, seq 4096) with ``lint="annotate"``:
   the kernels audited, the findings and the host seconds the audit adds
   (the prediction must not move).  Last, on the card's host: the port's
   CLI prints ``tests/golden/lint_stencil25.txt``,
   ``lint_fixture_racy_store.txt`` and ``graph_zamba2_tpuv5e.txt``, and
   ``Study.explain`` ``explain_stencil25_{a100,v100}.txt``, byte for byte
   with the goldens' exit codes (fails otherwise), and a ``Study`` of each
   ``*_tpu`` entry on ``tpuv5e`` and ``tpuv6e`` gives its top and host
   seconds;
9. serve   — ``repro_torch.launch.serve.serve`` on the card at full width:
   Qwen2.5-14B (all 48 layers, f32 parameters, bf16 compute), RWKV6-1.6B
   (all 24 layers), StableLM-12B (all 40 layers, head dim 160),
   MusicGen-large (all 48, head dim 64), LLaVA-NeXT-34B (24 of 60 layers,
   56/8 heads), DBRX-132B (4 of 40 layers, 16 experts top-4) and Zamba2-7B
   (all 81 Mamba2 layers, shared attention of head dim 112 after every 27),
   each answering 4 requests of 512 prompt tokens with 16 new tokens,
   greedy, parameters drawn on the card from a seeded generator; a depth
   cut (``repro_torch.launch.one_card``: where the published depth does not
   fit 80 GB in f32) is named on its line as ``reduced``, and its kept
   layers are drawn at the published depth's std.  The prefill must launch ``flash_attention`` once per
   attention layer (the hybrid's: once per group) or ``wkv`` (RWKV) once
   per layer, and the decode neither.  MusicGen and LLaVA also run
   ``forward`` on the model they served, at batch 1 with their frontend's
   stub embeddings (512 audio frames of 768, 2304 vision patches of 1152)
   and 256 text tokens after them, which must launch ``flash_attention``
   once per layer and give finite logits.  The inputs the model fed the
   kernel at the first and the last layer are held, kernel against plain
   version, and timed: attention by ``ATTN_RULE``; WKV by
   ``WKV_SCALED_RULE`` (see there), with ``WKV_RULE``'s reading and the f32
   plain version's reading against an f64 one beside it.  Prefill and
   decode times (CUDA events), tokens per second, peak memory and the
   decode step against its weight-bytes bound;
10. train  — ``train_olmo``: ``Trainer.fit`` on OLMo-1B at full width and
   depth (16 layers, d 2048, f32 parameters and AdamW moments, bf16
   compute, remat) at ``train_4k``'s sequence of 4096 and a global batch of
   4 of its 256 (``launch.one_card``), 6 steps from seed 0, a checkpoint
   every 3 (keep 1) into a directory under ``build/`` that the phase
   removes, and one fault injected at step 4.  Fails unless every loss and
   gradient norm is finite, step 3 re-runs after the restore with its
   first run's loss within 1e-4 relative, and every step launches the
   flash forward twice a layer (once in the forward, once in remat's
   recompute) and its backward once a layer.  One layer's (q, k, v, dO),
   captured in the first step, is held, backward kernel against autograd
   through the plain version, by ``ATTN_GRAD_RULE``, and timed with the
   forward, the plain version's backward and SDPA's.  Prints the warm
   median step, tokens per second, peak memory, the disk's free space and
   the checkpoint's snapshot, write and restore seconds.  Then
   ``train_rwkv``: ``Trainer.fit`` on RWKV6-1.6B at full width and depth
   (24 layers, d 2048, 32 heads of 64, f32 parameters and AdamW moments,
   bf16 compute, the WKV in f32, remat) at the same cut of ``train_4k``, 4
   steps from seed 0, its checkpoints left out (the fault and the restore
   are ``train_olmo``'s).  Fails unless every loss and gradient norm is
   finite, nothing restarts, and every step launches the WKV forward twice
   a layer (remat), its backward once a layer and no flash kernel.  The
   first layer's (r, k, v, wlog, u) and dO of the first step are held,
   backward kernel against autograd through the stepwise plain version on
   32 rows and against ``wkv_bwd_plain`` on every row, by
   ``WKV_GRAD_RULE``, both also read against an f64 run, and the
   chunked plain version (``wkv_bwd_plain`` in f32 at the kernel's chunk)
   against the f64 run on the same 32 rows (``chunked_plain_f32_vs_f64``),
   and the kernel from the f64 recurrence's chunk-start states rounded to
   f32 (``kernel_f64_states_vs_f64``: what the forward's states add); two
   launches must give the same bits, and the backward is timed against its
   bound; warm median step, tokens per second, peak memory;
11. sharded — a one-rank NCCL process group (a ``HashStore``: no network)
   and a (1, 1) ``DeviceMesh`` (``launch.mesh.make_test_mesh``) on the
   card, then two paths through the DTensor placements
   (``train/sharding.py``): ``train_sharded``, ``Trainer.fit`` with
   ``mesh=`` on ``train_olmo``'s model, cut and data, 4 steps from seed 0,
   no checkpoints; fails unless the parameters are DTensors, every loss is
   finite, each step launches the flash forward twice a layer and its
   backward once, and the losses sit within 1e-4 relative of
   ``train_olmo``'s first 4 (whether they are equal to the bit is
   printed), with the warm step, tokens per second and peak memory beside
   ``train_olmo``'s.  Then ``serve_sharded``: RWKV6-1.6B at full width
   (seed 0, ``serve_rwkv``'s prompts) through ``make_prefill_step`` and
   ``make_decode_step`` on the mesh: the prefill bundle, the prompt through
   the decode bundle on a zeroed cache, then greedy steps to 16 tokens;
   fails unless the prefill and the cache fill each launch ``wkv`` once a
   layer, the decode none, and the tokens equal ``serve_rwkv``'s; prefill,
   cache-fill and decode times beside ``serve_rwkv``'s, and peak memory.
   The group is destroyed at the end;
12. step_time — the whole-model estimator, ``repro_torch.graph.step_time``
   on ``"h100"``, for each full-width path above with that path's own
   config (its depth cut included), batch, sequence and kind: the seven
   serve paths' prefills (batch 4, seq 512, ``forward``), ``train_olmo`` and
   ``train_rwkv`` (batch 4, seq 4096, ``train``).  One line a path: the
   predicted step, the step the phase above measured (the serve phase's
   prefill, which is cold: the first of its run; the training step's warm
   median), their ratio, the host seconds of the call, the node and
   unique-kernel counts, the limiter attribution and the predicted seconds
   by node class.  Fails only if
   ``step_time`` raises, a prediction is not finite and positive, or the
   single-device makespan is not exactly the node durations folded in
   schedule order.  A prediction far from the card is what the phase
   records, not a failure (``benchmarks/torch_step_time_check.py`` sets
   each prediction beside a warm step, class by class);
13. dryrun — the dry run, ``python -m repro_torch.launch.dryrun``, on the
   card's host and not on the card: OLMo-1B ``train_4k`` (16, 16),
   Qwen2.5-14B ``prefill_32k`` (16, 16), RWKV6-1.6B ``long_500k`` (16, 16)
   and DBRX-132B ``train_4k`` (2, 16, 16), at full width, one process each,
   all started together, each on a fake process group of 256 or 512 ranks
   with fake tensors (no parameter drawn, no kernel built or launched).  One
   line a cell: status, trace seconds, argument and output bytes per
   device, FLOPs, bytes accessed and collectives per device, and the three
   roofline terms, ``dominant`` and ``roofline_fraction`` on ``TPU_V5E``
   (the JAX package's pricing) and on the port-side H100 machine; fails
   unless every cell is ``ok``.  Then two one-card cells traced on a
   world-1 fake group through a (1, 1) mesh and priced on the H100 machine:
   ``train_olmo``'s cut step (batch 4, S 4096) and ``serve_qwen``'s prefill
   (4 x 512), each beside this run's measured step or prefill as predicted
   over measured;
14. simulate — ``benchmarks/torch_simulate_check.py`` on phase ``rank``'s
   records: the copy of the JAX package's sectored-LRU simulator on
   ``H100_SXM`` at the paper grids for the LBM pick, ``rank``'s fastest and
   slowest LBM blocks and eleven more spread over ``rank``'s order, the
   stencil pick and ``rank``'s fastest stencil configuration, in six host
   processes; each configuration's simulated DRAM and L2<->L1 bytes per LUP
   beside its effective bytes per LUP, and Spearman's rho over the LBM's.

Then the ``nvidia-smi`` line, a ``kernels`` JSON line, and as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result line, on
any failure and where CUDA or the port is missing.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import io
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "benchmarks"))

# Fails here, before any result, where the port is not beside this script.
from repro_torch import _build  # noqa: E402
from repro_torch.core import appspec  # noqa: E402
from repro_torch.kernels import attention  # noqa: E402
from repro_torch.kernels import lbm_d3q15 as lbm  # noqa: E402
from repro_torch.kernels import stencil25  # noqa: E402
from repro_torch.kernels import wkv  # noqa: E402
from repro_torch.kernels.attention import kernel as attn_kernel  # noqa: E402
from repro_torch.kernels.lbm_d3q15 import kernel as lbm_kernel  # noqa: E402
from repro_torch.kernels.stencil25 import kernel as st_kernel  # noqa: E402
from repro_torch.kernels.wkv import kernel as wkv_kernel  # noqa: E402
from repro_torch import analysis  # noqa: E402
from repro_torch import explore  # noqa: E402
from repro_torch.explore import cli as explore_cli  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.core.machine import H100_SXM  # noqa: E402
from repro_torch.explore import search as explore_search  # noqa: E402
from repro_torch.explore import serve as explore_serve  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.core.waves import wave_size  # noqa: E402
from repro_torch.kernels.stencil25.ref import star_offsets, star_weights_np  # noqa: E402
from repro_torch.configs import SHAPES, get_arch  # noqa: E402
from repro_torch.launch import one_card  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.data import SyntheticTokenDataset  # noqa: E402
from repro_torch.graph import classes as graph_classes  # noqa: E402
from repro_torch.graph import step_time  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train import trainer as train_trainer  # noqa: E402
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.models import registry as model_registry  # noqa: E402
from repro_torch.models import rwkv6 as model_rwkv6  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.train.step import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
import torch_rank_check as rank_check  # noqa: E402
import torch_simulate_check as simulate_check  # noqa: E402
import torch_stencil_probe as stencil_probe  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# H100 SXM, dense: f64 and f32 outside the tensor cores, bf16 on them
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12, torch.bfloat16: 989e12}
STENCIL_SHAPE = (512, 512, 640)  # (nz, ny, nx) = paper grid (640, 512, 512)
LBM_SHAPE = (256, 256, 512)  # (nz, ny, nx) = paper grid (512, 256, 256)
CHECK_SHAPE = (64, 64, 128)
LBM_STEPS = 3
TOL = {torch.float64: 1e-10, torch.float32: 3e-5, torch.bfloat16: 4e-2}
STENCIL_BYTES_PER_CELL = 16  # f64: src read once, dst written once
LBM_BYTES_PER_CELL = 280  # f64: 15 pdfs + phase + 3 vel read, 15 pdfs + phase written
REPS = 20
ORDER_REPS = 50  # the per-tile and per-chunk times that MEASURED_ORDER follows
ATTN_SHAPE = (1, 40, 8, 4096, 128)  # (B, Hq, Hkv, S, D): one layer of configs/qwen2_5_14b.py
ATTN_CHECK_HEADS = ((4, 4), (4, 2), (8, 1), (10, 2))
ATTN_CHECK_SEQ = 256
ATTN_CHECK_SEQS_BF16 = (256, 96)  # 96: Hopper's kernel's last q and kv tiles reach past S
ATTN_LONG_CHECK = (10, 2, 2048, 128)  # (Hq, Hkv, S, D): rows from 1024 on, causal, bf16
WKV_SHAPE = (64, 4096, 64)  # (BH, S, K): configs/rwkv6_1_6b.py, 32 heads of 64 at batch 2
WKV_CHECK_SHAPES = ((3, 128), (5, 1024))  # (BH, S)
# elementwise rules |a - b| <= atol + rtol |b|, as (atol, rtol).  bf16
# attention on top of its max abs error: one bf16 ulp is at most 2^-7 |b|, so
# the rule admits the last-bit disagreement of two f32 results each rounded
# to bf16, where 4e-2 alone is as large as a typical output at S = 4096.
# WKV: the JAX test's rtol = atol = 5e-4.
ATTN_RULE = (2e-3, 1e-2)
WKV_RULE = (5e-4, 5e-4)
# Attention's gradients, dq, dk and dv, against autograd through the plain
# version: |a - b| <= atol rms(b) + rtol |b|.  rtol 1e-2 admits one bf16
# ulp (at most 2^-7 |b|) between two results each rounded to bf16 once;
# atol is in units of the gradient's scale, since a gradient entry is a sum
# over the keys or queries that cancels near zero.  Calibrated on the plain
# version's own f32 gradients against its f64 ones, which the check phase
# reads by this rule (``plain_f32_vs_f64``).  F32_GRAD_RULE holds the f32
# kernel the same way at the forward's f32 limit.
ATTN_GRAD_RULE = (2e-3, 1e-2)
F32_GRAD_RULE = (3e-5, 3e-5)
ATTN_BWD_CHECK_SEQS = (256, 96)  # 96: a partial last tile of the backward's 64
ATTN_BWD_GQA_SHAPES = ((1, 40, 8, 2048, 128), (1, 16, 16, 4096, 128))  # Qwen2.5-14B's group; OLMo-1B
# train_olmo: the run, its fault and its one-card cut
TRAIN_ARCH = one_card.TRAIN_PATHS["train_olmo"]
TRAIN_SHAPE = one_card.TRAIN_SHAPE
TRAIN_STEPS = 6
TRAIN_CKPT_EVERY = 3
TRAIN_FAULT_STEP = 4
TRAIN_RERUN_STEP = 3  # the checkpoint at 3 is restored and step 3 runs again
TRAIN_RERUN_RTOL = 1e-4
# train_rwkv: RWKV6-1.6B at the same cut, a few steps, no checkpoints
SHARDED_TRAIN_STEPS = 4  # train_sharded: train_olmo's first steps, through a (1, 1) mesh
SHARDED_LOSS_RTOL = 1e-4
RWKV_TRAIN_ARCH = one_card.TRAIN_PATHS["train_rwkv"]
RWKV_TRAIN_STEPS = 4
RWKV_CHECK_ROWS = 32  # batch 0's 32 heads: the stepwise plain gradient on these rows
# The WKV gradients, dr, dk, dv, dwlog, du and ds0, against the plain
# version's: |a - b| <= atol rms(b) + rtol |b|, WKV_RULE's 5e-4 with its
# absolute part in units of each gradient's scale (a gradient entry is a sum
# over the steps after it, of terms of both signs, that can cancel near
# zero).  The check phase and train_rwkv print the f32 plain version's own
# reading against an f64 run beside it (``plain_f32_vs_f64``).
WKV_GRAD_RULE = (5e-4, 5e-4)
WKV_BWD_CHECK_SEQ = 1024
# The WKV rule in units of the data's scale: |a - b| <= atol rms(b) + rtol |b|,
# for the inputs the full-width models feed the kernel.  There the outputs
# are thousands (r, k, v about 9 from the reference's fan-in rule), and some
# cancel to near zero, where atol 5e-4 is below one f32 rounding of the
# terms summed: the f32 stepwise plain version itself reads above 1 against
# an f64 one by WKV_RULE (the serve line's ``plain_vs_f64_ratio``), so no
# f32 kernel could meet it.  At the check phase's unit-scale inputs rms(out)
# is 6 to 12, and WKV_RULE holds there as it is.
WKV_SCALED_RULE = (5e-4, 5e-4)
WKV_CHECK_HEADS = 3  # heads of the per-head bonus in the check phase: BH = 6
MODEL_CHECK_SEQ = 100  # the model's kernel calls padded: to 128 (attention), 112 (WKV)
SERVE = {  # main path: (config, the kernel its prefill must launch once per attention or WKV layer)
    path: (arch, "wkv" if get_arch(arch).family == "ssm" else "flash_attention")
    for path, arch in one_card.SERVE_PATHS.items()
}
SERVE_SHAPE = {"requests": one_card.SERVE_REQUESTS, "prompt_len": one_card.SERVE_PROMPT_LEN, "steps": 16}
STEP_TIME_MACHINE = "h100"  # the whole-model estimator's model of the card
EXPLORE_MACHINE = "h100"  # the exploration's machine model of the card
EXPLORE_BUDGET = 54  # SuccessiveHalving's full estimates: a third of the 162 stencil configurations
EXPLORE_WARM_POSTS = 10  # warm posts of the 162 stencil configurations to the daemon
AUDIT_MACHINE = "h100"  # the static auditor's model of the card (its perf lints)
AUDIT_PERF_RULES = ("perf.uncoalesced", "perf.bank_conflict", "perf.occupancy", "perf.capacity")
AUDIT_FASTEST = 10  # phase rank's fastest configurations, set beside the perf lints
AUDIT_STEP = ("olmo-1b", 4, 4096, "train")  # (arch, batch, seq, kind): a model step through the auditor
AUDIT_TPU_MACHINES = ("tpuv5e", "tpuv6e")  # the TPU backend's analytic machines, run on the host
AUDIT_TPU_KERNELS = ("stencil25_tpu", "lbm_d3q15_tpu", "attention_tpu", "wkv_tpu")
DRYRUN_CELLS = (("olmo-1b", "train_4k", "single"), ("qwen2.5-14b", "prefill_32k", "single"),
                ("rwkv6-1.6b", "long_500k", "single"), ("dbrx-132b", "train_4k", "multi"))
DRYRUN_OUT = ROOT / "build" / "dryrun_torch"
DRYRUN_TIMEOUT_S = 480  # all four cells run at once, each in its own process
GOLDEN_DIR = ROOT / "tests" / "golden"
# golden file -> (exit code, argv of the CLI), as tests/test_golden_lint.py
# and tests/test_golden_graph.py run the JAX CLI
AUDIT_CLI_GOLDENS = {
    "lint_stencil25.txt": (0, ["lint", "--kernel", "stencil25", "--config",
                               '{"block": [32, 4, 8], "fold": [1, 1, 1]}', "--machine", "V100"]),
    "lint_fixture_racy_store.txt": (1, ["lint", "--fixture", "racy_store", "--machine", "V100"]),
    "graph_zamba2_tpuv5e.txt": (0, ["graph", "--model", "zamba2-7b", "--smoke", "--machine", "tpuv5e",
                                    "--mesh", "data=4,model=2", "--batch", "8", "--seq", "128",
                                    "--kind", "train"]),
}
# golden file -> machine, for Study.explain as tests/test_obs.py calls it
AUDIT_EXPLAIN_GOLDENS = {"explain_stencil25_v100.txt": "v100", "explain_stencil25_a100.txt": "a100"}
AUDIT_EXPLAIN_CFG = {"block": (64, 2, 8), "fold": (1, 2, 1)}
# text tokens after the frontend's stub embeddings (n_frontend_tokens of
# frontend_dim) in the forward of a served config with a frontend
FRONTEND_TEXT_TOKENS = 256
OWN_PATH = {"stencil25": "paper", "lbm_d3q15": "paper", "flash_attention": "attention", "wkv": "wkv"}
WKV_FLOPS_PER_TOKEN = 6  # times K^2 per head: the stepwise recurrence
# the attention and WKV kernels' times at the main shapes before their
# redesign for Hopper (f32 scalar kernels; NVIDIA H100 80GB HBM3, 700 W),
# shown beside each run's own; taken as ``time_one_launch_ms`` takes them
PR12_MS = {"flash_attention": 6.5022, "wkv": 2.7553}
# the bf16 flash forward's and the WKV forward's times at the main shapes
# before their redesign for Hopper (the flash forward on mma.sync, the WKV
# forward as one kernel a (batch*head, 16 columns) walking every chunk; NVIDIA
# H100 80GB HBM3, 700 W), as ``ms``
PR26_MS = {"flash_attention": 0.9802, "wkv": 1.2214}
KERNELS = {  # name: (launch counter, CUDA source, TPU kernel it replaces)
    "stencil25": (st_kernel.stencil25_cuda, "src/repro_torch/csrc/stencil25.cu",
                  "src/repro/kernels/stencil25/kernel.py:24"),
    "lbm_d3q15": (lbm_kernel.lbm_d3q15_cuda, "src/repro_torch/csrc/lbm_d3q15.cu",
                  "src/repro/kernels/lbm_d3q15/kernel.py:37"),
    "flash_attention": (attn_kernel.flash_attention_cuda, "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/attention/kernel.py:21"),
    "wkv": (wkv_kernel.wkv_cuda, "src/repro_torch/csrc/wkv.cu",
            "src/repro/kernels/wkv/kernel.py:25"),
    # no TPU kernel: the JAX package differentiates its XLA reference attention
    "flash_attention_bwd": (attn_kernel.flash_attention_bwd_cuda, "src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/models/layers.py:111"),
    # no TPU kernel: the JAX package differentiates its WKV scan, _wkv_scan
    "wkv_bwd": (wkv_kernel.wkv_bwd_cuda, "src/repro_torch/csrc/wkv_bwd.cu", "src/repro/models/rwkv6.py:62"),
}
# launch counters of kernels that no main path may launch
OFF_PATH = {"stencil25_direct": st_kernel.stencil25_direct_cuda}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: {msg}")


def time_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Time of one launch: ``reps`` launches back to back between two CUDA
    events, over ``reps``.  The host enqueues ahead of the card, so the
    wrapper's own host time between launches does not count."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_one_launch_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median of ``reps`` single launches, each between its own two CUDA
    events: the host's time from the first event to the launch counts too.
    The port's earlier kernel times were taken this way."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def rule_ratio(a: torch.Tensor, b: torch.Tensor, rule: tuple[float, float]) -> float:
    """max |a - b| / (atol + rtol |b|) over the elements: at most 1 where the
    elementwise rule holds."""
    atol, rtol = rule
    a, b = a.float(), b.float()
    return float(((a - b).abs() / (atol + rtol * b.abs())).max())


def rule_text(rule: tuple[float, float]) -> str:
    return f"|a-b| <= {rule[0]} + {rule[1]}|b|"


def holds(res: dict) -> bool:
    """Every limit that a result carries: ``tol`` on its max abs error and
    ``max_ratio`` <= 1 for its elementwise rule (NaN fails both)."""
    return res["max_abs_err"] <= res.get("tol", math.inf) and res.get("max_ratio", 0.0) <= 1.0


def zero_counts() -> None:
    for counter in [c for c, _, _ in KERNELS.values()] + list(OFF_PATH.values()):
        counter.launches = 0


def read_counts() -> dict[str, int]:
    counts = {name: counter.launches for name, (counter, _, _) in KERNELS.items()}
    off_path = {name: counter.launches for name, counter in OFF_PATH.items() if counter.launches}
    if off_path:
        fail(f"a main path launched kernels it must not: {off_path}")
    return counts


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_device() -> str:
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build() -> dict:
    """Builds the six kernels and the stencil probe's variants together;
    returns the probe's libraries."""
    t0 = time.perf_counter()
    probe_jobs = stencil_probe.start_builds()
    libs = _build.build(tuple(KERNELS))
    probe_libs = stencil_probe.finish_builds(probe_jobs)
    wall = time.perf_counter() - t0
    regs = {}
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        for fold in st_kernel.FOLDS:
            for kind in ("staged", "direct"):
                regs[f"stencil25 {kind} {str(dtype)[6:]} fold{fold}"] = \
                    st_kernel.kernel_attributes(dtype, fold, staged=kind == "staged")
    for dtype in (torch.float64, torch.float32):
        regs[f"lbm_d3q15 {str(dtype)[6:]}"] = lbm_kernel.kernel_attributes(dtype)
    for dtype in (torch.float32, torch.bfloat16):
        for d in attn_kernel.HEAD_DIMS:
            for bq, bkv in fwd_tiles(dtype, d):  # raises where the source lacks a listed tile
                regs[f"flash_attention {str(dtype)[6:]} d{d} {bq}x{bkv}"] = \
                    attn_kernel.kernel_attributes(dtype, d, bq, bkv)
    for dtype in (torch.float32, torch.bfloat16):
        for d in attn_kernel.HEAD_DIMS:
            for which in attn_kernel.BWD_KERNELS:
                regs[f"flash_attention_bwd {which} {str(dtype)[6:]} d{d}"] = \
                    attn_kernel.bwd_kernel_attributes(dtype, d, which)
    for chunk in wkv_kernel.CHUNKS:
        for kd in wkv_kernel.HEAD_DIMS:
            for which in wkv_kernel.FWD_KERNELS:  # the state walk and the output kernel
                regs[f"wkv_{which} L{chunk} K{kd}"] = wkv_kernel.kernel_attributes(chunk, kd, which)
            regs[f"wkv_bwd L{chunk} K{kd}"] = wkv_kernel.bwd_kernel_attributes(chunk, kd)
    for name, attrs in regs.items():
        if attrs["local_bytes"]:
            print(f"chip_smoke: {name} spills {attrs['local_bytes']} B/thread", file=sys.stderr)
    sass = {n: tensor_core_counts(lib.path) for n, lib in libs.items()}  # by kernel instantiation
    hmma = {n: {k: c["HMMA"] for k, c in counts.items()} for n, counts in sass.items()}
    hgmma = {n: {k: c["HGMMA"] for k, c in counts.items() if c["HGMMA"]} for n, counts in sass.items()}
    stencil_f64_spills = {n: a["local_bytes"] for n, a in regs.items()
                          if n.startswith("stencil25") and "float64" in n and a["local_bytes"]}
    flash_spills = {n: a["local_bytes"] for n, a in regs.items()
                    if n.startswith("flash_attention") and a["local_bytes"]}
    emit({"phase": "build", "wall_s": wall, "stencil25_f64_spills": stencil_f64_spills,
          "flash_attention_spills": flash_spills,
          "wkv_bwd_spills": {n: a["local_bytes"] for n, a in regs.items() if n.startswith("wkv_bwd")},
          "wkv_fwd_spills": {n: a["local_bytes"] for n, a in regs.items()
                             if n.startswith(("wkv_states", "wkv_out")) and a["local_bytes"]},
          "nvcc_s": {n: lib.build_seconds for n, lib in libs.items()},
          "ir_regs_per_thread": {"stencil25": appspec.star3d_ir((32, 4, 8)).regs_per_thread,
                                 "lbm_d3q15": appspec.lbm_d3q15_ir((32, 4, 4)).regs_per_thread},
          "kernels": regs, "hmma": {n: sum(c.values()) for n, c in hmma.items()},
          "hgmma": {n: sum(c.values()) for n, c in hgmma.items()},
          "hgmma_flash_attention": hgmma["flash_attention"], "hmma_flash_attention_bwd": hmma["flash_attention_bwd"],
          "hgmma_flash_attention_bwd": hgmma["flash_attention_bwd"]})
    missing = [f"{name}<{d}>" for d in attn_kernel.HEAD_DIMS if d not in attn_kernel.BWD_WGMMA_HEAD_DIMS
               for name in ("flash_bwd_dkdv_tc_kernel", "flash_bwd_dq_tc_kernel")
               if not hmma["flash_attention_bwd"].get(f"{name}<{d}>")]
    if missing:
        fail(f"bf16 flash instantiations without tensor-core instructions (HMMA): {missing}")
    # Hopper's path: wgmma in every bf16 forward instantiation, and in both
    # backward kernels at each of the backward's head dims
    missing = [f"flash_fwd_wgmma_kernel<{d},{bkv}>" for d in attn_kernel.HEAD_DIMS
               for _, bkv in fwd_tiles(torch.bfloat16, d)
               if not hgmma["flash_attention"].get(f"flash_fwd_wgmma_kernel<{d},{bkv}>")]
    missing += [f"{name}<{d}>" for d in attn_kernel.BWD_WGMMA_HEAD_DIMS
                for name in ("flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel")
                if not hgmma["flash_attention_bwd"].get(f"{name}<{d}>")]
    if missing:
        fail(f"flash instantiations of Hopper's path without wgmma (HGMMA): {missing}")
    return probe_libs


def fwd_tiles(dtype, d: int) -> list[tuple[int, int]]:
    """The flash forward's tiles that the source compiles for ``dtype`` at
    head dim ``d``."""
    return [t for t in attn_kernel.TILES[dtype] if attn_kernel.compiled(*t, d, dtype)]


def tensor_core_counts(lib: Path) -> dict[str, dict[str, int]]:
    """HMMA (``mma.sync``) and HGMMA (``wgmma``) instructions in the SASS of
    each kernel of a built library, by kernel and template arguments
    (``flash_fwd_wgmma_kernel<128,128>``)."""
    sass = subprocess.run([_build.toolkit_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts = {}
    for block in sass.split("Function : ")[1:]:
        mangled, _, body = block.partition("\n")
        counts[kernel_name(mangled.strip())] = {op: len(re.findall(rf"\b{op}\b", body)) for op in ("HMMA", "HGMMA")}
    return counts


def kernel_name(mangled: str) -> str:
    """``flash_fwd_wgmma_kernel<128,128>`` for a kernel with integer template
    arguments: the last length-prefixed identifier that ends in ``_kernel``
    (``22flash_fwd_wgmma_kernel``), then its ``Li<n>E`` arguments.  Any other name
    is returned as it is."""
    found = mangled
    for m in re.finditer(r"(?=(\d+)(\w+))", mangled):
        n = int(m.group(1))
        name, rest = m.group(2)[:n], m.group(2)[n:]
        args = re.match(r"I((?:Li\d+E)+)E", rest)
        if len(name) == n and name.endswith("_kernel") and args:
            found = f"{name}<{','.join(re.findall(r'Li(\d+)E', args.group(1)))}>"
    return found


def phase_check() -> None:
    """Every configuration against the plain version, on a small grid."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    res = {}
    space = stencil25.config_space(CHECK_SHAPE, 4, torch.float64)
    kinds = {"staged": st_kernel.stencil25_cuda, "direct": st_kernel.stencil25_direct_cuda}
    for dtype, cfgs in ((torch.float64, space), (torch.float32, space[::27]),
                        (torch.bfloat16, space[13::27])):
        src = torch.randn(CHECK_SHAPE, generator=gen, device="cuda", dtype=torch.float64).to(dtype)
        plain = stencil25.stencil25_plain(src, 4)
        for kind, fn in kinds.items():
            err = max(max_err(fn(src, 4, c["block"], c["fold"]), plain) for c in cfgs)
            torch.cuda.synchronize()
            res[f"stencil25 {kind} {str(dtype)[6:]}"] = {"configs": len(cfgs), "max_abs_err": err,
                                                         "tol": TOL[dtype]}
    for r in (1, 2, 8):
        src = torch.randn(CHECK_SHAPE, generator=gen, device="cuda", dtype=torch.float64)
        plain = stencil25.stencil25_plain(src, r)
        for kind, fn in kinds.items():
            err = max(max_err(fn(src, r, block, fold), plain)
                      for block, fold in (((32, 4, 8), (1, 1, 2)), ((16, 8, 8), (1, 2, 1))))
            res[f"stencil25 {kind} float64 r={r}"] = {"configs": 2, "max_abs_err": err,
                                                      "tol": TOL[torch.float64]}
    src = torch.randn(CHECK_SHAPE, generator=gen, device="cuda", dtype=torch.float64)
    inner = (slice(4, -4),) * 3
    res["stencil25 yardstick conv3d float64 interior"] = {
        "configs": 1, "max_abs_err": max_err(conv3d_star(src, 4), stencil25.stencil25_plain(src, 4)[inner]),
        "tol": TOL[torch.float64]}
    lspace = lbm.config_space(CHECK_SHAPE, torch.float64)
    for dtype, cfgs in ((torch.float64, lspace), (torch.float32, lspace[::8])):
        f, phase, vel = lbm.init_fields(CHECK_SHAPE, seed=2, dtype=dtype)
        fr, pr = lbm.lbm_step_plain(f, phase, vel)
        err = 0.0
        for c in cfgs:
            fo, po = lbm.lbm_d3q15_cuda(f, phase, vel, block=c["block"])
            err = max(err, max_err(fo, fr), max_err(po, pr))
        torch.cuda.synchronize()
        res[f"lbm_d3q15 {str(dtype)[6:]}"] = {"configs": len(cfgs), "max_abs_err": err,
                                              "tol": TOL[dtype]}
    res.update(check_attention(gen))
    res.update(check_attention_bwd(gen))
    res.update(check_wkv(gen))
    res.update(check_wkv_heads(gen))
    res.update(check_wkv_bwd(gen))
    res.update(check_model_padded(gen))
    emit({"phase": "check", "shape": CHECK_SHAPE, "results": res})
    bad = {k: v for k, v in res.items() if not holds(v)}
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")


def check_attention(gen: torch.Generator) -> dict:
    """Every compiled (tile, head dim, dtype), at four head groupings, causal
    and not, against ``mha_plain`` at S = 256, bf16 also at S = 96 and by
    ``ATTN_RULE``, and every bf16 tile at ``ATTN_LONG_CHECK``."""
    res = {}
    hq, hkv, seq, d = ATTN_LONG_CHECK
    q, k, v = (torch.randn((1, h, seq, d), generator=gen, device="cuda").to(torch.bfloat16)
               for h in (hq, hkv, hkv))
    plain = attention.mha_plain(q, k, v, True)
    for bq, bkv in fwd_tiles(torch.bfloat16, d):
        out = attn_kernel.flash_attention_cuda(q, k, v, True, bq, bkv)
        res[f"flash_attention bfloat16 d{d} S{seq} {bq}x{bkv}"] = {
            "max_abs_err": max_err(out, plain), "tol": TOL[torch.bfloat16],
            "max_ratio": rule_ratio(out, plain, ATTN_RULE), "rule": rule_text(ATTN_RULE)}
    del q, k, v, plain
    for dtype in (torch.float32, torch.bfloat16):
        seqs = ATTN_CHECK_SEQS_BF16 if dtype == torch.bfloat16 else (ATTN_CHECK_SEQ,)
        for d in attn_kernel.HEAD_DIMS:
            err = ratio = 0.0
            for (hq, hkv), s in itertools.product(ATTN_CHECK_HEADS, seqs):
                q, k, v = (torch.randn((1, h, s, d), generator=gen, device="cuda").to(dtype)
                           for h in (hq, hkv, hkv))
                for causal in (True, False):
                    plain = attention.mha_plain(q, k, v, causal)
                    for bq, bkv in fwd_tiles(dtype, d):
                        out = attn_kernel.flash_attention_cuda(q, k, v, causal, bq, bkv)
                        err = max(err, max_err(out, plain))
                        ratio = max(ratio, rule_ratio(out, plain, ATTN_RULE))
            torch.cuda.synchronize()
            res[f"flash_attention {str(dtype)[6:]} d{d}"] = {
                "configs": len(fwd_tiles(dtype, d)) * len(ATTN_CHECK_HEADS) * len(seqs) * 2, "max_abs_err": err,
                "tol": TOL[dtype]}
            if dtype == torch.bfloat16:
                res[f"flash_attention {str(dtype)[6:]} d{d}"].update(max_ratio=ratio, rule=rule_text(ATTN_RULE))
    return res


def attention_grads(q, k, v, dout, causal: bool = True, tile=None) -> tuple[torch.Tensor, ...]:
    """(dq, dk, dv) for ``dout``: through the flash kernel and its backward
    kernel with ``tile``, or through the plain version where ``tile`` is
    None; in the inputs' dtype."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        out = (attention.mha_plain(*leaves, causal) if tile is None
               else attn_kernel.flash_attention_cuda(*leaves, causal, *tile))
        return torch.autograd.grad(out, leaves, dout)


def grad_reading(got: tuple, want: tuple, rule: tuple[float, float]) -> dict:
    """Gradients against others by ``rule`` in units of each one's scale
    (``ATTN_GRAD_RULE``, ``F32_GRAD_RULE``)."""
    return {"max_abs_err": max(max_err(a, b) for a, b in zip(got, want)),
            "max_ratio": max(scaled_ratio(a, b, rule) for a, b in zip(got, want)),
            "rule": f"|a-b| <= {rule[0]} rms(b) + {rule[1]}|b|"}


def attention_bwd_bound(q: torch.Tensor, k: torch.Tensor, causal: bool = True) -> tuple[float, str]:
    """``bound_ms`` of attention's backward: q, k, v, o, dO and the rows'
    log-sum-exp read and dq, dk, dv written once; 10 D flops per unmasked
    (query, key) pair (QK^T, dO V^T, dV, dQ, dK)."""
    b, hq, seq, d = q.shape
    n_bytes = q.element_size() * (4 * q.numel() + 4 * k.numel()) + 4.0 * b * hq * seq
    pairs = b * hq * seq * ((seq + 1) / 2 if causal else seq)
    return bound_ms(n_bytes, 10.0 * d * pairs, q.dtype)


def time_attention_bwd(q, k, v, dout, reps: int = REPS) -> dict:
    """The backward kernel's time a launch at the shape of ``q, k, v``
    (causal, bf16), its bound, and the backward of the plain version and of
    SDPA (the yardstick, never called by the port), each with its graph
    built once."""
    b, hq, seq, d = q.shape
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        out = attn_kernel.flash_attention_cuda(*leaves, True, *attention.select_blocks(b, hq, k.shape[1], seq, d))
    sq, sk, sv, so, lse, out_lo = out.grad_fn.saved_tensors
    res = {"ms": time_ms(lambda: attn_kernel.flash_attention_bwd_cuda(sq, sk, sv, so, lse, dout, True, out_lo),
                         reps=reps)}
    res["bound_ms"], res["bound_by"] = attention_bwd_bound(q, k)
    with torch.enable_grad():
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)
    res["library_ms"] = time_ms(lambda: torch.autograd.grad(sdpa_out, leaves, dout, retain_graph=True), reps=reps)
    del sdpa_out
    with torch.enable_grad():
        plain_out = attention.mha_plain(*leaves)
    res["plain_ms"] = time_ms(lambda: torch.autograd.grad(plain_out, leaves, dout, retain_graph=True),
                              reps=2, warmup=1)
    return res


def check_attention_bwd(gen: torch.Generator) -> dict:
    """The backward kernel against autograd through ``mha_plain``: every
    compiled head dim, f32 and bf16, at four head groupings, causal and not,
    at each of ``ATTN_BWD_CHECK_SEQS``; then bf16 at ``ATTN_BWD_GQA_SHAPES``,
    causal, with the plain version's own f32 gradients read against its f64
    ones by the same rule, the backward's reading without the forward's
    rounding error of its output (``without_out_lo``, D from the bf16
    output alone; not a limit), and the times of ``time_attention_bwd``."""
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        rule = ATTN_GRAD_RULE if dtype == torch.bfloat16 else F32_GRAD_RULE
        for d in attn_kernel.HEAD_DIMS:
            readings = []
            for (hq, hkv), seq, causal in itertools.product(ATTN_CHECK_HEADS, ATTN_BWD_CHECK_SEQS, (True, False)):
                q, k, v = (torch.randn((1, h, seq, d), generator=gen, device="cuda").to(dtype) for h in (hq, hkv, hkv))
                dout = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
                tile = attention.select_blocks(1, hq, hkv, seq, d, dtype)
                readings.append(grad_reading(attention_grads(q, k, v, dout, causal, tile),
                                             attention_grads(q, k, v, dout, causal), rule))
            torch.cuda.synchronize()
            res[f"flash_attention_bwd {str(dtype)[6:]} d{d}"] = {
                "configs": len(readings), "max_abs_err": max(r["max_abs_err"] for r in readings),
                "max_ratio": max(r["max_ratio"] for r in readings), "rule": readings[0]["rule"]}
    for b, hq, hkv, seq, d in ATTN_BWD_GQA_SHAPES:
        q, k, v = (torch.randn((b, h, seq, d), generator=gen, device="cuda").to(torch.bfloat16) for h in (hq, hkv, hkv))
        dout = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
        tile = attention.select_blocks(b, hq, hkv, seq, d)
        want = attention_grads(q, k, v, dout)
        reading = grad_reading(attention_grads(q, k, v, dout, True, tile), want, ATTN_GRAD_RULE)
        # why the forward writes its output's rounding error: D from the bf16 output alone
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            out = attn_kernel.flash_attention_cuda(*leaves, True, *tile)
        sq, sk, sv, so, lse, _ = out.grad_fn.saved_tensors
        reading["without_out_lo"] = grad_reading(
            attn_kernel.flash_attention_bwd_cuda(sq, sk, sv, so, lse, dout, True), want, ATTN_GRAD_RULE)["max_ratio"]
        del want, leaves, out, sq, sk, sv, so, lse
        f32 = attention_grads(*(t.float() for t in (q, k, v, dout)))
        f64 = attention_grads(*(t.double() for t in (q, k, v, dout)))
        reading["plain_f32_vs_f64"] = grad_reading(f32, f64, ATTN_GRAD_RULE)["max_ratio"]
        del f32, f64
        res[f"flash_attention_bwd bfloat16 {(b, hq, hkv, seq, d)} causal"] = {**reading, **time_attention_bwd(q, k, v, dout)}
        gc.collect()
        torch.cuda.empty_cache()
    return res


def wkv_inputs(gen: torch.Generator, bh: int, seq: int, kd: int) -> tuple[torch.Tensor, ...]:
    """r, k, v ~ N(0, 1), wlog = -exp(N(0, 1) clipped to [-8, 4]), u ~ N(0, 1):
    the distributions of the JAX package's WKV test."""
    r, k, v = (torch.randn((bh, seq, kd), generator=gen, device="cuda") for _ in range(3))
    wlog = -torch.exp(torch.randn((bh, seq, kd), generator=gen, device="cuda").clamp(-8, 4))
    return r, k, v, wlog, torch.randn((kd,), generator=gen, device="cuda")


def wkv_reading(got: tuple, plain: tuple) -> dict:
    """(out, state) of a kernel against the plain version's, by ``WKV_RULE``."""
    return {"max_abs_err": max(max_err(a, b) for a, b in zip(got, plain)),
            "max_ratio": max(rule_ratio(a, b, WKV_RULE) for a, b in zip(got, plain)),
            "rule": rule_text(WKV_RULE)}


def attn_reading(got: torch.Tensor, plain: torch.Tensor) -> dict:
    """bf16 attention against the plain version: max abs error within
    ``TOL[bf16]`` and ``ATTN_RULE``."""
    return {"max_abs_err": max_err(got, plain), "tol": TOL[torch.bfloat16],
            "max_ratio": rule_ratio(got, plain, ATTN_RULE), "rule": rule_text(ATTN_RULE)}


def wkv_with_states(r, k, v, wlog, u, s0, chunk: int, without: tuple) -> dict:
    """The forward with its chunk-start states kept, as ``WKVFn``'s forward
    keeps them: out and the final state against the plain version's and the
    states against the f64 recurrence's, by ``WKV_RULE``, and whether out
    and the final state are the bits of ``without``, the same call with the
    states to scratch."""
    bh, seq, kd = r.shape
    out, state = torch.empty_like(r), torch.empty((bh, kd, kd), device=r.device)
    states = torch.empty((bh, seq // chunk, kd, kd), device=r.device)
    wkv_kernel._launch_forward(r, k, v, wlog, u, s0, out, state, states, chunk)
    plain = wkv.wkv_plain(r, k, v, wlog, u, s0)
    start = torch.zeros((bh, kd, kd), device=r.device) if s0 is None else s0
    res = wkv_reading((out, state, states), (*plain, wkv_f64_chunk_states(r, k, v, wlog, u, start, chunk)))
    res["same_bits_as_without"] = bool(torch.equal(out, without[0]) and torch.equal(state, without[1]))
    if not res["same_bits_as_without"]:
        res["max_ratio"] = math.inf  # the states must not change what is computed
    return res


def check_wkv(gen: torch.Generator) -> dict:
    """Every compiled (chunk, K), output and final state, against
    ``wkv_plain`` by the elementwise rule, at each of ``WKV_CHECK_SHAPES``;
    and again with the chunk-start states kept, those held too."""
    res = {}
    for (bh, seq), kd in itertools.product(WKV_CHECK_SHAPES, wkv_kernel.HEAD_DIMS):
        inputs = wkv_inputs(gen, bh, seq, kd)
        plain = wkv.wkv_plain(*inputs)
        for chunk in wkv_kernel.CHUNKS:
            got = wkv_kernel.wkv_cuda(*inputs, chunk=chunk)
            res[f"wkv L{chunk} K{kd} S{seq}"] = wkv_reading(got, plain)
            res[f"wkv with states L{chunk} K{kd} S{seq}"] = wkv_with_states(*inputs, None, chunk, got)
    return res


def check_wkv_heads(gen: torch.Generator) -> dict:
    """Every compiled (chunk, K) in the models' form: a bonus per head
    (row bh % H) and a random initial state, against ``wkv_plain``."""
    res = {}
    bh = 2 * WKV_CHECK_HEADS
    for kd in wkv_kernel.HEAD_DIMS:
        r, k, v, wlog, _ = wkv_inputs(gen, bh, 128, kd)
        u = torch.randn((WKV_CHECK_HEADS, kd), generator=gen, device="cuda")
        s0 = torch.randn((bh, kd, kd), generator=gen, device="cuda")
        plain = wkv.wkv_plain(r, k, v, wlog, u, s0)
        for chunk in wkv_kernel.CHUNKS:
            got = wkv_kernel.wkv_cuda(r, k, v, wlog, u, chunk=chunk, s0=s0)
            res[f"wkv per-head u, s0 L{chunk} K{kd} S128"] = wkv_reading(got, plain)
            res[f"wkv per-head u, s0, with states L{chunk} K{kd} S128"] = wkv_with_states(
                r, k, v, wlog, u, s0, chunk, got)
    return res


def wkv_grads(r, k, v, wlog, u, s0, dout, ds=None, chunk=None) -> tuple[torch.Tensor, ...]:
    """(dr, dk, dv, dwlog, du, ds0) for the upstream gradients ``dout`` of
    the output and ``ds`` of the final state (None: the output's alone):
    through the kernel and its backward kernel (``WKVFn``) at ``chunk``, or,
    where ``chunk`` is None, through the stepwise plain version
    (``wkv_plain``; ``wkv_f64`` for f64 inputs)."""
    leaves = [t.detach().requires_grad_() for t in (r, k, v, wlog, u, s0)]
    with torch.enable_grad():
        if chunk is not None:
            out, s = wkv_kernel.wkv_cuda(*leaves[:5], chunk=chunk, s0=leaves[5])
        else:
            out, s = (wkv_f64 if r.dtype == torch.float64 else wkv.wkv_plain)(*leaves)
        if ds is None:
            return torch.autograd.grad(out, leaves, dout.to(out.dtype))
        return torch.autograd.grad((out, s), leaves, (dout.to(out.dtype), ds.to(s.dtype)))


def check_wkv_bwd(gen: torch.Generator) -> dict:
    """The backward kernel at every compiled (chunk, K), in the models' form
    (a bonus per head, row bh % H, an initial state) with the final state's
    gradient given, at S = ``WKV_BWD_CHECK_SEQ``: all six gradients against
    autograd through the stepwise plain version by ``WKV_GRAD_RULE``, and
    both against the same in f64."""
    res = {}
    bh, seq = 2 * WKV_CHECK_HEADS, WKV_BWD_CHECK_SEQ
    names = ("dr", "dk", "dv", "dwlog", "du", "ds0")
    for kd in wkv_kernel.HEAD_DIMS:
        r, k, v, wlog, _ = wkv_inputs(gen, bh, seq, kd)
        u = torch.randn((WKV_CHECK_HEADS, kd), generator=gen, device="cuda")
        s0, ds = (torch.randn((bh, kd, kd), generator=gen, device="cuda") for _ in range(2))
        dout = torch.randn((bh, seq, kd), generator=gen, device="cuda")
        inputs = (r, k, v, wlog, u, s0, dout, ds)
        want = wkv_grads(*inputs)
        f64 = wkv_grads(*(t.double() for t in inputs))
        plain_vs_f64 = grad_reading(want, f64, WKV_GRAD_RULE)["max_ratio"]
        for chunk in wkv_kernel.CHUNKS:
            n = wkv_kernel.wkv_bwd_cuda.launches
            got = wkv_grads(*inputs, chunk=chunk)
            if wkv_kernel.wkv_bwd_cuda.launches != n + 1:
                fail(f"the WKV gradient at (chunk {chunk}, K {kd}) did not launch the backward kernel once")
            res[f"wkv_bwd per-head u, s0, ds L{chunk} K{kd} S{seq}"] = {
                **grad_reading(got, want, WKV_GRAD_RULE),
                "by_gradient": {n: scaled_ratio(a, b, WKV_GRAD_RULE) for n, a, b in zip(names, got, want)},
                "kernel_vs_f64": grad_reading(got, f64, WKV_GRAD_RULE)["max_ratio"],
                "plain_f32_vs_f64": plain_vs_f64}
        torch.cuda.synchronize()
    return res


def check_model_padded(gen: torch.Generator) -> dict:
    """The model's own kernel calls at S = ``MODEL_CHECK_SEQ``, which they pad
    (attention to 128, WKV to 112), against the plain versions on the
    unpadded inputs: attention at Qwen2.5-14B's head dim and group of 5 in
    bf16, WKV at RWKV6-1.6B's head size with a bonus per head and an initial
    state."""
    seq = MODEL_CHECK_SEQ
    q = torch.randn((2, seq, 10, 128), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((2, seq, 2, 128), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
    out = model_layers.attention(q, k, v)
    plain = attention.mha_plain(*(a.transpose(1, 2) for a in (q, k, v))).transpose(1, 2)
    res = {f"model attention bfloat16 d128 S{seq} padded": attn_reading(out, plain)}
    r, kk, vv = (torch.randn((2, seq, 4, 64), generator=gen, device="cuda") for _ in range(3))
    wlog = -torch.exp(torch.randn((2, seq, 4, 64), generator=gen, device="cuda").clamp(-8, 4))
    u = torch.randn((4, 64), generator=gen, device="cuda")
    s0 = torch.randn((2, 4, 64, 64), generator=gen, device="cuda")
    out, state = model_rwkv6.wkv_heads(r, kk, vv, wlog, u, s0)

    def rows(a):  # (B, S, H, K) -> (B H, S, K)
        return a.permute(0, 2, 1, 3).reshape(8, seq, 64)

    plain = wkv.wkv_plain(rows(r), rows(kk), rows(vv), rows(wlog), u, s0.reshape(8, 64, 64))
    res[f"model wkv K64 S{seq} padded"] = wkv_reading((rows(out), state.reshape(8, 64, 64)), plain)
    return res


def in_measured_order(times: dict[str, float]) -> bool:
    """Whether the configurations, in the ``MEASURED_ORDER`` that their
    entry point's ``config_space`` lists them in, run fastest first here."""
    listed = list(times.values())
    return listed == sorted(listed)


def bound_ms(n_bytes: float, flops: float, dtype) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate for ``dtype``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def attention_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor) -> tuple[float, str]:
    """``bound_ms`` of causal attention: q, k, v read and out written once;
    QK^T and PV over the unmasked (query, key) pairs."""
    b, hq, seq, d = q.shape
    n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, out))
    return bound_ms(n_bytes, 4.0 * b * hq * d * seq * (seq + 1) / 2, q.dtype)


def wkv_bound(r: torch.Tensor, u: torch.Tensor, with_s0: bool) -> tuple[float, str]:
    """``bound_ms`` of the f32 WKV: r, k, v, wlog read and out written once,
    u read, the final state written (and the initial one read)."""
    bh, seq, kd = r.shape
    n_bytes = 4.0 * (5 * bh * seq * kd + u.numel() + (1 + with_s0) * bh * kd * kd)
    return bound_ms(n_bytes, float(WKV_FLOPS_PER_TOKEN * kd * kd * bh * seq), torch.float32)


def wkv_design_bound(r: torch.Tensor, u: torch.Tensor, with_s0: bool, chunk: int) -> float:
    """The least time of the forward's own design at ``chunk``: the function's
    bytes, k, v and wlog read a second time (by the state walk and by the
    output kernel), and the chunk-start states (4 K / chunk bytes a token
    and channel) written by the walk and read by the output kernel."""
    bh, seq, kd = r.shape
    n_bytes = 4.0 * ((8 + 2 * kd / chunk) * bh * seq * kd + u.numel() + (1 + with_s0) * bh * kd * kd)
    return bound_ms(n_bytes, float(WKV_FLOPS_PER_TOKEN * kd * kd * bh * seq), torch.float32)[0]


def conv3d_star(src: torch.Tensor, r: int) -> torch.Tensor:
    """The stencil's yardstick: one ``conv3d`` call with the star's weights
    in a (2r + 1)^3 kernel, zeros elsewhere.  It computes the interior
    ``[r:-r]^3`` that the TPU kernel defines; the port never calls it."""
    w = torch.zeros((2 * r + 1,) * 3, dtype=src.dtype, device=src.device)
    for k, (dz, dy, dx) in enumerate(star_offsets(r)):
        w[r + dz, r + dy, r + dx] = float(star_weights_np(r)[k])
    return torch.nn.functional.conv3d(src[None, None], w[None, None])[0, 0]


def in_turns(fns: dict, reps: int = REPS) -> dict[str, list[float]]:
    """``time_ms`` of each function, forward and then in reverse order
    (a, b, b, a), so that both readings of each come from one card."""
    names = list(fns)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(time_ms(fns[n], reps=reps))
    return times


def phase_main_paper() -> list[dict]:
    """The paper's loop: stencil25 and three LBM steps, block=None."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    src = torch.randn(STENCIL_SHAPE, generator=gen, device="cuda", dtype=torch.float64)
    f0, phase0, vel = lbm.init_fields(LBM_SHAPE, seed=0, dtype=torch.float64)
    torch.cuda.synchronize()

    # --- the main path, through the entry points a user calls -------------
    zero_counts()
    t0 = time.perf_counter()
    dst = stencil25.stencil25(src)  # block=None: the estimator picks it
    f, phase = f0, phase0
    for _ in range(LBM_STEPS):
        f, phase = lbm.lbm_step(f, phase, vel)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = read_counts()
    if not (launches["stencil25"] and launches["lbm_d3q15"]):
        fail(f"a kernel of the main path never launched: {launches}")
    select_s = select_block_seconds()

    out = []
    # --- stencil ------------------------------------------------------------
    cfg, pred = stencil25.select_block(STENCIL_SHAPE, 4, torch.float64)
    if tuple(dst.shape) != STENCIL_SHAPE or not bool(torch.isfinite(dst).all()):
        fail("stencil output is not finite or has the wrong shape")
    plain = stencil25.stencil25_plain(src, 4)
    err = max_err(dst, plain)
    library = {"library_ms": None}
    try:  # one PyTorch call for the interior; may need more memory than the card has
        library["library_max_abs_err"] = max_err(conv3d_star(src, 4), plain[(slice(4, -4),) * 3])
        library["library_ms"] = time_ms(lambda: conv3d_star(src, 4), reps=5, warmup=1)
    except RuntimeError as exc:
        library["library_error"] = str(exc).splitlines()[0][:300]
        torch.cuda.empty_cache()
    del plain
    cells = src.numel()
    block, fold = cfg["block"], cfg["fold"]
    turns = in_turns({"direct": lambda: st_kernel.stencil25_direct_cuda(src, 4, block, fold),
                      "staged": lambda: stencil25.stencil25_cuda(src, 4, block, fold)})
    ms, direct_ms = statistics.mean(turns["staged"]), statistics.mean(turns["direct"])
    one_ms = time_one_launch_ms(lambda: stencil25.stencil25_cuda(src, 4, block, fold))
    plain_ms = time_ms(lambda: stencil25.stencil25_plain(src, 4), reps=5, warmup=1)
    copy_ms = time_ms(lambda: dst.copy_(src))
    b_ms, b_by = bound_ms(cells * STENCIL_BYTES_PER_CELL, cells * (2 * 25 - 1), torch.float64)
    spec = appspec.star3d(**cfg)
    out.append({"name": "stencil25", "shape": STENCIL_SHAPE, "dtype": "float64",
                "block": block, "fold": fold, "predicted_glups": pred.glups,
                "predicted_limiter": pred.limiter, "ms": ms, "ms_turns": turns["staged"],
                "direct_ms": direct_ms, "direct_ms_turns": turns["direct"],
                "ms_one_launch": one_ms, "measured_glups": cells / ms / 1e6,
                "direct_glups": cells / direct_ms / 1e6,
                "prediction_error": pred.glups / (cells / ms / 1e6),
                "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
                "plain_ms": plain_ms, "copy_ms": copy_ms, **library,
                "smem_bytes": st_kernel.smem_bytes(block, fold, 4, src.dtype),
                "blocks_per_sm": st_kernel.blocks_per_sm(src.dtype, block, fold, 4),
                "model_blocks_per_sm": H100_SXM.blocks_per_sm(1024, spec.regs_per_thread),
                "model_wave_blocks": wave_size(spec, H100_SXM),
                "registers": st_kernel.kernel_attributes(src.dtype, fold)["registers"],
                "direct_registers": st_kernel.kernel_attributes(src.dtype, fold, staged=False)["registers"],
                "max_abs_err": err, "launches": launches["stencil25"]})
    del src, dst

    # --- LBM ----------------------------------------------------------------
    lcfg, lpred = lbm.select_block(LBM_SHAPE, torch.float64)
    if not (bool(torch.isfinite(f).all()) and bool(torch.isfinite(phase).all())):
        fail("LBM output is not finite")
    fr, pr = f0, phase0
    for _ in range(LBM_STEPS):
        fr, pr = lbm.lbm_step_plain(fr, pr, vel)
    lerr = max(max_err(f, fr), max_err(phase, pr))
    del fr, pr, f, phase
    cells = phase0.numel()
    ms = time_ms(lambda: lbm.lbm_d3q15_cuda(f0, phase0, vel, block=lcfg["block"]))
    one_ms = time_one_launch_ms(lambda: lbm.lbm_d3q15_cuda(f0, phase0, vel, block=lcfg["block"]))
    plain_ms = time_ms(lambda: lbm.lbm_step_plain(f0, phase0, vel), reps=5, warmup=1)
    yard = torch.empty_like(f0)
    copy_ms = time_ms(lambda: yard.copy_(f0))
    b_ms, b_by = bound_ms(cells * LBM_BYTES_PER_CELL, cells * 350.0, torch.float64)
    out.append({"name": "lbm_d3q15", "shape": LBM_SHAPE, "dtype": "float64",
                "block": lcfg["block"], "fold": lcfg["fold"], "predicted_glups": lpred.glups,
                "predicted_limiter": lpred.limiter, "ms": ms, "ms_one_launch": one_ms,
                "measured_glups": cells / ms / 1e6,
                "bound_ms": b_ms, "bound_by": b_by, "plain_ms": plain_ms,
                "copy_ms": copy_ms, "copy_bytes": f0.numel() * 8, "steps": LBM_STEPS,
                "max_abs_err": lerr, "launches": launches["lbm_d3q15"]})
    emit({"phase": "main", "path": "paper", "seconds": main_s, "launches": launches,
          "select_block_s": select_s, "results": out})
    bad = [r["name"] for r in out if not r["max_abs_err"] <= TOL[torch.float64]]
    if bad:
        fail(f"main-path outputs disagree with the plain versions: {bad}")
    return out


def select_block_seconds() -> dict:
    """Host seconds of ``select_block`` at the paper grids: cold, with its
    ranking's cache cleared first, then cached, the second call."""
    calls = {"stencil25": (stencil25, (STENCIL_SHAPE, 4, torch.float64)),
             "lbm_d3q15": (lbm, (LBM_SHAPE, torch.float64))}
    out = {}
    for name, (module, args) in calls.items():
        module.rank_configs.cache_clear()
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            module.select_block(*args)
            times.append(time.perf_counter() - t0)
        out[name] = {"cold": times[0], "cached": times[1]}
    return out


def phase_rank() -> dict:
    """Every configuration of both paper spaces timed against the one
    predicted ranking (``benchmarks/torch_rank_check.py``); the tensors are
    freed before the serve paths."""
    res = rank_check.run(ROOT / "results" / "rank_check.json")
    emit({"phase": "rank", **res})
    gc.collect()
    torch.cuda.empty_cache()
    return res


def ranking_ties(study_records, ranking) -> dict:
    """The ``Study``'s order against ``ops.rank_configs``' (select_block's
    ranking at the main path's grid, in space order): each configuration's
    predicted GLup/s must be the same number in both, and the ``Study``'s
    order must be the ranking sorted best first, where the two may differ
    only inside a group of equal GLup/s.  Returns the comparison; fails the
    run where they disagree."""
    def ident(cfg):
        return (tuple(cfg["block"]), tuple(cfg["fold"]))

    pred = {ident(cfg): p.glups for cfg, _, p in ranking}
    got = [(ident(r.config), r.metrics["glups"]) for r in study_records]
    if sorted(c for c, _ in got) != sorted(pred) or any(pred[c] != g for c, g in got):
        fail("explore: the Study's predictions differ from ops.rank_configs'")
    want = sorted(pred.items(), key=lambda item: -item[1])  # stable: ties in space order
    if [g for _, g in got] != [g for _, g in want]:
        fail("explore: the Study's order is not ops.rank_configs' order by predicted GLup/s")
    groups = {}
    for (c, g), (w, _) in zip(got, want):
        groups.setdefault(g, ([], []))
        groups[g][0].append(c)
        groups[g][1].append(w)
    tied = {g: cw for g, cw in groups.items() if len(cw[0]) > 1}
    if any(sorted(a) != sorted(b) for a, b in tied.values()):
        fail("explore: a group of equal GLup/s holds other configurations in the Study")
    return {"tie_groups": len(tied),
            "configs_in_ties": sum(len(a) for a, _ in tied.values()),
            "ties_ordered_alike": all(a == b for a, b in tied.values()),
            "top_tied": len(groups[got[0][1]][0]) > 1,
            "study_top": list(got[0][0]), "select_block_top": list(want[0][0]),
            "study_breaks_ties_by": "descending canonical AccessIR fingerprint (sort_records)",
            "select_block_breaks_ties_by": "first in space order (max over rank_configs)"}


def explore_sweeps(root: Path) -> dict:
    """Step 1 of phase explore: each paper space through ``Study`` on the
    H100 model, cold into a JSONL store and an alias store under ``root``,
    then warm.  The warm run must serve every configuration from the store
    and trace no IR."""
    out = {}
    for kernel in ("stencil25", "lbm_d3q15"):
        kw = dict(machine=EXPLORE_MACHINE, store=root / f"{kernel}.jsonl", alias=root / f"{kernel}_alias.jsonl")
        t0 = time.perf_counter()
        cold = explore.Study(kernel, **kw).result()
        cold_s = time.perf_counter() - t0
        tracer = obs_trace.enable()
        try:
            t0 = time.perf_counter()
            warm = explore.Study(kernel, **kw).result()
            warm_s = time.perf_counter() - t0
            spans = tracer.span_names()
        finally:
            obs_trace.disable()
        n = cold.stats.candidates
        if not (cold.stats.evaluated == n and warm.stats.cache_hits == n and warm.stats.evaluated == 0):
            fail(f"explore: {kernel}'s warm sweep did not serve every configuration from the store")
        if "study.trace_ir" in spans:
            fail(f"explore: {kernel}'s warm sweep traced IR")
        if [r.metrics for r in warm.records] != [r.metrics for r in cold.records]:
            fail(f"explore: {kernel}'s warm records differ from its cold ones")
        ranking = (stencil25.rank_configs(STENCIL_SHAPE, 4, torch.float64, H100_SXM) if kernel == "stencil25"
                   else lbm.rank_configs(LBM_SHAPE, torch.float64, H100_SXM))
        out[kernel] = {"result": cold, "configs": n, "cold_s": cold_s, "warm_s": warm_s,
                       "warm_cache_hits": warm.stats.cache_hits,
                       "order": ranking_ties(cold.records, ranking)}
    return out


def explore_run_pick(kernel: str, cfg: dict, inputs: dict) -> dict:
    """Launch one pick at the paper grid, hold it against the plain
    version (f64, 1e-10 over the whole grid) and time it as phase main
    does.  Returns the reading; the caller has counted the launch."""
    block, fold = tuple(cfg["block"]), tuple(cfg["fold"])
    if kernel == "stencil25":
        src = inputs["src"]
        err = max_err(st_kernel.stencil25_cuda(src, 4, block, fold), inputs["plain"])
        ms = time_ms(lambda: st_kernel.stencil25_cuda(src, 4, block, fold))
        cells = src.numel()
    else:
        f0, phase0, vel = inputs["fields"]
        fo, po = lbm_kernel.lbm_d3q15_cuda(f0, phase0, vel, block=block)
        err = max(max_err(fo, inputs["plain"][0]), max_err(po, inputs["plain"][1]))
        del fo, po
        ms = time_ms(lambda: lbm_kernel.lbm_d3q15_cuda(f0, phase0, vel, block=block))
        cells = phase0.numel()
    return {"block": list(block), "fold": list(fold), "max_abs_err": err, "ms": ms,
            "measured_glups": cells / ms / 1e6}


def beside_rank(rank_file: dict, kernel: str, pick: dict) -> dict:
    """The pick beside phase rank's records of the same space: the fastest
    configuration's time there, the pick's own time and measured rank
    there, and ``pick_over_best`` (this phase's time of the pick over that
    fastest time)."""
    recs = rank_file["configs"][kernel]
    kind = "staged" if kernel == "stencil25" else "kernel"
    ms = [r[kind]["ms"] for r in recs]
    best = min(range(len(ms)), key=ms.__getitem__)
    mine = next(i for i, r in enumerate(recs) if r["block"] == pick["block"] and r["fold"] == pick["fold"])
    return {"rank_best_ms": ms[best], "rank_best": {"block": recs[best]["block"], "fold": recs[best]["fold"]},
            "rank_pick_ms": ms[mine], "rank_pick_measured_rank": sorted(ms).index(ms[mine]),
            "pick_over_best": pick["ms"] / ms[best]}


def explore_daemon(sweep) -> dict:
    """Step 4: the estimation daemon on 127.0.0.1 (a free port), the 162
    stencil configurations posted cold and then warm; its records must
    equal the sweep's."""
    root = ROOT / "build" / "explore" / "serve"
    server, service = explore_serve.serve(host="127.0.0.1", port=0, root=str(root))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    client = explore_serve.ServeClient("127.0.0.1", server.server_address[1])
    try:
        configs = [r.config for r in sweep.records]
        t0 = time.perf_counter()
        cold = client.estimate("stencil25", configs, machine=EXPLORE_MACHINE)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm = [client.estimate("stencil25", configs, machine=EXPLORE_MACHINE) for _ in range(EXPLORE_WARM_POSTS)]
        warm_s = time.perf_counter() - t0
        health = client.health()
    finally:
        client.shutdown()
        client.close()
        thread.join(timeout=30)
        server.server_close()
        service.close()
    if thread.is_alive():
        fail("explore: the daemon did not stop")
    n = len(configs)
    if cold["stats"]["estimated"] != n or any(w["stats"]["store_hits"] != n for w in warm):
        fail(f"explore: the daemon's cold and warm stats are off: {cold['stats']}, {warm[-1]['stats']}")
    want = {r.fingerprint: r for r in sweep.records}
    for resp in [cold] + warm:
        for wire in resp["records"]:
            rec = want.get(wire["fingerprint"])
            if rec is None or (json.dumps(wire["config"]), wire["metrics"], wire["volumes"], wire["time_s"],
                               wire["limiter"], wire["feasible"]) != (
                    json.dumps(rec.config, default=list), rec.metrics, rec.volumes, rec.time_s,
                    rec.limiter, rec.feasible):
                fail("explore: the daemon's records differ from the Study's")
    return {"configs": n, "cold_s": cold_s, "warm_posts": EXPLORE_WARM_POSTS,
            "warm_queries_per_s": n * EXPLORE_WARM_POSTS / warm_s, "health_ok": health["ok"]}


def phase_explore(rank: dict) -> dict:
    """The exploration (``repro_torch.explore``) on the H100 model, and its
    picks on the card, as the module docstring says."""
    root = ROOT / "build" / "explore"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t_phase = time.perf_counter()
    sweeps = explore_sweeps(root)
    stencil_sweep = sweeps["stencil25"]["result"]
    t0 = time.perf_counter()
    searched = explore.Study("stencil25", machine=EXPLORE_MACHINE).run(
        search=explore_search.SuccessiveHalving(budget=EXPLORE_BUDGET, seed=0))
    search_s = time.perf_counter() - t0
    found = searched.result()
    stats = searched.search_stats
    search = {"budget": EXPLORE_BUDGET, "seed": 0, "seconds": search_s, "pool": stats.pool,
              "proxy_evaluated": stats.proxy_evaluated, "full_selected": stats.full_selected,
              "pareto_recall": explore_search.pareto_recall(found.records, stencil_sweep.pareto()),
              "best_equals_exhaustive": found.top(1)[0].config == stencil_sweep.top(1)[0].config,
              "best_glups_equals_exhaustive": found.top(1)[0].metrics["glups"]
              == stencil_sweep.top(1)[0].metrics["glups"]}
    picks = {"stencil25": sweeps["stencil25"]["result"].top(1)[0].config,
             "search": found.top(1)[0].config,
             "lbm_d3q15": sweeps["lbm_d3q15"]["result"].top(1)[0].config}
    host_s = time.perf_counter() - t_phase

    # --- the picks on the card: the path, counted ---------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    src = torch.randn(STENCIL_SHAPE, generator=gen, device="cuda", dtype=torch.float64)
    fields = lbm.init_fields(LBM_SHAPE, seed=0, dtype=torch.float64)
    torch.cuda.synchronize()
    zero_counts()
    seen = {}
    for name, cfg in picks.items():
        counter = st_kernel.stencil25_cuda if name != "lbm_d3q15" else lbm_kernel.lbm_d3q15_cuda
        before = counter.launches
        if name == "lbm_d3q15":
            lbm_kernel.lbm_d3q15_cuda(*fields, block=tuple(cfg["block"]))
        else:
            st_kernel.stencil25_cuda(src, 4, tuple(cfg["block"]), tuple(cfg["fold"]))
        seen[name] = counter.launches - before
    torch.cuda.synchronize()
    launches = read_counts()
    if not all(seen.values()) or not (launches["stencil25"] and launches["lbm_d3q15"]):
        fail(f"explore: a pick did not launch its kernel: {seen}, {launches}")

    # --- held against the plain versions, timed, beside phase rank ----------
    rank_file = json.loads((ROOT / "results" / "rank_check.json").read_text())
    runs = {}
    for kernel, names in (("stencil25", ("stencil25", "search")), ("lbm_d3q15", ("lbm_d3q15",))):
        inputs = ({"src": src, "plain": stencil25.stencil25_plain(src, 4)} if kernel == "stencil25"
                  else {"fields": fields, "plain": lbm.lbm_step_plain(*fields)})
        for name in names:
            runs[name] = explore_run_pick(kernel, picks[name], inputs)
            runs[name].update(beside_rank(rank_file, kernel, runs[name]))
        del inputs
    del src, fields
    gc.collect()
    torch.cuda.empty_cache()
    daemon = explore_daemon(stencil_sweep)
    parts = rank["seconds_by_part"]
    autotune = {k: parts[f"{k}_check"] + parts[f"{k}_timing"] for k in ("stencil", "lbm")}
    res = {"phase": "explore", "machine": EXPLORE_MACHINE, "host_s": host_s,
           "sweeps": {k: {kk: vv for kk, vv in v.items() if kk != "result"} for k, v in sweeps.items()},
           # phase rank's seconds checking and timing every configuration
           # (the stencil's on both of its kernels), and its whole run
           "rank_phase_s": {"stencil25": autotune["stencil"], "lbm_d3q15": autotune["lbm"],
                            "total": rank["seconds"]},
           "study_cold_s": {k: v["cold_s"] for k, v in sweeps.items()},
           "search": search, "picks": runs, "launches": launches, "daemon": daemon,
           "seconds": time.perf_counter() - t_phase}
    emit(res)
    bad = {n: r["max_abs_err"] for n, r in runs.items() if not r["max_abs_err"] <= TOL[torch.float64]}
    if bad:
        fail(f"explore: picks disagree with the plain versions: {bad}")
    return res


def _cfg_key(cfg: dict) -> tuple:
    return tuple(cfg["block"]), tuple(cfg["fold"])


def audit_spaces() -> dict:
    """Step 1 of phase audit: ``analysis.analyze_ir`` on the H100 model over
    every configuration of both paper spaces that the port launches, cold
    (both caches cleared) and then warm.  Fails where a configuration has an
    ``error`` finding, or the warm pass is not all ``lint.cache_hits``."""
    analysis.clear_cache()
    out = {}
    for kernel, cfgs, build in (("stencil25", stencil25.config_space(STENCIL_SHAPE), appspec.star3d_ir),
                                ("lbm_d3q15", lbm.config_space(LBM_SHAPE), appspec.lbm_d3q15_ir)):
        irs = [build(**cfg) for cfg in cfgs]
        passes = {}
        for name in ("cold", "warm"):
            hits = obs_metrics.counter("lint.cache_hits").value
            t0 = time.perf_counter()
            reports = [analysis.analyze_ir(ir, AUDIT_MACHINE) for ir in irs]
            passes[name] = (time.perf_counter() - t0, obs_metrics.counter("lint.cache_hits").value - hits)
        if passes["warm"][1] != len(irs):
            fail(f"audit: {kernel}'s warm pass was {passes['warm'][1]:g} cache hits of {len(irs)}")
        errors = [list(_cfg_key(c)) for c, rep in zip(cfgs, reports) if not rep.ok("error")]
        if errors:
            fail(f"audit: configurations the port launches have error findings: {kernel} {errors}")
        by_rule = collections.Counter(f"{f.rule} [{f.severity}]" for rep in reports for f in rep.findings)
        out[kernel] = {"configs": len(irs), "cold_s": passes["cold"][0], "warm_s": passes["warm"][0],
                       "warm_cache_hits": passes["warm"][1],
                       "findings": dict(sorted(by_rule.items())),
                       "cfgs": cfgs, "reports": reports}
    return out


def audit_beside_rank(spaces: dict, rank_file: dict) -> dict:
    """Step 2: each perf rule's flagged configurations beside phase rank's
    measured times of the same configurations (the stencil's staged kernel,
    the main path's): how many it flags, the median ms of the flagged and
    of the rest, and how many of the fastest ``AUDIT_FASTEST`` it flags."""
    out = {}
    for kernel, kind in (("stencil25", "staged"), ("lbm_d3q15", "kernel")):
        ms = {_cfg_key(r): r[kind]["ms"] for r in rank_file["configs"][kernel]}
        keys = [_cfg_key(c) for c in spaces[kernel]["cfgs"]]
        if sorted(keys) != sorted(ms):
            fail(f"audit: {kernel}'s audited configurations are not phase rank's")
        flagged = {rule: set() for rule in AUDIT_PERF_RULES}
        for key, rep in zip(keys, spaces[kernel]["reports"]):
            for f in rep.findings:
                if f.rule in flagged:
                    flagged[f.rule].add(key)
        fastest = sorted(ms, key=ms.get)[:AUDIT_FASTEST]

        def median(ks):
            return statistics.median(ms[k] for k in ks) if ks else None

        rules = {}
        for rule, hit in flagged.items():
            rules[rule] = {"flagged": len(hit), "median_ms_flagged": median(hit),
                           "median_ms_rest": median([k for k in keys if k not in hit]),
                           f"flagged_in_fastest_{AUDIT_FASTEST}": sum(k in hit for k in fastest)}
        out[kernel] = {"configs": len(keys), "rank_kernel": kind, "median_ms_all": median(keys),
                       "fastest_ms": ms[fastest[0]], "rules": rules}
    return out


def audit_gate(explored: dict) -> dict:
    """Step 3 (host part): ``Study(kernel, machines=["h100"], lint="error")``
    over both paper spaces, cold: every configuration audited before it is
    estimated.  Its top against phase explore's ungated top."""
    out = {}
    for kernel in ("stencil25", "lbm_d3q15"):
        t0 = time.perf_counter()
        study = explore.Study(kernel, machines=[AUDIT_MACHINE], lint="error")
        res = study.result()
        seconds = time.perf_counter() - t0
        top = res.top(1)[0].config
        ungated = explored["picks"][kernel]
        removed = explored["sweeps"][kernel]["configs"] - len(res.records)
        out[kernel] = {"study": study, "top": top, "seconds": seconds, "configs": len(res.records),
                       "reports": len(study.lint_reports),
                       "top_equals_ungated": _cfg_key(top) == _cfg_key(ungated),
                       "ungated_top": {"block": ungated["block"], "fold": ungated["fold"]},
                       "removed_by_gate": removed}
        if removed or len(study.lint_reports) != len(res.records):
            fail(f"audit: the {kernel} lint gate left {len(res.records)} configurations with "
                 f"{len(study.lint_reports)} reports, phase explore swept {explored['sweeps'][kernel]['configs']}")
    return out


def audit_explain(study: dict, rank_file: dict) -> dict:
    """Step 4: ``Study.explain`` for each paper space's pick and for phase
    rank's fastest configuration: the limiter, its runner-up and margin, the
    per-level volumes, and the predicted time and DRAM bytes per LUP beside
    the measured time and effective bytes per LUP (``rank_check.json``)."""
    out = {}
    for kernel, kind in (("lbm_d3q15", "kernel"), ("stencil25", "staged")):
        recs = {_cfg_key(r): r for r in rank_file["configs"][kernel]}
        fastest = min(recs, key=lambda k: recs[k][kind]["ms"])
        targets = {"pick": _cfg_key(study[kernel]["top"]), "fastest": fastest}
        out[kernel] = {}
        for label, (block, fold) in targets.items():
            rep = study[kernel]["study"].explain({"block": block, "fold": fold})
            levels = {lv.level: {"total": lv.total, "unit": lv.unit, **lv.parts} for lv in rep.levels}
            rec = recs[(block, fold)][kind]
            out[kernel][label] = {
                "block": list(block), "fold": list(fold), "limiter": rep.limiter.limiter,
                "runner_up": rep.limiter.runner_up, "margin": rep.limiter.margin,
                "terms_s": rep.limiter.terms, "levels": levels, "wave": rep.wave,
                "lint": sorted({f.rule for f in rep.lint.findings}) if rep.lint is not None else None,
                "predicted_ms": rep.score["time_s"] * 1e3, "predicted_glups": rep.score["glups"],
                "predicted_dram_bytes_per_lup": levels["DRAM<->L2"]["total"],
                "measured_ms": rec["ms"], "measured_glups": rec["glups"],
                "effective_bytes_per_lup": rec["bytes_per_lup"],
                "measured_rank": sorted(r[kind]["ms"] for r in recs.values()).index(rec["ms"])}
    return out


def audit_step() -> dict:
    """Step 5: ``graph.step_time`` of one model step on the H100 model, with
    and without ``lint="annotate"``; the audit may not move the prediction."""
    arch, batch, seq, kind = AUDIT_STEP
    cfg = get_arch(arch)
    t0 = time.perf_counter()
    plain = step_time(cfg, AUDIT_MACHINE, batch=batch, seq=seq, kind=kind)
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    linted = step_time(cfg, AUDIT_MACHINE, batch=batch, seq=seq, kind=kind, lint="annotate")
    lint_s = time.perf_counter() - t0
    if linted.step_time_s != plain.step_time_s:
        fail("audit: lint='annotate' moved the step's prediction")
    by_rule = collections.Counter(f"{f.rule} [{f.severity}]" for rep in linted.lint_reports.values()
                                  for f in rep.findings)
    return {"arch": arch, "batch": batch, "seq": seq, "kind": kind, "nodes": len(linted.dag.nodes),
            "unique_kernels": len(linted.unique), "kernels_audited": len(linted.lint_reports),
            "findings": dict(sorted(by_rule.items())), "step_time_s": linted.step_time_s,
            "host_s": plain_s, "host_s_with_lint": lint_s, "lint_extra_s": lint_s - plain_s}


def audit_goldens() -> dict:
    """Step 6: the JAX package's golden files through the port on this host:
    the CLI's ``lint`` and ``graph`` (a TPU machine) and ``Study.explain``,
    byte for byte with the golden's exit code; then a ``Study`` of each
    ``*_tpu`` entry on both TPU machines (the TPU backend runs on the host)."""
    out = {"files": {}, "tpu_studies": {}}
    for name, (want_rc, argv) in AUDIT_CLI_GOLDENS.items():
        analysis.clear_cache()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = explore_cli.main(argv)
        out["files"][name] = {"rc": rc, "want_rc": want_rc,
                              "byte_for_byte": buf.getvalue() == (GOLDEN_DIR / name).read_text()}
    for name, machine in AUDIT_EXPLAIN_GOLDENS.items():
        rep = explore.Study("stencil25", sample=24, seed=7, machine=machine).explain(dict(AUDIT_EXPLAIN_CFG))
        out["files"][name] = {"byte_for_byte": rep.render() + "\n" == (GOLDEN_DIR / name).read_text()}
    bad = [n for n, r in out["files"].items() if not r["byte_for_byte"] or r.get("rc") != r.get("want_rc")]
    if bad:
        fail(f"audit: the port does not print these goldens as the JAX package does: {bad}")
    for kernel in AUDIT_TPU_KERNELS:
        t0 = time.perf_counter()
        study = explore.Study(kernel, machines=list(AUDIT_TPU_MACHINES))
        res = study.run()
        seconds = time.perf_counter() - t0
        tops = {}
        for label, r in res.results.items():
            best = r.top(1)[0]
            if not (best.feasible and math.isfinite(best.time_s) and best.time_s > 0):
                fail(f"audit: {kernel}'s TPU top on {label} is not a feasible finite estimate")
            tops[label] = {"config": best.config["name"], "time_us": best.time_s * 1e6, "limiter": best.limiter}
        out["tpu_studies"][kernel] = {"configs": len(next(iter(res.results.values())).records),
                                      "seconds": seconds, "tops": tops}
    return out


def phase_audit(explored: dict) -> dict:
    """The static auditor (``repro_torch.analysis``) and the TPU backend, as
    the module docstring says; the lint gate's picks run on the card."""
    t_phase = time.perf_counter()
    spaces = audit_spaces()
    rank_file = json.loads((ROOT / "results" / "rank_check.json").read_text())
    beside = audit_beside_rank(spaces, rank_file)
    gate = audit_gate(explored)
    host_s = time.perf_counter() - t_phase

    # --- the gate's picks on the card: the path, counted --------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    src = torch.randn(STENCIL_SHAPE, generator=gen, device="cuda", dtype=torch.float64)
    fields = lbm.init_fields(LBM_SHAPE, seed=0, dtype=torch.float64)
    torch.cuda.synchronize()
    zero_counts()
    seen = {}
    for kernel in ("stencil25", "lbm_d3q15"):
        block, fold = _cfg_key(gate[kernel]["top"])
        counter = st_kernel.stencil25_cuda if kernel == "stencil25" else lbm_kernel.lbm_d3q15_cuda
        before = counter.launches
        if kernel == "stencil25":
            st_kernel.stencil25_cuda(src, 4, block, fold)
        else:
            lbm_kernel.lbm_d3q15_cuda(*fields, block=block)
        seen[kernel] = counter.launches - before
    torch.cuda.synchronize()
    launches = read_counts()
    if not all(seen.values()):
        fail(f"audit: a lint gate's pick did not launch its kernel: {seen}, {launches}")
    picks = {}
    for kernel in ("stencil25", "lbm_d3q15"):
        inputs = ({"src": src, "plain": stencil25.stencil25_plain(src, 4)} if kernel == "stencil25"
                  else {"fields": fields, "plain": lbm.lbm_step_plain(*fields)})
        picks[kernel] = explore_run_pick(kernel, gate[kernel]["top"], inputs)
        picks[kernel].update(beside_rank(rank_file, kernel, picks[kernel]))
        del inputs
    del src, fields
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    explained = audit_explain(gate, rank_file)
    step = audit_step()
    goldens = audit_goldens()
    host_s += time.perf_counter() - t0
    res = {"phase": "audit", "machine": AUDIT_MACHINE,
           "spaces": {k: {kk: vv for kk, vv in v.items() if kk not in ("cfgs", "reports")}
                      for k, v in spaces.items()},
           "perf_lints_beside_rank": beside,
           "gate": {k: {kk: vv for kk, vv in v.items() if kk != "study"} for k, v in gate.items()},
           "picks": picks, "launches": launches, "explain": explained, "step": step, "goldens": goldens,
           "host_s": host_s, "seconds": time.perf_counter() - t_phase}
    emit(res)
    bad = {n: r["max_abs_err"] for n, r in picks.items() if not r["max_abs_err"] <= TOL[torch.float64]}
    if bad:
        fail(f"audit: the lint gate's picks disagree with the plain versions: {bad}")
    return res


def phase_probe(libs: dict) -> dict:
    """The stencil probe's variants in turns at the stencil's main shape."""
    res = stencil_probe.run(libs)
    emit({"phase": "probe", **res})
    bad = {n: res[n]["max_abs_err"] for n in ("direct", "unclamped", "staged")
           if not res[n]["max_abs_err"] <= TOL[torch.float64]}
    if bad:
        fail(f"stencil probe variants disagree with the plain version: {bad}")
    return res


def phase_main_attention() -> dict:
    """``flash_attention(q, k, v)``, causal, tile from ``select_blocks``, at
    one layer of Qwen2.5-14B in bf16."""
    b, hq, hkv, seq, d = ATTN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn((b, h, seq, d), generator=gen, device="cuda").to(torch.bfloat16)
               for h in (hq, hkv, hkv))
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = read_counts()
    if not launches["flash_attention"]:
        fail(f"flash_attention never launched on its main path: {launches}")
    if out.shape != q.shape or out.dtype != q.dtype or not bool(torch.isfinite(out).all()):
        fail("attention output is not finite or has the wrong shape or dtype")
    plain = attention.mha_plain(q, k, v)
    err, ratio = max_err(out, plain), rule_ratio(out, plain, ATTN_RULE)

    def sdpa() -> torch.Tensor:
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    # what the rule reads for a result of lower precision (bf16 P on the tensor cores)
    library_ratio = rule_ratio(sdpa(), plain, ATTN_RULE)
    del plain
    tile = attention.select_blocks(b, hq, hkv, seq, d, q.dtype)
    tiles_ms = {f"{bq}x{bkv}": time_ms(lambda bq=bq, bkv=bkv: attn_kernel.flash_attention_cuda(q, k, v, True, bq, bkv),
                                       reps=ORDER_REPS)
                for bq, bkv in attention.config_space(b, hq, hkv, seq, d, q.dtype)}
    plain_ms = time_ms(lambda: attention.mha_plain(q, k, v), reps=3, warmup=1)
    sdpa_ms = time_ms(sdpa)
    flops = 4.0 * b * hq * d * seq * (seq + 1) / 2  # QK^T and PV over the unmasked pairs
    b_ms, b_by = attention_bound(q, k, v, out)
    ms = tiles_ms[f"{tile[0]}x{tile[1]}"]
    one_ms = time_one_launch_ms(lambda: attn_kernel.flash_attention_cuda(q, k, v, True, *tile))
    # the design's own work: P V runs twice, on P's bf16 hi and lo halves
    design_ms = 1.5 * flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    res = {"name": "flash_attention", "shape": ATTN_SHAPE, "dtype": "bfloat16", "causal": True,
           "tile": tile, "ms": ms, "ms_one_launch": one_ms, "tflops": flops / ms / 1e9,
           "tflops_6d": 1.5 * flops / ms / 1e9, "bound_ms": b_ms, "bound_by": b_by, "design_bound_ms": design_ms,
           "kernel": attn_kernel.kernel_attributes(q.dtype, d, *tile),
           "pr12_ms": PR12_MS["flash_attention"], "pr26_ms": PR26_MS["flash_attention"],
           "plain_ms": plain_ms, "library_ms": sdpa_ms,
           "tiles_ms": tiles_ms, "order_matches": in_measured_order(tiles_ms), "max_abs_err": err,
           "tol": TOL[torch.bfloat16], "max_ratio": ratio, "rule": rule_text(ATTN_RULE),
           "library_ratio": library_ratio, "launches": launches["flash_attention"]}
    emit({"phase": "main", "path": "attention", "seconds": main_s, "launches": launches, "results": [res]})
    if not holds(res):
        fail(f"flash_attention disagrees with mha_plain on its main path: error {err}, ratio {ratio}")
    return res


def phase_main_wkv() -> dict:
    """``wkv(r, k, v, wlog, u)``, chunk from ``select_chunk``, at RWKV6-1.6B's
    32 heads of 64 at batch 2, S = 4096, f32."""
    bh, seq, kd = WKV_SHAPE
    inputs = wkv_inputs(torch.Generator(device="cuda").manual_seed(4), bh, seq, kd)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out, state = wkv.wkv(*inputs)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = read_counts()
    if not launches["wkv"]:
        fail(f"wkv never launched on its main path: {launches}")
    if not (bool(torch.isfinite(out).all()) and bool(torch.isfinite(state).all())):
        fail("WKV output or state is not finite")
    plain_out, plain_state = wkv.wkv_plain(*inputs)
    err = max(max_err(out, plain_out), max_err(state, plain_state))
    ratio = max(rule_ratio(out, plain_out, WKV_RULE), rule_ratio(state, plain_state, WKV_RULE))
    del plain_out, plain_state
    chunk = wkv.select_chunk(bh, seq, kd)
    chunks_ms = {f"L{c}": time_ms(lambda c=c: wkv_kernel.wkv_cuda(*inputs, chunk=c), reps=ORDER_REPS)
                 for c in wkv.config_space(bh, seq, kd)}
    plain_ms = time_ms(lambda: wkv.wkv_plain(*inputs), reps=2, warmup=1)
    # r, k, v, wlog read and out written once; u read and the final state written
    b_ms, b_by = wkv_bound(inputs[0], inputs[4], with_s0=False)
    ms = chunks_ms[f"L{chunk}"]
    one_ms = time_one_launch_ms(lambda: wkv_kernel.wkv_cuda(*inputs, chunk=chunk))
    res = {"name": "wkv", "shape": WKV_SHAPE, "dtype": "float32", "chunk": chunk, "ms": ms,
           "ms_one_launch": one_ms, "pr12_ms": PR12_MS["wkv"], "pr26_ms": PR26_MS["wkv"],
           "bound_ms": b_ms, "bound_by": b_by,
           "design_bound_ms": {f"L{c}": wkv_design_bound(inputs[0], inputs[4], False, c)
                               for c in wkv.config_space(bh, seq, kd)},
           "kernel": {w: wkv_kernel.kernel_attributes(chunk, kd, w) for w in wkv_kernel.FWD_KERNELS},
           "plain_ms": plain_ms, "library_ms": None, "chunks_ms": chunks_ms,
           "order_matches": in_measured_order(chunks_ms), "max_abs_err": err, "max_ratio": ratio,
           "rule": rule_text(WKV_RULE), "launches": launches["wkv"]}
    emit({"phase": "main", "path": "wkv", "seconds": main_s, "launches": launches, "results": [res]})
    if not holds(res):
        fail(f"wkv disagrees with wkv_plain on its main path: ratio {ratio}")
    return res


def scaled_ratio(a: torch.Tensor, b: torch.Tensor, rule: tuple[float, float]) -> float:
    """max |a - b| / (atol rms(b) + rtol |b|): ``rule`` in units of the
    scale of ``b`` (``WKV_SCALED_RULE``)."""
    atol, rtol = rule
    a, b = a.double(), b.double()
    return float(((a - b).abs() / (atol * b.pow(2).mean().sqrt() + rtol * b.abs())).max())


def wkv_f64(r, k, v, wlog, u, s0) -> tuple[torch.Tensor, torch.Tensor]:
    """The stepwise recurrence of ``wkv_plain`` in float64: the yardstick
    that shows how near an f32 computation can come to ``WKV_RULE``."""
    bh, seq, kd = r.shape
    r, k, v, wlog, s = (a.double() for a in (r, k, v, wlog, s0))
    rows = u.double().reshape(-1, kd)
    u = rows[torch.arange(bh, device=r.device) % rows.shape[0]]
    out = torch.empty((bh, seq, kd), dtype=torch.float64, device=r.device)
    for t in range(seq):
        kv = k[:, t, :, None] * v[:, t, None, :]
        out[:, t] = torch.einsum("bk,bkv->bv", r[:, t], s + u[:, :, None] * kv)
        s = torch.exp(wlog[:, t])[:, :, None] * s + kv
    return out, s


def wkv_f64_chunk_states(r, k, v, wlog, u, s0, chunk: int) -> torch.Tensor:
    """The state at each chunk's start from ``wkv_f64``'s recurrence, rounded
    to f32: (BH, S / chunk, K, K), as the forward kernel writes them."""
    states = [s0.double()]
    for c in range(r.shape[1] // chunk - 1):
        at = slice(c * chunk, (c + 1) * chunk)
        states.append(wkv_f64(r[:, at], k[:, at], v[:, at], wlog[:, at], u, states[-1])[1])
    return torch.stack(states, 1).float().contiguous()


def captured_reading(kernel_name: str, args: tuple, kw: dict) -> dict:
    """The kernel against its plain version on inputs the model fed it,
    and its time a launch there (``time_ms``)."""
    if kernel_name == "flash_attention":
        q, k, v = args
        b, hq, seq, d = q.shape
        tile = attention.select_blocks(b, hq, k.shape[1], seq, d, q.dtype)
        out = attn_kernel.flash_attention_cuda(q, k, v, True, *tile)
        plain = attention.mha_plain(q, k, v)
        res = {"shape": [b, hq, k.shape[1], seq, d], "tile": tile, "max_abs_plain": float(plain.abs().max()),
               **attn_reading(out, plain)}
        # TOL[bf16] is an absolute limit for unit-scale values; here the
        # outputs are tens, where one bf16 ulp is 0.0625 to 0.25
        res["tol_holds"] = res.pop("tol") >= res["max_abs_err"]
        res["max_logit"] = max(float(torch.matmul(q[bi, h].float(), k[bi, h // (hq // k.shape[1])].float().T)
                                     .tril().abs().max()) for bi in range(b) for h in (0, hq - 1)) / math.sqrt(d)
        res["ms"] = time_ms(lambda: attn_kernel.flash_attention_cuda(q, k, v, True, *tile))
        res["bound_ms"], res["bound_by"] = attention_bound(q, k, v, out)
        return res
    r, k, v, wlog, u = args
    s0 = kw["s0"]
    chunk = wkv.select_chunk(*r.shape)
    got = wkv_kernel.wkv_cuda(r, k, v, wlog, u, chunk=chunk, s0=s0)
    plain = wkv.wkv_plain(r, k, v, wlog, u, s0)
    f64 = wkv_f64(r, k, v, wlog, u, s0)
    res = {"shape": list(r.shape), "u": list(u.shape), "chunk": chunk, **wkv_reading(got, plain),
           "ms": time_ms(lambda: wkv_kernel.wkv_cuda(r, k, v, wlog, u, chunk=chunk, s0=s0))}
    res["bound_ms"], res["bound_by"] = wkv_bound(r, u, with_s0=True)
    res["design_bound_ms"] = wkv_design_bound(r, u, True, chunk)
    res["wkv_rule_ratio"] = res.pop("max_ratio")  # reported; no f32 result meets it here
    res["max_ratio"] = max(scaled_ratio(a, b, WKV_SCALED_RULE) for a, b in zip(got, plain))
    res["rule"] = f"|a-b| <= {WKV_SCALED_RULE[0]} rms(b) + {WKV_SCALED_RULE[1]}|b|"
    res["rms_out"] = float(plain[0].pow(2).mean().sqrt())
    res["plain_vs_f64_ratio"] = max(rule_ratio(a, b, WKV_RULE) for a, b in zip(plain, f64))
    res["kernel_vs_f64_ratio"] = max(rule_ratio(a, b, WKV_RULE) for a, b in zip(got, f64))
    return res


def frontend_forward(model) -> dict:
    """``model.forward`` at batch 1 with the frontend's stub embeddings over
    the first ``n_frontend_tokens`` positions and ``FRONTEND_TEXT_TOKENS``
    text tokens after them, all drawn from seed 0 on the card; the launch
    counts of the call and whether its logits are finite."""
    cfg = model.cfg
    seq = cfg.n_frontend_tokens + FRONTEND_TEXT_TOKENS
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (1, seq), generator=gen, device="cuda")
    embeds = torch.randn((1, cfg.n_frontend_tokens, cfg.frontend_dim), generator=gen, device="cuda")
    torch.cuda.synchronize()
    zero_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    with torch.inference_mode():
        logits, aux = model(tokens, embeds)
    end.record()
    end.synchronize()
    return {"batch": 1, "seq": seq, "frontend_tokens": cfg.n_frontend_tokens, "ms": start.elapsed_time(end),
            "launches": read_counts(), "logits_shape": list(logits.shape),
            "logits_finite": bool(torch.isfinite(logits).all()), "aux": float(aux)}


def phase_main_serve(path: str) -> dict:
    """``launch.serve.serve`` on the card: ``SERVE_SHAPE`` on the config of
    ``path``, at its published widths and at the depth one card holds.  The
    kernel's inputs at the first and the last layer of the prefill are kept
    (references to the tensors the model made, the WKV's initial state
    copied, since the cache's is updated in place) and held against the
    plain version after the run; the prefill's logits and the last decode
    step's are kept and must be finite.  A config with a frontend then runs
    :func:`frontend_forward` on the model the serving path built, its
    kernel inputs held the same way."""
    arch, kernel_name = SERVE[path]
    cfg, reduced = one_card.one_card_config(arch)
    calls = one_card.attention_layers(cfg) if kernel_name == "flash_attention" else cfg.n_layers
    module, attr = (model_layers, "flash_attention") if kernel_name == "flash_attention" else (model_rwkv6, "wkv")
    original, head, build = getattr(module, attr), model_registry.LM._head, launch_serve.build_model
    captured, logits, models = {}, [], []

    def capture(*args, **kw):
        inputs = (args, {k: v.clone() if k == "s0" else v for k, v in kw.items()})
        captured.setdefault("first", inputs)
        captured["last"] = inputs
        return original(*args, **kw)

    def keep_logits(self, h):
        out = head(self, h)
        logits.append(out)
        del logits[1:-1]  # [the prefill's, the latest step's]
        return out

    def keep_model(*args, **kw):
        models.append(build(*args, **kw))
        return models[-1]

    gc.collect()
    torch.cuda.empty_cache()
    setattr(module, attr, capture)
    model_registry.LM._head = keep_logits
    launch_serve.build_model = keep_model
    frontend, frontend_inputs = None, {}
    try:
        zero_counts()
        t0 = time.perf_counter()
        res = launch_serve.serve(cfg, device="cuda", init_depth=get_arch(arch).n_layers, **SERVE_SHAPE)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = read_counts()
        finite = {"prefill": bool(torch.isfinite(logits[0]).all()),
                  "last_step": bool(torch.isfinite(logits[-1]).all())}
        prefill_logits = list(logits[0].shape)
        logits.clear()
        serve_inputs = dict(captured)
        if cfg.frontend != "none":
            captured.clear()
            frontend = frontend_forward(models[0])
            frontend_inputs = dict(captured)
            logits.clear()
    finally:
        setattr(module, attr, original)
        model_registry.LM._head = head
        launch_serve.build_model = build
        models.clear()
    want = {name: calls if name == kernel_name else 0 for name in KERNELS}
    by_phase = res.pop("launches")
    if launches != want or by_phase["prefill"][kernel_name] != calls:
        fail(f"{path}: the prefill must launch {kernel_name} once per attention or WKV layer ({calls}) "
             f"and nothing else: {launches}, by phase {by_phase}")
    if any(by_phase["decode"].values()):
        fail(f"{path}: the decode launched a kernel: {by_phase['decode']}")
    tokens = res.pop("tokens")
    shape = (SERVE_SHAPE["requests"], SERVE_SHAPE["steps"])
    if tokens.shape != shape or tokens.min() < 0 or tokens.max() >= cfg.vocab:
        fail(f"{path}: tokens of shape {tokens.shape} in [{tokens.min()}, {tokens.max()}]")
    readings = {which: captured_reading(kernel_name, *serve_inputs[which]) for which in ("first", "last")}
    if frontend is not None:
        frontend["captured"] = {which: captured_reading(kernel_name, *frontend_inputs[which])
                                for which in ("first", "last")}
    del captured, serve_inputs, frontend_inputs
    bound = res["params"] * 4 / HBM_BYTES_PER_S * 1e3  # f32 weights read once
    out = {"phase": "main", "path": path, "reduced": reduced, "attention_layers": one_card.attention_layers(cfg),
           "seconds": main_s, "launches": launches, "launches_by_phase": by_phase, **res,
           "max_memory_allocated": res["peak_memory_bytes"],
           "decode_bound_ms": bound, "decode_over_bound": res["decode_ms_per_step"] / bound,
           "prefill_logits_shape": prefill_logits, "logits_finite": finite,
           "first_tokens": tokens[:, :8].tolist(), "tokens": tokens.tolist(), "captured": readings,
           "frontend": frontend}
    emit(out)
    if not all(finite.values()):
        fail(f"{path}: logits are not finite: {finite}")
    bad = {w: r for w, r in readings.items() if not r["max_ratio"] <= 1.0}
    if bad:
        fail(f"{path}: {kernel_name} disagrees with its plain version on the model's inputs: {bad}")
    if frontend is not None:
        want = {name: cfg.n_layers if name == "flash_attention" else 0 for name in KERNELS}
        if frontend["launches"] != want or not frontend["logits_finite"]:
            fail(f"{path}: the frontend forward must launch flash_attention once per layer "
                 f"({cfg.n_layers}) and give finite logits: {frontend}")
        bad = {w: r for w, r in frontend["captured"].items() if not r["max_ratio"] <= 1.0}
        if bad:
            fail(f"{path}: flash_attention disagrees with its plain version in the frontend forward: {bad}")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train_olmo() -> dict:
    """``train_olmo``: ``Trainer.fit`` on OLMo-1B at full width, as the
    module docstring says.  The model's attention calls are wrapped to keep
    the first layer's (q, k, v) of the first step and, by a hook on its
    output, its dO; the train step to count each step's launches; the
    checkpointer and ``restore`` to time them."""
    cfg = get_arch(TRAIN_ARCH)
    shape, reduced = one_card.one_card_train_shape(SHAPES[TRAIN_SHAPE])
    ckpt_dir = tempfile.mkdtemp(prefix="train_olmo_", dir=ROOT / "build")
    free_bytes = shutil.disk_usage(ckpt_dir).free
    captured, per_step, faults = {}, [], []
    timings = {"snapshot_s": [], "wait_s": [], "restore_s": []}
    original_attention, original_restore = model_layers.flash_attention, train_trainer.restore

    def capture(q, k, v, causal=True, **kw):
        out = original_attention(q, k, v, causal=causal, **kw)
        if "q" not in captured and out.requires_grad:
            captured.update(q=q.detach(), k=k.detach(), v=v.detach())
            out.register_hook(lambda g: captured.setdefault("dout", g.detach().contiguous()))
        return out

    def timed_restore(*args, **kw):
        t0 = time.perf_counter()
        out = original_restore(*args, **kw)
        torch.cuda.synchronize()
        timings["restore_s"].append(time.perf_counter() - t0)
        return out

    def fault_hook(step):
        if step == TRAIN_FAULT_STEP and not faults:
            faults.append(step)
            raise RuntimeError(f"injected fault at step {step}")

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model_layers.flash_attention = capture
    train_trainer.restore = timed_restore
    try:
        t0 = time.perf_counter()
        model = model_registry.build_model(cfg, device="cuda", seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        trainer = Trainer(model, make_optimizer("adamw"),
                          TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=TRAIN_CKPT_EVERY, keep=1), fault_hook)
        step_fn, save, wait = trainer.step_fn, trainer.ckpt.save, trainer.ckpt.wait

        def counted_step(opt_state, batch):
            before = read_counts()
            out = step_fn(opt_state, batch)
            after = read_counts()
            per_step.append({n: after[n] - before[n] for n in after})
            return out

        def timed_wait():
            t0 = time.perf_counter()
            wait()
            timings["wait_s"].append(time.perf_counter() - t0)

        def timed_save(step, state, blocking=False):
            timed_wait()
            t0 = time.perf_counter()
            save(step, state, blocking)
            timings["snapshot_s"].append(time.perf_counter() - t0)

        trainer.step_fn, trainer.ckpt.save, trainer.ckpt.wait = counted_step, timed_save, timed_wait
        dataset = SyntheticTokenDataset(cfg.vocab, shape.seq_len, shape.global_batch, seed=0)
        zero_counts()
        t0 = time.perf_counter()
        trainer.fit(dataset, n_steps=TRAIN_STEPS)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        log, restarts = trainer.log, trainer.restarts
        n_params = sum(p.numel() for p in model.parameters())
        del trainer, model
    finally:
        model_layers.flash_attention = original_attention
        train_trainer.restore = original_restore
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    steps = [e for e in log if e["event"] == "step"]
    reruns = [e["loss"] for e in steps if e["step"] == TRAIN_RERUN_STEP]
    warm_s = statistics.median(e["dt"] for e in steps[1:])
    layers = cfg.n_layers
    res = {"phase": "main", "path": "train_olmo", "arch": cfg.name, "reduced": reduced,
           "n_layers": layers, "d_model": cfg.d_model, "params": n_params, "seq_len": shape.seq_len,
           "global_batch": shape.global_batch, "remat": cfg.remat, "optimizer": "adamw",
           "init_s": init_s, "fit_s": fit_s, "seconds": fit_s, "launches": launches,
           "launches_per_step": per_step, "steps": [{k: e[k] for k in ("step", "loss", "grad_norm", "dt")} for e in steps],
           "restarts": restarts, "events": [e for e in log if e["event"] != "step"],
           "rerun_losses": reruns,
           "step_ms_warm_median": warm_s * 1e3,
           "tokens_per_s": shape.global_batch * shape.seq_len / warm_s,
           "max_memory_allocated": peak, "disk_free_bytes": free_bytes, **timings}
    bad = []
    if not all(math.isfinite(e["loss"]) and math.isfinite(e["grad_norm"]) for e in steps):
        bad.append("a loss or a gradient norm is not finite")
    if restarts != 1 or [e["step"] for e in log if e["event"] == "restart"] != [TRAIN_RERUN_STEP]:
        bad.append(f"the fault at step {TRAIN_FAULT_STEP} was not restored from step {TRAIN_RERUN_STEP}")
    if len(reruns) != 2 or not abs(reruns[1] - reruns[0]) <= TRAIN_RERUN_RTOL * abs(reruns[0]):
        bad.append(f"step {TRAIN_RERUN_STEP} did not re-run to its loss: {reruns}")
    if len(steps) != TRAIN_STEPS + 1 or [e["step"] for e in steps][-1] != TRAIN_STEPS - 1:
        bad.append(f"the steps run: {[e['step'] for e in steps]}")
    want = {n: {"flash_attention": 2 * layers, "flash_attention_bwd": layers}.get(n, 0) for n in KERNELS}
    if any(c != want for c in per_step) or len(per_step) != len(steps):
        bad.append(f"each step must launch {want}: {per_step}")
    if "dout" not in captured:
        bad.append("no layer's dO was captured")
    else:
        q, k, v, dout = (captured[n] for n in ("q", "k", "v", "dout"))
        b, hq, seq, d = q.shape
        tile = attention.select_blocks(b, hq, k.shape[1], seq, d)
        reading = grad_reading(attention_grads(q, k, v, dout, True, tile), attention_grads(q, k, v, dout),
                               ATTN_GRAD_RULE)
        fwd_leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            fwd_ms = time_ms(lambda: attn_kernel.FlashAttentionFn.apply(*fwd_leaves, True, *tile))
        res["captured"] = {"shape": [b, hq, k.shape[1], seq, d], "tile": tile, **reading,
                           "forward_ms": fwd_ms, **time_attention_bwd(q, k, v, dout)}
        res["captured"]["forward_bound_ms"] = attention_bound(q, k, v, q)[0]
        if not reading["max_ratio"] <= 1.0:
            bad.append(f"the backward kernel disagrees with the plain version on the model's inputs: {reading}")
    del captured
    gc.collect()
    torch.cuda.empty_cache()
    emit(res)
    if bad:
        fail(f"train_olmo: {'; '.join(bad)}")
    return res


def wkv_bwd_flops(bh: int, seq: int, kd: int, chunk: int) -> float:
    """The arithmetic of the chunked gradient, in flops (an FMA two), as
    the backward's first, scalar kernel did it, and counted the same since
    so that ``bound_ms`` and the share stay comparable across its designs:
    per chunk and block of 16 state rows, delta for s <= t over K (each of
    the K / 16 blocks of a row computes it), sum_j G S', r' and k' from S dO
    and G v, the decayed sums within the chunk for dr~ and dk~, A over the
    block's 16 channels, dv's share and G's update; then the sum of the
    K / 16 shares.  It counts the gradient's operations, not the
    instructions of the kernel now (which splits each tensor-core product
    into three)."""
    L, R = chunk, wkv_kernel.BWD_ROWS
    per_block = (L * (L + 1) / 2 * kd + R * kd + 2 * L * R * kd + L * (L - 1) * R + L * (L + 1) / 2 * R
                 + L * kd * ((L + 1) / 2 + R) + R * kd * L)
    return 2.0 * per_block * (kd // R) * (seq // chunk) * bh + bh * seq * kd * (kd // R - 1)


def wkv_bwd_bound(r: torch.Tensor, chunk: int) -> dict:
    """``bound_ms`` of the WKV backward: r, k, v, wlog and dO read and dr,
    dk, dv and dwlog written once (36 B a (token, channel); u, du and the
    states' gradients are K^2 a row), over the kernel's own arithmetic at
    67 TFLOP/s; and beside it the same with the forward's chunk-start
    states read once (``with_states``)."""
    bh, seq, kd = r.shape
    n_bytes = 36.0 * bh * seq * kd
    flops = wkv_bwd_flops(bh, seq, kd, chunk)
    b_ms, b_by = bound_ms(n_bytes, flops, torch.float32)
    s_ms, s_by = bound_ms(n_bytes + 4.0 * bh * (seq // chunk) * kd * kd, flops, torch.float32)
    return {"bound_ms": b_ms, "bound_by": b_by, "bound_bytes": n_bytes, "bound_flops": flops,
            "bound_with_states_ms": s_ms, "bound_with_states_by": s_by}


def captured_wkv_grads(captured: dict) -> dict:
    """The backward kernel on the inputs the model fed the WKV in its first
    layer (r, k, v, wlog, u, s0) with that layer's dO: on the first
    ``RWKV_CHECK_ROWS`` rows (batch 0, every head) against autograd through
    the stepwise plain version and both against its f64 run, by
    ``WKV_GRAD_RULE``, with ``wkv_bwd_plain`` in f32 at the kernel's chunk
    read against the same f64 run (``chunked_plain_f32_vs_f64``: the
    chunked order's own error), and the kernel from the f64 recurrence's
    chunk-start states rounded to f32 (``kernel_f64_states_vs_f64``: what
    the forward kernel's states add), with those states' largest error in
    units of their rms; on every row against ``wkv_bwd_plain`` (chunked,
    the kernel's own plain version) and against a second launch bit for bit
    (dv's shares are summed in a fixed order); then the times at the
    captured shape: the backward kernel, the forward with and without its
    chunk-start states, and ``wkv_bwd_plain``, beside the backward's
    bound."""
    r, k, v, wlog, u, s0, dout = (captured[n] for n in ("r", "k", "v", "wlog", "u", "s0", "dout"))
    bh, seq, kd = r.shape
    chunk = wkv.select_chunk(bh, seq, kd)
    names = ("dr", "dk", "dv", "dwlog", "du", "ds0")
    rows = [t[:RWKV_CHECK_ROWS] for t in (r, k, v, wlog)] + [u, s0[:RWKV_CHECK_ROWS], dout[:RWKV_CHECK_ROWS]]
    got = wkv_grads(*rows, chunk=chunk)
    want = wkv_grads(*rows)
    f64 = wkv_grads(*(t.double() for t in rows))
    res = {"shape": [bh, seq, kd], "u": list(u.shape), "chunk": chunk, "rows_checked": RWKV_CHECK_ROWS,
           **grad_reading(got, want, WKV_GRAD_RULE),
           "by_gradient": {n: scaled_ratio(a, b, WKV_GRAD_RULE) for n, a, b in zip(names, got, want)},
           "kernel_vs_f64": grad_reading(got, f64, WKV_GRAD_RULE)["max_ratio"],
           "plain_f32_vs_f64": grad_reading(want, f64, WKV_GRAD_RULE)["max_ratio"],
           "rms": {n: float(b.double().pow(2).mean().sqrt())
                   for n, b in zip(names, want)}}
    # wkv_bwd_plain, the kernel's chunked order in PyTorch, in f32 at the kernel's chunk
    chunked = wkv.wkv_bwd_plain(*rows[:5], rows[6], None, rows[5], chunk)
    res["chunked_plain_f32_vs_f64"] = grad_reading(chunked, f64, WKV_GRAD_RULE)["max_ratio"]
    res["chunked_plain_f32_vs_f64_by_gradient"] = {
        n: scaled_ratio(a, b, WKV_GRAD_RULE) for n, a, b in zip(names, chunked, f64)}
    res["kernel_vs_f64_by_gradient"] = {n: scaled_ratio(a, b, WKV_GRAD_RULE) for n, a, b in zip(names, got, f64)}
    # the kernel from the f64 recurrence's chunk-start states, rounded to f32
    rr, rk, rv, rw, _, rs0, rdo = rows
    leaves = [t.detach().requires_grad_() for t in (rr, rk, rv, rw, u)]
    with torch.enable_grad():
        out, _ = wkv_kernel.wkv_cuda(*leaves, chunk=chunk, s0=rs0)
    states = out.grad_fn.saved_tensors[-1].detach()
    del out, leaves
    states64 = wkv_f64_chunk_states(rr, rk, rv, rw, u, rs0, chunk)
    res["forward_states_err_over_rms"] = float((states - states64).abs().max() / states64.pow(2).mean().sqrt())
    from64 = wkv_kernel.wkv_bwd_cuda(rr, rk, rv, rw, u, rdo, None, rs0, chunk, states64)
    res["kernel_f64_states_vs_f64"] = grad_reading(from64, f64, WKV_GRAD_RULE)["max_ratio"]
    res["kernel_f64_states_vs_f64_by_gradient"] = {
        n: scaled_ratio(a, b, WKV_GRAD_RULE) for n, a, b in zip(names, from64, f64)}
    del got, want, f64, rows, chunked, states, states64, from64
    leaves = [t.detach().requires_grad_() for t in (r, k, v, wlog, u)]
    with torch.enable_grad():
        out, _ = wkv_kernel.wkv_cuda(*leaves, chunk=chunk, s0=s0)
    sr, sk, sv, sw, su, _, states = (t.detach() for t in out.grad_fn.saved_tensors)
    del out, leaves
    full = wkv_kernel.wkv_bwd_cuda(sr, sk, sv, sw, su, dout, None, None, chunk, states)
    again = wkv_kernel.wkv_bwd_cuda(sr, sk, sv, sw, su, dout, None, None, chunk, states)
    res["repeats_bitwise"] = all(torch.equal(a, b) for a, b in zip(full, again))
    plain = wkv.wkv_bwd_plain(r, k, v, wlog, u, dout, None, s0, chunk)
    res["all_rows_vs_wkv_bwd_plain"] = grad_reading(full, plain, WKV_GRAD_RULE)["max_ratio"]
    del full, again, plain
    res["ms"] = time_ms(lambda: wkv_kernel.wkv_bwd_cuda(sr, sk, sv, sw, su, dout, None, None, chunk, states))
    res["plain_ms"] = time_ms(lambda: wkv.wkv_bwd_plain(r, k, v, wlog, u, dout, None, s0, chunk), reps=2, warmup=1)
    res["library_ms"] = None  # no PyTorch call computes the WKV's gradient
    res["forward_ms"] = time_ms(lambda: wkv_kernel.wkv_cuda(r, k, v, wlog, u, chunk=chunk, s0=s0))
    fwd_leaves = [t.detach().requires_grad_() for t in (r, k, v, wlog, u)]
    with torch.enable_grad():
        res["forward_with_states_ms"] = time_ms(lambda: wkv_kernel.WKVFn.apply(*fwd_leaves, s0, chunk))
    res.update(wkv_bwd_bound(r, chunk))
    res["forward_bound_ms"] = wkv_bound(r, u, with_s0=True)[0]
    return res


def phase_train_rwkv() -> dict:
    """``train_rwkv``: ``Trainer.fit`` on RWKV6-1.6B at full width, as the
    module docstring says.  The model's WKV calls are wrapped to keep the
    first layer's inputs of the first step and, by a hook on its output,
    its dO; the train step to count each step's launches; the
    checkpointer's ``save`` is replaced by a no-op that records the step
    (the end of ``fit`` saves one)."""
    cfg = get_arch(RWKV_TRAIN_ARCH)
    shape, reduced = one_card.one_card_train_shape(SHAPES[TRAIN_SHAPE])
    ckpt_dir = tempfile.mkdtemp(prefix="train_rwkv_", dir=ROOT / "build")  # read by fit's resume: empty
    captured, per_step, skipped = {}, [], []
    original_wkv = model_rwkv6.wkv

    def capture(r, k, v, wlog, u, chunk=None, s0=None):
        out, s = original_wkv(r, k, v, wlog, u, chunk=chunk, s0=s0)
        if "r" not in captured and out.requires_grad:
            captured.update(r=r.detach(), k=k.detach(), v=v.detach(), wlog=wlog.detach(), u=u.detach(),
                            s0=s0.detach())
            out.register_hook(lambda g: captured.setdefault("dout", g.detach().contiguous()))
        return out, s

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model_rwkv6.wkv = capture
    try:
        t0 = time.perf_counter()
        model = model_registry.build_model(cfg, device="cuda", seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        trainer = Trainer(model, make_optimizer("adamw"), TrainerConfig(ckpt_dir=ckpt_dir))
        step_fn = trainer.step_fn

        def counted_step(opt_state, batch):
            before = read_counts()
            out = step_fn(opt_state, batch)
            after = read_counts()
            per_step.append({n: after[n] - before[n] for n in after})
            return out

        trainer.step_fn = counted_step
        trainer.ckpt.save = lambda step, state, blocking=False: skipped.append(step)
        dataset = SyntheticTokenDataset(cfg.vocab, shape.seq_len, shape.global_batch, seed=0)
        zero_counts()
        t0 = time.perf_counter()
        trainer.fit(dataset, n_steps=RWKV_TRAIN_STEPS)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        log, restarts = trainer.log, trainer.restarts
        n_params = sum(p.numel() for p in model.parameters())
        del trainer, model
    finally:
        model_rwkv6.wkv = original_wkv
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    steps = [e for e in log if e["event"] == "step"]
    warm_s = statistics.median(e["dt"] for e in steps[1:])
    layers = cfg.n_layers
    res = {"phase": "main", "path": "train_rwkv", "arch": cfg.name, "reduced": reduced,
           "n_layers": layers, "d_model": cfg.d_model, "wkv_heads": cfg.d_model // cfg.rwkv_head_dim,
           "params": n_params, "seq_len": shape.seq_len, "global_batch": shape.global_batch,
           "remat": cfg.remat, "optimizer": "adamw", "init_s": init_s, "fit_s": fit_s, "seconds": fit_s,
           "launches": launches, "launches_per_step": per_step,
           "steps": [{k: e[k] for k in ("step", "loss", "grad_norm", "dt")} for e in steps],
           "restarts": restarts, "events": [e for e in log if e["event"] != "step"],
           "checkpoints_skipped": skipped, "step_ms_warm_median": warm_s * 1e3,
           "tokens_per_s": shape.global_batch * shape.seq_len / warm_s, "max_memory_allocated": peak}
    bad = []
    if not all(math.isfinite(e["loss"]) and math.isfinite(e["grad_norm"]) for e in steps):
        bad.append("a loss or a gradient norm is not finite")
    if restarts or [e["step"] for e in steps] != list(range(RWKV_TRAIN_STEPS)):
        bad.append(f"the steps run: {[e['step'] for e in steps]}, restarts {restarts}")
    want = {n: {"wkv": 2 * layers, "wkv_bwd": layers}.get(n, 0) for n in KERNELS}
    if any(c != want for c in per_step) or len(per_step) != len(steps):
        bad.append(f"each step must launch {want}: {per_step}")
    if "dout" not in captured:
        bad.append("no layer's dO was captured")
    else:
        res["captured"] = captured_wkv_grads(captured)
        if not res["captured"]["max_ratio"] <= 1.0:
            bad.append(f"the WKV backward kernel disagrees with the plain version on the model's inputs: "
                       f"{res['captured']}")
        if not res["captured"]["repeats_bitwise"]:
            bad.append("two launches of the WKV backward kernel on the same inputs differ")
    del captured
    gc.collect()
    torch.cuda.empty_cache()
    emit(res)
    if bad:
        fail(f"train_rwkv: {'; '.join(bad)}")
    return res


def sharded_train(mesh, train_olmo: dict) -> dict:
    """``train_sharded``: ``train_olmo``'s model, cut and data through
    ``Trainer.fit`` on ``mesh``, ``SHARDED_TRAIN_STEPS`` steps from seed 0,
    no checkpoints; each step's launches counted as ``train_olmo`` counts
    them."""
    cfg = get_arch(TRAIN_ARCH)
    shape, reduced = one_card.one_card_train_shape(SHAPES[TRAIN_SHAPE])
    ckpt_dir = tempfile.mkdtemp(prefix="train_sharded_", dir=ROOT / "build")  # read by fit's resume: empty
    per_step, skipped = [], []
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        model = model_registry.build_model(cfg, device="cuda", seed=0)
        t0 = time.perf_counter()
        trainer = Trainer(model, make_optimizer("adamw"), TrainerConfig(ckpt_dir=ckpt_dir), mesh=mesh, shape=shape)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        step_fn = trainer.step_fn

        def counted_step(opt_state, batch):
            before = read_counts()
            out = step_fn(opt_state, batch)
            after = read_counts()
            per_step.append({n: after[n] - before[n] for n in after})
            return out

        trainer.step_fn = counted_step
        trainer.ckpt.save = lambda step, state, blocking=False: skipped.append(step)
        dataset = SyntheticTokenDataset(cfg.vocab, shape.seq_len, shape.global_batch, seed=0)
        zero_counts()
        t0 = time.perf_counter()
        trainer.fit(dataset, n_steps=SHARDED_TRAIN_STEPS)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        log, restarts = trainer.log, trainer.restarts
        placements = sorted({str(tuple(p.placements)) for p in model.parameters()})
        dtensors = all(hasattr(p, "placements") for p in model.parameters())
        del trainer, model
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    steps = [e for e in log if e["event"] == "step"]
    losses = [e["loss"] for e in steps]
    olmo = [e["loss"] for e in train_olmo["steps"][:SHARDED_TRAIN_STEPS]]
    warm_s = statistics.median(e["dt"] for e in steps[1:])
    layers = cfg.n_layers
    res = {"phase": "sharded", "path": "train_sharded", "arch": cfg.name, "reduced": reduced,
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "backend": "nccl",
           "params_are_dtensors": dtensors, "placements": placements, "place_s": place_s, "fit_s": fit_s,
           "seq_len": shape.seq_len, "global_batch": shape.global_batch, "launches": launches,
           "launches_per_step": per_step,
           "steps": [{k: e[k] for k in ("step", "loss", "grad_norm", "dt")} for e in steps],
           "train_olmo_losses": olmo,
           "loss_rel_diff": [abs(a - b) / abs(b) for a, b in zip(losses, olmo)],
           "losses_bit_equal": losses == olmo,
           "step_ms_warm_median": warm_s * 1e3,
           "train_olmo_step_ms_warm_median": train_olmo["step_ms_warm_median"],
           "step_over_train_olmo": warm_s * 1e3 / train_olmo["step_ms_warm_median"],
           "tokens_per_s": shape.global_batch * shape.seq_len / warm_s,
           "train_olmo_tokens_per_s": train_olmo["tokens_per_s"],
           "max_memory_allocated": peak, "train_olmo_max_memory_allocated": train_olmo["max_memory_allocated"]}
    emit(res)
    bad = []
    if not dtensors:
        bad.append("the parameters are not DTensors on the mesh")
    if not all(math.isfinite(e["loss"]) and math.isfinite(e["grad_norm"]) for e in steps):
        bad.append("a loss or a gradient norm is not finite")
    if restarts or [e["step"] for e in steps] != list(range(SHARDED_TRAIN_STEPS)):
        bad.append(f"the steps run: {[e['step'] for e in steps]}, restarts {restarts}")
    if len(olmo) != SHARDED_TRAIN_STEPS or not all(d <= SHARDED_LOSS_RTOL for d in res["loss_rel_diff"]):
        bad.append(f"the losses {losses} are not within {SHARDED_LOSS_RTOL} relative of train_olmo's {olmo}")
    want = {n: {"flash_attention": 2 * layers, "flash_attention_bwd": layers}.get(n, 0) for n in KERNELS}
    if any(c != want for c in per_step) or len(per_step) != len(steps):
        bad.append(f"each step must launch {want}: {per_step}")
    if bad:
        fail(f"train_sharded: {'; '.join(bad)}")
    return res


def timed_ms(fn):
    """(fn(), its milliseconds between two CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def sharded_serve(mesh, serve_rwkv: dict) -> dict:
    """``serve_sharded``: ``serve_rwkv``'s model (seed 0) and prompts
    (numpy, seed 0) through ``make_prefill_step`` and ``make_decode_step``
    on ``mesh``: the prefill bundle's logits, the prompt through the decode
    bundle on a zeroed cache (``ServeEngine.prefill``'s way, which fills the
    cache) and greedy decode steps after it."""
    arch, kernel_name = SERVE["serve_rwkv"]
    cfg, reduced = one_card.one_card_config(arch)
    n_req, n_prompt, n_new = SERVE_SHAPE["requests"], SERVE_SHAPE["prompt_len"], SERVE_SHAPE["steps"]
    max_len = n_prompt + n_new + 8  # as launch.serve's engine
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = model_registry.build_model(cfg, device="cuda", seed=0, init_depth=get_arch(arch).n_layers)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, size=(n_req, n_prompt))
                               .astype(np.int32)).to(model.device, torch.long)
    shape = ShapeConfig("serve", seq_len=max_len, global_batch=n_req, kind="decode")
    t0 = time.perf_counter()
    prefill, decode = make_prefill_step(model, mesh, shape), make_decode_step(model, mesh, shape)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    launches = {}
    zero_counts()
    logits, prefill_ms = timed_ms(lambda: prefill({"tokens": prompts}))
    launches["prefill"] = read_counts()
    prefill_tok = logits.full_tensor()[:, -1:].argmax(dim=-1)
    finite = {"prefill": bool(torch.isfinite(logits.full_tensor()).all())}
    del logits
    _, prefill_first_ms = timed_ms(lambda: prefill({"tokens": prompts}))  # DTensor's sharding rules cached
    _, fill_first_ms = timed_ms(lambda: decode(model.init_cache(n_req, max_len), prompts))
    zero_counts()
    cache = model.init_cache(n_req, max_len)
    (logits, cache), fill_ms = timed_ms(lambda: decode(cache, prompts))
    launches["cache_fill"] = read_counts()
    tok = logits.full_tensor()[:, -1:].argmax(dim=-1)
    out = [tok]

    def steps():
        nonlocal tok, cache, logits
        for _ in range(n_new - 1):
            logits, cache = decode(cache, tok)
            tok = logits.full_tensor()[:, -1:].argmax(dim=-1)
            out.append(tok)

    zero_counts()
    _, decode_ms = timed_ms(steps)
    launches["decode"] = read_counts()
    finite["last_step"] = bool(torch.isfinite(logits.full_tensor()).all())
    tokens = torch.cat(out, dim=1).cpu().tolist()
    peak = torch.cuda.max_memory_allocated()
    cache_layout = {f: str(tuple(getattr(cache, f).placements)) for f in ("shift_tm", "shift_cm", "s")}
    del model, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    res = {"phase": "sharded", "path": "serve_sharded", "arch": cfg.name, "reduced": reduced,
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "requests": n_req, "prompt_len": n_prompt,
           "steps": n_new, "place_s": place_s, "launches": launches, "cache_placements": cache_layout,
           "prefill_ms": prefill_ms, "prefill_ms_warm": prefill_first_ms, "cache_fill_ms": fill_ms,
           "cache_fill_ms_first": fill_first_ms, "serve_rwkv_prefill_ms": serve_rwkv["prefill_ms"],
           "decode_ms_per_step": decode_ms / max(n_new - 1, 1),
           "serve_rwkv_decode_ms_per_step": serve_rwkv["decode_ms_per_step"],
           "decode_over_serve_rwkv": decode_ms / max(n_new - 1, 1) / serve_rwkv["decode_ms_per_step"],
           "max_memory_allocated": peak, "serve_rwkv_max_memory_allocated": serve_rwkv["max_memory_allocated"],
           "logits_finite": finite, "tokens": tokens, "tokens_equal_serve_rwkv": tokens == serve_rwkv["tokens"],
           "prefill_bundle_first_token_equal": prefill_tok.cpu().tolist() == [t[:1] for t in tokens]}
    emit(res)
    bad = []
    layers = {n: cfg.n_layers if n == kernel_name else 0 for n in KERNELS}
    for part in ("prefill", "cache_fill"):
        if launches[part] != layers:
            bad.append(f"the {part} must launch {kernel_name} once per layer ({cfg.n_layers}): {launches[part]}")
    if any(launches["decode"].values()):
        bad.append(f"the decode launched a kernel: {launches['decode']}")
    if not all(finite.values()):
        bad.append(f"logits are not finite: {finite}")
    if not res["tokens_equal_serve_rwkv"]:
        bad.append(f"the greedy tokens differ from serve_rwkv's: {tokens} against {serve_rwkv['tokens']}")
    if bad:
        fail(f"serve_sharded: {'; '.join(bad)}")
    return res


def phase_sharded(train_olmo: dict, serve_rwkv: dict) -> dict:
    """``sharded``: a one-rank NCCL process group (a ``HashStore``, no
    network), a (1, 1) ``DeviceMesh`` on the card, and the two paths above
    through the placements; the group is destroyed at the end."""
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_test_mesh(1, 1)
        return {"train_sharded": sharded_train(mesh, train_olmo), "serve_sharded": sharded_serve(mesh, serve_rwkv)}
    finally:
        dist.destroy_process_group()


def phase_step_time(served: dict, trains: dict) -> list[dict]:
    """``step_time``: the whole-model estimator's prediction of every
    full-width path's step beside the step the phases above measured, as
    the module docstring says."""
    runs = [(path, *one_card.one_card_config(SERVE[path][0]), SERVE_SHAPE["requests"],
             SERVE_SHAPE["prompt_len"], "forward", res["prefill_ms"],
             "prefill, cold: the serve phase's first (CUDA events)")
            for path, res in served.items()]
    runs += [(path, get_arch(one_card.TRAIN_PATHS[path]), train["reduced"], train["global_batch"],
              train["seq_len"], "train", train["step_ms_warm_median"],
              "warm median step (host clock after synchronize)") for path, train in trains.items()]
    rows, bad = [], []
    for path, cfg, reduced, batch, seq, kind, measured_ms, how in runs:
        t0 = time.perf_counter()
        try:
            rep = step_time(cfg, STEP_TIME_MACHINE, batch=batch, seq=seq, kind=kind)
        except Exception as e:  # noqa: BLE001 - any failure of the estimator fails the phase
            fail(f"step_time: {path}: step_time raised {e!r}")
        host_s = time.perf_counter() - t0
        predicted, fold = rep.step_time_s, graph_classes.schedule_sum(rep)
        row = {"phase": "step_time", "path": path, "arch": cfg.name, "reduced": reduced, "batch": batch,
               "seq": seq, "kind": kind, "machine": rep.machine.name, "predicted_s": predicted,
               "measured_s": measured_ms / 1e3, "measured": how,
               "predicted_over_measured": predicted / (measured_ms / 1e3), "step_time_host_s": host_s,
               "n_nodes": len(rep.dag), "n_unique_kernels": len(rep.unique),
               "limiters": rep.limiter_attribution(),
               "predicted_by_class_s": graph_classes.predicted_by_class(rep),
               "n_devices": rep.dag.mesh.n_devices, "schedule_sum_s": fold}
        emit(row)
        rows.append(row)
        if not (math.isfinite(predicted) and predicted > 0):
            bad.append(f"{path}: the prediction {predicted} is not finite and positive")
        if rep.dag.mesh.n_devices == 1 and predicted != fold:
            bad.append(f"{path}: the single-device makespan {predicted!r} is not the durations' sum {fold!r}")
    if bad:
        fail(f"step_time: {'; '.join(bad)}")
    return rows


def dryrun_cells() -> list[dict]:
    """``DRYRUN_CELLS`` through ``python -m repro_torch.launch.dryrun``, one
    process each, all started together and all ended by the time limit;
    returns the cells' JSONs."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
           "CUDA_VISIBLE_DEVICES": ""}  # a fake group and fake tensors: no card
    procs = []
    try:
        for arch, shape, mesh in DRYRUN_CELLS:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
                   "--mesh", mesh, "--out", str(DRYRUN_OUT)]
            procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True))
        deadline = time.monotonic() + DRYRUN_TIMEOUT_S
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
    except subprocess.TimeoutExpired:
        fail(f"dryrun: the cells did not end within {DRYRUN_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    cells = []
    for (arch, shape, mesh), p, (out, err) in zip(DRYRUN_CELLS, procs, logs):
        path = Path(dryrun.cell_path(str(DRYRUN_OUT), mesh, arch, shape, "baseline"))
        if p.returncode or not path.exists():
            fail(f"dryrun: {arch}/{shape}/{mesh} exited {p.returncode}: {(out + err)[-2000:]}")
        cells.append(json.loads(path.read_text()))
    return cells


def phase_dryrun(served: dict, trains: dict) -> dict:
    """``dryrun``: four full-width cells of the dry run on fake 256- and
    512-rank groups, then two one-card cells priced on the port-side H100
    machine beside this run's measured step and prefill, as the module
    docstring says."""
    t0 = time.perf_counter()
    cells = dryrun_cells()
    wall = time.perf_counter() - t0
    bad = []
    for c in cells:
        cell = f"{c['arch']}/{c['shape']}/{c['mesh']}"
        if c["status"] != "ok":
            bad.append(f"{cell}: {c['status']} {c.get('error', c.get('skip_reason', ''))}")
            continue
        emit({"phase": "dryrun", "cell": cell, "status": c["status"], "seconds_lower": c["seconds_lower"],
              "traced_ops": c["traced_ops"],
              "argument_bytes_per_device": c["memory_analysis"]["argument_size_in_bytes"],
              "output_bytes_per_device": c["memory_analysis"]["output_size_in_bytes"],
              "flops_per_device": c["cost_analysis_raw"]["flops"],
              "bytes_accessed_per_device": c["cost_analysis_raw"]["bytes accessed"],
              "collectives": c["collectives"]["counts"],
              "wire_bytes_per_device": c["collectives"]["total_wire_bytes_per_device"],
              **{key: {k: c[key][k] for k in ("t_compute_s", "t_memory_s", "t_collective_s", "dominant",
                                              "roofline_fraction", "useful_flops_ratio")}
                 for key in ("roofline", "roofline_h100")}})
    if bad:
        fail(f"dryrun: {'; '.join(bad)}")
    train_shape, _ = one_card.one_card_train_shape(SHAPES[one_card.TRAIN_SHAPE])
    serve_shape = ShapeConfig("serve_prefill", one_card.SERVE_PROMPT_LEN, one_card.SERVE_REQUESTS, "prefill")
    one = [("train_olmo", get_arch(one_card.TRAIN_PATHS["train_olmo"]), train_shape,
            trains["train_olmo"]["step_ms_warm_median"], "warm median step (host clock after synchronize)"),
           ("serve_qwen", one_card.one_card_config(SERVE["serve_qwen"][0])[0], serve_shape,
            served["serve_qwen"]["prefill_ms"], "prefill, cold: the serve phase's first (CUDA events)")]
    rows = []
    for path, cfg, shape, measured_ms, how in one:
        t1 = time.perf_counter()
        priced = dryrun.price_one_card(cfg, shape)
        r = priced["roofline"]
        predicted = max(r["t_compute_s"], r["t_memory_s"], r["t_collective_s"])
        row = {"phase": "dryrun", "one_card": path, "arch": cfg.name, "batch": shape.global_batch,
               "seq": shape.seq_len, "kind": shape.kind, "machine": "H100_ROOFLINE (port-side)",
               "seconds_lower": priced["seconds_lower"], "host_s": time.perf_counter() - t1,
               "flops": priced["cost_analysis_raw"]["flops"],
               "bytes_accessed": priced["cost_analysis_raw"]["bytes accessed"],
               "argument_bytes": priced["memory_analysis"]["argument_size_in_bytes"],
               **{k: r[k] for k in ("t_compute_s", "t_memory_s", "dominant", "model_flops", "useful_flops_ratio")},
               "predicted_s": predicted, "measured_s": measured_ms / 1e3, "measured": how,
               "predicted_over_measured": predicted / (measured_ms / 1e3)}
        emit(row)
        rows.append(row)
        if not (math.isfinite(predicted) and predicted > 0):
            fail(f"dryrun: {path}: the one-card prediction {predicted} is not finite and positive")
    return {"cells": cells, "one_card": rows, "wall_s": wall}


def phase_simulate() -> dict:
    """``simulate``: the LRU simulator's volumes of the LBM and stencil
    configurations ``benchmarks/torch_simulate_check.py`` picks from phase
    ``rank``'s records, beside the effective bytes per LUP there."""
    res = simulate_check.run(json.loads((ROOT / "results" / "rank_check.json").read_text()))
    emit({"phase": "simulate", **res})
    rhos = [res[k] for k in ("spearman_rho_dram_vs_effective", "spearman_rho_l2l1_vs_effective")]
    if res["lbm_configs"] < 12 or not all(math.isfinite(x) for x in rhos):
        fail(f"simulate: {res['lbm_configs']} LBM configurations, rho {rhos}")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = phase_device()
    probe_libs = phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' products in full f32
    torch.backends.cudnn.allow_tf32 = False
    phase_check()
    main_results = phase_main_paper()
    phase_probe(probe_libs)
    explored = phase_explore(phase_rank())
    audited = phase_audit(explored)
    main_results += [phase_main_attention(), phase_main_wkv()]
    served = {path: phase_main_serve(path) for path in SERVE}
    train = phase_train_olmo()
    trains = {"train_olmo": train, "train_rwkv": phase_train_rwkv()}
    sharded = phase_sharded(train, served["serve_rwkv"])
    phase_step_time(served, trains)
    phase_dryrun(served, trains)
    phase_simulate()
    for r in main_results:  # launches over every main path that runs the kernel
        r["launches_by_path"] = {OWN_PATH[r["name"]]: r["launches"]}
        if explored["launches"][r["name"]]:
            r["launches_by_path"]["explore"] = explored["launches"][r["name"]]
        if audited["launches"][r["name"]]:
            r["launches_by_path"]["audit"] = audited["launches"][r["name"]]
        for path, res in served.items():
            if res["launches"][r["name"]]:
                r["launches_by_path"][path] = res["launches"][r["name"]]
            if res["frontend"] and res["frontend"]["launches"][r["name"]]:
                r["launches_by_path"][f"{path}_frontend"] = res["frontend"]["launches"][r["name"]]
        for path, res in trains.items():
            if res["launches"][r["name"]]:
                r["launches_by_path"][path] = res["launches"][r["name"]]
        sharded_launches = {"train_sharded": sharded["train_sharded"]["launches"][r["name"]],
                            "serve_sharded": sum(c[r["name"]] for c in sharded["serve_sharded"]["launches"].values())}
        r["launches_by_path"].update({p: n for p, n in sharded_launches.items() if n})
        r["launches"] = sum(r["launches_by_path"].values())
    bwd = train["captured"]
    n_bwd = {"train_olmo": train["launches"]["flash_attention_bwd"],
             "train_sharded": sharded["train_sharded"]["launches"]["flash_attention_bwd"]}
    main_results.append({"name": "flash_attention_bwd", "launches": sum(n_bwd.values()), "launches_by_path": n_bwd,
                         **{k: bwd[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                                "library_ms")}})
    wbwd, n_wbwd = trains["train_rwkv"]["captured"], trains["train_rwkv"]["launches"]["wkv_bwd"]
    main_results.append({"name": "wkv_bwd", "launches": n_wbwd, "launches_by_path": {"train_rwkv": n_wbwd},
                         **{k: wbwd[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms")}})
    kernels = [{"name": r["name"], "route": "cuda", "source": KERNELS[r["name"]][1],
                "replaces": KERNELS[r["name"]][2], "launches": r["launches"],
                "launches_by_path": r["launches_by_path"],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r.get("library_ms")}
               for r in main_results]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
