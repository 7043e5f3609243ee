#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU: SpGEMM
(plan -> execute, compact output, chains, the submit/collect pipeline on
CUDA streams, the plan cache and its disk tier, sharded plans, the
autotuner, the multi-tenant gateway, static analysis of validated
plans), serving
granite-3-2b at full width, the ``ops`` entry points of the block-sparse
SpMM and the grouped matmul, serving qwen3-moe-30b-a3b at full width
through the grouped matmul, training granite-3-2b, serving the other
eight architectures of the registry at full width, and training the other
nine (the MoE layers' backward through the grouped matmul).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure (build error, launch error, mismatch) ends
the run with a nonzero exit code and no result line:

1. the card's name and power limit (nvidia-smi);
2. build the four CUDA sources (one nvcc each, side by side, sm_90a):
   block-Gustavson SpGEMM (K1, K2: a cp.async ring, float32 or bfloat16
   blocks), flash attention (K5: float32 FMA and bfloat16 mma.sync
   kernels), block-sparse SpMM (K3: float32 FMA and bfloat16 wgmma/TMA
   kernels) and grouped matmul (K4: the same pair); print every kernel's
   registers and spills (ptxas), the dynamic shared memory of the
   tensor-core kernels and of K1's ring per tile, and the blocks one SM
   holds;
3. hold the SpGEMM kernel (K1 single, K2 batched) against its plain
   PyTorch version at the JAX package's kernel-test shapes and a 128^3
   tile, and on tiles whose runs hold 0, 1, 3 and 8 triples: float32
   within 1e-5, bfloat16 within 2e-2, small integers bitwise, K2 against a
   loop of K1 bitwise;
4. SpGEMM main path on poisson3Da at its published size: ``spgemm_plan``
   on the card, three ``execute`` calls and one ``execute_batch`` of 4
   with fresh values from a numpy seed, each checked against the numpy
   Gustavson oracle (rtol = atol = 1e-4, the JAX package's own
   plan-vs-oracle tolerance); the launch counts show K1 and K2 ran;
5. 2cubes_sphere at its published size, one ``execute``, checked the same
   way; then (5b) a plan of poisson3Da built on bfloat16 values (a
   bfloat16 sparse CSR tensor): three ``execute`` calls with float32
   values launch K1 three times, all with bfloat16 blocks, each checked
   against the oracle on the bf16-rounded values; K1 on bfloat16 blocks
   timed beside its plain version;
5c. compact output (``output="compact"``) of poisson3Da and 2cubes_sphere:
   nnz(C) equals the structural product's (the oracle on ones), the result
   equals the block plan's on the same values at every stored position
   (bitwise; the block fill is zero), ``device_indptr`` equals the host
   indptr, ``execute_batch(4)`` equals four ``execute`` calls bitwise;
   nnz, plan seconds and device-to-host bytes per ``execute`` of both
   modes;
5d. a chain: ``plan.then(B2)`` on the compact poisson3Da A·A plan, B2 a
   banded random 14,000 x 14,000 matrix (``CHAIN_B``); ``execute_chain``
   bitwise equal to the host round trip, stage 1's values a CUDA tensor,
   at most one device-to-host copy per chain execute (torch.profiler);
   then the same with small-integer values through plans built on
   bfloat16; each stage's plan seconds;
5e. the pipeline on poisson3Da with values from ``SpGEMMValueStream``: 16
   steps at depths 1, 2 and 4 bitwise equal to sequential ``execute``,
   every ``submit`` under ``torch.cuda.set_sync_debug_mode("error")``, K1
   launched on one side stream per slot; an out-of-order collect; batched
   submits of 4 against ``execute_batch``; steps per second of
   sequential ``execute`` and of each depth (medians of 7 rounds); the
   device's idle share at depth 2 under torch.profiler;
5f. the plan cache and its disk tier, poisson3Da and 2cubes_sphere: a
   second ``spgemm_plan`` on the process-level cache returns phase 4's
   plan object with no schedule built, and a ``pattern_token`` hit pays no
   pattern digest; a ``PlanCache(disk_dir=...)`` cold build (symbolic
   phase and store write) against a fresh cache's rehydrate from the
   store, seconds of each and the store's bytes; a second Python process
   (this script with ``--token-restart``) resolves poisson3Da by its token
   through the store's alias index with no schedule built and executes
   bitwise equal to this process; every rehydrated plan's ``execute``
   bitwise equal to the cold plan's, its K1 launch counted;
5g. sharded plans on the one card (``make_shard_mesh`` with every shard on
   cuda:0): poisson3Da at 1, 2, 4 and 8 shards and 2cubes_sphere at 4,
   built from the single plans' persisted artifacts (no schedule rebuilt,
   only the partition): ``execute``, ``execute_batch(4)``, compact output
   and a depth-2 pipeline of 16 steps from ``SpGEMMValueStream`` bitwise
   equal to the single plan, K1 launched once per launching shard; a
   sharded plan persisted and rehydrated, bitwise; ``shard_stats()`` and
   ``execute`` ms (host) and numeric-phase ms (device) against the single
   plan's. Several cards are not exercised here;
5h. the autotuner on poisson3Da (float32, block output, requested tile 64
   and group 4) over a disk-tier store: the default grid on the card,
   tiles {32, 64, 128} x groups {2, 4, 8}, every candidate's model ms and
   its measured ``execute_batch(8)`` ms (or "pruned"), the survivors, the
   depth probes, the ``TunedConfig``, the winner's value sets/s against
   the default's, the ranking agreement, and the K2 (batch probes) and K1
   (depth probes) launches; the tuned plan's ``execute``,
   ``execute_batch(4)`` and ``execute_stream`` bitwise equal to an
   untuned plan at the winner's (tile, group); a second process (this
   script with ``--autotune-restart``) applies the persisted config with
   no probe; then ``measure_chunk_knee`` on the card (the reference's
   cases and six up to ~250 MiB per set): the measured knee and the
   suggested ``cuda`` row beside the derived (L2) row;
5i. the gateway: tenants "p3da" (phase 4's plan) and "p3da-b2" (A·B2,
   B2 = ``CHAIN_B``), two submitter threads each of 64 requests (values
   from numpy seeds), ``max_batch=4``, ``depth=2``, ``batch_window=0.002``:
   a checked pass (every result's SHA-256 equal to a direct ``execute``'s)
   and a timed pass (requests/s, p50/p99 latency, batch fill per tenant
   from ``stats()``; K2 launched once per chunk of each dispatch, K1
   never); a hot tenant's 256 queued requests against a cold tenant's 8
   (poisson3Da at a tenth of its size) completing the cold ones in the
   first half; a byte budget below one batch: a burst queued before the
   scheduler starts admits one request and sheds seven ``shed_bytes``, a
   burst while it runs sheds what arrives behind requests in flight, all
   resolved within a bounded wait; ``register(autotune=True)`` over 5h's
   store with no probe and the tuned depth;
5j. static analysis: the K1/K2 source lint; the launch lint's Python
   mirror of K1's dynamic shared memory and threads equal to
   ``gustavson_spgemm_smem_bytes`` / ``_threads`` over every tile
   {16..128}^3 in both dtypes, each launch and each config of the
   autotuner's card grid within the device's opt-in limit; then
   ``repro_torch.analysis.check`` on the card for poisson3Da and
   2cubes_sphere at full size (tile 32, group 4): element, block, x4
   sharded and disk-rehydrated plans, each built under
   ``validate="deep"``, verified (ms per plan and per check, checks run,
   findings) and linted, then ``execute`` and ``execute_batch(2)`` of each through K1/K2
   (the element plan against the oracle, the others bitwise equal to it);
   a persisted poisson3Da artifact whose first A slot is rewritten past A
   with its digest re-signed, reloaded under ``validate="deep"``:
   rejected in the loader with K1 and K2 launched zero times, rebuilt
   bitwise equal to a cold build; the gateway/pipeline lock-order lint on
   the card (acyclic); OMAR (Eq. 1) of the eight paper matrices at their
   published sizes;
6. hold the flash-attention kernel (K5) against its plain version at the
   JAX package's K5 test shapes, with windows, a q_offset, fully masked
   rows and ragged lengths and head widths, in float32 and bfloat16, and
   D = 64 at S = 2048: float32 within 2e-4 (the JAX
   package's own), bfloat16 within rtol 1e-2, atol 1e-3 (see
   ``ATTN_TOL``);
7. granite-3-2b at its published widths, float32, weights drawn on the
   card from seed 0: ``make_prefill_step`` on 4 x 2048 tokens from a numpy
   seed launches K5 once per layer (40; the bfloat16 prefill of phase 8
   launches the tensor-core kernel as many times); the logits of every
   position equal those of the same forward with the plain version in place of the
   kernel, and teacher-forced ``decode_step`` over the first 512 tokens
   reproduces them;
8. the same in bfloat16 (the config's own dtype): the largest logit
   difference and the share of greedy tokens on which the kernel and the
   plain version agree; the same prefill at 4 x 1000 tokens (not a
   multiple of 512) launches K5 40 times and no torch attention path, its
   logits compared with the plain path's the same way; then
   ``BatchedServer`` answers 8 requests;
9. timings with CUDA events (median after warm-up) of each kernel, its
   plain version and one PyTorch call for the same function (cuSPARSE
   CSR @ CSR, ``scaled_dot_product_attention``: yardsticks the port never
   calls), the least time the card could take, and end-to-end times:
   SpGEMM ``execute``, prefill and decode, with the device's busy time,
   idle share and kernel count per prefill and per decode step under
   torch.profiler; 2cubes_sphere's ``build_assembly_map`` on the host,
   sort-free beside the sort (first and last C blocks swapped), both
   bitwise equal to the plan's map; granite's weights are then freed;
10. hold the block-sparse SpMM (K3) against its plain version: the JAX
    package's K3 test shapes and the port's card-test shapes in float32
    and bfloat16, an empty column panel and small integers (bitwise, both
    types), bf16 blocks whose rows are padded (bn % 8 != 0), then
    granite-3-2b's SparseLinear down projection at full width (x 8192 x
    8192 bf16, W 8192 x 2048 in 128 x 128 blocks at density 0.25 from
    ``sparse_block_mask``) through ``ops.sparse_dense_matmul``, whose
    launch is counted; all within 1e-3 (see ``BSR_TOL``); the ``ops``
    call and the kernel alone on indices staged once timed beside its
    plain version and ``torch.matmul`` with the masked dense weight;
11. hold the grouped matmul (K4) against its plain version within 1e-4:
    the JAX package's K4 test shapes, small integers (bitwise), and
    qwen3-moe-30b-a3b's expert shapes at prefill (128 experts x 640 slots,
    D 2048 <-> F 768) and decode (8 slots, tile 8); each of the four bf16
    shapes timed beside its plain version and ``torch.bmm`` over
    [E, C, D] x [E, D, F], and the host time of the tensor maps that every
    bf16 launch encodes;
12. qwen3-moe-30b-a3b at its published widths, float32, depth cut to 4
    layers (full depth in float32 takes 120 GB), weights drawn on the card
    from seed 0: ``make_prefill_step`` on 4 x 2048 tokens launches K4 12
    times and K5 4 times; the logits of every position equal those of the
    same forward with the plain K4 and K5 in place within 2e-2, and
    teacher-forced ``decode_step`` over the first 512 tokens reproduces
    them within 2e-2; differing expert choices and dropped pairs are
    printed;
13. qwen3-moe-30b-a3b at full width and depth (48 layers), weights stored
    in bfloat16 (the config's ``param_dtype``; the reference casts every
    weight to the compute dtype at use) but for the 48 routers, kept in
    float32 as the reference routes: the prefill launches K4 144 times
    and K5 48 times, all on the tensor-core kernels, with finite logits; the largest logit difference and
    greedy agreement against the plain path; decode at batch 4 and
    ``BatchedServer`` answering 8 requests; prefill, decode and server
    times with the device's busy share;
14. training: (a) ``ops.attention``'s VJP (K5 forward, the reference's
    plain recompute backward) against autograd through the plain version
    at phase 6's shapes, windows, a q_offset and ragged lengths, in
    float32 within 2e-4 and bfloat16 within ``ATTN_TOL``; (b)
    granite-3-2b at full width, float32, 4 layers, trainable weights
    drawn on the card from seed 0, on 4 x 2048 ``SyntheticLM`` tokens
    (seed 0): ``lm_loss`` and every gradient on the K5 path against the
    plain path (``TRAIN_GRAD_TOL``), K5 twice per layer (forward and
    remat recompute); (c) granite-3-2b at full width and depth in the
    config's dtypes (bf16 compute, float32 params, remat "full"):
    ``make_train_step`` with the launcher's AdamW takes 3 steps with
    finite loss and grad_norm, moving every parameter, 80 K5 launches per
    step; the median step time, the peak memory allocated, the device's
    busy share of a profiled step, and the plain recompute backward of one
    layer's attention beside SDPA's forward + backward and its bound; (d)
    ``launch_train`` at the reduced config on the card, 20 steps with
    checkpoints every 5 under ``build/train_ckpt/``: the loss falls, a
    second launch resumes at step 20 with params and optimizer state
    bitwise equal to the saved ones;
15. the other eight architectures (``ARCH_RUNS``), weights drawn on the
    card from seed 0, inputs from a numpy seed: LM_BATCH x LM_SEQ tokens
    (hubert: frames of 512; paligemma: 256 patches of 1152 before the
    text; h2o-danube 1 x 8192, so that its window of 4096 masks). Each:
    (a) float32 at full width over one period (the fewest layers that
    hold every block kind: 1, jamba 8): all-position logits through K5
    and K4 against the plain versions within LM_TOL, K5 once per attention
    layer and K4 three times per MoE layer, then 32 teacher-forced decode
    steps against the prefill within LM_TOL (paligemma: against its
    backbone's text-only forward; hubert, encoder-only, has no decode);
    (b) bf16 weights (float32 routers) at full width, full depth where it
    fits and else the most layers that do: the prefill through
    ``make_prefill_step`` with its launches and peak memory, 8 bf16
    decode steps against the forward (drift, greedy agreement),
    ``BatchedServer`` answering 8 requests for mamba2 and jamba (the SSM
    state across slots); (c) prefill ms and tokens/s, decode ms per step,
    the MoE dispatch's share of a profiled prefill; then K5 alone at
    hubert's, paligemma's, h2o-danube's and command-r's prefill shapes
    and K4 at llama4-scout's and jamba's expert shapes, each against its
    plain version, SDPA / ``torch.bmm`` and its bound (the new shapes go
    under ``shapes`` of the kernels line);
16. training the nine architectures beside granite (``TRAIN_RUNS``), in
    the registry's order, at full width in the config's dtypes (bf16
    compute, float32 params and AdamW state, remat "full"), full depth
    where the state fits and else the most layers that do: (a)
    ``make_train_step`` with the launcher's AdamW on ``SyntheticLM``
    batches (hubert's frames, labels and mask; paligemma's patches) takes
    2 steps with finite metrics that move every parameter, K5 launched
    once per attention layer in the forward and once in the remat
    recompute, K4 3 times per MoE layer in each and 6 times in the
    expert backward (12 a layer), counted by phase; median step ms,
    tokens/s, peak memory, the expert backward's device ms, and one
    profiled step (idle share, K4's and the MoE dispatch's shares); (b)
    the float32 gradient gate for hubert, h2o-danube, mamba2, qwen3,
    llama4, paligemma and jamba at 1-2 layers: ``lm_loss`` and every
    gradient through K5 and K4 against the plain path within phase 14's
    bounds; (c) the expert backward's dx and dw K4 launches alone at
    qwen3's and llama4's train shapes against their plain versions,
    ``torch.bmm`` and their bounds; (d) ``launch_train`` of the reduced
    qwen3 and mamba2 on the card: the loss falls. Then one
    ``{"kernels": [...]}`` line with K1-K5 (K5's and K4's launches by
    path: the bf16 prefills and the train steps of phases 14 and 16; K4's
    backward timings under ``backward_shapes``);
17. the last line: ``{"ok": true, "device": {...}}``.

Needs one CUDA device; exits nonzero without one. TF32 is switched off, so
every float32 product here is full float32.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import shutil
import subprocess
import sys
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.registry import get_config, get_reduced  # noqa: E402
from repro_torch.core import perfmodel, tuning  # noqa: E402
from repro_torch.core.gustavson import spgemm_gustavson  # noqa: E402
from repro_torch.core.schedule import build_assembly_map, build_spgemm_schedule  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.bsr_spmm import bsr_spmm, bsr_spmm_staged, stage_bsr_index  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm  # noqa: E402
from repro_torch.kernels.gustavson_spgemm import (  # noqa: E402
    runs_case,
    spgemm_scheduled,
    spgemm_scheduled_batch,
    stage_runs,
)
from repro_torch.launch.serve import BatchedServer, Request  # noqa: E402
from repro_torch.models import moe, transformer as tr  # noqa: E402
from repro_torch.models.mlp import sparse_block_mask  # noqa: E402
from repro_torch.models.nn import cast_params  # noqa: E402
from repro_torch.runtime.steps import (  # noqa: E402
    make_decode_step,
    make_prefill_step,
    make_train_step,
)
from repro_torch.sparse.convert import to_bcsr, to_bcsv  # noqa: E402
from repro_torch.sparse.formats import BCSV, COO, CSR  # noqa: E402
from repro_torch.data.pipeline import SpGEMMValueStream, SyntheticLM  # noqa: E402
from repro_torch.launch.train import launch_train, make_optimizer  # noqa: E402
from repro_torch.models.tree import flatten_with_paths, tree_leaves  # noqa: E402
from repro_torch.sparse.random import random_block_sparse, random_coo, suite_matrix  # noqa: E402
from repro_torch.launch.mesh import make_shard_mesh  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.spgemm import (  # noqa: E402
    Outcome,
    PlanCache,
    SpGEMMGateway,
    SpGEMMPlan,
    default_cache,
    probe_run_count,
    schedule_build_count,
    spgemm_plan,
)

SEED = 0
TILE, GROUP = 64, 4
# The JAX package's kernel-test shapes (tests/test_kernels.py) and a 128^3
# tile, the largest a plan takes.
KERNEL_SHAPES = [
    ((128, 128, 128), (32, 32, 32), 1),
    ((256, 128, 192), (64, 64, 64), 2),
    ((256, 384, 256), (64, 64, 128), 4),
    ((256, 512, 256), (128, 128, 128), 2),
]
# Tiles whose runs hold 0, 1, 3 and 8 triples (phase 3).
RUN_TILES = [(32, 32, 32), (64, 64, 64), (64, 64, 128), (128, 128, 128)]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
ORACLE_TOL = 1e-4
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores (the
# kernels' float32 paths use none), dense bf16 on the tensor cores, HBM
# bandwidth; one definition, shared with the autotuner's roofline model.
PEAK_F32_FLOPS = perfmodel.PEAK_F32_FLOPS
PEAK_BYTES_PER_S = perfmodel.PEAK_BYTES_PER_S
PEAK_BF16_FLOPS = perfmodel.PEAK_BF16_FLOPS
SOURCE = "src/repro_torch/kernels/csrc/gustavson_spgemm.cu"
SOURCE_K5 = "src/repro_torch/kernels/csrc/flash_attention.cu"
SOURCE_K3 = "src/repro_torch/kernels/csrc/bsr_spmm.cu"
SOURCE_K4 = "src/repro_torch/kernels/csrc/moe_gmm.cu"

# Flash attention: the JAX package's K5 test shapes (tests/test_kernels.py)
# and D = 64 at S = 2048, the LM's head width at its prefill length.
ATTN_SHAPES = [(2, 256, 64), (4, 512, 128), (1, 1024, 128), (2, 2048, 64)]
# (rtol, atol). Float32: the JAX package's own 2e-4. Bfloat16: the plain
# version computes in float32; the kernel forms Q K^T on the tensor cores
# (bf16 products, exact in float32, summed in float32), multiplies V by
# the float32 probabilities split into two bf16 halves (hi + lo, P carried
# to ~2**-17; P rounded once to bf16 would move short rows whose weights
# cancel past atol) and rounds its output to bfloat16, at most 2**-8 of
# it. The JAX package's 5e-2 is as large as a typical |output| here (row i
# of a causal product averages ~i/e keys, so |o| ~ sqrt(e/i) ~ 0.04) and
# could not fail a wrong kernel, so the check is held at rtol 1e-2, atol
# 1e-3.
ATTN_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (1e-2, 1e-3)}
# SDPA, the yardstick, rounds its probabilities to bfloat16 before P.V, so
# it differs from the kernel by more than an output rounding; its check
# only shows that the timed call computes the same function.
SDPA_TOL = 5e-2
# The LM path: granite-3-2b at its published widths, prefill of 4 x 2048
# tokens (a multiple of 512, so every layer takes the flash kernel).
LM_ARCH = "granite-3-2b"
LM_BATCH, LM_SEQ = 4, 2048
# A prefill length that is not a multiple of 512 (the TPU kernel's tile):
# on the card it runs K5 all the same.
LM_SEQ_RAGGED = 1000
DECODE_TOKENS = 512
# The JAX package's own decode-vs-forward bound (tests/test_models.py).
# Float32 forwards whose attention sums in another order (the kernel's
# tiles against one softmax over the whole row), and a decode that
# recomputes every position one token at a time, drift apart through 40
# layers of rounding; 2e-2 on logits of order 1 bounds that and no more.
LM_TOL = 2e-2

# K3: the JAX package's test shapes (tests/test_kernels.py) and the port's
# card-test shapes (ragged M, bk 32 and 64, bn 64 and 192), (m, k, n, bk, bn).
BSR_SHAPES = [(64, 256, 256, 128, 128), (200, 384, 512, 128, 128), (128, 256, 384, 128, 128),
              (100, 96, 192, 32, 64), (256, 512, 384, 64, 192)]
# K3 and its plain version both form float32 sums of float32 products of
# the same inputs (bf16 inputs are widened exactly) and write float32, so
# bfloat16 is held at the float32 tolerance, 1e-3 (the JAX package's own;
# its 0.15 for bf16 compares against an oracle on unrounded inputs).
BSR_TOL = 1e-3
# granite-3-2b's SparseLinear down projection: d_ff x d_model in 128 x 128
# blocks at the config's density, applied to 4 x 2048 tokens.
BSR_FULL = dict(m=LM_BATCH * LM_SEQ, k=8192, n=2048, block=128, density=0.25)
# K4: the JAX package's test shapes (t, d, f, e, tm) and its 1e-4 (outputs
# of order 1: weights scaled by 1/sqrt(D)).
GMM_SHAPES = [(256, 128, 256, 2, 128), (512, 256, 128, 4, 128), (1024, 128, 384, 8, 128)]
GMM_TOL = 1e-4
# The library calls round their output to bf16 (2**-8 of outputs of order
# 1): their checks only show that the timed call computes the function.
LIB_TOL = 3e-2
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_F32_LAYERS = 4
# Training (phase 14). (b): granite at full width in float32, depth cut to
# 4 layers, lm_loss and every gradient on the K5 path against the plain
# path. Both paths run the same plain recompute backward; they differ only
# in the attention forwards (K5 against the plain version, within 2e-4 in
# float32), so the loss is held within rtol 1e-4 and each gradient within
# 1e-3 of its leaf's largest plain-path magnitude: room for that forward
# difference carried through 4 layers, the embedding gradient's
# order-dependent CUDA scatter-add and the reductions' order, and far
# below what a gradient that misses a term would show.
TRAIN_F32_LAYERS = 4
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
# (c): granite at full width and depth, the config's dtypes, 3 steps.
TRAIN_STEPS = 3
# (d): launch_train at the reduced config, checkpoints under build/.
LAUNCH_STEPS, LAUNCH_BATCH, LAUNCH_SEQ, LAUNCH_CKPT_EVERY = 20, 64, 64, 5
TRAIN_CKPT = ROOT / "build" / "train_ckpt"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_samples(fn, reps: int, warmup: int = 2) -> list:
    """Device times of ``fn`` in ms, one call between two events, over
    ``reps`` timed runs after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms over ``reps`` timed calls."""
    return float(np.median(time_samples(fn, reps, warmup)))


def host_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median wall time of ``fn`` in ms; ``fn`` returns host results."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


KERNELS = (spgemm_scheduled, spgemm_scheduled_batch, flash_attention, bsr_spmm, moe_gmm)


# Wrappers that count their launches on bfloat16 operands (K3, K4, K5:
# a tensor-core kernel of their own; K1, K2: bfloat16 blocks).
TC_KERNELS = (spgemm_scheduled, spgemm_scheduled_batch, flash_attention, bsr_spmm, moe_gmm)


def reset_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    for fn in TC_KERNELS:
        fn.bf16_launches = 0
    for fn in (spgemm_scheduled, spgemm_scheduled_batch):
        fn.stream_launches.clear()


def counts() -> dict:
    out = {fn.__name__: fn.launches for fn in KERNELS}
    out.update({f"{fn.__name__}_bf16": fn.bf16_launches for fn in TC_KERNELS})
    return out


# -- phase 3: kernel against its plain version --------------------------------

def kernel_case(shape, blocks, group, seed, integer):
    m, k, n = shape
    bm, bk, bn = blocks
    ad = random_block_sparse(m, k, (bm, bk), 0.35, seed=seed)
    bd = random_block_sparse(k, n, (bk, bn), 0.4, seed=seed + 1)
    if integer:
        rng = np.random.default_rng(seed + 100)
        ad = np.where(ad != 0, rng.integers(1, 4, ad.shape), 0).astype(np.float32)
        bd = np.where(bd != 0, rng.integers(-3, 4, bd.shape), 0).astype(np.float32)
    a, b = to_bcsv(ad, (bm, bk), group), to_bcsr(bd, (bk, bn))
    return a, b, build_spgemm_schedule(a, b)


def phase_kernel_checks(dev) -> None:
    for shape, blocks, group in KERNEL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for integer in (False, True):
                a, b, sch = kernel_case(shape, blocks, group, 1, integer)
                runs = stage_runs(sch, dev)
                at = torch.from_numpy(a.blocks).to(dev, dtype)
                bt = torch.from_numpy(b.blocks).to(dev, dtype)
                got = spgemm_scheduled(at, bt, runs)
                want = ref.spgemm_scheduled_ref(
                    at, bt, sch.a_slot, sch.b_slot, sch.panel, sch.sub_row,
                    sch.n_panels, sch.group)
                torch.cuda.synchronize()
                err = float((got - want).abs().max()) if got.numel() else 0.0
                if integer:
                    check(torch.equal(got, want),
                          f"K1 {shape} {dtype} small integers not bitwise (err {err})")
                else:
                    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])
                log(f"  K1 {shape} tile {blocks} group {group} {str(dtype)[6:]}"
                    f"{' int' if integer else ''}: max_abs_err {err:.3g}")
            # K2 with 3 value sets against a loop of K1, bitwise.
            g = torch.Generator(device=dev).manual_seed(SEED)
            a_sets = torch.randn((3,) + a.blocks.shape, generator=g, device=dev).to(dtype)
            b_sets = torch.randn((3,) + b.blocks.shape, generator=g, device=dev).to(dtype)
            batch = spgemm_scheduled_batch(a_sets.flatten(0, 1), b_sets.flatten(0, 1),
                                           runs, bsz=3)
            for i in range(3):
                check(torch.equal(batch[i], spgemm_scheduled(a_sets[i], b_sets[i], runs)),
                      f"K2 element {i} differs from K1 at {shape} {dtype}")
            plain = ref.spgemm_scheduled_batch_ref(
                a_sets.flatten(0, 1), b_sets.flatten(0, 1), sch.a_slot, sch.b_slot,
                sch.panel, sch.sub_row, sch.n_panels, sch.group, 3)
            torch.testing.assert_close(batch, plain, rtol=TOL[dtype], atol=TOL[dtype])
            log(f"  K2 bsz 3 {shape} {str(dtype)[6:]}: bitwise equal to looped K1")
    for tile in RUN_TILES:
        for dtype in (torch.float32, torch.bfloat16):
            errs = []
            for integer in (False, True):
                a, b, sch = runs_case(tile, integer)
                runs = stage_runs(sch, dev)
                check(np.diff(runs.ptr.cpu().numpy()).tolist() == [0, 1, 3, 8],
                      f"K1 run lengths at {tile}")
                at = torch.from_numpy(a.blocks).to(dev, dtype)
                bt = torch.from_numpy(b.blocks).to(dev, dtype)
                got = spgemm_scheduled(at, bt, runs)
                want = ref.spgemm_scheduled_ref(at, bt, sch.a_slot, sch.b_slot, sch.panel,
                                                sch.sub_row, sch.n_panels, sch.group)
                torch.cuda.synchronize()
                check(bool((got[0, :tile[0]] == 0).all()), f"K1 empty run at {tile} not zero")
                if integer:
                    check(torch.equal(got, want), f"K1 runs at {tile} {dtype}: not bitwise")
                else:
                    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])
                errs.append(float((got - want).abs().max()))
                sets = [(a.blocks * (i + 1)) for i in range(3)]
                a3 = torch.from_numpy(np.stack(sets)).to(dev, dtype)
                batch = spgemm_scheduled_batch(a3.flatten(0, 1), bt.repeat(3, 1, 1), runs, bsz=3)
                for i in range(3):
                    check(torch.equal(batch[i], spgemm_scheduled(a3[i], bt, runs)),
                          f"K2 element {i} differs from K1 on the runs at {tile}")
            log(f"  K1 runs of 0, 1, 3 and 8 triples, tile {tile} {str(dtype)[6:]}: "
                f"max_abs_err {errs[0]:.3g}, small integers bitwise; K2 bitwise equal to "
                f"looped K1")


# -- phases 4-5: the main path ------------------------------------------------

def compare_to_oracle(c: CSR, oracle: CSR, what: str) -> float:
    """``c`` against the Gustavson oracle: equal values at the oracle's
    nonzeros, zero at every other stored entry of ``c`` (the plan stores
    C's block-structural pattern). Returns the largest absolute
    difference."""
    n = c.shape[1]
    check(c.shape == oracle.shape, f"{what}: shape {c.shape} vs {oracle.shape}")
    key = np.repeat(np.arange(c.shape[0], dtype=np.int64), np.diff(c.indptr)) * n + c.indices
    o_key = (np.repeat(np.arange(oracle.shape[0], dtype=np.int64), np.diff(oracle.indptr)) * n
             + oracle.indices)
    pos = np.searchsorted(key, o_key)
    check(key.size > 0 and bool(np.all(pos < key.size))
          and np.array_equal(key[np.minimum(pos, key.size - 1)], o_key),
          f"{what}: oracle nonzeros outside the stored pattern")
    check(bool(np.all(np.isfinite(c.data))), f"{what}: non-finite values")
    np.testing.assert_allclose(c.data[pos], oracle.data, rtol=ORACLE_TOL, atol=ORACLE_TOL,
                               err_msg=what)
    rest = np.ones(key.size, bool)
    rest[pos] = False
    off = float(np.abs(c.data[rest]).max(initial=0.0))
    check(off <= ORACLE_TOL, f"{what}: entries outside the oracle's pattern not zero ({off})")
    return max(float(np.abs(c.data[pos] - oracle.data).max(initial=0.0)), off)


def check_against_oracle(c: CSR, a: CSR, a_vals, b_vals, what: str) -> float:
    """C = A·A from the plan, with A's pattern carrying ``a_vals`` on the
    left and ``b_vals`` on the right, against the Gustavson oracle."""
    oracle = spgemm_gustavson(CSR(a.indptr, a.indices, a_vals, a.shape),
                              CSR(a.indptr, a.indices, b_vals, a.shape))
    return compare_to_oracle(c, oracle, what)


def phase_main_path(dev, rng):
    a = suite_matrix("poisson3Da", scale=1.0, seed=SEED)
    t0 = time.perf_counter()
    plan = spgemm_plan(a, a, tile=TILE, group=GROUP, device=dev)
    plan_s = time.perf_counter() - t0
    r = plan.report
    log(f"  poisson3Da {a.shape} nnz {a.nnz}: plan {plan_s:.2f} s, triples "
        f"{r.num_triples}, panels {r.n_panels}, nnzb_a {r.nnzb_a}, nnzb_b "
        f"{r.nnzb_b}, structural nnz(C) {plan.assembly.nnz}")
    singles = [(rng.standard_normal(a.nnz, dtype=np.float32),
                rng.standard_normal(a.nnz, dtype=np.float32)) for _ in range(3)]
    a_batch = rng.standard_normal((4, a.nnz), dtype=np.float32)
    b_batch = rng.standard_normal((4, a.nnz), dtype=np.float32)
    chunk = plan._executor.batch_chunk()
    reset_counts()
    outs = [plan.execute(av, bv) for av, bv in singles]
    batch_outs = plan.execute_batch(a_batch, b_batch)
    torch.cuda.synchronize()
    launched = counts()
    log(f"  main path: 3 execute + execute_batch(4) (chunk {chunk}); launches {launched}")
    check(launched["spgemm_scheduled"] == 3, f"K1 launches {launched}")
    check(launched["spgemm_scheduled_batch"] == -(-4 // min(4, chunk)),
          f"K2 launches {launched}")
    errs = [check_against_oracle(c, a, av, bv, f"execute {i}")
            for i, (c, (av, bv)) in enumerate(zip(outs, singles))]
    errs += [check_against_oracle(c, a, a_batch[i], b_batch[i], f"execute_batch[{i}]")
             for i, c in enumerate(batch_outs)]
    for i in range(4):
        single = plan.execute(a_batch[i], b_batch[i])
        check(np.array_equal(single.data, batch_outs[i].data),
              f"execute_batch[{i}] differs from execute")
    log(f"  poisson3Da vs Gustavson oracle: max_abs_err {max(errs):.3g}; "
        f"execute_batch bitwise equal to looped execute")
    return a, plan, launched, chunk


def phase_second_matrix(dev, rng):
    a = suite_matrix("2cubes_sphere", scale=1.0, seed=SEED)
    t0 = time.perf_counter()
    plan = spgemm_plan(a, a, tile=TILE, group=GROUP, device=dev)
    plan_s = time.perf_counter() - t0
    r = plan.report
    log(f"  2cubes_sphere {a.shape} nnz {a.nnz}: plan {plan_s:.2f} s, triples "
        f"{r.num_triples}, panels {r.n_panels}, structural nnz(C) {plan.assembly.nnz}")
    av = rng.standard_normal(a.nnz, dtype=np.float32)
    bv = rng.standard_normal(a.nnz, dtype=np.float32)
    reset_counts()
    c = plan.execute(av, bv)
    torch.cuda.synchronize()
    launched = counts()
    check(launched["spgemm_scheduled"] == 1, f"K1 launches {launched}")
    err = check_against_oracle(c, a, av, bv, "2cubes_sphere execute")
    log(f"  2cubes_sphere: launches {launched}; vs oracle max_abs_err {err:.3g}")
    return a, plan


def phase_bf16_plan(a: CSR, dev, rng) -> dict:
    """poisson3Da through a plan built on bfloat16 values: the plan keeps
    bfloat16, rounds each execute's float32 values to it and launches K1
    on bfloat16 blocks; C against the oracle on the rounded values."""
    t = torch.sparse_csr_tensor(torch.from_numpy(a.indptr.astype(np.int64)),
                                torch.from_numpy(a.indices.astype(np.int64)),
                                torch.from_numpy(a.data.astype(np.float32)).bfloat16(), a.shape,
                                check_invariants=False)
    plan = spgemm_plan(t, t, tile=TILE, group=GROUP, device=dev)
    check(plan.value_dtypes == (torch.bfloat16, torch.bfloat16),
          f"bf16 plan value dtypes {plan.value_dtypes}")
    singles = [(rng.standard_normal(a.nnz, dtype=np.float32),
                rng.standard_normal(a.nnz, dtype=np.float32)) for _ in range(3)]
    reset_counts()
    outs = [plan.execute(av, bv) for av, bv in singles]
    torch.cuda.synchronize()
    launched = counts()
    check(launched["spgemm_scheduled"] == 3 and launched["spgemm_scheduled_bf16"] == 3,
          f"bf16 plan: K1 launches {launched}")

    def rounded(v):
        return torch.from_numpy(v).bfloat16().float().numpy()

    errs = [check_against_oracle(c, a, rounded(av), rounded(bv), f"bf16 plan execute {i}")
            for i, (c, (av, bv)) in enumerate(zip(outs, singles))]
    log(f"  poisson3Da bf16 plan: 3 execute, launches {launched}; vs the oracle on the "
        f"bf16-rounded values: max_abs_err {max(errs):.3g}")
    a_blocks, b_blocks, runs = kernel_inputs(plan, dev, rng, 1)
    a_blocks, b_blocks = a_blocks.bfloat16(), b_blocks.bfloat16()
    got = spgemm_scheduled(a_blocks, b_blocks, runs)
    plain = ref.spgemm_scheduled_ref(a_blocks, b_blocks, runs.a_slot, runs.b_slot,
                                     runs.panel, runs.sub_row, runs.n_panels, runs.group)
    torch.testing.assert_close(got, plain, rtol=TOL[torch.bfloat16], atol=TOL[torch.bfloat16])
    err = float((got - plain).abs().max())
    del got, plain
    (b_ms, b_by), flops, _ = bound(plan, 1)
    k_ms = time_ms(lambda: spgemm_scheduled(a_blocks, b_blocks, runs), reps=20)
    p_ms = time_ms(lambda: ref.spgemm_scheduled_ref(
        a_blocks, b_blocks, runs.a_slot, runs.b_slot, runs.panel, runs.sub_row,
        runs.n_panels, runs.group), reps=5)
    vals = singles[0]
    e2e_ms = host_ms(lambda: plan.execute(*vals), reps=5)
    log(f"  K1 poisson3Da, bf16 blocks: {k_ms:.4f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s, "
        f"{b_ms / k_ms:.1%} of the bound {b_ms:.4f} ms, {b_by}); plain {p_ms:.4f} ms; "
        f"max_abs_err {err:.3g}; execute end to end {e2e_ms:.3f} ms")
    return {"K1_bf16_ms": k_ms, "K1_bf16_plain_ms": p_ms, "K1_bf16_bound_ms": b_ms,
            "K1_bf16_bound_by": b_by, "K1_bf16_max_abs_err": err,
            "bf16_plan_oracle_max_abs": max(errs), "bf16_plan_execute_ms": e2e_ms,
            "bf16_plan_k1_launches": launched["spgemm_scheduled"]}


# -- phases 5c-5e: compact output, chains, the pipeline -------------------------

def same_on_positions(block: CSR, compact: CSR, what: str) -> None:
    """``compact`` expanded to dense equals ``block`` expanded to dense,
    bitwise: every compact position holds the block result's value there,
    and every other stored block value is zero."""
    n = block.shape[1]
    check(block.shape == compact.shape, f"{what}: shapes {block.shape} vs {compact.shape}")
    key = np.repeat(np.arange(block.shape[0], dtype=np.int64), np.diff(block.indptr)) * n \
        + block.indices
    c_key = np.repeat(np.arange(compact.shape[0], dtype=np.int64), np.diff(compact.indptr)) * n \
        + compact.indices
    pos = np.searchsorted(key, c_key)
    check(bool(np.all(pos < key.size)) and np.array_equal(key[np.minimum(pos, key.size - 1)],
                                                           c_key),
          f"{what}: compact positions outside the block pattern")
    check(np.array_equal(block.data[pos], compact.data), f"{what}: values differ")
    rest = np.ones(key.size, bool)
    rest[pos] = False
    check(not np.any(block.data[rest]), f"{what}: block fill not zero")


def structural_nnz(a: CSR) -> int:
    """nnz of A·A's element pattern, from the Gustavson oracle on ones
    (positive products: nothing cancels)."""
    ones = CSR(a.indptr, a.indices, np.ones(a.nnz, np.float32), a.shape)
    return int(spgemm_gustavson(ones, ones).nnz)


def phase_compact(mats, dev, rng) -> tuple:
    """``output="compact"`` plans of both matrices against their block
    plans (``mats``: name -> (A, block plan)) on the same values."""
    info, plans = {}, {}
    for name, (a, block) in mats.items():
        t0 = time.perf_counter()
        plan = spgemm_plan(a, a, tile=TILE, group=GROUP, device=dev, output="compact")
        plan_s = time.perf_counter() - t0
        nnz_c, nnz_b = plan.compact.nnz, block.assembly.nnz
        want_nnz = structural_nnz(a)
        check(nnz_c == want_nnz, f"{name}: nnz(compact) {nnz_c} != structural {want_nnz}")
        av = rng.standard_normal(a.nnz, dtype=np.float32)
        bv = rng.standard_normal(a.nnz, dtype=np.float32)
        a_batch = rng.standard_normal((4, a.nnz), dtype=np.float32)
        b_batch = rng.standard_normal((4, a.nnz), dtype=np.float32)
        reset_counts()
        c = plan.execute(av, bv)
        batch = plan.execute_batch(a_batch, b_batch)
        torch.cuda.synchronize()
        launched = counts()
        check(launched["spgemm_scheduled"] == 1 and launched["spgemm_scheduled_batch"] >= 1,
              f"{name} compact: launches {launched}")
        same_on_positions(block.execute(av, bv), c, f"{name} compact vs block")
        check(np.array_equal(plan.device_indptr().cpu().numpy(), c.indptr.astype(np.int32)),
              f"{name}: device_indptr differs from the host indptr")
        for i, got in enumerate(batch):
            check(np.array_equal(got.data, plan.execute(a_batch[i], b_batch[i]).data),
                  f"{name} compact execute_batch[{i}] differs from execute")
        e2e = {mode: host_ms(lambda p=p: p.execute(av, bv), reps=3)
               for mode, p in (("compact", plan), ("block", block))}
        log(f"  {name} compact: plan {plan_s:.2f} s; nnz(C) {nnz_c} against {nnz_b} block "
            f"values ({nnz_c / nnz_b:.1%}); D2H per execute {4 * nnz_c} B against "
            f"{4 * nnz_b} B; execute {e2e['compact']:.3f} ms against {e2e['block']:.3f} ms; "
            f"launches {launched}; equal to the block result on the structural positions, "
            f"execute_batch(4) bitwise equal to 4 execute")
        info[name] = {"plan_s": plan_s, "nnz_compact": nnz_c, "nnz_block": nnz_b,
                      "d2h_bytes_compact": 4 * nnz_c, "d2h_bytes_block": 4 * nnz_b,
                      "execute_ms_compact": e2e["compact"], "execute_ms_block": e2e["block"]}
        plans[name] = plan
    return plans, info


# The chain's second operand: a banded ("fem") random matrix at 3.2 values
# per row. With it stage 2 expands ~10 M (i, k) x B(k, :) pairs and fills
# ~11 M block values; a uniform one of that density would fill the whole
# 219 x 219 block grid (196 M block values), and B = A expands 2 x 10^8.
CHAIN_B = dict(density=2e-4, structure="fem", seed=1)


def dtoh_copies(fn) -> int:
    """Device-to-host copies the profiler sees while ``fn`` runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == DeviceType.CUDA and "DtoH" in e.name)


def chain_case(stage1, b2, av, bv, what: str) -> dict:
    """``stage1.then(b2)``: execute_chain against the host round trip,
    bitwise, with the intermediate a CUDA tensor."""
    t0 = time.perf_counter()
    chain = stage1.then(b2)
    plan2_s = time.perf_counter() - t0
    stage2 = chain.plans[1]
    reset_counts()
    out = chain.execute(av, bv)
    torch.cuda.synchronize()
    launched = counts()
    check(launched["spgemm_scheduled"] == 2, f"{what}: K1 launches {launched}")
    round_trip = stage2.execute(a_vals=stage1.execute(av, bv).data)
    check(np.array_equal(out.indptr, round_trip.indptr)
          and np.array_equal(out.data, round_trip.data),
          f"{what}: execute_chain differs from the host round trip")
    check(bool(np.all(np.isfinite(out.data))), f"{what}: non-finite values")
    packed = stage1._run_packed(av, bv)
    check(packed.is_cuda, f"{what}: stage 1's packed values left the device")
    last = stage2._run_packed_chained(packed)
    check(last.is_cuda and np.array_equal(last.cpu().numpy(), out.data),
          f"{what}: chained stage 2 differs")
    copies = dtoh_copies(lambda: chain.execute(av, bv))
    check(copies <= 1, f"{what}: {copies} device-to-host copies in one chain execute")
    r2 = stage2.report
    log(f"  {what}: stage 2 plan {plan2_s:.2f} s ({r2.num_triples} triples, "
        f"{stage2.assembly.nnz} block values, nnz(C) {stage2._active().nnz}); "
        f"launches {launched}; bitwise equal to the host round trip; stage 1's values a "
        f"CUDA tensor; {copies} device-to-host copy per chain execute")
    return {"stage2_plan_s": plan2_s, "stage2_triples": r2.num_triples,
            "stage2_nnz": stage2._active().nnz, "stage2_block_values": stage2.assembly.nnz,
            "dtoh_copies": copies}


def phase_chain(a: CSR, stage1, stage1_plan_s, dev, rng) -> dict:
    """poisson3Da (A·A)·B2 through ``plan.then``, float32, then once with
    small-integer values through a chain of plans built on bfloat16."""
    n = a.shape[0]
    b2 = random_coo(n, n, CHAIN_B["density"], CHAIN_B["structure"], seed=CHAIN_B["seed"])
    log(f"  B2: random_coo({n}, {n}, {CHAIN_B['density']}, {CHAIN_B['structure']!r}, "
        f"seed={CHAIN_B['seed']}): nnz {b2.nnz} ({b2.nnz / n:.2f} per row)")
    av = rng.standard_normal(a.nnz, dtype=np.float32)
    bv = rng.standard_normal(a.nnz, dtype=np.float32)
    info = {"stage1_plan_s": stage1_plan_s, "b2_nnz": b2.nnz,
            "float32": chain_case(stage1, b2, av, bv, "chain, float32")}

    def bf16_csr(m: CSR, vals):
        return torch.sparse_csr_tensor(torch.from_numpy(m.indptr.astype(np.int64)),
                                       torch.from_numpy(m.indices.astype(np.int64)),
                                       torch.from_numpy(vals).bfloat16(), m.shape,
                                       check_invariants=False)

    def small_ints(size):
        v = rng.integers(-4, 5, size).astype(np.float32)
        return np.where(v == 0, np.float32(1), v)

    ta = bf16_csr(a, small_ints(a.nnz))
    t0 = time.perf_counter()
    stage1_bf16 = spgemm_plan(ta, ta, tile=TILE, group=GROUP, device=dev, output="compact")
    plan_s = time.perf_counter() - t0
    b2_csr = CSR.from_coo(b2)
    tb = bf16_csr(b2_csr, small_ints(b2.nnz))
    check(stage1_bf16.value_dtypes == (torch.bfloat16, torch.bfloat16), "bf16 chain dtypes")
    info["bfloat16"] = chain_case(stage1_bf16, tb, small_ints(a.nnz), small_ints(a.nnz),
                                  "chain, bfloat16, small integers")
    info["bfloat16"]["stage1_plan_s"] = plan_s
    return info


def submit_without_sync(pipe, a_vals, b_vals):
    """``submit`` with PyTorch's sync debug mode set to raise: a hidden
    synchronization inside it (a pageable copy, ``.item()``) fails it, at
    once or at its collect."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return pipe.submit(a_vals, b_vals)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def device_union_ms(events) -> float:
    """Time (ms) during which at least one of the device ``events``
    (kernels and copies, on any stream) ran."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -np.inf
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3


PIPE_STEPS, PIPE_ROUNDS, PIPE_DEPTHS = 16, 7, (1, 2, 4)


def phase_pipeline(plan, dev) -> dict:
    """poisson3Da through the submit/collect pipeline, values from
    ``SpGEMMValueStream``: 16 steps at depths 1, 2 and 4 bitwise equal to
    sequential ``execute``, every submit without a synchronization, K1 on
    one side stream per slot; an out-of-order collect; batched submits
    of 4 against ``execute_batch``; steps per second; the device's idle
    share at depth 2."""
    # The check has teeth: the debug mode catches a pageable copy.
    try:
        submit_without_sync(types.SimpleNamespace(
            submit=lambda a, b: torch.from_numpy(a).to(dev)), np.ones(4, np.float32), None)
        caught = False
    except RuntimeError:
        caught = True
    check(caught, "sync debug mode let a pageable host-to-device copy through")
    stream = SpGEMMValueStream(plan.a_pattern, plan.b_pattern, seed=SEED)
    sets = [stream.values_at(s) for s in range(PIPE_STEPS)]
    probe = torch.zeros(plan.assembly.nnz, dtype=torch.float32, device=dev)
    info = {"pageable_d2h_ms_before": host_ms(probe.cpu, reps=5),
            "execute_ms_before": host_ms(lambda: plan.execute(*sets[0]), reps=5)}
    seq = [plan.execute(*v).data for v in sets]
    default = torch.cuda.default_stream(dev).cuda_stream
    for depth in PIPE_DEPTHS:
        reset_counts()
        out = []
        with plan.pipeline(depth=depth) as pipe:
            for v in sets:
                if pipe.free_slots == 0:
                    out.append(pipe.collect())
                submit_without_sync(pipe, *v)
            out.extend(pipe)
        torch.cuda.synchronize()
        launched = counts()
        side = {s: n for s, n in spgemm_scheduled.stream_launches.items() if s != default}
        check(launched["spgemm_scheduled"] == PIPE_STEPS and sum(side.values()) == PIPE_STEPS,
              f"depth {depth}: K1 launches {launched}, by stream {dict(side)}")
        check(len(side) == depth, f"depth {depth}: K1 ran on {len(side)} side streams")
        for s, (got, want) in enumerate(zip(out, seq)):
            check(np.array_equal(got.data, want), f"depth {depth}: step {s} differs from execute")
        log(f"  depth {depth}: {PIPE_STEPS} steps bitwise equal to execute; K1 launches "
            f"{launched['spgemm_scheduled']} on {len(side)} side streams")
        info[f"depth{depth}_side_streams"] = len(side)
    with plan.pipeline(depth=4) as pipe:
        tickets = [submit_without_sync(pipe, *v) for v in sets[:4]]
        order = (2, 0, 3, 1)
        got = {i: pipe.collect(tickets[i]) for i in order}
    for i in order:
        check(np.array_equal(got[i].data, seq[i]), f"out-of-order collect: step {i} differs")
    a_batch, b_batch = stream.values_batch_at(0, batch=4)
    want = plan.execute_batch(a_batch, b_batch)
    reset_counts()
    with plan.pipeline(depth=2) as pipe:
        t1 = submit_without_sync(pipe, a_batch, b_batch)
        t2 = submit_without_sync(pipe, *stream.values_batch_at(1, batch=4))
        got1, got2 = t1.result(), t2.result()
    torch.cuda.synchronize()
    launched = counts()
    check(launched["spgemm_scheduled_batch"] >= 2, f"batched submit: launches {launched}")
    want2 = plan.execute_batch(*stream.values_batch_at(1, batch=4))
    for i, (g, w) in enumerate(zip(got1 + got2, want + want2)):
        check(np.array_equal(g.data, w.data), f"batched submit element {i} differs")
    log(f"  out-of-order collect {order} bitwise equal; 2 batched submits of 4 bitwise equal "
        f"to execute_batch (K2 launches {launched['spgemm_scheduled_batch']})")
    del out, got, got1, got2, want, want2, seq

    def sequential():
        for v in sets:
            plan.execute(*v)

    def pipelined(depth):
        def run():
            with plan.pipeline(depth=depth) as pipe:
                for _ in pipe.stream(iter(sets)):
                    pass
        return run

    modes = {"execute": sequential, **{f"depth{d}": pipelined(d) for d in PIPE_DEPTHS}}
    for fn in modes.values():  # warm-up
        fn()
    rates = {name: [] for name in modes}
    for _ in range(PIPE_ROUNDS):
        for name, fn in modes.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            rates[name].append(PIPE_STEPS / (time.perf_counter() - t0))
    steps_per_s = {name: float(np.median(r)) for name, r in rates.items()}
    info["steps_per_s"] = steps_per_s
    info["steps_per_s_rounds"] = rates
    log("  steps per second, median of " + f"{PIPE_ROUNDS} rounds of {PIPE_STEPS}: "
        + ", ".join(f"{k} {v:.1f}" for k, v in steps_per_s.items()))

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run = pipelined(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = device_union_ms(dev_events)
    kernels = device_union_ms([e for e in dev_events if "Memcpy" not in e.name
                               and "Memset" not in e.name])
    copies = {k: sum(e.time_range.elapsed_us() for e in dev_events if k in e.name) / 1e3
              for k in ("HtoD", "DtoH")}
    info["depth2_profile"] = {
        "wall_ms": wall, "unprofiled_wall_ms": plain_wall, "device_busy_ms": busy,
        "kernel_busy_ms": kernels, "copy_ms": copies, "idle_share": 1.0 - busy / wall,
        "idle_share_unprofiled": max(0.0, 1.0 - busy / plain_wall),
        "device_events": len(dev_events),
    }
    log(f"  depth 2 under torch.profiler, {PIPE_STEPS} steps: wall {wall:.2f} ms (unprofiled "
        f"{plain_wall:.2f}), device busy (any stream) {busy:.2f} ms, kernels {kernels:.2f} ms, "
        f"copies {copies}; idle share {1.0 - busy / wall:.1%} (unprofiled est. "
        f"{max(0.0, 1.0 - busy / plain_wall):.1%})")
    info["pageable_d2h_ms_after"] = host_ms(probe.cpu, reps=5)
    info["execute_ms_after"] = host_ms(lambda: plan.execute(*sets[0]), reps=5)
    log(f"  C's {4 * probe.numel()} B to pageable host memory: {info['pageable_d2h_ms_before']:.3f} "
        f"ms before this phase, {info['pageable_d2h_ms_after']:.3f} ms after; execute "
        f"{info['execute_ms_before']:.3f} / {info['execute_ms_after']:.3f} ms")
    return info


# -- phases 5f-5g: the plan cache, its disk tier, sharded plans ------------------

# The disk tier's directory, inside the checkout (build/ is not committed).
PLAN_STORE = ROOT / "build" / "plan_store"
TOKEN = "poisson3Da"
SHARDS = {"poisson3Da": (1, 2, 4, 8), "2cubes_sphere": (4,)}


def same_csr(got: CSR, want: CSR, what: str) -> None:
    check(np.array_equal(got.indptr, want.indptr) and np.array_equal(got.indices, want.indices)
          and np.array_equal(got.data, want.data), f"{what}: differs from the reference result")


def digest(c: CSR) -> str:
    import hashlib

    return hashlib.blake2b(np.ascontiguousarray(c.data).tobytes()
                           + np.ascontiguousarray(c.indices).tobytes(),
                           digest_size=16).hexdigest()


def restart_values(a: CSR):
    """The values both processes of the token restart execute with."""
    rng = np.random.default_rng(SEED + 7)
    return (rng.standard_normal(a.nnz, dtype=np.float32),
            rng.standard_normal(a.nnz, dtype=np.float32))


def token_restart(store: str) -> int:
    """The second process of phase 5f: resolve poisson3Da by its token
    through the store's alias index, with no schedule built, and print
    the digest of one execute and its K1 launches."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    a = suite_matrix("poisson3Da", scale=1.0, seed=SEED)
    coo = a.to_coo()
    cache = PlanCache(disk_dir=store)
    t0 = time.perf_counter()
    plan = spgemm_plan(coo, coo, tile=TILE, group=GROUP, device=dev, cache=cache,
                       pattern_token=TOKEN)
    resolve_s = time.perf_counter() - t0
    stats = cache.stats()
    check(stats["token_disk_hits"] == 1 and stats["disk_hits"] == 1,
          f"token restart: cache stats {stats}")
    check(schedule_build_count() == 0 and plan.report.schedule_builds == 0,
          "token restart: a schedule was built")
    reset_counts()
    c = plan.execute(*restart_values(a))
    torch.cuda.synchronize()
    print(json.dumps({"digest": digest(c), "k1": spgemm_scheduled.launches,
                      "resolve_s": resolve_s}), flush=True)
    return 0


def phase_cache(mats, dev) -> dict:
    """``mats``: name -> (A, the phase-4/5 block plan on the process-level
    cache)."""
    info = {}
    a, plan = mats["poisson3Da"]
    coo = a.to_coo()
    builds = schedule_build_count()
    again = spgemm_plan(a, a, tile=TILE, group=GROUP, device=dev)
    check(again is plan and schedule_build_count() == builds,
          "a second spgemm_plan on the process-level cache did not return the plan")
    cache = PlanCache()
    tok = spgemm_plan(coo, coo, tile=TILE, group=GROUP, device=dev, cache=cache,
                      pattern_token=TOKEN)
    import repro_torch.spgemm.plan as plan_mod

    real = plan_mod.pattern_digest

    def refuse(*_a, **_k):
        raise AssertionError("a pattern-token hit paid the pattern digest")

    plan_mod.pattern_digest = refuse
    try:
        t0 = time.perf_counter()
        hit = spgemm_plan(coo, coo, tile=TILE, group=GROUP, device=dev, cache=cache,
                          pattern_token=TOKEN)
        info["token_hit_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        plan_mod.pattern_digest = real
    check(hit is tok and cache.stats.token_hits == 1, "pattern-token hit")
    log(f"  memory tier: phase 4's plan returned, no schedule built; pattern-token hit in "
        f"{info['token_hit_ms']:.2f} ms, no digest")
    del cache, tok, hit

    shutil.rmtree(PLAN_STORE, ignore_errors=True)
    rng = np.random.default_rng(SEED + 5)
    for name, (m, _) in mats.items():
        args = (m.to_coo(),) * 2 if name == TOKEN else (m, m)
        kw = dict(tile=TILE, group=GROUP, device=dev)
        if name == TOKEN:
            kw["pattern_token"] = TOKEN
        cold_cache = PlanCache(disk_dir=str(PLAN_STORE))
        t0 = time.perf_counter()
        cold = spgemm_plan(*args, cache=cold_cache, **kw)
        cold_s = time.perf_counter() - t0
        check(cold_cache.stats.stores == 1, f"{name}: cold build not stored")
        builds = schedule_build_count()
        warm_cache = PlanCache(disk_dir=str(PLAN_STORE))
        t0 = time.perf_counter()
        warm = spgemm_plan(*args, cache=warm_cache, **kw)
        warm_s = time.perf_counter() - t0
        check(warm is not cold and warm.report.loads == 1 and warm.report.schedule_builds == 0
              and schedule_build_count() == builds, f"{name}: not rehydrated from the store")
        if name == TOKEN:
            check(warm_cache.stats.token_disk_hits == 1, f"{name}: token not resolved on disk")
        av = rng.standard_normal(m.nnz, dtype=np.float32)
        bv = rng.standard_normal(m.nnz, dtype=np.float32)
        want = cold.execute(av, bv)
        reset_counts()
        got = warm.execute(av, bv)
        torch.cuda.synchronize()
        check(spgemm_scheduled.launches == 1, f"{name}: rehydrated execute launched "
              f"{spgemm_scheduled.launches} K1")
        same_csr(got, want, f"{name}: rehydrated execute")
        nbytes = cold_cache.store.total_bytes()
        info[name] = {"cold_s": cold_s, "rehydrate_s": warm_s, "store_bytes": nbytes}
        log(f"  {name}: cold build (symbolic phase + store write) {cold_s:.2f} s; rehydrate "
            f"from the store {warm_s:.2f} s; store {nbytes} B; rehydrated execute bitwise "
            f"equal to the cold plan's, K1 launched once")
        del cold, warm, want, got
    want = plan.execute(*restart_values(a))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--token-restart",
                          str(PLAN_STORE)], capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    check(out.returncode == 0, f"token restart process failed:\n{out.stderr[-3000:]}")
    child = json.loads(out.stdout.strip().splitlines()[-1])
    check(child["digest"] == digest(want) and child["k1"] == 1,
          f"token restart: {child} against this process's digest {digest(want)}")
    info["restart_process"] = {"wall_s": child_s, "resolve_s": child["resolve_s"]}
    log(f"  second process: token {TOKEN!r} resolved through the alias index in "
        f"{child['resolve_s']:.2f} s (process {child_s:.1f} s), no schedule built; its "
        f"execute bitwise equal to this process's, K1 launched once")
    return info


def sharded_from(single, mesh, dev):
    """``single``'s sharded twin over ``mesh``, from its persisted
    artifacts: no schedule is rebuilt, only the partition."""
    arrays, meta = single.persist_artifacts()
    return SpGEMMPlan.from_artifacts(
        arrays, meta, device=dev, a_vals=single.a_pattern.val, b_vals=single.b_pattern.val,
        a_pattern=single.a_pattern, b_pattern=single.b_pattern, mesh=mesh,
        output=single.output)


def phase_sharded(mats, dev) -> dict:
    """``mats``: name -> (A, block plan, compact plan), single-device."""
    info = {}
    for name, (a, single, single_c) in mats.items():
        stream = SpGEMMValueStream(single.a_pattern, single.b_pattern, seed=SEED)
        av, bv = stream.values_at(0)
        a_batch, b_batch = stream.values_batch_at(1, batch=4)
        want = single.execute(av, bv)
        want_batch = single.execute_batch(a_batch, b_batch)
        want_c = single_c.execute(av, bv)
        a_dev = torch.from_numpy(av).to(dev)
        b_dev = torch.from_numpy(bv).to(dev)
        single_ms = host_ms(lambda: single.execute(av, bv), reps=5)
        single_dev_ms = time_ms(lambda: single._executor.run_values(a_dev, b_dev), reps=10)
        for n in SHARDS[name]:
            t0 = time.perf_counter()
            plan = sharded_from(single, make_shard_mesh(n, devices=[dev] * n), dev)
            part_s = time.perf_counter() - t0
            launching = plan._executor.n_launching
            reset_counts()
            got = plan.execute(av, bv)
            torch.cuda.synchronize()
            k1 = spgemm_scheduled.launches
            check(k1 == launching, f"{name} x{n}: K1 launches {k1} for {launching} shards")
            same_csr(got, want, f"{name} x{n} execute")
            chunk = min(4, plan._executor.batch_chunk())
            reset_counts()
            batch = plan.execute_batch(a_batch, b_batch)
            torch.cuda.synchronize()
            k2 = spgemm_scheduled_batch.launches
            check(k2 == launching * -(-4 // chunk), f"{name} x{n}: K2 launches {k2}")
            for i, (g, w) in enumerate(zip(batch, want_batch)):
                same_csr(g, w, f"{name} x{n} execute_batch[{i}]")
            del batch
            compact = sharded_from(single_c, make_shard_mesh(n, devices=[dev] * n), dev)
            same_csr(compact.execute(av, bv), want_c, f"{name} x{n} compact")
            del compact
            reset_counts()
            with plan.pipeline(depth=2) as pipe:
                for s, c in enumerate(pipe.stream(stream.values_at(i)
                                                  for i in range(PIPE_STEPS))):
                    same_csr(c, single.execute(*stream.values_at(s)),
                             f"{name} x{n} pipeline step {s}")
            check(counts()["spgemm_scheduled"] == PIPE_STEPS * (1 + launching),
                  f"{name} x{n} pipeline: launches {counts()}")
            ms = host_ms(lambda: plan.execute(av, bv), reps=5)
            dev_ms = time_ms(lambda: plan._executor.run_values(a_dev, b_dev), reps=10)
            st = plan.shard_stats()
            info[f"{name}_x{n}"] = {
                "triples": st["triples"], "nnz_c": st["nnz_c"], "imbalance": st["imbalance"],
                "launching": launching, "partition_s": part_s, "execute_ms": ms,
                "single_execute_ms": single_ms, "numeric_ms": dev_ms,
                "single_numeric_ms": single_dev_ms, "k1_launches": k1, "k2_launches": k2,
            }
            log(f"  {name} x{n} shards on {dev}: triples {st['triples']} (imbalance "
                f"{st['imbalance']:.3f}); K1 launches {k1}, K2 {k2} (chunk {chunk}); execute, "
                f"execute_batch(4), compact and a depth-2 pipeline of {PIPE_STEPS} steps "
                f"bitwise equal to the single plan; execute {ms:.3f} ms against {single_ms:.3f}; "
                f"numeric phase on the card {dev_ms:.4f} ms against {single_dev_ms:.4f}; "
                f"partition {part_s:.2f} s")
            del plan
        del want, want_batch, want_c
    a, single, _ = mats["poisson3Da"]
    mesh = make_shard_mesh(4, devices=[dev] * 4)
    cold = spgemm_plan(a, a, tile=TILE, group=GROUP, device=dev, mesh=mesh,
                       cache=PlanCache(disk_dir=str(PLAN_STORE)))
    builds = schedule_build_count()
    warm = spgemm_plan(a, a, tile=TILE, group=GROUP, device=dev, mesh=mesh,
                       cache=PlanCache(disk_dir=str(PLAN_STORE)))
    check(warm.report.loads == 1 and schedule_build_count() == builds
          and warm.shard_stats() == cold.shard_stats(), "sharded plan not rehydrated")
    av, bv = SpGEMMValueStream(single.a_pattern, single.b_pattern, seed=SEED + 1).values_at(0)
    same_csr(warm.execute(av, bv), single.execute(av, bv), "rehydrated sharded plan")
    log("  poisson3Da x4 persisted and rehydrated: no schedule built, bitwise equal to the "
        "single plan")
    return info


# -- phases 5h-5i: the autotuner, the gateway -----------------------------------

# The autotuner's store (the tuned-config sidecar and the candidates'
# plans), inside the checkout (build/ is not committed); removed after 5i.
TUNE_STORE = ROOT / "build" / "autotune_store"
# The reference's knee cases (80 KiB to 8 MiB per set) and six more up to
# ~250 MiB, well past the card's 50 MiB L2.
CARD_KNEE_CASES = tuning._KNEE_CASES + tuple(
    (m, m, m, 0.02, 16, 4) for m in (384, 448, 512, 640, 768)) + ((1024, 1024, 1024, 0.015, 16, 4),)


def autotune_restart(store: str) -> int:
    """The second process of phase 5h: ``spgemm_plan(autotune=True)`` on
    poisson3Da over the store must apply the persisted config with no
    probe run; prints the config."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    a = suite_matrix("poisson3Da", scale=1.0, seed=SEED)
    t0 = time.perf_counter()
    plan = spgemm_plan(a, a, tile=TILE, group=GROUP, device=dev,
                       cache=PlanCache(disk_dir=store), autotune=True)
    resolve_s = time.perf_counter() - t0
    check(probe_run_count() == 0, f"autotune restart ran {probe_run_count()} probes")
    print(json.dumps({"cfg": plan.tuned_config.to_meta(), "source": plan.report.config_source,
                      "resolve_s": resolve_s}), flush=True)
    return 0


def phase_autotune(a: CSR, dev) -> dict:
    """poisson3Da at its published size, float32, block output: the
    autotuner's default grid around tile 64, group 4 (on the card, tiles
    {32, 64, 128} x groups {2, 4, 8}), with the disk tier; the tuned plan
    bitwise equal to an untuned plan at the winner's (tile, group); a
    second process applying the persisted config with no probe; the
    chunk-fusion knee measured on the card."""
    info = {}
    shutil.rmtree(TUNE_STORE, ignore_errors=True)
    cache = PlanCache(disk_dir=str(TUNE_STORE))
    record = {}
    probes0 = probe_run_count()
    reset_counts()
    t0 = time.perf_counter()
    tuned = spgemm_plan(a, a, tile=TILE, group=GROUP, device=dev, cache=cache,
                        autotune={"record": record})
    search_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launched = counts()
    cfg = tuned.tuned_config
    check(cfg is not None and tuned.report.config_source == "tuned", "autotune applied no config")
    check(probe_run_count() - probes0 == cfg.probes > 0, "probe count")
    grid = [(tuple(c["tile"]), c["group"]) for c in record["candidates"]]
    check(sorted({t[0] for t, _ in grid}) == [32, 64, 128]
          and sorted({g for _, g in grid}) == [2, 4, 8] and len(grid) == 9,
          f"the card's grid: {grid}")
    check(all(all(d % 16 == 0 and 16 <= d <= 128 for d in p["tile"]) for p in record["probes"]),
          "a probe ran at a tile K1 refuses")
    check(launched["spgemm_scheduled_batch"] > 0 and launched["spgemm_scheduled"] > 0,
          f"the probes launched {launched}")
    log(f"  search {search_s:.2f} s, {cfg.probes} probe runs; K2 launches "
        f"{launched['spgemm_scheduled_batch']} (batch probes), K1 launches "
        f"{launched['spgemm_scheduled']} (depth probes)")
    best = {}
    for p in record["probes"]:
        key = (tuple(p["tile"]), p["group"])
        best[key] = min(best.get(key, np.inf), p["ms"])
    for c in record["candidates"]:
        key = (tuple(c["tile"]), c["group"])
        ms = f"{best[key]:.3f} ms" if key in best else "pruned"
        log(f"  candidate tile {c['tile'][0]} group {c['group']}: model "
            f"{c['model_s'] * 1e3:.4f} ms, measured (execute_batch of 8) {ms}")
    log("  probes (tile, group, chunk bytes: best ms): " + "; ".join(
        f"{p['tile'][0]},{p['group']},{p['chunk_bytes']}: {p['ms']:.3f}" for p in record["probes"]))
    log(f"  survivors {sorted(best)}; depths (ms per 8-step stream) {record['depths']}")
    log(f"  TunedConfig {json.dumps(cfg.to_meta())}")
    log(f"  winner {cfg.values_per_s:.1f} value sets/s against the default's "
        f"{cfg.default_values_per_s:.1f} (x{cfg.speedup:.3f}); model rank of the winner "
        f"{cfg.model_rank}; ranking agreement {cfg.ranking_agreement:.3f}")
    info.update({"search_s": search_s, "cfg": cfg.to_meta(), "launches": launched,
                 "candidates": record["candidates"], "probes": record["probes"],
                 "depths": record["depths"]})

    untuned = spgemm_plan(a, a, tile=cfg.tile, group=cfg.group, device=dev, cache=PlanCache())
    check(untuned.tuned_config is None and untuned is not tuned, "untuned plan")
    rng = np.random.default_rng(SEED + 11)
    av, bv = (rng.standard_normal((4, a.nnz), dtype=np.float32) for _ in range(2))
    same_csr(tuned.execute(av[0], bv[0]), untuned.execute(av[0], bv[0]), "tuned execute")
    for i, (got, want) in enumerate(zip(tuned.execute_batch(av, bv),
                                        untuned.execute_batch(av, bv))):
        same_csr(got, want, f"tuned execute_batch[{i}]")
    streamed = list(tuned.execute_stream((av[i], bv[i]) for i in range(4)))
    for i, got in enumerate(streamed):
        same_csr(got, untuned.execute(av[i], bv[i]), f"tuned execute_stream[{i}]")
    log(f"  tuned plan (tile {cfg.tile[0]}, group {cfg.group}, depth {cfg.pipeline_depth}): "
        f"execute, execute_batch(4), execute_stream bitwise equal to an untuned plan there")
    del untuned

    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--autotune-restart",
                          str(TUNE_STORE)], capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    check(out.returncode == 0, f"autotune restart process failed:\n{out.stderr[-3000:]}")
    child = json.loads(out.stdout.strip().splitlines()[-1])
    want = dict(cfg.to_meta(), source="persisted")
    check(child["cfg"] == want and child["source"] == "persisted",
          f"autotune restart: {child} against {want}")
    info["restart_process"] = {"wall_s": child_s, "resolve_s": child["resolve_s"]}
    log(f"  second process: the persisted config applied with 0 probes in "
        f"{child['resolve_s']:.2f} s (process {child_s:.1f} s), to_meta equal but the source")

    t0 = time.perf_counter()
    knee = tuning.measure_chunk_knee(device=dev, cases=CARD_KNEE_CASES)
    info["chunk_knee"] = knee
    for s in knee["samples"]:
        log(f"  knee case {s['case']}: per set {s['per_set_bytes'] / 2**20:.2f} MiB, fused "
            f"{s['fused_ms_per_set'] * 1e3:.1f} us per set, split "
            f"{s['split_ms_per_set'] * 1e3:.1f} us (x{s['speedup']:.2f})")
    log(f"  chunk knee on {knee['device']}: {knee['knee_bytes']} bytes per set; chunk sweep "
        + ", ".join(f"{c['chunk']}: {c['ms_per_set'] * 1e3:.1f} us" for c in knee["chunk_sweep"])
        + f"; suggested cuda row {knee['suggested_policy_row']} against the derived (L2) row "
        f"{knee['configured_policy_row']} ({time.perf_counter() - t0:.1f} s)")
    return info, tuned


GW_THREADS, GW_REQUESTS, GW_WINDOW = 2, 64, 8


def request_values(plan, tenant: int, thread: int, i: int):
    """Request ``i`` of a submitter thread: float32 values from a numpy
    seed of (tenant, thread, request)."""
    rng = np.random.default_rng((SEED, tenant, thread, i))
    return (rng.standard_normal(plan.report.nnz_a, dtype=np.float32),
            rng.standard_normal(plan.report.nnz_b, dtype=np.float32))


def sha(c: CSR) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(c.data)).hexdigest()


def serve_traffic(tenants: dict, values: dict, digest: bool):
    """Each tenant's submitter threads send their requests through one
    gateway (``max_batch=4``, ``depth=2``, ``batch_window=0.002``), each
    keeping ``GW_WINDOW`` requests outstanding. With ``digest`` every
    result's SHA-256 is kept (results are dropped either way). Returns
    the gateway's stats, the digests, the wall seconds and the launches."""
    digests, errors = {}, []
    lock = threading.Lock()
    with SpGEMMGateway(cache=PlanCache(), max_batch=4, depth=2, batch_window=0.002) as gw:
        for name, p in tenants.items():
            gw.register_plan(name, p)

        def submitter(name: str, th: int):
            try:
                window = []
                for i in range(GW_REQUESTS + GW_WINDOW):
                    if i < GW_REQUESTS:
                        window.append((i, gw.submit(name, *values[(name, th, i)])))
                    if len(window) > GW_WINDOW or (i >= GW_REQUESTS and window):
                        j, t = window.pop(0)
                        r = t.wait(300)
                        check(r.outcome is Outcome.OK,
                              f"{name} request {j}: {r.outcome} {r.error!r}")
                        if digest:
                            h = sha(r.value)
                            with lock:
                                digests[(name, th, j)] = h
            except BaseException as e:  # reported by the main thread
                errors.append(e)

        threads = [threading.Thread(target=submitter, args=(name, th))
                   for name in tenants for th in range(GW_THREADS)]
        reset_counts()
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        wall_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launched = counts()
        check(not errors, f"a submitter failed: {errors[:1]!r}")
        check(not any(th.is_alive() for th in threads), "a submitter hung")
        stats = gw.stats()
    return stats, digests, wall_s, launched


def phase_gateway(a: CSR, plan, tuned, dev) -> dict:
    """Two tenants on one gateway: "p3da" (phase 4's plan, A·A) and
    "p3da-b2" (A·B2, B2 = ``CHAIN_B``), each with two submitter threads of
    64 requests (values drawn from numpy seeds before the run): a checked
    pass (every result bitwise equal to a direct ``execute``), then a
    timed pass whose stats give requests/s and p50/p99; then a hot
    tenant's backlog against a cold tenant, a byte budget below one batch,
    and an autotuned registration over phase 5h's store."""
    info = {}
    n = a.shape[0]
    b2 = random_coo(n, n, CHAIN_B["density"], CHAIN_B["structure"], seed=CHAIN_B["seed"])
    plan_b2 = spgemm_plan(a, b2, tile=TILE, group=GROUP, device=dev)
    tenants = {"p3da": plan, "p3da-b2": plan_b2}
    values = {(name, th, i): request_values(p, ti, th, i)
              for ti, (name, p) in enumerate(tenants.items())
              for th in range(GW_THREADS) for i in range(GW_REQUESTS)}
    total = GW_THREADS * GW_REQUESTS

    _, digests, check_s, _ = serve_traffic(tenants, values, digest=True)
    t0 = time.perf_counter()
    for key, h in sorted(digests.items()):
        check(sha(tenants[key[0]].execute(*values[key])) == h,
              f"{key}: differs from a direct execute")
    check(len(digests) == 2 * total, f"{len(digests)} results")
    log(f"  checked pass: {len(digests)} results in {check_s:.2f} s, all bitwise equal to a "
        f"direct execute of their values (SHA-256 of C's values; "
        f"{time.perf_counter() - t0:.1f} s)")

    stats, _, wall_s, launched = serve_traffic(tenants, values, digest=False)
    dispatches = batched = 0
    for name, p in tenants.items():
        st = stats["patterns"][name]
        check(st["completed"] == total and st["failed"] == 0 and st["shed_total"] == 0,
              f"{name}: {st}")
        check(st["batch_fill"] > 1.0, f"{name}: batch fill {st['batch_fill']}")
        dispatches += st["dispatches"]
        batched += st["batched_requests"]
        lat = st["latency_s"]
        info[name] = {"requests_per_s": st["throughput_rps"], "p50_ms": lat["p50"] * 1e3,
                      "p99_ms": lat["p99"] * 1e3, "batch_fill": st["batch_fill"],
                      "dispatches": st["dispatches"], "chunk": p._executor.batch_chunk(),
                      "c_bytes": 4 * p.assembly.nnz}
        log(f"  {name}: {st['completed']} requests, {st['throughput_rps']:.1f} requests/s, "
            f"p50 {lat['p50'] * 1e3:.2f} ms, p99 {lat['p99'] * 1e3:.2f} ms, batch fill "
            f"{st['batch_fill']:.2f} over {st['dispatches']} dispatches (K2 chunk "
            f"{info[name]['chunk']}), C {4 * p.assembly.nnz / 1e6:.1f} MB per request")
    # Every dispatch is one batched pipeline submit (a lone request is a
    # batch of one): K2 once per chunk of it, K1 never.
    chunks = {info[name]["chunk"] for name in tenants}
    want_k2 = batched if chunks == {1} else dispatches if min(chunks) >= 4 else None
    check(launched["spgemm_scheduled"] == 0, f"gateway K1 launches {launched}")
    if want_k2 is not None:
        check(launched["spgemm_scheduled_batch"] == want_k2,
              f"gateway K2 launches {launched} against {want_k2}")
    else:
        check(dispatches <= launched["spgemm_scheduled_batch"] <= batched, f"{launched}")
    info.update({"wall_s": wall_s, "k2_launches": launched["spgemm_scheduled_batch"],
                 "dispatches": dispatches, "batched_requests": batched})
    log(f"  timed pass: {2 * total} requests in {wall_s:.2f} s "
        f"({2 * total / wall_s:.1f} requests/s); K2 launches "
        f"{launched['spgemm_scheduled_batch']} over {dispatches} dispatches of {batched} "
        f"requests, K1 launches 0")
    del plan_b2, tenants, values

    # Fairness: a hot tenant's 256 queued requests against a cold one's 8
    # (poisson3Da at a tenth of its size, so that results stay small).
    small = suite_matrix("poisson3Da", scale=0.1, seed=SEED)
    small2 = suite_matrix("poisson3Da", scale=0.1, seed=SEED + 1)
    with SpGEMMGateway(cache=PlanCache(), max_pipelines=2, max_batch=4, batch_window=0.0,
                       start=False) as gw:
        hot = gw.register("hot", small, small, tile=TILE, group=GROUP, device=dev)
        cold = gw.register("cold", small2, small2, tile=TILE, group=GROUP, device=dev)
        hot_t = [gw.submit("hot", *request_values(hot, 2, 0, i)) for i in range(256)]
        cold_t = [gw.submit("cold", *request_values(cold, 3, 0, i)) for i in range(8)]
        gw.start()
        cold_seq = [t.wait(120).seq for t in cold_t]
        hot_seq = [t.wait(120).seq for t in hot_t]
        fair = gw.stats()["patterns"]
    check(all(t.done() and t.wait(0).outcome is Outcome.OK for t in hot_t + cold_t),
          "fairness requests")
    check(max(cold_seq) < 0.5 * max(hot_seq), f"cold finished at {max(cold_seq)}, hot at "
          f"{max(hot_seq)}")
    info["fairness"] = {"cold_last_seq": max(cold_seq), "hot_last_seq": max(hot_seq),
                        "cold_p99_ms": fair["cold"]["latency_s"]["p99"] * 1e3,
                        "hot_p99_ms": fair["hot"]["latency_s"]["p99"] * 1e3}
    log(f"  fairness: 256 hot and 8 cold requests queued; the cold tenant's last completed "
        f"{max(cold_seq)}th of {len(hot_seq) + len(cold_seq)} (hot's last: {max(hot_seq)}); "
        f"p99 cold {info['fairness']['cold_p99_ms']:.2f} ms, hot "
        f"{info['fairness']['hot_p99_ms']:.2f} ms")
    del hot_t, cold_t

    # Overload: a byte budget below one batch sheds, typed, and nothing
    # hangs. A burst queued before the scheduler starts admits exactly one
    # request; a second burst, sent back to back while it runs, sheds what
    # arrives while earlier requests are in flight.
    budget = plan.value_nbytes() * 3 // 2
    burst = [request_values(plan, 0, 9, i) for i in range(16)]
    with SpGEMMGateway(cache=PlanCache(), max_batch=4, max_inflight_bytes=budget,
                       start=False) as gw:
        gw.register_plan("p3da", plan)
        t0 = time.perf_counter()
        tickets = [gw.submit("p3da", *v) for v in burst[:8]]
        queued = [t.wait(0).outcome if t.done() else None for t in tickets]
        gw.start()
        tickets += [gw.submit("p3da", *v) for v in burst[8:]]
        outs = [t.wait(60) for t in tickets]
        shed_s = time.perf_counter() - t0
        over = gw.stats()["patterns"]["p3da"]
    kinds = [r.outcome for r in outs]
    check(queued == [None] + [Outcome.SHED_BYTES] * 7, f"queued burst outcomes {queued}")
    check(set(kinds) <= {Outcome.OK, Outcome.SHED_BYTES} and kinds[0] is Outcome.OK,
          f"overload outcomes {kinds}")
    check(over["shed"].get("shed_bytes", 0) == kinds.count(Outcome.SHED_BYTES),
          f"shed counter {over['shed']}")
    check(all(r.value is None and r.outcome.shed for r in outs if r.outcome is not Outcome.OK),
          "a shed carried a value")
    for i, r in enumerate(outs):
        if r.outcome is Outcome.OK:
            same_csr(r.value, plan.execute(*burst[i]), f"overload {i}")
    info["overload"] = {"ok": kinds.count(Outcome.OK), "shed_bytes": kinds.count(Outcome.SHED_BYTES),
                        "running_burst_shed": kinds[8:].count(Outcome.SHED_BYTES),
                        "s": shed_s, "budget": budget}
    log(f"  overload: budget {budget} B (1.5 requests, below one batch of 4): a queued burst of "
        f"8 admits 1 and sheds 7 (shed_bytes); a running burst of 8 sheds "
        f"{kinds[8:].count(Outcome.SHED_BYTES)}; all 16 resolved in {shed_s:.2f} s; admitted "
        f"results bitwise equal to execute")

    # An autotuned registration over phase 5h's store: zero probes, the
    # tuned depth.
    probes0 = probe_run_count()
    with SpGEMMGateway(cache=PlanCache(disk_dir=str(TUNE_STORE)), depth=2) as gw:
        reg = gw.register("p3da-tuned", a, a, tile=TILE, group=GROUP, device=dev, autotune=True)
        st = gw.stats()["patterns"]["p3da-tuned"]
        r = gw.submit("p3da-tuned", *request_values(reg, 0, 7, 0)).wait(60)
    cfg = tuned.tuned_config
    check(probe_run_count() == probes0, "the autotuned registration ran probes")
    check(st["pipeline_depth"] == cfg.pipeline_depth and st["config_source"] == "persisted"
          and st["tuned"] == dict(cfg.to_meta(), source="persisted"), f"tuned registration {st}")
    check(r.outcome is Outcome.OK, f"tuned request {r.outcome}")
    same_csr(r.value, tuned.execute(*request_values(reg, 0, 7, 0)), "tuned request")
    log(f"  register(autotune=True) over phase 5h's store: 0 probes, source "
        f"{st['config_source']}, pipeline depth {st['pipeline_depth']} (the tuned depth); "
        f"its result bitwise equal to the tuned plan's execute")
    return info


# -- phase 5j: static analysis ---------------------------------------------------

# The analysis CLI's plans (element, block, x4 sharded, rehydrated) at full
# size: tile 32 and group 4, one of the autotuner's card grid configs
# (5h's winner was tile 32), whose block-structural C is smaller than
# tile 64's, so the verifier's passes over it take less time.
ANALYSIS_TILE, ANALYSIS_GROUP, ANALYSIS_SHARDS = 32, 4, 4
ANALYSIS_STORE = ROOT / "build" / "analysis_store"
# OMAR (Eq. 1) of every paper matrix at this PE count.
OMAR_PES = 16


def analysis_oracle(a: COO, b: COO, av, bv) -> CSR:
    """C = A·B on ``a``'s and ``b``'s patterns with values ``av``, ``bv``."""
    from repro_torch.sparse.convert import to_csr

    return spgemm_gustavson(to_csr(COO(a.row, a.col, av, a.shape)),
                            to_csr(COO(b.row, b.col, bv, b.shape)))


def same_trimmed(got: CSR, want: CSR, what: str) -> None:
    """``got`` equals ``want`` bitwise on ``want``'s shape, and stores only
    zeros outside it (a block plan's C spans A's and B's padded block
    rows and block columns)."""
    m, n = want.shape
    indptr = got.indptr[:m + 1]
    inside = got.indices[:indptr[-1]] < n
    trimmed = CSR(indptr - np.concatenate([[0], np.cumsum(
        ~inside)])[indptr], got.indices[:indptr[-1]][inside], got.data[:indptr[-1]][inside],
        want.shape)
    same_csr(trimmed, want, what)
    check(not np.any(got.data[:indptr[-1]][~inside]) and not np.any(got.data[indptr[-1]:]),
          f"{what}: nonzero values in the padding")


def analysis_values(plan, a: COO, b: COO, av, bv):
    """The operand values a validated plan takes for ``av``/``bv``: the
    element vectors, or for a block plan the packed blocks of them."""
    from repro_torch.sparse.convert import bcsr_from_coo, bcsv_from_coo

    if plan._a_scatter is not None:
        return av, bv
    tile, group = plan.report.tile, plan.report.group
    return (bcsv_from_coo(COO(a.row, a.col, av, a.shape), tile[:2], group)[0].blocks,
            bcsr_from_coo(COO(b.row, b.col, bv, b.shape), tile[1:])[0].blocks)


def analysis_lint_grid(dev) -> dict:
    """The launch lint's shared-memory mirror against the library's export
    over every tile K1 takes, both dtypes; then every config of the
    autotuner's card grid against this device's opt-in limit."""
    from repro_torch.analysis.kernel_lint import (
        device_smem_limit, k1_smem_bytes, k1_threads, lint_kernel_module, lint_launch_config)
    from repro_torch.spgemm.autotune import _search_grid

    found = lint_kernel_module()
    check(found == [], f"kernel module lint: {found}")
    lib = _build.load_gustavson()
    limit = device_smem_limit(dev)
    dims = range(16, 129, 16)
    tiles = [(m, k, n) for m in dims for k in dims for n in dims]
    worst = 0
    for code, dtype in ((0, torch.float32), (1, torch.bfloat16)):
        for tile in tiles:
            smem = lib.gustavson_spgemm_smem_bytes(code, *tile)
            check(smem == k1_smem_bytes(dtype, *tile),
                  f"smem mirror at {tile} {dtype}: {k1_smem_bytes(dtype, *tile)} vs {smem}")
            check(lib.gustavson_spgemm_threads(code, *tile) == k1_threads(*tile),
                  f"threads mirror at {tile} {dtype}")
            found = lint_launch_config(tile, dtype, smem_limit=limit)
            check(found == [], f"launch lint at {tile} {dtype}: {found}")
            worst = max(worst, smem)
    grid = _search_grid((TILE,) * 3, GROUP, None, "cuda")
    for tile, group in grid:
        for dtype in (torch.float32, torch.bfloat16):
            found = lint_launch_config(tile, dtype, bsz=8, smem_limit=limit)
            check(found == [], f"autotune grid config {tile} x {group} {dtype}: {found}")
    log(f"  kernel module lint clean; smem mirror equal to gustavson_spgemm_smem_bytes and "
        f"_threads over {len(tiles)} tiles x 2 dtypes (largest {worst} B); opt-in limit "
        f"{limit} B (cudaDevAttrMaxSharedMemoryPerBlockOptin); autotuner card grid "
        f"{sorted({t[0] for t, _ in grid})} x groups {sorted({g for _, g in grid})} lints clean")
    return {"smem_tiles": len(tiles) * 2, "smem_max_bytes": worst, "smem_optin_bytes": limit,
            "autotune_grid": [[list(t), g] for t, g in grid]}


def analysis_matrix(name: str, dev, rng) -> dict:
    """``repro_torch.analysis.check`` over one matrix at full size on the
    card, then every validated plan through K1/K2 against the oracle."""
    from repro_torch.analysis import check as analysis_check

    failures: list = []
    store = ANALYSIS_STORE / name
    shutil.rmtree(store, ignore_errors=True)
    t0 = time.perf_counter()
    plans = analysis_check.check_matrix(
        name, 1.0, ANALYSIS_SHARDS, "auto", failures, device=dev, tile=ANALYSIS_TILE,
        group=ANALYSIS_GROUP, store_dir=store)
    check_s = time.perf_counter() - t0
    check(not failures, f"analysis check {name}: {failures}")
    # The plans hold their operands in canonical (row-major) order.
    a, b = (x.sum_duplicates() for x in analysis_check._operands(name, 1.0))
    av = rng.standard_normal(a.nnz, dtype=np.float32)
    bv = rng.standard_normal(b.nnz, dtype=np.float32)
    info = {"check_s": check_s, "plans": {}}
    first = None
    for label, (plan, rep) in plans.items():
        check(rep.ok and rep.findings == [], f"{name} {label}: {rep.summary()}")
        x, y = analysis_values(plan, a, b, av, bv)
        reset_counts()
        c = plan.execute(x, y)
        batch = plan.execute_batch(np.stack([x, x]), np.stack([y, y]))
        torch.cuda.synchronize()
        launched = counts()
        shards = getattr(plan, "n_shards", 1)
        check(launched["spgemm_scheduled"] == shards, f"{name} {label}: K1 launches {launched}")
        check(launched["spgemm_scheduled_batch"] >= shards,
              f"{name} {label}: K2 launches {launched}")
        if first is None:  # the element plan, against the oracle
            err = compare_to_oracle(c, analysis_oracle(a, b, av, bv),
                                    f"{name} {label} execute")
            first = (c, err)
        else:  # bitwise equal to the element plan's result
            same_trimmed(c, first[0], f"{name} {label} execute vs the element plan")
            err = first[1]
        for i, ci in enumerate(batch):
            same_csr(ci, c, f"{name} {label} execute_batch[{i}]")
        info["plans"][label] = {
            "verify_ms": rep.elapsed_s * 1e3, "checks": len(rep.checks_run),
            "checks_run": rep.checks_run, "check_ms": {
                k: v * 1e3 for k, v in rep.check_seconds.items()},
            "findings": len(rep.findings),
            "triples": plan.report.num_triples, "nnz_c": plan.assembly.nnz,
            "loads": plan.report.loads, "k1_launches": launched["spgemm_scheduled"],
            "k2_launches": launched["spgemm_scheduled_batch"], "max_abs_err": err}
        log(f"  {name} {label}: verify {rep.elapsed_s * 1e3:.1f} ms ({len(rep.checks_run)} checks: "
            f"{', '.join(rep.checks_run)}; {len(rep.findings)} findings), triples "
            f"{plan.report.num_triples}, nnz(C) {plan.assembly.nnz}; execute vs oracle "
            f"max_abs_err {err:.3g}, execute_batch(2) bitwise; K1 {launched['spgemm_scheduled']}, "
            f"K2 {launched['spgemm_scheduled_batch']}")
        log(f"    verify ms by check: " + ", ".join(
            f"{k} {v * 1e3:.1f}" for k, v in rep.check_seconds.items()))
    del plans
    shutil.rmtree(store, ignore_errors=True)
    log(f"  {name}: check (four plans built, verified, linted) {check_s:.1f} s")
    return info


def corrupt_a_slot(store: Path) -> int:
    """Point one A slot of the stored artifact past A, re-signing the
    payload digest so the store's own checks still pass; returns the slot
    written."""
    from repro_torch.spgemm.persist import _META_KEY, _payload_digest

    [path] = sorted(store.glob("*.plan-torch.npz"))
    with np.load(path, allow_pickle=False) as npz:
        arrays = {n: npz[n].copy() for n in npz.files if n != _META_KEY}
        header = json.loads(bytes(np.asarray(npz[_META_KEY])).decode())
    slot = int(header["meta"]["a_shape"][0])
    arrays["sched.a_slot"][0] = slot
    header["digest"] = _payload_digest(arrays, header["meta"])
    arrays[_META_KEY] = np.frombuffer(json.dumps(header).encode(), np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    return slot


def analysis_corrupt(dev, rng) -> dict:
    """A digest-valid artifact whose first A slot points past A: under
    ``validate="deep"`` the loader rejects it and the plan is rebuilt,
    with K1 launched zero times, bitwise equal to a cold build."""
    a = suite_matrix("poisson3Da", scale=1.0, seed=SEED).to_coo()
    store = ANALYSIS_STORE / "corrupt"
    shutil.rmtree(store, ignore_errors=True)
    kw = dict(tile=ANALYSIS_TILE, group=ANALYSIS_GROUP, device=dev)
    cold = spgemm_plan(a, a, cache=PlanCache(disk_dir=str(store)), **kw)
    slot = corrupt_a_slot(store)
    reset_counts()
    cache = PlanCache(disk_dir=str(store))
    plan = spgemm_plan(a, a, cache=cache, validate="deep", **kw)
    torch.cuda.synchronize()
    launched = counts()
    check(launched["spgemm_scheduled"] == 0 and launched["spgemm_scheduled_batch"] == 0,
          f"the corrupted plan launched {launched}")
    stats = cache.stats()
    check(stats["load_failures"] == 1 and plan.report.schedule_builds == 1
          and plan.report.loads == 0, f"corrupted artifact: stats {stats}")
    for f in ("a_slot", "b_slot", "panel", "sub_row", "start"):
        check(np.array_equal(getattr(plan.schedule, f), getattr(cold.schedule, f)),
              f"rebuilt schedule {f} differs from the cold build")
    for f in ("gather", "indptr", "indices"):
        check(np.array_equal(getattr(plan.assembly, f), getattr(cold.assembly, f)),
              f"rebuilt assembly {f} differs from the cold build")
    av = rng.standard_normal(a.nnz, dtype=np.float32)
    bv = rng.standard_normal(a.nnz, dtype=np.float32)
    reset_counts()
    same_csr(plan.execute(av, bv), cold.execute(av, bv), "rebuilt plan vs cold build")
    check(spgemm_scheduled.launches == 2, "rebuilt and cold plans: K1 launches")
    shutil.rmtree(store, ignore_errors=True)
    log(f"  corrupted artifact (sched.a_slot[0] = {slot} = nnzb_a, digest re-signed): rejected "
        f"in the loader (load_failures 1), rebuilt (schedule_builds 1) with 0 K1/K2 launches; "
        f"schedule, assembly and execute bitwise equal to a cold build")
    return {"slot": slot, "load_failures": stats["load_failures"],
            "k1_launches_while_loading": launched["spgemm_scheduled"]}


def analysis_omar() -> dict:
    """OMAR (paper Eq. 1, ``core/buffering.py``) of every paper matrix at
    its published size, at ``OMAR_PES`` PEs, equal to the fetch trace's."""
    from repro_torch.configs.paper_matrices import PAPER_MATRICES
    from repro_torch.core.buffering import omar, omar_from_trace

    out = {}
    for name in PAPER_MATRICES:
        m = suite_matrix(name, scale=1.0, seed=SEED)
        out[name] = omar(m, OMAR_PES)
        check(out[name] == omar_from_trace(m, OMAR_PES),
              f"{name}: Eq. 1 and the fetch trace disagree")
    log(f"  OMAR % (Eq. 1) at {OMAR_PES} PEs: "
        + "; ".join(f"{n} {v:.2f}" for n, v in out.items()))
    return out


def phase_analysis(dev, rng) -> dict:
    from repro_torch.analysis import check as analysis_check

    info = {"lint": analysis_lint_grid(dev)}
    for name in ("poisson3Da", "2cubes_sphere"):
        info[name] = analysis_matrix(name, dev, rng)
    info["corrupt"] = analysis_corrupt(dev, rng)
    failures: list = []
    lock = analysis_check.lock_lint(failures, device=dev)
    check(not failures, f"lock lint on the card: {failures}")
    info["locks"] = lock
    log(f"  lock-order lint on the card: {lock['sites']} sites, "
        f"{sum(len(v) for v in lock['edges'].values())} edges, {lock['requests']} requests "
        f"through the gateway, acyclic")
    info["omar"] = analysis_omar()
    shutil.rmtree(ANALYSIS_STORE, ignore_errors=True)
    return info


# -- phase 9: timings (SpGEMM) ---------------------------------------------------

def kernel_inputs(plan, dev, rng, bsz):
    """The kernel's operands at the main path's shapes: packed blocks
    rebound from fresh values (stacked for ``bsz`` > 1) on the card."""
    ex = plan._executor
    a_sets, b_sets = [], []
    for _ in range(bsz):
        av = torch.from_numpy(rng.standard_normal(plan.report.nnz_a, dtype=np.float32)).to(dev)
        bv = torch.from_numpy(rng.standard_normal(plan.report.nnz_b, dtype=np.float32)).to(dev)
        a_sets.append(torch.cat([av, av.new_zeros(1)]).index_select(0, ex._a_inv))
        b_sets.append(torch.cat([bv, bv.new_zeros(1)]).index_select(0, ex._b_inv))
    a_blocks = torch.cat(a_sets).reshape((bsz * ex.a_shape[0],) + ex.a_shape[1:])
    b_blocks = torch.cat(b_sets).reshape((bsz * ex.b_shape[0],) + ex.b_shape[1:])
    return a_blocks, b_blocks, ex._runs


def bound(plan, bsz) -> tuple:
    """Least time (ms) the card could take for the kernel's work on this
    plan: each input read once (at the plan's value size: 4 bytes, or 2 for
    bfloat16), each float32 output written once, the flops at the card's
    peak for the input type (bfloat16's tensor-core peak for a plan on
    bfloat16 blocks, else float32's); the larger of the two."""
    ex = plan._executor
    bm, bk = ex.a_shape[1], ex.a_shape[2]
    bn = ex.b_shape[2]
    flops = 2.0 * plan.report.num_triples * bm * bk * bn * bsz
    runs = ex._runs
    item_a, item_b = (dt.itemsize for dt in plan.value_dtypes)
    nbytes = bsz * (item_a * np.prod(ex.a_shape) + item_b * np.prod(ex.b_shape)
                    + 4 * plan.report.n_panels * GROUP * bm * bn) \
        + 4 * (runs.ptr.numel() + runs.a_slot.numel() + runs.b_slot.numel())
    bf16 = plan.value_dtypes == (torch.bfloat16, torch.bfloat16)
    t_ops = flops / (PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS) * 1e3
    t_bytes = float(nbytes) / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes"), flops, nbytes


def library_call(a: CSR, dev, rng):
    """cuSPARSE CSR @ CSR through torch.sparse for C = A·A with fresh
    values (int32 indices), checked against the Gustavson oracle; returns
    the call for timing."""
    vals = rng.standard_normal(a.nnz, dtype=np.float32)
    t = torch.sparse_csr_tensor(torch.from_numpy(a.indptr.astype(np.int32)).to(dev),
                                torch.from_numpy(a.indices.astype(np.int32)).to(dev),
                                torch.from_numpy(vals).to(dev), a.shape,
                                check_invariants=False)
    res = t @ t
    crow = res.crow_indices().cpu().numpy()
    rows = np.repeat(np.arange(a.shape[0], dtype=np.int32), np.diff(crow))
    got = CSR.from_coo(COO(rows, res.col_indices().cpu().numpy(), res.values().cpu().numpy(),
                           a.shape).sum_duplicates())
    del res
    av = CSR(a.indptr, a.indices, vals, a.shape)
    compare_to_oracle(got, spgemm_gustavson(av, av), "cuSPARSE CSR @ CSR")
    return lambda: t @ t


def phase_timings(a, plan, launched, chunk, dev, rng):
    entries, extra = [], {}
    a_blocks, b_blocks, runs = kernel_inputs(plan, dev, rng, 1)
    kernel = spgemm_scheduled(a_blocks, b_blocks, runs)
    plain = ref.spgemm_scheduled_ref(a_blocks, b_blocks, runs.a_slot, runs.b_slot,
                                     runs.panel, runs.sub_row, runs.n_panels, runs.group)
    torch.testing.assert_close(kernel, plain, rtol=TOL[torch.float32], atol=TOL[torch.float32])
    err1 = float((kernel - plain).abs().max())
    del kernel, plain
    lib = library_call(a, dev, rng)
    lib_ms = time_ms(lib, reps=10)
    (b_ms, b_by), flops, nbytes = bound(plan, 1)
    k1_ms = time_ms(lambda: spgemm_scheduled(a_blocks, b_blocks, runs), reps=20)
    p1_ms = time_ms(lambda: ref.spgemm_scheduled_ref(
        a_blocks, b_blocks, runs.a_slot, runs.b_slot, runs.panel, runs.sub_row,
        runs.n_panels, runs.group), reps=5)
    log(f"  K1 poisson3Da: {k1_ms:.4f} ms ({flops / k1_ms / 1e9:.1f} TFLOP/s, "
        f"{b_ms / k1_ms:.1%} of the bound), plain {p1_ms:.4f} ms, cuSPARSE {lib_ms:.4f} ms")
    entries.append({
        "name": "spgemm_scheduled", "route": "cuda", "source": SOURCE,
        "replaces": "src/repro/kernels/gustavson_spgemm.py:128",
        "launches": launched["spgemm_scheduled"], "max_abs_err": err1,
        "ms": k1_ms, "plain_ms": p1_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms,
    })

    # K2 at the main path's shape: execute_batch(4) ran chunks of `bsz`.
    bsz = min(4, chunk)
    ab, bb, runs = kernel_inputs(plan, dev, rng, bsz)
    k2 = spgemm_scheduled_batch(ab, bb, runs, bsz=bsz)
    p2 = ref.spgemm_scheduled_batch_ref(ab, bb, runs.a_slot, runs.b_slot, runs.panel,
                                        runs.sub_row, runs.n_panels, runs.group, bsz)
    torch.testing.assert_close(k2, p2, rtol=TOL[torch.float32], atol=TOL[torch.float32])
    err2 = float((k2 - p2).abs().max())
    del k2, p2
    (b2_ms, b2_by), _, _ = bound(plan, bsz)
    k2_ms = time_ms(lambda: spgemm_scheduled_batch(ab, bb, runs, bsz=bsz), reps=20)
    p2_ms = time_ms(lambda: ref.spgemm_scheduled_batch_ref(
        ab, bb, runs.a_slot, runs.b_slot, runs.panel, runs.sub_row, runs.n_panels,
        runs.group, bsz), reps=5)
    # No single torch call runs a batch of sparse products: bsz CSR @ CSR.
    lib2_ms = time_ms(lambda: [lib() for _ in range(bsz)], reps=5)
    log(f"  K2 poisson3Da bsz {bsz}: {k2_ms:.4f} ms, plain {p2_ms:.4f} ms, "
        f"cuSPARSE x{bsz} {lib2_ms:.4f} ms")
    entries.append({
        "name": "spgemm_scheduled_batch", "route": "cuda", "source": SOURCE,
        "replaces": "src/repro/kernels/gustavson_spgemm.py:186",
        "launches": launched["spgemm_scheduled_batch"], "max_abs_err": err2,
        "ms": k2_ms, "plain_ms": p2_ms, "bound_ms": b2_ms, "bound_by": b2_by,
        "library_ms": lib2_ms,
    })
    del ab, bb

    # K2 with the whole batch of 4 in one launch (not the main path's shape).
    ab, bb, runs = kernel_inputs(plan, dev, rng, 4)
    extra["K2_bsz4_ms"] = time_ms(lambda: spgemm_scheduled_batch(ab, bb, runs, bsz=4), reps=10)
    extra["K2_bsz4_bound_ms"] = bound(plan, 4)[0][0]
    del ab, bb

    # End to end, poisson3Da: host values in, host CSR out.
    vals = [rng.standard_normal(a.nnz, dtype=np.float32) for _ in range(2)]
    e2e_ms = host_ms(lambda: plan.execute(vals[0], vals[1]), reps=10)
    batch = rng.standard_normal((4, a.nnz), dtype=np.float32)
    e2e_b_ms = host_ms(lambda: plan.execute_batch(batch, batch), reps=5)
    nnz_c = plan.assembly.nnz
    extra.update({
        "execute_ms": e2e_ms, "execute_values_per_s": nnz_c / (e2e_ms / 1e3),
        "execute_batch4_ms": e2e_b_ms,
        "execute_batch4_values_per_s": 4 * nnz_c / (e2e_b_ms / 1e3),
        "K1_tflops": flops / k1_ms / 1e9, "K1_bound_share": b_ms / k1_ms,
        "K1_flops": flops, "K1_bytes": float(nbytes),
    })
    extra["execute_stages_ms"] = breakdown(plan, dev, rng, reps=5)
    log(f"  execute poisson3Da stages (ms): {extra['execute_stages_ms']}")
    log(f"  execute poisson3Da end to end: {e2e_ms:.3f} ms "
        f"({extra['execute_values_per_s']:.4g} C values/s); execute_batch(4): "
        f"{e2e_b_ms:.3f} ms")
    return entries, extra


def breakdown(plan, dev, rng, reps: int) -> dict:
    """Median time (ms) of each stage of one element-plan ``execute``,
    run stage by stage through the calls ``execute`` makes: host value
    rebind, host-to-device copy of the values, value bind (gather), the
    kernel, the assembly gather, device-to-host copy of C's values, CSR
    wrap. Device stages are timed with CUDA events, the others with the
    host clock around a synchronize. ``bind_batch`` and ``assemble_batch``
    are the batched path's two gathers for one value set."""
    from repro_torch.spgemm.executor import bind_batch_core, bind_core

    ex, r = plan._executor, plan.report
    names = ("host_rebind", "h2d", "bind", "kernel", "assemble", "d2h", "wrap",
             "bind_batch", "assemble_batch")
    runs = {k: [] for k in names}
    for i in range(reps + 1):
        av = rng.standard_normal(r.nnz_a, dtype=np.float32)
        bv = rng.standard_normal(r.nnz_b, dtype=np.float32)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan._rebind(av, plan._a_blocks, plan._a_scatter, r.nnz_a, "a_vals", plan._a_shape,
                     plan._a_dtype)
        plan._rebind(bv, plan._b_blocks, plan._b_scatter, r.nnz_b, "b_vals", plan._b_shape,
                     plan._b_dtype)
        t1 = time.perf_counter()
        a_d, b_d = torch.from_numpy(av).to(dev), torch.from_numpy(bv).to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ev[0].record()
        a_blocks = bind_core(a_d, ex._a_inv, shape=ex.a_shape)
        b_blocks = bind_core(b_d, ex._b_inv, shape=ex.b_shape)
        ev[1].record()
        panels = spgemm_scheduled(a_blocks, b_blocks, ex._runs)
        ev[2].record()
        packed = panels.reshape(-1).index_select(0, ex._gather)
        ev[3].record()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        host = packed.cpu()
        t4 = time.perf_counter()
        plan._wrap_packed(host)
        t5 = time.perf_counter()
        evb = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        evb[0].record()
        bind_batch_core(a_d[None], ex._a_inv, shape=ex.a_shape)
        bind_batch_core(b_d[None], ex._b_inv, shape=ex.b_shape)
        evb[1].record()
        evb[2].record()
        panels.reshape(1, -1).index_select(1, ex._gather)
        evb[3].record()
        torch.cuda.synchronize()
        if i == 0:
            continue  # warm-up
        for k, v in zip(names, ((t1 - t0) * 1e3, (t2 - t1) * 1e3, ev[0].elapsed_time(ev[1]),
                                ev[1].elapsed_time(ev[2]), ev[2].elapsed_time(ev[3]),
                                (t4 - t3) * 1e3, (t5 - t4) * 1e3,
                                evb[0].elapsed_time(evb[1]), evb[2].elapsed_time(evb[3]))):
            runs[k].append(v)
    return {k: float(np.median(v)) for k, v in runs.items()}


def assembly_timings(plan) -> dict:
    """``build_assembly_map`` on the plan's schedule (C blocks ascending:
    the sort-free path) and on the same schedule with its first and last C
    blocks swapped (the sort every plan took before that path), one call
    each on the host clock; both maps bitwise equal to the plan's."""
    s = plan.schedule
    swapped = {f: getattr(s, f).copy() for f in ("c_brow", "c_bcol")}
    for arr in swapped.values():
        arr[[0, -1]] = arr[[-1, 0]]
    out = {}
    for name, sched in (("no_sort", s), ("sort", dataclasses.replace(s, **swapped))):
        t0 = time.perf_counter()
        got = build_assembly_map(sched, (plan._bm, plan._bn), (plan._m, plan._n))
        out[name] = (time.perf_counter() - t0) * 1e3
        for f in ("gather", "indptr", "indices"):
            check(np.array_equal(getattr(got, f), getattr(plan.assembly, f)),
                  f"build_assembly_map ({name}) {f} differs from the plan's")
        del got
    return out


def phase_second_timings(a, plan, dev, rng, extra):
    a_blocks, b_blocks, runs = kernel_inputs(plan, dev, rng, 1)
    (b_ms, b_by), flops, _ = bound(plan, 1)
    k_ms = time_ms(lambda: spgemm_scheduled(a_blocks, b_blocks, runs), reps=5)
    p_ms = time_ms(lambda: ref.spgemm_scheduled_ref(
        a_blocks, b_blocks, runs.a_slot, runs.b_slot, runs.panel, runs.sub_row,
        runs.n_panels, runs.group), reps=3, warmup=1)
    del a_blocks, b_blocks
    lib_ms = time_ms(library_call(a, dev, rng), reps=5)
    vals = [rng.standard_normal(a.nnz, dtype=np.float32) for _ in range(2)]
    e2e_ms = host_ms(lambda: plan.execute(vals[0], vals[1]), reps=3)
    extra["2cubes_assembly_map_ms"] = assembly_timings(plan)
    log(f"  build_assembly_map 2cubes_sphere (host): sort-free "
        f"{extra['2cubes_assembly_map_ms']['no_sort']:.1f} ms, with the sort "
        f"{extra['2cubes_assembly_map_ms']['sort']:.1f} ms; both bitwise equal to the plan's")
    extra["2cubes_execute_stages_ms"] = breakdown(plan, dev, rng, reps=3)
    log(f"  execute 2cubes_sphere stages (ms): {extra['2cubes_execute_stages_ms']}")
    extra.update({
        "2cubes_K1_ms": k_ms, "2cubes_plain_ms": p_ms, "2cubes_bound_ms": b_ms,
        "2cubes_bound_by": b_by, "2cubes_library_ms": lib_ms,
        "2cubes_execute_ms": e2e_ms, "2cubes_K1_tflops": flops / k_ms / 1e9,
    })
    log(f"  K1 2cubes_sphere: {k_ms:.3f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s, "
        f"{b_ms / k_ms:.1%} of the bound {b_ms:.3f} ms, {b_by}), plain {p_ms:.3f} ms, "
        f"cuSPARSE {lib_ms:.3f} ms; execute end to end {e2e_ms:.3f} ms")


# -- phase 6: flash attention against its plain version ------------------------

def attention_inputs(dev, shape, dtype, sq=None, seed=SEED):
    """q [BH, sq or S, D], k and v [BH, S, D], normal, on the card."""
    bh, s, d = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((bh, sq or s, d), generator=g, device=dev).to(dtype)
    k = torch.randn(shape, generator=g, device=dev).to(dtype)
    v = torch.randn(shape, generator=g, device=dev).to(dtype)
    return q, k, v


def attention_check(q, k, v, what: str, **kw) -> torch.Tensor:
    got = flash_attention(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    check(got.dtype == q.dtype and got.shape == q.shape, f"K5 {what}: dtype or shape")
    rtol, atol = ATTN_TOL[q.dtype]
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol, msg=f"K5 {what}")
    log(f"  K5 {what}: max_abs_err {float((got.float() - want).abs().max()):.3g}")
    return got


def phase_attention_checks(dev) -> None:
    for shape in ATTN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                attention_check(*attention_inputs(dev, shape, dtype),
                                f"{shape} {str(dtype)[6:]} causal={causal}", causal=causal)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for window in (64, 128, 1024):
            attention_check(*attention_inputs(dev, (2, 512, 64), dtype),
                            f"(2, 512, 64) {name} window {window}", causal=True, window=window)
        q, k, v = attention_inputs(dev, (1, 512, 64), dtype)
        part = attention_check(q[:, 256:].contiguous(), k, v,
                               f"(1, 512, 64) {name} rows 256.. q_offset 256",
                               causal=True, q_offset=256)
        full = ref.flash_attention_ref(q, k, v, causal=True)
        rtol, atol = ATTN_TOL[dtype]
        torch.testing.assert_close(part.float(), full[:, 256:], rtol=rtol, atol=atol,
                                   msg="K5 q_offset rows against one-shot attention")
        # Row i sees keys in (i + 136, i + 200] of 0..255: rows 119.. see
        # none, and the first kv tiles of every row are fully masked.
        q, k, v = attention_inputs(dev, (2, 256, 64), dtype, sq=128)
        got = attention_check(q, k, v, f"(2, 128 of 256, 64) {name} window 64 q_offset 200",
                              causal=True, window=64, q_offset=200)
        check(bool(torch.all(got[:, 119:] == 0)) and bool(torch.isfinite(got).all()),
              "K5 rows without a visible key are not 0")
        # Ragged lengths and head widths below the kernels' own (zero-padded).
        for sq, skv, d in ((65, 130, 72), (100, 200, 8), (64, 64, 256)):
            q, k, v = attention_inputs(dev, (3, skv, d), dtype, sq=sq)
            attention_check(q, k, v, f"({sq} of {skv}, D {d}) {name} q_offset {skv - sq}",
                            causal=True, q_offset=skv - sq)


# -- phases 7-8: granite-3-2b -------------------------------------------------

def lm_tokens(cfg, dev, seq: int = LM_SEQ) -> torch.Tensor:
    rng = np.random.default_rng(SEED)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (LM_BATCH, seq))).to(dev)


def plain_attention(q, k, v, causal=True, window=None, q_offset=0, backend="auto"):
    """``ops.attention`` with the plain version in place of the kernel."""
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset).to(q.dtype)


def plain_grouped_matmul(x, w, tile_expert, *, tm=128, backend="auto"):
    """``ops.grouped_matmul`` with the plain version in place of the kernel."""
    return ref.moe_gmm_ref(x, w, tile_expert, tm)


@contextlib.contextmanager
def plain_kernels_in_place():
    """The model's dense comparison: its attention and its expert matmuls
    through the plain versions, for this script only (the package has no
    such switch)."""
    real = ops.attention, ops.grouped_matmul
    ops.attention, ops.grouped_matmul = plain_attention, plain_grouped_matmul
    try:
        yield
    finally:
        ops.attention, ops.grouped_matmul = real


@contextlib.contextmanager
def recording_routes(store: list):
    """Append the experts every MoE layer chooses ([T, k]) to ``store``."""
    real = moe.route

    def spy(p, xf, cfg):
        out = real(p, xf, cfg)
        store.append(out[1])
        return out

    moe.route = spy
    try:
        yield
    finally:
        moe.route = real


def moe_layers(cfg) -> int:
    return sum(cfg.block_pattern[i % cfg.period].ff == "moe" for i in range(cfg.n_layers))


def attention_layers(cfg) -> int:
    return sum(cfg.block_pattern[i % cfg.period].mixer == "attn" for i in range(cfg.n_layers))


def check_launches(launched: dict, cfg, what: str) -> None:
    """One K5 launch per attention layer and three K4 launches per MoE
    layer; with a bfloat16 compute dtype every one of them on the
    tensor-core kernels, with float32 none."""
    check(launched["flash_attention"] == attention_layers(cfg)
          and launched["moe_gmm"] == 3 * moe_layers(cfg),
          f"{what}: launches {launched} for {cfg.n_layers} layers")
    bf16 = cfg.dtype == "bfloat16"
    for name in ("flash_attention", "moe_gmm"):
        check(launched[f"{name}_bf16"] == (launched[name] if bf16 else 0),
              f"{what}: {name} launches {launched} with compute dtype {cfg.dtype}")


def model_seq(cfg, batch: dict) -> tuple:
    """(batch, sequence) of the model's positions for an input batch:
    frames (audio), patches and text (vision), or tokens."""
    if cfg.frontend == "audio":
        return tuple(batch["feats"].shape[:2])
    b, s = batch["tokens"].shape
    return b, s + (cfg.num_patches if cfg.frontend == "vision" else 0)


def kernel_and_dense_logits(params, cfg, batch: dict):
    """All-position logits of ``batch`` (tokens and/or feats) through the
    kernels, then through the plain versions, and the experts each run's
    MoE layers chose."""
    routes, plain_routes = [], []
    reset_counts()
    with torch.no_grad():
        with recording_routes(routes):
            full, _ = tr.forward(params, cfg, **batch)
        torch.cuda.synchronize()
        launched = counts()
        with plain_kernels_in_place(), recording_routes(plain_routes):
            dense, _ = tr.forward(params, cfg, **batch)
    torch.cuda.synchronize()
    check_launches(launched, cfg, "the forward")
    for name, x in (("kernel", full), ("dense", dense)):
        check(tuple(x.shape) == model_seq(cfg, batch) + (cfg.vocab_padded,)
              and bool(torch.isfinite(x[..., :cfg.vocab]).all()), f"{name} logits")
    return full, dense, routes, plain_routes


def prefill_main_path(params, cfg, batch: dict) -> dict:
    """The main path: ``make_prefill_step`` once on ``batch`` (tokens
    and/or feats); returns its launches."""
    prefill = make_prefill_step(cfg)
    reset_counts()
    last = prefill(params, batch)
    torch.cuda.synchronize()
    launched = counts()
    check_launches(launched, cfg, "prefill")
    check(tuple(last.shape) == (model_seq(cfg, batch)[0], cfg.vocab_padded)
          and bool(torch.isfinite(last[:, :cfg.vocab]).all()), "prefill logits")
    return launched


def teacher_forced_decode(params, cfg, tokens, full, dev, n=DECODE_TOKENS) -> tuple:
    """``decode_step`` at batch 1 over the first ``n`` tokens of sequence
    0, against the prefill's logits of those positions; returns (max abs
    difference, ms per step). Gated at LM_TOL."""
    cache = tr.init_cache(cfg, 1, n, device=dev)
    step = make_decode_step(cfg)
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(n):
        logits, cache = step(params, cache, tokens[:1, t:t + 1])
        outs.append(logits[:, 0])
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    dec = torch.stack(outs, dim=1)
    derr = float((dec.float() - full[:1, :n].float()).abs().max())
    log(f"  teacher-forced decode of {n} tokens (batch 1): max_abs_err "
        f"{derr:.3g} against the prefill's logits; {dec_s / n * 1e3:.2f} ms "
        f"per step")
    torch.testing.assert_close(dec, full[:1, :n], rtol=LM_TOL, atol=LM_TOL,
                               msg="teacher-forced decode against the prefill's logits")
    return derr, dec_s / n * 1e3


def phase_lm_float32(dev):
    cfg = get_config(LM_ARCH).with_(dtype="float32")
    t0 = time.perf_counter()
    params = tr.init_lm(SEED, cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"  {LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"({cfg.n_kv_heads} kv) of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab} "
        f"(padded {cfg.vocab_padded}); {n_params} float32 parameters drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    tokens = lm_tokens(cfg, dev)
    launches = prefill_main_path(params, cfg, {"tokens": tokens})["flash_attention"]
    log(f"  prefill {LM_BATCH} x {LM_SEQ} (make_prefill_step): K5 launches {launches}")
    full, dense, _, _ = kernel_and_dense_logits(params, cfg, {"tokens": tokens})
    err = float((full - dense).abs().max())
    torch.testing.assert_close(full, dense, rtol=LM_TOL, atol=LM_TOL,
                               msg="float32 logits: kernel against dense path")
    log(f"  all-position logits, kernel vs dense path: max_abs_err {err:.3g} "
        f"(bound {LM_TOL}); logit range [{float(full[..., :cfg.vocab].min()):.3g}, "
        f"{float(full[..., :cfg.vocab].max()):.3g}]")
    del dense
    derr, dec_ms = teacher_forced_decode(params, cfg, tokens, full, dev)
    del full
    params16 = cast_params(params, torch.bfloat16)
    del params
    torch.cuda.empty_cache()
    return params16, {
        "lm_params": n_params, "f32_prefill_k5_launches": launches,
        "f32_kernel_vs_dense_max_abs": err, "f32_decode_vs_prefill_max_abs": derr,
        "f32_decode_ms_per_step_batch1": dec_ms,
    }


def logit_drift(full, dense, v) -> tuple:
    """Largest |logit difference| and the share of positions whose greedy
    token agrees, one sequence at a time (a float32 copy of all of
    qwen3's logits would take 5 GB each)."""
    dmax, agree = 0.0, 0.0
    for b in range(full.shape[0]):
        a, d = full[b, :, :v].float(), dense[b, :, :v].float()
        dmax = max(dmax, float((a - d).abs().max()))
        agree += float((a.argmax(-1) == d.argmax(-1)).float().sum())
    return dmax, agree / (full.shape[0] * full.shape[1])


@contextlib.contextmanager
def torch_attention_forbidden():
    """Fail if ``attn_forward`` takes one of its torch branches (dense or
    blocked): on the card every prefill runs K5, at any length."""
    real = attention._gqa_scores_apply

    def refuse(*_a, **_k):
        raise AssertionError("a torch attention path ran on the card")

    attention._gqa_scores_apply = refuse
    try:
        yield
    finally:
        attention._gqa_scores_apply = real


def serve_requests(server, cfg) -> dict:
    """``server`` answers 8 requests (8 prompt tokens from a numpy seed,
    16 new tokens each): every answer checked in full; the times."""
    rng = np.random.default_rng(SEED)
    for i in range(8):
        server.submit(Request(i, rng.integers(0, cfg.vocab, 8).tolist(), 16))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = server.run_until_done()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    check(len(done) == 8 and all(r.done and len(r.out) == 16 for r in done),
          "BatchedServer did not answer every request in full")
    check(all(0 <= t < cfg.vocab for r in done for t in r.out), "BatchedServer token ids")
    st = server.stats
    log(f"  BatchedServer(batch_slots=4, max_seq=256): {len(done)} requests, {st['tokens']} "
        f"tokens in {st['steps']} steps, {serve_s:.3f} s: {st['tokens'] / serve_s:.1f} "
        f"tokens/s, {serve_s / st['steps'] * 1e3:.2f} ms per step")
    log("  first requests: " + "; ".join(f"{r.rid}: {r.out[:6]}" for r in done[:2]))
    return {"serve_s": serve_s, "serve_steps": st["steps"], "serve_tokens": st["tokens"],
            "serve_tokens_per_s": st["tokens"] / serve_s,
            "serve_ms_per_step": serve_s / st["steps"] * 1e3}


def phase_lm_bfloat16(params16, dev) -> dict:
    cfg = get_config(LM_ARCH)
    info = {}
    for seq in (LM_SEQ, LM_SEQ_RAGGED):
        tokens = lm_tokens(cfg, dev, seq)
        with torch_attention_forbidden():
            launches = prefill_main_path(params16, cfg, {"tokens": tokens})["flash_attention"]
            log(f"  prefill {LM_BATCH} x {seq} (make_prefill_step): K5 launches {launches}, "
                f"no torch attention path")
            full, dense, _, _ = kernel_and_dense_logits(params16, cfg, {"tokens": tokens})
        dmax, agree = logit_drift(full, dense, cfg.vocab)
        log(f"  all-position logits, kernel vs dense path: max |dlogit| {dmax:.3g}; greedy "
            f"tokens agree at {agree:.4%} of {LM_BATCH * seq} positions")
        del full, dense
        tag = "bf16" if seq == LM_SEQ else f"bf16_s{seq}"
        info.update({f"{tag}_prefill_k5_launches": launches, f"{tag}_kernel_vs_dense_max_abs": dmax,
                     f"{tag}_greedy_agreement": agree})
    prefill = make_prefill_step(cfg)
    info[f"prefill_bf16_s{LM_SEQ_RAGGED}_ms"] = host_ms(
        lambda: prefill(params16, {"tokens": tokens}), reps=5)
    log(f"  prefill {LM_BATCH} x {LM_SEQ_RAGGED}, bf16: "
        f"{info[f'prefill_bf16_s{LM_SEQ_RAGGED}_ms']:.2f} ms (host clock, median of 5)")
    server = BatchedServer(cfg, batch_slots=4, max_seq=256, seed=SEED, device=dev)
    info.update(serve_requests(server, cfg))
    del server
    torch.cuda.empty_cache()
    return info


def attention_bound(bh, s, d, itemsize, causal=True, window=None) -> tuple:
    """Least time (ms) for attention over [bh, s, d]: 4*d flops per visible
    (q, k) pair at the bf16 tensor-core peak, against q, k, v read once and
    o written once at the memory rate; the larger of the two. Row i sees
    i + 1 keys (causal, at most ``window`` of them) or all s."""
    if not causal:
        pairs = s * s
    else:
        w = min(window or s, s)
        pairs = w * (w + 1) // 2 + (s - w) * w
    flops = 4.0 * d * pairs * bh
    nbytes = 4.0 * bh * s * d * itemsize
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes"), flops


def device_busy(fn, reps: int, match: str = "", warmup: int = 1, split: tuple = ()) -> dict:
    """``reps`` calls of ``fn`` unprofiled, then ``reps`` more under
    torch.profiler: the wall time per call of each window, the device's
    kernel time per call, kernels per call and the five kernels that take
    the most time. Recording every op costs host time, so the profiled
    window's idle share is an upper bound; ``idle_share_unprofiled``
    divides the same device time by the adjacent unprofiled window's wall
    time, an estimate of the idle share without the profiler.
    ``matched_ms``: the device time per call of the kernels whose name
    holds ``match``; ``split_ms``, with ``split``: the same for each of
    its strings. ``warmup`` calls run first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    plain_wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    matched_us = sum(us for name, us in by_name.items() if match and match in name)
    return {"wall_ms": wall_us / reps / 1e3, "device_ms": busy_us / reps / 1e3,
            "matched_ms": matched_us / reps / 1e3, "idle_share": 1.0 - busy_us / wall_us,
            "unprofiled_wall_ms": plain_wall_us / reps / 1e3,
            "idle_share_unprofiled": max(0.0, 1.0 - busy_us / plain_wall_us),
            "kernels_per_call": len(kernels) / reps,
            "top_ms": [[name[:80], us / reps / 1e3] for name, us in top],
            **({"split_ms": {key: sum(us for name, us in by_name.items() if key in name)
                             / reps / 1e3 for key in split}} if split else {})}


def phase_lm_timings(params16, lm, dev, extra) -> dict:
    """K5 at the prefill's shape (bf16, causal) against its plain version,
    SDPA and its bound; then prefill and decode end to end."""
    import torch.nn.functional as F

    cfg = get_config(LM_ARCH)
    bh, s, d = LM_BATCH * cfg.n_heads, LM_SEQ, cfg.head_dim
    q, k, v = attention_inputs(dev, (bh, s, d), torch.bfloat16)
    got = flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    rtol, atol = ATTN_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol, msg="K5 at the LM shape")
    err = float((got.float() - want).abs().max())
    del want

    def sdpa():
        return F.scaled_dot_product_attention(q[None], k[None], v[None], is_causal=True)

    lib_out = sdpa()[0].float()
    sdpa_err = float((lib_out - got.float()).abs().max())
    torch.testing.assert_close(lib_out, got.float(), rtol=SDPA_TOL, atol=SDPA_TOL,
                               msg="SDPA against K5")
    del lib_out
    k5_ms = time_ms(lambda: flash_attention(q, k, v, causal=True), reps=20)
    plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True), reps=5)
    sdpa_ms = time_ms(sdpa, reps=20)
    (b_ms, b_by), flops = attention_bound(bh, s, d, q.element_size())
    q32, k32, v32 = (x.float() for x in (q, k, v))
    k5_f32_ms = time_ms(lambda: flash_attention(q32, k32, v32, causal=True), reps=10)
    del q32, k32, v32
    log(f"  K5 bf16 [{bh}, {s}, {d}] causal: {k5_ms:.4f} ms ({flops / k5_ms / 1e9:.1f} "
        f"TFLOP/s, {b_ms / k5_ms:.1%} of the bound {b_ms:.4f} ms, {b_by}); plain "
        f"{plain_ms:.4f} ms; SDPA {sdpa_ms:.4f} ms (K5 / SDPA {k5_ms / sdpa_ms:.2f}x; max "
        f"|SDPA - K5| {sdpa_err:.3g}); float32 K5 {k5_f32_ms:.4f} ms")

    tokens = lm_tokens(cfg, dev)
    prefill = make_prefill_step(cfg)
    pre_ms = host_ms(lambda: prefill(params16, {"tokens": tokens}), reps=5)
    step = make_decode_step(cfg)
    state = {"cache": tr.init_cache(cfg, LM_BATCH, 256, device=dev)}

    def decode_once():
        _, state["cache"] = step(params16, state["cache"], tokens[:, :1])

    dec_ms = host_ms(decode_once, reps=20, warmup=2)
    prof_prefill = device_busy(lambda: prefill(params16, {"tokens": tokens}), reps=2)
    prof_decode = device_busy(decode_once, reps=10)
    for what, prof in (("prefill", prof_prefill), ("decode step", prof_decode)):
        log(f"  profiled {what}: wall {prof['wall_ms']:.2f} ms, device busy "
            f"{prof['device_ms']:.2f} ms (idle {prof['idle_share']:.1%}); unprofiled "
            f"wall {prof['unprofiled_wall_ms']:.2f} ms (idle ~"
            f"{prof['idle_share_unprofiled']:.1%}); {prof['kernels_per_call']:.0f} kernels; "
            f"top {prof['top_ms']}")
    extra.update(lm)
    extra.update({
        "K5_ms": k5_ms, "K5_plain_ms": plain_ms, "K5_sdpa_ms": sdpa_ms, "K5_bound_ms": b_ms,
        "K5_bound_by": b_by, "K5_tflops": flops / k5_ms / 1e9, "K5_bound_share": b_ms / k5_ms,
        "K5_f32_ms": k5_f32_ms, "K5_sdpa_max_abs": sdpa_err, "prefill_bf16_ms": pre_ms,
        "prefill_tokens_per_s": LM_BATCH * LM_SEQ / (pre_ms / 1e3),
        "prefill_attention_share": cfg.n_layers * k5_ms / pre_ms,
        "decode_bf16_ms_per_step": dec_ms, "decode_tokens_per_s": LM_BATCH / (dec_ms / 1e3),
        "profile_prefill": prof_prefill, "profile_decode": prof_decode,
    })
    log(f"  prefill bf16 {LM_BATCH} x {LM_SEQ}: {pre_ms:.2f} ms "
        f"({extra['prefill_tokens_per_s']:.0f} tokens/s), K5 {cfg.n_layers} x {k5_ms:.3f} ms "
        f"= {extra['prefill_attention_share']:.1%} of it; decode step bf16 batch "
        f"{LM_BATCH}: {dec_ms:.2f} ms ({extra['decode_tokens_per_s']:.1f} tokens/s)")
    return {
        "name": "flash_attention", "route": "cuda", "source": SOURCE_K5,
        "replaces": "src/repro/kernels/flash_attention.py:94",
        "launches": lm["bf16_prefill_k5_launches"], "max_abs_err": err,
        "ms": k5_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": sdpa_ms,
    }


# -- phase 10: block-sparse SpMM (K3) ------------------------------------------

def bsr_weight(k, n, bk, bn, seed, integer=False, kill_panel=None):
    """A weight of the JAX package's K3 tests (density 0.5 from a numpy
    seed), dense and as BCSV."""
    wd = random_block_sparse(k, n, (bk, bn), 0.5, seed=seed)
    if kill_panel is not None:
        wd[:, kill_panel * bn:(kill_panel + 1) * bn] = 0.0
    if integer:
        rng = np.random.default_rng(seed + 100)
        wd = np.where(wd != 0, rng.integers(-3, 4, wd.shape), 0).astype(np.float32)
    return wd, to_bcsv(wd, (bk, bn), group=1)


def bsr_check(x, w: BCSV, what: str) -> tuple:
    """K3 through ``ops.sparse_dense_matmul`` against its plain version on
    the same operands (W's blocks in x's dtype on the card)."""
    got = ops.sparse_dense_matmul(x, w)
    blocks = torch.from_numpy(w.blocks).to(x.device, x.dtype)
    want = ref.bsr_spmm_ref(x, blocks, w.brow, w.bcol, w.shape[1])
    torch.cuda.synchronize()
    check(got.dtype == torch.float32 and got.shape == want.shape, f"K3 {what}: dtype or shape")
    err = float((got - want).abs().max())
    log(f"  K3 {what}: max_abs_err {err:.3g}")
    torch.testing.assert_close(got, want, rtol=BSR_TOL, atol=BSR_TOL, msg=f"K3 {what}")
    return got, err


def granite_sparse_weight(dev) -> BCSV:
    """granite-3-2b's SparseLinear down projection at full width: the block
    mask from ``sparse_block_mask`` (a generator on the card, seed 0) and
    normal block values from a numpy seed, scaled so outputs are of order
    1. Row-major mask order is BCSV's order for group 1."""
    c = BSR_FULL
    b = c["block"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    mask = sparse_block_mask(gen, c["k"], c["n"], b, c["density"]).cpu().numpy()
    brow, bcol = np.nonzero(mask)
    per_panel = float(mask.sum(0).mean())
    blocks = np.random.default_rng(SEED).standard_normal((brow.size, b, b), dtype=np.float32)
    blocks *= np.float32(1.0 / np.sqrt(b * per_panel))
    group_ptr = np.concatenate([[0], np.cumsum(np.bincount(brow, minlength=mask.shape[0]))])
    return BCSV(blocks, brow, bcol, group_ptr, (c["k"], c["n"]), 1)


def bsr_bound(m, n, w: BCSV, itemsize) -> tuple:
    """Least time (ms) for y = x @ W: 2*M*bk*bn flops per block at the
    tensor-core peak of the input type (bf16) or the float32 peak, against
    x's block columns that W uses, W's blocks and their indices read once
    and y (float32) written once; the larger of the two."""
    bk, bn = w.block_shape
    flops = 2.0 * m * bk * bn * w.nnzb
    used_cols = np.unique(w.brow).size * bk
    nbytes = itemsize * (m * used_cols + w.nnzb * bk * bn) + 4.0 * m * n + 4.0 * 2 * w.nnzb
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes"), flops


def refuses_grad(call, what: str) -> None:
    """``call`` (a K3 or K4 entry point on CUDA operands that require
    grad) must raise, launching nothing: the kernel's output would carry
    no gradient."""
    before = counts()
    try:
        call()
    except NotImplementedError as e:
        check(counts() == before, f"{what}: launched while refusing")
        log(f"  {what} on CUDA operands that require grad: refused ({e})")
        return
    raise AssertionError(f"{what} accepted CUDA operands that require grad")


def phase_bsr(dev) -> dict:
    for m, k, n, bk, bn in BSR_SHAPES:
        x = np.random.default_rng(0).standard_normal((m, k), dtype=np.float32)
        _, w = bsr_weight(k, n, bk, bn, seed=7)
        for dtype in (torch.float32, torch.bfloat16):
            bsr_check(torch.from_numpy(x).to(dev, dtype), w,
                      f"({m}, {k}, {n}) blocks ({bk}, {bn}) {str(dtype)[6:]}")
    # bf16 blocks whose rows the wrapper pads (bn % 8 != 0; TMA reads
    # 16-byte rows).
    for m, bn in ((100, 20), (64, 132)):
        x = np.random.default_rng(2).standard_normal((m, 96), dtype=np.float32)
        _, w = bsr_weight(96, 3 * bn, 32, bn, seed=12)
        bsr_check(torch.from_numpy(x).to(dev, torch.bfloat16), w,
                  f"({m}, 96, {3 * bn}) blocks (32, {bn}) bfloat16, rows padded")
    _, w = bsr_weight(256, 512, 128, 128, seed=8, kill_panel=1)
    x = np.random.default_rng(1).standard_normal((64, 256), dtype=np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        got, _ = bsr_check(torch.from_numpy(x).to(dev, dtype), w,
                           f"(64, 256, 512) column panel 1 empty {str(dtype)[6:]}")
        check(bool((got[:, 128:256] == 0).all()), "K3: the empty column panel is not zero")
    wd, w = bsr_weight(384, 512, 128, 128, seed=5, integer=True)
    xi = np.random.default_rng(3).integers(-3, 4, (200, 384)).astype(np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        got = ops.sparse_dense_matmul(torch.from_numpy(xi).to(dev, dtype), w)
        check(torch.equal(got.cpu(), torch.from_numpy(xi @ wd)),
              f"K3 small integers not bitwise in {dtype}")
        log(f"  K3 (200, 384, 512) {str(dtype)[6:]} small integers: bitwise equal to x @ W")

    _, w = bsr_weight(256, 256, 128, 128, seed=7)
    xg = torch.from_numpy(x).to(dev).requires_grad_()
    refuses_grad(lambda: ops.sparse_dense_matmul(xg, w), "K3 ops.sparse_dense_matmul")

    # The main path's shape: granite-3-2b's SparseLinear down projection.
    c = BSR_FULL
    w = granite_sparse_weight(dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((c["m"], c["k"]), generator=g, device=dev).to(torch.bfloat16)
    reset_counts()
    y = ops.sparse_dense_matmul(x, w)
    torch.cuda.synchronize()
    launched = counts()
    launches = launched["bsr_spmm"]
    check(launches == 1 and launched["bsr_spmm_bf16"] == 1,
          f"K3 launches in ops.sparse_dense_matmul: {launched}")
    blocks = torch.from_numpy(w.blocks).to(dev, torch.bfloat16)
    want = ref.bsr_spmm_ref(x, blocks, w.brow, w.bcol, c["n"])
    err = float((y - want).abs().max())
    log(f"  K3 granite-3-2b SparseLinear [{c['m']}, {c['k']}] x [{c['k']}, {c['n']}] bf16, "
        f"{w.nnzb} blocks of {c['block']}^2 (density {w.nnzb / (c['k'] * c['n'] / c['block'] ** 2):.4f}):"
        f" ops.sparse_dense_matmul launches {launches}, max_abs_err {err:.3g} vs plain "
        f"(|y| max {float(want.abs().max()):.3g})")
    torch.testing.assert_close(y, want, rtol=BSR_TOL, atol=BSR_TOL, msg="K3 at granite's shape")
    del want
    # Operands as the kernel takes them, its indices staged on the card
    # once, for timing the kernel alone.
    order = np.lexsort((w.brow, w.bcol))
    brow, bcol = w.brow[order], w.bcol[order]
    sorted_blocks = blocks[torch.from_numpy(order).to(dev)].contiguous()
    b = c["block"]
    index = stage_bsr_index(brow, bcol, k_blocks=c["k"] // b, n_panels=c["n"] // b, device=dev)
    check(torch.equal(bsr_spmm_staged(x, sorted_blocks, index, n=c["n"]), y),
          "K3 on staged indices differs from ops.sparse_dense_matmul")
    kernel = lambda: bsr_spmm_staged(x, sorted_blocks, index, n=c["n"])  # noqa: E731
    # The yardstick: the reference's serving path, a dense product with the
    # masked weight (cuBLAS bf16); the port never calls it.
    dense_w = torch.zeros((c["k"] // b, c["n"] // b, b, b), dtype=torch.bfloat16, device=dev)
    dense_w[torch.from_numpy(w.brow).long(), torch.from_numpy(w.bcol).long()] = blocks
    dense_w = dense_w.permute(0, 2, 1, 3).reshape(c["k"], c["n"])
    lib_err = float((torch.matmul(x, dense_w).float() - y).abs().max())
    check(lib_err <= LIB_TOL * max(1.0, float(y.abs().max())), f"matmul vs K3: {lib_err}")
    (b_ms, b_by), flops = bsr_bound(c["m"], c["n"], w, 2)
    # Kernel and yardstick in turns (matmul, kernel, kernel, matmul), one
    # call per event pair as every kernel here is timed; each time is the
    # median of its two turns' samples.
    matmul = lambda: torch.matmul(x, dense_w)  # noqa: E731
    lib_a = time_samples(matmul, reps=10)
    k_a = time_samples(kernel, reps=10)
    k_b = time_samples(kernel, reps=10)
    lib_b = time_samples(matmul, reps=10)
    k_ms, lib_ms = float(np.median(k_a + k_b)), float(np.median(lib_a + lib_b))
    # The wrapper call that stages its indices on every call, as K3's
    # timings before the staged split measured it.
    flags = np.zeros(w.nnzb, np.int32)
    wrap_ms = time_ms(lambda: bsr_spmm(x, sorted_blocks, brow, bcol, flags, n=c["n"]), reps=10)
    ops_ms = time_ms(lambda: ops.sparse_dense_matmul(x, w), reps=10)
    p_ms = time_ms(lambda: ref.bsr_spmm_ref(x, blocks, w.brow, w.bcol, c["n"]), reps=5)
    log(f"  K3 timing, kernel alone on staged indices: {k_ms:.4f} ms (turns "
        f"{np.median(k_a):.4f} / {np.median(k_b):.4f}; {flops / k_ms / 1e9:.1f} TFLOP/s, "
        f"{b_ms / k_ms:.2%} of the bound {b_ms:.4f} ms, {b_by}); torch.matmul with the masked "
        f"dense weight {lib_ms:.4f} ms (turns {np.median(lib_a):.4f} / {np.median(lib_b):.4f}; "
        f"K3 / matmul {k_ms / lib_ms:.2f}x; max |matmul - K3| {lib_err:.3g}); the wrapper "
        f"bsr_spmm (index staging included) {wrap_ms:.4f} ms; ops.sparse_dense_matmul (host staging included) {ops_ms:.4f} ms; plain {p_ms:.4f} ms")
    return {
        "name": "bsr_spmm", "route": "cuda", "source": SOURCE_K3,
        "replaces": "src/repro/kernels/bsr_spmm.py:77", "launches": launches,
        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms,
    }, {"K3_nnzb": w.nnzb, "K3_tflops": flops / k_ms / 1e9, "K3_matmul_max_abs": lib_err,
        "K3_ops_ms": ops_ms, "K3_wrapper_ms": wrap_ms, "K3_kernel_ms_turns": [float(np.median(k_a)), float(np.median(k_b))],
        "K3_matmul_ms_turns": [float(np.median(lib_a)), float(np.median(lib_b))],
        "K3_bound_share": b_ms / k_ms}


# -- phase 11: grouped matmul (K4) ---------------------------------------------

def gmm_inputs(dev, t, d, f, e, tm, dtype, seed, integer=False, te=None):
    """x [t, d], w [e, d, f] on the card (normal, w scaled by 1/sqrt(d) so
    outputs are of order 1; or small integers) and sorted tile experts."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if integer:
        x = torch.randint(-3, 4, (t, d), generator=g, device=dev).float()
        w = torch.randint(-3, 4, (e, d, f), generator=g, device=dev).float()
    else:
        x = torch.randn((t, d), generator=g, device=dev)
        w = torch.randn((e, d, f), generator=g, device=dev) / d ** 0.5
    if te is None:
        te = torch.randint(0, e, (t // tm,), generator=g, device=dev).sort().values.int()
    return x.to(dtype), w.to(dtype), te


def gmm_check(x, w, te, tm, what) -> tuple:
    got = ops.grouped_matmul(x, w, te, tm=tm)
    want = ref.moe_gmm_ref(x, w, te, tm)
    torch.cuda.synchronize()
    check(got.dtype == torch.float32 and got.shape == want.shape, f"K4 {what}: dtype or shape")
    err = float((got - want).abs().max())
    log(f"  K4 {what}: max_abs_err {err:.3g}")
    torch.testing.assert_close(got, want, rtol=GMM_TOL, atol=GMM_TOL, msg=f"K4 {what}")
    return got, err


def gmm_bound(t, d, f, e, tm, itemsize) -> tuple:
    """Least time (ms) for the grouped matmul: 2*T*D*F flops at the
    tensor-core peak of the input type (bf16) or the float32 peak, against
    x, w and the tile experts read once and out (float32) written once."""
    flops = 2.0 * t * d * f
    nbytes = itemsize * (t * d + e * d * f) + 4.0 * t * f + 4.0 * t / tm
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes"), flops


def gmm_timing(x, w, te, tm, got, what: str) -> dict:
    """K4 at one bf16 expert shape (x [E*C, D], w [E, D, F]), its output
    ``got`` already checked: the yardstick, the reference's einsum twin
    as one batched product over [E, C, D] x [E, D, F] (cuBLAS bf16),
    checked against it; K4, its plain version and the yardstick timed;
    the bound."""
    (e, din, dout), t = w.shape, x.shape[0]
    xb = x.view(e, t // e, din)
    lib_err = float((torch.bmm(xb, w).float().view(t, dout) - got).abs().max())
    check(lib_err <= LIB_TOL * max(1.0, float(got.abs().max())), f"bmm vs K4: {lib_err}")
    k_ms = time_ms(lambda: moe_gmm(x, w, te, tm=tm), reps=10)
    p_ms = time_ms(lambda: ref.moe_gmm_ref(x, w, te, tm), reps=5)
    lib_ms = time_ms(lambda: torch.bmm(xb, w), reps=20)
    (b_ms, b_by), flops = gmm_bound(t, din, dout, e, tm, 2)
    log(f"  K4 timing, {what} bf16: {k_ms:.4f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s, "
        f"{b_ms / k_ms:.2%} of the bound {b_ms:.4f} ms, {b_by}); plain {p_ms:.4f} ms; "
        f"torch.bmm over [E, C, D] x [E, D, F] {lib_ms:.4f} ms (K4 / bmm "
        f"{k_ms / lib_ms:.2f}x; max |bmm - K4| {lib_err:.3g})")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "tflops": flops / k_ms / 1e9, "bmm_max_abs": lib_err}


def phase_gmm(dev) -> tuple:
    for t, d, f, e, tm in GMM_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            gmm_check(*gmm_inputs(dev, t, d, f, e, tm, dtype, SEED), tm,
                      f"({t}, {d}, {f}) E {e} tm {tm} {str(dtype)[6:]}")
    for tm in (128, 8):
        x, w, te = gmm_inputs(dev, 1024, 128, 384, 8, tm, torch.float32, 1, integer=True)
        got = ops.grouped_matmul(x, w, te, tm=tm)
        check(torch.equal(got, ref.moe_gmm_ref(x, w, te, tm)),
              f"K4 small integers not bitwise at tm {tm}")
        log(f"  K4 (1024, 128, 384) E 8 tm {tm} small integers: bitwise equal to plain")
    x, w, te = gmm_inputs(dev, 256, 128, 256, 2, 128, torch.float32, SEED)
    refuses_grad(lambda: ops.grouped_matmul(x.requires_grad_(), w, te, tm=128),
                 "K4 ops.grouped_matmul (x)")
    refuses_grad(lambda: ops.grouped_matmul(x.detach(), w.requires_grad_(), te, tm=128),
                 "K4 ops.grouped_matmul (w)")

    # qwen3-moe-30b-a3b's expert shapes: 128 experts, prefill 4 x 2048
    # tokens (capacity 640, tile 128), decode at batch 4 (capacity 8, tile 8).
    cfg = get_config(MOE_ARCH)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.expert_ff
    timing, extra = {}, {}
    for name, cap, (din, dout), dtypes in (
            ("prefill gate/up", 640, (d, f), (torch.float32, torch.bfloat16)),
            ("prefill down", 640, (f, d), (torch.bfloat16,)),
            ("decode gate/up", 8, (d, f), (torch.bfloat16,)),
            ("decode down", 8, (f, d), (torch.bfloat16,))):
        tm = moe._tile_rows(cap)
        te = torch.arange(e, dtype=torch.int32, device=dev).repeat_interleave(cap // tm)
        for dtype in dtypes:
            x, w, _ = gmm_inputs(dev, e * cap, din, dout, e, tm, dtype, SEED, te=te)
            got, err = gmm_check(x, w, te, tm, f"qwen3 {name} [{e * cap}, {din}] x "
                                 f"[{e}, {din}, {dout}] tm {tm} {str(dtype)[6:]}")
            if dtype != torch.bfloat16:
                continue
            row = gmm_timing(x, w, te, tm, got, name)
            key = f"K4_{name.replace(' ', '_').replace('/', '')}"
            extra.update({f"{key}_{k.replace('library', 'bmm')}": v for k, v in row.items()})
            extra[f"{key}_max_abs_err"] = err
            if name == "prefill gate/up":
                timing = {"max_abs_err": err, **{k: row[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
            if name == "decode gate/up":
                # Host time the two tensor maps add to every launch.
                lib, reps = _build.load_moe_gmm(), 1000
                t0 = time.perf_counter()
                rc = lib.moe_gmm_encode_maps(x.data_ptr(), w.data_ptr(), e * cap, din, dout, e,
                                             tm, reps)
                enc_us = (time.perf_counter() - t0) / reps * 1e6
                check(rc == 0, f"tensor-map encoding failed: cudaError_t {rc}")
                extra["K4_tensor_map_encode_us"] = enc_us
                log(f"  K4 tensor maps (x and w) encoded on the host: {enc_us:.2f} us per launch")
            del x, w, got
    torch.cuda.empty_cache()
    return timing, extra


# -- phases 12-13: qwen3-moe-30b-a3b --------------------------------------------

def choice_diff(routes, plain_routes, e: int) -> int:
    """(token, slot) expert choices of one run that the other did not make,
    summed over the MoE layers."""
    n = 0
    for a, b in zip(routes, plain_routes):
        ha = torch.nn.functional.one_hot(a, e).sum(1)
        hb = torch.nn.functional.one_hot(b, e).sum(1)
        n += int((ha - hb).clamp(min=0).sum())
    return n


def dropped_pairs(routes, e: int, cap: int) -> tuple:
    """(token, slot) pairs dropped for capacity over the MoE layers, and
    the first token (flat index, batch-major) that lost a pair."""
    n, first = 0, None
    for r in routes:
        over = (torch.bincount(r.reshape(-1), minlength=e) - cap).clamp(min=0)
        n += int(over.sum())
        for ex in torch.nonzero(over).reshape(-1).tolist():
            tok = int(torch.nonzero(r.reshape(-1) == ex)[cap]) // r.shape[1]
            first = tok if first is None else min(first, tok)
    return n, first


def describe_lm(cfg, params, t0) -> int:
    n_params = sum(p.numel() for p in params.parameters())
    log(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"({cfg.n_kv_heads} kv) of {cfg.head_dim}, {cfg.n_experts} experts top-{cfg.top_k} of "
        f"{cfg.expert_ff}, vocab {cfg.vocab}; {n_params} {cfg.param_dtype} parameters drawn "
        f"on the card in {time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    return n_params


def moe_kernel_vs_plain(params, cfg, tokens) -> tuple:
    """Logits of every position through K4/K5 and through their plain
    versions, the expert choices that differ and the dropped pairs."""
    full, dense, routes, plain_routes = kernel_and_dense_logits(params, cfg, {"tokens": tokens})
    diff = choice_diff(routes, plain_routes, cfg.n_experts)
    drops, first = dropped_pairs(routes, cfg.n_experts, moe._capacity(tokens.numel(), cfg))
    dmax, agree = logit_drift(full, dense, cfg.vocab)
    log(f"  all-position logits, kernels vs plain versions: max |dlogit| {dmax:.3g}, greedy "
        f"tokens agree at {agree:.4%} of {LM_BATCH * LM_SEQ} positions; expert choices that "
        f"differ: {diff} of {len(routes) * tokens.numel() * cfg.top_k}; pairs dropped for "
        f"capacity {moe._capacity(tokens.numel(), cfg)}: {drops} (first token {first})")
    return full, dense, {"max_abs": dmax, "greedy_agreement": agree, "choices_differ": diff,
                         "dropped_pairs": drops, "first_dropped_token": first}


def phase_moe_float32(dev) -> dict:
    cfg = get_config(MOE_ARCH).with_(dtype="float32", n_layers=MOE_F32_LAYERS)
    t0 = time.perf_counter()
    params = tr.init_lm(SEED, cfg, device=dev)
    torch.cuda.synchronize()
    describe_lm(cfg, params, t0)
    tokens = lm_tokens(cfg, dev)
    launched = prefill_main_path(params, cfg, {"tokens": tokens})
    log(f"  prefill {LM_BATCH} x {LM_SEQ} (make_prefill_step): K4 launches "
        f"{launched['moe_gmm']}, K5 launches {launched['flash_attention']}")
    full, dense, stats = moe_kernel_vs_plain(params, cfg, tokens)
    torch.testing.assert_close(full, dense, rtol=LM_TOL, atol=LM_TOL,
                               msg="float32 logits: kernels against the plain versions")
    del dense
    derr, dec_ms = teacher_forced_decode(params, cfg, tokens, full, dev)
    del full, params
    torch.cuda.empty_cache()
    return {"moe_f32_layers": cfg.n_layers, "moe_f32_k4_launches": launched["moe_gmm"],
            "moe_f32_k5_launches": launched["flash_attention"],
            **{f"moe_f32_{k}": v for k, v in stats.items()},
            "moe_f32_decode_vs_prefill_max_abs": derr, "moe_f32_decode_ms_per_step": dec_ms}


def float32_routers(params, cfg, dev) -> int:
    """Redraw every MoE layer's router in float32 (normal, std 0.02, the
    template's rule; a generator on the card, seed SEED): the reference
    routes with a float32 weight, and ``BatchedServer`` keeps it float32.
    Returns the router parameters' count."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n = 0
    for layer in params["layers"]:
        if "ff" not in layer or "router" not in layer["ff"]:
            continue
        w = layer["ff"]["router"]["w"]
        w.data = torch.randn(tuple(w.shape), generator=gen, device=dev).mul_(0.02)
        n += w.numel()
    return n


def phase_moe_bfloat16(dev) -> tuple:
    cfg = get_config(MOE_ARCH).with_(param_dtype="bfloat16")
    t0 = time.perf_counter()
    params = tr.init_lm(SEED, cfg, device=dev)
    n_router = float32_routers(params, cfg, dev)
    torch.cuda.synchronize()
    n_params = describe_lm(cfg, params, t0)
    routers = [layer["ff"]["router"]["w"] for layer in params["layers"]]
    check(len(routers) == moe_layers(cfg) and all(w.dtype == torch.float32 for w in routers),
          "qwen3 routers are not float32")
    log(f"  {len(routers)} routers kept in float32 ({n_router} parameters, "
        f"{4 * n_router / 1e6:.1f} MB); every other weight bfloat16")
    tokens = lm_tokens(cfg, dev)
    launched = prefill_main_path(params, cfg, {"tokens": tokens})
    log(f"  prefill {LM_BATCH} x {LM_SEQ} (make_prefill_step): K4 launches "
        f"{launched['moe_gmm']}, K5 launches {launched['flash_attention']}")
    full, dense, stats = moe_kernel_vs_plain(params, cfg, tokens)
    del full, dense
    pairs = moe_layers(cfg) * tokens.numel() * cfg.top_k
    log(f"  expert choices that differ between the kernels and the plain versions, float32 "
        f"routers: {stats['choices_differ'] / pairs:.2%} of {pairs} (with bf16 routers, "
        f"measured before: 0.77 %)")
    torch.cuda.empty_cache()
    server = BatchedServer(cfg, batch_slots=4, max_seq=256, device=dev, params=params)
    check(all(layer["ff"]["router"]["w"].dtype == torch.float32
              for layer in server.params["layers"]), "BatchedServer's routers are not float32")
    served = serve_requests(server, cfg)
    del server
    return params, cfg, launched, {
        "moe_params": n_params, "moe_bf16_k4_launches": launched["moe_gmm"],
        "moe_bf16_k5_launches": launched["flash_attention"],
        **{f"moe_bf16_{k}": v for k, v in stats.items()},
        **{f"moe_{k}": v for k, v in served.items()},
    }


def phase_moe_timings(params, cfg, dev) -> dict:
    """qwen3-moe-30b-a3b prefill and decode at batch 4, end to end and
    under the profiler."""
    tokens = lm_tokens(cfg, dev)
    prefill = make_prefill_step(cfg)
    pre_ms = host_ms(lambda: prefill(params, {"tokens": tokens}), reps=3)
    step = make_decode_step(cfg)
    state = {"cache": tr.init_cache(cfg, LM_BATCH, 256, device=dev)}

    def decode_once():
        _, state["cache"] = step(params, state["cache"], tokens[:, :1])

    dec_ms = host_ms(decode_once, reps=10, warmup=2)
    prof_prefill = device_busy(lambda: prefill(params, {"tokens": tokens}), reps=1)
    prof_decode = device_busy(decode_once, reps=5)
    for what, prof in (("prefill", prof_prefill), ("decode step", prof_decode)):
        log(f"  qwen3 profiled {what}: wall {prof['wall_ms']:.2f} ms, device busy "
            f"{prof['device_ms']:.2f} ms (idle {prof['idle_share']:.1%}); unprofiled wall "
            f"{prof['unprofiled_wall_ms']:.2f} ms (idle ~{prof['idle_share_unprofiled']:.1%}); "
            f"{prof['kernels_per_call']:.0f} kernels; top {prof['top_ms']}")
    out = {"moe_prefill_bf16_ms": pre_ms,
           "moe_prefill_tokens_per_s": LM_BATCH * LM_SEQ / (pre_ms / 1e3),
           "moe_decode_bf16_ms_per_step": dec_ms,
           "moe_decode_tokens_per_s": LM_BATCH / (dec_ms / 1e3),
           "moe_profile_prefill": prof_prefill, "moe_profile_decode": prof_decode}
    log(f"  qwen3 prefill bf16 {LM_BATCH} x {LM_SEQ}: {pre_ms:.2f} ms "
        f"({out['moe_prefill_tokens_per_s']:.0f} tokens/s); decode step bf16 batch "
        f"{LM_BATCH}: {dec_ms:.2f} ms ({out['moe_decode_tokens_per_s']:.1f} tokens/s)")
    return out


# -- phase 14: training ----------------------------------------------------------

def attention_grad_check(q, k, v, what: str, causal=True, window=None, q_offset=0) -> None:
    """``ops.attention`` on inputs that require grad (K5 forward, the plain
    recompute backward) against autograd through the plain version: the
    output and dq, dk, dv within ``ATTN_TOL``."""
    g = torch.randn(q.shape, generator=torch.Generator(device=q.device).manual_seed(SEED),
                    device=q.device).to(q.dtype)
    t = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ops.attention(*t, causal, window, q_offset)
    got = torch.autograd.grad(out, t, g)
    t2 = [x.clone().requires_grad_() for x in (q, k, v)]
    plain = ref.flash_attention_ref(*t2, causal=causal, window=window,
                                    q_offset=q_offset).to(q.dtype)
    want = torch.autograd.grad(plain, t2, g)
    out, plain = out.detach(), plain.detach()
    torch.cuda.synchronize()
    rtol, atol = ATTN_TOL[q.dtype]
    torch.testing.assert_close(out.float(), plain.float(), rtol=rtol, atol=atol,
                               msg=f"K5 VJP forward {what}")
    errs = []
    for name, a, b in zip("qkv", got, want):
        check(a.dtype == q.dtype and a.shape == b.shape, f"d{name} {what}: dtype or shape")
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=atol,
                                   msg=f"K5 VJP d{name} {what}")
        errs.append(float((a.float() - b.float()).abs().max()))
    log(f"  K5 VJP {what}: out max_abs_err {float((out.float() - plain.float()).abs().max()):.3g}"
        f", dq/dk/dv max_abs_err {max(errs):.3g}")


def phase_train_attention(dev) -> int:
    """(a) the attention VJP at phase 6's shapes; returns its K5 launches."""
    before = flash_attention.launches
    for shape in ATTN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            attention_grad_check(*attention_inputs(dev, shape, dtype),
                                 f"{shape} {str(dtype)[6:]} causal")
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        attention_grad_check(*attention_inputs(dev, (2, 512, 64), dtype),
                             f"(2, 512, 64) {name} window 128", window=128)
        q, k, v = attention_inputs(dev, (2, 256, 64), dtype, sq=128)
        attention_grad_check(q, k, v, f"(2, 128 of 256, 64) {name} window 64 q_offset 200",
                             window=64, q_offset=200)
        for sq, skv, d in ((65, 130, 72), (100, 200, 8)):
            q, k, v = attention_inputs(dev, (3, skv, d), dtype, sq=sq)
            attention_grad_check(q, k, v, f"({sq} of {skv}, D {d}) {name} q_offset {skv - sq}",
                                 q_offset=skv - sq)
    return flash_attention.launches - before


def train_batch(cfg, dev, step: int = 0) -> dict:
    data = SyntheticLM(cfg, LM_BATCH, LM_SEQ, seed=SEED)
    return {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(step).items()}


def loss_and_grads(params, cfg, batch) -> tuple:
    total, metrics = tr.lm_loss(params, cfg, **batch)
    grads = torch.autograd.grad(total, tree_leaves(params))
    return total.detach(), metrics, grads


def phase_train_float32(dev) -> dict:
    """(b) granite-3-2b at full width, float32, TRAIN_F32_LAYERS layers:
    ``lm_loss`` and every gradient on the K5 path against the plain path."""
    cfg = get_config(LM_ARCH).with_(dtype="float32", n_layers=TRAIN_F32_LAYERS)
    params = tr.init_lm(SEED, cfg, device=dev, trainable=True)
    batch = train_batch(cfg, dev)
    reset_counts()
    total, metrics, grads = loss_and_grads(params, cfg, batch)
    torch.cuda.synchronize()
    launched = counts()
    check(launched["flash_attention"] == 2 * cfg.n_layers,
          f"K5 launches in a float32 forward and backward with remat full: {launched}")
    with plain_kernels_in_place():
        p_total, _, p_grads = loss_and_grads(params, cfg, batch)
    torch.cuda.synchronize()
    loss_rel = abs(float(total) - float(p_total)) / abs(float(p_total))
    check(loss_rel <= TRAIN_LOSS_RTOL, f"lm_loss K5 {float(total)} vs plain {float(p_total)}")
    worst, worst_path = 0.0, None
    for (path, _), a, b in zip(flatten_with_paths(params), grads, p_grads):
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_path = rel, path
    check(worst <= TRAIN_GRAD_TOL, f"gradient {worst_path}: {worst:.3g} of its scale")
    log(f"  {LM_ARCH} float32, {cfg.n_layers} of 40 layers at full width, {LM_BATCH} x {LM_SEQ} "
        f"SyntheticLM tokens: lm_loss {float(total):.6f} (plain {float(p_total):.6f}, rel "
        f"{loss_rel:.3g}); K5 launches {launched['flash_attention']} (forward + remat); "
        f"{len(grads)} gradients, largest difference {worst:.3g} of its leaf's scale "
        f"({worst_path}; bound {TRAIN_GRAD_TOL})")
    del params, grads, p_grads
    torch.cuda.empty_cache()
    return {"train_f32_layers": cfg.n_layers, "train_f32_loss": float(total),
            "train_f32_loss_rel": loss_rel, "train_f32_grad_rel_max": worst,
            "train_f32_grad_rel_max_leaf": worst_path,
            "train_f32_k5_launches": launched["flash_attention"],
            "train_f32_moe_aux": float(metrics["moe_aux"])}


def attention_backward_timings(dev) -> dict:
    """The plain recompute backward of one layer's attention at the train
    step's shape, [LM_BATCH * heads, LM_SEQ, head_dim] bf16 causal (what
    ``_Attention.backward`` runs), against SDPA's forward + backward (the
    yardstick; the port never calls it), also at D = 128; the bound is
    2.5x the forward's operations at the bf16 peak."""
    cfg = get_config(LM_ARCH)
    result = {}
    for d in (cfg.head_dim, 128):
        bh, s = LM_BATCH * cfg.n_heads, LM_SEQ
        q, k, v = attention_inputs(dev, (bh, s, d), torch.bfloat16)
        g = torch.randn(q.shape, device=dev).to(torch.bfloat16)
        qs, ks, vs = (x[None].clone().requires_grad_() for x in (q, k, v))
        t = [x.requires_grad_() for x in (q, k, v)]
        out = ops.attention(*t, True, None, 0)

        def recompute():  # the VJP's backward alone: its forward ran once, above
            return torch.autograd.grad(out, t, g, retain_graph=True)

        def sdpa():
            o = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
            return torch.autograd.grad(o, (qs, ks, vs), g[None])

        bwd_ms = time_ms(recompute, reps=5)
        sdpa_ms = time_ms(sdpa, reps=20)
        _, flops = attention_bound(bh, s, d, 2)
        bound = 2.5 * flops / PEAK_BF16_FLOPS * 1e3
        log(f"  attention backward [{bh}, {s}, {d}] bf16 causal: plain recompute {bwd_ms:.3f} ms "
            f"per layer; SDPA forward + backward {sdpa_ms:.4f} ms; bound (2.5x the forward's "
            f"{flops / 1e12:.3f} TFLOP at the bf16 peak) {bound:.4f} ms")
        result[f"d{d}"] = {"plain_recompute_ms": bwd_ms, "sdpa_fwd_bwd_ms": sdpa_ms,
                           "bound_ms": bound}
        del q, k, v, g, qs, ks, vs, t, out
    torch.cuda.empty_cache()
    return result


def phase_train_full(dev) -> tuple:
    """(c) granite-3-2b at full width and depth in the config's dtypes:
    ``make_train_step`` with the launcher's AdamW takes TRAIN_STEPS steps.
    Returns (K5 launches of those steps, results)."""
    cfg = get_config(LM_ARCH)
    check(cfg.remat == "full" and cfg.dtype == "bfloat16" and cfg.param_dtype == "float32",
          f"granite's training dtypes: {cfg.remat}, {cfg.dtype}, {cfg.param_dtype}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = tr.init_lm(SEED, cfg, device=dev, trainable=True)
    opt = make_optimizer(cfg, TRAIN_STEPS)
    state = {"params": params, "opt": opt.init(params)}
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    log(f"  {LM_ARCH}: {cfg.n_layers} layers at full width, {n_params} float32 parameters "
        f"(trainable) and AdamW state drawn on the card in {time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB allocated")
    leaves = tree_leaves(params)
    before = torch.stack([p.detach().double().abs().sum() for p in leaves])
    step = make_train_step(cfg, opt)
    batches = [train_batch(cfg, dev, i) for i in range(TRAIN_STEPS)]

    def one_step(batch):
        state["params"], state["opt"], m = step(state["params"], state["opt"], batch)
        return m

    step_ms, per_step, metrics = [], [], []
    reset_counts()
    for i in range(TRAIN_STEPS):
        k5 = flash_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = one_step(batches[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append(flash_attention.launches - k5)
        metrics.append({k: float(v) for k, v in m.items()})
    launched = counts()
    peak = torch.cuda.max_memory_allocated(dev)
    for i, m in enumerate(metrics):
        check(all(np.isfinite(v) for v in m.values()), f"train step {i + 1} metrics {m}")
        log(f"  step {i + 1}: loss {m['loss']:.4f}, grad_norm {m['grad_norm']:.4f}, "
            f"{step_ms[i]:.1f} ms, K5 launches {per_step[i]}")
    check(all(n == 2 * cfg.n_layers for n in per_step) and launched["flash_attention_bf16"]
          == launched["flash_attention"] == TRAIN_STEPS * 2 * cfg.n_layers,
          f"K5 launches per step {per_step} (expected {2 * cfg.n_layers}: forward and remat "
          f"recompute), {launched}")
    after = torch.stack([p.detach().double().abs().sum() for p in tree_leaves(state["params"])])
    moved = int((after != before).sum())
    check(moved == len(leaves), f"only {moved} of {len(leaves)} parameters moved")
    check(int(state["opt"]["step"]) == TRAIN_STEPS, "optimizer step count")
    busy = device_busy(lambda: one_step(batches[0]), reps=1)
    med = float(np.median(step_ms))
    log(f"  {TRAIN_STEPS} steps of {LM_BATCH} x {LM_SEQ} tokens: median {med:.1f} ms "
        f"({LM_BATCH * LM_SEQ / med * 1e3:.0f} tokens/s); peak memory allocated "
        f"{peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated); all {moved} parameters moved")
    log(f"  profiled step: wall {busy['wall_ms']:.1f} ms, device busy {busy['device_ms']:.1f} "
        f"ms (idle {busy['idle_share']:.1%}); unprofiled wall {busy['unprofiled_wall_ms']:.1f} "
        f"ms (idle ~{busy['idle_share_unprofiled']:.1%}); {busy['kernels_per_call']:.0f} "
        f"kernels; top {busy['top_ms']}")
    del state, params, leaves, batches
    torch.cuda.empty_cache()
    bwd = attention_backward_timings(dev)
    share = cfg.n_layers * bwd[f"d{cfg.head_dim}"]["plain_recompute_ms"] / med
    log(f"  attention backward (plain recompute) x {cfg.n_layers} layers = {share:.1%} of the "
        f"median step")
    return launched["flash_attention"], {
        "train_params": n_params, "train_steps": TRAIN_STEPS, "train_step_ms": step_ms,
        "train_step_ms_median": med, "train_tokens_per_s": LM_BATCH * LM_SEQ / med * 1e3,
        "train_peak_bytes": peak, "train_k5_launches_per_step": per_step,
        "train_metrics": metrics, "train_profile_step": busy,
        "train_attention_backward": bwd, "train_attention_backward_share": share,
    }


def phase_launch_train(dev) -> dict:
    """(d) ``launch_train`` at granite's reduced config on the card: the
    loss falls over LAUNCH_STEPS steps with checkpoints every
    LAUNCH_CKPT_EVERY; a second launch over the same directory resumes at
    the newest step and holds the saved params and optimizer state
    bitwise."""
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    kw = dict(steps=LAUNCH_STEPS, batch=LAUNCH_BATCH, seq=LAUNCH_SEQ, ckpt_dir=str(TRAIN_CKPT),
              log_every=LAUNCH_CKPT_EVERY, ckpt_every=LAUNCH_CKPT_EVERY, device=dev)
    before = flash_attention.launches
    t0 = time.perf_counter()
    res = launch_train(LM_ARCH, **kw)
    train_s = time.perf_counter() - t0
    k5 = flash_attention.launches - before
    losses = [h["loss"] for h in res["history"]]
    check(res["final_step"] == LAUNCH_STEPS and losses[-1] < losses[0],
          f"launch_train: {res['final_step']} steps, losses {losses}")
    n_layers = get_reduced(LM_ARCH).n_layers
    check(k5 == LAUNCH_STEPS * 2 * n_layers,
          f"launch_train: K5 launches {k5}, expected {LAUNCH_STEPS * 2 * n_layers}")
    steps_kept = CheckpointManager(str(TRAIN_CKPT)).all_steps()
    again = launch_train(LM_ARCH, **dict(kw, seed=SEED + 1))
    check(again["final_step"] == LAUNCH_STEPS and again["history"] == [],
          f"the second launch did not resume at step {LAUNCH_STEPS}: {again['final_step']}")
    saved = tree_leaves({"p": res["params"], "o": res["opt_state"]})
    restored = tree_leaves({"p": again["params"], "o": again["opt_state"]})
    check(len(saved) == len(restored) and all(
        a.device == b.device and torch.equal(a.detach(), b.detach())
        for a, b in zip(saved, restored)), "restored state differs from the saved state")
    log(f"  launch_train({LM_ARCH}, reduced, {LAUNCH_STEPS} steps of {LAUNCH_BATCH} x "
        f"{LAUNCH_SEQ}, checkpoints every {LAUNCH_CKPT_EVERY}) on the card in {train_s:.2f} s: "
        f"loss {' -> '.join(f'{x:.4f}' for x in losses)}; K5 launches {k5}; checkpoints kept "
        f"{steps_kept}; a second launch resumed at step {again['final_step']}, {len(saved)} "
        f"tensors of params and optimizer state bitwise equal to the saved ones")
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    return {"launch_losses": losses, "launch_k5_launches": k5, "launch_s": train_s,
            "launch_ckpt_steps": steps_kept}


# -- phase 15: the other eight architectures ------------------------------------

# The eight architectures beyond granite and qwen3, in the registry's
# order. Traffic: the earlier LM phases' LM_BATCH x LM_SEQ (hubert: frames
# of frontend_dim; paligemma: its num_patches patches before LM_SEQ text
# tokens), but h2o-danube at 1 x 8192, so that K5's window (4096) masks.
# ``layers``: the depth at bf16 weights on the 80 GB card, full where the
# weights and the prefill's transients fit (command-r: 60.6 GB of weights,
# a 65.1 GB peak). llama4-scout (4.16 GB a layer beside 4.1 GB of
# embedding and head, ~7 GB of prefill transients at its 202,112-wide
# head) and jamba (26 GB a period of 8) are cut to the most layers that
# fit with their prefill: 16 of 48 (~77 GB peak) and 2 of 4 periods
# (55.4 GB; a third would need ~81 GB).
ARCH_RUNS = {
    "hubert-xlarge": dict(batch=LM_BATCH, seq=LM_SEQ, layers=48),
    "command-r-35b": dict(batch=LM_BATCH, seq=LM_SEQ, layers=40),
    "yi-9b": dict(batch=LM_BATCH, seq=LM_SEQ, layers=48),
    "h2o-danube-3-4b": dict(batch=1, seq=8192, layers=24),
    "mamba2-130m": dict(batch=LM_BATCH, seq=LM_SEQ, layers=24),
    "llama4-scout-17b-a16e": dict(batch=LM_BATCH, seq=LM_SEQ, layers=16),
    "paligemma-3b": dict(batch=LM_BATCH, seq=LM_SEQ, layers=18),
    "jamba-v0.1-52b": dict(batch=LM_BATCH, seq=LM_SEQ, layers=16),
}
# Teacher-forced decode steps against the prefill: float32 gate (LM_TOL)
# and bf16 (reported).
ARCH_DECODE_F32, ARCH_DECODE_BF16 = 32, 8
# Archs whose BatchedServer runs here: the SSM state across slots.
ARCH_SERVED = ("mamba2-130m", "jamba-v0.1-52b")
# The kernel name of the MoE dispatch's index_put_(accumulate=True).
DISPATCH_KERNEL = "indexing_backward_kernel"


def arch_batch(cfg, dev, batch: int, seq: int) -> dict:
    """Inputs of one prefill from a numpy seed: ``seq`` text tokens, or
    frames (audio), or patches and ``seq`` text tokens (vision)."""
    rng = np.random.default_rng(SEED)
    out = {}
    if cfg.frontend != "audio":
        out["tokens"] = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq))).to(dev)
    if cfg.frontend != "none":
        n = seq if cfg.frontend == "audio" else cfg.num_patches
        out["feats"] = torch.from_numpy(
            rng.standard_normal((batch, n, cfg.frontend_dim), dtype=np.float32)).to(dev)
    return out


def decode_reference(params, cfg, batch: dict, n: int) -> torch.Tensor:
    """Logits [1, n, V] that teacher-forced decode of sequence 0's first
    ``n`` tokens must reproduce: the forward of those tokens. The decode
    cache holds text only (as the reference's ``decode_step``), so for a
    vision model it is the text-only forward of its backbone."""
    text_cfg = cfg.with_(frontend="none") if cfg.frontend == "vision" else cfg
    with torch.no_grad():
        return tr.forward(params, text_cfg, tokens=batch["tokens"][:1, :n])[0]


def arch_float32_gate(arch: str, dev) -> dict:
    """(a) Full width, float32, the fewest layers that hold every block
    kind (one period): all-position logits through K5/K4 against the plain
    versions within LM_TOL, then teacher-forced decode within LM_TOL."""
    base, run = get_config(arch), ARCH_RUNS[arch]
    cfg = base.with_(dtype="float32", n_layers=base.period)
    t0 = time.perf_counter()
    params = tr.init_lm(SEED, cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    batch = arch_batch(cfg, dev, run["batch"], run["seq"])
    full, dense, _, _ = kernel_and_dense_logits(params, cfg, batch)
    launched = counts()  # the kernel forward's; the plain one launches nothing
    err = float((full - dense).abs().max())
    torch.testing.assert_close(full, dense, rtol=LM_TOL, atol=LM_TOL,
                               msg=f"{arch} float32 logits: kernels against the plain versions")
    log(f"  (a) float32, {cfg.n_layers} layer(s), {n_params} parameters, "
        f"{model_seq(cfg, batch)}: K5 {launched['flash_attention']}, K4 "
        f"{launched['moe_gmm']} launches; logits kernels vs plain max_abs_err {err:.3g} "
        f"(bound {LM_TOL})")
    out = {"f32_layers": cfg.n_layers, "f32_kernel_vs_plain_max_abs": err,
           "f32_k5_launches": launched["flash_attention"], "f32_k4_launches": launched["moe_gmm"]}
    del dense
    if not cfg.is_encoder_only:
        n = ARCH_DECODE_F32
        want = (decode_reference(params, cfg, batch, n) if cfg.frontend == "vision"
                else full[:1, :n])
        out["f32_decode_vs_prefill_max_abs"], _ = teacher_forced_decode(
            params, cfg, batch["tokens"], want, dev, n)
    del full, params
    torch.cuda.empty_cache()
    out["f32_s"] = time.perf_counter() - t0
    return out


def arch_bfloat16(arch: str, dev) -> tuple:
    """(b) bf16 weights (float32 routers) at full width and the depth of
    ``ARCH_RUNS``: the prefill (main path) with its launches and peak
    memory, bf16 teacher-forced decode against the forward, BatchedServer
    for the SSM archs; (c) prefill and decode times, and the MoE
    dispatch's share of a profiled prefill."""
    run = ARCH_RUNS[arch]
    cfg = get_config(arch).with_(param_dtype="bfloat16", n_layers=run["layers"])
    t0 = time.perf_counter()
    params = tr.init_lm(SEED, cfg, device=dev)
    float32_routers(params, cfg, dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    weights_gb = torch.cuda.memory_allocated() / 1e9
    batch = arch_batch(cfg, dev, run["batch"], run["seq"])
    b, s = model_seq(cfg, batch)
    torch.cuda.reset_peak_memory_stats()
    launched = prefill_main_path(params, cfg, batch)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  (b) bf16 weights, {cfg.n_layers} of {get_config(arch).n_layers} layers, "
        f"{n_params} parameters ({weights_gb:.1f} GB allocated): prefill {b} x {s} "
        f"(make_prefill_step): K5 {launched['flash_attention']}, K4 {launched['moe_gmm']} "
        f"launches (attention layers {attention_layers(cfg)}, MoE layers {moe_layers(cfg)}); "
        f"peak {peak_gb:.1f} GB")
    out = {"layers": cfg.n_layers, "params": n_params, "weights_gb": weights_gb,
           "prefill_peak_gb": peak_gb, "k5_launches": launched["flash_attention"],
           "k4_launches": launched["moe_gmm"]}
    prefill = make_prefill_step(cfg)
    out["prefill_ms"] = host_ms(lambda: prefill(params, batch), reps=2)
    out["prefill_tokens_per_s"] = b * s / (out["prefill_ms"] / 1e3)
    if cfg.has_moe:
        prof = device_busy(lambda: prefill(params, batch), reps=1, match=DISPATCH_KERNEL)
        out["prefill_dispatch_share"] = prof["matched_ms"] / prof["device_ms"]
        out["profile_prefill"] = prof
        log(f"  profiled prefill: device busy {prof['device_ms']:.2f} ms, MoE dispatch "
            f"(index_put_) {prof['matched_ms']:.2f} ms = {out['prefill_dispatch_share']:.1%}; "
            f"top {prof['top_ms'][:3]}")
    if not cfg.is_encoder_only:
        n = ARCH_DECODE_BF16
        want = decode_reference(params, cfg, batch, n)
        cache = tr.init_cache(cfg, 1, n, device=dev)
        step = make_decode_step(cfg)
        got = []
        for t in range(n):
            logits, cache = step(params, cache, batch["tokens"][:1, t:t + 1])
            got.append(logits[:, 0])
        got = torch.stack(got, dim=1)
        check(bool(torch.isfinite(got[..., :cfg.vocab]).all()), f"{arch} bf16 decode logits")
        dmax, agree = logit_drift(got, want, cfg.vocab)
        out.update({"bf16_decode_vs_forward_max_abs": dmax, "bf16_decode_greedy_agreement": agree})
        state = {"cache": tr.init_cache(cfg, b, 256, device=dev)}

        def decode_once():
            _, state["cache"] = step(params, state["cache"], batch["tokens"][:, :1])

        out["decode_ms_per_step"] = host_ms(decode_once, reps=5, warmup=1)
        out["decode_tokens_per_s"] = b / (out["decode_ms_per_step"] / 1e3)
        del state
        log(f"  bf16 teacher-forced decode of {n} tokens: max |dlogit| {dmax:.3g} against the "
            f"forward, greedy tokens agree at {agree:.1%}")
    log(f"  (c) prefill {out['prefill_ms']:.2f} ms ({out['prefill_tokens_per_s']:.0f} tokens/s)"
        + (f"; decode step at batch {b}: {out['decode_ms_per_step']:.2f} ms "
           f"({out['decode_tokens_per_s']:.1f} tokens/s)" if "decode_ms_per_step" in out
           else "; no decode step (encoder-only)"))
    if arch in ARCH_SERVED:
        server = BatchedServer(cfg, batch_slots=4, max_seq=256, device=dev, params=params)
        out.update(serve_requests(server, cfg))
        del server
    del params
    torch.cuda.empty_cache()
    out["bf16_s"] = time.perf_counter() - t0
    return launched, out


def sdpa_call(q, k, v, causal: bool, window):
    """``scaled_dot_product_attention`` over [1, BH, S, D] with K5's mask:
    causal, or a causal window as a boolean mask."""
    import torch.nn.functional as F

    if window is None:
        return lambda: F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                      is_causal=causal)
    i = torch.arange(q.shape[1], device=q.device)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    return lambda: F.scaled_dot_product_attention(q[None], k[None], v[None], attn_mask=mask)


def arch_attention_shape(arch: str, dev) -> dict:
    """K5 alone at one architecture's prefill shape, bf16: against its
    plain version (ATTN_TOL), SDPA and its bound."""
    cfg, run = get_config(arch), ARCH_RUNS[arch]
    seq = run["seq"] + (cfg.num_patches if cfg.frontend == "vision" else 0)
    bh, d, window = run["batch"] * cfg.n_heads, cfg.head_dim, cfg.window
    q, k, v = attention_inputs(dev, (bh, seq, d), torch.bfloat16)
    kw = dict(causal=cfg.causal, window=window)
    got = flash_attention(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    rtol, atol = ATTN_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol,
                               msg=f"K5 at {arch}'s shape")
    err = float((got.float() - want).abs().max())
    del want
    sdpa = sdpa_call(q, k, v, cfg.causal, window)
    lib_err = float((sdpa()[0].float() - got.float()).abs().max())
    check(lib_err <= SDPA_TOL, f"SDPA against K5 at {arch}'s shape: {lib_err}")
    k_ms = time_ms(lambda: flash_attention(q, k, v, **kw), reps=10)
    p_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), reps=3)
    lib_ms = time_ms(sdpa, reps=10)
    (b_ms, b_by), flops = attention_bound(bh, seq, d, 2, cfg.causal, window)
    log(f"  K5 timing, {arch} bf16 [{bh}, {seq}, {d}]: {k_ms:.4f} ms "
        f"({flops / k_ms / 1e9:.1f} TFLOP/s, {b_ms / k_ms:.1%} of the bound {b_ms:.4f} ms, "
        f"{b_by}); plain {p_ms:.4f} ms; SDPA {lib_ms:.4f} ms (K5 / SDPA {k_ms / lib_ms:.2f}x)")
    return {"arch": arch, "shape": [bh, seq, d], "causal": cfg.causal, "window": window,
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "tflops": flops / k_ms / 1e9}


def arch_gmm_shapes(arch: str, dev) -> list:
    """K4 alone at one MoE architecture's prefill expert shapes (gate/up
    and down; capacity of LM_BATCH x LM_SEQ tokens), bf16: against its
    plain version (GMM_TOL), ``torch.bmm`` and its bound."""
    cfg = get_config(arch)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.expert_ff
    cap = moe._capacity(LM_BATCH * LM_SEQ, cfg)
    tm = moe._tile_rows(cap)
    te = torch.arange(e, dtype=torch.int32, device=dev).repeat_interleave(cap // tm)
    rows = []
    for name, (din, dout) in (("gate/up", (d, f)), ("down", (f, d))):
        x, w, _ = gmm_inputs(dev, e * cap, din, dout, e, tm, torch.bfloat16, SEED, te=te)
        got, err = gmm_check(x, w, te, tm, f"{arch} {name} [{e * cap}, {din}] x "
                             f"[{e}, {din}, {dout}] tm {tm} bfloat16")
        rows.append({"arch": arch, "shape": f"{name} [{e * cap}, {din}] x [{e}, {din}, {dout}]",
                     "max_abs_err": err, **gmm_timing(x, w, te, tm, got, f"{arch} {name}")})
        del x, w, got
    torch.cuda.empty_cache()
    return rows


def phase_archs(dev) -> tuple:
    """Phase 15: each of the eight architectures (a) float32 gate, (b)
    bf16 at full width, (c) timings; then K5 and K4 alone at their new
    shapes. Returns (K5 and K4 launches by arch prefill, K5 shapes, K4
    shapes, info)."""
    launches, info = {}, {}
    for arch in ARCH_RUNS:
        t0 = time.perf_counter()
        log(f"  -- {arch}")
        row = arch_float32_gate(arch, dev)
        launched, bf16 = arch_bfloat16(arch, dev)
        row.update(bf16)
        launches[arch] = launched
        info[arch] = row
        log(f"  {arch}: {time.perf_counter() - t0:.1f} s")
    k5 = [arch_attention_shape(arch, dev) for arch in
          ("hubert-xlarge", "paligemma-3b", "h2o-danube-3-4b", "command-r-35b")]
    torch.cuda.empty_cache()
    k4 = [row for arch in ("llama4-scout-17b-a16e", "jamba-v0.1-52b")
          for row in arch_gmm_shapes(arch, dev)]
    return launches, k5, k4, info


# -- phase 16: training the other nine architectures ----------------------------

# (a) Train steps of each architecture but granite (phase 14), in the
# registry's order, at full width in the config's dtypes: bf16 compute,
# float32 params and AdamW state, remat "full". A step holds ~18 B per
# parameter (params 4, m and v 8, the bf16 copies 2, the gradient 4) beside
# its activations, and the card ~84 GB. ``layers``: full depth where that
# fits, else the most layers that do with ~10 GB to spare for the loss
# (the float32 logits and their softmax, [tokens, vocab]) and the backward
# of one layer (the plain attention recompute's [B*H, S, S] float32
# scores; the expert backward's transposed weight and float32 dw):
# hubert 0.95 B (17 GB), mamba2 0.13 B and paligemma 2.51 B (45 GB; its
# 257,280-wide head over 4 x 2304 positions is the largest loss) at full
# depth; command-r 2.10 B of embedding and 0.705 B a layer: 1 layer
# (50 GB; a second would leave no room for its 256,000-wide loss at
# 4 x 2048); yi 0.52 B + 0.173 B a layer: 16 of 48 (59 GB); h2o 0.25 B +
# 0.155 B a layer at 1 x 8192 (so that its window of 4096 masks) with
# ~35 GB of attention recompute at S = 8192: 12 of 24 (38 GB); qwen3
# 0.62 B + 0.614 B a layer: 4 of 48 (55 GB); llama4 2.07 B + 2.08 B a
# layer: 1 of 48 (75 GB at the end of the backward, 77 GB with the
# embedding's bf16 gradient), with 2 x 2048 tokens: at 4 x 2048 its
# 202,112-wide loss would peak at ~75 GB before the gradients exist, with
# no margin for the allocator; jamba: its first two layers (ssm + mlp,
# ssm + moe: 3.73 B, 67 GB), so no attention layer fits.
TRAIN_RUNS = {
    "hubert-xlarge": dict(batch=LM_BATCH, seq=LM_SEQ, layers=48),
    "command-r-35b": dict(batch=LM_BATCH, seq=LM_SEQ, layers=1),
    "yi-9b": dict(batch=LM_BATCH, seq=LM_SEQ, layers=16),
    "h2o-danube-3-4b": dict(batch=1, seq=8192, layers=12),
    "mamba2-130m": dict(batch=LM_BATCH, seq=LM_SEQ, layers=24),
    "qwen3-moe-30b-a3b": dict(batch=LM_BATCH, seq=LM_SEQ, layers=4),
    "llama4-scout-17b-a16e": dict(batch=2, seq=LM_SEQ, layers=1),
    "paligemma-3b": dict(batch=LM_BATCH, seq=LM_SEQ, layers=18),
    "jamba-v0.1-52b": dict(batch=LM_BATCH, seq=LM_SEQ, layers=2),
}
ARCH_TRAIN_STEPS = 2
# (b) The float32 gradient gate (kernels against the plain path, held to
# phase 14's TRAIN_LOSS_RTOL and TRAIN_GRAD_TOL) for the archs whose
# training path differs from granite's: the K4 backward (qwen3, llama4,
# jamba), the SSD's autograd (mamba2, jamba), the frontends (hubert's
# non-causal K5, paligemma's D 256) and K5's window in the VJP (h2o).
# Full width, 1-2 layers; params and both gradients in float32 (12 B a
# parameter): tokens cut to 1 x 2048 where the head or the experts are
# large, h2o at 1 x 8192 so that its window masks.
TRAIN_GATES = {
    "hubert-xlarge": dict(batch=LM_BATCH, seq=LM_SEQ, layers=2),
    "h2o-danube-3-4b": dict(batch=1, seq=8192, layers=1),
    "mamba2-130m": dict(batch=LM_BATCH, seq=LM_SEQ, layers=2),
    "qwen3-moe-30b-a3b": dict(batch=1, seq=LM_SEQ, layers=2),
    "llama4-scout-17b-a16e": dict(batch=1, seq=LM_SEQ, layers=1),
    "paligemma-3b": dict(batch=1, seq=LM_SEQ, layers=2),
    "jamba-v0.1-52b": dict(batch=1, seq=LM_SEQ, layers=2),
}
# (d) launch_train at the reduced configs.
LAUNCH_ARCHS = ("qwen3-moe-30b-a3b", "mamba2-130m")


def train_config(arch: str, layers: int, **kw):
    """The arch's config cut to ``layers`` layers; jamba's pattern (a
    period of 8) to its first ``layers`` positions."""
    cfg = get_config(arch)
    if layers % cfg.period:
        kw["block_pattern"] = cfg.block_pattern[:layers]
    return cfg.with_(n_layers=layers, **kw)


def arch_train_batch(cfg, run: dict, step: int, dev) -> dict:
    """A ``SyntheticLM`` batch on the card: ``seq`` text tokens (paligemma:
    after its patches), or hubert's frames, labels and mask."""
    seq = run["seq"] + (cfg.num_patches if cfg.frontend == "vision" else 0)
    data = SyntheticLM(cfg, run["batch"], seq, seed=SEED)
    return {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(step).items()}


@contextlib.contextmanager
def launch_phases(store: dict, timed: list = None):
    """Split the K4 and K5 launches of a train step by where they happen:
    ``forward``, ``recompute`` (a forward inside the backward: remat) and
    ``backward`` (K4 inside ``_ExpertMatmul.backward``; K5 has none).
    With ``timed``, each expert backward is bracketed by CUDA events,
    appended as (start, end) pairs."""
    em, att = moe._ExpertMatmul, ops._Attention
    real = {"em_fwd": em.forward, "em_bwd": em.backward, "att_fwd": att.forward}

    def counted(kernel, fn, phase=None):
        def spy(ctx, *args):
            where = phase or ("forward" if torch._C._current_graph_task_id() == -1
                              else "recompute")
            before = kernel.launches
            if timed is not None and phase == "backward":
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = fn(ctx, *args)
                ev[1].record()
                timed.append(ev)
            else:
                out = fn(ctx, *args)
            key = f"{kernel.__name__} {where}"
            store[key] = store.get(key, 0) + kernel.launches - before
            return out
        return staticmethod(spy)

    em.forward = counted(moe_gmm, real["em_fwd"])
    em.backward = counted(moe_gmm, real["em_bwd"], "backward")
    att.forward = counted(flash_attention, real["att_fwd"])
    try:
        yield store
    finally:
        em.forward, em.backward = staticmethod(real["em_fwd"]), staticmethod(real["em_bwd"])
        att.forward = staticmethod(real["att_fwd"])


def expected_phases(cfg) -> dict:
    """K5 and K4 launches of one train step under remat "full": per
    attention layer one K5 forward and one in the recompute; per MoE layer
    three K4 forward, three in the recompute and six in the backward."""
    a, m = attention_layers(cfg), moe_layers(cfg)
    want = {"flash_attention forward": a, "flash_attention recompute": a,
            "moe_gmm forward": 3 * m, "moe_gmm recompute": 3 * m, "moe_gmm backward": 6 * m}
    return {k: v for k, v in want.items() if v}


def arch_train(arch: str, dev) -> tuple:
    """(a) ``make_train_step`` with the launcher's AdamW at the depth and
    tokens of ``TRAIN_RUNS``: ARCH_TRAIN_STEPS steps with finite metrics
    that move every parameter, the launches of each step by phase, step
    ms, tokens/s and peak memory; then one profiled step. Returns (the
    steps' launches, results)."""
    run = TRAIN_RUNS[arch]
    cfg = train_config(arch, run["layers"])
    check(cfg.remat == "full" and cfg.dtype == "bfloat16" and cfg.param_dtype == "float32",
          f"{arch}'s training dtypes: {cfg.remat}, {cfg.dtype}, {cfg.param_dtype}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = tr.init_lm(SEED, cfg, device=dev, trainable=True)
    opt = make_optimizer(cfg, ARCH_TRAIN_STEPS)
    state = {"params": params, "opt": opt.init(params)}
    leaves = tree_leaves(params)
    n_params = sum(p.numel() for p in leaves)
    state_gb = torch.cuda.memory_allocated(dev) / 1e9
    before = torch.stack([p.detach().double().abs().sum() for p in leaves])
    step = make_train_step(cfg, opt)
    batches = [arch_train_batch(cfg, run, i, dev) for i in range(ARCH_TRAIN_STEPS)]
    b, s = model_seq(cfg, batches[0])

    def one_step(batch):
        state["params"], state["opt"], m = step(state["params"], state["opt"], batch)
        return m

    want = expected_phases(cfg)
    step_ms, metrics, bwd_ms = [], [], []
    reset_counts()
    for i in range(ARCH_TRAIN_STEPS):
        phases, timed = {}, []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with launch_phases(phases, timed):
            m = one_step(batches[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        bwd_ms.append(sum(a.elapsed_time(z) for a, z in timed))
        metrics.append({k: float(v) for k, v in m.items()})
        phases = {k: v for k, v in phases.items() if v}
        check(phases == want, f"{arch} step {i + 1}: launches by phase {phases}, expected {want}")
    launched = counts()
    peak = torch.cuda.max_memory_allocated(dev)
    check(launched["flash_attention"] == launched["flash_attention_bf16"]
          == ARCH_TRAIN_STEPS * 2 * attention_layers(cfg)
          and launched["moe_gmm"] == launched["moe_gmm_bf16"]
          == ARCH_TRAIN_STEPS * 12 * moe_layers(cfg), f"{arch} train launches {launched}")
    for i, m in enumerate(metrics):
        check(all(np.isfinite(v) for v in m.values()), f"{arch} train step {i + 1} metrics {m}")
    after = torch.stack([p.detach().double().abs().sum() for p in tree_leaves(state["params"])])
    moved = int((after != before).sum())
    check(moved == len(leaves), f"{arch}: only {moved} of {len(leaves)} parameters moved")
    med = float(np.median(step_ms))
    losses = [m["loss"] for m in metrics]
    log(f"  (a) {cfg.n_layers} of {get_config(arch).n_layers} layers, {n_params} float32 "
        f"parameters and AdamW state ({state_gb:.1f} GB); {ARCH_TRAIN_STEPS} steps of {b} x {s}: "
        f"loss {' -> '.join(f'{x:.4f}' for x in losses)}, launches per step {want or 'none'}; "
        f"median {med:.1f} ms ({b * s / med * 1e3:.0f} tokens/s), peak {peak / 1e9:.2f} GB; all "
        f"{moved} parameters moved" + (f"; expert backward (dx, dw, their copies) "
                                       f"{np.median(bwd_ms):.2f} ms a step" if want.get(
                                           "moe_gmm backward") else ""))
    busy = device_busy(lambda: one_step(batches[0]), reps=1, match=DISPATCH_KERNEL, warmup=0,
                       split=("moe_gmm",))
    k4 = busy["split_ms"]["moe_gmm"]
    log(f"  a third step, unprofiled: {busy['unprofiled_wall_ms']:.1f} ms; a fourth, profiled: "
        f"device busy {busy['device_ms']:.1f} ms (idle {busy['idle_share']:.1%}"
        f", ~{busy['idle_share_unprofiled']:.1%} unprofiled); {busy['kernels_per_call']:.0f} "
        f"kernels; K4 {k4:.2f} ms ({k4 / busy['device_ms']:.1%}), dispatch index_put_ "
        f"{busy['matched_ms']:.2f} ms ({busy['matched_ms'] / busy['device_ms']:.1%}); "
        f"top {busy['top_ms'][:3]}")
    del state, params, leaves, batches, step
    torch.cuda.empty_cache()
    return launched, {
        "layers": cfg.n_layers, "batch": b, "seq": s, "params": n_params, "state_gb": state_gb,
        "step_ms": step_ms, "step_ms_median": med, "tokens_per_s": b * s / med * 1e3,
        "peak_gb": peak / 1e9, "metrics": metrics, "launches_per_step": want,
        "expert_backward_ms": bwd_ms, "profile_step": busy, "k4_ms": k4,
        "third_step_ms": busy["unprofiled_wall_ms"],
        "k4_share": k4 / busy["device_ms"],
        "dispatch_share": busy["matched_ms"] / busy["device_ms"]}


def grad_gap(params, grads, p_grads) -> tuple:
    """The largest gradient difference relative to its leaf's plain-path
    scale, and the leaf."""
    worst, worst_path = 0.0, None
    for (path, _), a, b in zip(flatten_with_paths(params), grads, p_grads):
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_path = rel, path
    return worst, worst_path


def arch_train_gate(arch: str, dev) -> dict:
    """(b) Float32 at full width, ``TRAIN_GATES``' depth and tokens:
    ``lm_loss`` and every gradient through K5 and K4 (forward, remat
    recompute, K4 backward) against the same under the plain versions."""
    run = TRAIN_GATES[arch]
    cfg = train_config(arch, run["layers"], dtype="float32")
    params = tr.init_lm(SEED, cfg, device=dev, trainable=True)
    batch = arch_train_batch(cfg, run, 0, dev)
    routes, p_routes = [], []
    reset_counts()
    with recording_routes(routes):
        total, _, grads = loss_and_grads(params, cfg, batch)
    torch.cuda.synchronize()
    launched = counts()
    check(launched["flash_attention"] == 2 * attention_layers(cfg)
          and launched["moe_gmm"] == 12 * moe_layers(cfg),
          f"{arch} float32 gate: launches {launched}")
    with plain_kernels_in_place(), recording_routes(p_routes):
        p_total, _, p_grads = loss_and_grads(params, cfg, batch)
    torch.cuda.synchronize()
    diff = sum(choice_diff(r, p, cfg.n_experts) for r, p in zip(routes, p_routes))
    loss_rel = abs(float(total) - float(p_total)) / abs(float(p_total))
    worst, worst_path = grad_gap(params, grads, p_grads)
    b, s = model_seq(cfg, batch)
    log(f"  (b) float32 gate, {cfg.n_layers} layer(s), {b} x {s}: lm_loss {float(total):.6f} "
        f"(plain {float(p_total):.6f}, rel {loss_rel:.3g}); K5 {launched['flash_attention']}, "
        f"K4 {launched['moe_gmm']} launches; {len(grads)} gradients, largest difference "
        f"{worst:.3g} of its leaf's scale ({worst_path}; bound {TRAIN_GRAD_TOL})"
        + (f"; differing expert choices {diff}" if cfg.has_moe else ""))
    check(loss_rel <= TRAIN_LOSS_RTOL, f"{arch} lm_loss {float(total)} vs plain {float(p_total)}")
    check(worst <= TRAIN_GRAD_TOL, f"{arch} gradient {worst_path}: {worst:.3g} of its scale "
          f"(differing expert choices {diff})")
    del params, grads, p_grads
    torch.cuda.empty_cache()
    return {"gate_layers": cfg.n_layers, "gate_tokens": [b, s], "gate_loss_rel": loss_rel,
            "gate_grad_rel_max": worst, "gate_grad_rel_max_leaf": worst_path,
            "gate_choice_diff": diff}


def expert_backward_timing(arch: str, dev) -> list:
    """(c) The two K4 launches of an expert backward alone at the arch's
    train step (gate/up: x [E*C, D], w [E, D, F], dy [E*C, F]), bf16:
    dx = dy . w^T and dw = x^T . dy in the layouts ``_ExpertMatmul`` gives
    them, against their plain versions (GMM_TOL), ``torch.bmm`` over the
    same [E, C, *] views (transposes read in place) and their bounds."""
    cfg, run = get_config(arch), TRAIN_RUNS[arch]
    e, d, f = cfg.n_experts, cfg.d_model, cfg.expert_ff
    cap = moe._capacity(run["batch"] * run["seq"], cfg)
    tm, c2 = moe._tile_rows(cap), cap + (-cap % 16)
    te = torch.arange(e, dtype=torch.int32, device=dev).repeat_interleave(cap // tm)
    x, w, _ = gmm_inputs(dev, e * cap, d, f, e, tm, torch.bfloat16, SEED, te=te)
    dy = torch.randn((e * cap, f), device=dev).to(torch.bfloat16)
    wt = w.transpose(1, 2).contiguous()
    tmw = moe._tile_rows(d)
    tew = torch.arange(e, dtype=torch.int32, device=dev).repeat_interleave(d // tmw)
    xt = torch.nn.functional.pad(x.view(e, cap, d).transpose(1, 2), (0, c2 - cap)).reshape(e * d, c2)
    dye = torch.nn.functional.pad(dy.view(e, cap, f), (0, 0, 0, c2 - cap))
    rows = []
    for name, (a, b, tiles, rows_tm), lib in (
            ("dx", (dy, wt, te, tm), lambda: torch.bmm(dy.view(e, cap, f), w.transpose(1, 2))),
            ("dw", (xt, dye, tew, tmw), lambda: torch.bmm(x.view(e, cap, d).transpose(1, 2),
                                                          dy.view(e, cap, f)))):
        what = f"{arch} expert backward {name} [{a.shape[0]}, {a.shape[1]}] x {list(b.shape)}"
        got, err = gmm_check(a, b, tiles, rows_tm, what + " bfloat16")
        lib_err = float((lib().float().reshape(got.shape) - got).abs().max())
        check(lib_err <= LIB_TOL * max(1.0, float(got.abs().max())), f"bmm vs K4 {what}: {lib_err}")
        k_ms = time_ms(lambda: moe_gmm(a, b, tiles, tm=rows_tm), reps=10)
        p_ms = time_ms(lambda: ref.moe_gmm_ref(a, b, tiles, rows_tm), reps=3)
        lib_ms = time_ms(lib, reps=10)
        t, din = a.shape
        (b_ms, b_by), flops = gmm_bound(t, din, b.shape[2], e, rows_tm, 2)
        log(f"  K4 timing, {what} bf16: {k_ms:.4f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s, "
            f"{b_ms / k_ms:.2%} of the bound {b_ms:.4f} ms, {b_by}); plain {p_ms:.4f} ms; "
            f"torch.bmm {lib_ms:.4f} ms (K4 / bmm {k_ms / lib_ms:.2f}x)")
        rows.append({"arch": arch, "shape": what, "max_abs_err": err, "ms": k_ms,
                     "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                     "tflops": flops / k_ms / 1e9, "bmm_max_abs": lib_err})
        del got
    del x, w, dy, wt, xt, dye
    torch.cuda.empty_cache()
    return rows


def launch_train_archs(dev) -> dict:
    """(d) ``launch_train`` at the reduced configs of ``LAUNCH_ARCHS`` on
    the card: the loss falls over LAUNCH_STEPS steps."""
    out = {}
    for arch in LAUNCH_ARCHS:
        shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
        reset_counts()
        t0 = time.perf_counter()
        res = launch_train(arch, steps=LAUNCH_STEPS, batch=LAUNCH_BATCH, seq=LAUNCH_SEQ,
                           ckpt_dir=str(TRAIN_CKPT), log_every=LAUNCH_CKPT_EVERY,
                           ckpt_every=LAUNCH_STEPS, device=dev)
        train_s = time.perf_counter() - t0
        launched = counts()
        losses = [h["loss"] for h in res["history"]]
        cfg = get_reduced(arch)
        check(res["final_step"] == LAUNCH_STEPS and losses[-1] < losses[0],
              f"launch_train {arch}: {res['final_step']} steps, losses {losses}")
        check(launched["moe_gmm"] == LAUNCH_STEPS * 12 * moe_layers(cfg)
              and launched["flash_attention"] == LAUNCH_STEPS * 2 * attention_layers(cfg),
              f"launch_train {arch}: launches {launched}")
        log(f"  (d) launch_train({arch}, reduced, {LAUNCH_STEPS} steps of {LAUNCH_BATCH} x "
            f"{LAUNCH_SEQ}) on the card in {train_s:.2f} s: loss "
            f"{' -> '.join(f'{x:.4f}' for x in losses)}; K5 {launched['flash_attention']}, K4 "
            f"{launched['moe_gmm']} launches")
        out[arch] = {"losses": losses, "s": train_s, "k5": launched["flash_attention"],
                     "k4": launched["moe_gmm"]}
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    return out


def phase_train_archs(dev) -> tuple:
    """Phase 16: (a) train steps and (b) the float32 gate of each
    architecture but granite, (c) the expert backward's K4 launches alone,
    (d) ``launch_train``. Returns (K5 and K4 launches of the train steps by
    arch, K4 backward timings, info)."""
    # llama4's step peaks at ~77 GB of the card's 85; in fixed-size
    # segments the caching allocator left 9.4 GiB of it reserved but
    # unusable there. Segments that grow in place leave none.
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    launches, info = {}, {}
    for arch in TRAIN_RUNS:
        t0 = time.perf_counter()
        log(f"  -- {arch}")
        launched, row = arch_train(arch, dev)
        if arch in TRAIN_GATES:
            row.update(arch_train_gate(arch, dev))
        launches[arch] = launched
        info[arch] = row
        log(f"  {arch}: {time.perf_counter() - t0:.1f} s")
    k4_bwd = [row for arch in ("qwen3-moe-30b-a3b", "llama4-scout-17b-a16e")
              for row in expert_backward_timing(arch, dev)]
    info["launch_train"] = launch_train_archs(dev)
    return launches, k4_bwd, info


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    log("[1] card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, L2 "
        f"{torch.cuda.get_device_properties(0).L2_cache_size} bytes")

    log("[2] build")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        lib_paths = list(pool.map(_build.build, _build.SOURCES))
    for load in (_build.load_gustavson, _build.load_flash_attention, _build.load_bsr_spmm,
                 _build.load_moe_gmm):
        load()
    log(f"  built {', '.join(str(p.relative_to(ROOT)) for p in lib_paths)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for lib_path in lib_paths:
        for line in lib_path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas {lib_path.name.split('-')[0]}: " + line.strip())
    k4_lib, k5_lib = _build.load_moe_gmm(), _build.load_flash_attention()
    k3_lib, k1_lib = _build.load_bsr_spmm(), _build.load_gustavson()
    log("  dynamic shared memory of the tensor-core kernels (bytes per block): K4 bf16 "
        + ", ".join(f"tm {tm}: {k4_lib.moe_gmm_smem_bytes(1, tm)}" for tm in (128, 64, 32, 16, 8))
        + "; K3 bf16 " + ", ".join(f"M {m}: {k3_lib.bsr_spmm_smem_bytes(1, m)} "
                                   f"({k3_lib.bsr_spmm_blocks_per_sm(1, m)} blocks per SM)"
                                   for m in (BSR_FULL["m"], 128, 64, 32, 16, 8))
        + "; K5 bf16 " + ", ".join(f"D {d}: {k5_lib.flash_attention_smem_bytes(1, d)}"
                                   for d in (64, 128, 256)))
    ring = {}
    for dt, name in ((0, "float32"), (1, "bfloat16")):
        for tile in RUN_TILES:
            smem = k1_lib.gustavson_spgemm_smem_bytes(dt, *tile)
            blocks = k1_lib.gustavson_spgemm_blocks_per_sm(dt, *tile)
            threads = k1_lib.gustavson_spgemm_threads(dt, *tile)
            check(smem > 0 and blocks > 0 and threads > 0, f"K1 occupancy at {tile} {name}")
            ring[f"{name} {tile}"] = (smem, threads, blocks)
    log("  K1 ring (3 stages, each 32 deep along k where bk allows, else 16; dynamic shared "
        "memory bytes, threads, blocks per SM): "
        + "; ".join(f"{k}: {v}" for k, v in ring.items()))

    log("[3] kernel vs plain version")
    phase_kernel_checks(dev)

    log("[4] main path: poisson3Da")
    a, plan, launched, chunk = phase_main_path(dev, rng)

    log("[5] 2cubes_sphere")
    a2, plan2 = phase_second_matrix(dev, rng)

    log("[5b] poisson3Da, a plan built on bfloat16 values")
    bf16_plan = phase_bf16_plan(a, dev, rng)

    log("[5c] compact output: poisson3Da and 2cubes_sphere")
    compact_plans, compact_info = phase_compact(
        {"poisson3Da": (a, plan), "2cubes_sphere": (a2, plan2)}, dev, rng)
    del compact_plans["2cubes_sphere"]

    log("[5d] chain: poisson3Da (A·A)·B2, float32 and bfloat16")
    chain_info = phase_chain(a, compact_plans.pop("poisson3Da"),
                             compact_info["poisson3Da"]["plan_s"], dev, rng)

    log("[5e] pipeline: poisson3Da, submit/collect at depths 1, 2 and 4")
    pipe_info = phase_pipeline(plan, dev)

    log("[5f] plan cache and disk tier: poisson3Da and 2cubes_sphere")
    t0 = time.perf_counter()
    cache_info = phase_cache({"poisson3Da": (a, plan), "2cubes_sphere": (a2, plan2)}, dev)
    cache_info["phase_s"] = time.perf_counter() - t0
    log(f"  phase 5f: {cache_info['phase_s']:.1f} s")

    log("[5g] sharded plans on one card: poisson3Da x1/2/4/8, 2cubes_sphere x4")
    t0 = time.perf_counter()
    shard_info = phase_sharded(
        {name: (m, p, spgemm_plan(m, m, tile=TILE, group=GROUP, device=dev, output="compact"))
         for name, m, p in (("poisson3Da", a, plan), ("2cubes_sphere", a2, plan2))}, dev)
    shard_info["phase_s"] = time.perf_counter() - t0
    log(f"  phase 5g: {shard_info['phase_s']:.1f} s")
    shutil.rmtree(PLAN_STORE, ignore_errors=True)

    log("[5h] autotune: poisson3Da, tiles {32, 64, 128} x groups {2, 4, 8}; the chunk knee")
    t0 = time.perf_counter()
    tune_info, tuned = phase_autotune(a, dev)
    tune_info["phase_s"] = time.perf_counter() - t0
    log(f"  phase 5h: {tune_info['phase_s']:.1f} s")

    log("[5i] gateway: tenants p3da (A·A) and p3da-b2 (A·B2), fairness, overload")
    t0 = time.perf_counter()
    gw_info = phase_gateway(a, plan, tuned, dev)
    gw_info["phase_s"] = time.perf_counter() - t0
    log(f"  phase 5i: {gw_info['phase_s']:.1f} s")
    del tuned
    shutil.rmtree(TUNE_STORE, ignore_errors=True)

    log("[5j] static analysis: poisson3Da and 2cubes_sphere validated plans through K1/K2, "
        "the launch lint, a corrupted artifact, the lock-order lint, OMAR")
    t0 = time.perf_counter()
    analysis_info = phase_analysis(dev, rng)
    analysis_info["phase_s"] = time.perf_counter() - t0
    log(f"  phase 5j: {analysis_info['phase_s']:.1f} s")

    log("[6] flash attention vs plain version")
    phase_attention_checks(dev)

    log("[7] granite-3-2b, float32: prefill, dense path, teacher-forced decode")
    params16, lm = phase_lm_float32(dev)

    log("[8] granite-3-2b, bfloat16: prefill, dense path, BatchedServer")
    lm.update(phase_lm_bfloat16(params16, dev))

    log("[9] timings")
    entries, extra = phase_timings(a, plan, launched, chunk, dev, rng)
    extra.update(bf16_plan)
    extra.update({"compact": compact_info, "chain": chain_info, "pipeline": pipe_info,
                  "cache": cache_info, "sharded": shard_info, "autotune": tune_info,
                  "gateway": gw_info, "analysis": analysis_info})
    del plan
    phase_second_timings(a2, plan2, dev, rng, extra)
    del plan2
    default_cache().clear()  # the SpGEMM plans of phases 4-5g
    torch.cuda.empty_cache()
    k5_entry = phase_lm_timings(params16, lm, dev, extra)
    del params16
    torch.cuda.empty_cache()

    log("[10] block-sparse SpMM (K3) vs plain version; granite's SparseLinear at full width")
    k3_entry, k3_extra = phase_bsr(dev)
    extra.update(k3_extra)

    log("[11] grouped matmul (K4) vs plain version; qwen3's expert shapes")
    k4_timing, k4_extra = phase_gmm(dev)
    extra.update(k4_extra)

    log(f"[12] {MOE_ARCH}, float32, {MOE_F32_LAYERS} layers: prefill, plain path, "
        "teacher-forced decode")
    extra.update(phase_moe_float32(dev))

    log(f"[13] {MOE_ARCH}, bfloat16 weights, 48 layers: prefill, plain path, BatchedServer, "
        "timings")
    params, cfg, moe_launched, moe_info = phase_moe_bfloat16(dev)
    extra.update(moe_info)
    extra.update(phase_moe_timings(params, cfg, dev))
    del params
    torch.cuda.empty_cache()

    log("[14] training: the attention VJP; granite-3-2b float32 (4 layers) gradients, K5 vs "
        "plain; 3 full-width, full-depth bf16 train steps; launch_train, checkpoints, resume")
    t0 = time.perf_counter()
    vjp_launches = phase_train_attention(dev)
    log(f"  (a) K5 launches in the VJP checks: {vjp_launches}")
    extra["train_vjp_check_k5_launches"] = vjp_launches
    extra.update(phase_train_float32(dev))
    train_launches, train_info = phase_train_full(dev)
    extra.update(train_info)
    extra.update(phase_launch_train(dev))
    extra["train_phase_s"] = time.perf_counter() - t0

    log("[15] architectures: hubert-xlarge, command-r-35b, yi-9b, h2o-danube-3-4b, "
        "mamba2-130m, llama4-scout-17b-a16e, paligemma-3b, jamba-v0.1-52b at full width")
    t0 = time.perf_counter()
    arch_launches, k5_shapes, k4_shapes, arch_info = phase_archs(dev)
    extra["archs"] = arch_info
    extra["archs_phase_s"] = time.perf_counter() - t0
    log(f"  phase 15: {extra['archs_phase_s']:.1f} s")

    log("[16] training the other nine architectures at full width: train steps, float32 "
        "gradient gates, the expert backward's K4 launches alone, launch_train")
    t0 = time.perf_counter()
    train_arch_launches, k4_backward, extra["train_archs"] = phase_train_archs(dev)
    extra["train_archs_phase_s"] = time.perf_counter() - t0
    log(f"  phase 16: {extra['train_archs_phase_s']:.1f} s")
    k5_entry["launches_by_path"] = {"prefill": k5_entry["launches"],
                                    f"train_step x{TRAIN_STEPS}": train_launches}
    k5_entry["launches"] += train_launches
    k4_entry = {
        "name": "moe_gmm", "route": "cuda", "source": SOURCE_K4,
        "replaces": "src/repro/kernels/moe_gmm.py:49", "launches": moe_launched["moe_gmm"],
        **k4_timing, "launches_by_path": {f"{MOE_ARCH} prefill": moe_launched["moe_gmm"]},
    }
    for path, by_arch in (("prefill", arch_launches),
                          (f"train step x{ARCH_TRAIN_STEPS}", train_arch_launches)):
        for arch, launched in by_arch.items():
            for entry in (k5_entry, k4_entry):
                n = launched[entry["name"]]
                if n:
                    entry["launches_by_path"][f"{arch} {path}"] = n
                    entry["launches"] += n
    k5_entry["shapes"], k4_entry["shapes"] = k5_shapes, k4_shapes
    k4_entry["backward_shapes"] = k4_backward
    entries += [k3_entry, k4_entry, k5_entry]
    extra["total_s"] = time.perf_counter() - t_start
    log("timing " + json.dumps(extra))
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--token-restart"]:
        sys.exit(token_restart(sys.argv[2]))
    if sys.argv[1:2] == ["--autotune-restart"]:
        sys.exit(autotune_restart(sys.argv[2]))
    sys.exit(main())
