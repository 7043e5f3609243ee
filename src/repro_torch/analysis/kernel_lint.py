"""Static lint of the block-Gustavson kernel's launch (K1/K2): the Hopper
counterpart of the JAX package's lint over its ``pallas_call`` specs.

Two layers, both execution-free:

* :func:`lint_kernel_module` — a source lint of the kernel's wrapper
  (``kernels/gustavson_spgemm.py``, by AST) and of its CUDA source
  (``kernels/csrc/gustavson_spgemm.cu``, by text): float32 accumulation
  (the wrapper allocates a float32 output; the kernel takes ``float* out``
  and sums into float registers), the launch geometry the verifier's race
  proof rests on (``grid = (n_panels * group, bsz)``, one block per output
  tile, block x the tile and block y the batch element), the tile and
  batch refusals of wrapper and library, and the constants of the Python
  shared-memory mirror (:func:`k1_smem_bytes`) equal to the source's.
* :func:`lint_plan_kernel_specs` — given a built plan, check what one
  launch of K1/K2 for it assumes: tile dims multiples of 16 in [16, 128];
  ``1 <= bsz <= 65535`` and ``n_panels * group`` within grid x; every
  ``a_slot``/``b_slot`` of the runs, with batch element ``e``'s offset
  ``e * nnzb``, inside ``[0, bsz * nnzb)``; the output
  ``[bsz, n_panels, group * bm, bn]`` float32; blocks contiguous and every
  block and 16-byte copy aligned; the stage count within int32; the
  threads per block within the kernel's launch bound; and the launch's
  dynamic shared memory (:func:`k1_smem_bytes`) within the device's
  opt-in limit (``cudaDevAttrMaxSharedMemoryPerBlockOptin``; off the card,
  the H100's 227 KiB).

TPU checks with no counterpart here:

* ``dimension_semantics`` — a CUDA grid declares no axis semantics: its
  blocks share nothing and may run in any order. What ``"parallel"``
  asserted is proved instead by :func:`repro_torch.analysis.verify.check_schedule_runs`
  (each block writes only its own tile, from its own run).
* the ``BlockSpec`` index maps over every grid step — K1 has no block
  specs. Its reads are addressed by the run arrays, whose bounds with the
  batch offsets are linted here; there is no padded grid and no dummy
  panel in the launch.
* the per-step VMEM working set against ``TPU_VMEM_BYTES`` — replaced by
  the dynamic shared memory of the ``cp.async`` ring against the
  device's opt-in limit. It depends on the tile alone, not on ``group``:
  a block keeps its output tile in registers.
* the MXU dot's ``preferred_element_type`` — K1 has no dot: float32 FMAs
  (bfloat16 blocks widened exactly), checked in the source.
"""
from __future__ import annotations

import ast
import inspect
import re
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.verify import Finding, _err

__all__ = [
    "H100_SMEM_OPTIN_BYTES",
    "K1_MAX_THREADS",
    "K1_STAGES",
    "device_smem_limit",
    "k1_config",
    "k1_smem_bytes",
    "k1_threads",
    "lint_launch_config",
    "lint_kernel_module",
    "lint_plan_kernel_specs",
]

# The kernel's ring depth and launch bound (csrc/gustavson_spgemm.cu
# kStages, kMaxThreads; lint_kernel_module holds them to the source).
K1_STAGES = 3
K1_MAX_THREADS = 256
# H100's opt-in dynamic shared memory per block (227 KiB), the limit the
# lint holds a launch to where no CUDA device can be asked.
H100_SMEM_OPTIN_BYTES = 227 * 1024
_GRID_X_MAX = 2 ** 31 - 1
_GRID_Y_MAX = 65535
_INT32_MAX = 2 ** 31 - 1
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
_SOURCE = Path(__file__).resolve().parents[1] / "kernels" / "csrc" / "gustavson_spgemm.cu"


def _tile_dim_ok(d: int) -> bool:
    return 16 <= d <= 128 and d % 16 == 0


def k1_config(bm: int, bk: int, bn: int) -> Tuple[int, int, int]:
    """``(tm, tn, kc)`` of a launch at this tile: outputs per thread and
    the stage depth along k (mirror of the source's ``config()``)."""
    kc = 32 if bk % 32 == 0 else 16
    tm = tn = 4
    if bm * bn >= 64 * 64:
        tm = 8
        tn = 4 if (bm // 8) * (bn // 4) <= K1_MAX_THREADS else 8
    return tm, tn, kc


def k1_smem_bytes(dtype: torch.dtype, bm: int, bk: int, bn: int) -> int:
    """Dynamic shared memory (bytes) of a K1/K2 launch at this tile and
    block dtype, 0 for a tile the kernel refuses: mirror of the source's
    ``smem_bytes<T, KC>``. Each of the ``K1_STAGES`` ring stages holds A's
    ``bm x (KC + 16/itemsize)`` chunk (one 16-byte pad per row) and B's
    ``KC x bn`` chunk; bfloat16 blocks add one float32 stage, the widened
    chunk the multiply reads."""
    if not all(_tile_dim_ok(d) for d in (bm, bk, bn)):
        return 0
    itemsize = _ITEMSIZE[dtype]
    kc = k1_config(bm, bk, bn)[2]

    def stage_elems(vec: int) -> int:
        return bm * (kc + vec) + kc * bn

    ring = itemsize * K1_STAGES * stage_elems(16 // itemsize)
    return ring if itemsize == 4 else ring + 4 * stage_elems(4)


def k1_threads(bm: int, bk: int, bn: int) -> int:
    """Threads per block of a launch at this tile (0 if refused)."""
    if not all(_tile_dim_ok(d) for d in (bm, bk, bn)):
        return 0
    tm, tn, _ = k1_config(bm, bk, bn)
    return (bm // tm) * (bn // tn)


def device_smem_limit(device=None) -> int:
    """The opt-in dynamic shared memory per block of ``device``
    (``cudaDevAttrMaxSharedMemoryPerBlockOptin``, as PyTorch reports it),
    or :data:`H100_SMEM_OPTIN_BYTES` for a non-CUDA device."""
    device = torch.device(device if device is not None else "cpu")
    if device.type != "cuda":
        return H100_SMEM_OPTIN_BYTES
    props = torch.cuda.get_device_properties(device)
    return int(props.shared_memory_per_block_optin)


def lint_launch_config(
    tile: Tuple[int, int, int],
    dtype: torch.dtype,
    *,
    bsz: int = 1,
    smem_limit: Optional[int] = None,
) -> List[Finding]:
    """The plan-independent half of :func:`lint_plan_kernel_specs`: the
    tile, the batch width, the threads per block and the dynamic shared
    memory of one launch at ``tile`` on ``dtype`` blocks, against
    ``smem_limit`` (default :data:`H100_SMEM_OPTIN_BYTES`)."""
    findings: List[Finding] = []
    bm, bk, bn = (int(d) for d in tile)
    for name, d in (("bm", bm), ("bk", bk), ("bn", bn)):
        if not _tile_dim_ok(d):
            _err(findings, "kernel.tile-dims",
                 f"{name}={d}: the kernel takes tile dims that are multiples "
                 f"of 16 from 16 to 128")
    if dtype not in _ITEMSIZE:
        _err(findings, "kernel.block-dtype",
             f"blocks of {dtype}: the kernel takes float32 or bfloat16")
    if not 1 <= bsz <= _GRID_Y_MAX:
        _err(findings, "kernel.grid",
             f"bsz={bsz} outside grid y's [1, {_GRID_Y_MAX}]")
    if findings:
        return findings
    threads = k1_threads(bm, bk, bn)
    if not 0 < threads <= K1_MAX_THREADS:
        _err(findings, "kernel.threads",
             f"{threads} threads per block at tile {tile}: the kernel's "
             f"launch bound is {K1_MAX_THREADS}")
    limit = H100_SMEM_OPTIN_BYTES if smem_limit is None else int(smem_limit)
    smem = k1_smem_bytes(dtype, bm, bk, bn)
    if smem > limit:
        _err(findings, "kernel.smem",
             f"{smem} B of dynamic shared memory at tile {tile} "
             f"({str(dtype).replace('torch.', '')} blocks) exceeds the "
             f"device's opt-in {limit} B per block")
    return findings


def _slot_bounds(findings, what: str, slots: np.ndarray, nnzb: int, bsz: int) -> None:
    """Batch element ``e`` reads block ``e * nnzb + slot`` of the stacked
    operand ``[bsz * nnzb, ...]``: every such index in ``[0, bsz * nnzb)``
    (exactly when every slot is in ``[0, nnzb)``; a slot past ``nnzb`` also
    reads the next element's blocks)."""
    if not slots.size:
        return
    bad = (slots < 0) | (slots >= nnzb)
    if bad.any():
        i = int(np.argmax(bad))
        s = int(slots[i])
        e = 0 if s < 0 else bsz - 1
        _err(findings, "kernel.index-map.batch",
             f"{what}[{i}] = {s}: batch element {e} reads block "
             f"{e * nnzb + s} of [0, {bsz * nnzb})"
             + ("" if s < 0 or bsz == 1 else f" (element 0 reads element 1's block {s - nnzb})"))


def lint_plan_kernel_specs(
    plan, bsz: int = 2, smem_limit: Optional[int] = None,
) -> List[Finding]:
    """Check what a K1/K2 launch for ``plan`` assumes (see the module
    doc), at batch width ``bsz``. The run arrays are the ones the plan's
    executor staged (per shard for sharded plans), else the host
    regrouping of the schedule. ``smem_limit`` defaults to the opt-in limit
    of the plan's device (:func:`device_smem_limit`)."""
    from repro_torch.analysis.verify import _staged_runs
    from repro_torch.kernels.gustavson_spgemm import stage_runs

    findings: List[Finding] = []
    nnzb_a = int(plan._a_shape[0]) if len(plan._a_shape) == 3 else 0
    nnzb_b = int(plan._b_shape[0]) if len(plan._b_shape) == 3 else 0
    if not plan.schedule.num_triples or not nnzb_a or not nnzb_b:
        return findings  # empty plan: no kernel is ever launched
    bm, bk = int(plan._a_shape[1]), int(plan._a_shape[2])
    bn = int(plan._b_shape[2])
    if smem_limit is None:
        smem_limit = device_smem_limit(plan.device)
    findings += lint_launch_config((bm, bk, bn), plan._a_dtype, bsz=bsz, smem_limit=smem_limit)
    if plan._b_dtype != plan._a_dtype:
        _err(findings, "kernel.block-dtype",
             f"A blocks {plan._a_dtype}, B blocks {plan._b_dtype}: the launch "
             f"takes one dtype for both")
    if tuple(plan._b_shape[1:2]) != (bk,):
        _err(findings, "kernel.block-shape",
             f"A blocks {plan._a_shape} and B blocks {plan._b_shape} differ in "
             f"the inner dim")
    # Each block is one contiguous [rows, cols] run of the stacked array;
    # every cp.async copy moves 16 bytes of one row, so block starts and
    # rows must be 16-byte aligned (given a 16-byte aligned base).
    itemsize = _ITEMSIZE.get(plan._a_dtype, 4)
    for what, rows, cols in (("A", bm, bk), ("B", bk, bn)):
        if (cols * itemsize) % 16 or (rows * cols * itemsize) % 16:
            _err(findings, "kernel.block-align",
                 f"{what} blocks [{rows}, {cols}] of {itemsize}-byte values: "
                 f"rows or blocks not 16-byte aligned")
    with plan._lock:
        staged = [(name, t) for name, t in (("A", plan._a_dev), ("B", plan._b_dev))
                  if isinstance(t, torch.Tensor)]
    for name, t in staged:
        if not t.is_contiguous() or t.data_ptr() % 16:
            _err(findings, "kernel.block-align",
                 f"staged {name} blocks not contiguous or not 16-byte aligned")
    sharded = hasattr(plan, "_shards") and getattr(plan, "n_shards", 0) > 0
    runs_by_part = _staged_runs(plan)
    if not runs_by_part:
        runs_by_part = {0: stage_runs(plan.schedule, "cpu")} if not sharded else {
            i: stage_runs(sh.schedule, "cpu")
            for i, sh in enumerate(plan._shards) if sh.num_triples}
    chunks = bk // k1_config(bm, bk, bn)[2] if _tile_dim_ok(bk) else 1
    for i, runs in sorted(runs_by_part.items()):
        local_a = (plan._shards[i].a_hi - plan._shards[i].a_lo) if sharded else nnzb_a
        label = f"shard {i} " if sharded else ""
        n_tiles = runs.n_panels * runs.group
        if not 1 <= n_tiles <= _GRID_X_MAX:
            _err(findings, "kernel.grid",
                 f"{label}n_panels * group = {n_tiles} outside grid x's [1, {_GRID_X_MAX}]")
        a_slot = runs.a_slot.cpu().numpy()
        b_slot = runs.b_slot.cpu().numpy()
        if a_slot.shape[0] * chunks > _INT32_MAX:
            _err(findings, "kernel.int-range",
                 f"{label}{a_slot.shape[0]} triples x {chunks} stages overflow the "
                 f"kernel's int32 stage count")
        _slot_bounds(findings, f"{label}run a_slot", a_slot, local_a, bsz)
        _slot_bounds(findings, f"{label}run b_slot", b_slot, nnzb_b, bsz)
        want = (bsz, runs.n_panels, runs.group * bm, bn)
        got = (bsz, plan.schedule.n_panels if not sharded else plan._shards[i].n_panels,
               plan._group * bm, bn)
        if want != got:
            _err(findings, "kernel.output-shape",
                 f"{label}the launch writes [bsz, n_panels, group*bm, bn] = {want}, the "
                 f"plan's panels are {got}")
    return findings


# -- the source lint ---------------------------------------------------------------


def _dotted(node: ast.AST) -> str:
    """'torch.float32' for an Attribute/Name chain, '' otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _wrapper_launch_fn():
    from repro_torch.kernels import gustavson_spgemm

    tree = ast.parse(inspect.getsource(gustavson_spgemm))
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == "_launch":
            return node
    return None


def _lint_wrapper(findings: List[Finding]) -> None:
    fn = _wrapper_launch_fn()
    if fn is None:
        _err(findings, "kernel.launch-geometry", "_launch not found in the wrapper")
        return
    out_dtype = None
    tiles_arg = None
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and any(_dotted(t) == "out" for t in node.targets)
                and isinstance(node.value, ast.Call)
                and _dotted(node.value.func) == "torch.empty"):
            for kw in node.value.keywords:
                if kw.arg == "dtype":
                    out_dtype = _dotted(kw.value)
        if isinstance(node, ast.Call) and _dotted(node.func).endswith("gustavson_spgemm_launch"):
            # (a, b, ptr, run_a, run_b, out, dtype, bsz, n_tiles, ...)
            if len(node.args) > 8:
                tiles_arg = ast.unparse(node.args[8])
    if out_dtype != "torch.float32":
        _err(findings, "kernel.accum-dtype",
             f"_launch allocates its output as {out_dtype!r}, expected torch.float32")
    if tiles_arg != "runs.n_panels * runs.group":
        _err(findings, "kernel.launch-geometry",
             f"_launch passes n_tiles = {tiles_arg!r}; grid x must be "
             f"runs.n_panels * runs.group, one block per output tile")
    src = ast.unparse(fn)
    for needle, what in (("d % 16 or not 16 <= d <= 128", "tile dims outside [16, 128] step 16"),
                         ("bsz > 65535", "bsz past grid y")):
        if needle not in src:
            _err(findings, "kernel.refusals", f"_launch does not refuse {what}")


_SOURCE_RULES = (
    ("kernel.accum-dtype", r"float\*\s+__restrict__\s+out\b",
     "the kernel's output is not float* out"),
    ("kernel.accum-dtype", r"float\s+acc\[TM\]\[TN\]", "the accumulators are not float"),
    ("kernel.accum-dtype", r"static_cast<float\*>\(g\.out\)", "the launch does not pass float* out"),
    ("kernel.launch-geometry", r"<<<\s*dim3\(\s*g\.n_tiles\s*,\s*g\.bsz\s*\)",
     "the grid is not dim3(n_tiles, bsz)"),
    ("kernel.launch-geometry", r"const int tile = blockIdx\.x;", "block x is not the tile"),
    ("kernel.launch-geometry", r"const long long elem = blockIdx\.y;",
     "block y is not the batch element"),
    ("kernel.launch-geometry", r"__launch_bounds__\(kMaxThreads\)",
     "the kernel's launch bound is not kMaxThreads"),
    ("kernel.refusals", r"d >= 16 && d <= 128 && d % 16 == 0",
     "tile_dim_ok does not take multiples of 16 from 16 to 128"),
    ("kernel.refusals", r"bsz > 65535", "the library does not refuse bsz past grid y"),
    ("kernel.smem-mirror", r"bk % 32 == 0 \? 32 : 16", "the stage depth rule differs from k1_config"),
    ("kernel.smem-mirror", r"bm \* bn >= 64 \* 64", "the thread-tile rule differs from k1_config"),
    ("kernel.smem-mirror", r"kLda = KC \+ kVec", "the stage row pad differs from k1_smem_bytes"),
)


def _lint_source(findings: List[Finding], text: str) -> None:
    for check, pattern, message in _SOURCE_RULES:
        if re.search(pattern, text) is None:
            _err(findings, check, f"{_SOURCE.name}: {message}")
    for name, want in (("kStages", K1_STAGES), ("kMaxThreads", K1_MAX_THREADS)):
        m = re.search(rf"constexpr int {name} = (\d+);", text)
        if m is None or int(m.group(1)) != want:
            got = None if m is None else int(m.group(1))
            _err(findings, "kernel.smem-mirror",
                 f"{_SOURCE.name}: {name} = {got}, the mirror assumes {want}")


def lint_kernel_module(source: Optional[str] = None) -> List[Finding]:
    """Source lint of K1/K2's wrapper and CUDA source (see the module
    doc). ``source`` replaces the CUDA source's text (for tests)."""
    findings: List[Finding] = []
    _lint_wrapper(findings)
    _lint_source(findings, _SOURCE.read_text() if source is None else source)
    return findings
