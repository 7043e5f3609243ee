"""One-card dry-run: count one step of every (architecture x input shape)
cell on the meta device, and extract the roofline's raw data.

The port of ``repro.launch.dryrun``. The reference lowers and compiles each
cell for a 512-device forced host mesh and reads XLA's analyses; here one
step runs at full width and full depth on PyTorch's meta device, where
every tensor has a shape and a dtype and no storage: nothing is allocated
and nothing is launched. The meta device stands for the card: attention
takes K5's route at every length and the MoE experts K4's
(:mod:`repro_torch.kernels.ops` gives each kernel a shape-only output and
its operation count there). For every cell this records into
``artifacts/dryrun_torch/<arch>__<shape>__h100.json``:

* ``cost``        — ``flops`` from ``torch.utils.flop_counter.FlopCounterMode``
  (matrix products and the kernels' counts; elementwise operations are not
  counted), and ``bytes``: each operation's input and output bytes, summed
  over the step's operations (views and bare allocations move none). That
  is the traffic of the unfused step, the counterpart of XLA's per-op
  ``bytes accessed``;
* ``memory``      — the step's bytes on one card: ``params_bytes``,
  ``grads_bytes`` and ``optimizer_bytes`` (train: AdamW's float32 m and v,
  and its float32 master copy where the params are not float32),
  ``cache_bytes`` (decode), the ``peak_bytes`` of the live meta storages
  (tracked by weak references as the step runs, the state included) and
  ``activation_peak_bytes``, the peak above the state and the inputs;
  beside them ``card_bytes`` (the card's memory where one is present, else
  the H100's 80 GiB, ``core/perfmodel.py``) and ``fits_one_card``;
* ``corrected``   — the reference's trip-count correction from unrolled
  one- and two-period counts (:func:`corrected_costs`); here a check;
* ``model``       — 6·N·D (dense) / 6·N_active·D (MoE), :func:`model_flops`.

``microbatches``: train counts one microbatch of the global batch and
scales by the reference's count ``u``; prefill counts one sequence of the
global batch, the unit a server prefills, and scales by the batch. The
record names the microbatch it counted (``microbatch``: batch, seq). A
train step of ``u`` > 1 microbatches also holds a float32 gradient
accumulator, which ``memory`` adds (its additions are not in ``bytes``).

No counterpart, each for its reason: the ``XLA_FLAGS`` line that forces
512 host devices (one card has no mesh: ``mesh`` is ``{"cards": 1}``);
``parse_collectives`` (``collectives`` is ``{}``: one card has no
collective); ``parse_upcast_bytes`` and ``peak_bytes_tpu_adjusted``, which
undo XLA:CPU's float32 copies of bf16 operands, which the meta device
never makes; ``lower_optimizer_only``: the optimizer is counted in the
step's own pass, marked off from the rest.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S] [--jobs N]
"""
from __future__ import annotations

import argparse
import functools
import json
import multiprocessing
import os
import threading
import time
import traceback
import weakref
from fractions import Fraction
from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.registry import ARCHS, SHAPES, ShapeSpec, cell_status, get_config
from repro_torch.core.perfmodel import H100_MEMORY_BYTES
from repro_torch.data.pipeline import batch_specs
from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig
from repro_torch.models.nn import FLOAT32_SUBTREES, Param, ParamTree
from repro_torch.models.tree import tree_leaves
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.steps import make_decode_step, make_prefill_step, make_train_step

__all__ = ["ART_DIR", "cell_config", "corrected_costs", "count_step", "lower_cell",
           "main", "meta_params", "model_flops", "run_cell"]

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")
CARD = "h100"

# Allocations that move no bytes.
_NO_TRAFFIC = frozenset({
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default,
})


# ---------------------------------------------------------------------------
# Counting on the meta device
# ---------------------------------------------------------------------------

def _is_view(func) -> bool:
    """True for an operation whose outputs alias its inputs without
    writing them (a view); in-place operations write and are counted."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _MetaCounter(TorchDispatchMode):
    """Sums every operation's input and output bytes (``bytes``) and
    tracks the live meta storages and their peak (``live``, ``peak``).
    A storage counts from the operation that makes it until its last
    reference goes (a weak reference's callback)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, weakref.ref] = {}
        self._lock = threading.Lock()  # the autograd engine may free in its thread

    def hold(self, tensors) -> None:
        """Count tensors made before the pass (state, inputs) as live."""
        for t in tensors:
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        with self._lock:
            if key in self._refs:
                return
            n = st.nbytes()
            self._refs[key] = weakref.ref(st, functools.partial(self._free, key, n))
            self.live += n
            self.peak = max(self.peak, self.live)

    def _free(self, key: int, n: int, _ref) -> None:
        with self._lock:
            if self._refs.pop(key, None) is not None:
                self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in pytree_leaves(out) if isinstance(t, torch.Tensor)]
        if func not in _NO_TRAFFIC and not _is_view(func):
            ins = [t for t in pytree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        return out


class _MarkedOptimizer:
    """The optimizer, with the counts (``now()``: FLOPs and bytes so far)
    read before and after its update, so that the step's optimizer part
    can be told from the rest."""

    def __init__(self, opt, now):
        self.opt, self.now, self.marks = opt, now, []

    def update(self, grads, state, params):
        self.marks.append(self.now())
        out = self.opt.update(grads, state, params)
        self.marks.append(self.now())
        return out


def meta_params(cfg: ModelConfig, *, trainable: bool = False,
                float32_routers: bool = False) -> nn.Module:
    """The parameter tree of ``init_lm`` on the meta device, from
    ``lm_template``'s shapes, in ``cfg.param_dtype`` (the routers in
    float32 with ``float32_routers``, as the server keeps them), drawing
    nothing."""
    def build(t, dtype):
        if isinstance(t, Param):
            return torch.empty(t.shape, dtype=dtype, device="meta")
        if isinstance(t, dict):
            return ParamTree({k: build(v, torch.float32 if float32_routers
                                       and k in FLOAT32_SUBTREES else dtype)
                              for k, v in t.items()}, trainable)
        return nn.ModuleList([build(v, dtype) for v in t])

    return build(tr.lm_template(cfg), cfg.params_dtype())


def _storage_bytes(tensors) -> int:
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def card_bytes() -> int:
    """The card's memory where one is present, else the H100's."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return H100_MEMORY_BYTES


def count_step(cfg: ModelConfig, kind: str, batch: int, seq: int, *,
               optimizer: Optional[AdamW] = None) -> Dict[str, Any]:
    """Count one ``kind`` step (``"train"``, ``"prefill"`` or
    ``"decode"``) of ``cfg`` over ``batch`` x ``seq`` on the meta device,
    through the port's own step functions (:mod:`repro_torch.runtime.steps`).

    ``seq`` is the model's sequence (a vision model's patches included);
    decode steps one token against a cache of ``seq`` positions. Train
    builds trainable params and ``optimizer``'s state (default: the
    reference's AdamW, lr 1e-4, weight decay 0.01, a float32 master copy);
    serving keeps the routers in float32, as the server does. Returns
    ``flops`` and ``bytes`` of the whole step, those of its ``optimizer``
    update, and ``memory``."""
    train = kind == "train"
    params = meta_params(cfg, trainable=train, float32_routers=not train)
    meta, fc = _MetaCounter(), FlopCounterMode(display=False)

    def now():
        return fc.get_total_flops(), meta.bytes

    state, cache = [], None
    if train:
        opt = _MarkedOptimizer(optimizer or AdamW(lr=1e-4, weight_decay=0.01, master=True),
                               now)
        opt_state = opt.opt.init(params)
        state = tree_leaves({k: v for k, v in opt_state.items() if k != "step"})
        inputs = batch_specs(cfg, batch, seq)
        run = functools.partial(make_train_step(cfg, opt), params, opt_state, inputs)
    elif kind == "prefill":
        inputs = {k: v for k, v in batch_specs(cfg, batch, seq).items()
                  if k not in ("labels", "mask")}
        run = functools.partial(make_prefill_step(cfg), params, inputs)
    elif kind == "decode":
        cache = tr._new_cache(cfg, batch, seq, torch.device("meta"))
        inputs = {"token": torch.empty((batch, 1), dtype=torch.int32, device="meta")}
        run = functools.partial(make_decode_step(cfg), params, cache, inputs["token"])
    else:
        raise ValueError(f"unknown step kind {kind!r}")
    p_leaves = list(params.parameters())
    cache_leaves = [v for d in (cache or {}).values() if isinstance(d, dict)
                    for v in d.values()]
    held = p_leaves + state + cache_leaves + list(inputs.values())
    t0 = time.perf_counter()
    with fc, meta:
        meta.hold(held)
        resident = meta.live
        out = run()
        del out
    count_s = time.perf_counter() - t0
    flops, nbytes = now()
    marks = opt.marks if train else []
    opt_flops = marks[1][0] - marks[0][0] if marks else 0
    opt_bytes = marks[1][1] - marks[0][1] if marks else 0
    params_bytes = _storage_bytes(p_leaves)
    return {
        "flops": flops, "bytes": nbytes,
        "optimizer": {"flops": opt_flops, "bytes": opt_bytes},
        "count_s": count_s,
        "memory": {
            "params_bytes": params_bytes,
            "grads_bytes": params_bytes if train else 0,
            "optimizer_bytes": _storage_bytes(state),
            "cache_bytes": _storage_bytes(cache_leaves),
            "input_bytes": _storage_bytes(list(inputs.values())),
            "activation_peak_bytes": meta.peak - resident,
            "peak_bytes": meta.peak,
        },
    }


# ---------------------------------------------------------------------------
# Cell construction
# ---------------------------------------------------------------------------

def cell_config(arch: str, shape: ShapeSpec, *, n_layers: Optional[int] = None,
                attn_block_q: Optional[int] = None,
                scan_unroll: bool = False) -> ModelConfig:
    """The reference's overrides field for field (bf16 params and
    compute, remat "full", blocked attention with ``attn_block_q`` for
    full sequences, ``n_layers`` rounded up to whole periods,
    ``scan_unroll``), but ``kernel_backend``: ``"cuda"``, the card's route
    (K5 at every prefill, K4 for the experts), where the reference takes
    its oracle (``"jnp"``). On the card's route ``attn_impl`` and
    ``attn_block_q`` choose nothing, and the layer loop is a Python loop
    whatever ``scan_unroll`` says; both are kept for the record."""
    cfg = get_config(arch)
    over: Dict[str, Any] = dict(
        dtype="bfloat16", param_dtype="bfloat16", remat="full",
        kernel_backend="cuda",
    )
    if shape.kind in ("prefill", "train"):
        over["attn_impl"] = "blocked"
        over["attn_block_q"] = attn_block_q or 1024
    else:
        over["attn_impl"] = "dense"
    if n_layers is not None:
        over["n_layers"] = max(n_layers, 1) * cfg.period
    over["scan_unroll"] = scan_unroll
    return cfg.with_(**over)


def _train_microbatches(arch: str, cfg: ModelConfig, shape: ShapeSpec) -> int:
    """The reference's gradient-accumulation count for the full
    architecture, on one card (a data-parallel width of 1)."""
    total_params = get_config(arch).param_counts()["total"]
    u = (16 if total_params > 90e9 else
         8 if total_params > 40e9 else
         4 if (cfg.d_model >= 4096 or cfg.n_experts >= 64
               or cfg.d_model * cfg.n_layers >= 80_000) else 1)
    return max(1, min(u, shape.global_batch))


def lower_cell(
    arch: str,
    shape: ShapeSpec,
    *,
    n_periods: Optional[int] = None,
    attn_block_q: Optional[int] = None,
    microbatches: Optional[int] = None,
    scan_unroll: bool = False,
    compile_only_cost: bool = False,
) -> Dict[str, Any]:
    """Count one cell variant on the meta device; returns its record.
    ``microbatches`` overrides the count (train: the reference's ``u``;
    prefill: the global batch, one sequence a pass); the step counted is
    one microbatch's, scaled by the count, the optimizer counted once."""
    cfg = cell_config(arch, shape, n_layers=n_periods,
                      attn_block_q=attn_block_q, scan_unroll=scan_unroll)
    if shape.kind == "train":
        u = microbatches or _train_microbatches(arch, cfg, shape)
    elif shape.kind == "prefill":
        u = microbatches or shape.global_batch
    else:
        u = 1
    mb = max(shape.global_batch // u, 1)
    t0 = time.perf_counter()
    c = count_step(cfg, shape.kind, mb, shape.seq_len)
    opt = c["optimizer"]
    rec: Dict[str, Any] = {
        "arch": arch,
        "shape": shape.name,
        "kind": shape.kind,
        "card": CARD,
        "mesh": {"cards": 1},
        "microbatches": u,
        "microbatch": [mb, shape.seq_len if shape.kind != "decode" else 1],
        "n_layers": cfg.n_layers,
        "attn_block_q": cfg.attn_block_q if shape.kind == "prefill" else None,
        "count_s": round(time.perf_counter() - t0, 2),
        "cost": {"flops": opt["flops"] + u * (c["flops"] - opt["flops"]),
                 "bytes": opt["bytes"] + u * (c["bytes"] - opt["bytes"])},
        "optimizer": opt,
        "collectives": {},
    }
    if not compile_only_cost:
        mem = dict(c["memory"])
        if shape.kind == "train" and u > 1:
            acc = mem["params_bytes"] // cfg.params_dtype().itemsize * 4
            mem["grads_bytes"] += acc
            mem["peak_bytes"] += acc
        mem["card_bytes"] = card_bytes()
        mem["fits_one_card"] = mem["peak_bytes"] <= mem["card_bytes"]
        rec["memory"] = mem
    return rec


def _as_number(x: Fraction):
    return int(x) if x.denominator == 1 else float(x)


def corrected_costs(arch: str, shape: ShapeSpec, full_rec: Dict[str, Any]) -> Dict[str, Any]:
    """Trip-count-corrected FLOPs / bytes, the reference's scheme.

    The reference's XLA counts a loop body once, so it rebuilds full-depth
    totals from unrolled one- and two-period sub-counts at microbatch
    scale (and, for attention in train and prefill, two query-block sizes
    to resolve the q-block scan):

      m(L, bq) = b + L * (p0 + gamma*bq)
      total    = opt + u * (b + n_periods * (p0 + gamma*S))

    On the meta device the layer loop is a Python loop, so the full-depth
    count is already exact and this correction is a check of it:
    ``matches_full_count`` says whether the corrected FLOPs equal
    ``full_rec``'s. The optimizer's part is rebuilt from the same
    sub-counts (it is linear in the depth too); the arithmetic is exact
    (integers and fractions). On the card's route ``gamma`` is 0: K5
    takes no query blocks."""
    cfg = get_config(arch)
    n_periods = cfg.n_layers // cfg.period
    u = full_rec.get("microbatches", 1)
    sub_shape = ShapeSpec(shape.name, shape.seq_len,
                          max(shape.global_batch // u, 1), shape.kind)

    def sub(n_p, bq=None):
        return lower_cell(arch, sub_shape, n_periods=n_p, attn_block_q=bq,
                          microbatches=1, scan_unroll=True, compile_only_cost=True)

    def costs(rec):  # (step without the optimizer, optimizer), flops and bytes
        o = rec["optimizer"]
        return ([Fraction(rec["cost"]["flops"] - o["flops"]),
                 Fraction(rec["cost"]["bytes"] - o["bytes"])],
                [Fraction(o["flops"]), Fraction(o["bytes"])])

    use_bq = cfg.has_attention and shape.kind in ("train", "prefill")
    if not use_bq:
        r1, r2 = sub(1), sub(2)
        (c1, o1), (c2, o2) = costs(r1), costs(r2)
        per_period = [y - x for x, y in zip(c1, c2)]
        b = [x - p for x, p in zip(c1, per_period)]
        subs = [r1, r2]
        method = f"unrolled L1/L2 x u={u}"
    else:
        bq1, bq2 = 1024, 512
        r1a, r2a, r1b = sub(1, bq1), sub(2, bq1), sub(1, bq2)
        (c1, o1), (c2, o2), (c1b, _) = costs(r1a), costs(r2a), costs(r1b)
        pa = [y - x for x, y in zip(c1, c2)]  # p0 + gamma*bq1
        gamma = [max((x - y) / (bq1 - bq2), Fraction(0)) for x, y in zip(c1, c1b)]
        per_period = [p - g * bq1 + g * shape.seq_len for p, g in zip(pa, gamma)]
        b = [x - p for x, p in zip(c1, pa)]
        subs = [r1a, r2a, r1b]
        method = f"unrolled L1/L2 x bq1/bq2 x u={u}"
    b = [max(x, Fraction(0)) for x in b]
    per_period = [max(x, Fraction(0)) for x in per_period]
    opt_p = [y - x for x, y in zip(o1, o2)]
    opt = [x + (n_periods - 1) * p for x, p in zip(o1, opt_p)]
    if shape.kind == "train":
        method += " + opt"
    u_eff = u if shape.kind in ("train", "prefill") else 1
    total = [o + u_eff * (x + n_periods * p) for o, x, p in zip(opt, b, per_period)]
    out = {
        "method": method,
        "flops": _as_number(total[0]),
        "bytes": _as_number(total[1]),
        "collective_bytes": 0,
        "per_period": {"flops": _as_number(per_period[0]),
                       "bytes": _as_number(per_period[1]),
                       "collective_bytes": 0},
        "sub_counts": [{k: r.get(k) for k in ("n_layers", "attn_block_q", "cost", "count_s")}
                       for r in subs],
        "collectives": {},
        "full_count_flops": full_rec["cost"]["flops"],
    }
    out["matches_full_count"] = out["flops"] == full_rec["cost"]["flops"]
    return out


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, float]:
    n = cfg.param_counts()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    fwd = 2.0 * n["active"] * tokens
    mult = 3.0 if shape.kind == "train" else 1.0  # fwd + bwd(2x)
    return {
        "model_flops": mult * fwd,
        "tokens": tokens,
        "params_total": n["total"],
        "params_active": n["active"],
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, out_dir: str,
             with_correction: bool = True) -> Dict[str, Any]:
    """Count one cell (or record its skip) and write its JSON. Raises if
    the correction disagrees with the full-depth count."""
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    runs, reason = cell_status(cfg, shape)
    cell_id = f"{arch}__{shape_name}__{CARD}"
    out_path = os.path.join(out_dir, cell_id + ".json")
    os.makedirs(out_dir, exist_ok=True)
    if not runs:
        rec = {"arch": arch, "shape": shape_name, "card": CARD, "mesh": {"cards": 1},
               "status": "skipped", "reason": reason}
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[dryrun] {cell_id}: SKIP ({reason})")
        return rec

    t0 = time.perf_counter()
    rec = lower_cell(arch, shape)
    rec["status"] = "ok"
    rec["model"] = model_flops(cfg, shape)
    if with_correction:
        rec["corrected"] = corrected_costs(arch, shape, rec)
    rec["total_s"] = round(time.perf_counter() - t0, 2)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    mem = rec["memory"]
    print(f"[dryrun] {cell_id}: OK peak={mem['peak_bytes'] / 2**30:.2f}GiB "
          f"({'fits' if mem['fits_one_card'] else 'does not fit'} "
          f"{mem['card_bytes'] / 2**30:.2f}GiB) flops={rec['cost']['flops']:.3e} "
          f"bytes={rec['cost']['bytes']:.3e} u={rec['microbatches']} ({rec['total_s']}s)",
          flush=True)
    if with_correction and not rec["corrected"]["matches_full_count"]:
        raise ValueError(f"{cell_id}: corrected flops {rec['corrected']['flops']} != "
                         f"full-depth count {rec['cost']['flops']}")
    return rec


def _sweep_cell(arch: str, shape: str, out_dir: str, with_correction: bool) -> Optional[str]:
    """:func:`run_cell`, with a failure recorded in the cell's JSON and
    printed with its traceback; returns the failed cell's id, else None."""
    try:
        run_cell(arch, shape, out_dir, with_correction=with_correction)
        return None
    except Exception as e:  # keep sweeping; record the failure
        cell_id = f"{arch}__{shape}__{CARD}"
        with open(os.path.join(out_dir, cell_id + ".json"), "w") as f:
            json.dump({"arch": arch, "shape": shape, "card": CARD,
                       "mesh": {"cards": 1}, "status": "error",
                       "error": f"{type(e).__name__}: {e}"}, f)
        print(f"[dryrun] {cell_id}: ERROR {type(e).__name__}: {str(e)[:300]}", flush=True)
        traceback.print_exc()
        return cell_id


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="architecture id (or all)")
    ap.add_argument("--shape", default=None, help="shape name (or all)")
    ap.add_argument("--no-correction", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(ART_DIR))
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells counted at once, each in a process of its own")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch and args.arch != "all" else list(ARCHS)
    shapes = [args.shape] if args.shape and args.shape != "all" else list(SHAPES)
    # The longest counts first: train steps, then the SSM archs (a Python
    # loop over the sequence's chunks).
    cells = sorted(((a, s) for a in archs for s in shapes),
                   key=lambda c: (SHAPES[c[1]].kind != "train", not get_config(c[0]).has_ssm))
    os.makedirs(args.out, exist_ok=True)
    work = [(a, s, args.out, not args.no_correction) for a, s in cells]
    t0 = time.perf_counter()
    if args.jobs > 1:
        with multiprocessing.get_context("spawn").Pool(args.jobs) as pool:
            results = pool.starmap(_sweep_cell, work, chunksize=1)
    else:
        results = [_sweep_cell(*w) for w in work]
    failures = [r for r in results if r is not None]
    took = time.perf_counter() - t0
    if failures:
        print(f"[dryrun] {len(failures)} cell(s) failed in {took:.1f}s: {failures}")
        return 1
    print(f"[dryrun] all {len(cells)} cells passed in {took:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
