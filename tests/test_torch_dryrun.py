"""The one-card dry-run (``repro_torch.launch.dryrun``,
``launch/refresh_corrections.py``, ``data/pipeline.py::batch_specs``)
against the JAX package's, and its counts against the analytic ones.

* ``batch_specs``: keys, shapes and dtypes of the reference's
  ``ShapeDtypeStruct``s, every architecture at reduced and full width,
  the four shapes of the registry; the dtypes of the port's
  ``SyntheticLM.batch_at``.
* ``cell_config`` field for field (but ``kernel_backend``), ``model_flops``
  exactly and ``cell_status``'s skips with their reasons, against
  ``repro.launch.dryrun`` in a subprocess: the reference forces 512 host
  devices when it is imported, which this process must not see.
* The meta count of a dense reduced model equals the analytic one
  exactly: 2 x the matmul parameters x tokens, K5's count per attention
  layer (``core/perfmodel.py::attention_flops``), and in training three
  times the products, the plain recompute backward of the attention and,
  under remat "full", the layers' forward once more up to the down
  projection.
* The trip-count correction (L1/L2, bq1/bq2) equals the full-depth count
  for every architecture at reduced width, FLOPs and bytes.
* The meta route launches nothing, counts each kernel's operations and
  leaves the CPU results of ``ops.attention``, ``ops.grouped_matmul`` and
  ``ops.sparse_dense_matmul`` bitwise unchanged.
* One full-width cell (granite-3-2b x train_4k) end to end: its JSON, and
  ``refresh_corrections`` over it.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.data.pipeline import batch_specs as r_batch_specs  # noqa: E402
from repro_torch.configs.registry import (  # noqa: E402
    ARCHS, SHAPES, ShapeSpec, cell_status, get_config, get_reduced)
from repro_torch.core.perfmodel import attention_flops  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM, batch_specs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.backend import resolve_backend  # noqa: E402
from repro_torch.kernels.bsr_spmm import bsr_spmm  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm  # noqa: E402
from repro_torch.launch import dryrun, refresh_corrections  # noqa: E402
from repro_torch.sparse.convert import to_bcsv  # noqa: E402
from repro_torch.sparse.random import random_block_sparse  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _config_dict(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d.pop("kernel_backend")
    return json.loads(json.dumps(d))


# ---------------------------------------------------------------------------
# batch_specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("reduced", [True, False])
def test_batch_specs_match_reference(arch, reduced):
    from repro.configs.registry import get_config as r_get_config
    from repro.configs.registry import get_reduced as r_get_reduced

    cfg = get_reduced(arch) if reduced else get_config(arch)
    r_cfg = r_get_reduced(arch) if reduced else r_get_config(arch)
    for shape in SHAPES.values():
        batch, seq = (2, 64) if reduced else (shape.global_batch, shape.seq_len)
        ours, theirs = batch_specs(cfg, batch, seq), r_batch_specs(r_cfg, batch, seq)
        assert list(ours) == list(theirs), (shape.name, list(ours), list(theirs))
        for k, t in ours.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(theirs[k].shape), (shape.name, k)
            assert str(t.dtype).split(".")[-1] == np.dtype(theirs[k].dtype).name, (k, t.dtype)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_batch_specs_match_synthetic_batches(arch):
    cfg = get_reduced(arch)
    seq = 32 + (cfg.num_patches if cfg.frontend == "vision" else 0)
    real = SyntheticLM(cfg, 2, seq, seed=0).batch_at(0)
    specs = batch_specs(cfg, 2, seq)
    assert sorted(real) == sorted(specs)
    for k, v in real.items():
        t = torch.from_numpy(np.asarray(v))
        assert (tuple(t.shape), t.dtype) == (tuple(specs[k].shape), specs[k].dtype), k


# ---------------------------------------------------------------------------
# cell_config, model_flops, cell_status against the reference (subprocess)
# ---------------------------------------------------------------------------

_VARIANTS = [dict(), dict(n_layers=1), dict(n_layers=2, attn_block_q=512, scan_unroll=True)]


@pytest.fixture(scope="module")
def reference_cells():
    code = textwrap.dedent(f"""
        import dataclasses, json, sys
        from repro.launch import dryrun
        from repro.configs.registry import ARCHS, SHAPES, cell_status, get_config
        out = {{}}
        for arch in ARCHS:
            for name, shape in SHAPES.items():
                cfgs = []
                for kw in {_VARIANTS!r}:
                    d = dataclasses.asdict(dryrun.cell_config(arch, shape, **kw))
                    d.pop("kernel_backend")
                    cfgs.append(d)
                out[arch + "|" + name] = {{
                    "configs": cfgs,
                    "model_flops": dryrun.model_flops(get_config(arch), shape),
                    "status": list(cell_status(get_config(arch), shape)),
                }}
        print(json.dumps(out))
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cell_config_matches_reference(reference_cells):
    for arch in ARCHS:
        for name, shape in SHAPES.items():
            want = reference_cells[f"{arch}|{name}"]["configs"]
            for kw, w in zip(_VARIANTS, want):
                cfg = dryrun.cell_config(arch, shape, **kw)
                assert _config_dict(cfg) == w, (arch, name, kw)
                assert cfg.kernel_backend == "cuda"


def test_model_flops_match_reference(reference_cells):
    for arch in ARCHS:
        for name, shape in SHAPES.items():
            got = dryrun.model_flops(get_config(arch), shape)
            assert got == reference_cells[f"{arch}|{name}"]["model_flops"], (arch, name)


def test_cell_status_matches_reference(reference_cells, tmp_path):
    skipped = 0
    for arch in ARCHS:
        for name, shape in SHAPES.items():
            status = list(cell_status(get_config(arch), shape))
            assert status == reference_cells[f"{arch}|{name}"]["status"], (arch, name)
            if not status[0]:
                skipped += 1
                rec = dryrun.run_cell(arch, name, str(tmp_path))
                assert rec["status"] == "skipped" and rec["reason"] == status[1]
                with open(tmp_path / f"{arch}__{name}__h100.json") as f:
                    assert json.load(f) == rec
    assert skipped == 8  # hubert's two decodes, six full-attention archs at long_500k


# ---------------------------------------------------------------------------
# The counts
# ---------------------------------------------------------------------------

def _matmul_params(cfg) -> tuple:
    """(matmul weights of all layers, of the head) of a dense attention
    model: every ``w`` leaf of the layers, the head (or tied table)."""
    d, hd, h, kv, f = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    per_layer = d * h * hd + 2 * d * kv * hd + h * hd * d + (3 if cfg.mlp_gated else 2) * d * f
    return cfg.n_layers * per_layer, d * cfg.vocab_padded


@pytest.mark.parametrize("remat", ["none", "full"])
def test_meta_flops_equal_the_analytic_count(remat):
    cfg = get_reduced("granite-3-2b").with_(remat=remat)
    assert not (cfg.has_moe or cfg.has_ssm or cfg.sparse_ffn) and cfg.frontend == "none"
    b, s = 2, 96
    tokens = b * s
    layers, head = _matmul_params(cfg)
    k5 = attention_flops(b * cfg.n_heads, s, s, cfg.head_dim, causal=cfg.causal,
                         window=cfg.window)
    prefill = dryrun.count_step(cfg, "prefill", b, s)
    assert prefill["flops"] == 2 * tokens * (layers + head) + cfg.n_layers * k5
    # The plain recompute backward of the attention: two [BH, S, S] x hd
    # products and their two gradients each.
    attn_bwd = 3 * 4 * b * cfg.n_heads * s * s * cfg.head_dim
    train = dryrun.count_step(cfg, "train", b, s)
    want = 3 * 2 * tokens * (layers + head) + cfg.n_layers * (k5 + attn_bwd)
    if remat == "full":
        # The layers' forward once more, K5 included, up to the down
        # projection: the non-reentrant checkpoint stops recomputing once
        # the tensors the backward saved are back, and that product's
        # output is not among them.
        want += 2 * tokens * (layers - cfg.n_layers * cfg.d_ff * cfg.d_model) + cfg.n_layers * k5
    assert train["flops"] == want
    assert train["optimizer"]["flops"] == 0 and train["optimizer"]["bytes"] > 0
    mem = train["memory"]
    n = sum(p.numel() for p in dryrun.meta_params(cfg).parameters())
    assert mem["params_bytes"] == 4 * n and mem["grads_bytes"] == 4 * n
    assert mem["optimizer_bytes"] == 3 * 4 * n  # float32 m, v and the master copy
    assert mem["peak_bytes"] >= mem["params_bytes"] + mem["optimizer_bytes"] + mem["input_bytes"]
    assert mem["activation_peak_bytes"] > 0


def test_meta_counter_tracks_live_storages():
    counter = dryrun._MetaCounter()
    with counter:
        a = torch.empty((1024,), device="meta")  # 4096 bytes
        b = a * 2  # 4096 more, and 8192 of traffic
        v = b.view(2, 512)  # a view: no bytes, no storage
        del a
        c = v + 1  # peak: b and c
        del b, v, c
        d = torch.empty((256,), dtype=torch.bfloat16, device="meta")
    assert counter.peak == 2 * 4096
    assert counter.live == 512 and d.numel() == 256
    assert counter.bytes == 2 * 4096 + 2 * 4096


_SMALL = [ShapeSpec("t", 64, 2, "train"), ShapeSpec("p", 64, 2, "prefill"),
          ShapeSpec("d", 64, 2, "decode")]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_correction_equals_full_depth_count(arch, monkeypatch):
    monkeypatch.setattr(dryrun, "get_config", get_reduced)
    cfg = get_reduced(arch)
    for shape in _SMALL:
        if not cell_status(cfg, shape)[0]:
            continue
        rec = dryrun.lower_cell(arch, shape)
        cor = dryrun.corrected_costs(arch, shape, rec)
        assert cor["matches_full_count"], (shape.kind, cor["flops"], rec["cost"]["flops"])
        assert cor["flops"] == rec["cost"]["flops"] > 0
        assert cor["bytes"] == rec["cost"]["bytes"] > 0, shape.kind
        assert cor["method"].startswith("unrolled L1/L2")
        if cfg.has_attention and shape.kind != "decode":
            assert "bq1/bq2" in cor["method"]


def test_meta_route_launches_nothing_and_keeps_cpu_results():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((3, 40, 16), dtype=np.float32))
               for _ in range(3))
    x = torch.from_numpy(rng.standard_normal((32, 16), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 16, 24), dtype=np.float32))
    te = np.array([0, 1, 1, 0], np.int32)
    assert resolve_backend("auto", "meta") == "cuda"  # the meta device stands for the card
    k5, k4 = flash_attention.launches, moe_gmm.launches
    att = ops.attention(q, k, v, causal=True, window=24)
    assert torch.equal(att, ref.flash_attention_ref(q, k, v, causal=True, window=24))
    gmm = ops.grouped_matmul(x, w, te, tm=8)
    assert torch.equal(gmm, ref.moe_gmm_ref(x, w, torch.from_numpy(te), 8))
    meta = [t.to("meta") for t in (q, k, v, x, w)]
    with FlopCounterMode(display=False) as fc:
        att_m = ops.attention(*meta[:3], causal=True, window=24)
        gmm_m = ops.grouped_matmul(meta[3], meta[4], te, tm=8)
    assert (att_m.device.type, att_m.shape, att_m.dtype) == ("meta", att.shape, att.dtype)
    assert (gmm_m.device.type, gmm_m.shape, gmm_m.dtype) == ("meta", gmm.shape, gmm.dtype)
    assert fc.get_total_flops() == (attention_flops(3, 40, 40, 16, window=24)
                                    + 2 * 32 * 16 * 24)
    assert (flash_attention.launches, moe_gmm.launches) == (k5, k4)
    # The CPU results after the meta calls are the same bits.
    assert torch.equal(ops.attention(q, k, v, causal=True, window=24), att)
    assert torch.equal(ops.grouped_matmul(x, w, te, tm=8), gmm)


def test_sparse_dense_matmul_meta_route():
    """K3 on the meta device: the kernel's [M, N] float32 output, and its
    count: 2·M·bk·bn per stored block (column panels padded with a zero
    block count as the kernel visits them)."""
    wd = random_block_sparse(64, 96, (16, 32), 0.5, seed=3)
    w = to_bcsv(wd, (16, 32), group=1)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((40, 64), dtype=np.float32))
    k3 = bsr_spmm.launches
    cpu = ops.sparse_dense_matmul(x, w, tm=8)
    blocks = ops._bsr_operands(w)[0]
    with FlopCounterMode(display=False) as fc:
        y = ops.sparse_dense_matmul(x.to("meta"), w, tm=8)
    assert (y.device.type, y.shape, y.dtype) == ("meta", cpu.shape, cpu.dtype)
    assert fc.get_total_flops() == 2 * 40 * 16 * 32 * blocks.shape[0]
    assert bsr_spmm.launches == k3
    assert torch.equal(ops.sparse_dense_matmul(x, w, tm=8), cpu)


def test_attention_flops_counts_the_visible_pairs():
    for sq, skv, causal, window, off in [(7, 7, True, None, 0), (5, 9, True, 3, 4),
                                         (6, 6, False, None, 0), (8, 8, True, 1, 0)]:
        qi = np.arange(sq)[:, None] + off
        kj = np.arange(skv)[None, :]
        vis = np.ones((sq, skv), bool)
        if causal:
            vis &= kj <= qi
        if window is not None:
            vis &= kj > qi - window
        assert attention_flops(2, sq, skv, 4, causal=causal, window=window,
                               q_offset=off) == 4 * 4 * 2 * int(vis.sum())


def test_full_width_cell_end_to_end(tmp_path):
    rec = dryrun.run_cell("granite-3-2b", "train_4k", str(tmp_path))
    with open(tmp_path / "granite-3-2b__train_4k__h100.json") as f:
        stored = json.load(f)
    assert stored == json.loads(json.dumps(rec))
    cfg = get_config("granite-3-2b")
    assert rec["status"] == "ok" and rec["mesh"] == {"cards": 1} and rec["collectives"] == {}
    assert rec["n_layers"] == cfg.n_layers and rec["microbatches"] == 4
    assert rec["microbatch"] == [SHAPES["train_4k"].global_batch // 4, 4096]
    assert rec["corrected"]["matches_full_count"]
    assert rec["corrected"]["flops"] == rec["cost"]["flops"]
    mem = rec["memory"]
    assert mem["card_bytes"] == 80 * 2 ** 30 and not mem["fits_one_card"]
    n = cfg.param_counts()["total"]
    assert mem["params_bytes"] >= 2 * n  # bf16 params (the padded vocabulary too)
    assert mem["optimizer_bytes"] == 3 * 2 * mem["params_bytes"]  # float32 m, v, master
    # The useful compute is within the counted one (which adds the remat
    # recompute and the attention's plain backward).
    assert rec["model"]["model_flops"] < rec["cost"]["flops"] < 2 * rec["model"]["model_flops"]
    assert refresh_corrections.main(["--out", str(tmp_path)]) == 0
    with open(tmp_path / "granite-3-2b__train_4k__h100.json") as f:
        assert json.load(f)["corrected"]["flops"] == rec["cost"]["flops"]
    assert math.isfinite(rec["total_s"])
