"""Port parity of the eight architectures beyond granite-3-2b and
qwen3-moe-30b-a3b: the config-only text models (command-r-35b, yi-9b,
h2o-danube-3-4b with sliding windows, the MoE llama4-scout-17b-a16e), the
SSM (mamba2-130m), the hybrid (jamba-v0.1-52b: a period of 8, Mamba and
attention, MLP and MoE) and the two frontends (hubert-xlarge, audio,
encoder-only; paligemma-3b, vision, MQA at D = 256). Each reduced config
runs through the JAX package and the port on the same weights, carried
across by ``params_from_jax``, and the same numpy-seeded inputs
(``SyntheticLM`` batches, which carry the frontends' features, hubert's
mask and paligemma's text labels).

The JAX side runs with ``kernel_backend="jnp"`` and, for the kernel
branch, ``"pallas_interpret"`` (K5 and K4 in interpret mode where the
sequence is a multiple of 512); the port with ``"auto"`` and ``"cuda"``
(on CPU tensors the kernel wrappers take their plain versions).

Tolerances: forward logits 1e-4 relative to their scale (float32, as
tests/test_torch_models.py states it); the loss rtol 1e-5 and each
gradient within 5e-4 of its leaf's scale (tests/test_torch_train.py);
teacher-forced decode against the forward 2e-2 (the JAX package's own
check, tests/test_models.py), and the port's decode steps against the
reference's at 1e-4.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import registry as r_registry  # noqa: E402
from repro.data.pipeline import SyntheticLM  # noqa: E402
from repro.models import transformer as r_tr  # noqa: E402
from repro.runtime.steps import make_prefill_step as r_make_prefill_step  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import nn, transformer as tr  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.tree import flatten_with_paths, tree_leaves  # noqa: E402
from repro_torch.runtime.steps import make_decode_step, make_prefill_step  # noqa: E402

NEW_ARCHS = ["hubert-xlarge", "command-r-35b", "yi-9b", "h2o-danube-3-4b", "mamba2-130m",
             "llama4-scout-17b-a16e", "paligemma-3b", "jamba-v0.1-52b"]
DECODE_ARCHS = ["mamba2-130m", "jamba-v0.1-52b", "h2o-danube-3-4b"]
TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 5e-4
DECODE_TOL = 2e-2


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def _close(got, want, tol=TOL):
    want = _np(want)
    finite = np.abs(want) < 1e29  # the masked vocabulary tail is -1e30 on both sides
    scale = max(1.0, float(np.abs(want[finite]).max(initial=0.0)))
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * scale)


def _ported(tree, cfg, trainable=False):
    return params_from_jax(jax.tree.map(np.asarray, tree), cfg, device="cpu",
                           trainable=trainable)


class _Model:
    def __init__(self, arch, **kw):
        self.arch = arch
        self.r_cfg = r_registry.get_reduced(arch).with_(dtype="float32", **kw)
        self.p_cfg = registry.get_reduced(arch).with_(dtype="float32", **kw)
        self.r_params = r_tr.init_lm(jax.random.PRNGKey(0), self.r_cfg)
        self.ported = _ported(self.r_params, self.p_cfg)

    def batch(self, b, s, seed=0):
        """A ``SyntheticLM`` batch: numpy for the reference, torch for the port."""
        nb = SyntheticLM(self.r_cfg, b, s, seed=seed).batch_at(0)
        return ({k: jnp.asarray(v) for k, v in nb.items()},
                {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
                 for k, v in nb.items()})


@functools.cache
def _model(arch) -> _Model:
    return _Model(arch)


def _inputs(batch):
    return {k: batch.get(k) for k in ("tokens", "feats")}


# -- registry and configs -------------------------------------------------------

def test_registry_lists_the_references_architectures_in_order():
    assert list(registry.ARCHS) == list(r_registry.ARCHS)
    assert len(registry.ARCHS) == 10
    assert set(NEW_ARCHS) | {"granite-3-2b", "qwen3-moe-30b-a3b"} == set(registry.ARCHS)


def test_cells_match_reference():
    got, want = registry.cells(), r_registry.cells()
    assert got == want
    assert len(got) == 40 and sum(r for _, _, r, _ in got) == 32
    assert [dataclasses.asdict(s) for s in registry.SHAPES.values()] == [
        dataclasses.asdict(s) for s in r_registry.SHAPES.values()]


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_matches_reference(arch, reduced):
    r_cfg = r_registry.get_reduced(arch) if reduced else r_registry.get_config(arch)
    p_cfg = registry.get_reduced(arch) if reduced else registry.get_config(arch)
    r_fields, p_fields = dataclasses.asdict(r_cfg), dataclasses.asdict(p_cfg)
    assert set(r_fields) == set(p_fields)
    for name in r_fields:
        if name != "kernel_backend":  # the two packages' backend names
            assert p_fields[name] == r_fields[name], name
    assert p_cfg.param_counts() == r_cfg.param_counts()
    for shape in registry.SHAPES.values():
        assert registry.cell_status(p_cfg, shape) == r_registry.cell_status(
            r_cfg, r_registry.SHAPES[shape.name])


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_template_matches_reference_at_full_width(arch):
    """The port's per-layer template holds exactly the reference's
    parameters, unstacked: the leaves outside the layers (embed, final
    norm, lm_head, frontend) one for one, and pattern position i's leaves
    once per layer of that position."""
    cfg = registry.get_config(arch)
    shapes = jax.eval_shape(
        lambda: r_tr.init_lm(jax.random.PRNGKey(0), r_registry.get_config(arch)))
    r_total = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))

    def leaves(t):
        if isinstance(t, nn.Param):
            yield t
        elif isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        else:
            for v in t:
                yield from leaves(v)

    template = tr.lm_template(cfg)
    assert sorted(template) == sorted(shapes)
    port = list(leaves(template))
    assert sum(int(np.prod(p.shape)) for p in port) == r_total
    per_pos = [len(jax.tree.leaves(t)) for t in shapes["layers"]]
    outside = len(jax.tree.leaves({k: v for k, v in shapes.items() if k != "layers"}))
    assert len(port) == outside + sum(per_pos[i % cfg.period] for i in range(cfg.n_layers))
    for key in set(template) - {"layers"}:
        assert sorted(tuple(p.shape) for p in leaves(template[key])) == sorted(
            tuple(x.shape) for x in jax.tree.leaves(shapes[key])), key


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_params_from_jax_carries_every_leaf(arch):
    """Every leaf of the port equals its slice of the reference's stacked
    tree bitwise: the SSM's 1-D ``a_log`` / ``d_skip`` / ``dt_bias`` and
    conv weights, the frontend's projection and bias, jamba's eight
    pattern positions."""
    m = _model(arch)
    period = m.p_cfg.period
    want = {}
    for path, leaf in flatten_with_paths(jax.tree.map(lambda a: torch.from_numpy(
            np.array(a)), {k: v for k, v in m.r_params.items() if k != "layers"})):
        want[path] = leaf
    for i in range(m.p_cfg.n_layers):
        stacked = jax.tree.map(lambda a: torch.from_numpy(np.array(a[i // period])),
                               m.r_params["layers"][i % period])
        for path, leaf in flatten_with_paths(stacked):
            want[f"['layers'][{i}]{path}"] = leaf
    got = dict(flatten_with_paths(m.ported))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        assert torch.equal(leaf, want[path]), path
        assert not leaf.requires_grad


# -- the whole model ----------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward(arch):
    m = _model(arch)
    r_batch, p_batch = m.batch(2, 32)
    want, r_aux = r_tr.forward(m.r_params, m.r_cfg, **_inputs(r_batch))
    got, aux = tr.forward(m.ported, m.p_cfg, **_inputs(p_batch))
    assert tuple(got.shape) == (2, 32, m.r_cfg.vocab_padded)
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(r_aux), rtol=1e-5, atol=1e-7)
    assert (float(aux) > 0) == m.p_cfg.has_moe


# The attention archs whose K5 calls differ from granite's and qwen3's:
# non-causal (hubert), windowed (h2o-danube), MQA with patches prepended
# (paligemma), and the hybrid with K4 (jamba), on the kernel branch.
@pytest.mark.parametrize("arch", ["hubert-xlarge", "h2o-danube-3-4b", "paligemma-3b",
                                  "jamba-v0.1-52b"])
def test_prefill_step_kernel_branch(arch, monkeypatch):
    m = _model(arch)
    r_batch, p_batch = m.batch(1, 512, seed=1)
    calls = []
    real = ops.attention
    monkeypatch.setattr(ops, "attention", lambda *a: calls.append(a[3:5]) or real(*a))
    want = r_make_prefill_step(m.r_cfg.with_(kernel_backend="pallas_interpret"))(
        m.r_params, _inputs(r_batch))
    got = make_prefill_step(m.p_cfg.with_(kernel_backend="cuda"))(m.ported, _inputs(p_batch))
    assert tuple(got.shape) == (1, m.r_cfg.vocab_padded)
    _close(got, want)
    n_attn = sum(m.p_cfg.block_pattern[i % m.p_cfg.period].mixer == "attn"
                 for i in range(m.p_cfg.n_layers))
    assert calls == [(m.p_cfg.causal, m.p_cfg.window)] * n_attn


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_lm_loss(arch):
    """The loss of a ``SyntheticLM`` batch: hubert's per-frame labels
    under its masked-prediction mask, paligemma's text positions after the
    patches."""
    m = _model(arch)
    r_batch, p_batch = m.batch(2, 32, seed=2)
    if arch == "hubert-xlarge":
        assert "mask" in p_batch and 0 < float(p_batch["mask"].sum()) < 64
    if arch == "paligemma-3b":
        assert tuple(p_batch["labels"].shape) == (2, 32 - m.p_cfg.num_patches)
    want, r_metrics = r_tr.lm_loss(m.r_params, m.r_cfg, **r_batch)
    got, metrics = tr.lm_loss(m.ported, m.p_cfg, **p_batch)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    for k in ("loss", "moe_aux"):
        np.testing.assert_allclose(float(metrics[k]), float(r_metrics[k]), rtol=LOSS_RTOL,
                                   atol=1e-7)


@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-v0.1-52b"])
def test_loss_and_every_gradient_match_reference(arch):
    """The SSM's autograd path (and the hybrid's) against
    ``jax.value_and_grad`` of the reference's ``lm_loss``."""
    m = _model(arch)
    r_batch, p_batch = m.batch(2, 32, seed=3)
    (r_total, _), r_grads = jax.jit(jax.value_and_grad(
        lambda p: r_tr.lm_loss(p, m.r_cfg, **r_batch), has_aux=True))(m.r_params)
    params = _ported(m.r_params, m.p_cfg, trainable=True)
    total, _ = tr.lm_loss(params, m.p_cfg, **p_batch)
    grads = torch.autograd.grad(total, tree_leaves(params))
    np.testing.assert_allclose(float(total.detach()), float(r_total), rtol=LOSS_RTOL)
    want = dict(flatten_with_paths(_ported(r_grads, m.p_cfg)))
    for (path, _), g in zip(flatten_with_paths(params), grads):
        w = _np(want[path])
        scale = float(np.abs(w).max(initial=0.0))
        np.testing.assert_allclose(_np(g), w, rtol=0, atol=GRAD_TOL * max(scale, 1e-30),
                                   err_msg=path)


# -- decode ---------------------------------------------------------------------

def _decode_model(arch):
    return _Model(arch, ssm_chunk=4, capacity_factor=64.0)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_forward(arch):
    """Teacher-forced decode reproduces the forward logits inside the port
    (the JAX package's check, tests/test_models.py, at its 2e-2), with the
    capacity raised so that token dropping cannot enter."""
    m = _decode_model(arch)
    s = 8
    toks = torch.from_numpy(
        np.random.default_rng(4).integers(0, m.p_cfg.vocab, (2, s))).long()
    full, _ = tr.forward(m.ported, m.p_cfg, tokens=toks)
    cache = tr.init_cache(m.p_cfg, 2, max_seq=16, device="cpu")
    steps = []
    for t in range(s):
        lg, cache = tr.decode_step(m.ported, cache, m.p_cfg, toks[:, t:t + 1])
        steps.append(lg[:, 0])
    np.testing.assert_allclose(_np(torch.stack(steps, dim=1)), _np(full), rtol=DECODE_TOL,
                               atol=DECODE_TOL)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_step_matches_reference(arch):
    """``make_decode_step`` against the reference's ``decode_step``, step by
    step: the logits and, at the end, every cache tensor (the KV cache of
    the attention layers, the SSM states and conv windows)."""
    m = _decode_model(arch)
    s = 6
    toks = np.random.default_rng(5).integers(0, m.p_cfg.vocab, (2, s)).astype(np.int32)
    r_cache = r_tr.init_cache(m.r_cfg, 2, max_seq=8)
    cache = tr.init_cache(m.p_cfg, 2, max_seq=8, device="cpu")
    assert sorted(cache) == sorted(r_cache)
    step = make_decode_step(m.p_cfg)
    for t in range(s):
        want, r_cache = r_tr.decode_step(m.r_params, r_cache, m.r_cfg,
                                         jnp.asarray(toks[:, t:t + 1]))
        got, cache = step(m.ported, cache, torch.from_numpy(toks[:, t:t + 1]).long())
        _close(got, want)
        assert cache["pos"] == int(r_cache["pos"]) == t + 1
    for group in ("kv", "ssm"):
        for k, v in r_cache.get(group, {}).items():
            assert tuple(cache[group][k].shape) == v.shape
            assert cache[group][k].dtype == getattr(torch, str(v.dtype))
            _close(cache[group][k], v)


def test_init_cache_counts_layers_by_mixer():
    """jamba: one attention layer per period of 8 holds a KV cache, the
    other seven an SSM state; mamba2 has no KV cache, h2o-danube no SSM
    state and a ring of ``window`` slots."""
    for arch, kv_layers, ssm_layers in (("jamba-v0.1-52b", 1, 7), ("mamba2-130m", 0, 2),
                                        ("h2o-danube-3-4b", 2, 0)):
        cfg = registry.get_reduced(arch)
        cache = tr.init_cache(cfg, 2, 64, device="cpu")
        want = r_tr.init_cache(r_registry.get_reduced(arch), 2, 64)
        assert sorted(cache) == sorted(want)
        assert (cache["kv"]["k"].shape[0] if kv_layers else 0) == kv_layers
        assert (cache["ssm"]["state"].shape[0] if ssm_layers else 0) == ssm_layers
    assert tr.init_cache(registry.get_reduced("h2o-danube-3-4b"), 1, 64,
                         device="cpu")["kv"]["k"].shape[2] == 32


def test_swa_ring_buffer_matches_window_attention():
    """The SWA ring-buffer cache agrees with full attention under the same
    window after the buffer has wrapped (tests/test_models.py's check)."""
    m = _Model("h2o-danube-3-4b", window=8)
    s = 20  # > window: the ring buffer wraps
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, m.p_cfg.vocab, (1, s))).long()
    full, _ = tr.forward(m.ported, m.p_cfg, tokens=toks)
    want, _ = r_tr.forward(m.r_params, m.r_cfg, tokens=jnp.asarray(toks.numpy()))
    _close(full, want)
    cache = tr.init_cache(m.p_cfg, 1, max_seq=m.p_cfg.window, device="cpu")
    assert cache["kv"]["k"].shape[2] == 8
    outs = []
    for t in range(s):
        lg, cache = tr.decode_step(m.ported, cache, m.p_cfg, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    np.testing.assert_allclose(_np(torch.stack(outs, dim=1)), _np(full), rtol=DECODE_TOL,
                               atol=DECODE_TOL)


def test_frontends_need_their_inputs():
    for arch, missing in (("hubert-xlarge", "feats"), ("paligemma-3b", "feats"),
                          ("paligemma-3b", "tokens")):
        m = _model(arch)
        _, p_batch = m.batch(1, 16)
        inputs = {k: v for k, v in _inputs(p_batch).items() if k != missing}
        with pytest.raises(ValueError, match=f"{missing} are required"):
            tr.forward(m.ported, m.p_cfg, **inputs)
