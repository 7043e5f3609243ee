"""Port parity of the LM stack: every module on the serving path of the
port (``repro_torch.models``, ``runtime.steps``) against the JAX package's
function, on the reduced granite-3-2b in float32, and the whole model on
the reduced qwen3-moe-30b-a3b (MoE layers; the layer itself is held in
tests/test_torch_moe.py), with the same weights carried across by
``params_from_jax`` and inputs made with numpy from a seed.

The JAX side runs with ``kernel_backend="jnp"`` (its dense and blocked
attention) and with ``"pallas_interpret"`` (its flash kernel K5 in
interpret mode wherever the sequence is a multiple of 512). The port runs
with ``"auto"`` (on CPU tensors: the dense branch) and ``"cuda"`` (the
kernel branch; the kernel wrapper takes its plain version for CPU
tensors).

Tolerance 1e-4, relative to each output's scale (``atol`` is 1e-4 times
the largest magnitude of the reference's output, and at least 1e-4):
float32 throughout, the two packages rounding in different places. The
scale matters inside a layer. The reference's initialiser draws layer
weights with std 1/sqrt(n_periods) (0.71 here), so attention logits have
a std of about 30 and the softmax is sharply peaked; one-ulp differences
in RoPE (XLA fuses the rotation, torch rounds each product) then move
layer outputs of size ~200 by up to ~1e-2, about 5e-5 of their scale. The
logits after the final norm are of order 1, where this is 1e-4 absolute.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.registry import get_config as r_get_config  # noqa: E402
from repro.configs.registry import get_reduced as r_get_reduced  # noqa: E402
from repro.models import attention as r_attn  # noqa: E402
from repro.models import blocks as r_blocks  # noqa: E402
from repro.models import mlp as r_mlp  # noqa: E402
from repro.models import nn as r_nn  # noqa: E402
from repro.models import transformer as r_tr  # noqa: E402
from repro.runtime.steps import make_prefill_step as r_make_prefill_step  # noqa: E402
from repro_torch.configs.registry import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention, blocks, mlp, nn, transformer as tr  # noqa: E402
from repro_torch.models.config import BlockSpec  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime.steps import make_decode_step, make_prefill_step  # noqa: E402

ARCH = "granite-3-2b"
MOE_ARCH = "qwen3-moe-30b-a3b"
TOL = 1e-4
# (JAX kernel_backend, port kernel_backend) pairs that take the same branch.
BACKENDS = [("jnp", "auto"), ("pallas_interpret", "cuda")]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    want = _np(want)
    finite = np.abs(want) < 1e29  # the masked vocabulary tail is -1e30 on both sides
    scale = max(1.0, float(np.abs(want[finite]).max(initial=0.0)))
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * scale)


@pytest.fixture(scope="module")
def model():
    r_cfg = r_get_reduced(ARCH).with_(dtype="float32")
    params = r_tr.init_lm(jax.random.PRNGKey(0), r_cfg)
    p_cfg = get_reduced(ARCH).with_(dtype="float32")
    ported = params_from_jax(jax.tree.map(np.asarray, params), p_cfg, device="cpu")
    return r_cfg, params, p_cfg, ported


def _layer(params, ported, i=0):
    """Layer ``i``'s parameters in both packages."""
    r_cfg_period = len(params["layers"])
    r_layer = jax.tree.map(lambda a: a[i // r_cfg_period], params["layers"][i % r_cfg_period])
    return r_layer, ported["layers"][i]


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _x(b, s, d, seed=2):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


# -- config -----------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    r_cfg = r_get_reduced(ARCH) if reduced else r_get_config(ARCH)
    p_cfg = get_reduced(ARCH) if reduced else get_config(ARCH)
    r_fields = dataclasses.asdict(r_cfg)
    p_fields = dataclasses.asdict(p_cfg)
    assert set(r_fields) == set(p_fields)
    for name in r_fields:
        if name != "kernel_backend":  # the two packages' backend names
            assert p_fields[name] == r_fields[name], name
    assert p_cfg.param_counts() == r_cfg.param_counts()
    assert p_cfg.compute_dtype() == getattr(torch, r_cfg.dtype)
    assert p_cfg.params_dtype() == torch.float32


def test_template_matches_reference_at_full_width():
    """The port's per-layer template holds exactly the reference's
    parameters, unstacked: same leaf count and element count."""
    cfg = get_config(ARCH)
    shapes = jax.eval_shape(lambda: r_tr.init_lm(jax.random.PRNGKey(0), r_get_config(ARCH)))
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

    port = list(leaves(tr.lm_template(cfg)))
    assert sum(int(np.prod(p.shape)) for p in port) == r_total
    n_r_leaves = len(jax.tree.leaves(shapes))
    per_layer = (n_r_leaves - 2) // cfg.period  # less embed and final norm
    assert len(port) == 2 + per_layer * cfg.n_layers


# -- primitives ---------------------------------------------------------------

def test_rope():
    x = _x(2, 8, 4 * 16).reshape(2, 8, 4, 16)
    pos = np.tile(np.arange(3, 11), (2, 1)).astype(np.int32)
    want = r_attn.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = attention.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    _close(got, want, 1e-5)


def test_rmsnorm():
    x = _x(2, 5, 64) * 3
    scale = np.random.default_rng(4).standard_normal(64).astype(np.float32)
    want = r_nn.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5)
    got = nn.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x), 1e-5)
    _close(got, want, 1e-5)


def test_dense():
    rng = np.random.default_rng(5)
    x = _x(2, 5, 64)
    w = rng.standard_normal((64, 4, 16)).astype(np.float32)
    b = rng.standard_normal((4, 16)).astype(np.float32)
    want = r_nn.dense({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
    got = nn.dense({"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, torch.from_numpy(x))
    assert tuple(got.shape) == (2, 5, 4, 16)
    _close(got, want)


# -- attention ----------------------------------------------------------------

@pytest.mark.parametrize("s", [8, 512])
@pytest.mark.parametrize("r_backend,p_backend", BACKENDS)
def test_attn_forward(model, monkeypatch, s, r_backend, p_backend):
    r_cfg, params, p_cfg, ported = model
    r_layer, p_layer = _layer(params, ported)
    x = _x(2, s, r_cfg.d_model)
    calls = []
    real = ops.attention
    monkeypatch.setattr(ops, "attention", lambda *a: calls.append(a[6]) or real(*a))
    want = r_attn.attn_forward(r_layer["mixer"], jnp.asarray(x),
                               r_cfg.with_(kernel_backend=r_backend))
    got = attention.attn_forward(p_layer["mixer"], torch.from_numpy(x),
                                 p_cfg.with_(kernel_backend=p_backend))
    _close(got, want)
    # The kernel branch is taken exactly where the reference takes it.
    assert calls == (["cuda"] if p_backend == "cuda" and s % 512 == 0 else [])


@pytest.mark.parametrize("b", [1, 2])
def test_attn_forward_hands_the_kernel_contiguous_operands(model, monkeypatch, b):
    """The kernel branch flattens (B, KV, R) into K5's BH axis; the CUDA
    kernel refuses strided operands, and at B = 1 that flattening of q is
    a strided view."""
    r_cfg, params, p_cfg, ported = model
    _, p_layer = _layer(params, ported)
    seen = []
    real = ops.attention
    monkeypatch.setattr(ops, "attention", lambda q, k, v, *a: seen.append(
        (q.is_contiguous(), k.is_contiguous(), v.is_contiguous())) or real(q, k, v, *a))
    attention.attn_forward(p_layer["mixer"], torch.from_numpy(_x(b, 512, r_cfg.d_model)),
                           p_cfg.with_(kernel_backend="cuda"))
    assert seen == [(True, True, True)]


def test_attn_forward_blocked(model):
    r_cfg, params, p_cfg, ported = model
    r_layer, p_layer = _layer(params, ported, 1)
    x = _x(2, 16, r_cfg.d_model, seed=6)
    kw = dict(attn_impl="blocked", attn_block_q=4, window=6)
    want = r_attn.attn_forward(r_layer["mixer"], jnp.asarray(x), r_cfg.with_(**kw))
    got = attention.attn_forward(p_layer["mixer"], torch.from_numpy(x), p_cfg.with_(**kw))
    _close(got, want)


# pos 20 lies past the last slot of a 16-slot cache: nothing is written.
@pytest.mark.parametrize("window,pos", [(None, 5), (None, 15), (None, 20), (4, 9)])
def test_attn_decode(model, window, pos):
    r_cfg, params, p_cfg, ported = model
    r_cfg, p_cfg = r_cfg.with_(window=window), p_cfg.with_(window=window)
    r_layer, p_layer = _layer(params, ported)
    rng = np.random.default_rng(7)
    s_cache = min(16, window) if window else 16
    ck, cv = (rng.standard_normal((2, s_cache, r_cfg.n_kv_heads, r_cfg.head_dim))
              .astype(np.float32) for _ in range(2))
    x = _x(2, 1, r_cfg.d_model, seed=8)
    want = r_attn.attn_decode(r_layer["mixer"], jnp.asarray(x), jnp.asarray(ck),
                              jnp.asarray(cv), jnp.int32(pos), r_cfg)
    got = attention.attn_decode(p_layer["mixer"], torch.from_numpy(x), torch.from_numpy(ck),
                                torch.from_numpy(cv), pos, p_cfg)
    for g, w in zip(got, want):
        _close(g, w)


def test_init_kv_cache_shapes():
    cfg = get_reduced(ARCH)
    for window, slots in ((None, 32), (8, 8)):
        cache = attention.init_kv_cache(cfg.with_(window=window), 3, 32, 2, torch.float32, "cpu")
        want = r_attn.init_kv_cache(r_get_reduced(ARCH).with_(window=window), 3, 32, 2,
                                    jnp.float32)
        assert tuple(cache["k"].shape) == tuple(want["k"].shape) == (2, 3, slots, 2, 8)


# -- MLP, blocks --------------------------------------------------------------

@pytest.mark.parametrize("sparse", [False, True])
def test_mlp_forward(model, sparse):
    r_cfg, params, p_cfg, ported = model
    r_layer, p_layer = _layer(params, ported)
    r_ff, p_ff = dict(r_layer["ff"]), p_layer["ff"]
    kw = dict(sparse_ffn=True, sparse_block=32) if sparse else {}
    if sparse:
        mask = (np.random.default_rng(9).random((5, 2)) < 0.5).astype(np.float32)
        r_ff["wd_mask"] = jnp.asarray(mask)
        p_ff = {**{k: p_ff[k] for k in p_ff.keys()}, "wd_mask": torch.from_numpy(mask)}
    x = _x(2, 8, r_cfg.d_model, seed=10)
    want = r_mlp.mlp_forward(r_ff, jnp.asarray(x), r_cfg.with_(**kw))
    got = mlp.mlp_forward(p_ff, torch.from_numpy(x), p_cfg.with_(**kw))
    _close(got, want)


@pytest.mark.parametrize("r_backend,p_backend", BACKENDS)
def test_block_forward(model, r_backend, p_backend):
    r_cfg, params, p_cfg, ported = model
    r_layer, p_layer = _layer(params, ported, 1)
    x = _x(1, 512, r_cfg.d_model, seed=11)
    spec = r_cfg.block_pattern[0]
    want, r_aux = r_blocks.block_forward(r_layer, jnp.asarray(x),
                                         r_cfg.with_(kernel_backend=r_backend), spec)
    got, aux = blocks.block_forward(p_layer, torch.from_numpy(x),
                                    p_cfg.with_(kernel_backend=p_backend),
                                    BlockSpec(spec.mixer, spec.ff))
    _close(got, want)
    assert float(aux) == float(r_aux) == 0.0


@pytest.mark.parametrize("spec", [BlockSpec("rnn", "mlp")])
def test_unported_blocks_raise(spec):
    """Every mixer of the reference is ported (attention, SSM); a mixer
    that neither package knows raises."""
    with pytest.raises(ValueError, match="unknown block spec"):
        blocks.block_t(get_reduced(ARCH), spec)


# -- the whole model ----------------------------------------------------------

@pytest.mark.parametrize("s", [8, 512])
@pytest.mark.parametrize("r_backend,p_backend", BACKENDS)
def test_forward(model, s, r_backend, p_backend):
    r_cfg, params, p_cfg, ported = model
    toks = _tokens(r_cfg, 2, s)
    want, r_aux = r_tr.forward(params, r_cfg.with_(kernel_backend=r_backend),
                               tokens=jnp.asarray(toks))
    got, aux = tr.forward(ported, p_cfg.with_(kernel_backend=p_backend),
                          tokens=torch.from_numpy(toks).long())
    assert tuple(got.shape) == (2, s, r_cfg.vocab_padded)
    _close(got, want)
    assert float(aux) == float(r_aux) == 0.0


def test_prefill_step(model):
    r_cfg, params, p_cfg, ported = model
    toks = _tokens(r_cfg, 2, 512, seed=12)
    want = r_make_prefill_step(r_cfg.with_(kernel_backend="pallas_interpret"))(
        params, {"tokens": jnp.asarray(toks)})
    got = make_prefill_step(p_cfg.with_(kernel_backend="cuda"))(
        ported, {"tokens": torch.from_numpy(toks).long()})
    assert tuple(got.shape) == (2, r_cfg.vocab_padded)
    _close(got, want)


def test_decode_step(model):
    r_cfg, params, p_cfg, ported = model
    s = 6
    toks = _tokens(r_cfg, 2, s, seed=13)
    r_cache = r_tr.init_cache(r_cfg, 2, max_seq=8)
    cache = tr.init_cache(p_cfg, 2, max_seq=8, device="cpu")
    step = make_decode_step(p_cfg)
    for t in range(s):
        want, r_cache = r_tr.decode_step(params, r_cache, r_cfg, jnp.asarray(toks[:, t:t + 1]))
        got, cache = step(ported, cache, torch.from_numpy(toks[:, t:t + 1]).long())
        _close(got, want)
        assert cache["pos"] == int(r_cache["pos"]) == t + 1
    _close(cache["kv"]["k"], r_cache["kv"]["k"].reshape(cache["kv"]["k"].shape))
    _close(cache["kv"]["v"], r_cache["kv"]["v"].reshape(cache["kv"]["v"].shape))


def test_decode_matches_forward(model):
    """Teacher-forced decode reproduces the forward logits inside the port
    (the JAX package's own check, tests/test_models.py, at its 2e-2)."""
    _, _, p_cfg, ported = model
    s = 8
    toks = torch.from_numpy(_tokens(p_cfg, 2, s, seed=14)).long()
    full, _ = tr.forward(ported, p_cfg, tokens=toks)
    cache = tr.init_cache(p_cfg, 2, max_seq=16, device="cpu")
    steps = []
    for t in range(s):
        lg, cache = tr.decode_step(ported, cache, p_cfg, toks[:, t:t + 1])
        steps.append(lg[:, 0])
    np.testing.assert_allclose(_np(torch.stack(steps, dim=1)), _np(full), rtol=2e-2, atol=2e-2)


# -- parameters ---------------------------------------------------------------

def test_params_from_jax_raises(model):
    r_cfg, params, p_cfg, _ = model
    tree = jax.tree.map(np.asarray, params)
    with pytest.raises(ValueError, match="missing"):
        params_from_jax({k: v for k, v in tree.items() if k != "final_norm"}, p_cfg, "cpu")
    with pytest.raises(ValueError, match="unexpected"):
        params_from_jax({**tree, "lm_head": {"w": np.zeros((64, 256))}}, p_cfg, "cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["layers"][0]["mixer"]["wq"]["w"] = np.zeros((2, 64, 8, 4), np.float32)
    with pytest.raises(ValueError, match="wq/w: shape"):
        params_from_jax(bad, p_cfg, "cpu")
    bad = jax.tree.map(lambda a: a, tree)
    del bad["layers"][0]["ff"]["wu"]
    with pytest.raises(ValueError, match="missing leaves \\['wu'\\]"):
        params_from_jax(bad, p_cfg, "cpu")
    with pytest.raises(ValueError, match="shape"):  # one period more than n_layers
        params_from_jax(tree, p_cfg.with_(n_layers=3), "cpu")


def test_params_from_jax_unstacks_layers(model):
    _, params, _, ported = model
    for i in range(2):
        want = np.asarray(params["layers"][0]["mixer"]["wo"]["w"][i])
        assert np.array_equal(ported["layers"][i]["mixer"]["wo"]["w"].numpy(), want)
        assert not ported["layers"][i]["mixer"]["wo"]["w"].requires_grad


def test_init_lm():
    cfg = get_reduced(ARCH).with_(d_model=256, n_heads=4, n_kv_heads=2, d_ff=512)
    a = tr.init_lm(0, cfg, device="cpu")
    b = tr.init_lm(0, cfg, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    wq = a["layers"][0]["mixer"]["wq"]["w"]
    assert tuple(wq.shape) == (256, 4, 64) and wq.dtype == torch.float32
    assert abs(float(wq.std()) - 256 ** -0.5) < 0.1 * 256 ** -0.5  # fan-in std
    assert abs(float(a["embed"]["table"].std()) - 0.02) < 0.002
    assert torch.equal(a["final_norm"]["scale"], torch.ones(256))
    assert not any(p.requires_grad for p in a.parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tr.init_lm(0, cfg)


def test_cast_params_leaves_input_alone(model):
    _, _, _, ported = model
    half = nn.cast_params(ported, torch.bfloat16)
    assert half["embed"]["table"].dtype == torch.bfloat16
    assert ported["embed"]["table"].dtype == torch.float32
    same = nn.cast_params(ported, torch.float32)["embed"]["table"]
    assert same.data_ptr() == ported["embed"]["table"].data_ptr()


# -- the MoE model (qwen3-moe-30b-a3b, reduced) --------------------------------

@pytest.fixture(scope="module")
def moe_model():
    r_cfg = r_get_reduced(MOE_ARCH).with_(dtype="float32")
    params = r_tr.init_lm(jax.random.PRNGKey(0), r_cfg)
    p_cfg = get_reduced(MOE_ARCH).with_(dtype="float32")
    ported = params_from_jax(jax.tree.map(np.asarray, params), p_cfg, device="cpu")
    return r_cfg, params, p_cfg, ported


@pytest.mark.parametrize("reduced", [False, True])
def test_moe_config_matches_reference(reduced):
    r_cfg = r_get_reduced(MOE_ARCH) if reduced else r_get_config(MOE_ARCH)
    p_cfg = get_reduced(MOE_ARCH) if reduced else get_config(MOE_ARCH)
    r_fields, p_fields = dataclasses.asdict(r_cfg), dataclasses.asdict(p_cfg)
    assert set(r_fields) == set(p_fields)
    for name in r_fields:
        if name != "kernel_backend":
            assert p_fields[name] == r_fields[name], name
    assert p_cfg.param_counts() == r_cfg.param_counts()
    if not reduced:
        assert p_cfg.param_counts()["total"] == 30_079_125_504


def test_moe_template_matches_reference_at_full_width():
    cfg = get_config(MOE_ARCH)
    shapes = jax.eval_shape(lambda: r_tr.init_lm(jax.random.PRNGKey(0), r_get_config(MOE_ARCH)))
    r_total = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))

    def sizes(t):
        if isinstance(t, nn.Param):
            yield int(np.prod(t.shape))
        else:
            for v in (t.values() if isinstance(t, dict) else t):
                yield from sizes(v)

    assert sum(sizes(tr.lm_template(cfg))) == r_total


def test_moe_params_from_jax_carries_expert_leaves(moe_model):
    _, params, _, ported = moe_model
    for i in range(2):
        for leaf in ("router", "wg", "wu", "wd"):
            want = np.asarray(params["layers"][0]["ff"][leaf]["w"][i])
            assert np.array_equal(ported["layers"][i]["ff"][leaf]["w"].numpy(), want), leaf


@pytest.mark.parametrize("s", [8, 512])
@pytest.mark.parametrize("r_backend,p_backend", BACKENDS)
def test_moe_forward(moe_model, s, r_backend, p_backend):
    r_cfg, params, p_cfg, ported = moe_model
    toks = _tokens(r_cfg, 2, s, seed=15)
    want, r_aux = r_tr.forward(params, r_cfg.with_(kernel_backend=r_backend),
                               tokens=jnp.asarray(toks))
    got, aux = tr.forward(ported, p_cfg.with_(kernel_backend=p_backend),
                          tokens=torch.from_numpy(toks).long())
    assert tuple(got.shape) == (2, s, r_cfg.vocab_padded)
    _close(got, want)
    assert abs(float(aux) - float(r_aux)) <= 1e-5 * max(1.0, abs(float(r_aux)))
    assert float(aux) > 0.0


def test_moe_prefill_step(moe_model):
    r_cfg, params, p_cfg, ported = moe_model
    toks = _tokens(r_cfg, 2, 512, seed=16)
    want = r_make_prefill_step(r_cfg.with_(kernel_backend="pallas_interpret"))(
        params, {"tokens": jnp.asarray(toks)})
    got = make_prefill_step(p_cfg.with_(kernel_backend="cuda"))(
        ported, {"tokens": torch.from_numpy(toks).long()})
    _close(got, want)


def test_moe_decode_step(moe_model):
    r_cfg, params, p_cfg, ported = moe_model
    s = 6
    toks = _tokens(r_cfg, 2, s, seed=17)
    r_cache = r_tr.init_cache(r_cfg, 2, max_seq=8)
    cache = tr.init_cache(p_cfg, 2, max_seq=8, device="cpu")
    step = make_decode_step(p_cfg)
    for t in range(s):
        want, r_cache = r_tr.decode_step(params, r_cache, r_cfg, jnp.asarray(toks[:, t:t + 1]))
        got, cache = step(ported, cache, torch.from_numpy(toks[:, t:t + 1]).long())
        _close(got, want)
    _close(cache["kv"]["k"], r_cache["kv"]["k"].reshape(cache["kv"]["k"].shape))


def test_moe_decode_matches_forward(moe_model):
    """Teacher-forced decode reproduces the forward inside the port, with
    the capacity raised so that token dropping (which legitimately differs
    between a 16-token forward and a 2-token step) cannot enter, as in the
    JAX package's own check (tests/test_models.py), at its 2e-2."""
    _, _, p_cfg, ported = moe_model
    cfg = p_cfg.with_(capacity_factor=64.0)
    s = 8
    toks = torch.from_numpy(_tokens(cfg, 2, s, seed=18)).long()
    full, _ = tr.forward(ported, cfg, tokens=toks)
    cache = tr.init_cache(cfg, 2, max_seq=16, device="cpu")
    steps = []
    for t in range(s):
        lg, cache = tr.decode_step(ported, cache, cfg, toks[:, t:t + 1])
        steps.append(lg[:, 0])
    np.testing.assert_allclose(_np(torch.stack(steps, dim=1)), _np(full), rtol=2e-2, atol=2e-2)


def test_moe_init_lm():
    cfg = get_reduced(MOE_ARCH).with_(d_model=256, d_ff_expert=128, n_experts=4,
                                      param_dtype="bfloat16")
    p = tr.init_lm(0, cfg, device="cpu")
    wg = p["layers"][0]["ff"]["wg"]["w"]
    assert tuple(wg.shape) == (4, 256, 128) and wg.dtype == torch.bfloat16
    assert abs(float(wg.float().std()) - 256 ** -0.5) < 0.1 * 256 ** -0.5
    wd = p["layers"][1]["ff"]["wd"]["w"]
    assert abs(float(wd.float().std()) - 128 ** -0.5) < 0.1 * 128 ** -0.5
