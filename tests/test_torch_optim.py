"""Port parity of the optimizer pieces and the host-side substrate of
training: ``repro_torch.optim`` (AdamW, clipping, schedules, int8
error-feedback compression and its all-reduce), ``runtime.straggler`` and
``data.pipeline.SyntheticLM``, each against the JAX package's function of
the same name on inputs made with numpy from a seed.

Tolerances. AdamW over 3 steps: rtol 1e-6 (float32 arithmetic in the same
order on both sides; XLA and torch may round a transcendental or fuse an
expression one ulp apart). Clipping and the schedules: rtol 1e-6. The
int8 quantization is bitwise: both sides divide in float32 and round half
to even. ``SyntheticLM`` batches are numpy on both sides: bitwise.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs.registry import get_reduced as r_get_reduced  # noqa: E402
from repro.data.pipeline import SyntheticLM as RSyntheticLM  # noqa: E402
from repro.optim import AdamW as RAdamW  # noqa: E402
from repro.optim import clip as r_clip  # noqa: E402
from repro.optim import compress as r_compress  # noqa: E402
from repro.optim import schedules as r_sched  # noqa: E402
from repro.runtime.straggler import StragglerDetector as RStraggler  # noqa: E402
from repro_torch.configs.registry import get_reduced  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.models.tree import flatten_with_paths, tree_leaves  # noqa: E402
from repro_torch.optim import AdamW, clip, compress, schedules  # noqa: E402
from repro_torch.runtime.straggler import StragglerDetector  # noqa: E402

RTOL = 1e-6


def _np_tree(seed, scale=1.0):
    """A small tree of float32 numpy leaves: a dict with a nested list."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"w": f(4, 6), "b": f(6), "layers": [{"x": f(3, 5)}, {"x": f(3, 5), "s": f(5)}]}


def _to_jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda x: jnp.asarray(x).astype(dtype), tree)


def _to_torch(tree, dtype=torch.float32):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)).to(dtype), tree)


def _leaves_close(got, want, rtol=RTOL, atol=0.0):
    got_flat = flatten_with_paths(got)
    want_flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got_flat] == [jax.tree_util.keystr(k) for k, _ in want_flat]
    for (path, g), (_, w) in zip(got_flat, want_flat):
        np.testing.assert_allclose(g.detach().float().numpy(), np.asarray(w, np.float32),
                                   rtol=rtol, atol=atol, err_msg=path)


# -- AdamW --------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["plain", "master_bf16", "schedule"])
def test_adamw_three_steps_match_reference(kind):
    """Three ``update`` steps from the same params and numpy gradients: new
    params, m, v, step (and the master copy) against the reference's."""
    if kind == "master_bf16":
        kw, pdt, jdt = dict(lr=0.05, weight_decay=0.01, master=True), torch.bfloat16, jnp.bfloat16
    elif kind == "schedule":
        kw, pdt, jdt = dict(weight_decay=0.1), torch.float32, jnp.float32
    else:
        kw, pdt, jdt = dict(lr=1e-2, b2=0.99), torch.float32, jnp.float32
    p_lr = schedules.warmup_cosine(0.1, 2, 3) if kind == "schedule" else kw.pop("lr")
    r_lr = r_sched.warmup_cosine(0.1, 2, 3) if kind == "schedule" else p_lr
    popt, ropt = AdamW(lr=p_lr, **kw), RAdamW(lr=r_lr, **kw)
    p0 = _np_tree(0)
    pp, rp = _to_torch(p0, pdt), _to_jax(p0, jdt)
    ps, rs = popt.init(pp), ropt.init(rp)
    for step in range(3):
        g = _np_tree(10 + step, scale=0.5)
        pp, ps = popt.update(_to_torch(g, pdt), ps, pp)
        rp, rs = ropt.update(_to_jax(g, jdt), rs, rp)
    assert all(x.dtype == pdt for x in tree_leaves(pp))
    assert int(ps["step"]) == int(rs["step"]) == 3 and ps["step"].dtype == torch.int32
    # bf16 params: one rounding of the same float32 master value.
    _leaves_close(pp, rp)
    for key in ("m", "v") + (("master",) if kw.get("master") else ()):
        _leaves_close(ps[key], rs[key])


def test_adamw_updates_in_place():
    """The port writes the new params and moments into the given tensors
    and returns those objects."""
    opt = AdamW(lr=0.1)
    params = _to_torch(_np_tree(1))
    state = opt.init(params)
    ids = [id(x) for x in tree_leaves(params)] + [id(x) for x in tree_leaves(state["m"])]
    before = [x.clone() for x in tree_leaves(params)]
    new_params, new_state = opt.update(_to_torch(_np_tree(2)), state, params)
    assert new_params is params
    assert ids == ([id(x) for x in tree_leaves(new_params)]
                   + [id(x) for x in tree_leaves(new_state["m"])])
    assert all(not torch.equal(a, b) for a, b in zip(before, tree_leaves(params)))



@pytest.mark.parametrize("master", [False, True])
def test_adamw_update_in_chunks_is_bitwise(monkeypatch, master):
    """Each leaf is updated a chunk of ``_CHUNK`` elements at a time; the
    update is elementwise, so chunks of 7 give the bits of one chunk."""
    from repro_torch.optim import adamw

    results = []
    for chunk in (1 << 26, 7):
        monkeypatch.setattr(adamw, "_CHUNK", chunk)
        opt = AdamW(lr=0.1, weight_decay=0.01, master=master)
        params = _to_torch(_np_tree(1))
        state = opt.init(params)
        for i in (2, 3):
            params, state = opt.update(_to_torch(_np_tree(i)), state, params)
        results.append(tree_leaves({"p": params, "m": state["m"], "v": state["v"]}))
    assert all(torch.equal(a, b) for a, b in zip(*results))


def test_clip_leaves_matches_clip_by_global_norm():
    """``clip_leaves`` scales the list in place, entry by entry, to the
    values ``clip_by_global_norm`` gives the same tree."""
    t = _to_torch(_np_tree(3))
    want, wnorm = clip.clip_by_global_norm(t, 0.5)
    leaves = tree_leaves(t)
    norm = clip.clip_leaves(leaves, 0.5)
    assert torch.equal(norm, wnorm)
    assert all(torch.equal(a, b) for a, b in zip(leaves, tree_leaves(want)))
    assert all(a is not b for a, b in zip(leaves, tree_leaves(t)))

# -- clipping, schedules ------------------------------------------------------

@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    """Clipped (0.5) and unclipped (1e3) trees, with a bf16 leaf scaled in
    its own dtype."""
    t = _np_tree(3)
    pt, rt = _to_torch(t), _to_jax(t)
    pt["b"], rt["b"] = pt["b"].to(torch.bfloat16), rt["b"].astype(jnp.bfloat16)
    got, gnorm = clip.clip_by_global_norm(pt, max_norm)
    want, wnorm = r_clip.clip_by_global_norm(rt, max_norm)
    np.testing.assert_allclose(float(gnorm), float(wnorm), rtol=RTOL)
    np.testing.assert_allclose(float(clip.global_norm(pt)), float(r_clip.global_norm(rt)),
                               rtol=RTOL)
    assert got["b"].dtype == torch.bfloat16
    _leaves_close(got, want)


@pytest.mark.parametrize("step", [0, 1, 10, 55, 100, 130])
def test_schedules_match_reference(step):
    """warmup_cosine(peak 3e-3, warmup 10, total 100, floor 1e-4) at step 0,
    inside the warmup, at the warmup, inside the decay, at the total and
    past it; constant at the same step; int and int32 tensor steps."""
    want = r_sched.warmup_cosine(3e-3, 10, 100, 1e-4)(jnp.asarray(step, jnp.int32))
    for s in (step, torch.tensor(step, dtype=torch.int32)):
        got = schedules.warmup_cosine(3e-3, 10, 100, 1e-4)(s)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    assert float(schedules.constant(0.3)(step)) == float(r_sched.constant(0.3)(step))


# -- error-feedback compression ------------------------------------------------

def test_ef_compress_matches_reference_bitwise():
    """Three rounds of ``ef_compress`` carrying the residual: int8 q
    bitwise, scales, residuals and ``ef_decompress`` within rtol 1e-6."""
    g0 = _np_tree(4)
    p_res, r_res = compress.ef_init(_to_torch(g0)), r_compress.ef_init(_to_jax(g0))
    for step in range(3):
        g = _np_tree(20 + step)
        pq, ps, p_res = compress.ef_compress(_to_torch(g), p_res)
        rq, rs, r_res = r_compress.ef_compress(_to_jax(g), r_res)
        for (path, a), b in zip(flatten_with_paths(pq), jax.tree.leaves(rq)):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=path)
        _leaves_close(ps, rs)
        _leaves_close(p_res, r_res, atol=1e-7)
        _leaves_close(compress.ef_decompress(pq, ps), r_compress.ef_decompress(rq, rs))


def test_compressed_psum_at_world_size_one(tmp_path):
    """``compressed_psum`` over a one-process gloo group (file store): the
    average of one rank is its dequantized gradient, the residual is
    ``ef_compress``'s."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1)
    try:
        g = _to_torch(_np_tree(5))
        res = compress.ef_init(g)
        avg, new_res = compress.compressed_psum(g, res, group=dist.group.WORLD)
        q, s, want_res = compress.ef_compress(g, res)
        for a, b in zip(tree_leaves(avg), tree_leaves(compress.ef_decompress(q, s))):
            assert torch.equal(a, b)
        for a, b in zip(tree_leaves(new_res), tree_leaves(want_res)):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


# -- straggler detector, synthetic data ----------------------------------------

def test_straggler_events_match_reference():
    """One dt sequence (healthy jitter, a single spike, a sustained 5x
    slowdown, recovery) through both detectors: same events, same fires."""
    rng = np.random.default_rng(6)
    dts = list(0.1 + 0.01 * rng.random(20)) + [0.9] + list(0.1 + 0.01 * rng.random(10))
    dts += [0.5] * 8 + [0.1] * 5
    seen = [], []
    p = StragglerDetector(patience=2, warmup=3, on_straggler=lambda *a: seen[0].append(a))
    r = RStraggler(patience=2, warmup=3, on_straggler=lambda *a: seen[1].append(a))
    fires = [(p.observe(i, dt), r.observe(i, dt)) for i, dt in enumerate(dts)]
    assert all(a == b for a, b in fires) and any(a for a, _ in fires)
    assert p.events == r.events and p.events
    assert seen[0] == seen[1]


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("step", [0, 7])
def test_synthetic_lm_batches_bitwise(arch, step):
    got = SyntheticLM(get_reduced(arch), 4, 32, seed=3).batch_at(step)
    want = RSyntheticLM(r_get_reduced(arch), 4, 32, seed=3).batch_at(step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_synthetic_lm_iter_resumes_at_its_start_step():
    data = SyntheticLM(get_reduced("granite-3-2b"), 2, 16)
    it = data.iter(start_step=5)
    try:
        for step in (5, 6):
            np.testing.assert_array_equal(next(it)["tokens"], data.batch_at(step)["tokens"])
    finally:
        it.close()
