"""Port parity of the MoE layer: the port's ``moe_forward`` against the JAX
package's on the reduced qwen3-moe-30b-a3b in float32, with the reference's
weights (``params_from_jax``) and inputs made with numpy from a seed.

The routing must agree exactly: the experts chosen for every (token, slot)
are compared bitwise before any value is (``torch.topk`` and
``jax.lax.top_k`` may order exact ties differently; a near-tie that flips
shows here). Then the layer's output within 1e-5 relative to its scale
(``atol`` is 1e-5 times the largest magnitude of the reference's output,
as in test_torch_models: the reference's initialiser draws expert weights
with std 1/sqrt(n_periods), so outputs reach ~200, where a float32 ulp is
1.5e-5; the two packages sum in different orders) and the load-balance
loss within 1e-6. The expert compute goes through ``ops.grouped_matmul``
(K4) with the tiles the capacity gives; on CPU tensors that runs K4's
plain version.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.registry import get_reduced as r_get_reduced  # noqa: E402
from repro.models import moe as r_moe  # noqa: E402
from repro.models import transformer as r_tr  # noqa: E402
from repro_torch.configs.registry import get_reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"


@pytest.fixture(scope="module")
def layer():
    r_cfg = r_get_reduced(ARCH).with_(dtype="float32")
    params = r_tr.init_lm(jax.random.PRNGKey(0), r_cfg)
    cfg = get_reduced(ARCH).with_(dtype="float32")
    ported = params_from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu")
    r_ff = jax.tree.map(lambda a: a[0], params["layers"][0]["ff"])
    return r_cfg, r_ff, cfg, ported["layers"][0]["ff"]


def _x(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _reference(monkeypatch, r_ff, x, r_cfg):
    """The reference's layer output, aux loss and chosen experts."""
    chosen = []
    real = jax.lax.top_k

    def spy(operand, k):
        out = real(operand, k)
        chosen.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(jax.lax, "top_k", spy)
    y, aux = r_moe.moe_forward(r_ff, jnp.asarray(x), r_cfg)
    monkeypatch.setattr(jax.lax, "top_k", real)
    (experts,) = chosen
    return np.asarray(y), float(aux), experts


def _pairs_dropped(experts: np.ndarray, cap: int) -> int:
    counts = np.bincount(experts.reshape(-1))
    return int(np.maximum(counts - cap, 0).sum())


# (b, s, capacity factor) -> capacity 8 (tile 8), 16 (tile 16), 80 (tile 16)
# and 32 (tile 32, with dropped pairs).
@pytest.mark.parametrize("b,s,cf", [(1, 8, 1.25), (2, 16, 1.25), (4, 64, 1.25), (4, 64, 0.5)])
def test_moe_forward_matches_reference(monkeypatch, layer, b, s, cf):
    r_cfg, r_ff, cfg, p = layer
    r_cfg, cfg = r_cfg.with_(capacity_factor=cf), cfg.with_(capacity_factor=cf)
    x = _x(b, s, cfg.d_model, seed=b * s)
    want, r_aux, r_experts = _reference(monkeypatch, r_ff, x, r_cfg)

    xt = torch.from_numpy(x)
    _, experts, _ = moe.route(p, xt.reshape(b * s, -1), cfg)
    assert np.array_equal(experts.numpy(), r_experts)

    calls = []
    real = ops.grouped_matmul
    monkeypatch.setattr(ops, "grouped_matmul",
                        lambda *a, **kw: calls.append((a, kw)) or real(*a, **kw))
    got, aux = moe.moe_forward(p, xt, cfg)
    cap = moe._capacity(b * s, cfg)
    tm = {8: 8, 16: 16, 80: 16, 32: 32}[cap]
    assert len(calls) == 3  # gate, up, down
    for (xa, w, te), kw in calls:
        assert kw["tm"] == tm and tuple(xa.shape)[0] == cfg.n_experts * cap
        assert torch.equal(te, torch.arange(cfg.n_experts).repeat_interleave(cap // tm).int())
    if cf < 1:
        assert _pairs_dropped(r_experts, cap) > 0  # the case exercises dropping
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, cfg.d_model)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * scale)
    assert abs(float(aux) - r_aux) <= 1e-6
    assert aux.dtype == torch.float32


def test_capacity_matches_reference():
    r_cfg, cfg = r_get_reduced(ARCH), get_reduced(ARCH)
    for n, cf in ((1, 1.25), (4, 1.25), (8192, 1.25), (300, 0.3), (100_000, 2.0)):
        assert moe._capacity(n, cfg.with_(capacity_factor=cf)) == r_moe._capacity(
            n, r_cfg.with_(capacity_factor=cf))


@pytest.mark.parametrize("cap,tm", [(8, 8), (16, 16), (24, 8), (80, 16), (96, 32),
                                    (640, 128), (192, 64)])
def test_tile_rows(cap, tm):
    assert moe._tile_rows(cap) == tm


def test_expert_init_std():
    """Expert leaves are drawn with 1/sqrt of their own fan-in (D for the
    gate and up projections, F for the down one), not of the expert
    count that leads their shape."""
    cfg = get_reduced(ARCH).with_(d_model=256, d_ff_expert=64, n_experts=4)
    t = moe.moe_t(cfg)
    assert t["wg"]["w"].shape == (4, 256, 64) and t["wg"]["w"].init == f"normal:{256 ** -0.5}"
    assert t["wu"]["w"].init == f"normal:{256 ** -0.5}"
    assert t["wd"]["w"].shape == (4, 64, 256) and t["wd"]["w"].init == f"normal:{64 ** -0.5}"
    assert t["router"]["w"].init == "normal:0.02"
    assert set(t) == set(r_moe.moe_t(r_get_reduced(ARCH)))
