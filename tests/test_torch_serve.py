"""Port parity of the batched server: the port's ``BatchedServer`` against
the JAX package's on the reduced granite-3-2b and the reduced
qwen3-moe-30b-a3b (MoE layers) in float32, and on the reduced mamba2-130m
(SSM layers) and jamba-v0.1-52b (the hybrid: SSM states beside one
attention layer's KV cache per period), serving the JAX server's own
weights (carried across by ``params_from_jax``).

Five requests of different prompt lengths over two slots, so that requests
queue and slots are reused at a shared decode position. Greedy decoding
makes the result a sequence of argmaxes: the outputs must be identical
token for token, and so must ``stats``.

At bfloat16 compute with float32 parameters the server keeps the MoE
router in float32, as the reference routes: its routing logits and expert
choices at a MoE layer equal the reference's ``_moe_local``.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.registry import get_reduced as r_get_reduced  # noqa: E402
from repro.launch.serve import BatchedServer as RServer, Request as RRequest  # noqa: E402
from repro.models.moe import _moe_local  # noqa: E402
from repro_torch.configs.registry import get_reduced  # noqa: E402
from repro_torch.launch.serve import BatchedServer, Request  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.moe import moe_forward, route, router_logits  # noqa: E402

ARCH = "granite-3-2b"
MOE_ARCH = "qwen3-moe-30b-a3b"
PROMPT_LENS = [3, 7, 1, 5, 4]
MAX_NEW = [4, 2, 6, 3, 5]


def _requests(cls, vocab):
    rng = np.random.default_rng(0)
    return [cls(i, rng.integers(0, vocab, n).tolist(), m)
            for i, (n, m) in enumerate(zip(PROMPT_LENS, MAX_NEW))]


def _serve(server, requests):
    for r in requests:
        server.submit(r)
    done = server.run_until_done()
    return {r.rid: (r.out, r.done) for r in done}


def _serve_both(arch):
    r_cfg = r_get_reduced(arch).with_(dtype="float32")
    ref = RServer(r_cfg, batch_slots=2, max_seq=64, seed=0)
    want = _serve(ref, _requests(RRequest, r_cfg.vocab))
    cfg = get_reduced(arch).with_(dtype="float32")
    params = params_from_jax(jax.tree.map(np.asarray, ref.params), cfg, device="cpu")
    port = BatchedServer(cfg, batch_slots=2, max_seq=64, device="cpu", params=params)
    got = _serve(port, _requests(Request, cfg.vocab))
    return ref, want, port, got


@pytest.fixture(scope="module")
def served():
    return _serve_both(ARCH)


@pytest.fixture(scope="module")
def moe_served():
    return _serve_both(MOE_ARCH)


def test_outputs_identical(served):
    _, want, _, got = served
    assert len(want) == len(PROMPT_LENS)
    assert got == want
    assert all(len(out) == m and done for (out, done), m in zip(
        (got[i] for i in range(len(MAX_NEW))), MAX_NEW))


@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-v0.1-52b"])
def test_hybrid_outputs_and_stats_identical(arch):
    """The SSM state rides the cache across slots as in the reference,
    which does nothing to it per slot: a reused slot continues from the
    state its last request left."""
    ref, want, port, got = _serve_both(arch)
    assert got == want and len(got) == len(PROMPT_LENS)
    assert port.stats == ref.stats
    assert "ssm" in port.cache and bool(port.cache["ssm"]["state"].any())


def test_stats_identical(served):
    ref, _, port, _ = served
    assert port.stats == ref.stats
    assert port.stats["tokens"] == sum(MAX_NEW)
    assert port.cache["pos"] == int(ref.cache["pos"]) == port.stats["steps"]


def test_server_holds_weights_in_compute_dtype():
    cfg = get_reduced(ARCH)  # float32 compute
    server = BatchedServer(cfg.with_(dtype="bfloat16"), batch_slots=1, max_seq=8,
                           device="cpu")
    assert server.params["embed"]["table"].dtype == torch.bfloat16
    assert server.cache["kv"]["k"].dtype == torch.bfloat16
    server.submit(Request(0, [1, 2, 3], 2))
    (req,) = server.run_until_done()
    assert len(req.out) == 2 and all(0 <= t < cfg.vocab for t in req.out)


def test_moe_outputs_and_stats_identical(moe_served):
    ref, want, port, got = moe_served
    assert got == want
    assert all(len(got[i][0]) == m and got[i][1] for i, m in enumerate(MAX_NEW))
    assert port.stats == ref.stats


@pytest.fixture(scope="module")
def moe_bf16_servers():
    """The reduced qwen3 at bfloat16 compute, float32 parameters: the JAX
    server and the port's on the JAX server's weights."""
    r_cfg = r_get_reduced(MOE_ARCH).with_(dtype="bfloat16")
    ref = RServer(r_cfg, batch_slots=2, max_seq=64, seed=0)
    cfg = get_reduced(MOE_ARCH).with_(dtype="bfloat16")
    assert cfg.param_dtype == r_cfg.param_dtype == "float32"
    params = params_from_jax(jax.tree.map(np.asarray, ref.params), cfg, device="cpu")
    port = BatchedServer(cfg, batch_slots=2, max_seq=64, device="cpu", params=params)
    return ref, r_cfg, port, cfg


def test_moe_server_keeps_router_float32(moe_bf16_servers):
    _, _, port, _ = moe_bf16_servers
    for layer in port.params["layers"]:
        ff = layer["ff"]
        assert ff["router"]["w"].dtype == torch.float32
        assert ff["wu"]["w"].dtype == ff["wd"]["w"].dtype == torch.bfloat16
    assert port.params["embed"]["table"].dtype == torch.bfloat16


def test_moe_routing_at_bf16_matches_reference(moe_bf16_servers):
    """Layer 0 of the reduced qwen3 on one bf16 input [1, 64, D] from a
    numpy seed. The reference's ``_moe_local`` routes with
    ``einsum(xf.astype(float32), router.astype(float32))`` and
    ``lax.top_k``; the port's logits equal those within float32 rounding
    (1e-5), its expert choices and gates exactly or within 1e-5, and the
    layer's load-balance loss, a function of the probabilities and the
    first choices, within 1e-5. The layer output, bf16 through both
    frameworks' own rounding points, agrees within 2e-2 of its scale."""
    ref, r_cfg, port, cfg = moe_bf16_servers
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 64, cfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    rp = jax.tree.map(lambda a: a[0], ref.params["layers"][0]["ff"])
    pp = port.params["layers"][0]["ff"]

    want_logits = jnp.einsum("td,de->te", xj.reshape(64, -1).astype(jnp.float32),
                             rp["router"]["w"].astype(jnp.float32))
    want_gates, want_experts = jax.lax.top_k(want_logits, r_cfg.top_k)
    got_logits = router_logits(pp, xt.reshape(64, -1))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               rtol=1e-5, atol=1e-5)
    gates, experts, aux = route(pp, xt.reshape(64, -1), cfg)
    assert np.array_equal(experts.numpy(), np.asarray(want_experts))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jax.nn.softmax(want_gates, axis=-1)),
                               rtol=1e-5, atol=1e-5)

    want_y, want_aux = _moe_local(rp, xj, r_cfg, r_cfg.n_experts, None)
    got_y, got_aux = moe_forward(pp, xt, cfg)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5, atol=1e-6)
    want_y = np.asarray(want_y.astype(jnp.float32))
    scale = float(np.abs(want_y).max())
    np.testing.assert_allclose(got_y.float().numpy(), want_y, rtol=0, atol=2e-2 * scale)
