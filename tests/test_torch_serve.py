"""Port parity of the batched server: the port's ``BatchedServer`` against
the JAX package's on the reduced granite-3-2b and the reduced
qwen3-moe-30b-a3b (MoE layers) in float32, serving the JAX server's own
weights (carried across by ``params_from_jax``).

Five requests of different prompt lengths over two slots, so that requests
queue and slots are reused at a shared decode position. Greedy decoding
makes the result a sequence of argmaxes: the outputs must be identical
token for token, and so must ``stats``.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from repro.configs.registry import get_reduced as r_get_reduced  # noqa: E402
from repro.launch.serve import BatchedServer as RServer, Request as RRequest  # noqa: E402
from repro_torch.configs.registry import get_reduced  # noqa: E402
from repro_torch.launch.serve import BatchedServer, Request  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

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
