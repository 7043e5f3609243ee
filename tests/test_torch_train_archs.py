"""Port parity of training the MoE and hybrid architectures: one
``make_train_step`` step of the reduced llama4-scout-17b-a16e (attention
and MoE, capacity 24: the expert backward's padded dw) and
jamba-v0.1-52b (Mamba-2 and attention, MLP and MoE) against the JAX
package's step on the same weights and ``SyntheticLM`` batch, float32.
(tests/test_torch_train.py does the same for granite-3-2b and
qwen3-moe-30b-a3b; tests/test_torch_moe_train.py holds the expert
backward and the gradients.)

Tolerances, as tests/test_torch_train.py states and measures them: the
metrics within 5e-4 relative, the new params within 2 lr absolute, and
within 1e-5 wherever the gradient is not about zero.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import registry as r_registry  # noqa: E402
from repro.data.pipeline import SyntheticLM  # noqa: E402
from repro.models import transformer as r_tr  # noqa: E402
from repro.optim import AdamW as RAdamW  # noqa: E402
from repro.runtime.steps import make_train_step as r_make_train_step  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.tree import flatten_with_paths, tree_leaves  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.runtime.steps import make_train_step  # noqa: E402

GRAD_TOL = 5e-4
LR = 1e-3


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def _ported(tree, cfg, trainable=False):
    return params_from_jax(jax.tree.map(np.asarray, tree), cfg, device="cpu",
                           trainable=trainable)


class _Model:
    def __init__(self, arch):
        self.r_cfg = r_registry.get_reduced(arch).with_(dtype="float32")
        self.p_cfg = registry.get_reduced(arch).with_(dtype="float32")
        self.r_params = r_tr.init_lm(jax.random.PRNGKey(0), self.r_cfg)


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "jamba-v0.1-52b"])
def test_train_step_matches_reference(arch):
    """One ``make_train_step`` step with AdamW(lr 1e-3, weight decay 0.01)
    and clipping at 1.0 against the reference's step, held as
    tests/test_torch_train.py holds qwen3's: the metrics within 5e-4, the
    new params within 2 lr, and within 1e-5 wherever the gradient is not
    about zero (an element whose gradient is about zero can flip its
    update's sign)."""
    m = _Model(arch)
    nb = SyntheticLM(m.r_cfg, 2, 32, seed=0).batch_at(0)
    r_opt = RAdamW(lr=LR, weight_decay=0.01)
    r_step = jax.jit(r_make_train_step(m.r_cfg, r_opt))
    r_new, _, r_met = r_step(m.r_params, r_opt.init(m.r_params),
                             {k: jnp.asarray(v) for k, v in nb.items()})
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    opt = AdamW(lr=LR, weight_decay=0.01)
    params = _ported(m.r_params, m.p_cfg, trainable=True)
    old = [p.detach().clone() for p in tree_leaves(params)]
    new, state, met = make_train_step(m.p_cfg, opt)(params, opt.init(params), batch)
    assert sorted(met) == sorted(r_met) == ["grad_norm", "loss", "moe_aux", "total_loss"]
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(r_met[k]), rtol=GRAD_TOL, atol=1e-7,
                                   err_msg=k)
    assert int(state["step"]) == 1
    fresh = _ported(m.r_params, m.p_cfg, trainable=True)
    total, _ = tr.lm_loss(fresh, m.p_cfg, **batch)
    grads = torch.autograd.grad(total, tree_leaves(fresh))
    want_new = dict(flatten_with_paths(_ported(r_new, m.p_cfg)))
    moved = 0
    for (path, got), g, before in zip(flatten_with_paths(new), grads, old):
        w = _np(want_new[path])
        np.testing.assert_allclose(_np(got), w, rtol=0, atol=2 * LR, err_msg=path)
        g = np.abs(_np(g))
        firm = g > 1e-3 * g.max(initial=0.0)
        np.testing.assert_allclose(_np(got)[firm], w[firm], rtol=0, atol=1e-5, err_msg=path)
        moved += not torch.equal(got.detach(), before)
    assert moved == len(old)
