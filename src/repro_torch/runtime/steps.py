"""Train, prefill and decode step builders.

The port of ``repro.runtime.steps``. The returned functions run eagerly
(the reference's jit has no counterpart); prefill and decode run under
``torch.no_grad``. The reference's logical axes for the batch and the
cache (``batch_axes``, ``cache_axes``) feed its mesh's sharding rules and
have no counterpart on one card.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig
from repro_torch.models.tree import tree_leaves, tree_map
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.clip import clip_leaves

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step"]


def make_train_step(
    cfg: ModelConfig,
    optimizer: AdamW,
    clip_norm: float = 1.0,
    microbatches: int = 1,
):
    """Build the train step ``(params, opt_state, batch) -> (params,
    opt_state, metrics)``.

    Every parameter is cast to the compute dtype at use (the router too,
    as the reference casts every floating leaf), then ``lm_loss`` runs
    forward and backward; the gradients come back in the params' dtype.
    ``microbatches`` = u > 1 splits the batch along dim 0 and runs the
    forward and backward once per microbatch, one after the other,
    accumulating the gradient in float32, then divides it by u. Then the
    gradient is clipped to ``clip_norm`` and ``optimizer.update`` runs (in
    place, see :mod:`repro_torch.optim.adamw`). ``metrics`` holds
    ``loss``, ``moe_aux``, ``grad_norm`` and ``total_loss`` (0-d tensors
    on the params' device), as the reference's.

    The params must require grad (``init_lm(..., trainable=True)``). The
    reference's ``grad_shardings`` pins the gradient to the ZeRO-1
    layout over the data axes and has no counterpart on one card.
    """
    compute_dt = cfg.compute_dtype()

    def loss_and_grads(leaves, params, ubatch):
        pc = tree_map(lambda x: x.to(compute_dt), params)
        total, metrics = tr.lm_loss(pc, cfg, **ubatch)
        grads = torch.autograd.grad(total, leaves)
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        leaves = tree_leaves(params)
        if not all(p.requires_grad for p in leaves):
            raise ValueError("train_step needs params that require grad: "
                             "init_lm(..., trainable=True)")
        u = microbatches
        if u == 1:
            loss, metrics, grads = loss_and_grads(leaves, params, batch)
        else:
            split = {k: v.reshape(u, v.shape[0] // u, *v.shape[1:]) for k, v in batch.items()}
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            metrics = {"loss": torch.zeros_like(loss), "moe_aux": torch.zeros_like(loss)}
            for i in range(u):
                li, mi, gi = loss_and_grads(leaves, params, {k: v[i] for k, v in split.items()})
                for a, g in zip(grads, gi):
                    a.add_(g.to(torch.float32))
                del gi
                loss = loss + li / u
                metrics = {k: metrics[k] + mi[k] / u for k in metrics}
            grads = [g / u for g in grads]
        grads = list(grads)
        gnorm = clip_leaves(grads, clip_norm)  # replaces the leaves one by one
        it = iter(grads)
        grad_tree = tree_map(lambda _: next(it), params)
        del it, grads
        params, opt_state = optimizer.update(grad_tree, opt_state, params)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["total_loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """Forward over the full prompt; returns last-position logits."""

    @torch.no_grad()
    def prefill_step(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        logits, _ = tr.forward(params, cfg, tokens=batch.get("tokens"),
                               feats=batch.get("feats"))
        return logits[:, -1]

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    @torch.no_grad()
    def decode_step(params, cache, token):
        return tr.decode_step(params, cache, cfg, token)

    return decode_step
