"""Mixture-of-Experts with sort-based capacity dispatch.

The port of ``repro.models.moe`` on one device. Tokens are routed top-k in
float32, the (token, slot) pairs stably sorted by expert (the paper's CSV
vector-major order at expert granularity), each expert keeps its first
``capacity`` pairs, and the kept tokens are scattered into a capacity-
slotted dispatch tensor [E, C, D]. Capacity-dropped pairs contribute
nothing (standard Switch behaviour).

The expert compute goes through :func:`repro_torch.kernels.ops.grouped_matmul`
(K4) on the dispatch tensor flattened to [E*C, D], whose tiles of ``tm``
rows each belong to one expert (``tile_expert = arange(E).repeat_interleave(C
// tm)``). That is exactly the reference's batched einsum over [E, C, D],
whose docstring has the TPU dispatch to the same kernel. K4's float32
result is cast to the compute dtype, where the reference's einsum returns
it. On CPU tensors the same routing runs with K4's plain version.

Training: each expert matmul is an :class:`_ExpertMatmul`, whose backward
is the reference's einsum VJP written as two more grouped matmuls in the
same expert-blocked layout, dX[e] = dY[e] W[e]^T over the [E*C, F] rows
and dW[e] = X[e]^T dY[e] over the [E*D, C] rows of X transposed per
expert. So the MoE layer trains on the card through K4 alone (3 launches
in its forward, 6 in its backward), and on the CPU through K4's plain
version.

Expert parallelism (the reference's ``shard_map`` over the ``expert`` mesh
axis) is not ported: one card holds every expert.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import _act
from repro_torch.models.nn import Param

__all__ = ["moe_t", "moe_forward", "route", "router_logits"]

# Row tiles the grouped matmul may take, largest first; C is a multiple of 8
# (and so is every expert's D, for the backward's dw).
_TILE_ROWS = (128, 64, 32, 16, 8)


def moe_t(cfg: ModelConfig) -> Dict:
    """Router and expert weights. The expert leaves [E, D, F] and [E, F, D]
    are drawn with std 1/sqrt(fan-in) of their own contraction axis
    (D, resp. F): the port's default takes shape[0] as the fan-in, which
    for them is the expert count."""
    d, f, e = cfg.d_model, cfg.expert_ff, cfg.n_experts
    up = f"normal:{d ** -0.5}"
    t: Dict = {
        "router": {"w": Param((d, e), "normal:0.02")},
        "wd": {"w": Param((e, f, d), f"normal:{f ** -0.5}")},
    }
    if cfg.mlp_gated:
        t["wg"] = {"w": Param((e, d, f), up)}
    t["wu"] = {"w": Param((e, d, f), up)}
    return t


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # multiple of 8, ≥ 8


def _tile_rows(cap: int) -> int:
    return next(tm for tm in _TILE_ROWS if cap % tm == 0)


def router_logits(p, xf: torch.Tensor) -> torch.Tensor:
    """Routing logits [T, E] of tokens xf [T, D]: xf and the router weight
    in float32, as the reference routes. The weight is held in float32
    (:func:`repro_torch.models.nn.cast_params` never rounds it to the
    compute dtype), so the upcast here changes no value."""
    return xf.float() @ p["router"]["w"].float()


def route(p, xf: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing of tokens xf [T, D] in float32. Returns (gates [T, k]
    softmaxed over the chosen experts, experts [T, k] int64, the
    Switch/GShard load-balance loss)."""
    e = cfg.n_experts
    logits = router_logits(p, xf)
    gates, experts = torch.topk(logits, cfg.top_k, dim=-1)
    gates = torch.softmax(gates, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(dim=0)
    ce = torch.nn.functional.one_hot(experts[:, 0], e).float().mean(dim=0)
    return gates, experts, e * torch.sum(me * ce)


class _ExpertMatmul(torch.autograd.Function):
    """y = x @ w per expert through K4, cast to x's dtype, with the einsum
    VJP as two more K4 calls.

    x [E*C, D] is expert-blocked (expert e owns rows [e*C, (e+1)*C), in
    tiles of ``tm`` rows listed by ``te``); w [E, D, F] is already in x's
    dtype. The backward skips the product whose input needs no gradient:

    * dx = dy @ w^T: dy [E*C, F] times w transposed [E, F, D], on the
      forward's tiles. dy arrives in x's dtype (the forward's output is
      cast to it), so rounding it there is exact.
    * dw = x^T @ dy: x transposed per expert [E*D, C'] times dy [E, C', F],
      tiles of the largest of ``_TILE_ROWS`` that divides D, one expert's
      D rows per run of tiles. C' is C padded to a multiple of 16 (K4's
      contraction; C is a multiple of 8) with zero columns of x^T and zero
      rows of dy, which add nothing.

    dx comes back in x's dtype and dw in w's, as the reference's einsum
    VJP in the compute dtype; autograd's backward of ``w.to(x.dtype)``
    then widens dw to the parameter's dtype. Each transposed copy is freed
    before the next launch."""

    @staticmethod
    def forward(ctx, x, w, te, tm, backend):
        ctx.save_for_backward(x, w, te)
        ctx.tm, ctx.backend = tm, backend
        return kops.grouped_matmul(x, w, te, tm=tm, backend=backend).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w, te = ctx.saved_tensors
        e, d, f = (int(s) for s in w.shape)
        c = int(x.shape[0]) // e
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            wt = w.transpose(1, 2).contiguous()
            dx = kops.grouped_matmul(dy, wt, te, tm=ctx.tm, backend=ctx.backend).to(x.dtype)
            del wt
        if ctx.needs_input_grad[1]:
            pad = -c % 16
            xt = torch.nn.functional.pad(x.view(e, c, d).transpose(1, 2), (0, pad))
            dye = torch.nn.functional.pad(dy.view(e, c, f), (0, 0, 0, pad))
            tmw = _tile_rows(d)
            tew = torch.arange(e, dtype=torch.int32, device=x.device).repeat_interleave(d // tmw)
            dw = kops.grouped_matmul(xt.reshape(e * d, c + pad), dye, tew, tm=tmw,
                                     backend=ctx.backend).view(e, d, f).to(w.dtype)
        return dx, dw, None, None, None


def _grouped(x: torch.Tensor, w: torch.Tensor, te: torch.Tensor, tm: int,
             cfg: ModelConfig) -> torch.Tensor:
    """One expert matmul through K4, cast back to x's dtype; differentiable
    through :class:`_ExpertMatmul`."""
    return _ExpertMatmul.apply(x, w.to(x.dtype), te, tm, cfg.kernel_backend)


def moe_forward(p, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (y, aux_loss)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    dev, dt = x.device, x.dtype
    xf = x.reshape(t, d)
    gates, experts, aux = route(p, xf, cfg)

    # CSV order: stable-sort the pairs by expert; position within the group.
    e_flat = experts.reshape(-1)
    g_flat = gates.reshape(-1)
    tok_flat = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(e_flat, stable=True)
    e_sort, g_sort, tok_sort = e_flat[order], g_flat[order], tok_flat[order]
    group_start = torch.searchsorted(e_sort, torch.arange(e, device=dev), right=False)
    pos = torch.arange(t * k, device=dev) - group_start[e_sort]
    cap = _capacity(t, cfg)
    keep = pos < cap

    slot_e = torch.where(keep, e_sort, e - 1)
    slot_c = torch.where(keep, pos, cap - 1)
    dispatch = torch.zeros((e, cap, d), dtype=dt, device=dev)
    dispatch.index_put_((slot_e, slot_c),
                        torch.where(keep[:, None], xf[tok_sort], 0).to(dt), accumulate=True)

    # Expert compute: the grouped matmul over [E*C, D], one expert per tile.
    tm = _tile_rows(cap)
    te = torch.arange(e, dtype=torch.int32, device=dev).repeat_interleave(cap // tm)
    xd = dispatch.reshape(e * cap, d)
    act = _act(cfg.act)
    if cfg.mlp_gated:
        h = act(_grouped(xd, p["wg"]["w"], te, tm, cfg)) * _grouped(xd, p["wu"]["w"], te, tm, cfg)
    else:
        h = act(_grouped(xd, p["wu"]["w"], te, tm, cfg))
    y_exp = _grouped(h, p["wd"]["w"], te, tm, cfg).reshape(e, cap, d)

    # Combine: gather each kept pair's expert output, weight it by its gate.
    gathered = y_exp[torch.where(keep, e_sort, 0), torch.where(keep, pos, 0)]  # [T*k, D]
    contrib = torch.where(keep[:, None], gathered * g_sort[:, None].to(dt), 0)
    y = torch.zeros((t, d), dtype=dt, device=dev).index_add_(0, tok_sort, contrib)
    return y.reshape(b, s, d), aux.float()
