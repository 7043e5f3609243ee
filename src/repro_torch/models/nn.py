"""Parameter templates and the NN primitives of the LM stack.

The port of ``repro.models.nn``. Each module describes its parameters as a
*template*: a tree (dicts and lists) of :class:`Param` leaves giving a
shape and an initialiser. :func:`init_params` materialises a template into
modules: a dict becomes a :class:`ParamTree` (an ``nn.Module`` indexed like
the reference's dict, ``p["wq"]["w"]``), a list an ``nn.ModuleList``, a
leaf an ``nn.Parameter``. Parameters require gradients when they are
made with ``trainable=True`` (training); by default they do not
(serving, whose steps run under ``torch.no_grad``).

The reference's ``optimization_barrier`` and ``logical_axes`` have no
counterpart: the one fences XLA's scheduling across a scan's carry and
the other feeds the mesh's sharding rules, and eager PyTorch on one card
has neither.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

__all__ = [
    "FLOAT32_SUBTREES",
    "Param",
    "ParamTree",
    "cast_params",
    "dense",
    "dense_t",
    "embed_lookup",
    "embedding_t",
    "init_params",
    "rmsnorm",
    "rmsnorm_t",
]


@dataclasses.dataclass(frozen=True)
class Param:
    shape: Tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | normal:<std>


class ParamTree(nn.Module):
    """A dict of parameters and sub-trees, indexed by key. A tensor entry
    becomes an ``nn.Parameter`` that requires grad iff ``trainable``; an
    ``nn.Parameter`` entry is kept as it is."""

    def __init__(self, entries: Dict[str, Any], trainable: bool = False):
        super().__init__()
        self._names = list(entries)
        for name, value in entries.items():
            if isinstance(value, nn.Parameter):
                self.register_parameter(name, value)
            elif isinstance(value, torch.Tensor):
                self.register_parameter(name, nn.Parameter(value, requires_grad=trainable))
            elif isinstance(value, nn.Module):
                self.add_module(name, value)
            else:
                raise TypeError(f"{name}: expected a tensor or a module, got {type(value)}")

    def __getitem__(self, name: str):
        if name not in self._names:
            raise KeyError(name)
        return getattr(self, name)

    def __contains__(self, name: object) -> bool:
        return name in self._names

    def keys(self):
        return list(self._names)


def _init_leaf(p: Param, generator: torch.Generator, dtype, device) -> torch.Tensor:
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if p.init.startswith("normal"):
        std = float(p.init.split(":")[1]) if ":" in p.init else 1.0 / float(p.shape[0]) ** 0.5
        x = torch.randn(p.shape, generator=generator, dtype=torch.float32, device=device)
        return (x * std).to(dtype)
    raise ValueError(f"unknown init {p.init}")


def init_params(template: Any, generator: torch.Generator, dtype, device,
                trainable: bool = False) -> nn.Module:
    """Materialise a template on ``device``, drawing every normal leaf from
    ``generator`` (which must live on ``device``) in template order; the
    parameters require grad iff ``trainable``.

    A leaf's default std is 1/sqrt(shape[0]) of its own shape. The
    reference applies the same rule to templates stacked over layer
    periods, where shape[0] is the period count; the port's layer
    templates are not stacked, so shape[0] is the fan-in.
    """
    def build(t):
        if isinstance(t, Param):
            return _init_leaf(t, generator, dtype, device)
        if isinstance(t, dict):
            return ParamTree({k: build(v) for k, v in t.items()}, trainable)
        if isinstance(t, (list, tuple)):
            return nn.ModuleList([build(v) for v in t])
        raise TypeError(f"unexpected template node {type(t)}")

    return build(template)


# Subtrees whose leaves the reference always uses in float32, whatever the
# compute dtype: the MoE router (``repro.models.moe._moe_local`` routes with
# ``p["router"]["w"].astype(jnp.float32)``).
FLOAT32_SUBTREES = ("router",)


def cast_params(tree: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A new tree with every floating parameter cast to the dtype the
    reference computes it in: ``dtype``, except the leaves under a key of
    :data:`FLOAT32_SUBTREES`, which are cast to float32. The input tree is
    left as it is (``nn.Module.to`` would cast it in place). Leaves already
    in their dtype are shared, not copied."""
    if isinstance(tree, ParamTree):
        out = {}
        for name in tree.keys():
            value = tree[name]
            to = torch.float32 if name in FLOAT32_SUBTREES else dtype
            if isinstance(value, torch.Tensor):
                out[name] = value.detach().to(to) if value.is_floating_point() else value
            else:
                out[name] = cast_params(value, to)
        return ParamTree(out)
    if isinstance(tree, nn.ModuleList):
        return nn.ModuleList([cast_params(m, dtype) for m in tree])
    raise TypeError(f"unexpected parameter node {type(tree)}")


# ---------------------------------------------------------------------------
# Templates
# ---------------------------------------------------------------------------

def dense_t(
    d_in: int,
    d_out: Tuple[int, ...] | int,
    *,
    bias: bool = False,
    std: Optional[float] = None,
) -> Dict[str, Param]:
    out_dims = (d_out,) if isinstance(d_out, int) else tuple(d_out)
    init = f"normal:{std}" if std is not None else "normal"
    t = {"w": Param((d_in, *out_dims), init)}
    if bias:
        t["b"] = Param(out_dims, "zeros")
    return t


def rmsnorm_t(d: int) -> Dict[str, Param]:
    return {"scale": Param((d,), "ones")}


def embedding_t(vocab: int, d: int) -> Dict[str, Param]:
    return {"table": Param((vocab, d), "normal:0.02")}


# ---------------------------------------------------------------------------
# Apply functions
# ---------------------------------------------------------------------------

def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm as the reference computes it: float32 statistics, the
    inverse cast to x's dtype, then ``x * inv * scale`` in that dtype."""
    dt = x.dtype
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(dt)
    return x * inv * p["scale"].to(dt)


def dense(p, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """x [..., d_in] @ w [d_in, *out] (+ b), both cast to ``dtype`` (x's
    by default). Contracts the last axis."""
    w = p["w"]
    dt = dtype or x.dtype
    y = (x.to(dt) @ w.to(dt).reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])
    if "b" in p:
        y = y + p["b"].to(dt)
    return y


def embed_lookup(p, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return p["table"][tokens].to(dtype)
