"""AdamW with optional low-precision params and a float32 master copy.

The port of ``repro.optim.adamw``: ``init(params) -> state`` and
``update(grads, state, params) -> (params, state)``, with the reference's
float32 arithmetic line for line. The state is ``{"m", "v", "step"[,
"master"]}``: float32 moments shaped like the params (plain trees of
dicts and lists), the step count as an int32 0-d tensor on the host (so
that the learning rate and the bias corrections are computed without a
device read) and, with ``master=True``, a float32 copy of the params.

Unlike the reference, ``update`` works in place, under ``torch.no_grad``:
it writes the new moments, master copy and params into the tensors it was
given and returns those same objects (the step count is a new tensor). A
step on granite-3-2b's 2.5 B float32 params then holds one copy of the
params, grads, m and v, not two; each leaf is updated a chunk of
``_CHUNK`` elements at a time.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models.tree import tree_leaves, tree_map

__all__ = ["AdamW"]

# Elements updated at a time: every operation is elementwise, so the
# result is the same bits, and the float32 temporaries of one large leaf
# (llama4-scout's embedding holds 1.03 B) stay at ~0.3 GB each.
_CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    master: bool = False  # keep a float32 master copy (params may be bf16)

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return torch.as_tensor(self.lr(step), dtype=torch.float32)
        return torch.tensor(self.lr, dtype=torch.float32)

    def init(self, params: Any) -> Dict:
        state = {
            "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                          params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                          params),
            "step": torch.zeros((), dtype=torch.int32),
        }
        if self.master:
            state["master"] = tree_map(
                lambda p: p.detach().to(torch.float32, copy=True), params)
        return state

    @torch.no_grad()
    def update(self, grads: Any, state: Dict, params: Any) -> Tuple[Any, Dict]:
        step = state["step"] + 1
        lr = float(self._lr(step))
        b1, b2 = self.b1, self.b2
        stepf = step.to(torch.float32)
        bc1 = float(1.0 - b1 ** stepf)
        bc2 = float(1.0 - b2 ** stepf)
        ref = state["master"] if self.master else params
        for g, m, v, r, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                                 tree_leaves(state["v"]), tree_leaves(ref),
                                 tree_leaves(params), strict=True):
            flat = (g.reshape(-1), m.view(-1), v.view(-1), r.view(-1), p.view(-1))
            for a in range(0, p.numel(), _CHUNK):
                g, m, v, r, p = (x[a:a + _CHUNK] for x in flat)
                m_new = b1 * m + (1 - b1) * g.to(torch.float32)
                v_new = b2 * v + (1 - b2) * (g * g).to(torch.float32)
                upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + self.eps)
                p32 = r.to(torch.float32)
                p32 = p32 - lr * (upd + self.weight_decay * p32)
                m.copy_(m_new)
                v.copy_(v_new)
                if self.master:
                    r.copy_(p32)
                p.copy_(p32.to(p.dtype))
        new_state = {"m": state["m"], "v": state["v"], "step": step}
        if self.master:
            new_state["master"] = state["master"]
        return params, new_state
