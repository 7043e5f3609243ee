"""Serving launcher: batched autoregressive decoding.

The port of ``repro.launch.serve``. Requests accumulate into a fixed
decode batch (continuous batching simplified to slot-based), prompts are
fed one token per step through the decode path, and every step decodes one
token for every active slot, with the reference's slot assignment, greedy
argmax and ``stats``.

The reference builds a host mesh and logical-axis sharding rules around
its jitted step; on one card there is nothing to shard, so the port drops
them. The server holds the weights on the card in the dtypes the
reference computes them in, cast once at start-up where the reference
casts at every use (``dense`` to the compute dtype, the MoE router to
float32; :func:`repro_torch.models.nn.cast_params`): the values are the
same.

    python -m repro_torch.launch.serve --arch granite-3-2b
    python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.registry import get_reduced
from repro_torch.models import transformer as tr
from repro_torch.models.nn import cast_params
from repro_torch.runtime.steps import make_decode_step
from repro_torch.kernels.backend import resolve_device

__all__ = ["BatchedServer", "Request"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # Slot-local prompt cursor, advanced one token per decode step while
    # the request occupies a slot.
    cursor: int = 0


class BatchedServer:
    """Slot-based batched decoder over the decode step.

    ``params`` (the port's parameter tree, e.g. from
    :func:`repro_torch.models.convert.params_from_jax`) serves given
    weights; without it the server draws them from ``seed``.
    """

    def __init__(self, cfg, batch_slots: int = 8, max_seq: int = 512,
                 seed: int = 0, greedy: bool = True, *, device="cuda",
                 params: Optional[torch.nn.Module] = None):
        if not greedy:
            raise NotImplementedError("only greedy decoding is implemented, as in the reference")
        self.cfg = cfg
        self.slots = batch_slots
        self.max_seq = max_seq
        self.greedy = greedy
        self.device = resolve_device(device)
        if params is None:
            params = tr.init_lm(seed, cfg, device=self.device)
        self.params = cast_params(params, cfg.compute_dtype())
        del params
        self.step = make_decode_step(cfg)
        # One shared position counter requires slot-synchronized decoding;
        # per-request state tracks each slot's progress.
        self.cache = tr.init_cache(cfg, batch_slots, max_seq, device=self.device)
        self.active: Dict[int, Request] = {}
        self.slot_of: Dict[int, int] = {}
        self.pending: Deque[Request] = deque()
        self.tokens = np.zeros((batch_slots, 1), np.int32)
        self.stats = {"steps": 0, "tokens": 0}

    def submit(self, req: Request) -> None:
        self.pending.append(req)

    def _assign_slots(self) -> None:
        free = [s for s in range(self.slots) if s not in self.slot_of.values()]
        while free and self.pending:
            req = self.pending.popleft()
            slot = free.pop(0)
            self.active[req.rid] = req
            self.slot_of[req.rid] = slot
            req.cursor = 0

    def run_until_done(self, max_steps: int = 10_000) -> List[Request]:
        """Decode until all submitted requests complete."""
        finished: List[Request] = []
        for _ in range(max_steps):
            self._assign_slots()
            if not self.active:
                break
            # Feed each slot its next input token (prompt or generated).
            for rid, req in self.active.items():
                s = self.slot_of[rid]
                if req.cursor < len(req.prompt):
                    self.tokens[s, 0] = req.prompt[req.cursor]
                # else keep the last generated token already in place
            token = torch.from_numpy(self.tokens).to(self.device, torch.long)
            logits, self.cache = self.step(self.params, self.cache, token)
            nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
            self.stats["steps"] += 1
            done_now = []
            for rid, req in self.active.items():
                s = self.slot_of[rid]
                cur = req.cursor
                req.cursor = cur + 1
                if cur >= len(req.prompt) - 1:
                    # This step produced a generated token for the slot.
                    req.out.append(int(nxt[s]))
                    self.tokens[s, 0] = int(nxt[s])
                    self.stats["tokens"] += 1
                    if len(req.out) >= req.max_new:
                        req.done = True
                        done_now.append(rid)
            for rid in done_now:
                finished.append(self.active.pop(rid))
                del self.slot_of[rid]
        return finished


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = get_reduced(args.arch)
    server = BatchedServer(cfg, batch_slots=4, max_seq=256, device=args.device)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        server.submit(Request(i, rng.integers(0, cfg.vocab, 8).tolist(), args.max_new))
    t0 = time.time()
    done = server.run_until_done()
    dt = time.time() - t0
    print(f"served {len(done)} requests, {server.stats['tokens']} tokens "
          f"in {dt:.1f}s ({server.stats['tokens'] / dt:.1f} tok/s)")
    for r in done[:3]:
        print(f"  req {r.rid}: prompt {r.prompt[:4]}... -> {r.out[:8]}")


if __name__ == "__main__":
    main()
