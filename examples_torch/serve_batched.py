"""Serve a small model with batched requests through the slot-based
batched decoder (launch/serve.py), on the card by default.

The decoder feeds prompts one token a step through ``decode_step``, whose
attention is the reference's dense score row; the MoE layers of
``--arch qwen3-moe-30b-a3b`` run their experts through K4 at every step.
Then the prompts of the first requests go through ``make_prefill_step``,
the full-sequence forward (K5 on the card), and for a dense model the
greedy token it picks after each prompt must be the server's first
generated token. A MoE model's forward routes a prompt's tokens among
themselves under the experts' capacity, where the decoder routes the
slots of one step together, so its agreement is printed, not asserted.

    PYTHONPATH=src python examples_torch/serve_batched.py [--arch granite-3-2b]
    PYTHONPATH=src python examples_torch/serve_batched.py --device cpu --requests 3
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_reduced
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.runtime.steps import make_prefill_step

PREFILL_CHECKS = 3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_reduced(args.arch)
    server = BatchedServer(cfg, batch_slots=4, max_seq=128, device=args.device)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        plen = int(rng.integers(4, 12))
        server.submit(Request(i, rng.integers(0, cfg.vocab, plen).tolist(),
                              args.max_new))
    t0 = time.time()
    done = server.run_until_done()
    dt = time.time() - t0
    assert len(done) == args.requests
    assert all(len(r.out) == args.max_new for r in done)
    print(f"served {len(done)} requests / {server.stats['tokens']} tokens "
          f"in {dt:.1f}s ({server.stats['tokens']/dt:.1f} tok/s, "
          f"{server.stats['steps']} batch steps)")
    for r in done[:3]:
        print(f"  req {r.rid}: {r.prompt[:4]}... -> {r.out}")

    # The full-sequence forward over each prompt picks the same first token.
    prefill = make_prefill_step(cfg)
    checked = sorted(done, key=lambda r: r.rid)[:PREFILL_CHECKS]
    agree = 0
    for r in checked:
        tokens = torch.tensor([r.prompt], dtype=torch.long, device=server.device)
        first = int(torch.argmax(prefill(server.params, {"tokens": tokens})[0]))
        assert cfg.has_moe or first == r.out[0], (r.rid, first, r.out[0])
        agree += first == r.out[0]
    print(f"prefill (make_prefill_step) agrees with the decoder's first token "
          f"on {agree} of {len(checked)} requests")
    print("OK")


if __name__ == "__main__":
    main()
