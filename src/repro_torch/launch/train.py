"""Training launcher.

The port of ``repro.launch.train``::

    python -m repro_torch.launch.train --arch granite-3-2b \
        --steps 200 --batch 8 --seq 128 [--device cpu]
    python -m repro_torch.launch.train --arch granite-3-2b --full \
        --steps 3 --batch 4 --seq 2048

The launcher wires: config -> parameters drawn on the device (trainable)
-> AdamW with a warmup-cosine schedule -> synthetic data pipeline ->
fault-tolerant Trainer loop. It runs on the card unless ``device="cpu"``.
The reference's mesh, sharding rules and ``--mesh`` / ``--multi-pod``
options lay the state out over TPU pods and have no counterpart on one
card, nor has its rounding of the batch to the data-parallel degree (1).
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs.registry import get_config, get_reduced
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import transformer as tr
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.runtime.steps import make_train_step
from repro_torch.runtime.trainer import Trainer, TrainerConfig

__all__ = ["launch_train", "make_optimizer"]


def make_optimizer(cfg, steps: int, lr: float = 3e-3) -> AdamW:
    """The launcher's optimizer: AdamW over a warmup-cosine schedule (a
    tenth of ``steps`` of warmup), weight decay 0.01, and a float32 master
    copy when the params are not float32."""
    return AdamW(lr=warmup_cosine(lr, steps // 10 + 1, steps),
                 weight_decay=0.01,
                 master=(cfg.param_dtype != "float32"))


def launch_train(
    arch: str,
    steps: int,
    batch: int,
    seq: int,
    ckpt_dir: str,
    reduced: bool = True,
    lr: float = 3e-3,
    seed: int = 0,
    log_every: int = 10,
    ckpt_every: int = 100,
    device="cuda",
):
    """Train ``arch`` for ``steps`` steps (resuming from ``ckpt_dir``'s
    newest checkpoint, if any). Returns the Trainer's result dict and, in
    addition to the reference's keys, the final ``params`` and
    ``opt_state``."""
    device = resolve_device(device)
    cfg = get_reduced(arch) if reduced else get_config(arch)
    opt = make_optimizer(cfg, steps, lr)
    params = tr.init_lm(seed, cfg, device=device, trainable=True)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt)
    data = SyntheticLM(cfg, batch=batch, seq=seq, seed=seed)

    def batches():
        step = 0
        while True:
            yield {k: torch.from_numpy(v).to(device) for k, v in data.batch_at(step).items()}
            step += 1

    trainer = Trainer(
        TrainerConfig(
            total_steps=steps, ckpt_dir=ckpt_dir,
            ckpt_every=ckpt_every, log_every=log_every,
        ),
        step_fn, batches(), params, opt_state,
        on_metrics=lambda s, m: print(
            f"step {s:5d}  loss {m['loss']:.4f}  "
            f"gnorm {m['grad_norm']:.3f}"
        ),
    )
    res = trainer.run()
    res["params"], res["opt_state"] = trainer.params, trainer.opt_state
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    res = launch_train(
        args.arch, args.steps, args.batch, args.seq, args.ckpt_dir,
        reduced=args.reduced, lr=args.lr, device=args.device,
    )
    print(f"done: {res['final_step']} steps, preempted={res['preempted']}")


if __name__ == "__main__":
    main()
