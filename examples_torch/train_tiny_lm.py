"""End-to-end driver: train a small LM with the full production loop
(config -> trainable parameters on the device -> fault-tolerant trainer
with checkpoints), on the card by default, then check that the loss fell.

    PYTHONPATH=src python examples_torch/train_tiny_lm.py [--arch granite-3-2b]
    PYTHONPATH=src python examples_torch/train_tiny_lm.py --device cpu --steps 30
"""
import argparse
import shutil
import tempfile

from repro_torch.launch.train import launch_train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    ckpt = tempfile.mkdtemp(prefix="repro_torch_tiny_")
    try:
        res = launch_train(
            args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
            ckpt_dir=ckpt, reduced=True, lr=3e-3, log_every=max(1, args.steps // 12),
            ckpt_every=100, device=args.device,
        )
        hist = res["history"]
        first, last = hist[0]["loss"], hist[-1]["loss"]
        print(f"\nloss: {first:.3f} -> {last:.3f} over {res['final_step']} steps")
        assert last < first, "training must reduce loss"
        print("training reduced loss")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    main()
