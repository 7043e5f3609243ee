"""Read the numbers that decide ``correct`` on many seeds, for the program
and for its control, to set their limits (and to show the control fails).

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,...,12 \\
        --control-seeds 1,2,3 --seconds 3

For each seed: the cell's set-up, a short window at the cell's own load,
the program's state freed, and its kept results compared with the
reference, as a run does. On a control seed, the same inputs are also
given to the control: the reference one precision down (TF32 operands,
float32 sums) in the program's place. One JSON line per seed; the limit
is then set between the program's largest reading and the control's
smallest, in the configuration's file.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from perfbench.run import ROOT, _paths  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    _paths()
    import torch

    from perfbench import manifest as mf

    manifest = mf.Manifest(ROOT)
    cell = manifest.cell(args.workload)
    config = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    device = torch.device("cuda", 0)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        sut = mf.entry(config["system"], traffic["entry"])(config, traffic, seed, device)
        reqs, kept, _, _ = mf.loop(traffic["loop"]).run(sut, traffic, args.seconds, seed)
        sut.release()
        row = {"seed": seed, "requests": len(reqs), "ok": sum(r.ok for r in reqs),
               "stored": max((len(c.data) for c in kept.values()), default=0)}
        row["program"], row["compared"] = sut.check(kept)
        if seed in controls:
            row["control"], _ = sut.check(kept, control=True)
        row["seconds"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
        del sut, kept
    return 0


if __name__ == "__main__":
    sys.exit(main())
