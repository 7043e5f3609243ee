"""Recompute the ``corrected`` block of every stored dry-run record with
the unrolled one- and two-period sub-counts (the full-depth counts stay
valid).

The port of ``repro.launch.refresh_corrections``, over the records of
:mod:`repro_torch.launch.dryrun` (``artifacts/dryrun_torch/*__h100.json``);
it forces no device count, as one card has no mesh. A record whose
corrected FLOPs differ from its full-depth count fails.

    PYTHONPATH=src python -m repro_torch.launch.refresh_corrections [--out DIR]
"""
import argparse
import glob
import json
import os
import traceback

from repro_torch.configs.registry import SHAPES
from repro_torch.launch.dryrun import ART_DIR, CARD, corrected_costs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.abspath(ART_DIR),
                    help="directory of the dry-run's records")
    args = ap.parse_args(argv)
    failed = []
    for p in sorted(glob.glob(os.path.join(args.out, f"*__{CARD}.json"))):
        with open(p) as f:
            rec = json.load(f)
        if rec.get("status") != "ok":
            continue
        try:
            cor = corrected_costs(rec["arch"], SHAPES[rec["shape"]], rec)
            rec["corrected"] = cor
            with open(p, "w") as f:
                json.dump(rec, f, indent=1)
            print(f"[refresh] {rec['arch']} {rec['shape']}: "
                  f"flops={cor['flops']:.3e} bytes={cor['bytes']:.3e} "
                  f"matches_full_count={cor['matches_full_count']}", flush=True)
            if not cor["matches_full_count"]:
                failed.append(p)
        except Exception as e:  # keep refreshing; report the failure
            failed.append(p)
            print(f"[refresh] {rec['arch']} {rec['shape']}: FAIL "
                  f"{type(e).__name__}: {str(e)[:200]}", flush=True)
            traceback.print_exc()
    print(f"[refresh] done, {len(failed)} failed", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
