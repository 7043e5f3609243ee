"""The benchmark's own tests: run them from the repository's root with
``python -m pytest -q perfbench/tests`` (the repository's test run collects
``tests/`` only). Tests marked ``cuda`` need the card and skip without it."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def small(config: dict, scale: float) -> dict:
    """``config`` with every matrix cut to ``scale`` of its rows and
    columns at the same nonzeros per row."""
    import json

    out = json.loads(json.dumps(config))
    for spec in out["matrices"].values():
        spec["rows"] = int(spec["rows"] * scale)
        spec["cols"] = int(spec["cols"] * scale)
        spec["density"] /= scale
    return out
