"""What a run loads and reads: no top-level ``jax``, ``jaxlib``, ``flax`` or
``repro`` (compared by whole top-level name, so ``repro_torch`` passes), and
no file of the JAX package or of its ``benchmarks/`` folder; the command's
refusals without a card and outside a full checkout."""
import json
import re
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT
from perfbench import manifest as mf

RUN_SMALL = r"""
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}, {tests!r}]
from conftest import small
from perfbench import manifest as mf
from perfbench.run import run_cell, metrics
man = mf.Manifest({root!r})
for name, scale in (("fem101k.execute", 0.02), ("fem14k.oneshot", 0.1)):
    cell = man.cell(name)
    config = small(man.config(cell["config"]), scale)
    rec, checks, n, peak = run_cell(man, cell, 3, 0.3, True, "cpu", time.perf_counter(),
                                    config=config)
    metrics(man, name, rec, True)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_forbidden_names_are_whole_top_level_names():
    assert mf.forbidden_modules(["repro_torch", "repro_torch.spgemm", "reprox"]) == []
    assert mf.forbidden_modules(["repro.spgemm", "jax", "jaxlib.xla", "flax"]) == [
        "flax", "jax", "jaxlib.xla", "repro.spgemm"]


def test_a_run_loads_no_jax_and_no_reference_package():
    code = RUN_SMALL.format(root=str(ROOT), src=str(ROOT / "src"),
                            tests=str(ROOT / "perfbench" / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch" in loaded and "perfbench" in loaded
    assert not set(loaded) & set(mf.FORBIDDEN)


def test_sources_name_no_file_of_the_jax_package():
    pattern = re.compile(r"benchmarks/|src/repro/|\bimport (jax|repro)\b|\bfrom (jax|repro)\b")
    for path in (ROOT / "perfbench").rglob("*.py"):
        if path.parent.name == "tests":
            continue
        assert not pattern.search(path.read_text()), path


def _cli(cwd, *args):
    return subprocess.run([sys.executable, "perfbench/run.py", *args], capture_output=True,
                          text=True, timeout=300, cwd=cwd)


def test_command_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _cli(ROOT, "--workload", "fem101k.execute", "--seed", str(2**31 + 5),
               "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA device" in out.stderr


def test_command_outside_a_full_checkout_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path, "--workload", "fem14k.oneshot", "--seed", "1", "--seconds", "1",
               "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fem101k.execute", "fem14k.oneshot"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(card, name, trace):
    out = _cli(ROOT, "--workload", name, "--seed", str(2**31 + 17), "--seconds", "3",
               "--trace", str(trace))
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    names = {m["name"] for m in mf.Manifest(ROOT).metrics(name, bool(trace))}
    assert set(result["metrics"]) <= names and result["metrics"]
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert len(result["breakdown"]["device_ops"]) <= 10
