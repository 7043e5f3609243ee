"""``BENCHMARK.json`` within its contract, and a cell, a configuration, a
traffic mix and a metric added by files and entries alone."""
import json
import re
import shutil

import pytest

from conftest import ROOT
from perfbench import manifest as mf

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_and_paths():
    assert set(BENCH) == TOP
    assert 1 <= len(BENCH["paths"]) <= 16 and len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and not p.startswith("/")
        assert ".." not in p.split("/") and not p.endswith("_torch")
    for word in BENCH["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # A full check of 24 cells fits its 43,200 s.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert LINE.match(c["source"]) and LINE.match(c["why"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and LINE.match(w["why"])
        assert mf.NAME.match(w["config"]) and mf.NAME.match(w["traffic"])
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert w["config"] in {c["name"] for c in BENCH["configs"]}
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        allowed = {"name", "unit", "better", "source", "workloads"} | (
            {"bound"} if m in BENCH["end_to_end"] else {"layer", "moves"})
        assert set(m) - {"workloads"} == allowed - {"workloads"}
        assert mf.UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        names.append(m["name"])
    assert all(mf.NAME.match(n) for n in names)
    assert len({c["name"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)


def test_metrics_cover_the_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    man = mf.Manifest(ROOT)
    for cell in cells:
        reported = {m["name"] for m in man.metrics(cell, trace=False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert man.metrics(cell, trace=True)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and LINE.match(m["layer"])
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", [cell]), (m["name"], cell)


def test_configs_state_what_the_program_runs():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert (ROOT / "perfbench" / "systems" / cfg["system"] / "__init__.py").is_file()
        assert all(v > 0 for v in cfg.get("limits", {}).values())
        if cfg["system"] != "spgemm":
            continue
        assert cfg["tile"] == 64 and cfg["group"] == 4
        assert cfg["value_dtype"] == "float32" and cfg["output"] == "block"
        assert cfg["assumed"] and 0 < cfg["limits"]["c_err"] < 1e-3
        for name, spec in cfg["matrices"].items():
            want = round(spec["rows"] * spec["cols"] * spec["density"])
            assert cfg["sizes"][f"{name}_nnz"] == want


def test_every_cell_names_an_entry_and_a_loop():
    for w in BENCH["workloads"]:
        cfg = mf.Manifest(ROOT).config(w["config"])
        traffic = mf.Manifest(ROOT).traffic(w["traffic"])
        assert mf.entry(cfg["system"], traffic["entry"]).__name__ == "Entry"
        assert callable(mf.loop(traffic["loop"]).run)


TOY_ENTRY = """
class Entry:
    spans = {}

    def __init__(self, config, traffic, seed, device):
        self.gain = config["gain"]

    def product(self, i):
        return "echo"

    def call(self, i):
        return self.gain * i

    def counters(self):
        return {"calls": 0}

    def extra_checks(self, counters, requests):
        return {}

    def release(self):
        pass

    def check(self, kept, control=False):
        return {"echo_err": max(abs(v - 2.0 * i) for i, v in kept.items())}, len(kept)

    def least_seconds(self, i):
        return None
"""

RUN_TOY = r"""
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
from perfbench import manifest as mf
from perfbench.run import correct, metrics, run_cell
man = mf.Manifest({root!r})
rec, checks, n, peak = run_cell(man, man.cell("toy.echo"), 7, 0.2, False, "cpu",
                                time.perf_counter())
out = metrics(man, "toy.echo", rec, True)
print(json.dumps({{"checks": checks, "correct": correct(checks), "metrics": out,
                  "toy": sys.modules["perfbench.systems.toy.echo"].__file__}}))
"""


def test_a_cell_of_another_system_is_added_by_files_alone(tmp_path):
    """A configuration of a new system, with a limit of its own name, its
    entry, a traffic mix and a metric: new files and entries only."""
    import subprocess
    import sys

    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "perfbench/systems/toy").mkdir()
    (root / "perfbench/systems/toy/__init__.py").write_text('"""A toy system."""\n')
    (root / "perfbench/systems/toy/echo.py").write_text(TOY_ENTRY)
    (root / "perfbench/configs/toy.json").write_text(json.dumps(
        {"name": "toy", "system": "toy", "gain": 2.0, "limits": {"echo_err": 0.5}}))
    (root / "perfbench/traffic/echo.json").write_text(json.dumps(
        {"loop": "closed", "entry": "echo", "sample": 4}))
    (root / "perfbench/metrics/requests_total.py").write_text(
        "def read(run):\n    return len(run.requests)\n")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "a toy", "file": "perfbench/configs/toy.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "toy.echo", "config": "toy", "traffic": "echo",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "requests_total", "unit": "req", "better": "higher",
                               "source": "host_clock", "layer": "whole request",
                               "moves": "requests_per_s", "workloads": ["toy.echo"]})
    for m in bench["end_to_end"]:
        if m["name"] == "requests_per_s":
            m["workloads"].append("toy.echo")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = RUN_TOY.format(root=str(root), src=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["toy"].startswith(str(root))
    assert got["checks"]["echo_err"] == {"value": 0.0, "limit": 0.5}
    assert got["checks"]["unanswered"] == {"value": 0, "limit": 0.0}
    assert got["correct"] is True
    assert got["metrics"]["requests_total"]["value"] > 0
    assert set(got["metrics"]) == {"requests_total"}


def test_a_cell_is_added_by_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "perfbench/configs/fem14k.json").read_text())
    cfg["name"] = "fem14k_x"
    (root / "perfbench/configs/fem14k_x.json").write_text(json.dumps(cfg))
    (root / "perfbench/traffic/execute_x.json").write_text(json.dumps(
        {"loop": "closed", "entry": "execute", "products": ["AB2"], "value_sets": 2,
         "sample": 1}))
    bench["configs"].append(dict(bench["configs"][0], name="fem14k_x",
                                 file="perfbench/configs/fem14k_x.json"))
    bench["workloads"].append({"name": "fem14k_x.execute_x", "config": "fem14k_x",
                               "traffic": "execute_x", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    man = mf.Manifest(root)
    cell = man.cell("fem14k_x.execute_x")
    assert man.config(cell["config"])["name"] == "fem14k_x"
    assert man.traffic(cell["traffic"])["products"] == ["AB2"]
    assert [m["name"] for m in man.metrics(cell["name"], trace=False)] == ["setup_s"]


def test_names_outside_the_alphabet_are_refused():
    with pytest.raises(ValueError):
        mf.Manifest(ROOT).config("../BENCHMARK")
    with pytest.raises(ValueError):
        mf.entry("spgemm", "execute.x")
