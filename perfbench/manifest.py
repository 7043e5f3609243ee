"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix or one metric
is a file of its own, found by its name:

* ``perfbench/configs/<config>.json``: the configuration, whose ``system``
  names the package ``perfbench/systems/<system>/`` that builds and judges
  it, and whose ``limits`` hold the limit of each number compared that is
  not exact;
* ``perfbench/traffic/<traffic>.json``: the traffic mix, parameters only;
  its ``entry`` names the module ``perfbench/systems/<system>/<entry>.py``
  that serves it, and its ``loop`` the module ``perfbench/loops/<loop>.py``
  that offers it;
* ``perfbench/metrics/<metric>.py``: the metric's reader, ``read(run)``.

So a later change adds a cell, a configuration or a metric by adding files
and entries, never by editing a file that is here.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
# Top-level modules that may not be loaded in a run: the JAX stack and the
# JAX package the port was made from (compared by whole top-level name).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules) -> list:
    """Names among ``modules`` whose top-level name is forbidden."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


class Manifest:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.cells = {c["name"]: c for c in self.data["workloads"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {', '.join(sorted(self.cells))})")
        return self.cells[name]

    def config(self, name: str) -> dict:
        return _json(self.root / "perfbench" / "configs" / f"{_name(name)}.json")

    def traffic(self, name: str) -> dict:
        return _json(self.root / "perfbench" / "traffic" / f"{_name(name)}.json")

    def reader(self, metric: str):
        """The ``read(run)`` function of ``perfbench/metrics/<metric>.py``."""
        path = self.root / "perfbench" / "metrics" / f"{_name(metric)}.py"
        spec = importlib.util.spec_from_file_location(
            "perfbench.metrics." + metric.replace(".", "__").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def metrics(self, cell: str, trace: bool) -> list:
        """The metrics a run of ``cell`` reports: its end-to-end metrics
        with ``trace`` off, its per-layer metrics with it on. A metric
        without ``workloads`` is every cell's (a per-layer one: every cell
        that reports the metric it moves)."""
        e2e = [m for m in self.data["end_to_end"] if cell in m.get("workloads", [cell])]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in moved else [])]


def _name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def entry(system: str, name: str):
    """The ``Entry`` class of ``perfbench/systems/<system>/<name>.py``."""
    return importlib.import_module(f"perfbench.systems.{_module(system)}.{_module(name)}").Entry


def loop(name: str):
    """The module ``perfbench/loops/<name>.py``."""
    return importlib.import_module(f"perfbench.loops.{_module(name)}")


def _module(name: str) -> str:
    if not re.match(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$", name):
        raise ValueError(f"not a module name: {name!r}")
    return name
