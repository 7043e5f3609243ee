"""The check that decides ``correct``, driven through the rest of a run on
the CPU at a small size (the port's plain version in the card's place):
sound runs pass, the control fails, and each fault a cell can have, planted
in the timed path, makes ``correct`` false."""
import time

import numpy as np
import pytest

from conftest import ROOT, small
from perfbench import manifest as mf
from perfbench.run import correct, run_cell

MAN = mf.Manifest(ROOT)
# Cell -> (configuration, traffic, configuration scale, window seconds).
CELLS = {
    "fem101k.execute": ("fem101k", "execute", 0.02, 0.6),
    "fem14k.oneshot": ("fem14k", "oneshot", 0.1, 0.6),
}


def _small(name):
    cfg_name, traffic_name, scale, seconds = CELLS[name]
    return small(MAN.config(cfg_name), scale), MAN.traffic(traffic_name), seconds


def _run(name, seed=11):
    config, traffic, seconds = _small(name)
    cell = {"name": name, "config": CELLS[name][0], "traffic": CELLS[name][1], "chips": 1}
    _, checks, compared, _ = run_cell(MAN, cell, seed, seconds, False, "cpu",
                                      time.perf_counter(), config=config, traffic=traffic)
    assert compared > 0
    return checks


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_run_is_correct(name):
    checks = _run(name)
    assert correct(checks), checks
    assert checks["c_err"]["value"] < checks["c_err"]["limit"] / 10


@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_is_not_correct(name):
    """The reference one precision down (TF32 operands) in the program's
    place fails the limit that the program passes."""
    config, traffic, seconds = _small(name)
    sut = mf.entry(config["system"], traffic["entry"])(config, traffic, 5, "cpu")
    _, kept, _, _ = mf.loop(traffic["loop"]).run(sut, traffic, seconds, 5)
    sut.release()
    program, _ = sut.check(kept)
    control, _ = sut.check(kept, control=True)
    limit = config["limits"]["c_err"]
    assert program["c_err"] < limit < control["c_err"]


def test_execute_hands_each_request_its_own_values():
    """No two requests of the execute entry share a buffer or its values,
    also where they draw on one value set of the pool."""
    config, traffic, _ = _small("fem101k.execute")
    sut = mf.entry("spgemm", "execute")(config, traffic, 5, "cpu")
    sets = int(traffic["value_sets"])
    first, again = sut.values(0), sut.values(sets)
    assert first[0] is first[1]  # A·A: one operand
    assert first[0] is not again[0] and not np.array_equal(first[0], again[0])
    assert np.count_nonzero(first[0] != again[0]) <= 2
    assert np.array_equal(sut.values(3)[0], sut.values(3)[0])
    sut.release()


def _stale(monkeypatch):
    """A step that returns its state unchanged: every execute answers with
    the first result it gave."""
    from repro_torch.spgemm import SpGEMMPlan

    first = {}
    real = SpGEMMPlan.execute

    def execute(self, a_vals=None, b_vals=None):
        out = real(self, a_vals, b_vals)
        return first.setdefault("c", out)

    monkeypatch.setattr(SpGEMMPlan, "execute", execute)


def _altered(monkeypatch):
    """An answer altered where it is produced: C's largest value off by 0.1 %."""
    from repro_torch.spgemm import SpGEMMPlan

    real = SpGEMMPlan._wrap_packed

    def wrap(self, packed):
        packed = packed.clone()
        i = int(packed.abs().argmax())
        packed[i] *= 1.001
        return real(self, packed)

    monkeypatch.setattr(SpGEMMPlan, "_wrap_packed", wrap)


def _cached(monkeypatch):
    """Results cached by a sample of the values: a request whose sampled
    value was seen before is answered without a product."""
    from repro_torch.spgemm import SpGEMMPlan

    memo = {}
    real = SpGEMMPlan.execute

    def execute(self, a_vals=None, b_vals=None):
        key = (id(self), None if a_vals is None else float(np.asarray(a_vals)[-1]))
        if key not in memo:
            memo[key] = real(self, a_vals, b_vals)
        return memo[key]

    monkeypatch.setattr(SpGEMMPlan, "execute", execute)


@pytest.mark.parametrize("name,fault", [
    ("fem101k.execute", _stale), ("fem101k.execute", _altered),
    ("fem101k.execute", _cached),
    ("fem14k.oneshot", _stale), ("fem14k.oneshot", _altered),
])
def test_fault_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    checks = _run(name, seed=12)
    assert not correct(checks), checks


def test_a_result_served_without_a_launch_is_counted():
    """On the card, K1's launches over the window have to equal the
    completed requests."""
    import torch

    from perfbench.loops import Request
    from perfbench.systems.spgemm import Entry

    sut = object.__new__(Entry)
    sut.device = torch.device("cuda", 0)
    reqs = [Request(i, "AA", 0.0, 0.0, 1.0, True, "ok") for i in range(4)]
    assert sut.extra_checks({"k1_launches": 4}, reqs) == {"k1_launch_gap": 0}
    assert sut.extra_checks({"k1_launches": 3}, reqs) == {"k1_launch_gap": 1}
    sut.device = torch.device("cpu")
    assert sut.extra_checks({"k1_launches": 0}, reqs) == {}
