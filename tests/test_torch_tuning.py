"""Port parity: the performance models (``core/perfmodel.py``), the probe
primitives and the paper's FPGA model (``core/tuning.py``) and the metrics
registry and heartbeat (``runtime/heartbeat.py``) of ``repro_torch``,
against the JAX package, on the CPU.

* Every number the models compute is equal to the reference's, bitwise
  (plain float arithmetic, the same operations in the same order).
* The probe primitives make exactly two timer calls per measurement (the
  autotuner's tests script a fake clock through them) and make no CUDA
  call for host results; ``measure_chunk_knee`` measures the plain
  version's row and sizes each case as the reference does.
* The metrics instruments render the same snapshots for the same writes.
"""
import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro.core import perfmodel as rpm  # noqa: E402
from repro.core import tuning as rtn  # noqa: E402
from repro.runtime import heartbeat as rhb  # noqa: E402
from repro.spgemm import PlanCache as R_PlanCache  # noqa: E402
from repro.spgemm import spgemm_plan as r_spgemm_plan  # noqa: E402
from repro_torch.core import perfmodel as pm  # noqa: E402
from repro_torch.core import tuning as tn  # noqa: E402
from repro_torch.runtime import heartbeat as hb  # noqa: E402
from repro_torch.spgemm import PlanCache, spgemm_plan  # noqa: E402
from repro_torch.spgemm.executor import _default_chunk_policy  # noqa: E402

DEVICES = ("CPU_XEON_E5_2637", "GPU_TITAN_X", "FPGA_ARRIA10")
TABLES = ("PAPER_TABLE7_MS", "PAPER_TABLE8_STUF", "PAPER_TABLE9_J", "PAPER_MATRICES")


class FakeTimer:
    """Scripted perf_counter: every second call advances by the next
    duration, so measurement k reads ``durations[k]`` seconds."""

    def __init__(self, durations):
        self.durations = [float(d) for d in durations]
        self.t = 0.0
        self.calls = 0

    def __call__(self):
        self.calls += 1
        if self.calls % 2 == 0:
            self.t += self.durations.pop(0)
        return self.t


# -- perfmodel -------------------------------------------------------------------

@pytest.mark.parametrize("name", DEVICES)
def test_paper_devices_equal_the_reference(name):
    got, want = getattr(pm, name), getattr(rpm, name)
    assert (got.name, got.clock_Hz, got.parallelism, got.avg_power_W, got.mem_bandwidth) == (
        want.name, want.clock_Hz, want.parallelism, want.avg_power_W, want.mem_bandwidth)
    assert got.peak_flops == want.peak_flops


@pytest.mark.parametrize("name", TABLES)
def test_paper_tables_equal_the_reference(name):
    assert getattr(pm, name) == getattr(rpm, name)


@pytest.mark.parametrize("name", DEVICES)
def test_stuf_runtime_energy_equal_the_reference(name):
    rng = np.random.default_rng(0)
    dev, rdev = getattr(pm, name), getattr(rpm, name)
    for n_ops, r, u in zip(rng.uniform(1e6, 1e12, 8), rng.uniform(1e-4, 1.0, 8),
                           rng.uniform(1e-5, 1e-2, 8)):
        assert pm.stuf(n_ops, dev, r) == rpm.stuf(n_ops, rdev, r)
        assert pm.runtime_from_stuf(n_ops, dev, u) == rpm.runtime_from_stuf(n_ops, rdev, u)
        assert pm.energy(r, dev) == rpm.energy(r, rdev)
    assert pm.stuf(1.0, dev, 0.0) == rpm.stuf(1.0, rdev, 0.0) == 0.0


@pytest.mark.parametrize("tile,group,dtype_bytes", [
    ((8, 8, 8), 2, 4), ((16, 16, 16), 4, 4), ((64, 64, 64), 4, 2), ((32, 64, 128), 8, 4),
])
def test_traffic_and_roofline_equal_the_reference(tile, group, dtype_bytes):
    counts = dict(num_triples=6131, nnzb_a=2708, b_fetches=4100, n_panels=677)
    got = pm.spgemm_schedule_traffic(tile=tile, group=group, dtype_bytes=dtype_bytes, **counts)
    want = rpm.spgemm_schedule_traffic(tile=tile, group=group, dtype_bytes=dtype_bytes, **counts)
    assert got == want
    for name in DEVICES:
        assert (pm.roofline_seconds(got["flops"], got["bytes"], getattr(pm, name))
                == rpm.roofline_seconds(want["flops"], want["bytes"], getattr(rpm, name)))
    unknown = pm.DeviceModel("x", 1e9, 8.0, 1.0)  # no bandwidth: compute only
    assert pm.roofline_seconds(8e9, 1e30, unknown) == pytest.approx(1.0)


def test_cuda_device_model_names_the_card_and_takes_its_peaks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    f32 = pm.cuda_device_model("cuda:0", torch.float32)
    bf16 = pm.cuda_device_model("cuda:0", torch.bfloat16)
    assert f32.name == bf16.name == "NVIDIA H100 80GB HBM3"
    assert f32.peak_flops == pytest.approx(pm.PEAK_F32_FLOPS, rel=1e-12)
    assert bf16.peak_flops == pytest.approx(pm.PEAK_BF16_FLOPS, rel=1e-12)
    assert f32.mem_bandwidth == bf16.mem_bandwidth == pm.PEAK_BYTES_PER_S
    # A float32 plan of 1 TFLOP and 1 byte is compute bound at 67 TFLOP/s.
    assert pm.roofline_seconds(1e12, 1.0, f32) == pytest.approx(1e12 / 67e12)
    with pytest.raises(ValueError):
        pm.cuda_device_model("cpu")


def test_chip_smoke_bounds_by_the_one_definition():
    import sys

    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
    import chip_smoke

    assert chip_smoke.PEAK_F32_FLOPS is pm.PEAK_F32_FLOPS
    assert chip_smoke.PEAK_BF16_FLOPS is pm.PEAK_BF16_FLOPS
    assert chip_smoke.PEAK_BYTES_PER_S is pm.PEAK_BYTES_PER_S


def test_tpu_models_have_no_counterpart():
    for name in ("TPU_V5E_CHIP", "TPU_VMEM_BYTES", "spgemm_grid_step_vmem"):
        assert not hasattr(pm, name)
    for name in ("TPUSpec", "TPU_V5E", "tpu_tile_params"):
        assert not hasattr(tn, name)


# -- tuning: the paper's FPGA model ------------------------------------------------

def test_fpga_model_equals_the_reference():
    assert tn.ARRIA10_GX == tn.FPGASpec(**vars(rtn.ARRIA10_GX))
    assert tn.derive_fpga_params(tn.ARRIA10_GX) == rtn.derive_fpga_params(rtn.ARRIA10_GX) == (16, 32)
    for fb in (2, 4, 8):
        assert tn.derive_fpga_params(tn.ARRIA10_GX, fb) == rtn.derive_fpga_params(rtn.ARRIA10_GX, fb)
    for n_ops, sw, num_pe, stuf in ((1e9, None, None, 1.0), (3.3e8, 8, 16, 0.37),
                                    (7e10, 16, None, 3.4e-3)):
        assert (tn.fpga_runtime_model(n_ops, tn.ARRIA10_GX, sw, num_pe, stuf)
                == rtn.fpga_runtime_model(n_ops, rtn.ARRIA10_GX, sw, num_pe, stuf))


@pytest.mark.parametrize("m,n,density,seed", [(64, 64, 0.03, 1), (96, 80, 0.05, 7), (5, 3, 0.0, 2)])
def test_random_int_coo_equals_the_reference(m, n, density, seed):
    got, want = tn._random_int_coo(m, n, density, seed), rtn._random_int_coo(m, n, density, seed)
    assert got.shape == want.shape
    for x, y in ((got.row, want.row), (got.col, want.col), (got.val, want.val)):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    assert np.asarray(got.val).dtype == np.float32


# -- tuning: the probe primitives -----------------------------------------------------

def test_best_ms_two_timer_calls_per_repeat():
    for fn in (tn.best_ms, rtn.best_ms):
        timer = FakeTimer([0.004, 0.002, 0.003])
        assert fn(lambda: 0, 3, timer=timer) == pytest.approx(2.0)
        assert timer.calls == 6


def test_interleaved_best_ms_matches_the_reference():
    durations = [0.002, 0.003, 0.001, 0.005, 0.004, 0.0015]
    got_t, want_t = FakeTimer(durations), FakeTimer(durations)
    got = tn.interleaved_best_ms([lambda: 0, lambda: 0], 3, timer=got_t)
    want = rtn.interleaved_best_ms([lambda: 0, lambda: 0], 3, timer=want_t)
    assert got == want == pytest.approx([1.0, 1.5])
    assert got_t.calls == want_t.calls == 12


def test_probes_make_no_cuda_call_for_host_results(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a CUDA call on a host result")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    results = (np.zeros(3), torch.zeros(3), [torch.ones(2), (np.ones(1), None)], None)
    for out in results:
        assert tn.best_ms(lambda out=out: out, 2) >= 0.0
    assert len(tn.interleaved_best_ms([lambda out=out: out for out in results], 2)) == 4


def test_complete_waits_for_each_cuda_device_of_the_result(monkeypatch):
    """A result on the card is waited for once per device, inside the timed
    region: between the two timer calls."""
    waited = []
    fake = torch.zeros(2)
    monkeypatch.setattr(tn, "_cuda_devices",
                        lambda out, found: {torch.device("cuda", 0), torch.device("cuda", 1)}
                        if out is fake else found)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d: waited.append(("sync", d)))

    def timer():
        waited.append("timer")
        return 0.0

    tn.best_ms(lambda: fake, 1, timer=timer)
    assert waited[0] == "timer" and waited[-1] == "timer"
    assert sorted(str(w[1]) for w in waited[1:-1]) == ["cuda:0", "cuda:1"]


def test_measure_chunk_knee_on_the_cpu():
    cases = ((64, 64, 64, 0.03, 16, 4), (96, 96, 96, 0.03, 16, 4))
    out = tn.measure_chunk_knee(batch=4, repeats=1, device="cpu", cases=cases)
    assert out["device_backend"] == "cpu" and out["device"] == "cpu"
    assert out["plan_backend"] == "torch"
    assert out["configured_policy_row"] == list(_default_chunk_policy(torch.device("cpu")))
    assert [c["chunk"] for c in out["chunk_sweep"]] == [1, 2, 4, 4]  # (1, 2, 4, batch)
    assert len(out["samples"]) == 2 and all(s["fused_ms_per_set"] > 0 for s in out["samples"])
    sizes = [s["per_set_bytes"] for s in out["samples"]]
    knee = out["knee_bytes"]
    assert knee in [0] + sizes and out["suggested_policy_row"][0] == knee
    json.dumps(out)
    # Each case's per-set bytes are the reference plan's, the quantity
    # batch_chunk compares against the policy budget.
    cache, r_cache = PlanCache(), R_PlanCache()
    for ci, (m, k, n, density, tile, group) in enumerate(cases):
        a, b = tn._random_int_coo(m, k, density, 2 * ci + 1), tn._random_int_coo(k, n, density, 2 * ci + 2)
        ra, rb = rtn._random_int_coo(m, k, density, 2 * ci + 1), rtn._random_int_coo(k, n, density, 2 * ci + 2)
        ex = spgemm_plan(a, b, tile=tile, group=group, device="cpu", cache=cache)._executor
        rex = r_spgemm_plan(ra, rb, tile=tile, group=group, backend="jnp", cache=r_cache)._executor
        assert 4 * ex._per_set_rows * ex._bn == 4 * rex._per_set_rows * rex._bn == sizes[ci]


# -- heartbeat -------------------------------------------------------------------------

def _drive(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("gateway.p.completed")
    c.inc()
    c.inc(4)
    reg.gauge("gateway.inflight_bytes").set(1234)
    s = reg.summary("gateway.p.latency_s", window=16)
    for v in np.random.default_rng(3).uniform(0, 1, 40):
        s.record(v)
    assert reg.counter("gateway.p.completed") is c
    with pytest.raises(TypeError):
        reg.gauge("gateway.p.completed")
    return reg.snapshot(), [s.percentile(p) for p in (0, 1, 50, 99, 100)]


def test_metrics_snapshots_equal_the_reference():
    assert _drive(hb) == _drive(rhb)
    assert hb.Summary().snapshot() == rhb.Summary().snapshot()
    with pytest.raises(ValueError):
        hb.Summary(window=0)


def test_heartbeat_beats_with_metrics_and_peers_are_classified(tmp_path):
    reg = hb.MetricsRegistry()
    reg.counter("gateway.p.submitted").inc(3)
    beat = hb.Heartbeat(str(tmp_path), host="w0", interval=60.0, metrics=reg)
    beat.start()
    with pytest.raises(RuntimeError):
        beat.start()
    beat.stop()
    rec = json.loads((tmp_path / "heartbeat_w0.json").read_text())
    assert rec["host"] == "w0" and rec["metrics"] == {"gateway.p.submitted": 3}
    (tmp_path / "heartbeat_w1.json").write_text(json.dumps({"host": "w1", "time": 0.0}))
    (tmp_path / "heartbeat_w2.json").write_text("{not json")
    assert hb.check_peers(str(tmp_path), timeout=30.0) == {"alive": ["w0"], "dead": ["w1"]}
    assert hb.check_peers(str(tmp_path), 30.0) == rhb.check_peers(str(tmp_path), 30.0)
    beat.start()  # restartable after stop
    beat.stop()
