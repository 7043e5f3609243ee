"""Performance / STUF / energy models (paper Sec. 4.2.4, 5.3.2, 5.3.3).

The paper measures wall-clock and power on an Arria 10 GX FPGA, a Xeon
E5-2637 v3 and a GTX TITAN X. Those three devices, the paper's Tables 7-9
and the STUF / energy / roofline arithmetic are carried over from the JAX
package unchanged (the later paper-table benchmarks read them):

* STUF (spatial-temporal utilization factor): U = N_Ops / (F · P · R),
  with P = FLOPs available per cycle (paper Sec. 5.3.2);
* the roofline estimate of one scheduled block-Gustavson numeric phase
  (:func:`spgemm_schedule_traffic`, :func:`roofline_seconds`), the model
  side of the plan autotuner's search.

The port's own device is the card it runs on: :func:`cuda_device_model`
returns its :class:`DeviceModel`, named by ``torch.cuda.get_device_name``,
with the H100 SXM data-sheet peaks that ``chip_smoke.py`` bounds every
kernel by (:data:`PEAK_F32_FLOPS`, :data:`PEAK_BF16_FLOPS`,
:data:`PEAK_BYTES_PER_S`; one definition, imported there).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

__all__ = [
    "DeviceModel",
    "CPU_XEON_E5_2637",
    "GPU_TITAN_X",
    "FPGA_ARRIA10",
    "PEAK_BF16_FLOPS",
    "PEAK_BYTES_PER_S",
    "PEAK_F32_FLOPS",
    "cuda_device_model",
    "stuf",
    "runtime_from_stuf",
    "energy",
    "spgemm_schedule_traffic",
    "roofline_seconds",
    "PAPER_TABLE7_MS",
    "PAPER_TABLE8_STUF",
    "PAPER_TABLE9_J",
    "PAPER_MATRICES",
]


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    name: str
    clock_Hz: float  # F
    parallelism: float  # P: FLOPs per cycle available
    avg_power_W: float  # average power during SpGEMM (paper-implied)
    mem_bandwidth: float = 0.0  # bytes/s (0 = unknown; roofline helpers
    # then treat the device as compute-bound only)

    @property
    def peak_flops(self) -> float:
        return self.clock_Hz * self.parallelism


# Paper Sec. 5.3.2: CPU = 2 sockets x 4 cores x 32 FLOPs/cycle @ 3.5 GHz;
# E5-2637 v3 is 4-channel DDR4-2133 per socket: ~68 GB/s.
CPU_XEON_E5_2637 = DeviceModel(
    "xeon-e5-2637v3", 3.5e9, 256.0, 128.0, mem_bandwidth=68e9
)
# GPU: 3072 CUDA cores (Table 5; Sec. 5.3.2's 3,584 is a typo), 2 FLOPs/cycle
# @ 1.0 GHz; 336 GB/s GDDR5.
GPU_TITAN_X = DeviceModel(
    "gtx-titan-x", 1.0e9, 6144.0, 160.0, mem_bandwidth=336e9
)
# FPGA: SW*NUM_PE = 512 DSPs busy, 2 FLOPs/cycle each @ 236 MHz; the paper's
# STUF normalizes by all 1,518 DSPs. avg power implied by Table 7/9: ~18.5 W.
# Bandwidth is the paper's C1 = 15 GB/s DDR.
FPGA_ARRIA10 = DeviceModel(
    "arria10-gx", 236e6, 2 * 1518.0, 18.5, mem_bandwidth=15e9
)

# H100 SXM peaks (NVIDIA data sheet). Float32 outside the tensor cores:
# K1's float32 path is FMA with no TF32. Dense bf16 on the tensor cores.
# HBM3 bandwidth. Boost clock 1.98 GHz; 700 W board power.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
_H100_CLOCK_HZ = 1.98e9
_H100_POWER_W = 700.0


def cuda_device_model(device="cuda", dtype=torch.float32) -> DeviceModel:
    """The :class:`DeviceModel` of the card ``device`` for values of
    ``dtype``: named by ``torch.cuda.get_device_name``, with the H100 SXM
    peaks (bf16: the tensor cores' 989 TFLOP/s; any other dtype:
    float32's 67 TFLOP/s) and 3.35 TB/s. The autotuner ranks candidate
    configs with it; ordering is all that ranking reads, so another card
    than an H100 gets the same peaks."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"cuda_device_model needs a CUDA device, got {device}")
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    return DeviceModel(
        torch.cuda.get_device_name(device), _H100_CLOCK_HZ, peak / _H100_CLOCK_HZ,
        _H100_POWER_W, mem_bandwidth=PEAK_BYTES_PER_S,
    )


def stuf(n_ops: float, device: DeviceModel, runtime_s: float) -> float:
    """U = N_Ops / (F · P · R)   (paper Sec. 5.3.2)."""
    if runtime_s <= 0:
        return 0.0
    return n_ops / (device.peak_flops * runtime_s)


def runtime_from_stuf(n_ops: float, device: DeviceModel, u: float) -> float:
    """R = N_Ops / (F · P · U)   (paper Eq. 2 generalized)."""
    return n_ops / (device.peak_flops * u)


def energy(runtime_s: float, device: DeviceModel) -> float:
    """E = R · avg power (paper Sec. 5.3.3)."""
    return runtime_s * device.avg_power_W


def spgemm_schedule_traffic(
    *,
    num_triples: int,
    nnzb_a: int,
    b_fetches: int,
    n_panels: int,
    tile,
    group: int,
    dtype_bytes: int = 4,
) -> Dict[str, float]:
    """FLOP and streamed-byte counts of one scheduled block-Gustavson
    numeric phase, from the plan report's symbolic counters.

    Per triple the kernel runs a dense (bm x bk) @ (bk x bn) MAC —
    ``2·bm·bk·bn`` FLOPs. Traffic is the packed A blocks streamed once
    (``nnzb_a·bm·bk``), every scheduled B-tile fetch (``b_fetches·bk·bn``
    — the OMAR-reduced count, the paper's Sec. 4.2.2 win), and the C
    accumulator panels written out (``n_panels·group·bm·bn``).
    """
    bm, bk, bn = (int(t) for t in tile)
    flops = 2.0 * float(num_triples) * bm * bk * bn
    bytes_streamed = float(dtype_bytes) * (
        float(nnzb_a) * bm * bk
        + float(b_fetches) * bk * bn
        + float(n_panels) * group * bm * bn
    )
    return {"flops": flops, "bytes": bytes_streamed}


def roofline_seconds(
    flops: float, bytes_streamed: float, device: DeviceModel
) -> float:
    """Roofline runtime estimate: max of the compute and memory floors.

    This is the model side of the autotuner's two-stage search
    (``repro_torch.spgemm.autotune``): absolute seconds are
    host-dependent, but the *ordering* over candidate (tile, group)
    configs is what prunes the grid before measured probes. Devices with
    unknown bandwidth (``mem_bandwidth == 0``) rank by compute alone."""
    t = flops / device.peak_flops
    if device.mem_bandwidth > 0:
        t = max(t, bytes_streamed / device.mem_bandwidth)
    return t


PAPER_MATRICES = [
    "poisson3Da",
    "2cubes_sphere",
    "filter3D",
    "cage12",
    "scircuit",
    "mac_econ_fwd500",
    "offshore",
    "webbase-1M",
]

# Paper Table 7: runtime in ms (MKL CPU, cuSPARSE GPU, FSpGEMM FPGA).
PAPER_TABLE7_MS: Dict[str, Dict[str, float]] = {
    "poisson3Da": {"mkl": 27, "cusparse": 8, "fspgemm": 5},
    "2cubes_sphere": {"mkl": 21, "cusparse": 9, "fspgemm": 9},
    "filter3D": {"mkl": 44, "cusparse": 25, "fspgemm": 42},
    "cage12": {"mkl": 147, "cusparse": 46, "fspgemm": 15},
    "scircuit": {"mkl": 32, "cusparse": 14, "fspgemm": 6},
    "mac_econ_fwd500": {"mkl": 36, "cusparse": 11, "fspgemm": 7},
    "offshore": {"mkl": 71, "cusparse": 30, "fspgemm": 23},
    "webbase-1M": {"mkl": 181, "cusparse": 57, "fspgemm": 25},
}

# Paper Table 8: STUF.
PAPER_TABLE8_STUF: Dict[str, Dict[str, float]] = {
    "poisson3Da": {"mkl": 4.7e-4, "cusparse": 2.4e-4, "fspgemm": 3.4e-3},
    "2cubes_sphere": {"mkl": 1.4e-3, "cusparse": 5.0e-4, "fspgemm": 4.3e-3},
    "filter3D": {"mkl": 2.1e-3, "cusparse": 5.6e-4, "fspgemm": 2.9e-3},
    "cage12": {"mkl": 2.6e-4, "cusparse": 1.2e-4, "fspgemm": 3.2e-3},
    "scircuit": {"mkl": 2.9e-4, "cusparse": 1.0e-4, "fspgemm": 2.0e-3},
    "mac_econ_fwd500": {"mkl": 2.3e-4, "cusparse": 1.1e-4, "fspgemm": 1.5e-3},
    "offshore": {"mkl": 1.2e-4, "cusparse": 4.1e-5, "fspgemm": 4.6e-4},
    "webbase-1M": {"mkl": 4.2e-4, "cusparse": 2.0e-4, "fspgemm": 3.9e-3},
}

# Paper Table 9: energy in J.
PAPER_TABLE9_J: Dict[str, Dict[str, float]] = {
    "poisson3Da": {"mkl": 3.46, "cusparse": 1.31, "fspgemm": 0.09},
    "2cubes_sphere": {"mkl": 3.11, "cusparse": 1.22, "fspgemm": 0.17},
    "filter3D": {"mkl": 6.03, "cusparse": 3.43, "fspgemm": 0.79},
    "cage12": {"mkl": 16.91, "cusparse": 6.44, "fspgemm": 0.29},
    "scircuit": {"mkl": 4.35, "cusparse": 1.83, "fspgemm": 0.12},
    "mac_econ_fwd500": {"mkl": 5.22, "cusparse": 1.43, "fspgemm": 0.13},
    "offshore": {"mkl": 9.80, "cusparse": 3.99, "fspgemm": 0.44},
    "webbase-1M": {"mkl": 15.93, "cusparse": 9.86, "fspgemm": 0.47},
}
