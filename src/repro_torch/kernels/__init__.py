"""Hand-written CUDA kernels for the SpGEMM hot path, with their plain
PyTorch versions.

* ``gustavson_spgemm`` — the paper's FPGA kernel on the GPU: static
  triple-scheduled block-Gustavson SpGEMM, one thread block per output
  tile (``csrc/gustavson_spgemm.cu``), single and batched.
* ``ref`` — plain PyTorch versions: the CPU path and the kernels'
  tolerance oracle.
* ``ops`` — the ``spgemm`` shim over the plan/execute API.
"""
from repro_torch.kernels import ref

# ``ops`` is imported lazily: it shims spgemm onto repro_torch.spgemm, which
# in turn imports the kernel modules of this package.


def __getattr__(name):
    if name == "ops":
        import importlib

        return importlib.import_module("repro_torch.kernels.ops")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
