"""Hand-written CUDA kernels, with their plain PyTorch versions.

* ``gustavson_spgemm`` — the paper's FPGA kernel on the GPU: static
  triple-scheduled block-Gustavson SpGEMM, one thread block per output
  tile (``csrc/gustavson_spgemm.cu``), single and batched.
* ``flash_attention`` — online-softmax prefill attention with causal,
  window and ``q_offset`` masking, one thread block per (bh, q tile)
  (``csrc/flash_attention.cu``).
* ``bsr_spmm`` — dense activations times a block-sparse weight, one
  thread block per (row tile, column panel) (``csrc/bsr_spmm.cu``).
* ``moe_gmm`` — the grouped expert matmul over expert-sorted row tiles,
  one thread block per (row tile, column tile) (``csrc/moe_gmm.cu``).
* ``ref`` — plain PyTorch versions: the CPU path and the kernels'
  tolerance oracle.
* ``ops`` — the entry points: the ``spgemm`` shim over the plan/execute
  API, ``sparse_dense_matmul``, ``grouped_matmul`` and ``attention``.

The JAX package's ``kernels/_compat.py`` has no counterpart: it picks
Pallas's ``CompilerParams`` or ``TPUCompilerParams``, whichever the
installed JAX names, for the TPU kernels' compiler options. The CUDA
kernels take their options from ``nvcc``'s command line
(``kernels/_build.py``), and nothing here depends on a JAX release.
"""
from repro_torch.kernels import ref

# ``ops`` is imported lazily: it shims spgemm onto repro_torch.spgemm, which
# in turn imports the kernel modules of this package.


def __getattr__(name):
    if name == "ops":
        import importlib

        return importlib.import_module("repro_torch.kernels.ops")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
