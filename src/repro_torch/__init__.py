"""FSpGEMM on PyTorch and CUDA: the port of the JAX package ``repro``.

Same module layout and public names as ``repro``; every module here
imports ``torch`` and numpy only. Ported so far: the host sparse layer
(``sparse``), the symbolic phase and the Gustavson oracle (``core``), the
block-Gustavson CUDA kernel with its plain PyTorch version (``kernels``),
and plan/execute SpGEMM (``spgemm``).
"""
