"""FSpGEMM on PyTorch and CUDA: the port of the JAX package ``repro``.

Same module layout and public names as ``repro``; every module here
imports ``torch`` and numpy only. Ported so far: the host sparse layer
(``sparse``), the symbolic phase and the Gustavson oracle (``core``), the
block-Gustavson and flash-attention CUDA kernels with their plain PyTorch
versions (``kernels``), plan/execute SpGEMM (``spgemm``), and LM serving
for text models of attention + MLP blocks (``configs``, ``models``,
``runtime.steps``, ``launch.serve``).
"""
