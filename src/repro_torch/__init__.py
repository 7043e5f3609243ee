"""FSpGEMM on PyTorch and CUDA: the port of the JAX package ``repro``.

Same module layout and public names as ``repro``; every module here
imports ``torch`` and numpy only. Ported so far: the host sparse layer
(``sparse``), the symbolic phase and the Gustavson oracle (``core``), a
CUDA kernel for each of ``repro``'s Pallas kernels (block-Gustavson
SpGEMM, block-sparse SpMM, grouped expert matmul, flash attention) with
their plain PyTorch versions and ``ops`` entry points (``kernels``),
plan/execute SpGEMM with compact output, chains, the asynchronous
pipeline, the plan cache and its disk tier, sharded plans, the per-pattern
autotuner and the multi-tenant serving gateway (``spgemm``,
``launch.mesh``, ``runtime.heartbeat``), the paper's performance models
and the probe primitives (``core.perfmodel``, ``core.tuning``), its value
stream (``data``), LM serving for text models of attention + MLP or MoE
blocks (``configs``, ``models``, ``runtime.steps``, ``launch.serve``), and
LM training: the loss with its backward, AdamW, clipping, schedules and
gradient compression, the fault-tolerant trainer with checkpoints, the
synthetic token pipeline and the launcher (``models.transformer.lm_loss``,
``optim``, ``runtime.trainer``, ``checkpoint``, ``data``,
``launch.train``).
"""
