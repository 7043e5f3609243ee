"""Launchers: the training launcher (``train``), the batched LM server
(``serve``), the one-card dry-run (``dryrun``, ``refresh_corrections``)
and the device meshes of sharded SpGEMM plans (``mesh``).

The JAX package's ``launch/xla_flags.py`` has no counterpart: it merges a
preset of GPU ``XLA_FLAGS`` (the latency-hiding scheduler, collective
combine thresholds, pipelined collectives) into the environment before
JAX starts. ``XLA_FLAGS`` means nothing to PyTorch, and the collectives
those flags schedule do not exist on one card, so there is no NCCL
setting to carry over either.
"""
