"""The LM stack of the port: config, NN primitives, attention, MLP, blocks,
the transformer with its loss, trees of tensors (``tree``), and the
carrying of the reference's weights (``convert``). Text models with
attention + MLP or attention + MoE blocks are ported."""
