"""The LM stack of the port: config, NN primitives, attention, MLP, MoE,
the Mamba-2 (SSD) mixer, the audio/vision frontends, blocks, the
transformer with its loss, trees of tensors (``tree``), and the carrying of
the reference's weights (``convert``). Every architecture of the
registry is ported."""
