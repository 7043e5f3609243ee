"""The LM stack of the port: config, NN primitives, attention, MLP, blocks,
the transformer, and the carrying of the reference's weights
(``convert``). Text models with attention + MLP blocks are ported."""
