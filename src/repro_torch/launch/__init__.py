"""Launchers: the training launcher (``train``), the batched LM server,
and the device meshes of sharded SpGEMM plans."""
