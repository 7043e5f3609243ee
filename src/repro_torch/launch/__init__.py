"""Launchers: the batched LM server, and the device meshes of sharded
SpGEMM plans."""
