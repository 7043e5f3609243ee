"""Launchers: the batched LM server."""
