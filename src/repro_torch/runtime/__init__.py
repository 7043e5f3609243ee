"""The LM stack's serving steps (prefill and decode), and the metrics
registry and liveness heartbeat (``heartbeat``) that the SpGEMM serving
gateway records into."""
