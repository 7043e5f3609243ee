"""The LM stack's steps (train, prefill and decode), the fault-tolerant
training loop (``trainer``) with its straggler detector (``straggler``),
and the metrics registry and liveness heartbeat (``heartbeat``) that the
trainer and the SpGEMM serving gateway record into."""
