"""Input pipelines: the synthetic LM token batches that feed training and
the SpGEMM value stream that feeds ``SpGEMMPlan.execute_stream``."""
