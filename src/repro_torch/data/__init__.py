"""Input pipelines: the SpGEMM value stream that feeds
``SpGEMMPlan.execute_stream`` (the LM token pipeline is not ported)."""
