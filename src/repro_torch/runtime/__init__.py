"""Step builders of the LM stack (serving: prefill and decode)."""
