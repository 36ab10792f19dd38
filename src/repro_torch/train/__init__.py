"""Training: AdamW and the train step (port of ``repro.train``)."""
