"""Runnable examples of the port (``python -m repro_torch.examples.<name>``),
ports of the reference's ``examples/``."""
