"""Synthetic data (copy of ``repro.data``)."""
