"""Fault tolerance and gradient compression (port of ``repro.runtime``)."""
