"""Fault tolerance, gradient compression, elastic restore and the GPipe
schedule (port of ``repro.runtime``)."""
