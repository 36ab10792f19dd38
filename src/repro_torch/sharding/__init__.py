"""Logical-axis sharding rules (port of ``repro.sharding``)."""
