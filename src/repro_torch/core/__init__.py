"""Telemetry records shared by the serving engine."""
