"""Paged serving: page pool, admission scheduler, engine."""
