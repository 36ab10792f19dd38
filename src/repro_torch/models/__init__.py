"""Models: spec, layers, attention, blocks, lm."""
