"""device: the share of the traced span in which no operation ran on the
card (1 - the union of device intervals over the span)."""
from benchkit.readers import device_idle


def read(run):
    return device_idle(run)
