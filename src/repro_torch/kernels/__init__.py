"""Hand-written CUDA kernels and their plain PyTorch versions.

``PLAIN_DEVICES``: tensors on these devices take a wrapper's plain version
and launch nothing (``cpu``; ``meta``, where a step is counted without
running it: ``launch.dryrun``). A CUDA tensor launches the kernel or raises.
"""
PLAIN_DEVICES = ("cpu", "meta")
