"""PyTorch/CUDA port of ``repro``, module for module.

Plain tensor code is PyTorch; every kernel the reference wrote in Pallas for
the TPU is a hand-written CUDA kernel here (``repro_torch.kernels``). The
package imports neither JAX nor anything of ``repro``.
"""
