"""Reference trees (as numpy arrays) -> the port's tensors.

The reference's ``lm_init`` params and ``paged_cache_init`` pools are nested
dicts/lists of arrays; the port keeps the very same tree and leaf layout
(stacked repeats included), so conversion is leaf by leaf. The caller turns
the reference's arrays into numpy first (``np.asarray``), so this module
needs neither JAX nor the reference package.

bf16 leaves arrive with the ``ml_dtypes`` bfloat16 dtype, which
``torch.from_numpy`` rejects: their bits cross as uint16 and are viewed back
as ``torch.bfloat16`` — exact, no rounding.
"""
from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(arr, device="cpu") -> torch.Tensor:
    a = np.array(arr)                            # own, writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, device="cpu"):
    """Map a reference param tree of numpy arrays to tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return tensor_from_numpy(tree, device)


def pool_from_jax(pool, device="cpu") -> list:
    """Map a reference paged cache tree (``paged_cache_init`` layout: a list
    of group trees) to tensors, e.g. to compare pools leaf by leaf."""
    return params_from_jax(list(pool), device)
