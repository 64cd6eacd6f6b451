"""Carry weights across from the JAX package.

:func:`params_from_numpy` turns the JAX package's parameter pytree, passed in
as numpy arrays (``jax.tree.map(np.asarray, params)``), into the port's dict
of tensors with the same keys and layouts, on a given device and dtype.  After
that both packages compute the same function.  bf16 arrays (numpy dtype
``bfloat16`` from ``ml_dtypes``) are carried bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # JAX hands out read-only views; torch wants its own memory
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree, device: str | torch.device = "cuda", dtype: Optional[torch.dtype] = None):
    """Nested dicts of numpy arrays -> the same dicts of tensors on ``device``
    (cast to ``dtype`` when given)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if not isinstance(tree, np.ndarray):
        raise TypeError(f"expected numpy arrays (int8 QTensor weights are not ported yet), got {type(tree)}")
    t = _tensor(tree)
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)
