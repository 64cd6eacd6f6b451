"""Carry weights across from the JAX package.

:func:`params_from_numpy` turns the JAX package's parameter pytree, passed in
as numpy arrays (``jax.tree.map(np.asarray, params)``), into the port's dict
of tensors with the same keys and layouts, on a given device and dtype.  After
that both packages compute the same function.  bf16 arrays (numpy dtype
``bfloat16`` from ``ml_dtypes``) are carried bit for bit.  An int8 weight
node of the JAX pytree (its ``QTensor``, which ``jax.tree.map`` keeps, with
numpy ``q`` and ``scale`` inside) becomes the port's ``QTensor``: it is
recognised by its ``q`` / ``scale`` / ``n`` attributes, and its int8 values
and f32 scales keep their dtypes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dflash_tpu_torch.ops.linear import QTensor


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
    if all(hasattr(tree, a) for a in ("q", "scale", "n")):
        return QTensor(params_from_numpy(tree.q, device), params_from_numpy(tree.scale, device), tree.n)
    if not isinstance(tree, np.ndarray):
        raise TypeError(f"expected numpy arrays or int8 weight nodes, got {type(tree)}")
    t = _tensor(tree)
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)
