"""Token sampling and the speculative acceptance rule.  Port of ``sample`` and
``acceptance_length`` in ``dflash_tpu/ops/sampling.py``.

Greedy (temperature < 1e-5) is argmax and matches JAX token for token.  The
sampled branch draws from softmax(logits / T) with an explicit
``torch.Generator``: the same distribution as ``jax.random.categorical``, not
the same tokens.  The top-k / top-p filters are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

GREEDY_TEMP_EPS = 1e-5


def sample(
    logits: torch.Tensor, temperature: float, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """Token ids [...] (int64) from ``logits`` [..., V]."""
    logits = logits.float()
    if temperature < GREEDY_TEMP_EPS:
        return logits.argmax(dim=-1)
    probs = torch.softmax(logits / max(temperature, GREEDY_TEMP_EPS), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator).reshape(probs.shape[:-1])


def acceptance_length(draft_tokens: torch.Tensor, posterior: torch.Tensor) -> torch.Tensor:
    """Longest accepted prefix length: ``draft_tokens`` [B, S-1] against
    ``posterior`` [B, S]; ``(draft == posterior[:, :-1]).cumprod(1).sum(1)``."""
    matches = (draft_tokens == posterior[..., :-1]).long()
    return torch.cumprod(matches, dim=-1).sum(dim=-1)
