"""One-call user API: ``spec_generate``.  Port of ``dflash_tpu/spec/api.py``."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from dflash_tpu_torch.core.config import DraftConfig, ModelConfig
from dflash_tpu_torch.spec.engine import GenerationResult, SpecEngine, _round_up


def spec_generate(
    t_params: dict,
    d_params: dict,
    tcfg: ModelConfig,
    dcfg: DraftConfig,
    input_ids: np.ndarray,
    max_new_tokens: int,
    stop_token_ids: Sequence[int] = (),
    temperature: float = 0.0,
    *,
    block_size: Optional[int] = None,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> GenerationResult:
    """Speculative generation for one prompt through a transient
    :class:`SpecEngine`.  ``block_size`` defaults to ``dcfg.block_size``."""
    input_ids = np.asarray(input_ids)
    if input_ids.ndim == 1:
        input_ids = input_ids[None, :]
    engine = SpecEngine(
        tcfg, dcfg, t_params, d_params,
        max_new_tokens=max_new_tokens,
        block_size=block_size,
        prompt_cap=_round_up(max(input_ids.shape[1], 1), 128),
        prompt_bucket=128,
        stop_token_ids=stop_token_ids,
        device=device,
    )
    return engine.generate(input_ids, temperature=temperature, seed=seed)
