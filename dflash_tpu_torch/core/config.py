"""Model / draft configuration dataclasses (copy of ``dflash_tpu.core.config``).

The port keeps its own copy: importing any ``dflash_tpu`` module runs that
package's ``__init__``, which imports JAX.  Field names, defaults and presets
are identical, so a config built here describes the same model as the JAX
package's.  HF ``config.json`` parsing arrives with the checkpoint loader.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


def build_target_layer_ids(num_target_layers: int, num_draft_layers: int) -> Tuple[int, ...]:
    """Which target layers feed the drafter.

    A single-layer draft taps the target's middle layer; otherwise taps are
    evenly spaced over ``[1, num_target_layers - 3]``.
    """
    if num_draft_layers == 1:
        return (num_target_layers // 2,)
    start = 1
    end = num_target_layers - 3
    span = end - start
    return tuple(
        int(round(start + (i * span) / (num_draft_layers - 1)))
        for i in range(num_draft_layers)
    )


@dataclass(frozen=True)
class ModelConfig:
    """Architecture config for a (Qwen3/Llama-family) transformer LM."""

    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    head_dim: int
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    # Qwen3 applies per-head RMSNorm to q/k; Llama does not.
    use_qk_norm: bool = True
    # MoE (Qwen3-Coder-30B-A3B style). num_experts == 0 means dense MLP.
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    norm_topk_prob: bool = True
    # Llama-3.1 rope scaling: (factor, low_freq_factor, high_freq_factor,
    # original_max_position_embeddings); None = plain RoPE.
    rope_scaling: Optional[Tuple[float, float, float, int]] = None

    @property
    def num_kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class DraftConfig:
    """DFlash draft model config: a small non-causal Qwen3-style stack whose
    context K/V are projections of the target's tap-layer features."""

    model: ModelConfig
    block_size: int
    mask_token_id: int
    target_layer_ids: Tuple[int, ...]

    @property
    def num_taps(self) -> int:
        return len(self.target_layer_ids)


def _tiny(overrides: dict | None = None, **kw) -> ModelConfig:
    base = dict(
        vocab_size=512,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=4,
        num_attention_heads=4,
        num_key_value_heads=2,
        head_dim=16,
        rope_theta=10_000.0,
    )
    base.update(overrides or {})
    base.update(kw)
    return ModelConfig(**base)


def tiny_target_config(**kw) -> ModelConfig:
    """A tiny random-weight target used by unit/parity tests."""
    return _tiny(**kw)


def tiny_draft_config(target: ModelConfig, block_size: int = 8, num_layers: int = 2, **kw) -> DraftConfig:
    # Draft decoder layers are always dense, even for MoE targets.
    model = dataclasses.replace(
        target,
        num_hidden_layers=num_layers,
        num_experts=0,
        num_experts_per_tok=0,
        moe_intermediate_size=0,
        **kw,
    )
    return DraftConfig(
        model=model,
        block_size=block_size,
        mask_token_id=target.vocab_size - 1,
        target_layer_ids=build_target_layer_ids(target.num_hidden_layers, num_layers),
    )


# ---------------------------------------------------------------------------
# Model-family presets (shapes from the public HF configs).
# ---------------------------------------------------------------------------

QWEN3_4B = ModelConfig(
    vocab_size=151_936,
    hidden_size=2560,
    intermediate_size=9728,
    num_hidden_layers=36,
    num_attention_heads=32,
    num_key_value_heads=8,
    head_dim=128,
    tie_word_embeddings=True,
)

QWEN3_8B = ModelConfig(
    vocab_size=151_936,
    hidden_size=4096,
    intermediate_size=12288,
    num_hidden_layers=36,
    num_attention_heads=32,
    num_key_value_heads=8,
    head_dim=128,
)

QWEN3_CODER_30B_A3B = ModelConfig(
    vocab_size=151_936,
    hidden_size=2048,
    intermediate_size=6144,  # dense fallback size; MLP layers are MoE
    num_hidden_layers=48,
    num_attention_heads=32,
    num_key_value_heads=4,
    head_dim=128,
    num_experts=128,
    num_experts_per_tok=8,
    moe_intermediate_size=768,
)

LLAMA31_8B = ModelConfig(
    vocab_size=128_256,
    hidden_size=4096,
    intermediate_size=14336,
    num_hidden_layers=32,
    num_attention_heads=32,
    num_key_value_heads=8,
    head_dim=128,
    rms_norm_eps=1e-5,
    rope_theta=500_000.0,
    use_qk_norm=False,
    rope_scaling=(8.0, 1.0, 4.0, 8192),
)


def dflash_draft_config(
    target: ModelConfig,
    num_draft_layers: int = 1,
    block_size: int = 16,
    mask_token_id: int = 151_669,
    target_layer_ids: Optional[Tuple[int, ...]] = None,
) -> DraftConfig:
    """DFlash draft config for a given target (z-lab checkpoint style).  The
    draft is always dense; for an MoE target its MLP width falls back to
    ``target.intermediate_size``."""
    model = dataclasses.replace(
        target, num_hidden_layers=num_draft_layers,
        num_experts=0, num_experts_per_tok=0, moe_intermediate_size=0,
    )
    if target_layer_ids is None:
        target_layer_ids = build_target_layer_ids(target.num_hidden_layers, num_draft_layers)
    return DraftConfig(
        model=model,
        block_size=block_size,
        mask_token_id=mask_token_id,
        target_layer_ids=tuple(target_layer_ids),
    )
