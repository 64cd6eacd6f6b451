"""Weight-only int8 quantization of parameter dicts.  Port of the dense
branches of ``dflash_tpu/quant/quantize.py``.

Per-output-channel symmetric int8 with f32 scales: activations stay in their
dtype and every projection goes through ``kernels/matmul_q.py``.  Norm
weights and the embedding table stay as they are (the embedding is a gather,
not a matmul); a tied-embedding model gets a quantized ``lm_head`` copy so
the vocab projection still runs int8.  Quantization runs on the parameters'
own device, one layer at a time, so the f32 transient is one [K, N] matrix.

The MoE expert banks are not ported (they raise, as the port's other MoE
paths do).
"""

from __future__ import annotations

import torch

from dflash_tpu_torch.core.config import DraftConfig, ModelConfig
from dflash_tpu_torch.ops.linear import QTensor, quantize_weight

_MATMUL_KEYS = ("wq", "wk", "wv", "wo", "gate", "up", "down")


def _quantize_stacked(w: torch.Tensor, pad_to: int) -> QTensor:
    """Quantize per-layer-stacked [L, K, N] weights, per layer and channel."""
    L, K, N = w.shape
    first = quantize_weight(w[0], pad_to)
    q = torch.empty((L,) + tuple(first.q.shape), dtype=torch.int8, device=w.device)
    scale = torch.empty((L,) + tuple(first.scale.shape), dtype=torch.float32, device=w.device)
    q[0], scale[0] = first.q, first.scale
    for l in range(1, L):
        one = quantize_weight(w[l], pad_to)
        q[l], scale[l] = one.q, one.scale
    return QTensor(q, scale, N)


def _quantize_layers(layers: dict, cfg: ModelConfig, pad_to: int) -> dict:
    """Quantize the matmul weights of a layer-stack dict IN PLACE: each float
    stack is popped and released as soon as its int8 replacement exists, so
    the dict never holds two copies of a weight."""
    if cfg.is_moe:
        raise NotImplementedError("MoE expert quantization is not ported to dflash_tpu_torch yet")
    for key in _MATMUL_KEYS:
        if key not in layers:
            continue
        w = layers.pop(key)
        layers[key] = _quantize_stacked(w, pad_to)
        del w  # last reference to the float stack
    return layers


def quantize_target_params(params: dict, cfg: ModelConfig, pad_to: int = 512) -> dict:
    """Quantize a target param dict (CONSUMES the input: float weights are
    released as their int8 replacements are produced)."""
    params["layers"] = _quantize_layers(params["layers"], cfg, pad_to)
    if "lm_head" in params:
        w = params.pop("lm_head")
        params["lm_head"] = quantize_weight(w, pad_to)
        del w
    else:
        params["lm_head"] = quantize_weight(params["embed"].T, pad_to)
    return params


def quantize_draft_params(params: dict, cfg: DraftConfig, pad_to: int = 512) -> dict:
    """Quantize a draft param dict (consumes the input, see above)."""
    params["layers"] = _quantize_layers(params["layers"], cfg.model, pad_to)
    w = params.pop("fc")
    params["fc"] = quantize_weight(w, pad_to)
    del w
    return params


def init_params_quantized(seed: int, cfg: ModelConfig, pad_to: int = 512,
                          dtype=torch.bfloat16, device="cuda") -> dict:
    """Random target params drawn DIRECTLY in int8 from ``seed`` (the JAX
    function's distributions: uniform int8 bytes with -128 mapped to 0, scale
    0.02 * 2.5 / 127 on every column; normal * 0.02 embedding and ones for the
    norms, in ``dtype``), without ever holding the float weights.  The numbers
    differ from JAX's: the generators differ."""
    if cfg.is_moe:
        raise NotImplementedError("MoE expert quantization is not ported to dflash_tpu_torch yet")
    g = torch.Generator(device=device).manual_seed(seed)

    def q(shape) -> QTensor:
        K, N = shape[-2], shape[-1]
        Np = -(-N // pad_to) * pad_to if pad_to > 1 else N
        bits = torch.randint(0, 256, tuple(shape[:-1]) + (Np,), generator=g, dtype=torch.uint8, device=device)
        vals = bits.view(torch.int8)
        vals[vals == -128] = 0
        scale = torch.full(tuple(shape[:-2]) + (1, Np), 0.02 * 2.5 / 127.0, dtype=torch.float32, device=device)
        return QTensor(vals, scale, N)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    L, H, I = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    nh, nkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    layers = {
        "input_ln": ones(L, H),
        "post_ln": ones(L, H),
        "wq": q((L, H, nh * d)),
        "wk": q((L, H, nkv * d)),
        "wv": q((L, H, nkv * d)),
        "wo": q((L, nh * d, H)),
        "gate": q((L, H, I)),
        "up": q((L, H, I)),
        "down": q((L, I, H)),
    }
    if cfg.use_qk_norm:
        layers["q_norm"] = ones(L, d)
        layers["k_norm"] = ones(L, d)
    embed = (torch.randn((cfg.vocab_size, H), generator=g, dtype=torch.float32, device=device) * 0.02).to(dtype)
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": ones(H),
        "lm_head": q((H, cfg.vocab_size)),
    }
