"""Model resolution for the serving entry points.  Port of
``dflash_tpu/bench/cli.py::_resolve_models`` only: the rest of that CLI (the
benchmark modes, metric lines and traces) is ROADMAP.md Queue 1, item
"Serving, the rest".

A name resolves to a preset with random weights from fixed seeds (target 0,
draft 1), made on the caller's device: ``tiny``, ``qwen3-4b``, ``qwen3-8b``
and ``llama31-8b``, with the draft ``auto:N`` (an N-layer DFlash draft,
block 16).  ``--quant int8`` quantizes both through ``quant/quantize.py``;
the 8B presets draw their target weights directly in int8, as in JAX.
Checkpoint directories wait for the loader and the MoE presets for the MoE
target: both raise ``NotImplementedError``.
"""

from __future__ import annotations

import re
from pathlib import Path

import torch

from dflash_tpu_torch.core.config import (
    LLAMA31_8B,
    QWEN3_4B,
    QWEN3_8B,
    dflash_draft_config,
    tiny_draft_config,
    tiny_target_config,
)
from dflash_tpu_torch.models import dflash_draft, qwen3

PRESETS = {
    "tiny": tiny_target_config(num_key_value_heads=2),
    "qwen3-4b": QWEN3_4B,
    "qwen3-8b": QWEN3_8B,
    "llama31-8b": LLAMA31_8B,
}
# Presets whose float random init the JAX package avoids on a small card:
# with --quant int8 their target weights are drawn directly in int8.
_DIRECT_INT8 = ("qwen3-8b", "llama31-8b")
_MOE = re.compile(r"qwen3-30b-a3b(-l\d+)?")


def _not_ported_dir(path: Path) -> None:
    if path.joinpath("config.json").exists():
        raise NotImplementedError(
            f"{path}: loading a checkpoint directory is not ported to dflash_tpu_torch yet "
            "(ROADMAP.md Queue 1, item 'Loader')")


def _resolve_models(args):
    """(tcfg, dcfg, t_params, d_params) from ``args.model_name_or_path``,
    ``args.draft_name_or_path``, ``args.dtype`` ("bfloat16" | "float32"),
    ``args.quant`` ("" | "int8") and ``args.device`` (default "cuda")."""
    from dflash_tpu_torch.ops.linear import QTensor
    from dflash_tpu_torch.quant.quantize import (
        init_params_quantized,
        quantize_draft_params,
        quantize_target_params,
    )

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    device = getattr(args, "device", "cuda")
    quant = getattr(args, "quant", "") == "int8"
    name = args.model_name_or_path
    _not_ported_dir(Path(name))
    if _MOE.fullmatch(name):
        raise NotImplementedError(f"{name}: the MoE target is not ported to dflash_tpu_torch yet "
                                  "(ROADMAP.md Queue 1, item 'MoE target')")
    if name not in PRESETS:
        raise SystemExit(f"unknown model {name!r}; presets: {sorted(PRESETS)}")
    tcfg = PRESETS[name]
    if quant and name in _DIRECT_INT8:
        t_params = init_params_quantized(0, tcfg, dtype=dtype, device=device)
    else:
        t_params = qwen3.init_params(0, tcfg, dtype, device=device)

    draft = args.draft_name_or_path
    _not_ported_dir(Path(draft))
    if not draft.startswith("auto:"):
        raise SystemExit(f"unknown draft {draft!r}; use auto:<num_layers>")
    n_layers = int(draft.split(":", 1)[1])
    if name == "tiny":
        dcfg = tiny_draft_config(tcfg, block_size=16, num_layers=n_layers)
    else:
        dcfg = dflash_draft_config(tcfg, num_draft_layers=n_layers, block_size=16)
    d_params = dflash_draft.init_params(1, dcfg, dtype, device=device)
    if quant:
        if not isinstance(t_params.get("lm_head"), QTensor):
            t_params = quantize_target_params(t_params, tcfg)
        d_params = quantize_draft_params(d_params, dcfg)
    return tcfg, dcfg, t_params, d_params
