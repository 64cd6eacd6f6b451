from dflash_tpu_torch.quant.quantize import (
    init_params_quantized,
    quantize_draft_params,
    quantize_target_params,
)

__all__ = ["init_params_quantized", "quantize_target_params", "quantize_draft_params"]
