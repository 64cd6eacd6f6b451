from dflash_tpu_torch.spec.api import spec_generate
from dflash_tpu_torch.spec.engine import GenerationResult, SpecEngine

__all__ = ["GenerationResult", "SpecEngine", "spec_generate"]
