"""dflash_tpu_torch: the PyTorch / CUDA port of dflash_tpu for NVIDIA Hopper.

Imports torch and numpy only, never JAX or ``dflash_tpu``.  Entry points
(``init_params``, ``SpecEngine``, ``params_from_numpy``) run on the card
unless the caller passes ``device="cpu"``.
"""

from dflash_tpu_torch.spec.api import spec_generate
from dflash_tpu_torch.spec.engine import GenerationResult, SpecEngine

__all__ = ["GenerationResult", "SpecEngine", "spec_generate"]
