"""dflash_tpu_torch stands alone: it imports neither JAX nor dflash_tpu, and
its entry points default to the card instead of quietly using the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dflash_tpu_torch.convert import params_from_numpy
from dflash_tpu_torch.core.config import tiny_draft_config, tiny_target_config
from dflash_tpu_torch.models import dflash_draft, qwen3
from dflash_tpu_torch.spec.engine import SpecEngine

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import sys
import dflash_tpu_torch, dflash_tpu_torch.convert, dflash_tpu_torch.kernels._build
import dflash_tpu_torch.kernels.prefill_flash, dflash_tpu_torch.kernels.verify_fused
import dflash_tpu_torch.kernels.matmul_q, dflash_tpu_torch.quant
import chip_smoke
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "dflash_tpu" or m.startswith("dflash_tpu."))
print("BAD", bad)
"""


def test_import_pulls_in_neither_jax_nor_dflash_tpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without CUDA")
    tcfg = tiny_target_config()
    dcfg = tiny_draft_config(tcfg, num_layers=1)
    t_params = qwen3.init_params(0, tcfg, torch.float32, device="cpu")
    d_params = dflash_draft.init_params(1, dcfg, torch.float32, device="cpu")
    with pytest.raises(RuntimeError):
        SpecEngine(tcfg, dcfg, t_params, d_params, max_new_tokens=4)
    with pytest.raises((RuntimeError, AssertionError)):
        qwen3.init_params(0, tcfg, torch.float32)
    with pytest.raises((RuntimeError, AssertionError)):
        params_from_numpy({"final_norm": np.ones(4, np.float32)})
    engine = SpecEngine(tcfg, dcfg, t_params, d_params, max_new_tokens=4, device="cpu")
    assert engine.generate(np.asarray([[1, 2, 3]])).num_output_tokens >= 1
