#!/usr/bin/env python
"""Where the PyTorch/CUDA port's decode time goes on one NVIDIA GPU.

    python3 scripts/torch_profile_decode.py              # the bf16 path
    python3 scripts/torch_profile_decode.py --int8       # int8 weights + kv_quant
    python3 scripts/torch_profile_decode.py --pallas     # attn_impl="pallas"
    python3 scripts/torch_profile_decode.py --filtered   # spec at T 0.8, top_k 50, top_p 0.95

Builds the bf16 Qwen3-8B engine of chip_smoke.py (full width and depth,
random weights from a seed, 1-layer draft, a 600-token prompt padded to 640;
with ``--int8`` the weights quantized by the port and the int8 KV cache,
with ``--pallas`` the engine built with ``attn_impl="pallas"``), warms it
up, then for AR decode and spec decode (the random draft's own acceptance;
``--filtered``: spec decode only, sampled through the top-k / top-p filters)
prints one JSON line each with: the decode's wall ms per token
without the profiler (two runs); and, for one more decode under
torch.profiler (the prefill runs before the profiler starts), the device busy
share (union of kernel intervals over the profiled wall time), kernel
launches per token, and the kernels that take the most device time.  Needs a
card; imports no JAX.
"""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from dflash_tpu_torch.core.config import QWEN3_8B, dflash_draft_config  # noqa: E402
from dflash_tpu_torch.models import dflash_draft, qwen3  # noqa: E402
from dflash_tpu_torch.quant import quantize_draft_params, quantize_target_params  # noqa: E402
from dflash_tpu_torch.spec import engine as eng  # noqa: E402

NEW_TOKENS = 32


def busy_us(intervals: list) -> float:
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def measure(label: str, prefill, decode, run) -> dict:
    run()  # warm-up
    tpots = [run().time_per_output_token * 1e3 for _ in range(2)]
    state = prefill()
    start = state.start
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = decode(state)
        torch.cuda.synchronize()
        prof_wall_us = (time.perf_counter() - t0) * 1e6
    n_tok = state.start - start  # tokens committed by the profiled decode
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name] += e.time_range.end - e.time_range.start
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "path": label,
        "decode_wall_ms_per_token": tpots,
        "profiled_tokens": n_tok,
        "profiled_wall_ms_per_token": prof_wall_us / 1e3 / n_tok,
        "device_busy_ms_per_token": busy / 1e3 / n_tok,
        "device_busy_share": busy / prof_wall_us,
        "kernel_launches_per_token": len(kernels) / n_tok,
        "top_kernels_ms_per_token": {name[:80]: us / 1e3 / n_tok for name, us in top},
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profile_decode: no CUDA device", file=sys.stderr)
        return 1
    mode = next((a[2:] for a in sys.argv[1:] if a in ("--int8", "--pallas", "--filtered")), "bf16")
    int8 = mode == "int8"
    temperature, filters = (0.8, eng.SamplingFilters(50, 0.95)) if mode == "filtered" else (0.0, None)
    torch.backends.cuda.matmul.allow_tf32 = False
    dcfg = dflash_draft_config(QWEN3_8B, num_draft_layers=1, block_size=16)
    t_params = qwen3.init_params(0, QWEN3_8B, torch.bfloat16)
    d_params = dflash_draft.init_params(1, dcfg, torch.bfloat16)
    if int8:
        t_params = quantize_target_params(t_params, QWEN3_8B)
        d_params = quantize_draft_params(d_params, dcfg)
    e = eng.SpecEngine(
        QWEN3_8B, dcfg, t_params, d_params, max_new_tokens=NEW_TOKENS,
        block_size=16, prompt_cap=640, prompt_bucket=128, kv_quant=int8,
        attn_impl="pallas" if mode == "pallas" else "xla",
    )
    prompt = np.random.default_rng(0).integers(1, QWEN3_8B.vocab_size - 2, size=(1, 600))
    ids, plen, _ = e._pad_prompt(prompt)
    max_length = plen + NEW_TOKENS
    print(torch.cuda.get_device_name(0), f"{mode} path", flush=True)
    tag = "" if mode == "bf16" else "-" + mode
    if filters is None:  # ar_generate takes no filters
        ar = measure(
            "ar" + tag,
            lambda: eng._ar_prefill(e.t_params, ids, plen, 0.0, None, tcfg=e.tcfg,
                                    total_len=e.total_len, mask_token_id=dcfg.mask_token_id,
                                    kv_quant=int8),
            lambda st: eng._ar_decode(e.t_params, st, max_length, 0.0, tcfg=e.tcfg,
                                      stop_token_ids=frozenset(), attn_impl=e.attn_impl),
            lambda: e.ar_generate(prompt),
        )
        print(json.dumps(ar), flush=True)
    spec = measure(
        "spec" + tag,
        lambda: eng._prefill_impl(e.t_params, e.d_params, ids, plen, temperature,
                                  e._generator(temperature, 0), tcfg=e.tcfg, dcfg=dcfg,
                                  total_len=e.total_len, kv_quant=int8, filters=filters),
        lambda st: eng._decode_impl(e.t_params, e.d_params, st, max_length, temperature, tcfg=e.tcfg,
                                    dcfg=dcfg, block_size=16, stop_token_ids=frozenset(),
                                    max_cycles=NEW_TOKENS, attn_impl=e.attn_impl, filters=filters),
        lambda: e.generate(prompt, temperature=temperature, top_k=filters.top_k if filters else 0,
                           top_p=filters.top_p if filters else 1.0),
    )
    print(json.dumps(spec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
