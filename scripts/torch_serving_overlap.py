#!/usr/bin/env python
"""Serving tok/s with the overlapped scheduler on and off, on one card.

    python scripts/torch_serving_overlap.py [--points none:16,7.46:4,7.46:16] [--reps 2]

Builds Qwen3-8B bf16 with random weights from seeds 0/1 (chip_smoke.py's
phase 5f configuration: 16 lanes, 128 new tokens, steps_per_sync 4, a
1-layer draft, block 16) once, then for each point tau:concurrency runs the
serving engine behind its HTTP server in turns, overlap on, off, off, on
(``--reps`` such quadruples), each turn on fresh distinct random 600-token
prompts, 2 x concurrency requests, through bench/serving.py's client.
Prints one JSON line per turn and one summary line per (tau, concurrency)
with the median tok/s of each mode; the last line names the card and its
power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dflash_tpu_torch.bench import serving  # noqa: E402
from dflash_tpu_torch.bench.tokenizer import SyntheticTokenizer  # noqa: E402
from dflash_tpu_torch.core.config import QWEN3_8B, dflash_draft_config  # noqa: E402
from dflash_tpu_torch.engine import ContinuousBatchingEngine, EngineConfig  # noqa: E402
from dflash_tpu_torch.engine.server import EngineHTTPServer  # noqa: E402
from dflash_tpu_torch.models import dflash_draft, qwen3  # noqa: E402

LANES, NEW, PROMPT_LEN, PROMPT_CAP, BLOCK = 16, 128, 600, 640, 16


def run_turn(params, overlap: bool, tau, conc: int, rng) -> dict:
    dcfg, t_params, d_params = params
    cfg = EngineConfig(num_lanes=LANES, max_new_tokens=NEW, block_size=BLOCK, prompt_cap=PROMPT_CAP,
                       steps_per_sync=4, emulate_tau=tau, overlap=overlap)
    engine = ContinuousBatchingEngine(QWEN3_8B, dcfg, t_params, d_params, cfg,
                                      tokenizer=SyntheticTokenizer(QWEN3_8B.vocab_size), device="cuda")
    srv = EngineHTTPServer(engine, host="127.0.0.1", port=0, tokenizer=engine.tokenizer)
    srv.start()
    try:
        url = f"http://{srv.host}:{srv.port}"
        fresh = lambda n: [rng.integers(10, QWEN3_8B.vocab_size - 10, size=PROMPT_LEN).tolist()  # noqa: E731
                           for _ in range(n)]
        serving.run_bench_requests(url, fresh(1), 1, 8)  # warm-up
        cycles0 = engine.cycle_count
        m = serving.run_bench_requests(url, fresh(2 * conc), conc, NEW)
        cycles = engine.cycle_count - cycles0
    finally:
        srv.stop()
    del engine, srv
    torch.cuda.empty_cache()
    return dict(overlap=overlap, tau_mode="own" if tau is None else f"forced {tau}", concurrency=conc,
                requests=m.n_requests, tok_s=m.tokens_per_sec, mean_e2e_latency_s=m.mean_e2e_latency_s,
                mean_accept_length=m.mean_accept_length, wall_s=m.wall_s, cycles=cycles)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--points", default="none:16,7.46:4,7.46:16", help="tau:concurrency pairs (tau none: own)")
    p.add_argument("--reps", type=int, default=2)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_serving_overlap: no CUDA device", file=sys.stderr)
        return 1
    dcfg = dflash_draft_config(QWEN3_8B, num_draft_layers=1, block_size=BLOCK)
    params = (dcfg, qwen3.init_params(0, QWEN3_8B, torch.bfloat16, device="cuda"),
              dflash_draft.init_params(1, dcfg, torch.bfloat16, device="cuda"))
    rng = np.random.default_rng(200)
    for point in args.points.split(","):
        t, c = point.split(":")
        tau, conc = None if t == "none" else float(t), int(c)
        rows = []
        for _ in range(args.reps):
            for overlap in (True, False, False, True):
                rows.append(run_turn(params, overlap, tau, conc, rng))
                print(json.dumps(rows[-1]), flush=True)
        med = {mode: float(np.median([r["tok_s"] for r in rows if r["overlap"] == mode])) for mode in (True, False)}
        print(json.dumps({"tau_mode": rows[0]["tau_mode"], "concurrency": conc, "median_tok_s_overlap": med[True],
                          "median_tok_s_sync": med[False],
                          "turns_overlap": [round(r["tok_s"], 1) for r in rows if r["overlap"]],
                          "turns_sync": [round(r["tok_s"], 1) for r in rows if not r["overlap"]]}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
