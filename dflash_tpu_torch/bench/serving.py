"""Serving benchmark: a concurrency sweep against the HTTP engine.  Port of
``dflash_tpu/bench/serving.py``.

Launches the port's server in process (or targets a running one with
``--url``), sweeps client concurrency, drives ``/generate`` from a thread
pool, collects ``meta_info`` (tokens, verify cycles, acceptance, end-to-end
latency), checks that speculation ran (``spec_verify_ct_sum > 0``) and
prints a markdown report.  Prompts are random token ids from a seed.

    python -m dflash_tpu_torch.bench.serving --model-name-or-path qwen3-8b --num-lanes 16
    python -m dflash_tpu_torch.bench.serving --device cpu --model-name-or-path tiny --dtype float32

The engine's admission routes take the JAX bench's flags:
``--prefix-cache-mb`` (with ``--shared-prefix-len`` traffic: every prompt
starts with one shared system-prompt prefix), ``--prefill-ahead``,
``--admission-chunk`` and ``--disagg`` (a prefill worker on card 1 when
there is one, else on the engine's card).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List


@dataclass
class BenchMetrics:
    concurrency: int
    n_requests: int
    wall_s: float
    completion_tokens: int
    spec_verify_ct_sum: int
    accept_lengths: List[float] = field(default_factory=list)
    e2e_latencies: List[float] = field(default_factory=list)  # seconds, per request (server side)

    @property
    def tokens_per_sec(self) -> float:
        return self.completion_tokens / max(self.wall_s, 1e-9)

    @property
    def mean_accept_length(self) -> float:
        xs = [a for a in self.accept_lengths if a > 0]
        return sum(xs) / len(xs) if xs else 0.0

    @property
    def mean_e2e_latency_s(self) -> float:
        return sum(self.e2e_latencies) / len(self.e2e_latencies) if self.e2e_latencies else 0.0


def _post(url: str, payload: dict, timeout: float = 1800.0) -> dict:
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _flush(url: str) -> None:
    """POST /flush_cache; a server that refuses (409: requests still active)
    is left as it is."""
    req = urllib.request.Request(url + "/flush_cache", data=b"{}", method="POST")
    try:
        urllib.request.urlopen(req, timeout=30).read()
    except urllib.error.HTTPError as e:
        if e.code != 409:
            raise


def _consume_sse(url: str, payload: dict) -> dict:
    """POST a streaming /generate and consume the SSE events; returns the
    final chunk's body (same shape as the non-stream response)."""
    req = urllib.request.Request(
        url + "/generate", json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    last = None
    with urllib.request.urlopen(req, timeout=1800) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if line.startswith("data: ") and line != "data: [DONE]":
                last = json.loads(line[6:])
    if last is None:
        raise RuntimeError("no SSE chunks received")
    return last


def run_bench_requests(
    url: str,
    prompts: List[List[int]],
    concurrency: int,
    max_new_tokens: int,
    temperature: float = 0.0,
    stream: bool = False,
    top_k: int = 0,
    top_p: float = 1.0,
) -> BenchMetrics:
    def one(ids):
        payload = {
            "input_ids": ids,
            "sampling_params": {
                "max_new_tokens": max_new_tokens,
                "temperature": temperature,
                "top_k": top_k,
                "top_p": top_p,
            },
        }
        if stream:
            payload["stream"] = True
            return _consume_sse(url, payload)
        return _post(url, payload)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=concurrency) as pool:
        results = list(pool.map(one, prompts))
    wall = time.perf_counter() - t0

    failed = [r["error"] for r in results if "error" in r]
    if failed:
        raise RuntimeError(f"{len(failed)} of {len(results)} requests failed: {failed[0]}")
    return BenchMetrics(
        concurrency=concurrency, n_requests=len(prompts), wall_s=wall,
        completion_tokens=sum(r["meta_info"]["completion_tokens"] for r in results),
        spec_verify_ct_sum=sum(r["meta_info"]["spec_verify_ct"] for r in results),
        accept_lengths=[r["meta_info"]["spec_accept_length"] for r in results],
        e2e_latencies=[r["meta_info"]["e2e_latency_s"] for r in results],
    )


def markdown_report(rows: List[BenchMetrics], title: str) -> str:
    lines = [
        f"## {title}",
        "",
        "| concurrency | requests | wall (s) | tokens/s | mean accept len | mean e2e latency (s) | verify ct |",
        "|---|---|---|---|---|---|---|",
    ]
    for m in rows:
        lines.append(
            f"| {m.concurrency} | {m.n_requests} | {m.wall_s:.2f} | "
            f"{m.tokens_per_sec:.1f} | {m.mean_accept_length:.2f} | {m.mean_e2e_latency_s:.3f} | "
            f"{m.spec_verify_ct_sum} |"
        )
    return "\n".join(lines)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Serving concurrency benchmark")
    p.add_argument("--url", default=None, help="Benchmark a running server; default launches in-process.")
    p.add_argument("--model-name-or-path", default="tiny")
    p.add_argument("--draft-name-or-path", default="auto:1")
    p.add_argument("--device", default="cuda", help="the in-process engine's device: cuda (default) or cpu")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--num-lanes", type=int, default=8)
    p.add_argument("--concurrencies", default="1,4,8")
    p.add_argument("--num-requests", type=int, default=16)
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--prompt-cap", type=int, default=128)
    p.add_argument("--block-size", type=int, default=None)
    p.add_argument("--quant", default="", choices=["", "int8"],
                   help="int8 weight-only quantization for the in-process engine")
    p.add_argument("--kv-quant", action="store_true", help="int8 KV cache")
    p.add_argument("--prefix-cache-mb", type=int, default=0, help="prompt-prefix cache budget; 0 disables")
    p.add_argument("--shared-prefix-len", type=int, default=0,
                   help="length of a system-prompt prefix shared by every request (the prefix cache's traffic)")
    p.add_argument("--steps-per-sync", type=int, default=4, help="decode cycles per scheduling window")
    p.add_argument("--emulate-tau", type=float, default=None,
                   help="benchmark-only acceptance override (mean tau)")
    p.add_argument("--report-path", default=None)
    p.add_argument("--stream", action="store_true",
                   help='drive /generate with "stream": true and consume the SSE events')
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0, help="per-request top_k (needs --sampling-filters)")
    p.add_argument("--top-p", type=float, default=1.0, help="per-request top_p (needs --sampling-filters)")
    p.add_argument("--sampling-filters", action="store_true",
                   help="build the engine with the exact filtered sampler")
    p.add_argument("--topk-pool", type=int, default=64)
    p.add_argument("--stream-interval", type=int, default=4,
                   help="engine service cadence for streaming/stop lanes")
    p.add_argument("--prefill-ahead", type=int, default=0,
                   help="stage up to N queued prefills while every lane is busy")
    p.add_argument("--admission-chunk", type=int, default=None,
                   help="chunk-interleaved admission prefill (tokens per chunk); unset: one prefill forward")
    p.add_argument("--disagg", action="store_true",
                   help="disaggregated prefill: long admissions' prefix forwards on a prefill worker on card 1 "
                        "(on the engine's card when there is one card) and handed to the engine")
    p.add_argument("--vocab-size", type=int, default=1000,
                   help="prompt-id range when benchmarking an external --url server")
    args = p.parse_args(argv)
    if args.shared_prefix_len >= args.prompt_len:
        raise SystemExit(f"--shared-prefix-len {args.shared_prefix_len} must be < --prompt-len {args.prompt_len} "
                         "(each request needs its own tail)")

    import numpy as np

    server = worker = engine = None
    url = args.url
    if url is None:
        import torch

        from dflash_tpu_torch.bench.cli import _resolve_models
        from dflash_tpu_torch.bench.tokenizer import SyntheticTokenizer
        from dflash_tpu_torch.engine import ContinuousBatchingEngine, EngineConfig, PrefillWorker
        from dflash_tpu_torch.engine.server import EngineHTTPServer

        device = torch.device(args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device; pass --device cpu to run on the CPU")
        tcfg, dcfg, t_params, d_params = _resolve_models(args)  # honors --quant and --device
        if args.disagg:
            # JAX's rule: the prefill role on the second card when there is
            # one, else beside the engine on its own card
            prefill = device
            if device.type == "cuda":
                device = torch.device("cuda", 0)
                prefill = torch.device("cuda", 1 if torch.cuda.device_count() > 1 else 0)
            worker = PrefillWorker(tcfg, dcfg, t_params, prefill_device=prefill, decode_device=device,
                                   kv_quant=args.kv_quant)
        engine = ContinuousBatchingEngine(
            tcfg, dcfg, t_params, d_params, prefill_worker=worker,
            cfg=EngineConfig(
                num_lanes=args.num_lanes,
                max_new_tokens=args.max_new_tokens,
                block_size=args.block_size or dcfg.block_size,
                prompt_cap=args.prompt_cap,
                kv_quant=args.kv_quant,
                steps_per_sync=args.steps_per_sync,
                emulate_tau=args.emulate_tau,
                stream_interval=args.stream_interval,
                temperature=args.temperature,
                sampling_filters=args.sampling_filters,
                topk_pool=args.topk_pool,
                prefix_cache_mb=args.prefix_cache_mb,
                admission_chunk=args.admission_chunk,
                prefill_ahead=args.prefill_ahead,
            ),
            device=device,
        )
        server = EngineHTTPServer(engine, port=0, tokenizer=SyntheticTokenizer(tcfg.vocab_size))
        server.start()
        url = f"http://{server.host}:{server.port}"
        vocab = tcfg.vocab_size
    else:
        vocab = args.vocab_size  # an external server's vocab: prompt ids must stay in range

    rng = np.random.default_rng(0)
    # a shared "system prompt" prefix and a tail of each request's own (the
    # chat-serving shape the prefix cache is for); the prompts are
    # prompt_len long either way
    shared = rng.integers(10, vocab - 10, size=(args.shared_prefix_len,)).tolist()
    prompts = [shared + rng.integers(10, vocab - 10, size=(args.prompt_len - args.shared_prefix_len,)).tolist()
               for _ in range(args.num_requests)]
    sampling = dict(temperature=args.temperature, stream=args.stream, top_k=args.top_k, top_p=args.top_p)
    rows = []
    try:
        run_bench_requests(url, prompts[:2], 2, args.max_new_tokens, **sampling)  # warm-up
        for conc in (int(c) for c in args.concurrencies.split(",")):
            _flush(url)
            m = run_bench_requests(url, prompts, conc, args.max_new_tokens, **sampling)
            if m.spec_verify_ct_sum <= 0:
                raise RuntimeError("speculative decoding did not run (verify_ct == 0)")
            print(f"[serving] conc={conc}: {m.tokens_per_sec:.1f} tok/s, accept_len={m.mean_accept_length:.2f}, "
                  f"mean e2e latency {m.mean_e2e_latency_s:.3f} s", file=sys.stderr, flush=True)
            rows.append(m)
    finally:
        if server is not None:
            server.stop()
        if worker is not None:
            worker.stop()
    cache = getattr(engine, "_prefix_cache", None)
    if cache is not None:
        print(f"[serving] prefix cache: {cache.hits} hits, {cache.misses} misses", file=sys.stderr, flush=True)

    report = markdown_report(rows, f"dflash_tpu_torch serving ({args.model_name_or_path}, {args.device})")
    print(report)
    if args.report_path:
        with open(args.report_path, "w") as f:
            f.write(report + "\n")


if __name__ == "__main__":
    main()
