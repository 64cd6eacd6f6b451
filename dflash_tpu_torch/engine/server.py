"""Minimal HTTP serving surface over the continuous batching engine.  Port
of ``dflash_tpu/engine/server.py``, with the same routes and bodies.

SGLang's endpoints: POST ``/generate`` with ``{"input_ids" | "text",
"stream"?, "sampling_params": {"max_new_tokens", "temperature", "top_k",
"top_p", "stop", "seed"}}`` returning ``{"output_ids", "text", "meta_info":
{prompt_tokens, completion_tokens, spec_verify_ct, spec_accept_length,
e2e_latency_s, finish_reason}}``; a list body fans out across lanes and
returns a list; ``"stream": true`` returns server-sent events (``data:
{...}`` per serviced window with the cumulative output, then ``data:
[DONE]``).  POST ``/flush_cache`` and ``/abort_request``; GET ``/health``,
``/health_generate``, ``/v1/models`` and ``/get_model_info``.  The
OpenAI-compatible ``/v1/chat/completions`` and ``/v1/completions``
(non-stream and SSE deltas, ``n`` = 1 only).

Stdlib ``ThreadingHTTPServer``: the engine's loop thread alone touches the
device; handler threads only enqueue and wait on completion events.

    python -m dflash_tpu_torch.engine.server --model-name-or-path qwen3-8b --num-lanes 8
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from dflash_tpu_torch.engine.batching import ContinuousBatchingEngine


def stable_prefix(text: str, stop_strings=()) -> str:
    """The prefix of a cumulative decode that is safe to ship as an SSE
    *delta* (clients concatenate deltas; shipped text can never be revised):

    * trailing U+FFFD is held back — with byte-level BPE a multibyte char
      split across tokens decodes to a replacement char first ("a\\ufffd")
      and to the real char ("a好") once the next token lands;
    * a trailing proper prefix of any stop string is held back — if the rest
      of the stop arrives next window the final text is truncated BEFORE the
      match, so those chars must never have been shipped.

    Both hold-backs resolve at the final (finished) chunk, which ships the
    remainder as-is.  The incremental-detokenization approach of
    SGLang/vLLM (ADVICE r2)."""
    while text.endswith("�"):
        text = text[:-1]
    hold = 0
    for s in stop_strings:
        for k in range(min(len(s) - 1, len(text)), 0, -1):
            if text.endswith(s[:k]):
                hold = max(hold, k)
                break
    return text[:-hold] if hold else text


class EngineHTTPServer:
    # class-level default so partially-constructed servers (tests build one
    # via __new__ to drive handlers without a socket) still resolve it
    request_timeout_s: float = 1800.0

    def __init__(self, engine: ContinuousBatchingEngine, host: str = "127.0.0.1",
                 port: int = 30000, tokenizer=None, model_name: str = "dflash-tpu-torch",
                 request_timeout_s: float = 1800.0):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        # per-request wait bound before the server aborts the lane and
        # answers 400
        self.request_timeout_s = request_timeout_s
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (the stdlib's handler names)
                if self.path in ("/health", "/health_generate"):
                    self._send(200, {"status": "ok"})
                elif self.path == "/v1/models":  # OpenAI model discovery
                    self._send(200, {"object": "list", "data": [{
                        "id": outer.model_name, "object": "model",
                        "owned_by": "dflash_tpu_torch",
                    }]})
                elif self.path == "/get_model_info":  # SGLang discovery
                    self._send(200, {
                        "model_path": outer.model_name,
                        "is_generation": True,
                    })
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):  # noqa: N802
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n) if n else b"{}"
                try:
                    payload = json.loads(raw or b"{}")
                except json.JSONDecodeError:
                    self._send(400, {"error": "invalid json"})
                    return
                if self.path == "/flush_cache":
                    try:
                        outer.engine.flush()
                        self._send(200, {"status": "ok"})
                    except RuntimeError as e:
                        self._send(409, {"error": str(e)})
                    return
                if self.path == "/abort_request":
                    # client-disconnect path: streaming chunks carry "rid"
                    rid = payload.get("rid")
                    if rid is None:
                        self._send(400, {"error": "need rid"})
                    else:
                        self._send(200, {"aborted": outer.engine.abort(int(rid))})
                    return
                if self.path in ("/v1/chat/completions", "/v1/completions"):
                    try:
                        outer._openai(payload, self,
                                      is_chat=self.path.endswith("chat/completions"))
                    except ValueError as e:
                        self._send(400, {"error": {"message": str(e),
                                                   "type": "invalid_request_error"}})
                    return
                if self.path != "/generate":
                    self._send(404, {"error": "not found"})
                    return
                try:
                    if isinstance(payload, list):
                        self._send(200, [outer._generate(p) for p in payload])
                    elif payload.get("stream"):
                        outer._generate_stream(payload, self)
                    else:
                        self._send(200, outer._generate(payload))
                except ValueError as e:
                    self._send(400, {"error": str(e)})

        class _Server(ThreadingHTTPServer):
            # the stdlib's listen backlog of 5 overflows under a burst of
            # concurrent clients that all reconnect at a window boundary
            # while the accept thread waits on the GIL; the kernel then
            # resets the overflow
            request_queue_size = 128
            daemon_threads = True

        self._httpd = _Server((host, port), Handler)
        self.host, self.port = host, self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def _submit(self, payload: dict, stream: bool = False):
        sp = payload.get("sampling_params", {}) or {}
        if "input_ids" in payload:
            ids = np.asarray(payload["input_ids"], np.int32)
        elif "text" in payload and self.tokenizer is not None:
            ids = np.asarray(self.tokenizer.encode(payload["text"]), np.int32)
        else:
            raise ValueError("need input_ids (or text with a tokenizer)")
        seed = sp.get("seed")
        return self.engine.submit(
            ids,
            max_new_tokens=sp.get("max_new_tokens"),
            temperature=sp.get("temperature"),
            top_k=int(sp.get("top_k", 0) or 0),
            top_p=float(sp.get("top_p", 1.0)),
            stop=sp.get("stop"),
            stream=stream,
            seed=None if seed is None else int(seed),
        )

    def _decode_text(self, ids, meta_info: dict, stop_strings=()) -> str:
        """Decode + user-visible stop-string trim (the matched stop string is
        excluded from the text, SGLang's default).  ``stop_strings`` lets
        streaming chunks trim BEFORE the engine's finish_reason lands, so
        cumulative streamed text never shows a stop string and then shrinks."""
        text = self.tokenizer.decode(ids, skip_special_tokens=True)
        fr = (meta_info or {}).get("finish_reason") or {}
        matched = fr.get("matched")
        cuts = [text.index(s) for s in (*stop_strings, *([matched] if matched else ()))
                if s and s in text]
        if cuts:
            text = text[: min(cuts)]
        return text

    def _generate(self, payload: dict) -> dict:
        req = self._submit(payload)
        if not req.done_event.wait(timeout=self.request_timeout_s):
            self.engine.abort(req.rid)  # free the lane, don't just walk away
            raise ValueError("generation timed out")
        if req.error is not None:
            # per-request failure: surfaced in the response, engine keeps
            # serving the other lanes
            return {"error": req.error, "meta_info": req.meta_info}
        out = req.output_ids[0, req.meta_info["prompt_tokens"]:]
        result = {
            "output_ids": out.tolist(),
            "meta_info": req.meta_info,
        }
        if self.tokenizer is not None:
            result["text"] = self._decode_text(out, req.meta_info)
        return result

    def _generate_stream(self, payload: dict, handler) -> None:
        """SSE stream: one ``data: {...}`` event per engine scheduling window
        with the cumulative output (SGLang's streaming /generate shape),
        terminated by ``data: [DONE]``."""
        sp = payload.get("sampling_params", {}) or {}
        stop = sp.get("stop")
        stop_strings = (stop,) if isinstance(stop, str) else tuple(stop or ())
        req = self._submit(payload, stream=True)
        handler.send_response(200)
        handler.send_header("Content-Type", "text/event-stream")
        handler.send_header("Cache-Control", "no-cache")
        handler.send_header("Connection", "close")
        handler.end_headers()
        acc: list = []
        finished = False
        # A consumer that goes away must free its lane: client disconnect
        # raises BrokenPipeError/OSError mid-write, an engine stall raises
        # queue.Empty — in both cases abort the request instead of letting
        # the lane generate to max_new_tokens for nobody.
        try:
            while True:
                item = req.stream_queue.get(timeout=self.request_timeout_s)
                acc.extend(item["token_ids"])
                meta = item.get("meta_info") or {"completion_tokens": len(acc)}
                # rid lets a streaming client POST /abort_request on disconnect
                chunk = {"rid": req.rid, "output_ids": list(acc), "meta_info": meta}
                if req.error is not None:
                    chunk["error"] = req.error
                elif self.tokenizer is not None:
                    chunk["text"] = self._decode_text(
                        np.asarray(acc, np.int64), meta, stop_strings
                    )
                finished = item["finished"]
                handler.wfile.write(f"data: {json.dumps(chunk)}\n\n".encode())
                handler.wfile.flush()
                if finished:
                    break
            handler.wfile.write(b"data: [DONE]\n\n")
            handler.wfile.flush()
        except (queue.Empty, OSError):
            pass
        finally:
            if not finished:
                self.engine.abort(req.rid)

    # -- OpenAI-compatible surface ------------------------------------------
    # /v1/chat/completions and /v1/completions (the API SGLang exposes for
    # the reference's serving stack): chat messages run through the
    # tokenizer's chat template; stream=true emits chat.completion.chunk SSE
    # deltas.  Single-choice (n=1) only.

    def _openai(self, payload: dict, handler, *, is_chat: bool) -> None:
        if self.tokenizer is None:
            raise ValueError("OpenAI endpoints need a tokenizer")
        if payload.get("n", 1) != 1:
            raise ValueError("only n=1 is supported")
        if is_chat:
            messages = payload.get("messages")
            if not messages:
                raise ValueError("messages is required")
            text = self.tokenizer.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True
            )
        else:
            text = payload.get("prompt")
            if not isinstance(text, str):
                raise ValueError("prompt must be a string")
        stop = payload.get("stop")
        stop_strings = (stop,) if isinstance(stop, str) else tuple(stop or ())
        stream = bool(payload.get("stream", False))
        req = self.engine.submit(
            np.asarray(self.tokenizer.encode(text), np.int32),
            max_new_tokens=payload.get("max_tokens")
            or payload.get("max_completion_tokens"),
            temperature=float(payload.get("temperature", 1.0)),
            top_k=int(payload.get("top_k", 0) or 0),
            top_p=float(payload.get("top_p", 1.0)),
            stop=stop_strings or None,
            stream=stream,
        )
        rid = f"{'chatcmpl' if is_chat else 'cmpl'}-{req.rid}"
        created = int(time.time())
        obj = "chat.completion" if is_chat else "text_completion"

        def finish_of(meta) -> str:
            fr = (meta or {}).get("finish_reason") or {}
            return "stop" if fr.get("type") == "stop" else "length"

        if not stream:
            if not req.done_event.wait(timeout=self.request_timeout_s):
                raise ValueError("generation timed out")
            if req.error is not None:
                handler._send(500, {"error": {"message": req.error,
                                              "type": "engine_error"}})
                return
            out = req.output_ids[0, req.meta_info["prompt_tokens"]:]
            content = self._decode_text(out, req.meta_info, stop_strings)
            choice = {"index": 0, "finish_reason": finish_of(req.meta_info)}
            if is_chat:
                choice["message"] = {"role": "assistant", "content": content}
            else:
                choice["text"] = content
            handler._send(200, {
                "id": rid, "object": obj, "created": created,
                "model": self.model_name, "choices": [choice],
                "usage": {
                    "prompt_tokens": req.meta_info["prompt_tokens"],
                    "completion_tokens": req.meta_info["completion_tokens"],
                    "total_tokens": req.meta_info["prompt_tokens"]
                    + req.meta_info["completion_tokens"],
                },
            })
            return

        handler.send_response(200)
        handler.send_header("Content-Type", "text/event-stream")
        handler.send_header("Cache-Control", "no-cache")
        handler.send_header("Connection", "close")
        handler.end_headers()
        acc: list = []
        prev_text = ""
        first = True
        fin = False
        chunk_obj = "chat.completion.chunk" if is_chat else obj
        try:
            while True:
                item = req.stream_queue.get(timeout=self.request_timeout_s)
                acc.extend(item["token_ids"])
                meta = item.get("meta_info")
                cum = self._decode_text(np.asarray(acc, np.int64), meta, stop_strings)
                fin = item["finished"]
                # OpenAI chunks are DELTAS (clients concatenate): only the
                # stable prefix ships — trailing replacement chars and partial
                # stop-string suffixes are held back until resolved (the final
                # chunk ships whatever remains).
                stable = cum if fin else stable_prefix(cum, stop_strings)
                delta = stable[len(prev_text):]
                prev_text = stable
                choice = {"index": 0,
                          "finish_reason": finish_of(meta) if fin else None}
                if is_chat:
                    delta_obj = {}
                    if first:
                        delta_obj["role"] = "assistant"
                        first = False
                    if delta:
                        delta_obj["content"] = delta
                    choice["delta"] = delta_obj
                else:
                    choice["text"] = delta
                chunk = {"id": rid, "object": chunk_obj,
                         "created": created, "model": self.model_name,
                         "choices": [choice]}
                handler.wfile.write(f"data: {json.dumps(chunk)}\n\n".encode())
                handler.wfile.flush()
                if fin:
                    break
            handler.wfile.write(b"data: [DONE]\n\n")
            handler.wfile.flush()
        except (queue.Empty, OSError):
            pass
        finally:
            if not fin:
                self.engine.abort(req.rid)

    def start(self) -> None:
        self.engine.start()
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self.engine.stop()
        if self._thread is not None:
            self._thread.join(timeout=10)


def main(argv=None) -> None:
    """python -m dflash_tpu_torch.engine.server --model-name-or-path tiny --device cpu ...

    The JAX server's flags plus ``--device`` (default ``cuda``; raises
    without a card unless ``--device cpu``)."""
    import argparse
    from pathlib import Path

    import torch

    p = argparse.ArgumentParser(description="dflash_tpu_torch serving engine")
    p.add_argument("--model-name-or-path", default="tiny")
    p.add_argument("--draft-name-or-path", default="auto:1")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=30000)
    p.add_argument("--num-lanes", type=int, default=4)
    p.add_argument("--max-new-tokens", type=int, default=256)
    p.add_argument("--prompt-cap", type=int, default=512)
    p.add_argument("--block-size", type=int, default=None)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--quant", default="", choices=["", "int8"])
    p.add_argument("--kv-quant", action="store_true", help="int8 KV cache")
    p.add_argument("--sampling-filters", action="store_true",
                   help="enable per-request top_k/top_p (one filtered-sampler call per cycle)")
    p.add_argument("--topk-pool", type=int, default=64,
                   help="the filtered sampler's candidate pool: exact for any top_k <= pool; "
                        "wider requests are refused, never silently clamped")
    p.add_argument("--prefix-cache-mb", type=int, default=0, help="not ported: raises when set")
    p.add_argument("--stream-interval", type=int, default=4,
                   help="service cadence for streaming/stop lanes (windows between output reads)")
    p.add_argument("--admission-chunk", type=int, default=None, help="not ported: raises when set")
    p.add_argument("--buckets", default=None,
                   help="total_len ladder: comma list of prompt_cap:max_new:lanes rungs, "
                        "e.g. 256:128:8,1024:512:4 (BucketedEngine)")
    args = p.parse_args(argv)

    from dflash_tpu_torch.bench.cli import _resolve_models
    from dflash_tpu_torch.bench.tokenizer import resolve_tokenizer
    from dflash_tpu_torch.engine.batching import BucketedEngine, BucketSpec, EngineConfig

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device; pass --device cpu to serve on the CPU")
    for flag, on in (("--prefix-cache-mb", args.prefix_cache_mb > 0),
                     ("--admission-chunk", args.admission_chunk is not None)):
        if on:
            raise NotImplementedError(f"{flag} is not ported to dflash_tpu_torch yet "
                                      "(ROADMAP.md Queue 1, item 'Serving, the rest')")
    tcfg, dcfg, t_params, d_params = _resolve_models(args)  # honors --quant and --device
    tokenizer = resolve_tokenizer(
        args.model_name_or_path if Path(args.model_name_or_path).exists() else None, tcfg.vocab_size)
    cfg = EngineConfig(
        num_lanes=args.num_lanes,
        max_new_tokens=args.max_new_tokens,
        block_size=args.block_size or dcfg.block_size,
        prompt_cap=args.prompt_cap,
        stop_token_ids=(tokenizer.eos_token_id,) if tokenizer.eos_token_id is not None else (),
        kv_quant=args.kv_quant,
        sampling_filters=args.sampling_filters,
        topk_pool=args.topk_pool,
        stream_interval=args.stream_interval,
    )
    if args.buckets:
        rungs = [BucketSpec(*(int(x) for x in rung.split(":"))) for rung in args.buckets.split(",")]
        engine = BucketedEngine(tcfg, dcfg, t_params, d_params, cfg, rungs, tokenizer=tokenizer,
                                device=args.device)
    else:
        engine = ContinuousBatchingEngine(tcfg, dcfg, t_params, d_params, cfg, tokenizer=tokenizer,
                                          device=args.device)
    server = EngineHTTPServer(engine, args.host, args.port, tokenizer, model_name=Path(args.model_name_or_path).name)
    server.start()
    print(f"serving on http://{server.host}:{server.port}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
