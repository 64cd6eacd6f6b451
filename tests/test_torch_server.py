"""dflash_tpu_torch's serving surface on the CPU: the HTTP server
(engine/server.py) on an ephemeral port over a tiny f32 engine, the serving
benchmark client (bench/serving.py), and the entry points' model and
tokenizer resolution (bench/cli.py, bench/tokenizer.py).

Every route of the JAX server answers, with the engine's tokens: greedy
``/generate`` equals ``SpecEngine.generate`` on the same weights, streamed
chunks reassemble to the non-streamed output, stop strings trim the text.
"""

import json
import os
import subprocess
import sys
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from dflash_tpu.bench.tokenizer import SyntheticTokenizer as JSyntheticTokenizer
from dflash_tpu_torch.bench import cli, serving
from dflash_tpu_torch.bench.tokenizer import SyntheticTokenizer, resolve_tokenizer
from dflash_tpu_torch.core.config import QWEN3_8B, tiny_draft_config, tiny_target_config
from dflash_tpu_torch.engine import ContinuousBatchingEngine, EngineConfig
from dflash_tpu_torch.engine import server as server_mod
from dflash_tpu_torch.engine.server import EngineHTTPServer, stable_prefix
from dflash_tpu_torch.models import dflash_draft, qwen3
from dflash_tpu_torch.spec.engine import SpecEngine

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(num_lanes=3, max_new_tokens=10, block_size=4, prompt_cap=32, prompt_bucket=16)


@pytest.fixture(scope="module")
def models():
    tcfg = tiny_target_config()
    dcfg = tiny_draft_config(tcfg, block_size=4, num_layers=1)
    return (tcfg, dcfg, qwen3.init_params(0, tcfg, torch.float32, device="cpu"),
            dflash_draft.init_params(1, dcfg, torch.float32, device="cpu"))


@pytest.fixture(scope="module")
def server(models):
    tcfg, dcfg, tp, dp = models
    tok = SyntheticTokenizer(tcfg.vocab_size)
    engine = ContinuousBatchingEngine(tcfg, dcfg, tp, dp, EngineConfig(**CFG, sampling_filters=True),
                                      tokenizer=tok, device="cpu")
    srv = EngineHTTPServer(engine, port=0, tokenizer=tok, request_timeout_s=120)
    srv.start()
    yield srv
    srv.stop()


def url(srv) -> str:
    return f"http://{srv.host}:{srv.port}"


def post(srv, path: str, body) -> dict:
    req = urllib.request.Request(url(srv) + path, json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def get(srv, path: str) -> dict:
    with urllib.request.urlopen(url(srv) + path, timeout=30) as r:
        return json.loads(r.read())


def sse(srv, path: str, body) -> list:
    req = urllib.request.Request(url(srv) + path, json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=120) as r:
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("data: "):
                events.append(line[6:])
    assert events[-1] == "[DONE]"
    return [json.loads(e) for e in events[:-1]]


def single_tokens(models, ids) -> np.ndarray:
    tcfg, dcfg, tp, dp = models
    eng = SpecEngine(tcfg, dcfg, tp, dp, max_new_tokens=CFG["max_new_tokens"], block_size=4,
                     prompt_cap=CFG["prompt_cap"], prompt_bucket=CFG["prompt_bucket"], device="cpu")
    return eng.generate(np.asarray(ids)[None]).output_ids[0, len(ids):]


IDS = [11, 42, 97, 300, 5, 77, 18]


def test_generate_ids_text_and_list_bodies(server, models):
    sp = {"max_new_tokens": 10, "temperature": 0}
    out = post(server, "/generate", {"input_ids": IDS, "sampling_params": sp})
    np.testing.assert_array_equal(out["output_ids"], single_tokens(models, IDS))
    meta = out["meta_info"]
    assert meta["prompt_tokens"] == len(IDS) and meta["completion_tokens"] == len(out["output_ids"])
    assert meta["spec_verify_ct"] >= 1 and meta["finish_reason"]["type"] in ("length", "stop")
    assert out["text"] == server.tokenizer.decode(out["output_ids"])
    text = "the quick brown fox jumps"
    by_text = post(server, "/generate", {"text": text, "sampling_params": sp})
    np.testing.assert_array_equal(by_text["output_ids"], single_tokens(models, server.tokenizer.encode(text)))
    both = post(server, "/generate", [{"input_ids": IDS, "sampling_params": sp},
                                      {"text": text, "sampling_params": sp}])
    assert [b["output_ids"] for b in both] == [out["output_ids"], by_text["output_ids"]]
    filtered = post(server, "/generate", {"input_ids": IDS, "sampling_params": {
        "max_new_tokens": 10, "temperature": 2.0, "top_k": 2, "top_p": 1e-6, "seed": 3}})
    assert filtered["output_ids"] == out["output_ids"]  # the keep set is the argmax alone


def test_generate_stream_reassembles(server):
    body = {"input_ids": IDS, "sampling_params": {"max_new_tokens": 10, "temperature": 0}}
    plain = post(server, "/generate", body)
    chunks = sse(server, "/generate", {**body, "stream": True})
    assert chunks[-1]["output_ids"] == plain["output_ids"]
    assert chunks[-1]["text"] == plain["text"]
    assert all(len(a["output_ids"]) <= len(b["output_ids"]) for a, b in zip(chunks, chunks[1:]))
    assert "rid" in chunks[0]


def test_stop_string_trims_the_text(server):
    sp = {"max_new_tokens": 10, "temperature": 0}
    full = post(server, "/generate", {"input_ids": IDS, "sampling_params": sp})
    stop = server.tokenizer.decode([full["output_ids"][3]])
    cut = post(server, "/generate", {"input_ids": IDS, "sampling_params": {**sp, "stop": stop}})
    assert cut["meta_info"]["finish_reason"] == {"type": "stop", "matched": stop}
    assert cut["text"] == full["text"][:full["text"].index(stop)]
    streamed = sse(server, "/generate", {"input_ids": IDS, "stream": True, "sampling_params": {**sp, "stop": stop}})
    assert streamed[-1]["text"] == cut["text"]
    assert stable_prefix("abc tok1", (" tok12",)) == "abc" and stable_prefix("ab�") == "ab"


def test_discovery_flush_and_abort_routes(server):
    assert get(server, "/health") == {"status": "ok"}
    assert get(server, "/health_generate") == {"status": "ok"}
    assert get(server, "/v1/models")["data"][0]["id"] == server.model_name
    assert get(server, "/get_model_info")["is_generation"] is True
    assert post(server, "/flush_cache", {}) == {"status": "ok"}
    assert post(server, "/abort_request", {"rid": 10 ** 6}) == {"aborted": False}
    for path, body in (("/nope", {}), ("/abort_request", {})):
        with pytest.raises(urllib.error.HTTPError) as e:
            post(server, path, body)
        assert e.value.code in (400, 404)


def test_chat_and_text_completions(server):
    messages = [{"role": "user", "content": "hello there"}]
    chat = post(server, "/v1/chat/completions", {"messages": messages, "max_tokens": 8, "temperature": 0})
    content = chat["choices"][0]["message"]["content"]
    assert chat["object"] == "chat.completion" and chat["usage"]["completion_tokens"] >= 1
    prompt = server.tokenizer.apply_chat_template(messages, tokenize=False, add_generation_prompt=True)
    gen = post(server, "/generate", {"text": prompt, "sampling_params": {"max_new_tokens": 8, "temperature": 0}})
    assert content == gen["text"]
    deltas = sse(server, "/v1/chat/completions", {"messages": messages, "max_tokens": 8, "temperature": 0,
                                                  "stream": True})
    assert deltas[0]["choices"][0]["delta"]["role"] == "assistant"
    assert "".join(d["choices"][0]["delta"].get("content", "") for d in deltas) == content
    assert deltas[-1]["choices"][0]["finish_reason"] in ("length", "stop")
    text = post(server, "/v1/completions", {"prompt": "once upon a time", "max_tokens": 8, "temperature": 0})
    pieces = sse(server, "/v1/completions", {"prompt": "once upon a time", "max_tokens": 8, "temperature": 0,
                                             "stream": True})
    assert "".join(p["choices"][0]["text"] for p in pieces) == text["choices"][0]["text"]
    with pytest.raises(urllib.error.HTTPError) as e:
        post(server, "/v1/chat/completions", {"messages": messages, "n": 2})
    assert e.value.code == 400


def test_bench_client_against_the_port_server(server):
    prompts = [list(np.random.default_rng(s).integers(10, 500, size=9)) for s in range(4)]
    prompts = [[int(t) for t in p] for p in prompts]
    m = serving.run_bench_requests(url(server), prompts, 2, 8)
    assert m.spec_verify_ct_sum > 0 and m.completion_tokens > 0 and m.n_requests == 4
    assert m.tokens_per_sec > 0 and m.mean_e2e_latency_s > 0
    streamed = serving.run_bench_requests(url(server), prompts[:2], 2, 8, stream=True)
    assert streamed.completion_tokens == sum(
        r["meta_info"]["completion_tokens"] for r in [serving._post(url(server), {
            "input_ids": p, "sampling_params": {"max_new_tokens": 8, "temperature": 0.0}}) for p in prompts[:2]])
    assert "| 2 | 4 |" in serving.markdown_report([m], "t")
    serving._flush(url(server))


def test_serving_main_in_process_on_the_cpu(capsys):
    serving.main(["--device", "cpu", "--dtype", "float32", "--num-lanes", "2", "--concurrencies", "1,2",
                  "--num-requests", "2", "--prompt-len", "8", "--max-new-tokens", "6", "--prompt-cap", "16"])
    out = capsys.readouterr().out
    assert "dflash_tpu_torch serving (tiny, cpu)" in out and out.count("\n| ") >= 3


@pytest.mark.parametrize("flag", [["--prefix-cache-mb", "8"], ["--shared-prefix-len", "130"],
                                  ["--prefill-ahead", "1"], ["--admission-chunk", "8"], ["--disagg"]])
def test_serving_main_refuses_what_is_not_ported(flag, capsys):
    """The admission flags that were refused before the port had them now
    run the sweep on the CPU (136-token prompts: one whole prompt bucket of
    prefix for the prefix cache and the prefill worker); the shared-prefix
    traffic with the prefix cache hits for every request after the first
    after each flush."""
    argv = ["--device", "cpu", "--dtype", "float32", "--num-lanes", "1", "--concurrencies", "2",
            "--num-requests", "3", "--prompt-len", "136", "--max-new-tokens", "4", "--prompt-cap", "256"] + flag
    if flag[0] == "--shared-prefix-len":
        argv += ["--prefix-cache-mb", "8"]
    serving.main(argv)
    out = capsys.readouterr()
    assert "dflash_tpu_torch serving (tiny, cpu)" in out.out and "| 2 | 3 |" in out.out
    if flag[0] == "--shared-prefix-len":
        # the warm-up's two requests (a miss, then a hit) and the sweep's three
        # after the flush that empties the cache (a miss, then two hits)
        assert "prefix cache: 3 hits, 2 misses" in out.err
    with pytest.raises(SystemExit):
        serving.main(["--device", "cpu", "--prompt-len", "8", "--shared-prefix-len", "8"])


def test_server_main_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server_mod.main(["--model-name-or-path", "tiny"])
    # the prefix cache and chunked admission flags (refused before they
    # were ported) serve too
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "dflash_tpu_torch.engine.server", "--device", "cpu", "--dtype", "float32",
         "--port", "0", "--num-lanes", "2", "--max-new-tokens", "6", "--prompt-cap", "32",
         "--prefix-cache-mb", "8", "--admission-chunk", "4"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://"), (line, proc.stderr.read() if proc.poll() is not None else "")
        base = line.split()[-1]
        body = json.dumps({"input_ids": IDS, "sampling_params": {"max_new_tokens": 6}}).encode()
        with urllib.request.urlopen(urllib.request.Request(base + "/generate", body), timeout=60) as r:
            assert 1 <= len(json.loads(r.read())["output_ids"]) <= 6
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_resolve_models_presets_and_what_raises(tmp_path):
    args = types.SimpleNamespace(model_name_or_path="tiny", draft_name_or_path="auto:2", dtype="float32",
                                 quant="", device="cpu")
    tcfg, dcfg, tp, dp = cli._resolve_models(args)
    assert tcfg == tiny_target_config(num_key_value_heads=2) and dcfg.model.num_hidden_layers == 2
    assert dcfg.block_size == 16 and tp["embed"].dtype == torch.float32 and tp["embed"].device.type == "cpu"
    torch.testing.assert_close(tp["embed"], qwen3.init_params(0, tcfg, torch.float32, device="cpu")["embed"])
    int8 = cli._resolve_models(types.SimpleNamespace(**{**vars(args), "quant": "int8"}))
    assert type(int8[2]["lm_head"]).__name__ == "QTensor" and type(int8[3]["fc"]).__name__ == "QTensor"
    assert cli.PRESETS["qwen3-8b"] == QWEN3_8B
    for name in ("qwen3-30b-a3b", "qwen3-30b-a3b-l4"):
        with pytest.raises(NotImplementedError, match="MoE"):
            cli._resolve_models(types.SimpleNamespace(**{**vars(args), "model_name_or_path": name}))
    (tmp_path / "config.json").write_text("{}")
    with pytest.raises(NotImplementedError, match="Loader"):
        cli._resolve_models(types.SimpleNamespace(**{**vars(args), "model_name_or_path": str(tmp_path)}))
    with pytest.raises(NotImplementedError, match="Loader"):
        cli._resolve_models(types.SimpleNamespace(**{**vars(args), "draft_name_or_path": str(tmp_path)}))
    with pytest.raises(SystemExit):
        cli._resolve_models(types.SimpleNamespace(**{**vars(args), "model_name_or_path": "nope"}))


def test_synthetic_tokenizer_matches_dflash_tpu(tmp_path):
    ours, ref = SyntheticTokenizer(151_936), JSyntheticTokenizer(151_936)
    text = "Hello, wörld!  the quick\tbrown fox"
    assert ours.encode(text) == ref.encode(text) and ours.encode("") == ref.encode("") == [11]
    assert ours.decode([5, 12345]) == ref.decode([5, 12345])
    messages = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hi"}]
    assert ours.apply_chat_template(messages) == ref.apply_chat_template(messages)
    assert isinstance(resolve_tokenizer(str(tmp_path), 100), SyntheticTokenizer)
    assert resolve_tokenizer(None, 100).vocab_size == 100
