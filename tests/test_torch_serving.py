"""dflash_tpu_torch's continuous batching engine (engine/batching.py) and
per-lane top-k / top-p on the batched lanes, on the CPU.

The port's ``ContinuousBatchingEngine`` runs the same requests as
``dflash_tpu.engine.ContinuousBatchingEngine`` on the same f32 tiny weights
carried across by ``convert.params_from_numpy``: 5 requests on 3 lanes with
unequal prompts, staggered submissions and a stop token, float and int8
(``kv_quant``).  At temperature 0 the ``output_ids`` and the ``meta_info``
counts must be equal request by request; ``emulate_tau`` likewise.  The
per-lane [R] filters give JAX's keep masks exactly, and JAX's tokens where
each lane's keep set is its argmax.  The rest holds the engine's own
behaviour: overlap modes, aborts, streaming, stop strings, seeds, the bucket
ladder and the admission options (each route in detail:
tests/test_torch_admission.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dflash_tpu.core import config as jconfig
from dflash_tpu.engine import ContinuousBatchingEngine as JEngine
from dflash_tpu.engine import EngineConfig as JConfig
from dflash_tpu.models import dflash_draft as jdraft
from dflash_tpu.models import qwen3 as jqwen3
from dflash_tpu.ops import sampling as jsampling
from dflash_tpu.quant import quantize as jquant
from dflash_tpu.spec.batched import jit_batched_decode, jit_batched_prefill
from dflash_tpu.spec.engine import SamplingFilters as JFilters
from dflash_tpu_torch.bench.tokenizer import SyntheticTokenizer
from dflash_tpu_torch.convert import params_from_numpy
from dflash_tpu_torch.core import config as tconfig
from dflash_tpu_torch.engine import BucketedEngine, BucketSpec, ContinuousBatchingEngine, EngineConfig, PrefillWorker
from dflash_tpu_torch.engine.batching import request_seed
from dflash_tpu_torch.kernels import filter_stats as fs
from dflash_tpu_torch.ops import sampling
from dflash_tpu_torch.spec import batched as tb
from dflash_tpu_torch.spec.engine import SamplingFilters

torch.set_num_threads(2)

BLOCK = 4
ENGINE = dict(num_lanes=3, max_new_tokens=12, block_size=BLOCK, prompt_cap=32, prompt_bucket=16)
PROMPT_LENS = (5, 19, 9, 30, 3)

_MODELS = {}


def _models(int8: bool):
    """(JAX configs and params, port configs and params): f32 weights, or
    int8 weights quantized by the JAX package and carried across."""
    if int8 not in _MODELS:
        jt = jconfig.tiny_target_config()
        jd = jconfig.tiny_draft_config(jt, block_size=BLOCK, num_layers=1)
        jtp = jqwen3.init_params(jax.random.PRNGKey(0), jt, jnp.float32)
        jdp = jdraft.init_params(jax.random.PRNGKey(1), jd, jnp.float32)
        if int8:
            jtp = jquant.quantize_target_params(jtp, jt, pad_to=64)
            jdp = jquant.quantize_draft_params(jdp, jd, pad_to=64)
        tt = tconfig.tiny_target_config()
        td = tconfig.tiny_draft_config(tt, block_size=BLOCK, num_layers=1)
        to_torch = lambda tree: params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")  # noqa: E731
        _MODELS[int8] = (jt, jd, jtp, jdp, tt, td, to_torch(jtp), to_torch(jdp))
    return _MODELS[int8]


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(10, 500, size=n) for n in PROMPT_LENS]


def port_engine(int8=False, tokenizer=None, **kw) -> ContinuousBatchingEngine:
    tt, td, ttp, tdp = _models(int8)[4:]
    cfg = EngineConfig(**{**ENGINE, "kv_quant": int8, **kw})
    return ContinuousBatchingEngine(tt, td, ttp, tdp, cfg, tokenizer=tokenizer, device="cpu")


def jax_engine(int8=False, **kw) -> JEngine:
    jt, jd, jtp, jdp = _models(int8)[:4]
    return JEngine(jt, jd, jtp, jdp, JConfig(**{**ENGINE, "kv_quant": int8, **kw}))


def drive(engine, prompts, **submit_kw) -> list:
    """Three requests, two scheduling steps, then two more (admitted while
    the first ones decode), run until drained."""
    reqs = [engine.submit(p, **submit_kw) for p in prompts[:3]]
    engine.step()
    engine.step()
    reqs += [engine.submit(p, **submit_kw) for p in prompts[3:]]
    engine.run_until_drained()
    return reqs


META = ("prompt_tokens", "completion_tokens", "spec_verify_ct", "spec_accept_length", "finish_reason")


def assert_same_requests(port: list, ref: list) -> None:
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a.error is None and b.error is None, (a.error, b.error)
        np.testing.assert_array_equal(a.output_ids, b.output_ids, err_msg=f"request {i}")
        assert {k: a.meta_info[k] for k in META} == {k: b.meta_info[k] for k in META}, i


_STOP = {}


def _stop_token(int8: bool) -> int:
    """A token request 0 commits early (its third generated token)."""
    if int8 not in _STOP:
        req = drive(port_engine(int8), _prompts())[0]
        _STOP[int8] = int(req.output_ids[0, PROMPT_LENS[0] + 2])
    return _STOP[int8]


@pytest.mark.parametrize("int8", [False, True])
def test_engine_matches_dflash_tpu(int8):
    """Five staggered requests on three lanes with a stop token: the port's
    tokens and meta_info counts equal the JAX engine's request by request."""
    stop = _stop_token(int8)
    port = drive(port_engine(int8, stop_token_ids=(stop,)), _prompts())
    ref = drive(jax_engine(int8, stop_token_ids=(stop,)), _prompts())
    assert_same_requests(port, ref)
    assert port[0].meta_info["finish_reason"] == {"type": "stop"}
    assert any(r.meta_info["finish_reason"]["type"] == "length" for r in port)


@pytest.mark.parametrize("mode", [dict(overlap=True), dict(overlap=True, pipeline_depth=2)])
def test_overlap_modes_equal_the_sync_loop(mode):
    """The overlapped scheduler (depth 1 and 2) retires later but gives the
    synchronous loop's tokens and counts."""
    stop = _stop_token(False)
    sync = drive(port_engine(stop_token_ids=(stop,), overlap=False), _prompts())
    assert_same_requests(drive(port_engine(stop_token_ids=(stop,), **mode), _prompts()), sync)


def test_emulate_tau_matches_dflash_tpu():
    """The benchmark's forced acceptance (each lane at its own cycle) gives
    JAX's tokens, cycle counts and acceptance."""
    port = drive(port_engine(emulate_tau=2.5), _prompts(1))
    assert_same_requests(port, drive(jax_engine(emulate_tau=2.5), _prompts(1)))
    assert all(r.meta_info["spec_accept_length"] > 1.5 for r in port)


def _counting_stats(monkeypatch) -> list:
    calls = []

    def stats(x, thr):
        calls.append(x.shape[0])
        return fs.plain(x, thr)

    monkeypatch.setattr(sampling, "filter_stats", stats)
    return calls


def test_filtered_greedy_equivalent_request_gives_greedy_tokens(monkeypatch):
    """At temperature 2, top_k 2 and top_p 1e-6 the keep set is the argmax
    alone: the filtered request's tokens are the greedy request's, beside
    greedy neighbours, with one stats pass per sampling call (its first
    token and each cycle it was active in) and none for the greedy lanes."""
    calls = _counting_stats(monkeypatch)
    prompts = _prompts(2)
    eng = port_engine(sampling_filters=True)
    greedy = [eng.submit(p) for p in prompts[:2]]
    filtered = eng.submit(prompts[0], temperature=2.0, top_k=2, top_p=1e-6)
    eng.run_until_drained()
    np.testing.assert_array_equal(filtered.output_ids, greedy[0].output_ids)
    assert len(calls) == 1 + filtered.meta_info["spec_verify_ct"]
    assert set(calls[1:]) == {BLOCK}  # one lane's rows: the greedy lanes add none


def _lane_logits(R=3, S=4, V=4096, seed=5):
    return (np.random.default_rng(seed).standard_normal((R, S, V)) * 3.0).astype(np.float32)


_jax_filtered_lanes = jax.jit(jax.vmap(jsampling.filtered_logits_topk_topp, in_axes=(0, 0, 0, 0, None)),
                              static_argnums=(4,))


@pytest.mark.parametrize("pool", [8, 64])
def test_per_lane_keep_masks_match_dflash_tpu(pool):
    """[R] temperatures, top_k and top_p: the keep mask of every lane equals
    JAX's filter vmapped over lanes, bit for bit (pool 8 and k 200 refine)."""
    logits = _lane_logits()
    temps = np.asarray([0.8, 1.3, 2.0], np.float32)
    ks = np.asarray([200, 0, 5], np.int64)
    ps = np.asarray([1.0, 0.9, 0.95], np.float32)
    want = np.asarray(_jax_filtered_lanes(jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(ks, jnp.int32),
                                          jnp.asarray(ps), pool))
    got = sampling.filtered_logits_topk_topp(
        torch.from_numpy(logits), torch.from_numpy(temps)[:, None, None], torch.from_numpy(ks)[:, None],
        torch.from_numpy(ps)[:, None], pool).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[np.isfinite(got)], want[np.isfinite(want)])


def test_per_lane_sampler_keeps_each_lane_to_its_keep_set(monkeypatch):
    """sample_topk_topp with R host temperatures, top_k and top_p: one stats
    call over the filtered lanes' rows; a greedy lane takes the argmax and a
    filter-off lane draws as sample() does alone."""
    calls = _counting_stats(monkeypatch)
    logits = torch.from_numpy(_lane_logits(R=4, V=512))
    temps = [0.9, 0.0, 1.1, 1.5]
    ks, ps = [3, 3, 0, 0], [1.0, 1.0, 1.0, 0.5]
    gens = [torch.Generator().manual_seed(s) for s in range(4)]
    out = sampling.sample_topk_topp(logits, temps, gens, ks, ps, pool=64)
    assert out.shape == (4, 4)
    assert calls and set(calls) == {2 * 4}  # one call (and its rounds) over lanes 0 and 3's rows
    keep0 = torch.isfinite(sampling.filtered_logits_topk_topp(logits[0], 0.9, 3, 1.0, 64))
    assert keep0.gather(1, out[0][:, None]).all()
    keep3 = torch.isfinite(sampling.filtered_logits_topk_topp(logits[3], 1.5, 0, 0.5, 64))
    assert keep3.gather(1, out[3][:, None]).all()
    assert torch.equal(out[1], logits[1].argmax(-1))
    assert torch.equal(out[2], sampling.sample(logits[2], 1.1, torch.Generator().manual_seed(2)))


@pytest.mark.parametrize("int8", [False, True])
def test_per_lane_filters_tokens_match_dflash_tpu(int8):
    """batched_prefill (scalar filters shared by the group) and batched_decode
    ([R] filters): lanes whose keep set is the argmax (top_p 1e-6; top_k 1;
    both at hot temperatures) and a greedy lane give JAX's tokens and
    acceptance lane by lane."""
    jt, jd, jtp, jdp, tt, td, ttp, tdp = _models(int8)
    rng = np.random.default_rng(0)
    ids, lens = rng.integers(1, 500, size=(3, 1, 16)), np.asarray([5, 16, 9])
    temps = np.asarray([2.0, 0.0, 1.5], np.float32)
    ks, ps = np.asarray([2, 0, 1], np.int32), np.asarray([1e-6, 1.0, 1.0], np.float32)
    total, cycles, new = 48, 12, 12
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(3, dtype=jnp.uint32))
    st = jit_batched_prefill(jtp, jdp, jnp.asarray(ids, jnp.int32), jnp.asarray(lens, jnp.int32), jnp.float32(2.0),
                             keys, tcfg=jt, dcfg=jd, total_len=total, max_cycles=cycles, kv_quant=int8,
                             filters=JFilters(jnp.int32(1), jnp.float32(1.0)))
    st = jit_batched_decode(jtp, jdp, st, jnp.asarray(lens + new, jnp.int32), jnp.asarray(temps), tcfg=jt, dcfg=jd,
                            block_size=BLOCK, stop_token_ids=(), max_cycles=cycles,
                            filters=JFilters(jnp.asarray(ks), jnp.asarray(ps)))
    port = tb.batched_prefill(ttp, tdp, ids, lens, 2.0, [1, 2, 3], tcfg=tt, dcfg=td, total_len=total,
                              max_cycles=cycles, kv_quant=int8, filters=SamplingFilters(1, 1.0))
    port = tb.batched_decode(ttp, tdp, port, lens + new, temps, tcfg=tt, dcfg=td, block_size=BLOCK,
                             stop_token_ids=(), max_cycles=cycles, filters=SamplingFilters(ks, ps))
    np.testing.assert_array_equal(port.output_ids.numpy(), np.asarray(st.output_ids)[:, 0])
    np.testing.assert_array_equal(port.acc_trace.numpy(), np.asarray(st.acc_trace))


@pytest.mark.parametrize("R", [1, 3])
def test_filter_stats_calls_do_not_grow_with_lanes(R, monkeypatch):
    """Every lane filtered: one stats call per sampling call whatever R (the
    prefill's and each cycle's), none refining (keep sets of one token)."""
    calls = _counting_stats(monkeypatch)
    tt, td, ttp, tdp = _models(False)[4:]
    ids = np.random.default_rng(1).integers(1, 500, size=(R, 16))
    lens = np.full(R, 16)
    st = tb.batched_prefill(ttp, tdp, ids, lens, 1.5, list(range(R)), tcfg=tt, dcfg=td, total_len=48,
                            max_cycles=12, filters=SamplingFilters(1, 1.0))
    st = tb.batched_cycles(st, ttp, tdp, 1.5, lens + 12, tcfg=tt, dcfg=td, block_size=BLOCK, stop_token_ids=(),
                           n_steps=5, filters=SamplingFilters(np.full(R, 2), np.full(R, 1e-6)))
    assert len(calls) == 1 + 5 and calls == [R] + [R * BLOCK] * 5


def test_abort_queued_and_active_requests():
    eng = port_engine(num_lanes=1, overlap=False)
    prompts = _prompts()
    active = eng.submit(prompts[0], stream=True)
    queued = eng.submit(prompts[1])
    assert eng.abort(queued.rid)
    assert queued.done_event.is_set() and queued.meta_info["finish_reason"] == {"type": "abort"}
    eng.step()  # admits and decodes one window of the active request
    assert eng.abort(active.rid)
    eng.run_until_drained()
    assert active.meta_info["finish_reason"] == {"type": "abort"}
    full = drive(port_engine(), prompts)[0]
    n = active.output_ids.shape[1]
    assert PROMPT_LENS[0] < n < full.output_ids.shape[1]
    np.testing.assert_array_equal(active.output_ids[0], full.output_ids[0, :n])
    assert not eng.abort(active.rid) and not eng.abort(12345)
    items = []
    while not active.stream_queue.empty():
        items.append(active.stream_queue.get_nowait())
    assert items[-1]["finished"] and items[-1]["meta_info"]["finish_reason"] == {"type": "abort"}


def test_streamed_chunks_concatenate_to_the_output():
    eng = port_engine(stream_interval=1, pipeline_depth=2)
    reqs = drive(eng, _prompts(), stream=True)
    for r in reqs:
        chunks = []
        while True:
            item = r.stream_queue.get(timeout=5)
            chunks.extend(item["token_ids"])
            if item["finished"]:
                break
        assert r.stream_queue.empty()
        np.testing.assert_array_equal(np.asarray(chunks), r.output_ids[0, r.meta_info["prompt_tokens"]:])


def test_stop_string_cuts_before_the_match():
    """A stop string decoded from a token the request commits: the output
    ends at the token that completes the match, finish_reason says which."""
    tok = SyntheticTokenizer(tconfig.tiny_target_config().vocab_size)
    prompt = _prompts()[1]
    free = drive(port_engine(tokenizer=tok), [prompt])[0]
    gen = free.output_ids[0, len(prompt):]
    stop = tok.decode([gen[4]])
    first = next(i for i in range(len(gen)) if stop in tok.decode(gen[:i + 1]))
    for interval in (1, 4):
        req = drive(port_engine(tokenizer=tok, stream_interval=interval), [prompt], stop=stop)[0]
        assert req.meta_info["finish_reason"] == {"type": "stop", "matched": stop}
        np.testing.assert_array_equal(req.output_ids[0, len(prompt):], gen[:first + 1])
    with pytest.raises(ValueError):  # stop strings need a tokenizer
        port_engine().submit(prompt, stop="x")


def test_seed_reproduces_its_tokens_in_any_lane():
    """A sampled request with a seed gives the same tokens whether it is
    admitted first (lane 0) or after two others (lane 2), alone or beside
    other sampled requests; the default seed follows request_seed."""
    prompts = _prompts(3)

    def run(order):
        eng = port_engine()
        reqs = {name: eng.submit(prompts[i], temperature=0.9, seed=seed) for name, i, seed in order}
        eng.run_until_drained()
        return reqs

    first = run([("x", 0, 5)])
    later = run([("a", 1, None), ("b", 2, 7), ("x", 0, 5)])
    np.testing.assert_array_equal(first["x"].output_ids, later["x"].output_ids)
    other = run([("x", 0, 6)])
    assert not np.array_equal(first["x"].output_ids, other["x"].output_ids)
    assert request_seed(0, 1) != request_seed(0, 2) and request_seed(0, 1) == request_seed(0, 1)


def test_bucketed_engine_routes_to_the_smallest_fitting_pool():
    tt, td, ttp, tdp = _models(False)[4:]
    cfg = EngineConfig(**ENGINE)
    ladder = BucketedEngine(tt, td, ttp, tdp, cfg, [BucketSpec(32, 12, 2), BucketSpec(16, 8, 2)], device="cpu")
    short, long_ = _prompts()[0], _prompts()[3]
    a = ladder.submit(short, max_new_tokens=8)
    b = ladder.submit(long_, max_new_tokens=8)
    c = ladder.submit(short, max_new_tokens=12)
    ladder.run_until_drained()
    assert set(ladder.pools[0].completed) == {a.rid} and set(ladder.pools[1].completed) == {b.rid, c.rid}
    assert len(ladder.completed) == 3
    for req, pool_cfg in ((a, ladder.pools[0].cfg), (b, ladder.pools[1].cfg)):
        alone = ContinuousBatchingEngine(tt, td, ttp, tdp, pool_cfg, device="cpu")
        ref = alone.submit(req.output_ids[0, :req.meta_info["prompt_tokens"]], max_new_tokens=8)
        alone.run_until_drained()
        np.testing.assert_array_equal(req.output_ids, ref.output_ids)
    with pytest.raises(ValueError):
        ladder.submit(np.arange(40) + 10)


def test_submit_checks():
    eng = port_engine()
    with pytest.raises(ValueError):  # the prompt_cap
        eng.submit(np.arange(33) + 10)
    with pytest.raises(ValueError):  # filters need sampling_filters
        eng.submit(np.arange(5) + 10, temperature=0.8, top_k=5)
    req = eng.submit(np.arange(5) + 10, temperature=0.8, top_k=1, top_p=0.5)
    assert (req.temperature, req.top_k, req.top_p) == (0.0, 0, 1.0)  # top_k 1 is greedy
    filtered = port_engine(sampling_filters=True, topk_pool=8)
    # wider than the pool: accepted as it is (the keep set is exact for any
    # top_k, as in dflash_tpu)
    assert filtered.submit(np.arange(5) + 10, temperature=0.8, top_k=9).top_k == 9
    assert filtered.submit(np.arange(5) + 10, temperature=0.8, top_k=10_000).top_k == 0  # >= vocab: off
    assert eng.submit(np.arange(5) + 10, max_new_tokens=99).max_new_tokens == ENGINE["max_new_tokens"]


def test_flush_and_steps_per_sync():
    eng = port_engine(steps_per_sync=2)
    eng.submit(_prompts()[0])
    eng.step()
    with pytest.raises(RuntimeError):
        eng.flush()
    with pytest.raises(RuntimeError):
        eng.set_steps_per_sync(3)
    eng.run_until_drained()
    eng.flush()
    eng.set_steps_per_sync(3)
    assert eng.cfg.steps_per_sync == 3
    req = eng.submit(_prompts()[0])
    eng.run_until_drained()
    assert req.meta_info["completion_tokens"] == ENGINE["max_new_tokens"]


def test_adaptive_window_picks_the_earliest_finish():
    """With a request waiting, the window shrinks to the smallest size that
    covers the busy lane's predicted finish; with none waiting it is full."""
    eng = port_engine(num_lanes=1, adaptive_window=True, steps_per_sync=8, overlap=False)
    assert eng._windows == [1, 2, 4, 8]
    eng.submit(_prompts()[0])
    eng.step()
    assert eng.cycle_count == 8
    assert eng._pick_window() == 8  # nothing queued
    eng.submit(_prompts()[1])
    eng._tau_est = 1.0
    need = max(1, int(eng._lane_max_length[0] - eng._state.host_start[0]))
    assert eng._pick_window() == next(n for n in eng._windows if n >= need)


def test_loop_thread_serves_and_flushes():
    """start(): the loop thread admits, decodes and retires; flush() from
    this thread runs on the loop thread."""
    eng = port_engine()
    eng.start()
    try:
        req = eng.submit(_prompts()[2])
        assert req.done_event.wait(timeout=60)
        eng.flush()
    finally:
        eng.stop()
    ref = drive(port_engine(), [_prompts()[2]])[0]
    np.testing.assert_array_equal(req.output_ids, ref.output_ids)


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")  # the loop re-raises
def test_loop_failure_fails_the_requests_it_holds(monkeypatch):
    """A window that raises on the loop thread fails every request the
    engine holds (bound or queued) with the error, then the thread ends."""
    eng = port_engine()

    def failing_step():
        raise RuntimeError("window failed")

    monkeypatch.setattr(eng, "step", failing_step)
    reqs = [eng.submit(p) for p in _prompts()[:2]]
    eng.start()
    assert all(r.done_event.wait(timeout=30) for r in reqs)
    assert all("window failed" in r.error for r in reqs)
    eng._thread.join(timeout=30)
    assert not eng._thread.is_alive()


@pytest.mark.parametrize("option", [dict(prefix_cache_mb=16), dict(admission_chunk=8), dict(prefill_ahead=1),
                                    dict(batch_admission=True), "prefill_worker"])
def test_options_left_out_raise(option):
    """The admission options that were left out of the port (and raised)
    now run: the five staggered requests give the plain engine's tokens and
    counts through each (tests/test_torch_admission.py holds each route
    against dflash_tpu's)."""
    tt, td, ttp, tdp = _models(False)[4:]
    kw = {} if option == "prefill_worker" else option
    worker = (PrefillWorker(tt, td, ttp, prefill_device="cpu", decode_device="cpu")
              if option == "prefill_worker" else None)
    try:
        eng = ContinuousBatchingEngine(tt, td, ttp, tdp, EngineConfig(**ENGINE, **kw), device="cpu",
                                       prefill_worker=worker)
        got = drive(eng, _prompts())
    finally:
        if worker is not None:
            worker.stop()
    assert_same_requests(got, drive(port_engine(), _prompts()))


def test_submit_accepts_topk_beyond_pool_exactly():
    """submit() takes any top_k below the vocabulary, and the sample is exact
    whatever the pool: pool 8 (refinement rounds) and pool 128 (the
    threshold guess) give the same tokens for one seed; top_k >= vocab is a
    no-op, accepted."""
    vocab = tconfig.tiny_target_config().vocab_size
    prompt = np.asarray([5, 6, 7])
    outs = []
    for pool in (8, 128):
        eng = port_engine(sampling_filters=True, topk_pool=pool)
        outs.append(eng.submit(prompt, temperature=1.0, top_k=vocab - 3, seed=11))
        eng.run_until_drained()
        assert outs[-1].error is None
    np.testing.assert_array_equal(outs[0].output_ids, outs[1].output_ids)
    off = eng.submit(prompt, temperature=1.0, top_k=vocab, seed=3)
    eng.run_until_drained()
    assert off.error is None and off.top_k == 0


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without CUDA")
    tt, td, ttp, tdp = _models(False)[4:]
    with pytest.raises(RuntimeError):
        ContinuousBatchingEngine(tt, td, ttp, tdp, EngineConfig(**ENGINE))



def test_engine_config_has_the_jax_fields_and_defaults():
    assert [f.name for f in dataclasses.fields(EngineConfig)] == [f.name for f in dataclasses.fields(JConfig)]
    assert EngineConfig() == EngineConfig(**{f.name: getattr(JConfig(), f.name)
                                             for f in dataclasses.fields(JConfig)})
