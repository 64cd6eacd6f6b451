"""dflash_tpu_torch's serving admission routes on the CPU, against
dflash_tpu's engine on the same requests: batched admission, prefill-ahead,
the prompt-prefix cache, chunk-interleaved admission, disaggregated prefill
(two ``"cpu"`` devices stand in for two cards) and ``SpecEngine``'s chunked
prefill.

f32 tiny weights are carried across by ``convert.params_from_numpy``.  At
temperature 0 each route's ``output_ids`` and ``meta_info`` counts must equal
the JAX engine's on the same route, request by request, on the float path
and with ``kv_quant``; each route must also give the tokens of a plain
one-at-a-time admission.  The rest holds the routes' own behaviour (aborts,
faults, staging, the prefix cache's LRU and sizes), ported from the JAX
package's tests of the same names.
"""

import sys
import threading
import time

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
from dflash_tpu.quant import quantize as jquant
from dflash_tpu.spec.engine import SpecEngine as JSpecEngine
from dflash_tpu_torch.cache.kv import KVCache
from dflash_tpu_torch.convert import params_from_numpy
from dflash_tpu_torch.core import config as tconfig
from dflash_tpu_torch.engine import (
    BucketedEngine,
    BucketSpec,
    ContinuousBatchingEngine,
    EngineConfig,
    PrefillWorker,
    batching,
)
from dflash_tpu_torch.engine.prefix_cache import PrefixCache, PrefixEntry
from dflash_tpu_torch.kernels import _build
from dflash_tpu_torch.spec import batched as sb
from dflash_tpu_torch.spec.engine import SpecEngine

torch.set_num_threads(2)

BLOCK = 4
ENGINE = dict(num_lanes=3, max_new_tokens=12, block_size=BLOCK, prompt_cap=32, prompt_bucket=16)
META = ("prompt_tokens", "completion_tokens", "spec_verify_ct", "spec_accept_length", "finish_reason")

_MODELS = {}


def _models(int8: bool = False):
    """(JAX configs and params, port configs and params): the tiny target
    and a 1-layer draft in f32, or their int8 weights quantized by the JAX
    package, carried across."""
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


def port_engine(int8=False, worker=None, **kw) -> ContinuousBatchingEngine:
    tt, td, ttp, tdp = _models(int8)[4:]
    cfg = EngineConfig(**{**ENGINE, "kv_quant": int8, **kw})
    return ContinuousBatchingEngine(tt, td, ttp, tdp, cfg, prefill_worker=worker, device="cpu")


def jax_engine(int8=False, **kw) -> JEngine:
    jt, jd, jtp, jdp = _models(int8)[:4]
    return JEngine(jt, jd, jtp, jdp, JConfig(**{**ENGINE, "kv_quant": int8, **kw}))


def run(engine, prompts, **submit_kw) -> list:
    reqs = [engine.submit(p, **submit_kw) for p in prompts]
    engine.run_until_drained()
    return reqs


def assert_same(port: list, ref: list) -> None:
    """Tokens and meta_info counts equal request by request."""
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a.error is None and b.error is None, (i, a.error, b.error)
        np.testing.assert_array_equal(a.output_ids, b.output_ids, err_msg=f"request {i}")
        assert {k: a.meta_info[k] for k in META} == {k: b.meta_info[k] for k in META}, i


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(10, 500, size=n) for n in lens]


SHARED = np.random.default_rng(7).integers(1, 510, size=20)
LONG_PROMPT = np.arange(3, 23, dtype=np.int32)  # 20 tokens: p0 = 16 at chunk 8


# ---------------------------------------------------------------------------
# batched admission
# ---------------------------------------------------------------------------

GROUP = [np.asarray([5, 6, 7, 8]), np.asarray([9, 10, 11]), np.asarray([3, 4]), np.asarray([12, 13, 14, 15, 16])]


def _count_group_prefills(monkeypatch) -> list:
    """Record the group size of every batched prefill the engine runs."""
    calls, real = [], sb.batched_prefill

    def counting(*a, **kw):
        calls.append(len(a[3]))
        return real(*a, **kw)

    monkeypatch.setattr(sb, "batched_prefill", counting)
    return calls


@pytest.mark.parametrize("int8", [False, True])
def test_group_admission_matches_single_admission(int8, monkeypatch):
    """A burst admitted as one group (one batched prefill, one multi-lane
    write) gives the one-at-a-time tokens, and JAX's group tokens and
    counts."""
    calls = _count_group_prefills(monkeypatch)
    eng = port_engine(int8, num_lanes=4, batch_admission=True)
    reqs = [eng.submit(p, max_new_tokens=10) for p in GROUP]
    eng.step()  # all four in one group (same temperature)
    assert calls == [4] and all(r is not None for r in eng._lane_req)
    eng.run_until_drained()
    single = run(port_engine(int8, num_lanes=1), GROUP, max_new_tokens=10)
    assert_same(reqs, single)
    assert_same(reqs, run(jax_engine(int8, num_lanes=4, batch_admission=True), GROUP, max_new_tokens=10))


def test_group_admitted_seeded_sample_equals_alone(monkeypatch):
    """A seeded sampled request gives the same tokens admitted alone or in a
    group (its first token from its own generator)."""
    prompts = _prompts((5, 9, 14), seed=3)
    alone = run(port_engine(num_lanes=3), prompts[:1], temperature=0.9, seed=5)[0]
    calls = _count_group_prefills(monkeypatch)
    eng = port_engine(num_lanes=3, batch_admission=True)
    group = [eng.submit(p, temperature=0.9, seed=s) for p, s in zip(prompts, (5, 6, 7))]
    eng.run_until_drained()
    assert calls == [3]
    np.testing.assert_array_equal(group[0].output_ids, alone.output_ids)
    assert not np.array_equal(group[1].output_ids[0, 9:], group[0].output_ids[0, 5:14])


def test_group_prefill_failure_falls_back_per_request(monkeypatch):
    """A fault in the group prefill retries the requests one at a time:
    nothing fails, nothing is lost."""
    eng = port_engine(batch_admission=True, overlap=False, num_lanes=2)

    def bad_prefill(*a, **kw):
        raise RuntimeError("injected prefill fault")

    monkeypatch.setattr(sb, "batched_prefill", bad_prefill)
    reqs = run(eng, GROUP[:2])
    assert_same(reqs, run(port_engine(num_lanes=2), GROUP[:2]))


def test_failed_lane_write_sets_the_lanes_back_to_idle(monkeypatch):
    """A group's lane write that fails partway (the second lane half
    written) sets the group's lanes back to idle, leaves the running request
    untouched, and the group is admitted one request at a time with the
    plain tokens."""
    eng = port_engine(batch_admission=True, overlap=False, num_lanes=3)
    a = eng.submit(GROUP[0])
    eng.step()
    assert eng._lane_req[0] is a
    real_admit, real_idle, calls, idled = batching._admit, batching._idle_lanes, [], []

    def half_write(state, lane, single):
        calls.append(lane)
        if len(calls) == 2:
            state.output_ids[lane] = single.output_ids[0]
            state.done[lane] = False
            raise RuntimeError("injected device fault")
        real_admit(state, lane, single)

    def idle(state, lanes):
        real_idle(state, lanes)
        idled.append((list(lanes), eng._lane_req.copy(), state.host_done.copy(), state.done.clone()))

    monkeypatch.setattr(batching, "_admit", half_write)
    monkeypatch.setattr(batching, "_idle_lanes", idle)
    b, c = eng.submit(GROUP[1]), eng.submit(GROUP[2])
    eng._admit_pending()
    (lanes, bound, host_done, done), = idled
    assert lanes == [1, 2] and bound == [a, None, None]
    assert host_done[1:].all() and done[1:].all() and not done[0]
    assert calls == [1, 2, 1, 2] and eng._lane_req == [a, b, c]  # then one at a time
    eng.run_until_drained()
    assert_same([a, b, c], run(port_engine(num_lanes=1), GROUP[:3]))


def test_engine_survives_a_lost_lane_state(monkeypatch):
    """A lane write that fails and whose lanes cannot be set back to idle
    loses the lane state: the active request and the group fail with
    "engine state lost", and the engine keeps serving with the plain
    tokens."""
    eng = port_engine(batch_admission=True, overlap=False, num_lanes=3)
    a = eng.submit(GROUP[0])
    eng.step()

    def boom(*args, **kw):
        raise RuntimeError("injected device fault")

    monkeypatch.setattr(batching, "_admit_many", boom)
    monkeypatch.setattr(batching, "_idle_lanes", boom)
    b, c = eng.submit(GROUP[1]), eng.submit(GROUP[2])
    eng.step()
    for req in (a, b, c):
        assert req.done_event.is_set() and "engine state lost" in req.error
    assert all(r is None for r in eng._lane_req)
    monkeypatch.undo()
    d = run(eng, GROUP[:1])[0]
    assert_same([d], run(port_engine(num_lanes=3), GROUP[:1]))


# ---------------------------------------------------------------------------
# prefix cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True])
def test_prefix_cache_hit_matches_cold_prefill(int8):
    """Requests resuming from a cached prompt prefix (the 16-token boundary
    of a shared 20-token prefix) give the cold prefill's tokens, and JAX's
    warm tokens and counts; the int8 cache stores its own rows."""
    p1 = np.concatenate([SHARED, [5, 6, 7]])
    p2 = np.concatenate([SHARED, [9]] if int8 else [SHARED, [9, 10]])

    def warm(make):
        eng = make(int8, num_lanes=1, prefix_cache_mb=64)
        r1 = run(eng, [p1], max_new_tokens=10)
        assert (eng._prefix_cache.misses, eng._prefix_cache.hits) == (1, 0)
        r2 = run(eng, [p2], max_new_tokens=10)
        assert eng._prefix_cache.hits == 1
        return r1 + r2

    got = warm(port_engine)
    assert_same(got, run(port_engine(int8, num_lanes=1), [p1, p2], max_new_tokens=10))
    assert_same(got, warm(jax_engine))


def test_prefix_entry_owns_exactly_its_bytes():
    """An entry published by an admission holds its P0 rows in storage of
    its own (not a view of the total_len cache): storage == nbytes, float
    and int8."""
    for int8 in (False, True):
        eng = port_engine(int8, num_lanes=1, prefix_cache_mb=64)
        run(eng, [np.concatenate([SHARED, [5, 6, 7]])])
        (entry, keys), = eng._prefix_cache._groups.values()
        assert entry.prefix_len == 16 and len(keys) == 1
        storage = sum(x.untyped_storage().nbytes() for x in (*entry.kv_rows, entry.taps))
        assert storage == entry.nbytes == eng._prefix_cache._bytes
        assert entry.kv_rows.k.shape[2] == 16 and entry.kv_rows.k.shape[2] < eng.total_len


def _entry(seed, n):
    k = torch.full((2, 1, n, 2, 4), float(seed))
    return PrefixEntry(kv_rows=KVCache(k=k, v=k), taps=torch.zeros((1, n, 8)))


def test_prefix_cache_lru_eviction_and_flush():
    one = _entry(1, 16).nbytes
    pc = PrefixCache(capacity_bytes=2 * one + 1, granularity=16)
    ids_a, ids_b, ids_c = np.arange(1, 40), np.arange(2, 41), np.arange(3, 42)
    pc.insert(ids_a, _entry(1, 16))
    pc.insert(ids_b, _entry(2, 16))
    assert pc.lookup(ids_a, 38) is not None  # refresh a
    pc.insert(ids_c, _entry(3, 16))  # evicts b (least recently used)
    assert pc.lookup(ids_b, 39) is None
    assert pc.lookup(ids_c, 40) is not None
    pc.clear()
    assert pc.lookup(ids_a, 38) is None
    # off-boundary and oversize inserts are dropped
    pc.insert(ids_a, _entry(4, 15))
    big = PrefixCache(capacity_bytes=one - 1, granularity=16)
    big.insert(ids_a, _entry(5, 16))
    assert big.lookup(ids_a, 38) is None


def test_prefix_cache_superseded_entry_frees_bytes():
    """A longer prefix that takes over every boundary key of a shorter entry
    frees the shorter entry's bytes at once."""
    ids = np.arange(1, 60)
    short, long_ = _entry(1, 16), _entry(2, 32)
    pc = PrefixCache(capacity_bytes=short.nbytes + long_.nbytes, granularity=16)
    pc.insert(ids, short)
    pc.insert(ids, long_)
    assert pc._bytes == long_.nbytes and len(pc._groups) == 1
    hit = pc.lookup(ids, 58)
    assert hit is not None and hit[1].prefix_len == 32


def test_prefix_cache_sub_boundary_hits():
    """A 32-token entry also serves a prompt agreeing on its first 16 tokens
    (one entry, bytes counted once), truncated to the hit boundary."""
    k = torch.arange(2 * 1 * 32 * 2 * 4, dtype=torch.float32).reshape(2, 1, 32, 2, 4)
    entry = PrefixEntry(kv_rows=KVCache(k=k, v=k), taps=torch.zeros((1, 32, 8)))
    pc = PrefixCache(capacity_bytes=10 * entry.nbytes, granularity=16)
    ids_long = np.arange(1, 50)
    pc.insert(ids_long, entry)
    assert pc._bytes == entry.nbytes
    diverging = np.concatenate([ids_long[:16], [999, 998, 997]])
    n, sub = pc.lookup(diverging, len(diverging) - 1)
    assert n == 16 and sub.prefix_len == 16
    torch.testing.assert_close(sub.kv_rows.k, entry.kv_rows.k[:, :, :16], rtol=0, atol=0)
    n2, full = pc.lookup(ids_long, 48)
    assert n2 == 32 and full.prefix_len == 32


def test_bucketed_prefix_cache_shared_across_rungs():
    """One prefix cache for the whole ladder: a prefix prefilled in the big
    rung resumes an admission in the small one, with the cold tokens."""
    tt, td, ttp, tdp = _models()[4:]
    rungs = [BucketSpec(32, 8, 2), BucketSpec(32, 16, 2)]
    cfg = dict(num_lanes=2, max_new_tokens=16, block_size=BLOCK, prompt_cap=32, prompt_bucket=16)
    eng = BucketedEngine(tt, td, ttp, tdp, EngineConfig(**cfg, prefix_cache_mb=64), rungs, device="cpu")
    assert all(p._prefix_cache is eng._prefix_cache for p in eng.pools)
    prompt = np.arange(3, 27, dtype=np.int32)  # 24 tokens: a 16-token prefix
    a = eng.submit(prompt, max_new_tokens=16)  # the big rung
    eng.run_until_drained()
    assert eng._prefix_cache.misses >= 1 and eng._prefix_cache.hits == 0
    b = eng.submit(prompt, max_new_tokens=8)  # the small rung, same prefix
    eng.run_until_drained()
    assert eng._prefix_cache.hits == 1
    cold = BucketedEngine(tt, td, ttp, tdp, EngineConfig(**cfg), rungs, device="cpu")
    rb = cold.submit(prompt, max_new_tokens=8)
    cold.run_until_drained()
    np.testing.assert_array_equal(b.output_ids, rb.output_ids)
    assert a.output_ids is not None
    eng.flush()
    assert not eng._prefix_cache._groups


# ---------------------------------------------------------------------------
# prefill-ahead
# ---------------------------------------------------------------------------

def test_prefill_ahead_token_parity():
    """Seven requests on two lanes with prefill-ahead: the plain engine's
    tokens, and JAX's tokens and counts with prefill-ahead."""
    prompts = [np.asarray([3 + i, 4, 5 + (i % 3)]) for i in range(7)]
    got = run(port_engine(num_lanes=2, prefill_ahead=3), prompts)
    assert_same(got, run(port_engine(num_lanes=2), prompts))
    assert_same(got, run(jax_engine(num_lanes=2, prefill_ahead=3), prompts))


def test_prefill_ahead_stages_while_lanes_busy():
    eng = port_engine(num_lanes=2, prefill_ahead=2, overlap=False)
    for i in range(6):
        eng.submit(np.asarray([3 + i, 4, 5]))
    eng.step()  # admits two into the lanes
    assert sum(r is not None for r in eng._lane_req) == 2
    eng.step()  # every lane busy: stages up to the cap
    assert len(eng._staged) == 2
    eng.run_until_drained()
    assert not eng._staged and all(r is None for r in eng._lane_req)


def test_prefill_ahead_abort_while_staged():
    """A request aborted while staged completes with the abort reason and
    never takes a lane."""
    eng = port_engine(num_lanes=2, prefill_ahead=2, overlap=False)
    running = [eng.submit(np.asarray([3 + i, 4, 5])) for i in range(2)]
    victim = eng.submit(np.asarray([9, 9, 9]))
    eng.step()
    eng.step()  # the victim is staged
    assert any(r.rid == victim.rid for r, _ in eng._staged)
    assert eng.abort(victim.rid)
    eng.run_until_drained()
    assert victim.meta_info["finish_reason"]["type"] == "abort"
    for r in running:
        assert r.error is None and r.output_ids is not None


# ---------------------------------------------------------------------------
# chunk-interleaved admission
# ---------------------------------------------------------------------------

def _chunk_engine(make=port_engine, **kw):
    return make(**{"num_lanes": 2, **kw})


@pytest.mark.parametrize("int8", [False, True])
def test_chunked_admission_token_parity(int8):
    """A chunk-admitted request gives the one-forward admission's tokens,
    and JAX's chunked tokens and counts."""
    got = run(_chunk_engine(int8=int8, admission_chunk=8), [LONG_PROMPT])
    assert_same(got, run(_chunk_engine(int8=int8), [LONG_PROMPT]))
    assert_same(got, run(_chunk_engine(jax_engine, int8=int8, admission_chunk=8), [LONG_PROMPT]))


def test_chunked_admission_with_busy_lanes():
    """Chunk admission while another lane decodes: both outputs equal their
    solo runs."""
    ra = run(_chunk_engine(), [np.asarray([5, 6, 7])])[0]
    rb = run(_chunk_engine(), [LONG_PROMPT])[0]
    eng = _chunk_engine(admission_chunk=8, max_new_tokens=24)
    a = eng.submit(np.asarray([5, 6, 7]), max_new_tokens=12)
    eng.step()  # a admitted and decoding
    b = eng.submit(LONG_PROMPT, max_new_tokens=12)
    eng.run_until_drained()
    np.testing.assert_array_equal(a.output_ids, ra.output_ids)
    np.testing.assert_array_equal(b.output_ids, rb.output_ids)


def test_decode_advances_while_admission_in_flight():
    eng = _chunk_engine(admission_chunk=4, max_new_tokens=24)
    a = eng.submit(np.asarray([5, 6, 7]), max_new_tokens=24)
    eng.step()
    c_before = eng.cycle_count
    b = eng.submit(LONG_PROMPT, max_new_tokens=8)  # p0 = 16: four chunks
    windows = 0
    for _ in range(100):
        eng.step()
        if not eng._prefill_tasks:
            break
        windows += 1
        assert eng._state.done[eng._prefill_tasks[0].lane]  # the reserved lane stays idle
    assert windows >= 3 and eng.cycle_count > c_before
    eng.run_until_drained()
    assert a.error is None and b.error is None
    assert b.output_ids is not None and a.meta_info["completion_tokens"] == 24


def test_abort_during_chunked_admission():
    eng = _chunk_engine(admission_chunk=4, max_new_tokens=24)
    a = eng.submit(np.asarray([5, 6, 7]), max_new_tokens=24)
    eng.step()
    b = eng.submit(LONG_PROMPT, max_new_tokens=8)
    for _ in range(50):
        eng.step()
        if eng._prefill_tasks:
            break
    assert eng._prefill_tasks
    assert eng.abort(b.rid) is True
    eng.run_until_drained()
    assert b.meta_info["finish_reason"]["type"] == "abort"
    assert not eng._lane_reserved
    assert a.error is None and a.meta_info["completion_tokens"] == 24


def test_chunked_admission_resumes_from_prefix_cache():
    """A cached prefix, chunk-aligned, seeds the scratch cache: fewer chunk
    forwards, the same tokens."""
    want = run(_chunk_engine(), [LONG_PROMPT])[0]
    eng = _chunk_engine(admission_chunk=8, prefix_cache_mb=64)
    warm = run(eng, [LONG_PROMPT])[0]  # chunked itself; publishes its prefix
    h0 = eng._prefix_cache.hits
    eng.submit(LONG_PROMPT)
    eng._admit_pending()
    assert eng._prefill_tasks[0].c0 == 16 == eng._prefill_tasks[0].p0  # nothing left to prefill
    eng.run_until_drained()
    again = eng.completed[max(eng.completed)]
    assert eng._prefix_cache.hits > h0
    np.testing.assert_array_equal(want.output_ids, warm.output_ids)
    np.testing.assert_array_equal(want.output_ids, again.output_ids)


def test_short_prompts_bypass_chunking():
    eng = _chunk_engine(admission_chunk=16)
    r = run(eng, [np.asarray([5, 6, 7])])[0]  # p0 = 0: the one-forward admission
    assert r.error is None and not eng._prefill_tasks


# ---------------------------------------------------------------------------
# disaggregated prefill
# ---------------------------------------------------------------------------

def _disagg_engine(int8=False, lanes=3):
    tt, td, ttp = _models(int8)[4:7]
    worker = PrefillWorker(tt, td, ttp, prefill_device="cpu", decode_device=torch.device("cpu"), kv_quant=int8)
    return port_engine(int8, worker=worker, num_lanes=lanes, prompt_cap=64), worker


def _long_prompt(n=40, seed=3):
    return np.random.default_rng(seed).integers(0, 510, size=(n,)).astype(np.int32)


@pytest.mark.parametrize("int8", [False, True])
def test_disagg_admission_token_parity_under_busy_lanes(int8):
    """A request admitted through the prefill worker while two lanes decode
    gives the colocated admission's tokens and counts, and JAX's."""
    long_ids = _long_prompt(seed=7 if int8 else 3)
    shorts = [np.asarray([5, 6, 7, 8], np.int32)] * 2
    eng, worker = _disagg_engine(int8)
    try:
        got = run(eng, shorts + [long_ids])
    finally:
        worker.stop()
    assert_same(got[2:], run(port_engine(int8, prompt_cap=64), [long_ids]))
    assert_same(got, run(jax_engine(int8, prompt_cap=64), shorts + [long_ids]))


def test_disagg_short_prompt_admits_inline():
    """Prompts below one prompt bucket skip the worker."""
    eng, worker = _disagg_engine()
    try:
        r = run(eng, [np.asarray([5, 6, 7], np.int32)])[0]
        assert r.error is None and worker.inflight == 0 and eng._disagg_pending == 0
    finally:
        worker.stop()


def test_disagg_abort_before_admission():
    """Aborting a request while the worker prefills it completes it with the
    abort reason and frees its reserved lane; the engine keeps serving."""
    eng, worker = _disagg_engine(lanes=2)
    try:
        r = eng.submit(_long_prompt(seed=11))
        eng.step()  # handed to the worker
        assert eng.abort(r.rid)
        eng.run_until_drained()
        assert r.meta_info["finish_reason"]["type"] == "abort"
        assert not eng._lane_reserved
        assert run(eng, [np.asarray([4, 5, 6], np.int32)])[0].error is None
    finally:
        worker.stop()


def test_disagg_worker_failure_is_isolated():
    eng, worker = _disagg_engine(lanes=2)

    def boom(padded, p0):
        raise RuntimeError("synthetic prefill-device fault")

    worker._prefill_prefix = boom
    try:
        bad, ok = run(eng, [_long_prompt(seed=13), np.asarray([5, 6, 7], np.int32)])
        assert bad.error is not None and "disagg prefill failed" in bad.error
        assert ok.error is None and not eng._lane_reserved
    finally:
        worker.stop()


def test_disagg_handoff_lands_on_decode_device():
    """The handoff's rows are on the decode device and complete; on one
    device the worker's parameters are the engine's own tensors."""
    tt, td, ttp = _models()[4:7]
    worker = PrefillWorker(tt, td, ttp, prefill_device="cpu", decode_device="cpu")
    try:
        assert worker.t_params["embed"] is ttp["embed"]
        assert worker.t_params["layers"]["wq"] is ttp["layers"]["wq"]
        ids = _long_prompt()
        padded = np.zeros((1, 48), np.int64)
        padded[0, :len(ids)] = ids
        worker.submit(object(), 0, padded, 32)
        res = None
        for _ in range(600):
            got = worker.poll()
            if got:
                res = got[0]
                break
            time.sleep(0.05)
        assert res is not None and res.error is None
        assert all(x.device == torch.device("cpu") and x.shape[2] == 32 for x in res.kv_rows)
        assert res.taps.shape == (1, 32, td.num_taps * tt.hidden_size)
    finally:
        worker.stop()
    assert not worker._thread.is_alive()


def test_launch_counters_stay_exact_under_threads():
    """The engine's thread and a prefill worker's both count kernel
    launches: 8 threads adding 20000 each (a switch interval of 1 µs makes
    a lost read-modify-write likely) leave the exact total."""
    def fn():
        pass

    fn.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_build.count_launch(fn) for _ in range(20000)])
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert fn.launches == 8 * 20000


def test_disagg_worker_checks_its_cache_type():
    tt, td, ttp = _models()[4:7]
    worker = PrefillWorker(tt, td, ttp, prefill_device="cpu", decode_device="cpu", kv_quant=True)
    try:
        with pytest.raises(ValueError, match="kv_quant"):
            port_engine(worker=worker)
    finally:
        worker.stop()


# ---------------------------------------------------------------------------
# SpecEngine: chunked prefill
# ---------------------------------------------------------------------------

def _spec_pair(**kw):
    jt, jd, jtp, jdp, tt, td, ttp, tdp = _models()
    return (SpecEngine(tt, td, ttp, tdp, device="cpu", **kw), JSpecEngine(jt, jd, jtp, jdp, **kw))


@pytest.mark.parametrize("int8", [False, True])
def test_chunked_prefill_matches_ar(int8):
    """prefill_chunk=4: spec == AR, and both equal dflash_tpu's chunked
    engine's tokens; the chunked prefill's first token and K/V give the
    one-forward prefill's tokens."""
    jt, jd, jtp, jdp, tt, td, ttp, tdp = _models(int8)
    prompt = np.random.default_rng(9).integers(1, 510, size=(1, 13))
    kw = dict(max_new_tokens=16, prompt_cap=16, prompt_bucket=16, stop_token_ids=(), kv_quant=int8)
    eng = SpecEngine(tt, td, ttp, tdp, device="cpu", prefill_chunk=4, **kw)
    spec = eng.generate(prompt, temperature=0.0)
    ar = eng.ar_generate(prompt, temperature=0.0)
    np.testing.assert_array_equal(spec.output_ids, ar.output_ids)
    ref = JSpecEngine(jt, jd, jtp, jdp, prefill_chunk=4, **kw)
    np.testing.assert_array_equal(spec.output_ids, np.asarray(ref.generate(prompt, temperature=0.0).output_ids))
    np.testing.assert_array_equal(ar.output_ids, np.asarray(ref.ar_generate(prompt, temperature=0.0).output_ids))
    assert spec.acceptance_lengths == list(ref.generate(prompt, temperature=0.0).acceptance_lengths)
    whole = SpecEngine(tt, td, ttp, tdp, device="cpu", **kw).generate(prompt, temperature=0.0)
    np.testing.assert_array_equal(spec.output_ids, whole.output_ids)


def test_auto_prefill_chunk_selection():
    """"auto" keeps the one-forward prefill up to 16384 padded tokens, then
    takes a chunk that divides the pad; a 4100-token prompt generates."""
    tt, td, ttp, tdp = _models()[4:]
    eng = SpecEngine(tt, td, ttp, tdp, max_new_tokens=8, prompt_cap=8192, prompt_bucket=128,
                     prefill_chunk="auto", device="cpu")
    assert eng._resolve_chunk(128) is None
    assert eng._resolve_chunk(4096) is None
    assert eng._resolve_chunk(8192) is None
    assert eng._resolve_chunk(16896) == 512  # 33 * 512
    assert eng._resolve_chunk(16640) == 256  # 65 * 256
    assert eng._resolve_chunk(16512) == 128  # 129 * 128
    prompt = np.random.default_rng(0).integers(0, 510, size=(1, 9))
    spec = eng.generate(prompt, temperature=0.0)
    np.testing.assert_array_equal(spec.output_ids, eng.ar_generate(prompt, temperature=0.0).output_ids)
    long_prompt = np.random.default_rng(1).integers(0, 510, size=(1, 4100))
    assert eng.generate(long_prompt, temperature=0.0).num_output_tokens >= 1
    with pytest.raises(NotImplementedError):
        SpecEngine(tt, td, ttp, tdp, max_new_tokens=4, mesh=object(), device="cpu")
