"""dflash_tpu_torch's batched engine (spec/batched.py) on the CPU: R request
lanes with their own prompts, frontiers, acceptance and stop state, against
dflash_tpu.spec.batched (``jit_batched_prefill`` / ``jit_batched_decode`` /
``jit_batched_cycle``) on the same f32 tiny weights carried across by
``convert.py``, and against the port's own single-request engine.

At f32 and temperature 0 the port's lanes must give the JAX package's
``output_ids``, ``start`` and ``acc_trace`` exactly, lane by lane: with
different prompt lengths, a per-lane ``forced_acc``, a stop token that
freezes a lane early, and with and without ``kv_quant``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dflash_tpu.core import config as jconfig
from dflash_tpu.models import dflash_draft as jdraft
from dflash_tpu.models import qwen3 as jqwen3
from dflash_tpu.quant import quantize as jquant
from dflash_tpu.spec.batched import jit_batched_cycle, jit_batched_decode, jit_batched_prefill
from dflash_tpu_torch.convert import params_from_numpy
from dflash_tpu_torch.core import config as tconfig
from dflash_tpu_torch.kernels import prefill_flash, verify_fused
from dflash_tpu_torch.spec import batched as tb
from dflash_tpu_torch.spec.engine import SpecEngine

torch.set_num_threads(2)

BLOCK, P_PAD, TOTAL_LEN, MAX_CYCLES, NEW = 4, 16, 48, 12, 12
PROMPT_LENS = (5, 16, 9)


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


_MODELS = {}


def _models(kv_quant: bool):
    """(JAX configs and params, port configs and params), float or int8
    weights (quantized by the JAX package and carried across)."""
    if kv_quant not in _MODELS:
        jt = jconfig.tiny_target_config()
        jd = jconfig.tiny_draft_config(jt, block_size=BLOCK, num_layers=1)
        jtp = jqwen3.init_params(jax.random.PRNGKey(0), jt, jnp.float32)
        jdp = jdraft.init_params(jax.random.PRNGKey(1), jd, jnp.float32)
        if kv_quant:
            jtp = jquant.quantize_target_params(jtp, jt, pad_to=64)
            jdp = jquant.quantize_draft_params(jdp, jd, pad_to=64)
        tt = tconfig.tiny_target_config()
        td = tconfig.tiny_draft_config(tt, block_size=BLOCK, num_layers=1)
        _MODELS[kv_quant] = (jt, jd, jtp, jdp, tt, td, _to_torch(jtp), _to_torch(jdp))
    return _MODELS[kv_quant]


def _prompts(R=len(PROMPT_LENS), seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 500, size=(R, 1, P_PAD)), np.asarray(PROMPT_LENS[:R])


def _jax_run(kv_quant, ids, lens, stop=(), forced=None):
    jt, jd, jtp, jdp = _models(kv_quant)[:4]
    R = ids.shape[0]
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(R, dtype=jnp.uint32))
    st = jit_batched_prefill(jtp, jdp, jnp.asarray(ids, jnp.int32), jnp.asarray(lens, jnp.int32),
                             jnp.float32(0.0), keys, tcfg=jt, dcfg=jd, total_len=TOTAL_LEN,
                             max_cycles=MAX_CYCLES, kv_quant=kv_quant)
    st = jit_batched_decode(jtp, jdp, st, jnp.asarray(lens + NEW, jnp.int32), jnp.float32(0.0), tcfg=jt,
                            dcfg=jd, block_size=BLOCK, stop_token_ids=stop, max_cycles=MAX_CYCLES,
                            forced_acc=None if forced is None else jnp.asarray(forced, jnp.int32))
    return np.asarray(st.output_ids)[:, 0], np.asarray(st.start), np.asarray(st.acc_trace)


def _port_run(kv_quant, ids, lens, stop=(), forced=None):
    tt, td, ttp, tdp = _models(kv_quant)[4:]
    st = tb.batched_prefill(ttp, tdp, ids, lens, 0.0, tcfg=tt, dcfg=td, total_len=TOTAL_LEN,
                            max_cycles=MAX_CYCLES, kv_quant=kv_quant)
    return tb.batched_decode(ttp, tdp, st, lens + NEW, 0.0, tcfg=tt, dcfg=td, block_size=BLOCK,
                             stop_token_ids=stop, max_cycles=MAX_CYCLES, forced_acc=forced)


def _assert_same(port, ref):
    out, start, trace = ref
    np.testing.assert_array_equal(port.output_ids.numpy(), out)
    np.testing.assert_array_equal(port.start.numpy(), start)
    np.testing.assert_array_equal(port.acc_trace.numpy(), trace)
    np.testing.assert_array_equal(port.host_start, start)  # the host mirrors follow the device


@pytest.mark.parametrize("kv_quant", [False, True])
def test_batched_decode_matches_dflash_tpu(kv_quant):
    """R = 3 lanes with prompt lengths 5, 16 and 9: tokens, frontiers and
    acceptance traces equal JAX's lane by lane."""
    ids, lens = _prompts()
    port = _port_run(kv_quant, ids, lens)
    _assert_same(port, _jax_run(kv_quant, ids, lens))
    assert (port.host_start >= lens + NEW).all()


@pytest.mark.parametrize("kv_quant", [False, True])
def test_batched_forced_acceptance_per_lane_matches_dflash_tpu(kv_quant):
    """A per-lane forced_acc [R, max_cycles] (with -1 entries: the real
    rule) sets each lane's tau at its own cycle, as in JAX."""
    ids, lens = _prompts()
    forced = np.asarray([[3, 0, 2, -1, 3, 1, 0, 3, 2, 1, 0, 3],
                         [0, 1, -1, -1, 3, 3, 3, 0, 0, 1, 2, 3],
                         [2, 2, 2, 2, 2, 2, -1, 0, 1, 0, 1, 0]], np.int32)
    port = _port_run(kv_quant, ids, lens, forced=forced)
    _assert_same(port, _jax_run(kv_quant, ids, lens, forced=forced))
    assert port.acc_trace[0, :3].tolist() == [4, 1, 3]


@pytest.mark.parametrize("kv_quant", [False, True])
def test_batched_stop_token_freezes_one_lane_early(kv_quant):
    """A stop token that lane 0 commits early freezes lane 0 (tokens,
    frontier, trace) while the other lanes run on; equal to JAX's."""
    ids, lens = _prompts()
    free = _port_run(kv_quant, ids, lens)
    out = free.output_ids.numpy()
    stop = int(out[0, lens[0] + 2])
    later = [out[r, lens[r]:lens[r] + NEW] for r in (1, 2)]
    if any(stop in seq for seq in later):
        pytest.fail(f"stop token {stop} also appears in the other lanes; pick another prompt seed")
    port = _port_run(kv_quant, ids, lens, stop=(stop,))
    _assert_same(port, _jax_run(kv_quant, ids, lens, stop=(stop,)))
    assert port.host_done.tolist() == [True, False, False]
    assert port.host_start[0] < free.host_start[0]
    np.testing.assert_array_equal(port.output_ids.numpy()[1:], out[1:])


def test_batched_cycle_matches_dflash_tpu():
    """One unfrozen step of every lane (batched_cycle), twice."""
    ids, lens = _prompts()
    jt, jd, jtp, jdp, tt, td, ttp, tdp = _models(False)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(3, dtype=jnp.uint32))
    js = jit_batched_prefill(jtp, jdp, jnp.asarray(ids, jnp.int32), jnp.asarray(lens, jnp.int32),
                             jnp.float32(0.0), keys, tcfg=jt, dcfg=jd, total_len=TOTAL_LEN, max_cycles=MAX_CYCLES)
    ts = tb.batched_prefill(ttp, tdp, ids, lens, 0.0, tcfg=tt, dcfg=td, total_len=TOTAL_LEN, max_cycles=MAX_CYCLES)
    for _ in range(2):
        js = jit_batched_cycle(js, jtp, jdp, jnp.float32(0.0), tcfg=jt, dcfg=jd, block_size=BLOCK,
                               stop_token_ids=())
        ts = tb.batched_cycle(ts, ttp, tdp, 0.0, tcfg=tt, dcfg=td, block_size=BLOCK, stop_token_ids=())
    _assert_same(ts, (np.asarray(js.output_ids)[:, 0], np.asarray(js.start), np.asarray(js.acc_trace)))


def test_batched_cycles_shared_forced_matches_batched_decode():
    """batched_cycles with a shared forced_acc, n_steps at a time until every
    lane is done, ends where batched_decode does with that row per lane."""
    ids, lens = _prompts()
    tt, td, ttp, tdp = _models(False)[4:]
    forced = np.asarray([3, 1, -1, 2, 0, 3, 3, 1, 2, 0, 1, 3], np.int32)
    st = tb.batched_prefill(ttp, tdp, ids, lens, 0.0, tcfg=tt, dcfg=td, total_len=TOTAL_LEN, max_cycles=MAX_CYCLES)
    for _ in range(MAX_CYCLES // 3):
        st = tb.batched_cycles(st, ttp, tdp, 0.0, lens + NEW, tcfg=tt, dcfg=td, block_size=BLOCK,
                               stop_token_ids=(), n_steps=3, forced_acc=forced)
    ref = _port_run(False, ids, lens, forced=np.broadcast_to(forced, (3, MAX_CYCLES)))
    _assert_same(st, (ref.output_ids.numpy(), ref.start.numpy(), ref.acc_trace.numpy()))


@pytest.mark.parametrize("kv_quant", [False, True])
def test_lanes_equal_the_single_request_engine(kv_quant):
    """Each lane's tokens are what SpecEngine.generate gives for its prompt
    alone; identical prompts in two lanes decode identically; the kernel
    entries count one launch per layer whatever the lanes (CPU: none)."""
    tt, td, ttp, tdp = _models(kv_quant)[4:]
    ids, lens = _prompts(3, seed=4)
    ids = np.concatenate([ids, ids[:1]])  # lane 3 repeats lane 0
    lens = np.append(lens, lens[0])
    st = _port_run(kv_quant, ids, lens)
    outs = tb.lane_outputs(st, lens, NEW, td.mask_token_id)
    eng = SpecEngine(tt, td, ttp, tdp, max_new_tokens=NEW, block_size=BLOCK, prompt_cap=P_PAD,
                     prompt_bucket=P_PAD, kv_quant=kv_quant, device="cpu")
    for r in range(len(lens)):
        single = eng.generate(ids[r, :, :lens[r]])
        np.testing.assert_array_equal(outs[r], single.output_ids)
        assert st.acc_trace[r, :len(single.acceptance_lengths)].tolist() == single.acceptance_lengths
    np.testing.assert_array_equal(outs[0], outs[3])


def test_sampled_lanes_draw_from_their_own_generators():
    """At temperature > 0 a lane's tokens depend on its own seed and prompt,
    not on its neighbours'; per-lane temperatures mix greedy and sampled
    lanes."""
    tt, td, ttp, tdp = _models(False)[4:]
    ids, lens = _prompts(2, seed=5)

    def run(keys, temps, lane_ids):
        st = tb.batched_prefill(ttp, tdp, lane_ids, lens, temps, keys, tcfg=tt, dcfg=td, total_len=TOTAL_LEN,
                                max_cycles=MAX_CYCLES)
        st = tb.batched_decode(ttp, tdp, st, lens + NEW, temps, tcfg=tt, dcfg=td, block_size=BLOCK,
                               stop_token_ids=(), max_cycles=MAX_CYCLES)
        return st.output_ids.numpy()

    a = run([5, 7], 0.9, ids)
    other = ids.copy()
    other[1] = np.random.default_rng(9).integers(1, 500, size=(1, P_PAD))
    b = run([5, 11], 0.9, other)
    np.testing.assert_array_equal(a[0], b[0])
    assert not np.array_equal(a[1], b[1])
    mixed = run([5, 7], [0.0, 0.9], ids)
    np.testing.assert_array_equal(mixed[0], run(None, 0.0, ids)[0])
    gen = mixed[1, lens[1]:lens[1] + NEW]
    assert gen.min() >= 0 and gen.max() < tt.vocab_size


def test_batched_rejects_what_is_not_ported():
    tt, td, ttp, tdp = _models(False)[4:]
    ids, lens = _prompts()
    with pytest.raises(NotImplementedError):
        tb.batched_prefill(ttp, tdp, ids, lens, 0.0, tcfg=tt, dcfg=td, total_len=TOTAL_LEN,
                           max_cycles=MAX_CYCLES, filters=object())
    with pytest.raises(NotImplementedError):
        tb.state_shardings(None)
    st = tb.batched_prefill(ttp, tdp, ids, lens, 0.0, tcfg=tt, dcfg=td, total_len=TOTAL_LEN, max_cycles=MAX_CYCLES)
    with pytest.raises(NotImplementedError):
        tb.shard_state(st, None)
    with pytest.raises(ValueError):  # an active lane would write past the buffer
        tb.batched_decode(ttp, tdp, st, lens + 40, 0.0, tcfg=tt, dcfg=td, block_size=BLOCK,
                          stop_token_ids=(), max_cycles=64)


def test_batched_counts_one_kernel_call_per_layer_whatever_the_lanes():
    """The lanes share every kernel call: on the CPU the wrappers count no
    launch, and the lane entries run once per layer (36 on Qwen3-8B) per
    verify and once per draft forward: held on the card by chip_smoke.py's
    phase 4e; here the call count through a counting stand-in."""
    tt, td, ttp, tdp = _models(False)[4:]
    calls = {"verify": 0, "prefill": 0}
    lanes_fn, prefill_fn = verify_fused.fused_ctx_block_attention_lanes, prefill_flash.flash_prefill_attention

    def count_verify(*a, **k):
        calls["verify"] += 1
        return lanes_fn(*a, **k)

    def count_prefill(*a, **k):
        calls["prefill"] += 1
        return prefill_fn(*a, **k)

    from dflash_tpu_torch.models import dflash_draft as tdraft
    from dflash_tpu_torch.models import qwen3 as tqwen3
    mp = pytest.MonkeyPatch()
    for mod in (tqwen3, tdraft):
        mp.setattr(mod, "fused_ctx_block_attention_lanes", count_verify)
    mp.setattr(tqwen3, "flash_prefill_attention", count_prefill)
    try:
        for R in (1, 3):
            calls.update(verify=0, prefill=0)
            ids, lens = _prompts(R)
            st = tb.batched_prefill(ttp, tdp, ids, lens, 0.0, tcfg=tt, dcfg=td, total_len=TOTAL_LEN,
                                    max_cycles=MAX_CYCLES)
            st = tb.batched_decode(ttp, tdp, st, lens + NEW, 0.0, tcfg=tt, dcfg=td, block_size=BLOCK,
                                   stop_token_ids=(), max_cycles=MAX_CYCLES)
            cycles = int(st.host_cycle_idx.max())
            assert calls == {"verify": cycles * (tt.num_hidden_layers + td.model.num_hidden_layers),
                             "prefill": tt.num_hidden_layers}, (R, calls, cycles)
    finally:
        mp.undo()


@pytest.mark.parametrize("quant", [False, True])
def test_cache_writes_take_one_position_per_lane(quant):
    """update_any with a [R] position tensor writes each lane's rows at its own
    position, in one indexed write, and matches JAX's update_any vmapped over
    lanes (the float cache exactly; the int8 cache quantized by the port's
    eager quantize_rows, equal to a one-lane write); a window past the
    buffer, by the host bound, raises."""
    from dflash_tpu.cache import kv as jkv
    from dflash_tpu_torch.cache import kv as tkv

    tt = _models(False)[4]
    rng = np.random.default_rng(3)
    L, R, T, S = tt.num_hidden_layers, 3, 40, 5
    k = rng.standard_normal((L, R, S, tt.num_key_value_heads, tt.head_dim)).astype(np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    pos = np.asarray([0, 17, T - S])
    init = (lambda b: tkv.init_quant_kv_cache(tt, b, T, device="cpu")) if quant else \
        (lambda b: tkv.init_kv_cache(tt, b, T, torch.float32, device="cpu"))
    lanes = tkv.update_any(init(R), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos),
                           max_pos=int(pos.max()))
    for r in range(R):
        one = tkv.update_any(init(1), torch.from_numpy(k[:, r:r + 1]), torch.from_numpy(v[:, r:r + 1]), int(pos[r]))
        for a, b in zip(lanes, one):
            assert torch.equal(a[:, r:r + 1], b)
    if not quant:
        jc = jkv.init_kv_cache(jconfig.tiny_target_config(), R, T, jnp.float32)
        upd = jax.vmap(lambda c, kk, vv, p: jkv.update_any(c, kk, vv, p), in_axes=(1, 1, 1, 0), out_axes=1)
        ref = upd(jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos, jnp.int32))
        np.testing.assert_array_equal(lanes.k.numpy(), np.asarray(ref.k))
        np.testing.assert_array_equal(lanes.v.numpy(), np.asarray(ref.v))
    with pytest.raises(ValueError):  # the host bound says a lane's window leaves the buffer
        tkv.update_any(init(R), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos + 1),
                       max_pos=int(pos.max()) + 1)
    with pytest.raises(ValueError):  # per-lane positions need their host bound
        tkv.update_any(init(R), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos))
