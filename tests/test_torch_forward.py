"""dflash_tpu_torch's frontier-bounded verify attention and the full-buffer
``qwen3.forward(attn_impl="pallas")`` against the JAX package, and
``SpecEngine(attn_impl="pallas")`` tokens against dflash_tpu's.

The JAX side runs as its own tests run it on the CPU: ``verify_attention``
through the Pallas kernel in interpret mode (it selects that itself off the
TPU).  Inputs from numpy seeds, f32; tolerance 2e-5, the JAX kernel test's
bar (tests/test_pallas_attention.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dflash_tpu.cache.kv import init_kv_cache as j_init_kv_cache
from dflash_tpu.core import config as jconfig
from dflash_tpu.kernels.attention import verify_attention as j_verify_attention
from dflash_tpu.models import dflash_draft as jdraft
from dflash_tpu.models import qwen3 as jqwen3
from dflash_tpu.spec.engine import SpecEngine as JSpecEngine
from dflash_tpu_torch.cache.kv import KVCache, init_quant_kv_cache
from dflash_tpu_torch.convert import params_from_numpy
from dflash_tpu_torch.core.config import tiny_draft_config, tiny_target_config
from dflash_tpu_torch.kernels import attention
from dflash_tpu_torch.models import qwen3
from dflash_tpu_torch.spec.engine import SpecEngine

torch.set_num_threads(2)
ATOL = 2e-5


def _attn_inputs(seed, B, nh, n_kv, d, T):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(1, B, nh, d), f(1, T, n_kv, d), f(1, T, n_kv, d)


def _jax_verify(q, k, v, start, B, ck=128):
    return np.asarray(j_verify_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(start),
                                         block=B, ck=ck, interpret=True))


@pytest.mark.parametrize("start", [0, 3, 100, 112])
def test_verify_attention_plain_matches_pallas(start):
    B = 8
    q, k, v = _attn_inputs(0, B, 8, 4, 128, 256)
    want = _jax_verify(q, k, v, start, B)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = attention.plain(*t, start, B)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # the wrapper takes the plain version for CPU tensors, without counting a launch
    before = attention.verify_attention.launches
    assert torch.equal(attention.verify_attention(*t, start, B), got)
    assert attention.verify_attention.launches == before


def test_verify_attention_ignores_rows_beyond_frontier():
    """NaN and huge K/V past start + B change nothing, bit for bit."""
    B, start = 4, 60
    q, k, v = _attn_inputs(1, B, 4, 2, 128, 256)
    k2, v2 = k.copy(), v.copy()
    k2[:, start + B:] = 1e9
    v2[:, start + B:] = np.nan
    clean = attention.plain(*(torch.from_numpy(a) for a in (q, k, v)), start, B)
    dirty = attention.plain(*(torch.from_numpy(a) for a in (q, k2, v2)), start, B)
    assert torch.isfinite(dirty).all()
    assert torch.equal(clean, dirty)
    np.testing.assert_allclose(dirty.numpy(), _jax_verify(q, k, v, start, B), atol=ATOL, rtol=0)


def test_verify_attention_checks_its_window():
    q, k, v = (torch.from_numpy(a) for a in _attn_inputs(2, 4, 4, 2, 64, 32))
    with pytest.raises(ValueError):
        attention.verify_attention(q, k, v, 29, 4)  # rows 29..32 run past T = 32
    with pytest.raises(ValueError):
        attention.verify_attention(q, k, v, 3, 5)  # block != q rows
    with pytest.raises(ValueError):
        attention.verify_attention(q.to("meta"), k.to("meta"), v.to("meta"), 3, 4)


@pytest.fixture(scope="module")
def target():
    """JAX tiny target params and the same weights in the port."""
    jcfg = jconfig.tiny_target_config()
    jp = jqwen3.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tiny_target_config(), tp


@pytest.mark.parametrize("S,write_pos", [(8, 20), (1, 37), (4, 0)])
def test_forward_pallas_matches_jax(target, S, write_pos):
    """hidden, taps, and the cache rows the forward writes at write_pos (the
    rest of the cache untouched), on converted weights and a cache that
    already holds random rows."""
    jcfg, jp, tcfg, tp = target
    T, taps = 128, (1, 3)
    rng = np.random.default_rng(write_pos)
    shape = (tcfg.num_hidden_layers, 1, T, tcfg.num_key_value_heads, tcfg.head_dim)
    k0, v0 = rng.standard_normal(shape).astype(np.float32), rng.standard_normal(shape).astype(np.float32)
    ids = rng.integers(1, tcfg.vocab_size - 1, size=(1, S))
    pos = write_pos + np.arange(S)[None, :]

    jkv = j_init_kv_cache(jcfg, 1, T, jnp.float32)._replace(k=jnp.asarray(k0), v=jnp.asarray(v0))
    jpos = jnp.asarray(pos, jnp.int32)
    want = jqwen3.forward(jp, jcfg, jqwen3.embed(jp, jnp.asarray(ids)), jpos, jkv, jnp.int32(write_pos),
                          jqwen3.causal_mask(jpos[0], T), tap_ids=taps, attn_impl="pallas")

    kv = KVCache(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))
    got = qwen3.forward(tp, tcfg, qwen3.embed(tp, torch.from_numpy(ids)), torch.from_numpy(pos), kv,
                        write_pos, None, tap_ids=taps, attn_impl="pallas")
    assert got.kv is kv
    np.testing.assert_allclose(got.hidden.numpy(), np.asarray(want.hidden), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.taps.numpy(), np.asarray(want.taps), atol=ATOL, rtol=0)
    rows = slice(write_pos, write_pos + S)
    np.testing.assert_allclose(kv.k[:, :, rows].numpy(), np.asarray(want.kv.k)[:, :, rows], atol=ATOL, rtol=0)
    np.testing.assert_allclose(kv.v[:, :, rows].numpy(), np.asarray(want.kv.v)[:, :, rows], atol=ATOL, rtol=0)
    outside = np.ones(T, bool)
    outside[rows] = False
    np.testing.assert_array_equal(kv.k[:, :, outside].numpy(), k0[:, :, outside])
    np.testing.assert_array_equal(kv.v[:, :, outside].numpy(), v0[:, :, outside])


def test_forward_refuses_what_it_does_not_take(target):
    _, _, tcfg, tp = target
    ids = torch.ones((2, 4), dtype=torch.long)
    pos = torch.arange(4)[None, :]
    kv = KVCache(*(torch.zeros(tcfg.num_hidden_layers, 2, 128, tcfg.num_key_value_heads, tcfg.head_dim)
                   for _ in range(2)))
    with pytest.raises(ValueError):  # batch 2
        qwen3.forward(tp, tcfg, qwen3.embed(tp, ids), pos.expand(2, 4), kv, 0, None, attn_impl="pallas")
    qkv = init_quant_kv_cache(tcfg, 1, 128, device="cpu")
    with pytest.raises(ValueError):  # int8 cache
        qwen3.forward(tp, tcfg, qwen3.embed(tp, ids[:1]), pos, qkv, 0, None, attn_impl="pallas")
    for impl in ("xla", "bucketed", "fused"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            qwen3.forward(tp, tcfg, qwen3.embed(tp, ids[:1]), pos, kv, 0, None, attn_impl=impl)


@pytest.mark.parametrize("block_size,prompt_len,stop", [(4, 17, ()), (8, 9, tuple(range(0, 128)))])
def test_pallas_engine_tokens_match_dflash_tpu(block_size, prompt_len, stop):
    """SpecEngine(attn_impl="pallas"): generate and ar_generate equal
    dflash_tpu's pallas engine token for token on the same weights, and the
    port's default ("xla") engine."""
    kw = dict(max_new_tokens=16, block_size=block_size, prompt_cap=32, prompt_bucket=16,
              stop_token_ids=stop)
    jt = jconfig.tiny_target_config()
    jd = jconfig.tiny_draft_config(jt, block_size=block_size, num_layers=2)
    jtp = jqwen3.init_params(jax.random.PRNGKey(0), jt, jnp.float32)
    jdp = jdraft.init_params(jax.random.PRNGKey(1), jd, jnp.float32)
    jeng = JSpecEngine(jt, jd, jtp, jdp, attn_impl="pallas", **kw)
    tt = tiny_target_config()
    td = tiny_draft_config(tt, block_size=block_size, num_layers=2)
    to_t = lambda p: params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")  # noqa: E731
    tp, dp = to_t(jtp), to_t(jdp)
    teng = SpecEngine(tt, td, tp, dp, device="cpu", attn_impl="pallas", **kw)
    assert teng.total_len == jeng.total_len == 512

    prompt = np.random.default_rng(11).integers(1, jt.vocab_size - 2, size=(1, prompt_len))
    js, ts = jeng.generate(prompt), teng.generate(prompt)
    np.testing.assert_array_equal(ts.output_ids, js.output_ids)
    assert ts.acceptance_lengths == js.acceptance_lengths
    np.testing.assert_array_equal(teng.ar_generate(prompt).output_ids, jeng.ar_generate(prompt).output_ids)
    default = SpecEngine(tt, td, tp, dp, device="cpu", **kw)
    np.testing.assert_array_equal(default.generate(prompt).output_ids, ts.output_ids)


def test_pallas_engine_refuses_the_int8_cache():
    tcfg = tiny_target_config()
    dcfg = tiny_draft_config(tcfg, num_layers=1)
    params = {"final_norm": torch.ones(tcfg.hidden_size)}
    with pytest.raises(ValueError):
        SpecEngine(tcfg, dcfg, params, params, max_new_tokens=4, attn_impl="pallas", kv_quant=True,
                   device="cpu")
