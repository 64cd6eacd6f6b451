"""dflash_tpu_torch models against dflash_tpu on the same f32 weights (JAX
init, carried across by dflash_tpu_torch.convert), on the CPU.

Two configs: the tiny test config (head_dim 16, the XLA attention path in
JAX) and a 2-layer head_dim-128 config, where JAX runs its Pallas kernels
(attn_impl "flash" / "fused") in interpret mode.  Tolerance atol 1e-4 (f32
through several layers, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dflash_tpu.cache.kv import KVCache as JKVCache
from dflash_tpu.core import config as jconfig
from dflash_tpu.models import dflash_draft as jdraft
from dflash_tpu.models import qwen3 as jqwen3
from dflash_tpu_torch.cache.kv import KVCache as TKVCache
from dflash_tpu_torch.convert import params_from_numpy
from dflash_tpu_torch.core import config as tconfig
from dflash_tpu_torch.models import dflash_draft as tdraft
from dflash_tpu_torch.models import qwen3 as tqwen3

torch.set_num_threads(2)

ATOL = 1e-4
CONFIGS = {
    "tiny": (dict(), 2),
    "d128": (dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
                  head_dim=128, num_hidden_layers=2), 1),
}


def _models(name):
    kw, draft_layers = CONFIGS[name]
    jt = jconfig.tiny_target_config(**kw)
    jd = jconfig.tiny_draft_config(jt, block_size=16, num_layers=draft_layers)
    tt = tconfig.tiny_target_config(**kw)
    td = tconfig.tiny_draft_config(tt, block_size=16, num_layers=draft_layers)
    assert td == tconfig.DraftConfig(**{**jd.__dict__, "model": tconfig.ModelConfig(**jd.model.__dict__)})
    jtp = jqwen3.init_params(jax.random.PRNGKey(0), jt, jnp.float32)
    jdp = jdraft.init_params(jax.random.PRNGKey(1), jd, jnp.float32)
    to_t = lambda p: params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")  # noqa: E731
    return jt, jd, jtp, jdp, tt, td, to_t(jtp), to_t(jdp)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_prefill(name):
    jt, _, jtp, _, tt, _, ttp, _ = _models(name)
    S = 128
    ids = np.random.default_rng(0).integers(1, jt.vocab_size - 2, (1, S))
    pos = np.arange(S)[None, :]
    taps = (1, 0)  # tap order is the concatenation order
    ref = jqwen3.forward_prefill(
        jtp, jt, jqwen3.embed(jtp, jnp.asarray(ids)), jnp.asarray(pos), tap_ids=taps,
        attn_impl="flash" if jt.head_dim == 128 else "xla",
    )
    port = tqwen3.forward_prefill(
        ttp, tt, tqwen3.embed(ttp, torch.from_numpy(ids)), torch.from_numpy(pos), tap_ids=taps)
    for field in ("hidden", "taps", "k", "v"):
        _close(getattr(port, field), getattr(ref, field))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_block_candidates(name):
    jt, _, jtp, _, tt, _, ttp, _ = _models(name)
    rng = np.random.default_rng(1)
    T, B, ctx_len = 256, 16, 100
    L, nkv, d, H = jt.num_hidden_layers, jt.num_key_value_heads, jt.head_dim, jt.hidden_size
    ck, cv = _rand(rng, L, 1, T, nkv, d), _rand(rng, L, 1, T, nkv, d)
    emb = _rand(rng, 1, B, H)
    pos = (ctx_len + np.arange(B))[None, :]
    ref = jqwen3.forward_block_candidates(
        jtp, jt, jnp.asarray(emb), jnp.asarray(pos), JKVCache(jnp.asarray(ck), jnp.asarray(cv)),
        jnp.int32(ctx_len), tap_ids=(0,), attn_impl="fused" if d == 128 else "xla",
    )
    port = tqwen3.forward_block_candidates(
        ttp, tt, torch.from_numpy(emb), torch.from_numpy(pos),
        TKVCache(torch.from_numpy(ck), torch.from_numpy(cv)), ctx_len, tap_ids=(0,),
    )
    for field in ("hidden", "taps", "blk_k", "blk_v"):
        _close(getattr(port, field), getattr(ref, field))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_draft_append_ctx_and_forward(name):
    jt, jd, jtp, jdp, tt, td, ttp, tdp = _models(name)
    rng = np.random.default_rng(2)
    T, S, B = 256, 37, 16
    m = td.model
    shape = (m.num_hidden_layers, 1, T, m.num_key_value_heads, m.head_dim)
    feats = _rand(rng, 1, S, td.num_taps * m.hidden_size)
    pos = np.arange(S)[None, :]
    jcache = jdraft.append_ctx(
        jdp, jd, JKVCache(jnp.zeros(shape), jnp.zeros(shape)), jnp.asarray(feats),
        jnp.asarray(pos), jnp.int32(0),
    )
    tcache = tdraft.append_ctx(
        tdp, td, TKVCache(torch.zeros(shape), torch.zeros(shape)), torch.from_numpy(feats),
        torch.from_numpy(pos), 0,
    )
    _close(tcache.k, jcache.k)
    _close(tcache.v, jcache.v)

    noise = _rand(rng, 1, B, m.hidden_size)
    bpos = (S + np.arange(B))[None, :]
    ref = jdraft.forward(jdp, jd, jnp.asarray(noise), jnp.asarray(bpos), jcache, jnp.int32(S))
    port = tdraft.forward(tdp, td, torch.from_numpy(noise), torch.from_numpy(bpos), tcache, S)
    _close(port, ref)
    # the draft's logits through the target lm_head, as the engine takes them
    _close(tqwen3.lm_head(ttp, port), jqwen3.lm_head(jtp, ref))


# ---------------------------------------------------------------------------
# lanes: the batched engine's forms (R requests, each at its own frontier)
# ---------------------------------------------------------------------------

LANE_STARTS = (0, 100, 240)  # one frontier per lane


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_prefill_lanes(name):
    """R = 3 prompts of one bucket in one forward: each lane's hidden states,
    taps and K/V equal JAX's forward_prefill on that lane alone."""
    jt, _, jtp, _, tt, _, ttp, _ = _models(name)
    R, S = len(LANE_STARTS), 128
    ids = np.random.default_rng(3).integers(1, jt.vocab_size - 2, (R, S))
    pos = np.arange(S)[None, :]
    port = tqwen3.forward_prefill(ttp, tt, tqwen3.embed(ttp, torch.from_numpy(ids)), torch.from_numpy(pos),
                                  tap_ids=(1, 0))
    for r in range(R):
        ref = jqwen3.forward_prefill(
            jtp, jt, jqwen3.embed(jtp, jnp.asarray(ids[r:r + 1])), jnp.asarray(pos), tap_ids=(1, 0),
            attn_impl="flash" if jt.head_dim == 128 else "xla")
        for field in ("hidden", "taps"):
            _close(getattr(port, field)[r:r + 1], getattr(ref, field))
        for field in ("k", "v"):
            _close(getattr(port, field)[:, r:r + 1], getattr(ref, field))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_block_candidates_lanes(name):
    """R = 3 lanes, each over its own cache lane [layers, R, T, ...] below its
    own frontier (an int32 tensor): embeds [R, C, B, H] give hidden / taps
    [R, C, B, ...] and block K/V [L, R, C, B, ...], each lane equal to JAX's
    forward_block_candidates on that lane's cache and frontier."""
    jt, _, jtp, _, tt, _, ttp, _ = _models(name)
    rng = np.random.default_rng(4)
    R, T, B = len(LANE_STARTS), 256, 16
    L, nkv, d, H = jt.num_hidden_layers, jt.num_key_value_heads, jt.head_dim, jt.hidden_size
    ck, cv = _rand(rng, L, R, T, nkv, d), _rand(rng, L, R, T, nkv, d)
    emb = _rand(rng, R, 1, B, H)
    starts = np.asarray(LANE_STARTS, np.int32)
    pos = starts[:, None, None] + np.arange(B)
    port = tqwen3.forward_block_candidates(
        ttp, tt, torch.from_numpy(emb), torch.from_numpy(pos), TKVCache(torch.from_numpy(ck), torch.from_numpy(cv)),
        torch.from_numpy(starts), tap_ids=(0,), max_start=int(starts.max()))
    assert port.blk_k.shape == (L, R, 1, B, nkv, d)
    for r, s in enumerate(LANE_STARTS):
        ref = jqwen3.forward_block_candidates(
            jtp, jt, jnp.asarray(emb[r]), jnp.asarray(pos[r]),
            JKVCache(jnp.asarray(ck[:, r:r + 1]), jnp.asarray(cv[:, r:r + 1])), jnp.int32(s), tap_ids=(0,),
            attn_impl="fused" if d == 128 else "xla")
        for field in ("hidden", "taps"):
            _close(getattr(port, field)[r], getattr(ref, field))
        for field in ("blk_k", "blk_v"):
            _close(getattr(port, field)[:, r], getattr(ref, field))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_draft_lanes(name):
    """The draft with R = 3 lanes: append_ctx writes each lane's window at its
    own position (a [R] tensor), and forward attends each lane's ctx below
    its own frontier; each lane equal to JAX's on that lane alone."""
    jt, jd, jtp, jdp, tt, td, ttp, tdp = _models(name)
    rng = np.random.default_rng(5)
    R, T, S, B = len(LANE_STARTS), 256, 16, 16
    m = td.model
    shape = (m.num_hidden_layers, R, T, m.num_key_value_heads, m.head_dim)
    base = _rand(rng, *shape), _rand(rng, *shape)
    feats = _rand(rng, R, S, td.num_taps * m.hidden_size)
    w0 = np.maximum(np.asarray(LANE_STARTS) - S, 0).astype(np.int32)  # the window ending at each frontier
    wpos = w0[:, None] + np.arange(S)
    tcache = tdraft.append_ctx(tdp, td, TKVCache(*(torch.from_numpy(a.copy()) for a in base)),
                               torch.from_numpy(feats), torch.from_numpy(wpos), torch.from_numpy(w0),
                               max_pos=int(w0.max()))
    noise = _rand(rng, R, B, m.hidden_size)
    starts = np.asarray(LANE_STARTS, np.int32)
    bpos = starts[:, None] + np.arange(B)
    port = tdraft.forward(tdp, td, torch.from_numpy(noise), torch.from_numpy(bpos), tcache,
                          torch.from_numpy(starts), max_start=int(starts.max()))
    for r, s in enumerate(LANE_STARTS):
        jcache = jdraft.append_ctx(
            jdp, jd, JKVCache(jnp.asarray(base[0][:, r:r + 1]), jnp.asarray(base[1][:, r:r + 1])),
            jnp.asarray(feats[r:r + 1]), jnp.asarray(wpos[r:r + 1]), jnp.int32(w0[r]))
        _close(tcache.k[:, r:r + 1], jcache.k)
        _close(tcache.v[:, r:r + 1], jcache.v)
        ref = jdraft.forward(jdp, jd, jnp.asarray(noise[r:r + 1]), jnp.asarray(bpos[r:r + 1]), jcache, jnp.int32(s))
        _close(port[r:r + 1], ref)
