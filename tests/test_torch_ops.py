"""dflash_tpu_torch ops against their dflash_tpu counterparts, f32 on the CPU.

The same numpy inputs (np.random.default_rng) go through the JAX function and
the port's; tolerance atol 1e-5 (f32, sums in another order), except
``acceptance_length`` and greedy ``sample``, which must match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dflash_tpu.ops import attention as jattn
from dflash_tpu.ops import linear as jlinear
from dflash_tpu.ops import norms as jnorms
from dflash_tpu.ops import rope as jrope
from dflash_tpu.ops import sampling as jsampling
from dflash_tpu_torch.ops import attention as tattn
from dflash_tpu_torch.ops import linear as tlinear
from dflash_tpu_torch.ops import norms as tnorms
from dflash_tpu_torch.ops import rope as trope
from dflash_tpu_torch.ops import sampling as tsampling

torch.set_num_threads(2)

ATOL = 1e-5


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol, rtol=0)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, w = _f32(rng, 3, 5, 64), _f32(rng, 64)
    _close(tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("rope_scaling", [None, (8.0, 1.0, 4.0, 8192)])
def test_rope(rope_scaling):
    rng = np.random.default_rng(1)
    d = 128
    positions = rng.integers(0, 20000, size=(2, 9))
    x = _f32(rng, 2, 9, 4, d)
    jc, js = jrope.rope_cos_sin(jnp.asarray(positions), d, 500_000.0, rope_scaling)
    tc, ts = trope.rope_cos_sin(torch.from_numpy(positions), d, 500_000.0, rope_scaling)
    _close(tc, jc)
    _close(ts, js)
    np.testing.assert_allclose(
        trope._inv_freq(d, 500_000.0, rope_scaling).numpy(),
        np.asarray(jrope._inv_freq(d, 500_000.0, rope_scaling)), rtol=1e-6,
    )
    # the rotation itself, on shared tables
    jc, js = np.array(jc), np.array(js)
    _close(trope.apply_rope(torch.from_numpy(x), torch.from_numpy(jc), torch.from_numpy(js)),
           jrope.apply_rope(jnp.asarray(x), jnp.asarray(jc), jnp.asarray(js)))


@pytest.mark.parametrize("out_dtype", [None, "float32"])
def test_linear(out_dtype):
    rng = np.random.default_rng(2)
    x, w = _f32(rng, 2, 7, 64), _f32(rng, 64, 96)
    port = tlinear.linear(torch.from_numpy(x), torch.from_numpy(w),
                          getattr(torch, out_dtype) if out_dtype else None)
    ref = jlinear.linear(jnp.asarray(x), jnp.asarray(w), getattr(jnp, out_dtype) if out_dtype else None)
    assert port.dtype == torch.float32
    _close(port, ref)


@pytest.mark.parametrize("mask_rank", [2, 3])
def test_gqa_attention(mask_rank):
    rng = np.random.default_rng(3)
    B, Sq, Sk, nh, nkv, d = 2, 5, 11, 8, 2, 16
    q, k, v = _f32(rng, B, Sq, nh, d), _f32(rng, B, Sk, nkv, d), _f32(rng, B, Sk, nkv, d)
    shape = (Sq, Sk) if mask_rank == 2 else (B, Sq, Sk)
    mask = rng.random(shape) < 0.7
    mask[..., 0] = True  # every row attends something
    _close(tattn.gqa_attention(*map(torch.from_numpy, (q, k, v, mask)), 0.25),
           jattn.gqa_attention(*map(jnp.asarray, (q, k, v, mask)), 0.25))


@pytest.mark.parametrize("C,ctx_len", [(1, 0), (1, 13), (3, 20)])
def test_gqa_attention_ctx_plus_block(C, ctx_len):
    rng = np.random.default_rng(4)
    B, T, nh, nkv, d = 6, 20, 8, 2, 16
    q = _f32(rng, C, B, nh, d)
    ck, cv = _f32(rng, 1, T, nkv, d), _f32(rng, 1, T, nkv, d)
    bk, bv = _f32(rng, C, B, nkv, d), _f32(rng, C, B, nkv, d)
    ctx_mask = np.arange(T) < ctx_len
    blk_mask = np.tril(np.ones((B, B), bool))
    args = (q, ck, None, cv, None, bk, bv, ctx_mask, blk_mask)
    port = tattn.gqa_attention_quant_ctx_plus_block(
        *[None if a is None else torch.from_numpy(a) for a in args], 0.25)
    ref = jattn.gqa_attention_quant_ctx_plus_block(
        *[None if a is None else jnp.asarray(a) for a in args], 0.25)
    _close(port, ref)


def test_ctx_plus_block_rejects_int8_scales():
    """The int8 ctx is ported (held against JAX in tests/test_torch_quant.py);
    scales that do not match the cache's [1, T, n_kv] rows are rejected."""
    z = torch.zeros(1, 4, 1, 16, dtype=torch.int8)
    args = (torch.zeros(1, 2, 1, 16), torch.zeros(1, 2, 1, 16), torch.ones(4, dtype=torch.bool),
            torch.ones(2, 2, dtype=torch.bool), 0.25)
    out = tattn.gqa_attention_quant_ctx_plus_block(
        torch.zeros(1, 2, 1, 16), z, torch.ones(1, 4, 1), z, torch.ones(1, 4, 1), *args)
    assert out.shape == (1, 2, 16) and torch.isfinite(out).all()
    with pytest.raises(RuntimeError):
        tattn.gqa_attention_quant_ctx_plus_block(
            torch.zeros(1, 2, 1, 16), z, torch.ones(1, 3, 1), z, torch.ones(1, 3, 1), *args)


def test_sample_greedy():
    import jax

    logits = _f32(np.random.default_rng(5), 3, 16, 512)
    port = tsampling.sample(torch.from_numpy(logits), 0.0)
    ref = jsampling.sample(jnp.asarray(logits), 0.0, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_sample_temperature_stays_in_vocab():
    logits = torch.from_numpy(_f32(np.random.default_rng(6), 2, 4, 50))
    g = torch.Generator().manual_seed(0)
    tok = tsampling.sample(logits, 0.8, g)
    assert tok.shape == (2, 4) and int(tok.min()) >= 0 and int(tok.max()) < 50


def test_acceptance_length():
    rng = np.random.default_rng(7)
    post = rng.integers(0, 3, size=(64, 8))
    draft = np.where(rng.random((64, 7)) < 0.8, post[:, :-1], rng.integers(0, 3, size=(64, 7)))
    port = tsampling.acceptance_length(torch.from_numpy(draft), torch.from_numpy(post))
    ref = jsampling.acceptance_length(jnp.asarray(draft), jnp.asarray(post))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_rope_lane_positions():
    """The batched engine's positions [R, C, B]: each lane's block at its own
    frontier; rope_cos_sin broadcasts them and apply_rope rotates
    [R, C, B, heads, d], as JAX's functions do."""
    rng = np.random.default_rng(11)
    d, R, B = 128, 3, 16
    positions = (np.asarray([0, 700, 4077])[:, None, None] + np.arange(B)).astype(np.int64)  # [R, 1, B]
    x = _f32(rng, R, 1, B, 4, d)
    jc, js = jrope.rope_cos_sin(jnp.asarray(positions), d, 1_000_000.0)
    tc, ts = trope.rope_cos_sin(torch.from_numpy(positions), d, 1_000_000.0)
    assert tc.shape == (R, 1, B, d)
    _close(tc, jc)
    _close(ts, js)
    _close(trope.apply_rope(torch.from_numpy(x), tc, ts), jrope.apply_rope(jnp.asarray(x), jc, js))


def test_sample_per_lane_temperatures_and_generators():
    """Per-lane sampling: R host temperatures and one generator per lane.
    Greedy lanes take the argmax; a sampled lane's tokens are what a
    one-lane call with the same generator state draws, whatever its
    neighbours; all lanes greedy is one argmax."""
    logits = torch.from_numpy(_f32(np.random.default_rng(12), 3, 16, 64)) * 3
    gens = lambda: [torch.Generator().manual_seed(s) for s in (1, 2, 3)]  # noqa: E731
    mixed = tsampling.sample(logits, [0.0, 0.9, 1.3], gens())
    np.testing.assert_array_equal(mixed[0].numpy(), logits[0].argmax(-1).numpy())
    for r, (t, seed) in enumerate(((0.9, 2), (1.3, 3)), start=1):
        alone = tsampling.sample(logits[r], t, torch.Generator().manual_seed(seed))
        np.testing.assert_array_equal(mixed[r].numpy(), alone.numpy())
    other = logits.clone()
    other[0] = -other[0]  # a different neighbour leaves lane 1's draws as they were
    np.testing.assert_array_equal(tsampling.sample(other, [0.5, 0.9, 1.3], gens())[1].numpy(), mixed[1].numpy())
    np.testing.assert_array_equal(tsampling.sample(logits, [0.0, 0.0, 0.0], None).numpy(),
                                  logits.argmax(-1).numpy())


def test_acceptance_length_per_lane():
    """acceptance_length on the batched engine's [R, B] blocks: lane r's
    value is the one-lane call's, and JAX's under vmap."""
    import jax

    rng = np.random.default_rng(13)
    post = rng.integers(0, 2, size=(5, 16))
    draft = np.where(rng.random((5, 15)) < 0.9, post[:, :-1], 1 - post[:, :-1])
    port = tsampling.acceptance_length(torch.from_numpy(draft), torch.from_numpy(post))
    ref = jax.vmap(lambda a, b: jsampling.acceptance_length(a[None], b[None])[0])(jnp.asarray(draft),
                                                                                  jnp.asarray(post))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    for r in range(5):
        assert int(port[r]) == int(tsampling.acceptance_length(torch.from_numpy(draft[r:r + 1]),
                                                               torch.from_numpy(post[r:r + 1]))[0])
