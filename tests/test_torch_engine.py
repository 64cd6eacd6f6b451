"""dflash_tpu_torch's SpecEngine on the CPU: the repo's oracle cases
(tests/test_parity.py) run on the port, and the port's tokens against
dflash_tpu's on the same f32 tiny weights.

At temperature 0 the speculative decode must emit exactly the autoregressive
decode's tokens, for any draft: every committed token is the target's own
greedy choice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dflash_tpu.core import config as jconfig
from dflash_tpu.models import dflash_draft as jdraft
from dflash_tpu.models import qwen3 as jqwen3
from dflash_tpu.spec.engine import SpecEngine as JSpecEngine
from dflash_tpu_torch import spec_generate
from dflash_tpu_torch.convert import params_from_numpy
from dflash_tpu_torch.core.config import tiny_draft_config, tiny_target_config
from dflash_tpu_torch.models import dflash_draft, qwen3
from dflash_tpu_torch.spec.engine import SpecEngine

torch.set_num_threads(2)


def _params(tcfg, dcfg):
    return (qwen3.init_params(0, tcfg, torch.float32, device="cpu"),
            dflash_draft.init_params(1, dcfg, torch.float32, device="cpu"))


def _make_engine(block_size=8, max_new_tokens=24, stop_token_ids=()):
    tcfg = tiny_target_config()
    dcfg = tiny_draft_config(tcfg, block_size=block_size, num_layers=2)
    t_params, d_params = _params(tcfg, dcfg)
    return SpecEngine(
        tcfg, dcfg, t_params, d_params,
        max_new_tokens=max_new_tokens, block_size=block_size,
        prompt_cap=64, prompt_bucket=16, stop_token_ids=stop_token_ids, device="cpu",
    )


@pytest.mark.parametrize("block_size", [4, 8])
@pytest.mark.parametrize("prompt_len", [3, 16, 17])
def test_spec_matches_ar_greedy(block_size, prompt_len):
    engine = _make_engine(block_size=block_size)
    prompt = np.random.default_rng(7).integers(0, engine.tcfg.vocab_size - 2, size=(1, prompt_len))
    spec = engine.generate(prompt, temperature=0.0)
    ar = engine.ar_generate(prompt, temperature=0.0)
    assert spec.num_output_tokens == ar.num_output_tokens
    assert spec.num_output_tokens >= engine.max_new_tokens - 4
    np.testing.assert_array_equal(spec.output_ids, ar.output_ids)
    assert sum(spec.acceptance_lengths) >= spec.num_output_tokens - 1
    assert all(1 <= t <= block_size for t in spec.acceptance_lengths)


def test_spec_matches_ar_with_stop_tokens():
    engine = _make_engine(block_size=4, max_new_tokens=32, stop_token_ids=tuple(range(0, 256)))
    prompt = np.random.default_rng(3).integers(0, engine.tcfg.vocab_size - 2, size=(1, 5))
    spec = engine.generate(prompt, temperature=0.0)
    ar = engine.ar_generate(prompt, temperature=0.0)
    np.testing.assert_array_equal(spec.output_ids, ar.output_ids)
    assert spec.num_output_tokens < 32  # actually stopped early
    assert int(spec.output_ids[0, -1]) in range(0, 256)


def test_acceptance_trace_covers_the_generation():
    """tau never exceeds the block and the trace sums to at least the
    generated length (the first token comes from the prefill)."""
    engine = _make_engine(block_size=8, max_new_tokens=16)
    spec = engine.generate(np.arange(4)[None, :], temperature=0.0)
    assert sum(spec.acceptance_lengths) + 1 >= spec.num_output_tokens
    assert all(1 <= t <= 8 for t in spec.acceptance_lengths)


def test_forced_acceptance_commits_the_forced_lengths():
    """forced_acc (the benchmark's tau emulation) sets each cycle's tau."""
    engine = _make_engine(block_size=8, max_new_tokens=40)
    prompt = np.asarray([[5, 6, 7]])
    forced = np.asarray([7, 3, 0, 7, 5])
    out = engine.generate(prompt, temperature=0.0, forced_acc=forced)
    assert out.acceptance_lengths[:5] == [8, 4, 1, 8, 6]


def test_sampling_temperature_spec_runs_and_stays_in_vocab():
    engine = _make_engine(block_size=4, max_new_tokens=12)
    out = engine.generate(np.asarray([[1, 2, 3]]), temperature=0.8, seed=123)
    assert out.num_output_tokens == 12
    gen = out.output_ids[0, out.num_input_tokens:]
    assert gen.min() >= 0 and gen.max() < engine.tcfg.vocab_size


def test_prompt_bucketing_does_not_change_output():
    tcfg = tiny_target_config()
    dcfg = tiny_draft_config(tcfg, block_size=4, num_layers=2)
    t_params, d_params = _params(tcfg, dcfg)
    outs = []
    for bucket in (8, 32):
        e = SpecEngine(tcfg, dcfg, t_params, d_params, max_new_tokens=10,
                       prompt_cap=64, prompt_bucket=bucket, device="cpu")
        outs.append(e.generate(np.asarray([[5, 6, 7, 8, 9]]), temperature=0.0).output_ids)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_spec_generate_api_matches_engine():
    tcfg = tiny_target_config()
    dcfg = tiny_draft_config(tcfg, block_size=8, num_layers=1)
    t_params, d_params = _params(tcfg, dcfg)
    prompt = np.random.default_rng(5).integers(0, tcfg.vocab_size - 2, size=(1, 7))
    res = spec_generate(t_params, d_params, tcfg, dcfg, prompt, max_new_tokens=16, device="cpu")
    ref = SpecEngine(tcfg, dcfg, t_params, d_params, max_new_tokens=16, prompt_cap=128,
                     prompt_bucket=128, device="cpu").generate(prompt, temperature=0.0)
    np.testing.assert_array_equal(res.output_ids, ref.output_ids)


def test_unported_options_raise():
    engine = _make_engine()
    with pytest.raises(NotImplementedError):
        SpecEngine(engine.tcfg, engine.dcfg, engine.t_params, engine.d_params,
                   max_new_tokens=4, prefill_chunk=16, device="cpu")
    with pytest.raises(NotImplementedError):
        SpecEngine(engine.tcfg, engine.dcfg, engine.t_params, engine.d_params,
                   max_new_tokens=4, attn_impl="fused", device="cpu")
    # top-k / top-p are ported (tests/test_torch_sampling.py); a top_k wider
    # than the engine's exact pool is refused, as in dflash_tpu
    with pytest.raises(ValueError):
        engine.generate(np.asarray([[1, 2]]), temperature=1.0, top_k=engine.topk_pool + 1)
    # kv_quant is ported (tests/test_torch_quant.py)
    assert SpecEngine(engine.tcfg, engine.dcfg, engine.t_params, engine.d_params,
                      max_new_tokens=4, kv_quant=True, device="cpu").kv_quant


@pytest.mark.parametrize("block_size,prompt_len,stop", [(8, 9, ()), (4, 16, tuple(range(0, 128)))])
def test_tokens_match_dflash_tpu(block_size, prompt_len, stop):
    """The port and the JAX package emit the same tokens on the same weights,
    for generate and ar_generate."""
    kw = dict(max_new_tokens=20, block_size=block_size, prompt_cap=64, prompt_bucket=16,
              stop_token_ids=stop)
    jt = jconfig.tiny_target_config()
    jd = jconfig.tiny_draft_config(jt, block_size=block_size, num_layers=2)
    jtp = jqwen3.init_params(jax.random.PRNGKey(0), jt, jnp.float32)
    jdp = jdraft.init_params(jax.random.PRNGKey(1), jd, jnp.float32)
    jeng = JSpecEngine(jt, jd, jtp, jdp, **kw)
    tt = tiny_target_config()
    td = tiny_draft_config(tt, block_size=block_size, num_layers=2)
    to_t = lambda p: params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")  # noqa: E731
    teng = SpecEngine(tt, td, to_t(jtp), to_t(jdp), device="cpu", **kw)

    prompt = np.random.default_rng(11).integers(0, jt.vocab_size - 2, size=(1, prompt_len))
    js, ts = jeng.generate(prompt), teng.generate(prompt)
    np.testing.assert_array_equal(ts.output_ids, js.output_ids)
    assert ts.acceptance_lengths == js.acceptance_lengths
    np.testing.assert_array_equal(teng.ar_generate(prompt).output_ids, jeng.ar_generate(prompt).output_ids)
