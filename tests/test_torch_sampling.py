"""dflash_tpu_torch's filtered sampling against the JAX package: the
``filter_stats`` plain version against ``filter_stats_xla``, the exact
top-k / top-p keep masks against JAX's and against a full-sort reference,
``sample_topk_topp``'s guarantees, and filtered ``SpecEngine`` requests.

Inputs come from numpy seeds and go through both packages at f32.
Tolerances: counts and keep masks exact; ``mass_gt`` and ``lse`` within
1e-6 (f32 sums of up to 4096 terms taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dflash_tpu.core import config as jconfig
from dflash_tpu.kernels.filter_stats import filter_stats_xla
from dflash_tpu.models import dflash_draft as jdraft
from dflash_tpu.models import qwen3 as jqwen3
from dflash_tpu.ops import sampling as jsampling
from dflash_tpu.spec.engine import SpecEngine as JSpecEngine
from dflash_tpu_torch import spec_generate
from dflash_tpu_torch.convert import params_from_numpy
from dflash_tpu_torch.core.config import tiny_draft_config, tiny_target_config
from dflash_tpu_torch.kernels import filter_stats as fs
from dflash_tpu_torch.ops import sampling
from dflash_tpu_torch.spec.engine import SpecEngine

torch.set_num_threads(2)

UMAX = 0xFFFFFFFF


def _stats_inputs(case: str):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((5, 4096)) * 3.0).astype(np.float32)
    if case == "ties":
        x[:, :300] = 1.25  # a 300-way tie, and thresholds on it
        x[:, 300:310] = -0.5
    bits = np.asarray(jsampling._float_bits_ordered(jnp.asarray(x))).astype(np.int64)
    cols = rng.integers(0, x.shape[1], size=(x.shape[0], 16))
    thr = np.take_along_axis(bits, cols, axis=1)  # thresholds on the rows' own values
    if case == "ties":
        thr[:, :4] = bits[:, [0, 0, 300, 305]]
    if case == "edges":
        thr[:, 0] = UMAX
        thr[:, 1] = bits.min(axis=1) - 1  # below the row minimum: counts V, mass 1
        thr[:, 2] = 0
        thr[:, 3] = bits.max(axis=1)
        thr[:, 4] = thr[:, 3] + 1
    return x, thr


@pytest.mark.parametrize("case", ["random", "ties", "edges"])
def test_filter_stats_plain_matches_xla(case):
    x, thr = _stats_inputs(case)
    ref = filter_stats_xla(jnp.asarray(x), jnp.asarray(thr.astype(np.uint32)), thr.shape[1])
    got = fs.plain(torch.from_numpy(x), torch.from_numpy(thr))
    for i in (0, 1):  # count_ge, count_gt
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))
    for i in (2, 3):  # mass_gt, lse
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))
    if case == "edges":
        V = x.shape[1]
        assert (got[0][:, 0] <= 1).all() and (got[1][:, 0] == 0).all()
        assert (got[0][:, 1] == V).all() and (got[1][:, 1] == V).all()
        np.testing.assert_allclose(got[2][:, 1].numpy(), 1.0, atol=1e-6)


def test_filter_stats_folds_leading_axes_and_broadcasts_thresholds():
    """The dispatch flattens x's leading axes into rows and broadcasts the
    thresholds over them (JAX's vmap folding), on the CPU through the plain
    version without counting a launch."""
    x, thr = _stats_inputs("random")
    x3 = torch.from_numpy(x[:4]).reshape(2, 2, -1)
    t1 = torch.from_numpy(thr[0])  # one threshold row for every row
    before = fs.filter_stats.launches
    got = fs.filter_stats(x3, t1)
    assert fs.filter_stats.launches == before
    ref = fs.plain(x3.reshape(4, -1), t1.broadcast_to(4, t1.shape[0]))
    assert got[0].shape == (2, 2, 16) and got[3].shape == (2, 2)
    for g, r in zip(got, ref):
        assert torch.equal(g.reshape(r.shape), r)
    with pytest.raises(ValueError):
        fs.filter_stats(x3, torch.zeros(65, dtype=torch.int64))
    with pytest.raises(ValueError):
        fs.filter_stats(x3.to("meta"), t1.to("meta"))


def test_ordered_bits_match_jax_and_invert():
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.standard_normal(1000).astype(np.float32) * 50,
                        np.asarray([0.0, -0.0, 1e-38, -1e-38, 3e38, -3e38], np.float32)])
    got = sampling._float_bits_ordered(torch.from_numpy(x))
    want = np.asarray(jsampling._float_bits_ordered(jnp.asarray(x))).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(sampling._bits_to_float(got).view(torch.int32), torch.from_numpy(x).view(torch.int32))
    order = np.argsort(x, kind="stable")
    step = np.diff(got.numpy()[order])
    same = np.diff(x[order]) == 0  # 0.0 and -0.0 compare equal as floats; the bits order -0.0 first
    assert (step[~same] > 0).all()


def _full_sort_keep(logits: np.ndarray, temp: float, k: int, p: float) -> np.ndarray:
    """Ground truth keep set from a full-vocab f64 sort (the JAX test's
    ``_full_sort_masked_logits``): rank < k AND mass before the token < p."""
    scaled = np.asarray(logits, np.float64) / max(temp, 1e-5)
    keep = np.zeros(scaled.shape, bool)
    V = scaled.shape[-1]
    k_eff = V if k <= 0 else min(k, V)
    for b in range(scaled.shape[0]):
        order = np.argsort(-scaled[b], kind="stable")
        svals = scaled[b][order]
        probs = np.exp(svals - (np.max(svals) + np.log(np.sum(np.exp(svals - np.max(svals))))))
        cum_before = np.cumsum(probs) - probs
        keep[b][order[(np.arange(V) < k_eff) & (cum_before < p)]] = True
    return keep


_jax_filtered = jax.jit(jsampling.filtered_logits_topk_topp, static_argnums=(4,))


@pytest.mark.parametrize("pool", [8, 64])
@pytest.mark.parametrize("top_k", [0, 1, 5, 128, 1024])
def test_keep_mask_matches_jax_and_full_sort(pool, top_k):
    """At V = 4096 the port's keep set equals JAX's exactly and the full-sort
    reference's; pool 8 with k >= 128 goes through the bisection rounds."""
    logits = (np.random.default_rng(3).standard_normal((4, 4096)) * 3.0).astype(np.float32)
    temp = 0.8
    passes = []

    def stats(x, thr):
        passes.append(thr.shape[-1])
        return fs.plain(x, thr)

    for p in (1.0, 0.98, 0.9):
        want = np.asarray(_jax_filtered(jnp.asarray(logits), jnp.float32(temp), jnp.int32(top_k),
                                        jnp.float32(p), pool))
        passes.clear()
        got = sampling.filtered_logits_topk_topp(torch.from_numpy(logits), temp, top_k, p, pool,
                                                 stats=stats).numpy()
        assert passes[0] == 2 * min(sampling.REPAIR_W, pool)
        assert all(t == 2 * sampling.REFINE_W for t in passes[1:])
        if pool == 8 and top_k >= 128:
            assert len(passes) > 1  # refinement rounds ran
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=f"k={top_k} p={p}")
        np.testing.assert_array_equal(got[np.isfinite(got)], want[np.isfinite(want)])
        np.testing.assert_array_equal(np.isfinite(got), _full_sort_keep(logits, temp, top_k, p))


def test_keep_mask_ties_and_wide_nucleus():
    """Ties straddling rank k keep every tied token; a p = 0.9 nucleus wider
    than the pool is found through the full-row masses (the JAX tests'
    cases)."""
    v = np.full((1, 512), -10.0, np.float32)
    v[0, :8] = 2.0
    got = sampling.filtered_logits_topk_topp(torch.from_numpy(v), 1.0, 4, 1.0, 64)
    assert torch.isfinite(got[0, :8]).all() and not torch.isfinite(got[0, 8:]).any()
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(1, 2048)) * 0.01).astype(np.float32)
    w[0, :4] += 5.0
    got = torch.isfinite(sampling.filtered_logits_topk_topp(torch.from_numpy(w), 1.0, 0, 0.9, 64)).numpy()
    want = _full_sort_keep(w, 1.0, 0, 0.9)
    assert want.sum() > 64
    np.testing.assert_array_equal(got, want)


def _logits(batch, vocab=128, seed=0):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal((batch, vocab)) * 3.0)
                            .astype(np.float32))


def test_sample_topk_topp_is_argmax_when_greedy_or_top_k_one():
    logits = _logits(4)
    argmax = logits.argmax(-1)
    assert torch.equal(sampling.sample_topk_topp(logits, 0.0, None, 5, 0.5), argmax)
    for seed in range(5):
        g = torch.Generator().manual_seed(seed)
        assert torch.equal(sampling.sample_topk_topp(logits, 5.0, g, 1, 1.0), argmax)
        # a tiny nucleus keeps the first token only
        assert torch.equal(sampling.sample_topk_topp(logits, 1.0, g, 0, 1e-6), argmax)


def test_noop_filters_match_sample_bitwise():
    logits = _logits(8)
    for seed in range(5):
        base = sampling.sample(logits, 0.9, torch.Generator().manual_seed(seed))
        for k, p in ((0, 1.0), (-1, 1.0), (128, 1.0), (0, 1.5)):
            filt = sampling.sample_topk_topp(logits, 0.9, torch.Generator().manual_seed(seed), k, p)
            assert torch.equal(base, filt)


def test_support_is_the_keep_set():
    """Over 200 draws the filtered sampler emits only kept tokens, and at a
    hot temperature every kept token appears."""
    logits = _logits(1, seed=4)
    keep = torch.isfinite(sampling.filtered_logits_topk_topp(logits, 2.0, 3, 1.0, 64))[0]
    assert int(keep.sum()) == 3
    g = torch.Generator().manual_seed(0)
    seen = {int(sampling.sample_topk_topp(logits, 2.0, g, 3, 1.0)[0]) for _ in range(200)}
    assert seen == set(torch.nonzero(keep)[:, 0].tolist())


# ---------------------------------------------------------------------------
# the engine: filtered requests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    """dflash_tpu's and the port's SpecEngine on the same f32 tiny weights."""
    kw = dict(max_new_tokens=16, block_size=4, prompt_cap=32, prompt_bucket=16)
    jt = jconfig.tiny_target_config()
    jd = jconfig.tiny_draft_config(jt, block_size=4, num_layers=1)
    jtp = jqwen3.init_params(jax.random.PRNGKey(0), jt, jnp.float32)
    jdp = jdraft.init_params(jax.random.PRNGKey(1), jd, jnp.float32)
    tt = tiny_target_config()
    td = tiny_draft_config(tt, block_size=4, num_layers=1)
    to_t = lambda p: params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")  # noqa: E731
    return JSpecEngine(jt, jd, jtp, jdp, **kw), SpecEngine(tt, td, to_t(jtp), to_t(jdp), device="cpu", **kw)


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.5, 1, 1.0), (2.0, 2, 1e-6)])
def test_greedy_equivalent_filters_match_dflash_tpu_greedy(engines, temperature, top_k, top_p):
    """A hot request whose keep set is the argmax alone emits dflash_tpu's
    greedy tokens, through the filtered sampler at every cycle."""
    jeng, teng = engines
    prompt = np.asarray([[9, 4, 11, 3, 7]])
    want = jeng.generate(prompt, temperature=0.0)
    got = teng.generate(prompt, temperature=temperature, top_k=top_k, top_p=top_p, seed=5)
    np.testing.assert_array_equal(got.output_ids, want.output_ids)
    assert got.acceptance_lengths == want.acceptance_lengths


def test_filtered_request_stays_in_the_keep_set(engines):
    _, teng = engines
    out = teng.generate(np.asarray([[1, 2, 3]]), temperature=0.8, top_k=5, top_p=0.9, seed=1)
    assert out.num_output_tokens == teng.max_new_tokens
    gen = out.output_ids[0, out.num_input_tokens:]
    assert gen.min() >= 0 and gen.max() < teng.tcfg.vocab_size


def test_spec_generate_filters_match_engine(engines):
    _, teng = engines
    prompt = np.random.default_rng(5).integers(0, teng.tcfg.vocab_size - 2, size=(1, 7))
    kw = dict(temperature=0.8, seed=3, top_k=5, top_p=0.9)
    res = spec_generate(teng.t_params, teng.d_params, teng.tcfg, teng.dcfg, prompt, max_new_tokens=12,
                        block_size=4, device="cpu", **kw)
    ref = SpecEngine(teng.tcfg, teng.dcfg, teng.t_params, teng.d_params, max_new_tokens=12, block_size=4,
                     prompt_cap=128, prompt_bucket=128, device="cpu").generate(prompt, **kw)
    np.testing.assert_array_equal(res.output_ids, ref.output_ids)


def test_top_k_beyond_the_pool_raises(engines):
    _, teng = engines
    eng = SpecEngine(teng.tcfg, teng.dcfg, teng.t_params, teng.d_params, max_new_tokens=4,
                     topk_pool=8, device="cpu")
    with pytest.raises(ValueError, match="topk_pool"):
        eng.generate(np.asarray([[1, 2]]), temperature=1.0, top_k=9)
    assert eng.generate(np.asarray([[1, 2]]), temperature=1.0, top_k=8).num_output_tokens == 4
