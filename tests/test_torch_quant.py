"""The port's int8 serving path against dflash_tpu's, on the CPU: int8
weights (``QTensor``, ``quantize_*``, ``linear``, ``matmul_int8``), the int8
KV cache (``quantize_rows``, ``update_layer_quant``, ``write_prompt_rows``)
and its attention (the int8 branch of the two-part ctx+block attention and of
``verify_fused``), the target forward over both, and the engine as a whole.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: quantization (int8 values and f32 scales) is compared bit for
bit; f32 products and attention with atol 2e-5 (a few sums in another
order); a product rounded to bf16 once at the end with atol 1e-2 (nearly
equal f32 sums may round one bf16 ulp apart); the plain matmul against the
Pallas kernel with the JAX kernel test's bar (atol 1e-4, rtol 1e-5); the
target forward at atol 1e-4 (several layers); tokens exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dflash_tpu.cache import kv as jkv
from dflash_tpu.core import config as jconfig
from dflash_tpu.models import dflash_draft as jdraft
from dflash_tpu.models import qwen3 as jqwen3
from dflash_tpu.ops import attention as jattn
from dflash_tpu.ops import linear as jlinear
from dflash_tpu.quant import quantize as jquant
from dflash_tpu.spec.engine import SpecEngine as JSpecEngine
from dflash_tpu_torch.cache import kv as tkv
from dflash_tpu_torch.convert import params_from_numpy
from dflash_tpu_torch.core import config as tconfig
from dflash_tpu_torch.kernels import matmul_q, verify_fused
from dflash_tpu_torch.models import dflash_draft as tdraft
from dflash_tpu_torch.models import qwen3 as tqwen3
from dflash_tpu_torch.ops import attention as tattn
from dflash_tpu_torch.ops import linear as tlinear
from dflash_tpu_torch.quant import quantize as tquant
from dflash_tpu_torch.spec.engine import SpecEngine

torch.set_num_threads(2)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _same_bits(port: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    assert port.dtype == {np.dtype(np.int8): torch.int8, np.dtype(np.float32): torch.float32}[ref.dtype]
    assert tuple(port.shape) == ref.shape
    np.testing.assert_array_equal(port.numpy().view(np.uint8), ref.view(np.uint8))


def _same_qtensor(port, ref) -> None:
    assert isinstance(port, tlinear.QTensor) and port.n == ref.n
    _same_bits(port.q, ref.q)
    _same_bits(port.scale, ref.scale)


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


# ---------------------------------------------------------------------------
# int8 weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,pad_to", [((64, 96), 1), ((64, 100), 64), ((40, 512), 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_matches_jax_bitwise(shape, pad_to, dtype):
    w = _rand(np.random.default_rng(0), *shape) * 0.05
    w[:, 3] = 0.0  # an all-zero channel takes the 1e-8 floor
    jw = jnp.asarray(w, getattr(jnp, dtype))
    ref = jlinear.quantize_weight(jw, pad_to)
    port = tlinear.quantize_weight(params_from_numpy({"w": np.asarray(jw)}, device="cpu")["w"], pad_to)
    _same_qtensor(port, ref)
    assert port.q.shape[1] % pad_to == 0 and port.n == shape[1]
    np.testing.assert_array_equal(tlinear.dequantize(port, torch.float32).numpy(),
                                  np.asarray(jlinear.dequantize(ref, jnp.float32)))


@pytest.mark.parametrize("x_dtype,out_dtype", [("float32", None), ("bfloat16", None),
                                               ("bfloat16", "float32")])
def test_linear_qtensor_matches_jax(x_dtype, out_dtype):
    """N = 100 is not a multiple of pad_to = 64: the padded columns are cut."""
    rng = np.random.default_rng(1)
    w, x = _rand(rng, 64, 100) * 0.05, _rand(rng, 2, 5, 64)
    jq = jlinear.quantize_weight(jnp.asarray(w), pad_to=64)
    tq = tlinear.quantize_weight(torch.from_numpy(w), pad_to=64)
    jx = jnp.asarray(x, getattr(jnp, x_dtype))
    tx = params_from_numpy({"x": np.asarray(jx)}, device="cpu")["x"]
    ref = jlinear.linear(jx, jq, out_dtype=getattr(jnp, out_dtype) if out_dtype else None)
    port = tlinear.linear(tx, tq, out_dtype=getattr(torch, out_dtype) if out_dtype else None)
    assert port.shape == (2, 5, 100) and str(port.dtype).split(".")[-1] == str(ref.dtype)
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=2e-5 if (out_dtype or x_dtype) == "float32" else 1e-2, rtol=0)


def test_matmul_plain_matches_pallas_kernel():
    """matmul_q.plain vs the Pallas kernel body in interpret mode (the shapes
    of tests/test_quant.py), and the wrapper on CPU tensors is the plain
    version without counting a launch."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from dflash_tpu.kernels.matmul_q import _kernel

    rng = np.random.default_rng(3)
    S, K, N, bn = 16, 512, 512, 256
    x = jnp.asarray(rng.normal(size=(S, K)).astype(np.float32), jnp.bfloat16)
    w = rng.integers(-127, 127, size=(K, N)).astype(np.int8)
    scale = rng.uniform(0.001, 0.01, size=(1, N)).astype(np.float32)
    ref = pl.pallas_call(
        _kernel,
        grid=(N // bn,),
        in_specs=[
            pl.BlockSpec((S, K), lambda n: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((K, bn), lambda n: (0, n), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, bn), lambda n: (0, n), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((S, bn), lambda n: (0, n), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((S, N), jnp.float32),
        interpret=True,
    )(x, jnp.asarray(w), jnp.asarray(scale))
    tx = params_from_numpy({"x": np.asarray(x)}, device="cpu")["x"]
    tw, ts = torch.from_numpy(w), torch.from_numpy(scale)
    port = matmul_q.plain(tx, tw, ts, N)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)
    before = matmul_q.matmul_int8.launches
    assert torch.equal(matmul_q.matmul_int8(tx, tw, ts, N), port)
    assert torch.equal(matmul_q.matmul_int8(tx, tw, ts, 300, out_dtype=torch.bfloat16),
                       port[:, :300].to(torch.bfloat16))
    assert matmul_q.matmul_int8.launches == before


def test_k_split_depends_on_the_weight_only():
    """The kernel's K split fills the card on narrow weights and never
    depends on S (so AR and verify rows sum in one order)."""
    assert matmul_q.k_split(4096, 152064) == 1  # lm_head: 1188 column tiles
    assert matmul_q.k_split(4096, 1024) == 32  # wk / wv: 8 column tiles
    for K, N in ((4096, 4096), (4096, 12288), (12288, 4096), (4096, 1024)):
        ks = matmul_q.k_split(K, N)
        assert K % (16 * ks) == 0 and K // ks >= 128
        assert -(-N // matmul_q.COLS_PER_BLOCK) * ks >= 128


# (K, N_pad) of every Qwen3-8B projection, N padded to 512 as
# quantize_target_params pads it; the wgmma tile each takes at S = 640 and 2048
_PROJECTIONS = {"wq/wo": (4096, 4096), "wk/wv": (4096, 1024), "gate/up": (4096, 12288),
                "down": (12288, 4096), "lm_head": (4096, 152064)}
_PROMPT_TILES = {"wq/wo": ((160, 128), (128, 128)), "wk/wv": ((64, 128), (128, 128)),
                 "gate/up": ((160, 128), (128, 128)), "down": ((160, 128), (128, 128)),
                 "lm_head": ((128, 128), (128, 128))}


@pytest.mark.parametrize("proj", sorted(_PROJECTIONS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_plan_policy(proj, dtype):
    """matmul_int8's dispatch at a Qwen3-8B projection: f32 x keeps the FMA
    plan (1-, 4- or 16-row tiles, K split by k_split); bf16 x streams the
    weight up to S = 32 (rows padded to 16 or 32, K split by k_split, shared
    by every S, so rows do not depend on S) and runs wgmma beyond, with no K
    split and the row tile that best fills the 132 SMs."""
    K, N_pad = _PROJECTIONS[proj]
    ks = matmul_q.k_split(K, N_pad)
    for S in (1, 15, 16, 32, 33, 640, 2048):
        p = matmul_q.plan(getattr(torch, dtype), S, K, N_pad)
        if dtype == "float32":
            assert p == matmul_q.Plan("fma", 1 if S == 1 else 4 if S <= 4 else 16, 128, ks)
        elif S <= 32:
            assert p == matmul_q.Plan("stream", 16 if S <= 16 else 32, 128, ks)
        else:
            assert p.variant == "wgmma" and p.split == 1 and p.cols == 128
            # 64 rows for short x or a grid under half the SMs; else the
            # fewest rows of work on the busiest SM, 128 rows on a tie
            blocks = lambda r: -(-S // r) * -(-N_pad // 128)  # noqa: E731
            cost = lambda r: -(-blocks(r) // matmul_q.SM_COUNT) * r  # noqa: E731
            if S <= 64 or blocks(128) < matmul_q.SM_COUNT // 2:
                assert p.rows == 64
            else:
                assert p.rows in (128, 160) and cost(p.rows) == min(cost(128), cost(160))
                assert p.rows == 128 or cost(160) < cost(128)
            if S in (640, 2048):
                assert (p.rows, p.cols) == _PROMPT_TILES[proj][S == 2048]


@pytest.mark.parametrize("K,N_pad", [(64, 100), (128, 520), (4096, 4100)])
def test_matmul_plan_ragged_widths(K, N_pad):
    """N_pad % 16 != 0 (rows TMA and 16-byte copies cannot address): bf16 x
    takes the ragged variant at every S, without a K split; f32 x keeps its
    FMA plan."""
    for S in (1, 16, 32, 33, 640):
        p = matmul_q.plan(torch.bfloat16, S, K, N_pad)
        assert p == matmul_q.Plan("ragged", 16 if S <= 32 else 64, 128, 1)
        assert matmul_q.plan(torch.float32, S, K, N_pad).variant == "fma"


# ---------------------------------------------------------------------------
# int8 KV cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_matches_jax_bitwise(dtype):
    x = _rand(np.random.default_rng(4), 2, 7, 3, 16)
    x[0, 1, 2] = 0.0  # an all-zero row takes the 1e-8 floor
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jq, js = jkv.quantize_rows(jx)
    tq, ts = tkv.quantize_rows(params_from_numpy({"x": np.asarray(jx)}, device="cpu")["x"])
    _same_bits(tq, jq)
    _same_bits(ts, js)


def test_update_layer_quant_and_write_prompt_rows_match_jax_bitwise():
    rng = np.random.default_rng(5)
    cfg_kw = dict(num_hidden_layers=2)
    jc, tc = jconfig.tiny_target_config(**cfg_kw), tconfig.tiny_target_config(**cfg_kw)
    L, T, nkv, d = 2, 24, jc.num_key_value_heads, jc.head_dim
    jcache = jkv.init_quant_kv_cache(jc, 1, T)
    tcache = tkv.init_quant_kv_cache(tc, 1, T, device="cpu")
    prompt_k, prompt_v = _rand(rng, L, 1, 9, nkv, d), _rand(rng, L, 1, 9, nkv, d)
    jcache = jkv.write_prompt_rows(jcache, jnp.asarray(prompt_k), jnp.asarray(prompt_v))
    assert tkv.write_prompt_rows(tcache, torch.from_numpy(prompt_k), torch.from_numpy(prompt_v)) is tcache
    for f in jcache._fields:
        _same_bits(getattr(tcache, f), getattr(jcache, f))
    # a commit of 4 rows at the frontier, per layer as the JAX engine vmaps it
    new_k, new_v = _rand(rng, L, 1, 4, nkv, d), _rand(rng, L, 1, 4, nkv, d)
    jnew = jax.vmap(jkv.update_any, in_axes=(0, 0, 0, None))(
        jcache, jnp.asarray(new_k), jnp.asarray(new_v), jnp.int32(9))
    tkv.update_any(tcache, torch.from_numpy(new_k), torch.from_numpy(new_v), 9)
    for f in jnew._fields:
        _same_bits(getattr(tcache, f), getattr(jnew, f))
    # update_layer_quant on one layer slice writes in place
    out = tkv.update_layer_quant(tcache.k[1], tcache.k_scale[1], tcache.v[1], tcache.v_scale[1],
                                 torch.from_numpy(new_k[1]), torch.from_numpy(new_v[1]), 20)
    ref = jkv.update_layer_quant(jnew.k[1], jnew.k_scale[1], jnew.v[1], jnew.v_scale[1],
                                 jnp.asarray(new_k[1]), jnp.asarray(new_v[1]), jnp.int32(20))
    for a, b in zip(out, ref):
        _same_bits(a, b)
    assert out[0].data_ptr() == tcache.k[1].data_ptr()
    with pytest.raises(ValueError):
        tkv.update_any(tcache, torch.from_numpy(new_k), torch.from_numpy(new_v), T - 2)


# ---------------------------------------------------------------------------
# parameter quantization and carrying int8 weights across
# ---------------------------------------------------------------------------

def _same_stack(port, ref, ref_layers) -> None:
    """A quantized layer stack against the JAX function's: q bit for bit; the
    scales bit for bit against JAX's quantize_weight run per layer, and within
    1 ulp of the JAX stack.  JAX quantizes stacks under jit, where XLA turns
    the division by 127 into a multiply by its reciprocal; the port divides,
    as the source (and JAX run eagerly) does."""
    _same_bits(port.q, ref.q)
    assert port.n == ref.n
    _same_bits(port.scale, np.stack([np.asarray(jlinear.quantize_weight(w, 64).scale) for w in ref_layers]))
    np.testing.assert_array_max_ulp(port.scale.numpy(), np.asarray(ref.scale), maxulp=1)


@pytest.mark.parametrize("tied", [False, True])
def test_quantize_target_and_draft_params_match_jax_bitwise(tied):
    jt = jconfig.tiny_target_config(tie_word_embeddings=tied)
    jd = jconfig.tiny_draft_config(jt, num_layers=1)
    tt = tconfig.tiny_target_config(tie_word_embeddings=tied)
    td = tconfig.tiny_draft_config(tt, num_layers=1)
    jtp = jqwen3.init_params(jax.random.PRNGKey(0), jt, jnp.float32)
    jdp = jdraft.init_params(jax.random.PRNGKey(1), jd, jnp.float32)
    ttp, tdp = _to_torch(jtp), _to_torch(jdp)  # before JAX consumes its dicts
    float_layers = {"t": dict(jtp["layers"]), "d": dict(jdp["layers"])}
    ttp_in = ttp["layers"]["wq"]
    jq_t = jquant.quantize_target_params(jtp, jt, pad_to=64)
    jq_d = jquant.quantize_draft_params(jdp, jd, pad_to=64)
    tq_t = tquant.quantize_target_params(ttp, tt, pad_to=64)
    tq_d = tquant.quantize_draft_params(tdp, td, pad_to=64)
    assert tq_t is ttp and tq_t["layers"]["wq"] is not ttp_in  # consumed and replaced
    for name in tquant._MATMUL_KEYS:
        _same_stack(tq_t["layers"][name], jq_t["layers"][name], float_layers["t"][name])
        _same_stack(tq_d["layers"][name], jq_d["layers"][name], float_layers["d"][name])
    _same_qtensor(tq_t["lm_head"], jq_t["lm_head"])
    _same_qtensor(tq_d["fc"], jq_d["fc"])
    assert tq_t["lm_head"].q.is_contiguous()
    # the JAX int8 pytree carried across as numpy
    carried = _to_torch(jq_t)
    for name in tquant._MATMUL_KEYS:
        _same_qtensor(carried["layers"][name], jq_t["layers"][name])
        _same_qtensor(carried["layers"][name][2], jax.tree.map(lambda a: a[2], jq_t["layers"][name]))
    _same_qtensor(carried["lm_head"], jq_t["lm_head"])
    np.testing.assert_array_equal(carried["embed"].numpy(), np.asarray(jq_t["embed"]))


def _layout(tree, prefix=""):
    """name -> shape (or q shape, scale shape, n) of a param tree of either package."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_layout(v, f"{prefix}{k}."))
        elif hasattr(v, "q"):
            out[prefix + k] = (tuple(v.q.shape), tuple(v.scale.shape), v.n)
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def test_init_params_quantized_has_the_jax_layout():
    """Random numbers differ between the generators; keys, shapes, widths and
    the scale do not."""
    jt, tt = jconfig.tiny_target_config(), tconfig.tiny_target_config()
    ref = jquant.init_params_quantized(jax.random.PRNGKey(0), jt, pad_to=64)
    port = tquant.init_params_quantized(0, tt, pad_to=64, device="cpu")
    assert _layout(port) == _layout(ref)
    wq = port["layers"]["wq"]
    assert wq.q.dtype == torch.int8 and int(wq.q.min()) >= -127
    assert torch.all(wq.scale == np.float32(0.02 * 2.5 / 127.0))
    assert port["embed"].dtype == torch.bfloat16


def test_moe_quantization_raises():
    moe = tconfig.tiny_target_config(num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32)
    layers = {"gate": torch.zeros(1, 64, 32)}
    with pytest.raises(NotImplementedError):
        tquant.quantize_target_params({"layers": layers}, moe)
    with pytest.raises(NotImplementedError):
        tquant.init_params_quantized(0, moe, device="cpu")


# ---------------------------------------------------------------------------
# int8 ctx attention
# ---------------------------------------------------------------------------

def _int8_ctx(rng, T, nkv, d):
    k, v = _rand(rng, 1, T, nkv, d), _rand(rng, 1, T, nkv, d)
    (kq, ks), (vq, vs) = jkv.quantize_rows(jnp.asarray(k)), jkv.quantize_rows(jnp.asarray(v))
    return [np.array(a) for a in (kq, ks, vq, vs)]


def test_int8_ctx_plus_block_attention_matches_jax():
    rng = np.random.default_rng(6)
    C, B, nh, nkv, d, T = 2, 5, 4, 2, 16, 24
    q, bk, bv = _rand(rng, C, B, nh, d), _rand(rng, C, B, nkv, d), _rand(rng, C, B, nkv, d)
    kq, ks, vq, vs = _int8_ctx(rng, T, nkv, d)
    ctx_mask = np.arange(T) < 17
    blk_mask = np.tril(np.ones((B, B), bool))
    ref = jattn.gqa_attention_quant_ctx_plus_block(
        *map(jnp.asarray, (q, kq, ks, vq, vs, bk, bv, ctx_mask, blk_mask)), 0.25)
    port = tattn.gqa_attention_quant_ctx_plus_block(
        *map(torch.from_numpy, (q, kq, ks, vq, vs, bk, bv, ctx_mask, blk_mask)), 0.25)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


@pytest.mark.parametrize("B,mask,ctx_len", [
    (16, "causal", 0), (16, "causal", 130), (16, "causal", 256), (16, "all_true", 130), (1, "causal", 130),
])
def test_verify_int8_ctx_matches_pallas_interpret(B, mask, ctx_len):
    """The port's fused_ctx_block_attention (CPU: the plain version) vs the
    JAX kernel's int8 branch in interpret mode, at d 128 and T 256."""
    from dflash_tpu.kernels.verify_fused import fused_ctx_block_attention as j_verify

    rng = np.random.default_rng(7)
    nh, nkv, d, T = 32, 8, 128, 256
    q, bk, bv = _rand(rng, 1, B, nh, d), _rand(rng, 1, B, nkv, d), _rand(rng, 1, B, nkv, d)
    kq, ks, vq, vs = _int8_ctx(rng, T, nkv, d)
    m = np.tril(np.ones((B, B), bool)) if mask == "causal" else np.ones((B, B), bool)
    scale = d ** -0.5
    ref = j_verify(*map(jnp.asarray, (q, kq, ks, vq, vs, bk, bv)), jnp.int32(ctx_len),
                   jnp.asarray(m), scale, interpret=True)
    t = [torch.from_numpy(a) for a in (q, kq, ks, vq, vs, bk, bv)]
    before = (verify_fused.fused_ctx_block_attention.launches,
              verify_fused.fused_ctx_block_attention.launches_int8)
    port = verify_fused.fused_ctx_block_attention(*t, ctx_len, torch.from_numpy(m), scale)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    assert torch.equal(port, verify_fused.plain(t[0], t[1], t[3], t[5], t[6], ctx_len,
                                                torch.from_numpy(m), scale, t[2], t[4]))
    assert (verify_fused.fused_ctx_block_attention.launches,
            verify_fused.fused_ctx_block_attention.launches_int8) == before


# ---------------------------------------------------------------------------
# the target forward and the engine
# ---------------------------------------------------------------------------

def _quantized_models(block_size=8, draft_layers=2):
    jt = jconfig.tiny_target_config()
    jd = jconfig.tiny_draft_config(jt, block_size=block_size, num_layers=draft_layers)
    tt = tconfig.tiny_target_config()
    td = tconfig.tiny_draft_config(tt, block_size=block_size, num_layers=draft_layers)
    jtp = jqwen3.init_params(jax.random.PRNGKey(0), jt, jnp.float32)
    jdp = jdraft.init_params(jax.random.PRNGKey(1), jd, jnp.float32)
    jtp = jquant.quantize_target_params(jtp, jt, pad_to=64)
    jdp = jquant.quantize_draft_params(jdp, jd, pad_to=64)
    return jt, jd, jtp, jdp, tt, td, _to_torch(jtp), _to_torch(jdp)


def test_forward_block_candidates_int8_matches_jax():
    jt, _, jtp, _, tt, _, ttp, _ = _quantized_models()
    rng = np.random.default_rng(8)
    T, B, ctx_len = 64, 8, 30
    L, nkv, d, H = jt.num_hidden_layers, jt.num_key_value_heads, jt.head_dim, jt.hidden_size
    ck, cv = _rand(rng, L, 1, T, nkv, d), _rand(rng, L, 1, T, nkv, d)
    jcache = jkv.write_prompt_rows(jkv.init_quant_kv_cache(jt, 1, T), jnp.asarray(ck), jnp.asarray(cv))
    tcache = tkv.write_prompt_rows(tkv.init_quant_kv_cache(tt, 1, T, device="cpu"),
                                   torch.from_numpy(ck), torch.from_numpy(cv))
    emb = _rand(rng, 1, B, H)
    pos = (ctx_len + np.arange(B))[None, :]
    ref = jqwen3.forward_block_candidates(jtp, jt, jnp.asarray(emb), jnp.asarray(pos), jcache,
                                          jnp.int32(ctx_len), tap_ids=(1,))
    port = tqwen3.forward_block_candidates(ttp, tt, torch.from_numpy(emb), torch.from_numpy(pos),
                                           tcache, ctx_len, tap_ids=(1,))
    for field in ("hidden", "taps", "blk_k", "blk_v"):
        np.testing.assert_allclose(getattr(port, field).numpy(), np.asarray(getattr(ref, field)),
                                   atol=1e-4, rtol=0)
    np.testing.assert_allclose(tqwen3.lm_head(ttp, port.hidden).numpy(),
                               np.asarray(jqwen3.lm_head(jtp, ref.hidden)), atol=1e-4, rtol=0)


@pytest.mark.parametrize("block_size,prompt_len,stop", [(8, 9, ()), (4, 16, tuple(range(0, 128)))])
def test_int8_tokens_match_dflash_tpu(block_size, prompt_len, stop):
    """The slice as a whole: int8 weights and kv_quant=True; port tokens ==
    dflash_tpu tokens for generate and ar_generate, and port spec == port AR."""
    jt, jd, jtp, jdp, tt, td, ttp, tdp = _quantized_models(block_size)
    kw = dict(max_new_tokens=20, block_size=block_size, prompt_cap=64, prompt_bucket=16,
              stop_token_ids=stop, kv_quant=True)
    jeng = JSpecEngine(jt, jd, jtp, jdp, **kw)
    teng = SpecEngine(tt, td, ttp, tdp, device="cpu", **kw)
    prompt = np.random.default_rng(11).integers(0, jt.vocab_size - 2, size=(1, prompt_len))
    js, ts = jeng.generate(prompt), teng.generate(prompt)
    np.testing.assert_array_equal(ts.output_ids, js.output_ids)
    assert ts.acceptance_lengths == js.acceptance_lengths
    tar = teng.ar_generate(prompt)
    np.testing.assert_array_equal(tar.output_ids, jeng.ar_generate(prompt).output_ids)
    np.testing.assert_array_equal(ts.output_ids, tar.output_ids)


def test_kv_quant_engine_uses_the_int8_cache_and_matches_ar():
    """kv_quant=True builds a QuantKVCache and the draft keeps a float one;
    the port's own spec == AR oracle on port-quantized weights."""
    tt = tconfig.tiny_target_config()
    td = tconfig.tiny_draft_config(tt, block_size=8, num_layers=2)
    ttp = tquant.quantize_target_params(tqwen3.init_params(0, tt, torch.float32, device="cpu"), tt, 64)
    tdp = tquant.quantize_draft_params(tdraft.init_params(1, td, torch.float32, device="cpu"), td, 64)
    from dflash_tpu_torch.spec import engine as teng_mod

    eng = SpecEngine(tt, td, ttp, tdp, max_new_tokens=24, prompt_cap=64, prompt_bucket=16,
                     kv_quant=True, device="cpu")
    ids, prompt_len, _ = eng._pad_prompt(np.asarray([[3, 1, 4, 1, 5]]))
    state = teng_mod._prefill_impl(ttp, tdp, ids, prompt_len, 0.0, None, tcfg=tt, dcfg=td,
                                   total_len=eng.total_len, kv_quant=True)
    assert isinstance(state.t_kv, tkv.QuantKVCache) and state.t_kv.k.dtype == torch.int8
    assert isinstance(state.d_kv, tkv.KVCache) and state.d_kv.k.dtype == torch.float32
    prompt = np.random.default_rng(2).integers(0, tt.vocab_size - 2, size=(1, 13))
    np.testing.assert_array_equal(eng.generate(prompt).output_ids, eng.ar_generate(prompt).output_ids)
