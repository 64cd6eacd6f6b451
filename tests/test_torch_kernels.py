"""The port's kernel modules: each plain PyTorch version against the JAX
Pallas kernel run in interpret mode, on the shapes the JAX kernel tests use
(tests/test_verify_fused.py, tests/test_prefill_flash.py), and each CUDA
kernel against its plain version on the card (skipped without one).

Tolerances: the JAX kernel tests' bars, f32 atol 2e-5 (verify) and 5e-5
(prefill); on the card bf16 atol = rtol = 2e-2.  ``matmul_int8`` on the card:
atol 1e-4, rtol 1e-5 for both x dtypes (every product of a bf16 or f32 value
and an int8 value is exact in f32; only how the f32 sums are ordered and, on
the tensor cores, rounded differs).
The int8-ctx branch of ``verify_fused`` and the int8 matmul's CPU side are in
tests/test_torch_quant.py.

JAX is imported inside the tests that use it: the card's machine has no JAX,
and runs this file's card test alone with
``python -m pytest tests/test_torch_kernels.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from dflash_tpu_torch.kernels import matmul_q, prefill_flash, verify_fused
from dflash_tpu_torch.cache.kv import quantize_rows

torch.set_num_threads(2)


def _verify_inputs(rng, C, B, nh, nkv, d, T):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(C, B, nh, d), f(1, T, nkv, d), f(1, T, nkv, d), f(C, B, nkv, d), f(C, B, nkv, d)


def _verify_vs_jax(C, B, ctx_len, mask, T=256, atol=2e-5):
    import jax.numpy as jnp
    from dflash_tpu.kernels.verify_fused import fused_ctx_block_attention as j_verify

    rng = np.random.default_rng(0)
    q, ck, cv, bk, bv = _verify_inputs(rng, C, B, 32, 8, 128, T)
    scale = 128 ** -0.5
    ref = j_verify(
        jnp.asarray(q), jnp.asarray(ck), None, jnp.asarray(cv), None, jnp.asarray(bk),
        jnp.asarray(bv), jnp.int32(ctx_len), jnp.asarray(mask), scale, interpret=True,
    )
    t = [torch.from_numpy(a) for a in (q, ck, cv, bk, bv)]
    port = verify_fused.plain(*t, ctx_len, torch.from_numpy(mask), scale)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol, rtol=0)
    # the wrapper takes the plain version for CPU tensors, without counting a launch
    before = verify_fused.fused_ctx_block_attention.launches
    wrapped = verify_fused.fused_ctx_block_attention(
        t[0], t[1], None, t[2], None, t[3], t[4], ctx_len, torch.from_numpy(mask), scale)
    assert torch.equal(wrapped, port)
    assert verify_fused.fused_ctx_block_attention.launches == before


@pytest.mark.parametrize("ctx_len", [0, 130, 256])
def test_verify_plain_matches_pallas_causal(ctx_len):
    _verify_vs_jax(1, 16, ctx_len, np.tril(np.ones((16, 16), bool)))


def test_verify_plain_matches_pallas_all_true_mask():
    """The draft's shape: every block row attends every block row."""
    _verify_vs_jax(1, 16, 130, np.ones((16, 16), bool))


def test_verify_plain_matches_pallas_single_row():
    """The AR step's shape: B = 1."""
    _verify_vs_jax(1, 1, 130, np.ones((1, 1), bool))


def test_verify_plain_isolates_candidates():
    """C > 1: the JAX kernel adds candidate isolation; the plain version has
    it by construction, and routing_mask builds the kernel's [C*B, C*B] mask."""
    _verify_vs_jax(4, 16, 37, np.tril(np.ones((16, 16), bool)))
    blk = torch.tril(torch.ones(3, 3, dtype=torch.bool))
    m = verify_fused.routing_mask(blk, 2)
    assert m.shape == (6, 6)
    assert torch.equal(m[:3, :3], blk) and torch.equal(m[3:, 3:], blk)
    assert not m[:3, 3:].any() and not m[3:, :3].any()


@pytest.mark.parametrize("S", [128, 256])
def test_prefill_plain_matches_pallas(S):
    import jax.numpy as jnp
    from dflash_tpu.kernels.prefill_flash import flash_prefill_attention as j_prefill

    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, S, 32, 128)).astype(np.float32)
    k = rng.standard_normal((1, S, 8, 128)).astype(np.float32)
    v = rng.standard_normal((1, S, 8, 128)).astype(np.float32)
    scale = 128 ** -0.5
    ref = j_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, interpret=True)
    port = prefill_flash.plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=5e-5, rtol=0)
    before = prefill_flash.flash_prefill_attention.launches
    wrapped = prefill_flash.flash_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale)
    assert torch.equal(wrapped, port)
    assert prefill_flash.flash_prefill_attention.launches == before


def test_wrappers_raise_on_a_device_without_a_kernel():
    """A tensor that is not on the CPU never falls back to the plain version."""
    q = torch.empty(1, 16, 4, 64, device="meta")
    kv = torch.empty(1, 16, 2, 64, device="meta")
    with pytest.raises(ValueError):
        prefill_flash.flash_prefill_attention(q, kv, kv, 0.125)
    with pytest.raises(ValueError):
        verify_fused.fused_ctx_block_attention(
            q, kv, None, kv, None, kv, kv, 4, torch.ones(16, 16, dtype=torch.bool), 0.125)


def test_int8_wrappers_raise_on_a_device_without_a_kernel():
    x = torch.empty(4, 64, device="meta")
    with pytest.raises(ValueError):
        matmul_q.matmul_int8(x, torch.empty(64, 128, dtype=torch.int8, device="meta"),
                             torch.empty(1, 128, device="meta"), 100)
    q = torch.empty(1, 16, 4, 64, device="meta")
    kv = torch.empty(1, 16, 2, 64, device="meta")
    kq = torch.empty(1, 16, 2, 64, dtype=torch.int8, device="meta")
    ks = torch.empty(1, 16, 2, device="meta")
    with pytest.raises(ValueError):
        verify_fused.fused_ctx_block_attention(
            q, kq, ks, kq, ks, kv, kv, 4, torch.ones(16, 16, dtype=torch.bool), 0.125)
    with pytest.raises(ValueError):  # a key scale without a value scale
        verify_fused.fused_ctx_block_attention(
            q, kq, ks, kq, None, kv, kv, 4, torch.ones(16, 16, dtype=torch.bool), 0.125)


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version.
# ---------------------------------------------------------------------------

def _tol(dtype):
    return dict(atol=5e-5, rtol=0) if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    dtype = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)  # noqa: E731
    scale = 128 ** -0.5
    for C, B, T, ctx_len, causal in [(1, 16, 300, 0, True), (1, 16, 300, 1, True),
                                     (1, 16, 300, 284, True), (1, 16, 300, 170, False),
                                     (1, 1, 300, 299, True), (3, 16, 300, 77, True)]:
        q, bk, bv = randn(C, B, 32, 128), randn(C, B, 8, 128), randn(C, B, 8, 128)
        ck, cv = randn(1, T, 8, 128), randn(1, T, 8, 128)
        mask = torch.ones(B, B, dtype=torch.bool, device="cuda")
        if causal:
            mask = torch.tril(mask)
        out = verify_fused.fused_ctx_block_attention(q, ck, None, cv, None, bk, bv, ctx_len, mask, scale)
        ref = verify_fused.plain(q, ck, cv, bk, bv, ctx_len, mask, scale)
        torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))
    for S in (128, 200, 640):
        q, k, v = randn(1, S, 32, 128), randn(1, S, 8, 128), randn(1, S, 8, 128)
        out = prefill_flash.flash_prefill_attention(q, k, v, scale)
        torch.testing.assert_close(out.float(), prefill_flash.plain(q, k, v, scale).float(), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_matmul_int8_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    dtype = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(1)
    for K, N_pad, n in [(4096, 1024, 1024), (4096, 4096, 4096), (12288, 4096, 4096),
                        (4096, 12288, 12288), (256, 640, 600), (64, 100, 97)]:
        # S: the GEMV, 16-row tensor-core tiles, a ragged 64-row tile, 2 tiles
        q = torch.randint(-127, 128, (K, N_pad), generator=g, device="cuda", dtype=torch.int8)
        scale = torch.rand((1, N_pad), generator=g, device="cuda") * 1e-3
        x = torch.randn((130, K), generator=g, device="cuda").to(dtype)
        for S in (1, 3, 16, 40, 130):
            for out_dtype in (torch.float32, torch.bfloat16):
                out = matmul_q.matmul_int8(x[:S], q, scale, n, out_dtype=out_dtype)
                ref = matmul_q.plain(x[:S], q, scale, n, out_dtype=out_dtype)
                assert out.shape == (S, n) and out.dtype == out_dtype
                tol = dict(atol=1e-4, rtol=1e-5) if out_dtype == torch.float32 else _tol(torch.bfloat16)
                torch.testing.assert_close(out.float(), ref.float(), **tol)
        # f32 x: a row's sum does not depend on S or on its place in the tile
        # (the exact spec == AR run); bf16 x: not within the tensor cores'
        # 16-row tiles (S = 2 .. 32)
        if dtype == torch.float32:
            rows = [matmul_q.matmul_int8(x[i:i + 1], q, scale, n) for i in range(40)]
            for S in (3, 16, 40):
                assert torch.equal(matmul_q.matmul_int8(x[:S], q, scale, n), torch.cat(rows[:S]))
        else:
            full = matmul_q.matmul_int8(x[:32], q, scale, n)
            for S in (2, 3, 16):
                assert torch.equal(matmul_q.matmul_int8(x[:S], q, scale, n), full[:S])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_verify_int8_ctx_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    dtype = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(2)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)  # noqa: E731
    scale = 128 ** -0.5
    for C, B, T, ctx_len, causal in [(1, 16, 300, 0, True), (1, 16, 300, 1, True),
                                     (1, 16, 300, 284, True), (1, 16, 300, 170, False),
                                     (1, 1, 300, 299, True), (3, 16, 300, 77, True)]:
        q, bk, bv = randn(C, B, 32, 128), randn(C, B, 8, 128), randn(C, B, 8, 128)
        (kq, ks), (vq, vs) = quantize_rows(randn(1, T, 8, 128)), quantize_rows(randn(1, T, 8, 128))
        mask = torch.ones(B, B, dtype=torch.bool, device="cuda")
        if causal:
            mask = torch.tril(mask)
        before = verify_fused.fused_ctx_block_attention.launches_int8
        out = verify_fused.fused_ctx_block_attention(q, kq, ks, vq, vs, bk, bv, ctx_len, mask, scale)
        assert verify_fused.fused_ctx_block_attention.launches_int8 == before + 1
        ref = verify_fused.plain(q, kq, vq, bk, bv, ctx_len, mask, scale, ks, vs)
        torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))
