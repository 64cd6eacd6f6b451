"""The port's kernel modules: each plain PyTorch version against the JAX
Pallas kernel run in interpret mode, on the shapes the JAX kernel tests use
(tests/test_verify_fused.py, tests/test_prefill_flash.py), and each CUDA
kernel against its plain version on the card (skipped without one).

Tolerances: the JAX kernel tests' bars, f32 atol 2e-5 (verify) and 5e-5
(prefill); on the card bf16 atol = rtol = 2e-2.

JAX is imported inside the tests that use it: the card's machine has no JAX,
and runs this file's card test alone with
``python -m pytest tests/test_torch_kernels.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from dflash_tpu_torch.kernels import prefill_flash, verify_fused

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
