"""The port's kernel modules: each plain PyTorch version against the JAX
Pallas kernel run in interpret mode, on the shapes the JAX kernel tests use
(tests/test_verify_fused.py, tests/test_prefill_flash.py), and each CUDA
kernel against its plain version on the card (skipped without one).

Tolerances: the JAX kernel tests' bars, f32 atol 2e-5 (verify) and 5e-5
(prefill); on the card f32 atol 5e-5 and bf16 atol = rtol = 2e-2 (bf16 p
and bf16 outputs; sums in another order, split partials merged in f32).  ``matmul_int8`` on the card:
atol 1e-4, rtol 1e-5 for both x dtypes (every product of a bf16 or f32 value
and an int8 value is exact in f32; only how the f32 sums are ordered and, on
the tensor cores, rounded differs).
The int8-ctx branch of ``verify_fused`` and the int8 matmul's CPU side are in
tests/test_torch_quant.py; ``filter_stats`` and ``verify_attention`` (the
kernel module ``attention``) are held against JAX in
tests/test_torch_sampling.py and tests/test_torch_forward.py.  On the card:
``filter_stats`` counts exact, masses and lse within atol 2e-6 (f32 sums of
up to 151,936 terms taken in another order).

JAX is imported inside the tests that use it: the card's machine has no JAX,
and runs this file's card test alone with
``python -m pytest tests/test_torch_kernels.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from dflash_tpu_torch.kernels import attention, filter_stats, matmul_q, prefill_flash, verify_fused
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


@pytest.mark.parametrize("B,start", [(16, 0), (16, 700), (1, 700), (5, 77), (16, 4000), (64, 30000)])
def test_verify_attention_split_policy(B, start):
    """The bf16 verify kernel's splits: the fewest 64-key tiles per split
    that keep the grid (splits x kv heads x 64-row groups) within one wave
    of blocks, and a workspace exactly when there is more than one split."""
    nh, n_kv, d = 32, 8, 128
    tiles = attention.split_tiles(B, nh, n_kv, start)
    n_tiles = -(-(start + B) // attention.KEY_TILE)
    n_splits = -(-n_tiles // tiles)
    units = n_kv * -(-(nh // n_kv * B) // 64)
    assert tiles >= 1 and n_splits * units < attention.SM_COUNT + units
    if tiles > 1:  # one tile fewer per split would overfill the wave
        assert n_tiles * units > (tiles - 1) * attention.SM_COUNT
    ws = attention.workspace_floats(B, nh, n_kv, start, d)
    assert ws == (0 if n_splits == 1 else n_splits * nh * B * (d + 2))


@pytest.mark.parametrize("R,ctx_len", [(16, 0), (16, 700), (1, 700), (32, 77), (16, 4000), (64, 30000),
                                       (256, 700)])
def test_verify_fused_split_policy(R, ctx_len):
    """The bf16 verify_fused kernel's splits: the fewest 64-key ctx tiles per
    split that keep the grid (ctx splits + the block part's split, x kv heads
    x 64-row groups) within about one wave of blocks; ctx_len 0 leaves the
    block split alone, with no workspace."""
    nh, n_kv, d = 32, 8, 128
    tiles = verify_fused.split_tiles(R, nh, n_kv, ctx_len)
    n_tiles = -(-ctx_len // attention.KEY_TILE)
    n_ctx_splits = -(-n_tiles // tiles)
    units = n_kv * -(-(nh // n_kv * R) // 64)
    budget = max(1, attention.SM_COUNT - units)  # blocks left for the ctx splits
    assert verify_fused.n_splits(R, nh, n_kv, ctx_len) == n_ctx_splits + 1
    assert tiles >= 1 and n_ctx_splits * units < budget + units
    if tiles > 1:  # one tile fewer per split would overfill the wave
        assert n_tiles * units > (tiles - 1) * budget
    if units < attention.SM_COUNT // 2:
        assert (n_ctx_splits + 1) * units <= attention.SM_COUNT + units
    ws = verify_fused.workspace_floats(R, nh, n_kv, ctx_len, d)
    assert ws == (0 if ctx_len == 0 else (n_ctx_splits + 1) * nh * R * (d + 2))


@pytest.mark.parametrize("int8", [False, True])
def test_verify_fused_cpu_tensors_take_plain(int8):
    """CPU tensors, float or int8 ctx: the wrapper returns the plain
    version's result and counts no launch on either branch."""
    g = torch.Generator().manual_seed(5)
    randn = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    q, bk, bv = randn(2, 4, 8, 64), randn(2, 4, 2, 64), randn(2, 4, 2, 64)
    ck, cv = randn(1, 40, 2, 64), randn(1, 40, 2, 64)
    ks = vs = None
    if int8:
        (ck, ks), (cv, vs) = quantize_rows(ck), quantize_rows(cv)
    mask = torch.tril(torch.ones(4, 4, dtype=torch.bool))
    counts = (verify_fused.fused_ctx_block_attention.launches, verify_fused.fused_ctx_block_attention.launches_int8)
    got = verify_fused.fused_ctx_block_attention(q, ck, ks, cv, vs, bk, bv, 33, mask, 0.125)
    assert torch.equal(got, verify_fused.plain(q, ck, cv, bk, bv, 33, mask, 0.125, ks, vs))
    assert (verify_fused.fused_ctx_block_attention.launches,
            verify_fused.fused_ctx_block_attention.launches_int8) == counts


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version.
# ---------------------------------------------------------------------------

def _tol(dtype):
    return dict(atol=5e-5, rtol=0) if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)


def _fused_cases():
    """(C, B, T, ctx_len, causal) of verify_fused on the card: ctx_len 0, 1 and
    on both sides of the bf16 kernel's first split boundary (64), the main
    path's 700, B 1 and 16, causal and all-true masks, C = 2 (R = 32), and
    both sides of a split boundary of a long ctx (several tiles a split)."""
    cases = [(1, 16, 300, 0, True), (1, 16, 300, 1, True), (1, 16, 300, 284, True), (1, 16, 300, 170, False),
             (1, 1, 300, 299, True), (3, 16, 300, 77, True)]
    edge = attention.KEY_TILE
    cases += [(1, B, 785, ctx_len, causal) for B in (1, 16) for causal in (True, False)
              for ctx_len in (0, 1, edge - 1, edge, edge + 1, 700)]
    cases += [(2, 16, 785, ctx_len, True) for ctx_len in (0, edge + 1, 700)]
    for ctx_len in (3840, 4000):
        span = attention.KEY_TILE * verify_fused.split_tiles(16, 32, 8, ctx_len)
        e = ctx_len // span * span
        cases += [(1, 16, 4096, c, True) for c in (e - 1, e, e + 1)]
    return cases


def _check_fused_cases(dtype, int8, seed):
    """verify_fused against its plain version at every _fused_cases shape, one
    launch counted per call; then the ctx K/V (int8: their scales) past
    ctx_len set to NaN must leave the output finite and bit-equal."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)  # noqa: E731
    scale = 128 ** -0.5
    counter = "launches_int8" if int8 else "launches"
    for C, B, T, ctx_len, causal in _fused_cases():
        q, bk, bv = randn(C, B, 32, 128), randn(C, B, 8, 128), randn(C, B, 8, 128)
        ck, cv, ks, vs = randn(1, T, 8, 128), randn(1, T, 8, 128), None, None
        if int8:
            (ck, ks), (cv, vs) = quantize_rows(ck), quantize_rows(cv)
        mask = torch.ones(B, B, dtype=torch.bool, device="cuda")
        if causal:
            mask = torch.tril(mask)
        case = f"C {C} B {B} T {T} ctx_len {ctx_len} causal {causal}"
        before = getattr(verify_fused.fused_ctx_block_attention, counter)
        out = verify_fused.fused_ctx_block_attention(q, ck, ks, cv, vs, bk, bv, ctx_len, mask, scale)
        assert getattr(verify_fused.fused_ctx_block_attention, counter) == before + 1
        ref = verify_fused.plain(q, ck, cv, bk, bv, ctx_len, mask, scale, ks, vs)
        torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype), msg=case)
        if int8:  # past the frontier: never read
            ks[:, ctx_len:], vs[:, ctx_len:] = float("nan"), float("nan")
        else:
            ck[:, ctx_len:], cv[:, ctx_len:] = float("nan"), float("nan")
        dirty = verify_fused.fused_ctx_block_attention(q, ck, ks, cv, vs, bk, bv, ctx_len, mask, scale)
        assert bool(torch.isfinite(dirty).all()) and torch.equal(dirty, out), case


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    dtype = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)  # noqa: E731
    scale = 128 ** -0.5
    _check_fused_cases(dtype, False, 10)
    for S in (1, 16, 128, 130, 200, 640, 2048):  # ragged against the row and key tiles, and long
        q, k, v = randn(1, S, 32, 128), randn(1, S, 8, 128), randn(1, S, 8, 128)
        before = prefill_flash.flash_prefill_attention.launches
        out = prefill_flash.flash_prefill_attention(q, k, v, scale)
        assert prefill_flash.flash_prefill_attention.launches == before + 1
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
    _check_fused_cases(getattr(torch, dtype), True, 2)


@pytest.mark.cuda
def test_cuda_filter_stats_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(3)
    for N, V, T in [(1, 151936, 16), (16, 151936, 32), (3, 1000, 64), (2, 1025, 5)]:
        x = torch.randn((N, V), generator=g, device="cuda") * 3.0
        x[:, :40] = 1.5  # ties
        bits = filter_stats.ordered_bits(x)
        cols = torch.randint(0, V, (N, T), generator=g, device="cuda")
        thr = torch.gather(bits, 1, cols)
        thr[:, 0] = 0xFFFFFFFF
        thr[:, 1] = bits.amin(dim=1) - 1
        before = filter_stats.filter_stats.launches
        got = filter_stats.filter_stats(x, thr)
        assert filter_stats.filter_stats.launches == before + 1
        ref = filter_stats.plain(x, thr)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        for a, b in zip(got[2:], ref[2:]):
            torch.testing.assert_close(a, b, atol=2e-6, rtol=0)


def _split_starts(B, T):
    """Starts on both sides of a split boundary of the bf16 kernel (the
    block ending at it, just past it, straddling it, starting on it): the
    first boundary, and the last one below a full cache of T rows; plus the
    first split alone and the last split of a full cache."""
    span = attention.KEY_TILE * attention.split_tiles(B, 32, 8, T - B)
    edges = (attention.KEY_TILE, (T - B - 1) // span * span)
    starts = {0, T - B} | {s for e in edges for s in (e - B, e - B + 1, e - B // 2, e)}
    return sorted(s for s in starts if 0 <= s <= T - B)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_verify_attention_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    dtype = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(4)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)  # noqa: E731
    cases = [(1024, B, start) for B, start in [(16, 0), (16, 1), (16, 700), (16, 1008), (1, 0), (1, 1023), (5, 77)]]
    cases += [(T, B, start) for T in (1024, 4096) for B in (1, 5, 16) for start in _split_starts(B, T)]
    for T, B, start in cases:
        q, k, v = randn(1, B, 32, 128), randn(1, T, 8, 128), randn(1, T, 8, 128)
        before = attention.verify_attention.launches
        out = attention.verify_attention(q, k, v, start, B)
        assert attention.verify_attention.launches == before + 1
        torch.testing.assert_close(out.float(), attention.plain(q, k, v, start, B).float(), **_tol(dtype),
                                   msg=f"T {T} B {B} start {start}")
        k[:, start + B:], v[:, start + B:] = float("nan"), float("nan")  # past the frontier: never read
        assert torch.equal(attention.verify_attention(q, k, v, start, B), out), (T, B, start)


@pytest.mark.cuda
def test_cuda_verify_attention_f32_rows_do_not_depend_on_B():
    """f32: each row of a B = 16 call equals, bit for bit, a B = 1 call at the
    same position (what the exact spec == AR run on the "pallas" path needs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(7)
    T = 1024
    q = torch.randn((1, 16, 32, 128), generator=g, device="cuda")
    k, v = torch.randn((1, T, 8, 128), generator=g, device="cuda"), torch.randn((1, T, 8, 128), generator=g, device="cuda")
    for start in (0, 49, 700, T - 16):
        full = attention.verify_attention(q, k, v, start, 16)
        for r in range(16):
            one = attention.verify_attention(q[:, r:r + 1].contiguous(), k, v, start + r, 1)
            assert torch.equal(one[0, 0], full[0, r]), (start, r)


@pytest.mark.cuda
def test_cuda_bf16_attention_is_deterministic():
    """bf16: two calls on the same inputs give the same bits (the split merge
    runs in a fixed order; no atomics): verify_attention, verify_fused (bf16
    and int8 ctx) and prefill_flash."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(8)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)  # noqa: E731
    for T, B, start in ((1024, 16, 700), (1024, 1, 700), (4096, 16, 4000)):
        q, k, v = randn(1, B, 32, 128), randn(1, T, 8, 128), randn(1, T, 8, 128)
        assert torch.equal(attention.verify_attention(q, k, v, start, B),
                           attention.verify_attention(q, k, v, start, B))
        bk, bv = randn(1, B, 8, 128), randn(1, B, 8, 128)
        mask = torch.tril(torch.ones(B, B, dtype=torch.bool, device="cuda"))
        (kq, ks), (vq, vs) = quantize_rows(k), quantize_rows(v)
        for ctx in ((k, None, v, None), (kq, ks, vq, vs)):
            assert torch.equal(verify_fused.fused_ctx_block_attention(q, *ctx, bk, bv, start, mask, 128 ** -0.5),
                               verify_fused.fused_ctx_block_attention(q, *ctx, bk, bv, start, mask, 128 ** -0.5))
    q, k, v = randn(1, 640, 32, 128), randn(1, 640, 8, 128), randn(1, 640, 8, 128)
    assert torch.equal(prefill_flash.flash_prefill_attention(q, k, v, 128 ** -0.5),
                       prefill_flash.flash_prefill_attention(q, k, v, 128 ** -0.5))
