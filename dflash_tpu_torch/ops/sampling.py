"""Token sampling, exact top-k / top-p filters and the speculative acceptance
rule.  Port of ``dflash_tpu/ops/sampling.py``: ``sample``,
``sample_topk_topp``, ``filtered_logits_topk_topp``,
``exact_filter_thresholds`` and ``acceptance_length``.

Greedy (temperature < 1e-5) is argmax and matches JAX token for token.  The
sampled branch draws from softmax(logits / T) with an explicit
``torch.Generator``: the same distribution as ``jax.random.categorical``, not
the same tokens.  The top-k / top-p keep set is exact and equals JAX's: value
thresholds in ordered-float-bit space, found from a candidate pool and checked
by the ``filter_stats`` kernel (``kernels/filter_stats.py``) in one read of
the logits per round.

Where the port differs from JAX in form, not in result: the candidate pool is
an exact ``torch.topk`` (JAX's ``approx_max_k`` at recall 0.95 equals exact
top-k on the CPU; on the TPU it may miss, and the repair candidates absorb
that); ordered bits are int64 holding 0 .. 2^32 - 1, since torch has no
``uint32`` comparison on the CPU; and JAX's device ``lax.while_loop`` of
refinement rounds is a Python loop whose condition is one host read per
round, with the same cap of 16 rounds.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch

from dflash_tpu_torch.kernels.filter_stats import bits_as_int32, filter_stats
from dflash_tpu_torch.kernels.filter_stats import ordered_bits as _float_bits_ordered

GREEDY_TEMP_EPS = 1e-5
# Default candidate-pool size of the filtered sampler: the pool only seeds the
# threshold guess, so the keep set is exact for any top_k; SpecEngine.generate
# rejects top_k > pool, as the JAX engine does.
TOPK_POOL = 64
# Candidate thresholds per filter in the first stats pass.
REPAIR_W = 8
# Probes per filter per refinement round (17-ary bracket narrowing).
REFINE_W = 16
_UMAX = 0xFFFFFFFF
_MAX_ROUNDS = 16


def sample(
    logits: torch.Tensor,
    temperature: Union[float, Sequence[float]],
    generator: Union[None, torch.Generator, Sequence[Optional[torch.Generator]]] = None,
) -> torch.Tensor:
    """Token ids [...] (int64) from ``logits`` [..., V].

    Per lane: ``temperature`` a sequence of R host floats and ``generator``
    one generator per lane (or one shared) for logits [R, ..., V]; lane r
    samples its rows at its own temperature from its own generator, so its
    draws do not depend on its neighbours (JAX's per-lane PRNG keys).  All
    lanes greedy is one argmax over every lane."""
    logits = logits.float()
    if not isinstance(temperature, (int, float)):
        temps = [float(t) for t in temperature]
        if all(t < GREEDY_TEMP_EPS for t in temps):
            return logits.argmax(dim=-1)
        gens = list(generator) if isinstance(generator, (list, tuple)) else [generator] * len(temps)
        return torch.stack([sample(logits[r], t, g) for r, (t, g) in enumerate(zip(temps, gens))])
    if temperature < GREEDY_TEMP_EPS:
        return logits.argmax(dim=-1)
    return _draw(logits / max(temperature, GREEDY_TEMP_EPS), generator)


def _draw(scaled: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One categorical draw per row of softmax(``scaled``) (-inf = excluded)."""
    probs = torch.softmax(scaled, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator).reshape(probs.shape[:-1])


def _bits_to_float(u: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_float_bits_ordered` (int64 in [0, 2^32) -> float32;
    bit values that are no valid float give NaN patterns, which callers
    guard)."""
    ui = bits_as_int32(u)
    b = torch.where(ui < 0, ui ^ torch.iinfo(torch.int32).min, ~ui)
    return b.view(torch.float32)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[n, idx[n]] for x [N, W] and idx [N]."""
    return torch.gather(x, 1, idx[:, None])[:, 0]


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True per row (0 when none), as ``jnp.argmax`` of a
    bool array."""
    return mask.to(torch.int32).argmax(dim=-1)


def exact_filter_thresholds(
    scaled: torch.Tensor,  # [..., V] float32, temperature-scaled
    top_k,  # int or [...] tensor; <= 0 or >= V: off
    top_p,  # float or [...] tensor; >= 1: off
    pool_vals: torch.Tensor,  # [..., P] descending candidate values
    stats: Callable = filter_stats,
) -> torch.Tensor:
    """EXACT joint top-k / top-p keep mask [..., V] as value thresholds (JAX's
    function, step for step).

    top-k: an ordered-bit threshold t gives the top-k set iff
    count(bits >= t) == k (value ties straddling rank k keep all tied
    tokens).  top-p: t gives the nucleus iff mass(> t) < p <= mass(>= t),
    the mass normalized over the full row.  One ``stats`` pass checks 8
    candidates per filter from the pool (ranks k-1 .. k-8 and around the
    pool's nucleus cut); rows that none resolves narrow a bit-space bracket
    by 17-ary probing, one ``stats`` pass per round.  ``stats`` is the
    filter_stats function (the kernel dispatch by default; a test may pass
    the plain version)."""
    V = scaled.shape[-1]
    P = pool_vals.shape[-1]
    W = min(REPAIR_W, P)
    lead = scaled.shape[:-1]
    dev = scaled.device
    x2 = scaled.reshape(-1, V)
    pool2 = pool_vals.reshape(-1, P)
    N = x2.shape[0]
    k = torch.as_tensor(top_k, dtype=torch.int64, device=dev).broadcast_to(lead).reshape(N)
    p = torch.as_tensor(top_p, dtype=torch.float32, device=dev).broadcast_to(lead).reshape(N)
    k_on = (k > 0) & (k < V)
    p_on = p < 1.0
    umax = torch.full((N,), _UMAX, dtype=torch.int64, device=dev)
    kc, pc = k[:, None], p[:, None]

    # -- candidate thresholds ------------------------------------------------
    kk = torch.clamp(k, 1, min(P, V)) - 1
    ar = torch.arange(W, device=dev)
    ranks_k = torch.clamp(kk[:, None] - ar, 0, P - 1)
    # nucleus-cut guess from a pool-local softmax (seeds only; the verified
    # full-row masses below decide)
    pool_sm = torch.softmax(pool2, dim=-1)
    cum_before = torch.cumsum(pool_sm, dim=-1) - pool_sm
    cut = (cum_before < pc).to(torch.int64).sum(dim=-1) - 1
    ranks_p = torch.clamp(cut[:, None] - ar, 0, P - 1)
    thr_vals = torch.gather(pool2, 1, torch.cat([ranks_k, ranks_p], dim=-1))  # values ascend per group
    tb = _float_bits_ordered(thr_vals)
    c_ge, c_gt, m_gt, lse, row_min = stats(x2, tb)
    # "below everything": count(>= it) = V, mass(> it) = 1
    floor_bits = _float_bits_ordered(row_min) - 1
    m_eq = torch.where(c_ge > c_gt, torch.exp(thr_vals - lse[:, None]) * (c_ge - c_gt).float(), 0.0)
    m_ge = m_gt + m_eq

    # -- top-k: a candidate that separates rank k (or tie-straddles it) -----
    cgk, cgtk, tbk = c_ge[:, :W], c_gt[:, :W], tb[:, :W]
    good_k = (cgk == kc) | ((cgtk < kc) & (kc < cgk))
    kbits = _take(tbk, _first_true(good_k))
    # candidates ascend, counts do not increase: (count >= k) is a prefix
    n_ok = (cgk >= kc).to(torch.int64).sum(dim=-1)
    klo = torch.where(n_ok > 0, _take(tbk, torch.clamp(n_ok - 1, 0, W - 1)), floor_bits)
    klo_c = torch.where(n_ok > 0, _take(cgk, torch.clamp(n_ok - 1, 0, W - 1)).to(torch.int64),
                        torch.full_like(k, V))
    khi = torch.where(n_ok < W, _take(tbk, torch.clamp(n_ok, 0, W - 1)), umax)
    k_res = good_k.any(dim=-1) | ~k_on

    # -- top-p: a candidate with mass(> t) < p <= mass(>= t) ----------------
    mgp, mgep, tbp = m_gt[:, W:], m_ge[:, W:], tb[:, W:]
    good_p = (mgp < pc) & (mgep >= pc)
    pbits = _take(tbp, _first_true(good_p))
    n_okp = (mgp >= pc).to(torch.int64).sum(dim=-1)
    plo = torch.where(n_okp > 0, _take(tbp, torch.clamp(n_okp - 1, 0, W - 1)), floor_bits)
    phi = torch.where(n_okp < W, _take(tbp, torch.clamp(n_okp, 0, W - 1)), umax)
    p_res = good_p.any(dim=-1) | ~p_on

    # -- 17-ary refinement: one stats pass per round --------------------------
    RW = REFINE_W
    j = torch.arange(1, RW + 1, dtype=torch.int64, device=dev)

    def probes_of(lo, hi):
        """REFINE_W strictly increasing probes inside (lo, hi]."""
        step = torch.clamp((hi - lo) // (RW + 1), min=1)
        return torch.minimum(lo[:, None] + step[:, None] * j[None, :], hi[:, None])

    for _ in range(_MAX_ROUNDS):
        k_open = ~k_res & (khi - klo > 1) & (klo_c != k)
        p_open = ~p_res & (phi - plo > 1)
        if not bool((k_open | p_open).any()):  # the round's one host read
            break
        kpr, ppr = probes_of(klo, khi), probes_of(plo, phi)
        cg, cgt_, mg, _, _ = stats(x2, torch.cat([kpr, ppr], dim=-1))
        cgk, cgtk, mgp = cg[:, :RW], cgt_[:, :RW], mg[:, RW:]
        # tie mass at the p probes (NaN only where no element equals the
        # probe, and there the factor is 0)
        pvals = _bits_to_float(ppr)
        meqp = torch.where(cg[:, RW:] > cgt_[:, RW:],
                           torch.exp(pvals - lse[:, None]) * (cg[:, RW:] - cgt_[:, RW:]).float(), 0.0)
        mgep = mgp + meqp
        # k: an exact / tie probe?
        gk = (cgk == kc) | ((cgtk < kc) & (kc < cgk))
        hit_k = gk.any(dim=-1)
        kb_new = _take(kpr, _first_true(gk))
        nk = (cgk >= kc).to(torch.int64).sum(dim=-1)
        klo2 = torch.where(nk > 0, _take(kpr, torch.clamp(nk - 1, 0, RW - 1)), klo)
        klo_c2 = torch.where(nk > 0, _take(cgk, torch.clamp(nk - 1, 0, RW - 1)).to(torch.int64), klo_c)
        khi2 = torch.where(nk < RW, _take(kpr, torch.clamp(nk, 0, RW - 1)), khi)
        k_act = ~k_res
        kbits = torch.where(k_act & hit_k, kb_new, kbits)
        k_res = k_res | hit_k
        klo = torch.where(k_act, klo2, klo)
        klo_c = torch.where(k_act, klo_c2, klo_c)
        khi = torch.where(k_act, khi2, khi)
        # p: a valid probe?
        gp = (mgp < pc) & (mgep >= pc)
        hit_p = gp.any(dim=-1)
        pb_new = _take(ppr, _first_true(gp))
        np_ = (mgp >= pc).to(torch.int64).sum(dim=-1)
        plo2 = torch.where(np_ > 0, _take(ppr, torch.clamp(np_ - 1, 0, RW - 1)), plo)
        phi2 = torch.where(np_ < RW, _take(ppr, torch.clamp(np_, 0, RW - 1)), phi)
        p_act = ~p_res
        pbits = torch.where(p_act & hit_p, pb_new, pbits)
        p_res = p_res | hit_p
        plo = torch.where(p_act, plo2, plo)
        phi = torch.where(p_act, phi2, phi)
    # unresolved leftovers collapsed to width <= 1: keep all ties at lo (k) /
    # the minimal set at hi (p)
    kbits = torch.where(k_res, kbits, klo)
    pbits = torch.where(p_res, pbits, phi)

    u = _float_bits_ordered(x2)
    keep = (~k_on[:, None] | (u >= kbits[:, None])) & (~p_on[:, None] | (u >= pbits[:, None]))
    return keep.reshape(scaled.shape)


def filtered_logits_topk_topp(
    logits: torch.Tensor,  # [..., V] float32
    temp: float,  # >= GREEDY_TEMP_EPS
    top_k,
    top_p,
    pool: int,
    stats: Callable = filter_stats,
) -> torch.Tensor:
    """Full-vocab logits / temp with everything outside the joint top-k /
    top-p keep set at -inf: the exact filter a full-sort sampler applies
    (HF/SGLang rule: rank < top_k AND cumulative probability before the
    token < top_p, over the full-vocab softmax).  ``pool`` only seeds the
    threshold search; the keep set is exact for any ``top_k``."""
    pool = min(pool, logits.shape[-1])
    scaled = logits / temp
    cand_vals = torch.topk(scaled, pool, dim=-1, sorted=True).values  # descending
    keep = exact_filter_thresholds(scaled, top_k, top_p, cand_vals, stats)
    return torch.where(keep, scaled, -torch.inf)


def sample_topk_topp(
    logits: torch.Tensor,
    temperature: float,
    generator: Optional[torch.Generator],
    top_k: int,
    top_p: float,
    pool: int = TOPK_POOL,
) -> torch.Tensor:
    """:func:`sample` with top-k / top-p filtering (temperature first, then
    the filters, then a categorical draw over the masked full-vocab logits).
    Below the greedy epsilon it is argmax whatever the filters; with both
    filters off (``top_k <= 0`` or ``>= V``, ``top_p >= 1``) it is
    :func:`sample`, bit for bit for the same generator state."""
    logits = logits.float()
    if temperature < GREEDY_TEMP_EPS:
        return logits.argmax(dim=-1)
    if not (0 < top_k < logits.shape[-1] or top_p < 1.0):
        return sample(logits, temperature, generator)
    temp = max(temperature, GREEDY_TEMP_EPS)
    return _draw(filtered_logits_topk_topp(logits, temp, top_k, top_p, pool), generator)


def acceptance_length(draft_tokens: torch.Tensor, posterior: torch.Tensor) -> torch.Tensor:
    """Longest accepted prefix length: ``draft_tokens`` [B, S-1] against
    ``posterior`` [B, S]; ``(draft == posterior[:, :-1]).cumprod(1).sum(1)``.
    Any leading axes (the batched engine's lanes [R, S-1] / [R, S] give [R])."""
    matches = (draft_tokens == posterior[..., :-1]).long()
    return torch.cumprod(matches, dim=-1).sum(dim=-1)
