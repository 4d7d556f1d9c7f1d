"""Fixed-allele genotype-likelihood kernels, f64 log-space, in torch.

The math of lynch.hpp:48-96 and lynch.cpp:37-61 (``sid_tpu/ops/likelihoods.py``):
log likelihoods instead of the reference's long-double linear space, with
the lgamma lookup as a gather from an f64 integer table. Elementwise over a
(U,) profile axis; ``profiles`` is (U, 4) integer counts.

The Lynch marginals and the compound objective are the plain f64 versions of
the CUDA kernels in ``csrc/lynch.cu`` and follow ``csrc/lynch.cuh`` operation
for operation: the logs of (pi, epsilon, nt) are host scalars
(``lynch_scalars``, glibc), log-sum-exp and logaddexp are JAX's formulas, the
exp terms add left to right, and the objective's sum is the kernel's
fixed-order reduction (``fixed_order_sum``). So the kernel and these differ
only in the rounding of each profile's exp and log.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

# the unordered base pairs i < j in the reference's order (lynch.hpp:59-60)
PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))

DBL_MAX = float(np.finfo(np.float64).max)

# csrc/lynch.cuh: the long-double range screen and the reduction's shape
_LN2 = 0.69314718055994530942
LD_LOG_MAX = 16384.0 * _LN2
LD_LOG_MIN_NORMAL = -16382.0 * _LN2
SAFE_MAX = LD_LOG_MAX - 64.0
SAFE_MIN = LD_LOG_MIN_NORMAL + 64.0
NEGLIGIBLE = 64.0
_LOG4 = 1.3862943611198906
_LOG6 = 1.791759469228055
REDUCE_THREADS = 256
ROWS_PER_THREAD = 4
CHUNK_ROWS = REDUCE_THREADS * ROWS_PER_THREAD


def _xlogy(x: torch.Tensor, logy: torch.Tensor) -> torch.Tensor:
    """x * logy with the powl(base, 0) == 1 convention: 0 * (-inf) -> 0.

    A select, never a product with 0: 0 * NaN would stay NaN.
    """
    return torch.where(x == 0, 0.0, x * logy)


def log_multinomial(profiles: torch.Tensor, lgamma_tab: torch.Tensor) -> torch.Tensor:
    """log multinomialCoefficient (lynch.hpp:48-55):
    lngamma(cov+1) - sum lngamma(n_i+1).

    The four lngamma terms are summed left to right, ((t0 + t1) + t2) + t3,
    the order the CUDA kernel uses too.
    """
    profiles = profiles.to(torch.int64)
    cov = profiles.sum(-1)
    t = lgamma_tab[profiles + 1]
    return lgamma_tab[cov + 1] - (((t[..., 0] + t[..., 1]) + t[..., 2]) + t[..., 3])


def _take(profiles: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(profiles, -1, idx.to(torch.int64)[..., None])[..., 0]


def log_het_fixed(
    profiles: torch.Tensor,
    error_probability: torch.Tensor,
    ref0: torch.Tensor,
    ref1: torch.Tensor,
    lgamma_tab: torch.Tensor,
) -> torch.Tensor:
    """log heterozygousLikelihood at fixed alleles (ref0, ref1) (lynch.hpp:76-80)."""
    profiles = profiles.to(torch.int64)
    cov = profiles.sum(-1)
    e = error_probability
    n01 = _take(profiles, ref0) + _take(profiles, ref1)
    log_match = torch.log((1.0 - 2.0 / 3.0 * e) / 2.0)
    log_err = torch.log(e / 3.0)
    return (
        log_multinomial(profiles, lgamma_tab)
        + _xlogy(n01, log_match)
        + _xlogy(cov - n01, log_err)
    )


def log_hom_fixed(
    profiles: torch.Tensor,
    error_probability: torch.Tensor,
    ref: torch.Tensor,
    lgamma_tab: torch.Tensor,
) -> torch.Tensor:
    """log homozygousLikelihood at a fixed allele (lynch.hpp:92-96)."""
    profiles = profiles.to(torch.int64)
    cov = profiles.sum(-1)
    e = error_probability
    n0 = _take(profiles, ref)
    log_match = torch.log1p(-e)
    log_err = torch.log(e / 3.0)
    return (
        log_multinomial(profiles, lgamma_tab)
        + _xlogy(n0, log_match)
        + _xlogy(cov - n0, log_err)
    )


def _glibc_log(x: float) -> float:
    """log through glibc (math.log), with log 0 = -inf and NaN below 0."""
    if x > 0:
        return math.log(x)
    return -math.inf if x == 0 else math.nan


def _glibc_log1p(x: float) -> float:
    if x > -1:
        return math.log1p(x)
    return -math.inf if x == -1 else math.nan


def theta_scalars(pi: float, eps: float) -> list:
    """The five scalars of ``lynch_scalars`` that depend on theta:
    log1p(-e), log(e/3), log((1-2e/3)/2), log1p(-pi), log pi (the fit's
    kernel computes them on the card: csrc/nmsimplex.cuh theta_scalars)."""
    pi, e = float(pi), float(eps)
    return [
        _glibc_log1p(-e),
        _glibc_log(e / 3.0),
        _glibc_log((1.0 - 2.0 / 3.0 * e) / 2.0),
        _glibc_log1p(-pi),
        _glibc_log(pi),
    ]


def lynch_scalars(pi: float, eps: float, nt: Sequence[float]) -> np.ndarray:
    """The 16 theta-dependent f64 scalars of one evaluation (the layout of
    ``LynchScalars`` in csrc/lynch.cuh), computed once on the host:
    log1p(-e), log(e/3), log((1-2e/3)/2), log1p(-pi), log pi,
    log1p(-sum nt^2), log nt_i (4), log(nt_i nt_j) (6, in PAIRS order)."""
    nt = [float(v) for v in nt]
    s2 = ((nt[0] * nt[0] + nt[1] * nt[1]) + nt[2] * nt[2]) + nt[3] * nt[3]
    vals = theta_scalars(pi, eps) + [_glibc_log1p(-s2)]
    vals += [_glibc_log(v) for v in nt]
    vals += [_glibc_log(nt[i] * nt[j]) for i, j in PAIRS]
    return np.array(vals, np.float64)


def _xlogy_s(x: torch.Tensor, logy: torch.Tensor) -> torch.Tensor:
    """_xlogy of integer counts and per-row scalars: (double)x * logy, 0 at x == 0."""
    return torch.where(x == 0, 0.0, x.to(torch.float64) * logy)


def _logsumexp(terms):
    """JAX's logsumexp over a list of (U,) tensors, the exp terms summed left
    to right; returns (lse, the max term before the isfinite guard)."""
    amax = terms[0]
    for t in terms[1:]:
        amax = torch.maximum(amax, t)  # NaN-propagating, as XLA's max
    shift = torch.where(torch.isfinite(amax), amax, 0.0)
    s = torch.exp(terms[0] - shift)
    for t in terms[1:]:
        s = s + torch.exp(t - shift)
    return torch.log(torch.abs(s)) + shift, amax


def _logaddexp(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """JAX's logaddexp: max + log1p(exp(-|x1 - x2|)), x1 + x2 where the
    difference is NaN (NaNs, or infinities of one sign)."""
    amax = torch.maximum(x1, x2)
    delta = x1 - x2
    return torch.where(
        torch.isnan(delta), x1 + x2, amax + torch.log1p(torch.exp(-torch.abs(delta)))
    )


def _component_ok(amax: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    return (amax == -math.inf) | ((amax >= SAFE_MIN) & (value >= SAFE_MIN) & (value <= SAFE_MAX))


def _component_negligible(log_weight, m, amax, log_n_terms, log_denom, log_mix):
    top = torch.where(amax > LD_LOG_MIN_NORMAL, amax, LD_LOG_MIN_NORMAL)
    bound = log_weight + (((m + log_n_terms) + top) - log_denom)
    return (bound < log_mix - NEGLIGIBLE) | (log_weight == -math.inf)


class LynchRows(NamedTuple):
    lhom: torch.Tensor  # (U,) f64 log L_hom
    lhet: torch.Tensor  # (U,) f64 log L_het
    log_mix: torch.Tensor  # (U,) f64 log((1-pi) L_hom + pi L_het)
    flag_marginals: torch.Tensor  # (U,) bool: long-double marginals may differ
    flag_mixture: torch.Tensor  # (U,) bool: long-double objective term may differ


def row_scalars(scalars, profiles: torch.Tensor) -> torch.Tensor:
    """One evaluation's 16 values (``lynch_scalars``) as every row's, the
    (U, 16) form ``lynch_rows`` takes: a broadcast view, no copy."""
    s = torch.as_tensor(np.asarray(scalars, np.float64), device=profiles.device)
    return s.expand(profiles.shape[0], 16)


def lynch_rows(profiles: torch.Tensor, scalars: torch.Tensor, lgamma_tab: torch.Tensor) -> LynchRows:
    """Per profile, ``lynch_row`` of csrc/lynch.cuh: the two marginals, the
    mixture and the long-double range screen's flags. ``scalars`` is a
    (U, 16) f64 tensor on the profiles' device, each row's 16 values of
    ``lynch_scalars`` (one evaluation's: ``row_scalars``; a cohort's: each
    row its lane's)."""
    s = list(scalars.unbind(1))
    prof = profiles.to(torch.int64)
    cov = prof.sum(-1)
    m = log_multinomial(prof, lgamma_tab)
    c = [prof[:, i] for i in range(4)]
    th = [(s[6 + i] + _xlogy_s(c[i], s[0])) + _xlogy_s(cov - c[i], s[1]) for i in range(4)]
    tp = []
    for p, (i, j) in enumerate(PAIRS):
        n = c[i] + c[j]
        tp.append((s[10 + p] + _xlogy_s(n, s[2])) + _xlogy_s(cov - n, s[1]))
    lse_hom, amax_hom = _logsumexp(th)
    lse_het, amax_het = _logsumexp(tp)
    lhom = m + lse_hom
    lhet = (m + lse_het) - s[5]
    log_mix = _logaddexp(s[3] + lhom, s[4] + lhet)

    mc_over = m > SAFE_MAX
    hom_ok = _component_ok(amax_hom, lhom)
    het_ok = _component_ok(amax_het, lhet)
    hom_decides = ~hom_ok & ~_component_negligible(s[3], m, amax_hom, _LOG4, 0.0, log_mix)
    het_decides = ~het_ok & ~_component_negligible(s[4], m, amax_het, _LOG6, s[5], log_mix)
    mix_out = torch.isfinite(log_mix) & ((log_mix < SAFE_MIN) | (log_mix > SAFE_MAX))
    return LynchRows(
        lhom, lhet, log_mix,
        mc_over | ~hom_ok | ~het_ok,
        mc_over | mix_out | hom_decides | het_decides,
    )


def lynch_terms(log_mix: torch.Tensor, mult: torch.Tensor) -> torch.Tensor:
    """The objective's per-profile terms: 0 where the mixture is -inf,
    else log_mix * mult (mult converted to f64)."""
    return torch.where(log_mix == -math.inf, 0.0, log_mix * mult.to(torch.float64))


def _tree_fold(v: torch.Tensor) -> torch.Tensor:
    """(B, REDUCE_THREADS) -> (B,): v[t] = v[t] + v[t + s], s halving to 1."""
    s = v.shape[1] // 2
    while s:
        v = v[:, :s] + v[:, s : 2 * s]
        s //= 2
    return v[:, 0]


def fixed_order_sum(terms: torch.Tensor) -> torch.Tensor:
    """Sum of a (U,) f64 tensor in the kernel's fixed order (csrc/lynch.cuh):
    per chunk of CHUNK_ROWS rows, thread t adds rows k*REDUCE_THREADS + t in
    k order from 0.0, the threads fold as a tree; the chunk sums fold the
    same way. Rows past the end add 0.0. Returns a 0-d tensor."""
    return fixed_order_sums(terms, [terms.shape[0]])[0]


def chunk_sums_ref(terms: torch.Tensor) -> torch.Tensor:
    """The first half of ``fixed_order_sum``: the (ceil(U / CHUNK_ROWS),)
    chunk sums of a (U,) f64 tensor, each in its chunk's fixed order, what
    B2 stores per chunk (the sharded objective, a shard's). A shard cut
    at a multiple of CHUNK_ROWS has the whole tensor's chunk sums of its
    rows."""
    n_chunks = -(-terms.shape[0] // CHUNK_ROWS)
    x = torch.zeros(n_chunks * CHUNK_ROWS, dtype=torch.float64, device=terms.device)
    x[: terms.shape[0]] = terms
    x = x.view(n_chunks, ROWS_PER_THREAD, REDUCE_THREADS)
    acc = torch.zeros((n_chunks, REDUCE_THREADS), dtype=torch.float64, device=terms.device)
    for k in range(ROWS_PER_THREAD):
        acc = acc + x[:, k, :]
    return _tree_fold(acc)


def fold_chunk_sums_ref(chunk_sums: torch.Tensor) -> torch.Tensor:
    """The second half of ``fixed_order_sum`` and the plain version of the
    fold that the last block of B2 and of the sharded objective makes
    (csrc/lynch.cu ``lynch_nll_kernel``, ``lynch_nll_shards_kernel``):
    thread t adds chunk sums t, t + REDUCE_THREADS, ... from 0.0, the
    threads fold as a tree.
    ``fold_chunk_sums_ref(chunk_sums_ref(terms))`` is bitwise
    ``fixed_order_sum(terms)``. Returns a 0-d tensor."""
    rounds = -(-chunk_sums.shape[0] // REDUCE_THREADS)
    y = torch.zeros(rounds * REDUCE_THREADS, dtype=torch.float64, device=chunk_sums.device)
    y[: chunk_sums.shape[0]] = chunk_sums
    y = y.view(rounds, REDUCE_THREADS)
    acc = torch.zeros((1, REDUCE_THREADS), dtype=torch.float64, device=chunk_sums.device)
    for r in range(rounds):
        acc = acc + y[r]
    return _tree_fold(acc)[0]


def lane_chunks(rows, chunk_rows: int = CHUNK_ROWS) -> np.ndarray:
    """The objective chunks of lanes of ``rows`` rows each (csrc/lynch.cuh
    lane_chunks), or chunks of ``chunk_rows``: ceil(rows / chunk_rows), and
    one for an empty lane."""
    return np.maximum(1, -(-np.asarray(rows, np.int64) // chunk_rows))


def fixed_order_sums(terms: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
    """``fixed_order_sum`` of each run of consecutive ``terms`` (their
    lengths ``sizes``), all at once, as the lanes' objective kernel sums
    its lanes: each run in chunks of CHUNK_ROWS from its first term (an
    empty run one chunk of nothing), each run's chunk sums folded in one
    block's order. Bitwise ``fixed_order_sum`` of each run alone: the
    padding adds 0.0, which changes no sum (a sum from 0.0 is never -0.0).
    Returns a (len(sizes),) tensor."""
    dev = terms.device
    sizes = np.asarray(sizes, np.int64)
    n_runs = sizes.shape[0]
    chunks = lane_chunks(sizes)
    chunk_base = np.concatenate([[0], np.cumsum(chunks)[:-1]]).astype(np.int64)
    run_start = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    total = int(chunks.sum())
    pos = np.repeat(chunk_base * CHUNK_ROWS - run_start, sizes) + np.arange(int(sizes.sum()))
    x = torch.zeros(total * CHUNK_ROWS, dtype=torch.float64, device=dev)
    x[torch.from_numpy(pos).to(dev)] = terms
    x = x.view(total, ROWS_PER_THREAD, REDUCE_THREADS)
    acc = torch.zeros((total, REDUCE_THREADS), dtype=torch.float64, device=dev)
    for k in range(ROWS_PER_THREAD):
        acc = acc + x[:, k, :]
    partials = _tree_fold(acc)
    rounds = int((-(-chunks // REDUCE_THREADS)).max()) if n_runs else 0
    y = torch.zeros((n_runs, rounds * REDUCE_THREADS), dtype=torch.float64, device=dev)
    run_of_chunk = torch.from_numpy(np.repeat(np.arange(n_runs), chunks)).to(dev)
    slot = torch.from_numpy(np.arange(total) - np.repeat(chunk_base, chunks)).to(dev)
    y[run_of_chunk, slot] = partials
    y = y.view(n_runs, rounds, REDUCE_THREADS)
    acc = torch.zeros((n_runs, REDUCE_THREADS), dtype=torch.float64, device=dev)
    for r in range(rounds):
        acc = acc + y[:, r, :]
    return _tree_fold(acc)


def log_hom_marginal(profiles, error_probability: float, nucleotide_distribution, lgamma_tab) -> torch.Tensor:
    """log homozygousLikelihood marginalized over the base (lynch.hpp:82-90):
    multinom * sum_i nt_i (1-e)^n_i (e/3)^(cov-n_i), in log space."""
    s = lynch_scalars(0.0, error_probability, nucleotide_distribution)
    return lynch_rows(profiles, row_scalars(s, profiles), lgamma_tab).lhom


def log_het_marginal(profiles, error_probability: float, nucleotide_distribution, lgamma_tab) -> torch.Tensor:
    """log heterozygousLikelihood marginalized over base pairs (lynch.hpp:57-74):
    multinom * sum_{i<j} nt_i nt_j ((1-2e/3)/2)^(n_i+n_j) (e/3)^(cov-n_i-n_j)
    / (1 - sum nt_i^2), in log space."""
    s = lynch_scalars(0.0, error_probability, nucleotide_distribution)
    return lynch_rows(profiles, row_scalars(s, profiles), lgamma_tab).lhet


def compound_neg_log_likelihood(theta, profiles, mult, nucleotide_distribution, lgamma_tab) -> torch.Tensor:
    """The Lynch-fit objective (lynch.cpp:37-61) for theta = (pi, epsilon),
    as sid_tpu computes it: -sum mult * log[(1-pi) L_hom + pi L_het] at the
    box-clipped theta, terms with a -inf mixture skipped, the sum clamped to
    +-DBL_MAX, DBL_MAX outside [0,1]^2. No long-double range screen. Returns
    a 0-d f64 tensor."""
    pi, eps = float(theta[0]), float(theta[1])
    in_box = 0.0 <= pi <= 1.0 and 0.0 <= eps <= 1.0
    s = lynch_scalars(min(max(pi, 0.0), 1.0), min(max(eps, 0.0), 1.0), nucleotide_distribution)
    rows = lynch_rows(profiles, row_scalars(s, profiles), lgamma_tab)
    total = fixed_order_sum(lynch_terms(rows.log_mix, mult))
    total = torch.clamp(total, -DBL_MAX, DBL_MAX)
    if not in_box:
        return torch.full((), DBL_MAX, dtype=torch.float64, device=total.device)
    return -total
