"""Fixed-allele genotype-likelihood kernels, f64 log-space, in torch.

The math of lynch.hpp:48-55 and :76-96 (``sid_tpu/ops/likelihoods.py``):
log likelihoods instead of the reference's long-double linear space, with
the lgamma lookup as a gather from an f64 integer table. Elementwise over a
(U,) profile axis; ``profiles`` is (U, 4) integer counts. The marginals and
the compound Lynch objective come with the fit.
"""

from __future__ import annotations

import torch


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
