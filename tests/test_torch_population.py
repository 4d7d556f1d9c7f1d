"""The port's population mode vs sid_tpu's, on the CPU.

``sid_tpu_torch.models.population`` (lockstep lane fits over the lanes'
objective, the lanes' marginals, per-sample local and quality calls) is held
against ``sid_tpu.models.population`` (vmapped jitted fits, batched
marginals) on small seeded cohorts made with ``tests/synth.py`` and handed
to both packages:

- ``fit_population``, pooled and independent: (pi, eps, converged) of every
  sample and of the pooled fit bitwise what sid_tpu's simplex spec
  (``sid_tpu.exact.nmsimplex``) reaches over sid_tpu's objective
  (``compound_neg_log_likelihood`` of the bucket-padded histogram), and
  within the simplex tolerance of sid_tpu's jitted ``fit_population``
  (whose vmapped loop parts from its own spec in the last bits:
  ROADMAP.md C5), with the same diagnostic lines;
- ``call_population``: the CSV bytes of every sample for all four methods
  (LR and local also with -R), pooled and independent;
- ``call_population_streaming``: the ``.calls.csv`` files, the record
  counts and the diagnostic lines, and the same bytes as the in-memory
  run;
- a cohort with a sample whose sites are all below coverage 4 (an empty
  fit lane) and one with a sample of no sites (sid_tpu's whole-cohort
  switch of ``-m local`` to its batched f64 path, ADVICE r5 #2, which gives
  the same bytes here);
- the deep cohort of fault C4 (one sample with a (9000, 9000, 0, 0) site):
  sid_tpu's population fits have no long-double range screen and leave the
  reference, so the port is held to the reference's long-double semantics
  instead: its fits bitwise the long-double fits of ``sid_tpu.exact``, the
  flagged rows' marginals bitwise the long-double ones, and the deep
  sample's ``-m local`` CSV that of sid_tpu's host long-double classifier
  at the long-double fit's pi (where sid_tpu's cohort output differs);
- the fused on-device LRT (``exact_pvalues=False``: B5 per sample for
  ``-m local``, the LRT and BH kernels' plain versions per sample for LR,
  B6's full form for quality): every sample's CSV held to sid_tpu's by the
  device-LRT tolerance (test_torch_lrt.py), the class tables to the same
  call's host-libm tables (the same logs) to 1e-13, streaming byte-equal
  to in memory;
- the mesh raises ``NotPortedError``.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sid_tpu.config import Options as RefOptions  # noqa: E402
from sid_tpu.exact import lynch_ld as ref_lynch_ld  # noqa: E402
from sid_tpu.exact.nmsimplex import minimize_nmsimplex2 as ref_minimize  # noqa: E402
from sid_tpu.io.pileup import parse_pileup as ref_parse  # noqa: E402
from sid_tpu.models import common as ref_common  # noqa: E402
from sid_tpu.models import local as ref_local  # noqa: E402
from sid_tpu.models import population as ref_pop  # noqa: E402
from sid_tpu.ops import likelihoods as ref_lk  # noqa: E402
from sid_tpu.ops.lgamma import lgamma_int_table, table_size  # noqa: E402
from sid_tpu.parallel.distributed import merge_histograms as ref_merge  # noqa: E402
from sid_tpu.utils.padding import pad_axis0  # noqa: E402
from sid_tpu_torch.config import Options  # noqa: E402
from sid_tpu_torch.io.pileup import parse_pileup  # noqa: E402
from sid_tpu_torch.models import population as pop  # noqa: E402
from sid_tpu_torch.models.lynch import LanesObjective  # noqa: E402
from sid_tpu_torch.ops import lynch_objective  # noqa: E402
from sid_tpu_torch.ops.profiles import (  # noqa: E402
    filter_min_coverage,
    nucleotide_distribution,
    unique_profiles,
)
from sid_tpu_torch.parallel.distributed import merge_histograms  # noqa: E402
from sid_tpu_torch.utils.errors import NotPortedError  # noqa: E402
from synth import make_pileup_text, simulate_diploid_counts  # noqa: E402
from test_torch_local_classify import assert_agree  # noqa: E402
from test_torch_lrt import assert_csv_close, assert_het_close, assert_pvalues_close  # noqa: E402

MODES = ("pooled", "independent")
METHODS = {
    "bayes": {"method": "bayes"},
    "lr": {"method": "likelihood_ratio"},
    "lr-R": {"method": "likelihood_ratio", "estimate_prior": True},
    "local": {"method": "local"},
    "local-R": {"method": "local", "estimate_prior": True},
    "quality": {"method": "quality"},
}
# the fused on-device LRT's variants
DEVICE_LRT_METHODS = {
    "lr-dev": {"method": "likelihood_ratio", "exact_pvalues": False},
    "lr-R-dev": {"method": "likelihood_ratio", "estimate_prior": True, "exact_pvalues": False},
    "local-dev": {"method": "local", "exact_pvalues": False},
    "local-R-dev": {"method": "local", "estimate_prior": True, "exact_pvalues": False},
}
ALL_METHODS = {**METHODS, **DEVICE_LRT_METHODS}
PIS = (0.002, 0.02, 0.06, 0.01, 0.03)
DEEP = [9000, 9000, 0, 0]


def sample_counts(k, n_sites=900, pi=None, coverage=25):
    return simulate_diploid_counts(n_sites, coverage=coverage, pi=PIS[k % len(PIS)] if pi is None else pi,
                                   eps=0.01, seed=300 + k)


def cohort_texts(name):
    """The pileup texts of a named cohort."""
    base = [sample_counts(k) for k in range(4)]
    if name == "main":
        samples = base
    elif name == "low-coverage":  # sample 1's sites all below coverage 4: an empty fit lane
        low = simulate_diploid_counts(200, coverage=2, pi=0.01, eps=0.01, seed=77)
        samples = [base[0], low[low.sum(1) < 4][:150], base[2]]
    elif name == "no-sites":  # sample 2 has no sites
        samples = [base[0], base[1], np.zeros((0, 4), np.int64), base[3]]
    elif name == "deep":  # fault C4: one deep site in sample 1
        samples = [base[0], np.vstack([sample_counts(1, 300), [DEEP]]), base[2]]
    elif name == "deep-no-sites":  # ADVICE r5 #2 with a deep site
        samples = [base[0], np.vstack([sample_counts(1, 300), [DEEP]]), np.zeros((0, 4), np.int64)]
    else:
        raise KeyError(name)
    return [make_pileup_text(c, with_qualities=True) if len(c) else b"" for c in samples]


def _parse_both(texts, reads):
    ref = [ref_parse(t, reads, reads) for t in texts]
    port = [parse_pileup(t, reads, reads, quality_terms_only=reads) for t in texts]
    return ref, port


def _hists(batches):
    out = []
    for b in batches:
        p, m, _ = unique_profiles(b.counts)
        out.append(filter_min_coverage(p, m, 4)[:2])
    return out


@pytest.fixture(scope="module")
def cohorts():
    return {name: cohort_texts(name) for name in ("main", "low-coverage", "no-sites", "deep", "deep-no-sites")}


@pytest.fixture(scope="module")
def ref_runs(cohorts):
    """sid_tpu's call_population outputs, each computed once: (CSV bytes per
    sample, diagnostic lines)."""
    memo = {}

    def get(cohort, mode, variant):
        key = (cohort, mode, variant)
        if key not in memo:
            kw = ALL_METHODS[variant]
            reads = kw["method"] == "quality"
            batches, _ = _parse_both(cohorts[cohort], reads)
            lines = []
            res = ref_pop.call_population(batches, RefOptions(**kw), mode, lines.append)
            memo[key] = ([r.to_csv_bytes() for r in res], lines)
        return memo[key]

    return get


def _port_run(texts, mode, variant):
    kw = ALL_METHODS[variant]
    reads = kw["method"] == "quality"
    _, batches = _parse_both(texts, reads)
    lines = []
    res = pop.call_population(batches, Options(platform="cpu", **kw), mode, lines.append)
    return [r.to_csv_bytes() for r in res], lines


def _first_difference(a: bytes, b: bytes) -> str:
    la, lb = a.split(b"\n"), b.split(b"\n")
    k = next((i for i, (x, y) in enumerate(zip(la, lb)) if x != y), min(len(la), len(lb)))
    return f"line {k}: port {la[k:k + 1]!r} vs sid_tpu {lb[k:k + 1]!r}"


def _assert_csvs(got, want):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"sample {k}: {_first_difference(g, w)}"


# the simplex's size tolerance (optimization.hpp:66): sid_tpu's jitted fit
# and its spec may stop at other points of the last simplex
SIMPLEX_TOL = 1e-5
# sid_tpu's objective, compiled as its population fits compile it
_REF_NLL = jax.jit(ref_lk.compound_neg_log_likelihood)


def _spec_fit(prof, mult, nt, eps=None):
    """sid_tpu's population fit as its spec defines it: the NumPy nmsimplex2
    over sid_tpu's objective of the bucket-padded histogram (the rows
    ``_fit_pooled`` / ``_fit_batched`` / ``_fit_pi_batched`` evaluate);
    2-D from (1e-3, 1e-3), or pi at ``eps`` from 1e-3, step 1e-4."""
    max_cov = int(prof.sum(-1).max()) if prof.shape[0] else 0
    tab = jnp.asarray(lgamma_int_table(table_size(max_cov)))
    p = jnp.asarray(pad_axis0(np.asarray(prof, np.int32)))
    m = jnp.asarray(pad_axis0(np.asarray(mult, np.int64)))
    nt = jnp.asarray(nt)

    def f(theta):
        return float(_REF_NLL(jnp.asarray(theta), p, m, nt, tab))

    if eps is None:
        return ref_minimize(f, [1e-3, 1e-3], [1e-4, 1e-4])
    return ref_minimize(lambda x: f([x[0], eps]), [1e-3], [1e-4])


def _is_spec(fit, spec, eps=None):
    want = spec.x if eps is None else np.array([spec.x[0], eps])
    assert np.array_equal(np.array([fit.pi, fit.eps]).view(np.int64), want.view(np.int64))
    assert fit.converged == spec.converged


def _near(a, b):
    assert a.converged == b.converged
    assert abs(a.pi - b.pi) <= SIMPLEX_TOL and abs(a.eps - b.eps) <= SIMPLEX_TOL


def test_sample_fit_fields_map_one_to_one():
    assert [f.name for f in dataclasses.fields(pop.SampleFit)] == [
        f.name for f in dataclasses.fields(ref_pop.SampleFit)]


def test_merge_histograms_is_sid_tpus(cohorts):
    _, batches = _parse_both(cohorts["main"], False)
    hists = _hists(batches)
    for got, want in zip(merge_histograms(hists), ref_merge(hists)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("cohort", ["main", "low-coverage", "no-sites"])
@pytest.mark.parametrize("mode", MODES)
def test_fit_population_bitwise(cohorts, cohort, mode):
    _, batches = _parse_both(cohorts[cohort], False)
    hists = _hists(batches)
    want_lines, got_lines = [], []
    want, want_pooled = ref_pop.fit_population(hists, mode=mode, diag=want_lines.append)
    got, got_pooled = pop.fit_population(hists, mode=mode, diag=got_lines.append, device="cpu")
    assert len(got) == len(want)
    eps = None
    if mode == "pooled":
        pp, pm = ref_merge(hists)
        _is_spec(got_pooled, _spec_fit(pp, pm, nucleotide_distribution(pp, pm)))
        _near(got_pooled, want_pooled)
        eps = got_pooled.eps
        assert len(got_lines) == 2
    else:
        assert got_pooled is None and want_pooled is None and got_lines == []
    for a, b, (prof, mult) in zip(got, want, hists):
        _is_spec(a, _spec_fit(prof, mult, nucleotide_distribution(prof, mult), eps), eps)
        _near(a, b)
    assert got_lines == want_lines


@pytest.mark.parametrize("variant", list(METHODS))
@pytest.mark.parametrize("mode", MODES)
def test_call_population_csv_bytes(cohorts, ref_runs, mode, variant):
    got, got_lines = _port_run(cohorts["main"], mode, variant)
    want, want_lines = ref_runs("main", mode, variant)
    _assert_csvs(got, want)
    assert got_lines == want_lines


@pytest.mark.parametrize("cohort", ["low-coverage", "no-sites"])
@pytest.mark.parametrize("variant", ["bayes", "lr-R", "local"])
@pytest.mark.parametrize("mode", MODES)
def test_cohorts_with_an_empty_sample(cohorts, ref_runs, cohort, mode, variant):
    got, got_lines = _port_run(cohorts[cohort], mode, variant)
    want, want_lines = ref_runs(cohort, mode, variant)
    _assert_csvs(got, want)
    assert got_lines == want_lines
    empty = 1 if cohort == "low-coverage" else 2
    if cohort == "no-sites" or variant != "local":
        assert got[empty] == b"chrom,pos,label,gt,hom_conf,het_conf,conf_type\n"


def _write_cohort(directory, texts):
    os.makedirs(directory, exist_ok=True)
    paths = []
    for k, t in enumerate(texts):
        path = os.path.join(directory, f"s{k}.pileup")
        with open(path, "wb") as f:
            f.write(t)
        paths.append(path)
    return paths


@pytest.mark.parametrize("variant", ["bayes", "lr-R", "local", "quality"])
@pytest.mark.parametrize("mode", MODES)
def test_streaming_files_equal_sid_tpus(cohorts, ref_runs, tmp_path, mode, variant):
    texts = cohorts["main"]
    kw = METHODS[variant]
    ref_paths = _write_cohort(str(tmp_path / "sid_tpu"), texts)
    port_paths = _write_cohort(str(tmp_path / "port"), texts)
    want_lines, got_lines = [], []
    chunk = 16 << 10  # several chunks a sample
    want_n = ref_pop.call_population_streaming(ref_paths, RefOptions(**kw), mode, want_lines.append, chunk)
    got_n = pop.call_population_streaming(port_paths, Options(platform="cpu", **kw), mode, got_lines.append,
                                          chunk)
    assert got_n == want_n
    assert got_lines == [ln.replace(str(tmp_path / "sid_tpu"), str(tmp_path / "port")) for ln in want_lines]
    got = []
    for rp, pp in zip(ref_paths, port_paths):
        with open(rp + ".calls.csv", "rb") as f:
            want_bytes = f.read()
        with open(pp + ".calls.csv", "rb") as f:
            got.append(f.read())
        assert got[-1] == want_bytes, _first_difference(got[-1], want_bytes)
    # and the in-memory run's bytes
    assert got == ref_runs("main", mode, variant)[0]


def test_degenerate_cohort_follows_the_spec():
    """Fault C5 where it shows in the bytes: one sample of three sites,
    pooled. The port's fit is the spec's over sid_tpu's objective and the
    long-double fit's, bit for bit; sid_tpu's jitted loop prints another
    pooled error."""
    counts = np.array([[0, 2, 0, 2], [0, 2, 0, 4], [5, 0, 0, 0]])
    _, batches = _parse_both([make_pileup_text(counts, with_qualities=True)], False)
    hists = _hists(batches)
    (prof, mult), = hists
    lines, ref_lines = [], []
    _, got = pop.fit_population(hists, mode="pooled", diag=lines.append, device="cpu")
    _, want = ref_pop.fit_population(hists, mode="pooled", diag=ref_lines.append)
    nt = nucleotide_distribution(prof, mult)
    _is_spec(got, _spec_fit(prof, mult, nt))
    _is_spec(got, _ld_fit(prof, mult, nt))
    _near(got, want)
    assert lines == ["# pooled heterozygosity: 6.941021e-01", "# pooled error: 6.288976e-10"]
    assert ref_lines[1] == "# pooled error: 6.288926e-10"


# ---- fault C4: deep rows in the population fits ----

_LD_FITS = {}


def _ld_fit(prof, mult, nt, eps=None):
    """sid_tpu.exact's long-double fit of one histogram: 2-D from (1e-3,
    1e-3), or pi alone at ``eps`` from 1e-3; step 1e-4. Each computed
    once."""
    key = (prof.tobytes(), mult.tobytes(), np.asarray(nt).tobytes(), eps)
    if key not in _LD_FITS:
        obj = ref_lynch_ld.NativeLynchLD(prof, mult, nt)
        if eps is None:
            _LD_FITS[key] = ref_minimize(obj.objective, [1e-3, 1e-3], [1e-4, 1e-4])
        else:
            _LD_FITS[key] = ref_minimize(lambda x: obj.objective((x[0], eps)), [1e-3], [1e-4])
    return _LD_FITS[key]


@pytest.fixture(scope="module")
def deep_fits(cohorts):
    _, batches = _parse_both(cohorts["deep"], False)
    hists = _hists(batches)
    return hists, {mode: pop.fit_population(hists, mode=mode, device="cpu") for mode in MODES}


def test_deep_cohort_independent_fits_follow_long_double(deep_fits):
    hists, fits = deep_fits
    got, _ = fits["independent"]
    want, _ = ref_pop.fit_population(hists, mode="independent")
    for k, (prof, mult) in enumerate(hists):
        if k == 1:  # the deep sample: the reference's long-double fit
            ld = _ld_fit(prof, mult, nucleotide_distribution(prof, mult))
            assert np.array_equal(np.array([got[k].pi, got[k].eps]), ld.x) and got[k].converged == ld.converged
            # sid_tpu's f64 fit leaves it (C4)
            assert (want[k].pi, want[k].eps) != (got[k].pi, got[k].eps)
        else:
            _is_spec(got[k], _spec_fit(prof, mult, nucleotide_distribution(prof, mult)))
            _near(got[k], want[k])


def test_deep_cohort_pooled_fits_follow_long_double(deep_fits):
    hists, fits = deep_fits
    got, got_pooled = fits["pooled"]
    pp, pm = ref_merge(hists)
    ld = _ld_fit(pp, pm, nucleotide_distribution(pp, pm))
    assert np.array_equal(np.array([got_pooled.pi, got_pooled.eps]), ld.x)
    assert got_pooled.converged == ld.converged
    for k, (prof, mult) in enumerate(hists):
        ld_k = _ld_fit(prof, mult, nucleotide_distribution(prof, mult), eps=got_pooled.eps)
        assert got[k].pi == ld_k.x[0] and got[k].eps == got_pooled.eps and got[k].converged == ld_k.converged
    _, want_pooled = ref_pop.fit_population(hists, mode="pooled")
    assert (want_pooled.pi, want_pooled.eps) != (got_pooled.pi, got_pooled.eps)  # C4


def test_deep_cohort_marginals_follow_long_double(deep_fits):
    hists, fits = deep_fits
    got_fits, _ = fits["independent"]
    eps = [f.eps for f in got_fits]
    nts = np.stack([nucleotide_distribution(p, m) for p, m in hists])
    marg = LanesObjective(hists, nts, "cpu").marginals(eps)
    for k, ((prof, mult), (lhom, lhet)) in enumerate(zip(hists, marg)):
        cov = prof.sum(1)
        tab = lgamma_int_table(table_size(int(cov.max())))
        w_hom = np.asarray(ref_lk.log_hom_marginal(prof, eps[k], nts[k], tab))
        w_het = np.asarray(ref_lk.log_het_marginal(prof, eps[k], nts[k], tab))
        deep = cov > 10000
        assert deep.sum() == (1 if k == 1 else 0)
        assert_agree(lhom[~deep], w_hom[~deep], 1e-12)
        assert_agree(lhet[~deep], w_het[~deep], 1e-12)
        if deep.any():
            l_hom, l_het = ref_lynch_ld.NativeLynchLD(prof[deep], mult[deep], nts[k]).marginals(eps[k])
            with np.errstate(divide="ignore", invalid="ignore"):
                assert np.array_equal(lhom[deep], np.log(l_hom).astype(np.float64), equal_nan=True)
                assert np.array_equal(lhet[deep], np.log(l_het).astype(np.float64), equal_nan=True)


@pytest.mark.parametrize("cohort", ["deep", "deep-no-sites"])
def test_deep_cohort_local_follows_long_double(cohorts, ref_runs, deep_fits, cohort):
    """-m local, independent: the deep sample's CSV is sid_tpu's host
    long-double classifier's at the long-double fit's pi; sid_tpu's own
    cohort run differs (its fit leaves the reference, C4, and with a sample
    of no sites its whole cohort takes the f64 path, ADVICE r5 #2)."""
    got, _ = _port_run(cohorts[cohort], "independent", "local")
    ref_batches, _ = _parse_both(cohorts[cohort], False)
    b = ref_batches[1]
    p, m, inv = unique_profiles(b.counts)
    fp, fm, _ = filter_min_coverage(p, m, 4)
    ld = _ld_fit(fp, fm, nucleotide_distribution(fp, fm))
    cls = ref_local.classify_profiles_local(p, RefOptions(), float(ld.x[0]))
    want = ref_common.gather_result(b, "p_value", inv, *cls).to_csv_bytes()
    assert got[1] == want, _first_difference(got[1], want)
    assert ref_runs(cohort, "independent", "local")[0][1] != want
    if cohort == "deep-no-sites":
        assert got[2] == b"chrom,pos,label,gt,hom_conf,het_conf,conf_type\n"


# ---- what is not ported ----

def test_mesh_and_device_lrt_raise(cohorts):
    _, batches = _parse_both(cohorts["main"][:2], False)
    hists = _hists(batches)
    fits, _ = pop.fit_population(hists, mode="independent", device="cpu")
    with pytest.raises(NotPortedError, match="--devices"):
        pop.fit_population(hists, mesh_devices=2, device="cpu")
    with pytest.raises(NotPortedError, match="--devices"):
        pop.call_population(batches, Options(platform="cpu", method="bayes", mesh_devices=2))
    # (named when the fused on-device LRT raised too) its class tables:
    # those of the same call with the host-libm LRT, p-values to 1e-13
    per_sample = [unique_profiles(b.counts)[:2] for b in batches]
    for method in ("local", "likelihood_ratio"):
        got, filtered, conf_type = pop.classify_population_profiles(
            per_sample, fits, Options(platform="cpu", method=method, exact_pvalues=False))
        want = pop.classify_population_profiles(per_sample, fits, Options(platform="cpu", method=method))
        assert (filtered, conf_type) == want[1:]
        for g, w in zip(got, want[0]):
            assert np.array_equal(g[1], w[1]) and np.array_equal(g[2], w[2])
            assert_pvalues_close(g[3], w[3])
            assert_pvalues_close(g[4], w[4])
            assert_het_close(g[0], w[0], w[4], 0.05)
    texts = cohorts["main"][:2]
    ref_batches, batches = _parse_both(texts, True)
    got = pop.call_population(batches, Options(platform="cpu", method="quality", exact_pvalues=False))
    want = ref_pop.call_population(ref_batches, RefOptions(method="quality", exact_pvalues=False))
    for g, w in zip(got, want):
        assert_csv_close(g.to_csv_bytes(), w.to_csv_bytes())
    with pytest.raises(ValueError, match="does not support method"):
        pop.classify_population_profiles(per_sample, fits, Options(platform="cpu", method="bogus"))


def test_fixed_classify_is_the_cohort_classify(cohorts):
    """The single-sample entries (_classify_bayes_fixed, _classify_lr_fixed,
    classify_sample_profiles) give the cohort path's tables, as sid_tpu's
    do."""
    _, batches = _parse_both(cohorts["main"][:2], False)
    hists = _hists(batches)
    fits, _ = pop.fit_population(hists, mode="independent", device="cpu")
    opts = Options(platform="cpu", method="likelihood_ratio", estimate_prior=True)
    for (fp, fm), fit in zip(hists, fits):
        tables = (
            (pop._classify_bayes_fixed(fp, fm, fit, opts),
             ref_pop._classify_bayes_fixed(fp, fm, ref_pop.SampleFit(fit.pi, fit.eps, fit.converged))),
            (pop._classify_lr_fixed(fp, fm, fit, opts),
             ref_pop._classify_lr_fixed(fp, fm, ref_pop.SampleFit(fit.pi, fit.eps, fit.converged),
                                        RefOptions(method="likelihood_ratio", estimate_prior=True))),
        )
        for got, want in tables:
            assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
            for a, b in zip(got[3:], want[3:]):
                assert_agree(np.asarray(a, np.float64), np.asarray(b, np.float64), 1e-12)
        cls, filtered, conf_type = pop.classify_sample_profiles(fp, fm, fit, opts)
        assert filtered and conf_type == "p_value"
        assert all(np.array_equal(a, b) for a, b in zip(cls, tables[1][0]))


def test_population_launches_no_kernel_on_the_cpu(cohorts):
    counts = (lynch_objective.RECORD_LAUNCHES, lynch_objective.NLL_LANES_LAUNCHES,
              lynch_objective.MARGINALS_LANES_LAUNCHES)
    _port_run(cohorts["main"][:2], "pooled", "bayes")
    assert counts == (lynch_objective.RECORD_LAUNCHES, lynch_objective.NLL_LANES_LAUNCHES,
                      lynch_objective.MARGINALS_LANES_LAUNCHES)


@pytest.mark.parametrize("mode, bound", [("pooled", 2), ("independent", 1)])
def test_marginals_use_the_fits_lanes(cohorts, monkeypatch, mode, bound):
    """The cohort's rows are bound once for the per-sample fits, and the
    marginals run over that binding: pooled binds the merged histogram and
    the samples, independent the samples alone."""
    made = []

    class Counted(pop.LanesObjective):
        def __init__(self, *args, **kwargs):
            made.append(len(args[0]))
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(pop, "LanesObjective", Counted)
    texts = cohorts["main"][:3]
    _port_run(texts, mode, "lr-R")
    assert made == [1, 3][2 - bound:]


@pytest.mark.parametrize("variant", list(DEVICE_LRT_METHODS))
@pytest.mark.parametrize("mode", MODES)
def test_call_population_device_lrt(cohorts, ref_runs, mode, variant):
    """exact_pvalues=False: every sample's CSV sid_tpu's by the device-LRT
    tolerance (sid_tpu's cohort local runs its batched classify_local), the
    same diagnostics."""
    got, got_lines = _port_run(cohorts["main"], mode, variant)
    want, want_lines = ref_runs("main", mode, variant)
    assert got_lines == want_lines and len(got) == len(want)
    for g, w in zip(got, want):
        assert g.count(b"\n") > 500
        assert_csv_close(g, w)


@pytest.mark.parametrize("variant", ["lr-R-dev", "local-dev"])
def test_streaming_device_lrt_equals_in_memory(cohorts, tmp_path, variant):
    texts = cohorts["main"]
    paths = _write_cohort(str(tmp_path / "port"), texts)
    opts = Options(platform="cpu", **DEVICE_LRT_METHODS[variant])
    pop.call_population_streaming(paths, opts, "pooled", None, 16 << 10)
    got = []
    for path in paths:
        with open(path + ".calls.csv", "rb") as f:
            got.append(f.read())
    assert got == _port_run(texts, "pooled", variant)[0]
