"""Population batches: joint calling over many samples (BASELINE config 5).

The port of ``sid_tpu/models/population.py``. Two estimation modes over S
samples' cov >= 4 profile histograms:

- ``independent``: S separate Lynch fits (pi, epsilon) from (1e-3, 1e-3),
  step 1e-4;
- ``pooled`` (default): the error rate is the platform's, not the
  sample's: fit (pi, epsilon) once on the merged histogram (the
  histograms' sufficient statistics add), then hold that epsilon and fit
  each sample's pi from 1e-3, step 1e-4.

sid_tpu vmaps one nmsimplex2 while-loop per sample over the sample axis.
Here the cohort's fits run as lanes of one loop on the device
(``LanesObjective.minimize``: on a card one launch of the fit's kernel,
whose blocks run each sample's evaluations and take each lane's simplex
step as soon as its evaluation is in; on the CPU its plain version), and
each sample's fit is the one ``fit_lynch``'s objective would give alone,
with the long-double terms of the rows the range screen flags (sid_tpu's
population fits have no screen: fault C4 in ROADMAP.md): a lane whose
evaluation flags rows goes on in the host's lockstep
(``exact.nmsimplex.finish_lanes``) from its replayed history, one launch
of the lanes' objective kernel a round.
The cohort's (hom, het) marginals at each sample's epsilon are one launch
of the lanes' marginals kernel, over the workspace the per-sample fits
bound. Per-sample priors, LRT and BH run per sample (BH's domain is each
sample's own unique profiles, call.cpp:120-138): on the host, or with
``exact_pvalues=False`` (sid_tpu's fused on-device LRT) on the device, one
LRT kernel and two BH corrections a sample
(``ops.stats.lrt_benjamini_hochberg``). ``-m local`` classifies each sample
through ``models.local.classify_profiles_local`` (the local classify kernel,
or its fused LRT form B5 with ``exact_pvalues=False``) at the sample's pi;
``-m quality`` calls each sample through ``models.quality.call_quality``
with its pi as the SNP prior.

With ``--devices`` the cohort's lanes are cut into contiguous blocks of
ceil(S / n), one a device of the mesh, as sid_tpu's shard_map variants
shard the sample axis (``_fit_batched_shardmap``,
``_fit_pi_batched_shardmap``, the sharded marginals and batched classify):
each block its own lanes' workspace on its device
(``models.lynch.ShardedLanesObjective``), every block's running lanes
enqueued each round, no collectives, each lane bitwise its unsharded fit;
no padding samples are made. The pooled 2-D fit stays on the mesh's first
device, unsharded, as in sid_tpu. ``-m local`` classifies each sample on
its block's device, and ``-m quality`` shards each sample's sites over the
mesh, as sid_tpu's ``call_quality`` does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from sid_tpu_torch.config import Options
from sid_tpu_torch.exact.nmsimplex import MinimizeResult, minimize_nmsimplex2_lanes
from sid_tpu_torch.models import common, local
from sid_tpu_torch.models.common import CallResult
from sid_tpu_torch.models.lynch import LanesObjective, ShardedLanesObjective
from sid_tpu_torch.ops import stats
from sid_tpu_torch.ops.profiles import filter_min_coverage, nucleotide_distribution, unique_profiles
from sid_tpu_torch.parallel.distributed import merge_histograms
from sid_tpu_torch.parallel.mesh import make_site_mesh, platform_devices, shard_bounds
from sid_tpu_torch.utils import profiling

# the fits' starts and steps (sid_tpu/models/population.py:77-78,163)
START = (1e-3, 1e-3)
STEP = (1e-4, 1e-4)
START_PI = (1e-3,)
STEP_PI = (1e-4,)


@dataclasses.dataclass
class SampleFit:
    pi: float
    eps: float
    converged: bool


def _nts(histograms) -> np.ndarray:
    return np.stack([nucleotide_distribution(p, m) for p, m in histograms]).reshape(-1, 4)


def fit_lanes(
    histograms: Sequence[Tuple[np.ndarray, np.ndarray]],
    nts: np.ndarray,
    device,
    start: Sequence[float],
    step: Sequence[float],
    eps: Optional[float] = None,
    mesh=None,
) -> Tuple[List[MinimizeResult], LanesObjective]:
    """One nmsimplex2 fit per histogram, all as lanes of one loop: 2-D
    fits of (pi, epsilon), or 1-D fits of pi at ``eps``; on ``device``
    (``LanesObjective.minimize``: the loop on the device), or with
    ``mesh`` (a list of devices) in blocks of lanes one a device, in
    lockstep on the host. Returns (per-lane results, the objective with
    its round counts)."""
    if mesh is None:
        objective = LanesObjective(histograms, nts, device, eps)
        return objective.minimize(start, step), objective
    objective = ShardedLanesObjective(histograms, nts, mesh, eps)
    n = len(histograms)
    return minimize_nmsimplex2_lanes(objective, [start] * n, [step] * n), objective


def fit_population(
    histograms: Sequence[Tuple[np.ndarray, np.ndarray]],
    mode: str = "pooled",
    diag=None,
    mesh_devices: Optional[int] = None,
    device=None,
) -> Tuple[List[SampleFit], Optional[SampleFit]]:
    """Fit the Lynch model over per-sample (cov>=4-filtered) histograms.

    Returns (per-sample fits, pooled fit or None). ``mode`` is "pooled" or
    "independent" (any other value fits independently, as sid_tpu does).
    ``device`` is the torch device of the objective (default cuda). With
    ``mesh_devices`` the per-sample fits run over the mesh of the first
    ``mesh_devices`` devices of ``device``'s type, one block of samples a
    device. ``diag`` receives the pooled fit's two lines. The fits run in
    the device stage ``population_fit`` (sid_tpu times them in no stage).
    """
    device = Options().device() if device is None else torch.device(device)
    mesh = None if mesh_devices is None else make_site_mesh(mesh_devices, platform_devices(device))
    fits, pooled, _ = _fit_population(histograms, mode, diag, mesh, device)
    return fits, pooled


def _fit_population(histograms, mode: str, diag, mesh, device):
    """``fit_population`` over ``mesh`` (a list of devices, which may repeat
    one; None: on ``device``), and the per-sample lanes' objective the fits
    ran over, whose workspaces then serve the cohort's marginals."""
    if mesh is None:
        device = torch.device(device)
    else:
        mesh = make_site_mesh(devices=mesh)
        device = mesh[0]
    with profiling.device_stage("population_fit", device):
        return _fit_lanes_of_mode(histograms, mode, diag, device, mesh)


def _fit_lanes_of_mode(histograms, mode: str, diag, device, mesh):
    nts = _nts(histograms)
    pooled = None
    if mode == "pooled":
        pp, pm = merge_histograms(list(histograms))
        pnt = nucleotide_distribution(pp, pm)
        (res,), _ = fit_lanes([(pp, pm)], pnt[None], device, START, STEP)
        pooled = SampleFit(float(res.x[0]), float(res.x[1]), bool(res.converged))
        if diag:
            diag(f"# pooled heterozygosity: {pooled.pi:.6e}")
            diag(f"# pooled error: {pooled.eps:.6e}")
        results, objective = fit_lanes(histograms, nts, device, START_PI, STEP_PI, eps=pooled.eps, mesh=mesh)
        fits = [SampleFit(float(r.x[0]), pooled.eps, bool(r.converged)) for r in results]
    else:
        results, objective = fit_lanes(histograms, nts, device, START, STEP, mesh=mesh)
        fits = [SampleFit(float(r.x[0]), float(r.x[1]), bool(r.converged)) for r in results]
    return fits, pooled, objective


def classify_sample_profiles(profiles: np.ndarray, mult: np.ndarray, fit: SampleFit, options: Options):
    """Per-class tables for one sample at its fitted (pi, eps): (cls
    5-tuple, filtered, conf_type); ``filtered`` says whether the table
    covers the cov>=4-filtered profiles (bayes, likelihood_ratio) or all
    of them (local)."""
    cls_list, filtered, conf_type = classify_population_profiles([(profiles, mult)], [fit], options)
    return cls_list[0], filtered, conf_type


def classify_population_profiles(
    per_sample: Sequence[Tuple[np.ndarray, np.ndarray]],
    fits: Sequence[SampleFit],
    options: Options,
    objective: Optional[LanesObjective] = None,
):
    """Per-class tables for a whole cohort.

    ``per_sample`` is the UNFILTERED (profiles, mult) per sample;
    bayes/likelihood_ratio apply the cov>=4 filter (reference semantics).
    Returns (list of per-sample cls 5-tuples, filtered, conf_type). The
    marginals of every sample come from one launch of the lanes' marginals
    kernel, over ``objective`` (the fits' lanes, already on the device) when
    it is given; local runs the local classify kernel once per sample.
    """
    method = options.method
    if method == "local":
        return _classify_local_population(per_sample, fits, options), False, "p_value"
    if method not in ("bayes", "likelihood_ratio"):
        raise ValueError(f"population mode does not support method {method!r}")

    filtered = [filter_min_coverage(p, m, 4)[:2] for p, m in per_sample]
    marginals = _population_marginals(filtered, fits, options, objective)
    out = []
    devices = sample_devices(len(filtered), options)
    for (fp, _), fit, (lh, lt), dev in zip(filtered, fits, marginals, devices):
        if method == "bayes":
            out.append(_bayes_post(fp, lh, lt, fit))
        else:
            out.append(_lr_post(fp, lh, lt, fit, options, dev))
    if method == "bayes":
        return out, True, "probability"
    return out, True, "p_value"


def _population_marginals(
    filtered: Sequence[Tuple[np.ndarray, np.ndarray]],
    fits: Sequence[SampleFit],
    options: Options,
    objective: Optional[LanesObjective] = None,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The cohort's (log L_hom, log L_het) per sample at its fitted
    epsilon: one launch of the lanes' marginals kernel, over ``objective``
    when the fits' lanes are given, else over ``filtered`` bound anew."""
    mesh = options.mesh()
    device = options.device() if mesh is None else mesh[0]
    with profiling.device_stage("population_marginals", device):
        if objective is None:
            objective = (LanesObjective(filtered, _nts(filtered), device) if mesh is None
                         else ShardedLanesObjective(filtered, _nts(filtered), mesh))
        return objective.marginals([f.eps for f in fits])


def _classify_local_population(per_sample, fits, options: Options):
    """Cohort ``local`` tables: each sample through the local classify
    kernel at its fitted pi (the -R prior), or B5 with
    ``exact_pvalues=False``, one launch a sample. sid_tpu moves the whole
    cohort to its f64 batched path when one sample has no profiles or more
    than 1M, and always with ``exact_pvalues=False`` (ROADMAP.md C, ADVICE
    r5 #2, C6); here every sample takes the path it takes alone. With a
    mesh each sample runs on its block's device (``sample_devices``)."""
    out = []
    for (p, _), fit, dev in zip(per_sample, fits, sample_devices(len(per_sample), options)):
        if p.shape[0] == 0:
            empty = np.zeros(0, np.int32)
            out.append((np.zeros(0, bool), empty, empty, np.zeros(0), np.zeros(0)))
        else:
            out.append(local.classify_profiles_local(p, options, fit.pi, None if dev is None else [dev]))
    return out


def sample_devices(n_samples: int, options: Options) -> list:
    """Each sample's device under the run's mesh: the device of its block
    of ceil(S / n) samples (the fits' blocks); None for every sample
    without a mesh."""
    mesh = options.mesh()
    if mesh is None:
        return [None] * n_samples
    bounds = shard_bounds(n_samples, len(mesh))
    return [mesh[int(np.searchsorted(bounds, i, side="right")) - 1] for i in range(n_samples)]


def call_population(
    batches: Sequence,
    options: Options,
    mode: str = "pooled",
    diag=None,
) -> List[CallResult]:
    """Per-sample genotype calls with population-level model fitting.

    All four methods: local uses the sample's fitted pi as prior (-R
    semantics), bayes/likelihood_ratio classify at the sample's (pi, eps),
    quality (per-site) uses the fitted pi as its SNP prior.
    """
    histograms = []
    uniques = []
    for b in batches:
        p, m, inv = unique_profiles(b.counts)
        uniques.append((p, m, inv))
        fp, fm, _ = filter_min_coverage(p, m, 4)
        histograms.append((fp, fm))

    fits, _, objective = _fit_population(histograms, mode, diag, options.mesh(), options.device())

    results = []
    if options.method == "quality":
        # per-site method: each sample runs through call_quality with its
        # fitted pi as the SNP prior
        from sid_tpu_torch.models.quality import call_quality

        for b, fit in zip(batches, fits):
            opts = dataclasses.replace(options, estimate_prior=False, snp_prior=fit.pi)
            results.append(call_quality(b, opts))
        return results
    cls_list, filtered, conf_type = classify_population_profiles(
        [(p, m) for p, m, _ in uniques], fits, options, objective
    )
    for b, (p, m, inv), cls in zip(batches, uniques, cls_list):
        keep = filter_min_coverage(p, m, 4)[2] if filtered else None
        results.append(common.gather_result(b, conf_type, inv, *cls, keep_u=keep))
    return results


def call_population_streaming(
    paths: Sequence[str],
    options: Options,
    mode: str = "pooled",
    diag=None,
    chunk_bytes: int = 64 << 20,
) -> List[int]:
    """Streamed population calling: no sample is ever held in memory.

    Pass 1 folds each sample into its unique-profile histogram
    (accumulate_histogram); the population fit runs on the histograms;
    pass 2 re-parses each sample chunk by chunk, classifying through the
    per-class join (or per-site quality calls) and writing
    ``<path>.calls.csv``. Returns per-sample record counts.
    """
    from sid_tpu_torch.io.stream import (
        accumulate_histogram, iter_chunks, pack_profiles, parse_chunk, with_offsets,
    )
    from sid_tpu_torch.models.quality import call_quality

    full_hists = []
    for p in paths:
        profiles, mult, _ = accumulate_histogram(p, chunk_bytes, options.io_backend)
        full_hists.append((profiles, mult))
    filtered_hists = [filter_min_coverage(p, m, 4)[:2] for p, m in full_hists]
    fits, _, objective = _fit_population(filtered_hists, mode, diag, options.mesh(), options.device())

    needs_reads = options.method == "quality"
    if not needs_reads:
        # every sample's class table up front, before the chunked re-parses
        cls_all, filtered, conf_type = classify_population_profiles(full_hists, fits, options, objective)
    counts = []
    for i, (path, (profiles, mult), fit) in enumerate(zip(paths, full_hists, fits)):
        out_path = path + ".calls.csv"
        emitted = 0
        if needs_reads:
            opts = dataclasses.replace(options, estimate_prior=False, snp_prior=fit.pi)
            cls = keys = None
        else:
            cls = cls_all[i]
            src = filter_min_coverage(profiles, mult, 4)[0] if filtered else profiles
            keys = pack_profiles(src)
        with open(out_path, "wb") as out:
            out.write((common.CSV_HEADER + "\n").encode())
            for offset, chunk in with_offsets(iter_chunks(path, chunk_bytes)):
                batch = parse_chunk(path, offset, chunk, needs_reads, needs_reads,
                                    backend=options.io_backend, quality_terms_only=needs_reads)
                if batch.num_sites == 0:
                    continue
                if needs_reads:
                    res = call_quality(batch, opts)
                else:
                    res = common.join_class_table(batch, keys, cls, conf_type)
                out.write(res.to_csv_buffer(include_header=False))
                emitted += res.num_records
        if diag:
            diag(f"# wrote {out_path} ({emitted} records)")
        counts.append(emitted)
    return counts


def _classify_lr_fixed(profiles, mult, fit: SampleFit, options: Options):
    """likelihood_ratio per-class classification at a fixed (pi, eps) for
    one sample (call.cpp:62-143): marginals at the fitted error rate (the
    lanes' marginals kernel, one lane), the -R prior, two LRT p-values, BH
    across the sample's own unique profiles, het iff adjusted p2 < alpha."""
    ((log_l_hom, log_l_het),) = _population_marginals([(profiles, mult)], [fit], options)
    return _lr_post(profiles, log_l_hom, log_l_het, fit, options)


def _lr_post(profiles, log_l_hom, log_l_het, fit: SampleFit, options: Options, device=None):
    """The LR classification after the marginals: prior, LRT, per-sample BH,
    on the host, or with ``exact_pvalues=False`` on ``device`` (default the
    options' device)."""
    if not options.exact_pvalues:
        log_priors = stats.prior_logs(fit.pi) if options.estimate_prior and fit.pi > 0 else None
        device = options.device() if device is None else device
        with profiling.device_stage("population_lrt", device):
            is_het, adj_p1, adj_p2 = stats.lrt_benjamini_hochberg(
                log_l_hom, log_l_het, log_priors, options.significance_level, device
            )
        major, second = common.major_allele_indices_np(profiles)
        return is_het, major, second, adj_p1, adj_p2
    log_l_hom = common.clamp_ld_underflow_np(log_l_hom)
    log_l_het = common.clamp_ld_underflow_np(log_l_het)
    if options.estimate_prior and fit.pi > 0:
        with np.errstate(divide="ignore"):
            log_l_het = common.clamp_ld_underflow_np(log_l_het + np.log(fit.pi))
            log_l_hom = common.clamp_ld_underflow_np(log_l_hom + np.log(1.0 - fit.pi))
    p1 = stats.lrt_pvalue_from_logs_np(log_l_het, log_l_hom)
    p2 = stats.lrt_pvalue_from_logs_np(log_l_hom, log_l_het)
    adj_p1 = stats.adjust_benjamini_hochberg_np(p1)
    adj_p2 = stats.adjust_benjamini_hochberg_np(p2)
    is_het = adj_p2 < options.significance_level
    major, second = common.major_allele_indices_np(profiles)
    return is_het, major, second, adj_p1, adj_p2


def _classify_bayes_fixed(profiles, mult, fit: SampleFit, options: Optional[Options] = None):
    """Bayes per-class classification at a fixed (pi, eps) for one sample:
    the marginals on ``options``' device (default cuda), then
    ``_bayes_post``."""
    options = options or Options()
    ((log_l_hom, log_l_het),) = _population_marginals([(profiles, mult)], [fit], options)
    return _bayes_post(profiles, log_l_hom, log_l_het, fit)


def _bayes_post(profiles, log_l_hom, log_l_het, fit: SampleFit):
    """Host half of the Bayes classification: posterior odds at (pi, eps)."""
    pi = fit.pi
    log_apost_hom = log_l_hom + np.log(np.float64(1.0 - pi))
    log_apost_het = (
        log_l_het + np.log(np.float64(pi)) if pi > 0 else np.full_like(log_l_hom, -np.inf)
    )
    with np.errstate(invalid="ignore", over="ignore"):
        mx = np.maximum(log_apost_hom, log_apost_het)
        wh = np.exp(log_apost_hom - mx)
        wt = np.exp(log_apost_het - mx)
        denom = wh + wt
        prob_hom = wh / denom
        prob_het = wt / denom
        is_het = prob_het > prob_hom
    major, second = common.major_allele_indices_np(profiles)
    return is_het, major, second, prob_hom, prob_het
