"""The state the two packages share: run configuration and the lgamma table.

``Options.from_reference`` must carry every field of a sid_tpu Options, and
the port's lgamma table must be sid_tpu's bit for bit, so both packages
compute from identical inputs.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sid_tpu.config import Options as RefOptions  # noqa: E402
from sid_tpu.ops import lgamma as ref_lgamma  # noqa: E402
from sid_tpu_torch.config import Options  # noqa: E402
from sid_tpu_torch.ops import lgamma  # noqa: E402

NON_DEFAULT = dict(
    method="bayes", estimate_prior=True, snp_prior=2.5e-4, significance_level=0.01,
    site_error_threshold=0.2, engine="exact", fit_backend="device",
    io_backend="python", exact_pvalues=False, mesh_devices=4, per_shard_fit=True,
    diagnostics=False, output="out.csv", stream=True, chunk_mb=16, profile=True,
    checkpoint="ckpt.npz", resume=True, population="pooled", multihost=True,
    platform="cpu", warm_cache=True,
)


def test_same_fields_and_defaults():
    assert [f.name for f in dataclasses.fields(Options)] == [
        f.name for f in dataclasses.fields(RefOptions)
    ]
    assert dataclasses.asdict(Options()) == dataclasses.asdict(RefOptions())


@pytest.mark.parametrize("kw", [{}, NON_DEFAULT])
def test_from_reference_round_trips_every_field(kw):
    ref = RefOptions(**kw)
    d = dataclasses.asdict(ref)
    port = Options.from_reference(d)
    assert dataclasses.asdict(port) == d
    # NON_DEFAULT changes every field, so nothing rides on a default
    assert set(NON_DEFAULT) == set(d)


def test_from_reference_rejects_unknown_fields():
    d = dataclasses.asdict(RefOptions())
    d["bogus"] = 1
    with pytest.raises(ValueError, match="bogus"):
        Options.from_reference(d)


@pytest.mark.parametrize("max_cov", [0, 30, 1022, 1023, 5000, 65535 * 4])
def test_lgamma_table_bitwise(max_cov):
    want = ref_lgamma.lgamma_int_table(ref_lgamma.table_size(max_cov))
    got = lgamma.lgamma_table(max_cov, "cpu")
    assert got.dtype == torch.float64
    assert lgamma.table_size(max_cov) == ref_lgamma.table_size(max_cov)
    assert np.array_equal(got.numpy().view(np.uint64), want.view(np.uint64))
