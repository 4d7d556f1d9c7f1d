"""The port's host layer against its own specs and sid_tpu's: the native
parser vs the Python grammar spec, the non-strict error channel, the libm
erfc, the native CSV writer vs the Python ``%g`` spec, and the dedup."""

import gzip
import math
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from sid_tpu.io.pileup import parse_pileup as ref_parse  # noqa: E402
from sid_tpu.ops.profiles import unique_profiles as ref_unique  # noqa: E402
from sid_tpu_torch import engine  # noqa: E402
from sid_tpu_torch.config import Options  # noqa: E402
from sid_tpu_torch.io import native  # noqa: E402
from sid_tpu_torch.io.pileup import parse_pileup  # noqa: E402
from sid_tpu_torch.models import local  # noqa: E402
from sid_tpu_torch.models.common import CSV_HEADER  # noqa: E402
from sid_tpu_torch.native import bridge  # noqa: E402
from sid_tpu_torch.ops.profiles import _unique_profiles_np, unique_profiles  # noqa: E402
from sid_tpu_torch.utils.errors import SidParseError  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture(scope="module")
def real_cut():
    with open(os.path.join(FIXTURES, "realdata", "bwa_like_100k.pileup.gz"), "rb") as f:
        raw = gzip.decompress(f.read())
    return b"\n".join(raw.split(b"\n")[:4000]) + b"\n"


FIELDS = ("chrom_id", "pos", "ref_base", "counts", "read_offsets", "read_code",
          "read_strand", "read_bq", "read_mq")


@pytest.mark.parametrize("backend", ["native", "python"])
def test_parse_matches_sid_tpu_with_reads(real_cut, backend):
    got = parse_pileup(real_cut, True, True, backend=backend)
    want = ref_parse(real_cut, True, True, backend="python")
    assert got.chrom_table == want.chrom_table
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


@pytest.mark.parametrize("backend", ["native", "python"])
def test_non_strict_channel_records_bad_lines(backend):
    data = b"chr1\t1\tA\t1\t.\nnot a pileup line\nchr1\t3\tC\t2\t.,\n"
    batch = parse_pileup(data, backend=backend, strict=False)
    assert batch.pos.tolist() == [1, 3]
    assert [r.line_number for r in batch.errors.records] == [2]
    with pytest.raises(SidParseError) as e:
        parse_pileup(data, backend=backend)
    assert e.value.line_number == 2


def test_erfc_is_libm():
    x = np.array([0.0, 1e-300, 0.5, 1.0, 3.0, 27.0, 30.0, np.inf, -2.0, np.nan])
    got = bridge.erfc_libm(native.load(), x)
    want = [math.erfc(v) for v in x]
    assert np.array_equal(got, want, equal_nan=True)


def test_native_csv_matches_python_format_spec():
    # zero coverage (-nan p-values) and ties included in the golden input
    with open(os.path.join(FIXTURES, "golden.pileup"), "rb") as f:
        batch = parse_pileup(f.read())
    result = local.call_local(batch, Options(platform="cpu"))
    want = "\n".join([CSV_HEADER] + result.to_csv_lines()) + "\n"
    assert result.to_csv() == want
    assert engine.run(os.path.join(FIXTURES, "golden.pileup"), Options(platform="cpu")) == want


@pytest.mark.parametrize("n", [0, 1000, 65535, 65536, 70000])
def test_unique_profiles_match_sid_tpu(n):
    """Both backends (the numpy spec below 65,536 sites, libsidtpu's
    histogram from there on) give sid_tpu's values and an int32 inverse."""
    rng = np.random.default_rng(n)
    counts = rng.integers(0, 40, (n, 4)).astype(np.uint16)
    counts[: n // 3] = counts[n // 2 : n // 2 + n // 3]  # repeats
    got = unique_profiles(counts)
    want = ref_unique(counts)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[2].dtype == np.int32 and got[2].shape == (n,)
    if n:
        for a, b in zip(_unique_profiles_np(counts), got):
            np.testing.assert_array_equal(a, b)
