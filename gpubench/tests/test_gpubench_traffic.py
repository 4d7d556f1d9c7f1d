"""The generator's bytes: the six columns of every traffic without
``read_mapping_quality`` stay what they were, and the seven columns of one
with it parse alike in the port's parser and in the reference."""

import hashlib

import numpy as np
import pytest

from gpubench import harness
from gpubench.reference import pileup
from gpubench.traffic import generate
from sid_tpu_torch.io.pileup import parse_pileup
from sid_tpu_torch.models import common, quality


def _traffic(name, **sizes):
    return dict(harness.load_json(harness.ROOT, "gpubench", "traffic", name + ".json"), **sizes)


# make_pileup of chrom17M's parameters at 40,000 sites (4 tiles of 10,000, 2
# drawn) before the seventh column was added
SIX_COLUMNS_SHA256 = {
    1: "8047fe117584c0526fbafdb354aab38576ee85d1a718cfbeb641ec0db42d370e",
    2: "15f9e1c83710966b1b91ba39196b395ebb6e986247ae596f27e91b65330af025",
    3: "71051318e00a0206003a3f6433eb7688b333ffd9033a51a158e57f2de658f590",
}


@pytest.mark.parametrize("seed", sorted(SIX_COLUMNS_SHA256))
def test_six_columns_are_the_bytes_they_were(seed):
    text = generate.make_pileup(_traffic("chrom17M", sites=40_000, body_sites=10_000, distinct_bodies=2), seed)
    assert hashlib.sha256(text).hexdigest() == SIX_COLUMNS_SHA256[seed]


def _seven_columns(seed):
    return generate.make_pileup(_traffic("chrom12M.mq", sites=20_000, body_sites=10_000, distinct_bodies=2), seed)


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_seven_columns_a_mapping_quality_a_read(seed):
    """One byte a read in each quality column; a read's ``^`` prints its
    column's byte; MAPQ 60 on about 9 reads in 10, the rest on 1..59."""
    mqs, starts = [], 0
    for line in _seven_columns(seed).splitlines():
        chrom, pos, ref, depth, bases, bq, mq = line.split(b"\t")
        assert len(bq) == len(mq) == int(depth)
        j, i = 0, 0
        while i < len(bases):
            if bases[i] == ord("^"):
                assert bases[i + 1] == mq[j]
                starts += 1
                i += 2
                continue
            j += bases[i] in b"ACGTacgt"
            i += 1
        assert j == int(depth)
        mqs.append(mq)
    q = np.frombuffer(b"".join(mqs), np.uint8).astype(np.int64) - 33
    assert starts > 1000 and q.min() >= 1 and q.max() == 60
    assert 0.88 < (q == 60).mean() < 0.92 and len(np.unique(q[q < 60])) == 59


def test_seven_columns_parse_alike_in_the_port_and_the_reference():
    text = _seven_columns(7)
    chrom_id, table, pos, counts, reads = pileup.parse(text, reads=np.float64)
    batch = parse_pileup(text, True, True, backend="python")
    assert np.array_equal(batch.counts.astype(np.int64), counts) and np.array_equal(batch.pos, pos)
    assert [batch.chrom_table[i] for i in batch.chrom_id] == [table[i].decode() for i in chrom_id]
    # the port's per-read sums in NumPy are the reference's bit for bit
    major, second = common.major_allele_indices_np(batch.counts)
    log_hom, log_het = quality.accumulate_read_terms(batch, major, second)
    assert np.array_equal(log_hom, reads.log_hom) and np.array_equal(log_het, reads.log_het)
    # and the native parser's inline sums, in another order, to rounding
    native = parse_pileup(text, True, True, quality_terms_only=True)
    assert np.array_equal(native.counts, batch.counts)
    assert np.allclose(native.q_log_hom, reads.log_hom, rtol=1e-12, atol=1e-12)
    assert np.allclose(native.q_log_het, reads.log_het, rtol=1e-12, atol=1e-12)
