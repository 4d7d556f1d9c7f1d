"""The one generator of the benchmark's inputs: a simulated diploid sample's
``samtools mpileup`` text, from a traffic file's parameters and a seed.

The model is a frozen copy of ``chip_smoke.simulated_counts``: at each site
a coverage drawn from the traffic's distribution (at least 1), a major base
drawn uniformly, heterozygous with probability ``pi`` (then half of the
major reads move to another base), ``Binomial(coverage, eps)`` error reads
all on one uniformly drawn base. The text is what ``samtools mpileup``
prints without a reference (``-f``) or ``-s``: six columns, reference
``N``, the reads as letters in a random order within the site, each on
the reverse strand (lower case) with probability ``reverse_strand``, a
read starting (``^`` and its mapping quality) or ending (``$``) at a site
with probability ``1 / read_length`` each, and a base quality a read. The
qualities are drawn uniformly from the stated Phred ranges. The rendering
is vectorised.

A traffic with ``read_mapping_quality`` is what ``samtools mpileup -s``
prints: a seventh column of one mapping quality a read (Phred+33, in the
order of the reads), each read's ``top`` with probability ``p_top`` and
otherwise uniform on ``others``; a read that starts at the site prints the
same byte after its ``^``. Without the key nothing more is drawn, and the
six columns are the same bytes as ever.

An input of ``sites`` sites is ``sites / body_sites`` tiles of
``body_sites`` consecutive positions. The first ``distinct_bodies`` tiles
are drawn from the seed; a later tile repeats the reads and qualities of
tile ``k % distinct_bodies`` under its own positions, so the input's size
and positions are those of ``sites`` independent sites while its set-up
costs ``distinct_bodies`` draws. Tiling needs every position of the input
to have as many digits as the first.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)


def _rng(seed: int, stream: int) -> np.random.Generator:
    """Independent streams of one seed (any whole number)."""
    return np.random.default_rng([seed & (2**64 - 1), stream])


def simulate_counts(n: int, traffic: dict, rng: np.random.Generator) -> np.ndarray:
    """(n, 4) int64 read counts of a diploid sample (A, C, G, T)."""
    cov_spec = traffic["coverage"]
    if cov_spec["distribution"] == "poisson":
        cov = rng.poisson(cov_spec["mean"], n)
    elif cov_spec["distribution"] == "negative_binomial":
        k = cov_spec["k"]
        cov = rng.negative_binomial(k, k / (k + cov_spec["mean"]), n)
    else:
        raise ValueError(f"unknown coverage distribution {cov_spec['distribution']!r}")
    cov = cov.clip(cov_spec.get("min", 1)).astype(np.int64)
    is_het = rng.uniform(size=n) < traffic["pi"]
    major = rng.integers(0, 4, n)
    counts = np.zeros((n, 4), np.int64)
    n_err = rng.binomial(cov, traffic["eps"])
    rows = np.arange(n)
    counts[rows, major] = cov - n_err
    het = np.flatnonzero(is_het)
    second = (major[het] + 1 + rng.integers(0, 3, het.size)) % 4
    half = counts[het, major[het]] // 2
    counts[het, major[het]] -= half
    counts[het, second] += half
    counts[rows, rng.integers(0, 4, n)] += n_err
    return counts


def _digits(x: np.ndarray) -> np.ndarray:
    return np.searchsorted(10 ** np.arange(1, 19, dtype=np.int64), x, side="right") + 1


def _number_columns(x: np.ndarray, width: int):
    """(values, lengths) of ``width`` one-byte columns holding the decimal
    digits of x, most significant first; the columns left of a number's
    first digit have length 0."""
    values = np.empty((x.shape[0], width), np.uint8)
    y = x.copy()
    for j in range(width - 1, -1, -1):
        values[:, j] = 48 + y % 10
        y //= 10
    lengths = (np.arange(width) >= width - _digits(x)[:, None]).astype(np.int64)
    return values, lengths


def _site_order(counts: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Each read's base (0..3), site by site, in an order drawn at random
    within its site (only sites with two or more bases need the draw)."""
    n = counts.shape[0]
    allele = np.repeat(np.tile(np.arange(4, dtype=np.uint8), n), counts.ravel())
    site = np.repeat(np.arange(n), counts.sum(1))
    mixed = np.flatnonzero(((counts > 0).sum(1) > 1)[site])
    order = np.argsort(site[mixed] + rng.random(mixed.size), kind="stable")
    allele[mixed] = allele[mixed[order]]
    return allele


def render(counts: np.ndarray, first_pos: int, chrom: bytes, traffic: dict, rng: np.random.Generator) -> np.ndarray:
    """The mpileup lines of ``counts`` from position ``first_pos``, as a
    uint8 array. A read is up to four bytes: ``^`` and its mapping quality
    where it starts at the site, its base (upper case on the forward
    strand, lower on the reverse), and ``$`` where it ends there; reads
    ending at the site come first and reads starting there last, as
    samtools orders them by their alignments' starts. The heads, the reads
    and the base qualities are each made as one array, and one gather
    interleaves their lines' segments."""
    n = counts.shape[0]
    cov = counts.sum(1)
    reads = int(cov.sum())
    pos = np.arange(first_pos, first_pos + n, dtype=np.int64)
    pos_v, pos_l = _number_columns(pos, int(_digits(pos).max()))
    cov_v, cov_l = _number_columns(cov, int(_digits(cov).max()))

    def const(text: bytes):
        return np.tile(np.frombuffer(text, np.uint8), (n, 1)), np.ones((n, len(text)), np.int64)

    head = [const(chrom + b"\t"), (pos_v, pos_l), const(b"\tN\t"), (cov_v, cov_l), const(b"\t")]
    head_in = np.concatenate([length for _, length in head], 1).astype(bool)
    heads = np.concatenate([v for v, _ in head], 1)[head_in]

    p_end = 1.0 / traffic["read_length"]
    n_start, n_end = rng.binomial(cov, p_end), rng.binomial(cov, p_end)
    site_first = np.cumsum(cov) - cov
    r = np.arange(reads)
    tokens = np.empty((reads, 4), np.uint8)
    tokens_in = np.ones((reads, 4), bool)
    tokens[:, 0], tokens_in[:, 0] = ord("^"), r >= np.repeat(site_first + cov - n_start, cov)
    mq_column = traffic.get("read_mapping_quality")
    if mq_column is None:
        lo, hi = traffic["mapping_quality"]
        tokens[:, 1] = rng.integers(33 + lo, 34 + hi, reads, dtype=np.uint8)
    else:
        top = rng.random(reads) < mq_column["p_top"]
        lo, hi = mq_column["others"]
        tokens[:, 1] = np.where(top, 33 + mq_column["top"], rng.integers(33 + lo, 34 + hi, reads, dtype=np.uint8))
    mqs = tokens[:, 1].copy()
    tokens_in[:, 1] = tokens_in[:, 0]
    strand = (rng.random(reads) < traffic["reverse_strand"]).astype(np.uint8) << 5
    tokens[:, 2] = BASES[_site_order(counts, rng)] | strand
    tokens[:, 3], tokens_in[:, 3] = ord("$"), r < np.repeat(site_first + n_end, cov)
    tokens = tokens[tokens_in]
    lo, hi = traffic["base_quality"]
    quals = rng.integers(33 + lo, 34 + hi, reads, dtype=np.uint8)

    # each line: its head, its reads, a tab, its base qualities, (a tab,
    # its mapping qualities,) a newline
    columns = [quals] if mq_column is None else [quals, mqs]
    stream = np.concatenate([heads, tokens, *columns, np.frombuffer(b"\t\n", np.uint8)])
    tab = stream.size - 2
    head_len = head_in.sum(1)
    token_len = cov + 2 * n_start + n_end
    one = np.ones(n, np.int64)
    src = [np.cumsum(head_len) - head_len, heads.size + np.cumsum(token_len) - token_len]
    length = [head_len, token_len]
    for k in range(len(columns)):
        src += [np.full(n, tab), heads.size + tokens.size + k * reads + site_first]
        length += [one, cov]
    src, length = np.stack(src + [np.full(n, tab + 1)], 1).ravel(), np.stack(length + [one], 1).ravel()
    return stream[np.repeat(src - (np.cumsum(length) - length), length) + np.arange(int(length.sum()))]


def _retile(body: np.ndarray, chrom: bytes, first_pos: int, n: int) -> np.ndarray:
    """A copy of ``body`` (n lines from some position) with its positions
    rewritten to start at ``first_pos``; both have the same widths."""
    out = body.copy()
    start = np.concatenate([[0], np.flatnonzero(out == 10)[:-1] + 1])
    pos = np.arange(first_pos, first_pos + n, dtype=np.int64)
    width = int(_digits(pos[:1])[0])
    at = start + len(chrom) + 1
    for j in range(width - 1, -1, -1):
        out[at + j] = 48 + pos % 10
        pos //= 10
    return out


def bodies(traffic: dict, seed: int, threads: int = 8):
    """The input's tiles for ``seed``, in order, as uint8 arrays; its
    distinct bodies drawn on ``threads`` threads."""
    sites, body_sites = traffic["sites"], traffic["body_sites"]
    distinct = traffic["distinct_bodies"]
    first = traffic["first_pos"]
    chrom = traffic["chrom"].encode()
    if sites % body_sites:
        raise ValueError("sites must be a multiple of body_sites")
    tiles = sites // body_sites
    if distinct < tiles and _digits(np.array([first]))[0] != _digits(np.array([first + sites - 1]))[0]:
        raise ValueError("tiled bodies need positions of one width")

    def draw(k: int) -> np.ndarray:
        rng = _rng(seed, k)
        return render(simulate_counts(body_sites, traffic, rng), first + k * body_sites, chrom, traffic, rng)

    with ThreadPoolExecutor(threads) as pool:
        drawn = list(pool.map(draw, range(min(distinct, tiles))))
    for k in range(tiles):
        yield drawn[k] if k < distinct else _retile(drawn[k % distinct], chrom, first + k * body_sites, body_sites)


def make_pileup(traffic: dict, seed: int) -> bytes:
    """The traffic's input for ``seed``, as bytes."""
    return b"".join(memoryview(tile) for tile in bodies(traffic, seed))


def write_pileup(traffic: dict, seed: int, path: str) -> int:
    """The traffic's input for ``seed`` written to ``path``, synced to
    the disk; returns its size in bytes."""
    size = 0
    with open(path, "wb") as f:
        for tile in bodies(traffic, seed):
            f.write(memoryview(tile))
            size += tile.size
        f.flush()
        os.fsync(f.fileno())
    return size
