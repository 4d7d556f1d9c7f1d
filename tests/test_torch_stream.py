"""The port's streaming engine and checkpoints vs sid_tpu's, on the CPU.

The counterpart of ``tests/test_streaming.py`` and ``tests/test_checkpoint.py``:
chunking (newline alignment, gzip by magic, byte ranges), the pass-1
histogram, ``run_streaming`` byte-equal to ``engine.run`` and to
``sid_tpu.engine.run_streaming`` (with the same diagnostic lines) for all
four methods and an unknown ``-m``, the pass-1 checkpoint skip, pass-2
resume, a corrupt sidecar, a suffixless checkpoint path, and checkpoints
that cross between the two packages in both directions.
"""

import gzip
import io
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

pytest.importorskip("torch")

from sid_tpu import engine as ref_engine  # noqa: E402
from sid_tpu.config import Options as RefOptions  # noqa: E402
from sid_tpu.io import stream as ref_stream  # noqa: E402
from sid_tpu.io.pileup import parse_pileup as ref_parse  # noqa: E402
from sid_tpu.models import common as ref_common  # noqa: E402
from sid_tpu.utils import checkpoint as ref_ckpt  # noqa: E402
from sid_tpu_torch import engine  # noqa: E402
from sid_tpu_torch.config import Options  # noqa: E402
from sid_tpu_torch.io import stream  # noqa: E402
from sid_tpu_torch.io.pileup import parse_pileup  # noqa: E402
from sid_tpu_torch.models import common  # noqa: E402
from sid_tpu_torch.ops.profiles import unique_profiles  # noqa: E402
from sid_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from synth import make_pileup_text, simulate_diploid_counts  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 1 << 14
HEADER = "chrom,pos,label,gt,hom_conf,het_conf,conf_type\n"


@pytest.fixture(scope="module")
def text():
    counts = simulate_diploid_counts(2500, coverage=18, pi=0.03, eps=0.01, seed=3)
    return make_pileup_text(counts, with_qualities=True, seed=4)


class TestIterChunks:
    def test_newline_alignment(self, text):
        chunks = list(stream.iter_chunks(text, chunk_bytes=1 << 12))
        assert b"".join(chunks) == text and len(chunks) > 10
        assert all(c.endswith(b"\n") for c in chunks)
        assert chunks == list(ref_stream.iter_chunks(text, chunk_bytes=1 << 12))

    def test_single_chunk(self, text):
        assert list(stream.iter_chunks(text, chunk_bytes=1 << 30)) == [text]

    def test_no_trailing_newline(self):
        data = b"c\t1\tA\t1\t.\nc\t2\tA\t1\t."
        assert list(stream.iter_chunks(data, 4)) == [b"c\t1\tA\t1\t.\n", b"c\t2\tA\t1\t."]

    @pytest.mark.parametrize("seed", range(4))
    def test_cut_in_place_equals_the_stream_loop(self, tmp_path, seed):
        """Plain bytes and plain files are cut in place (one copy a chunk):
        the chunks of sid_tpu's stream loop, for lines longer and shorter
        than a chunk, with and without a last newline, and an empty file."""
        rng = np.random.default_rng(seed)
        path = tmp_path / "in.txt"
        for _ in range(50):
            lines = [b"x" * int(k) for k in rng.integers(0, 40, rng.integers(0, 30))]
            data = b"\n".join(lines) + [b"", b"\n", b"tail"][rng.integers(3)]
            chunk = int(rng.integers(1, 60))
            want = list(ref_stream.iter_chunks(io.BytesIO(data), chunk))
            path.write_bytes(data)
            assert list(stream.iter_chunks(data, chunk)) == want
            assert list(stream.iter_chunks(str(path), chunk)) == want
            assert list(stream.iter_chunks(io.BytesIO(data), chunk)) == want

    def test_gzip_by_magic(self, text, tmp_path):
        gz = gzip.compress(text)
        path = tmp_path / "renamed.txt"  # no .gz suffix: detected by content
        path.write_bytes(gz)
        for src in (gz, str(path), io.BufferedReader(io.BytesIO(gz))):
            chunks = list(stream.iter_chunks(src, chunk_bytes=1 << 12))
            assert b"".join(chunks) == text
            assert all(c.endswith(b"\n") for c in chunks)

    def test_range_chunks(self, text, tmp_path):
        path = tmp_path / "in.pileup"
        path.write_bytes(text)
        cut = text.index(b"\n", len(text) // 2) + 1
        parts = [list(stream.iter_range_chunks(str(path), a, b, 1 << 11)) for a, b in ((0, cut), (cut, len(text)))]
        assert b"".join(parts[0]) == text[:cut] and b"".join(parts[1]) == text[cut:]
        assert parts[0] == list(ref_stream.iter_range_chunks(str(path), 0, cut, 1 << 11))

    def test_pack_unpack(self):
        prof = np.array([[0, 0, 0, 0], [65535, 1, 2, 3], [7, 65535, 0, 65535]], np.int32)
        keys = stream.pack_profiles(prof)
        assert np.array_equal(keys, ref_stream.pack_profiles(prof))
        assert np.array_equal(stream.unpack_profiles(keys), prof)
        assert (np.diff(stream.pack_profiles(np.sort(prof, axis=0))) >= 0).all()


def test_histogram_matches_unique_profiles_and_sid_tpu(text):
    batch = parse_pileup(text)
    want_p, want_m, _ = unique_profiles(batch.counts)
    got_p, got_m, total = stream.accumulate_histogram(text, chunk_bytes=1 << 13)
    assert total == batch.num_sites
    assert np.array_equal(got_p, want_p) and np.array_equal(got_m, want_m)
    ref_p, ref_m, ref_total = ref_stream.accumulate_histogram(text, chunk_bytes=1 << 13)
    assert np.array_equal(got_p, ref_p) and np.array_equal(got_m, ref_m) and total == ref_total
    py_p, py_m, _ = stream.accumulate_histogram(text, chunk_bytes=1 << 13, backend="python")
    assert np.array_equal(py_p, got_p) and np.array_equal(py_m, got_m)


def test_join_class_table_matches_sid_tpu(text):
    batch = parse_pileup(text)
    prof, _, _ = unique_profiles(batch.counts)
    keep = prof.sum(-1) >= 20  # a table that misses some sites' profiles
    keys = stream.pack_profiles(prof[keep])
    u = int(keep.sum())
    rng = np.random.default_rng(0)
    cls = (rng.uniform(size=u) < 0.3, rng.integers(0, 4, u).astype(np.int32),
           rng.integers(0, 4, u).astype(np.int32), rng.uniform(size=u), rng.uniform(size=u))
    got = common.join_class_table(batch, keys, cls, "p_value")
    want = ref_common.join_class_table(ref_parse(text), keys, cls, "p_value")
    assert 0 < got.num_records < batch.num_sites
    assert got.to_csv_bytes() == want.to_csv_bytes()
    # the class table as given, an int32 row a site
    assert all(getattr(got, name).shape == (u,) for name in common.ANSWER)
    assert got.class_idx.dtype == np.int32 and got.class_idx.shape == (got.num_records,)
    np.testing.assert_array_equal(got.per_site().conf_hom, want.conf_hom)
    empty = common.join_class_table(batch, keys[:0], tuple(c[:0] for c in cls), "p_value")
    assert empty.num_records == 0


STREAM_CASES = {
    "local": {},
    "local-R": {"estimate_prior": True},
    "local-r": {"snp_prior": 1e-3},
    "bayes": {"method": "bayes"},
    "likelihood_ratio": {"method": "likelihood_ratio"},
    "likelihood_ratio-R": {"method": "likelihood_ratio", "estimate_prior": True},
    "quality": {"method": "quality"},
    "quality-R": {"method": "quality", "estimate_prior": True},
    "quality-io-python": {"method": "quality", "io_backend": "python"},
}


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_stream_equals_batch_and_sid_tpu(text, case):
    kw = STREAM_CASES[case]
    whole = engine.run(text, Options(platform="cpu", **kw), binary=True)
    got_diag, want_diag = [], []
    buf = io.BytesIO()
    n = engine.run_streaming(text, Options(platform="cpu", **kw), buf, got_diag.append, chunk_bytes=CHUNK)
    assert buf.getvalue() == whole
    assert n == whole.count(b"\n") - 1
    ref_buf = io.BytesIO()
    ref_engine.run_streaming(text, RefOptions(**kw), ref_buf, want_diag.append, chunk_bytes=CHUNK)
    assert buf.getvalue() == ref_buf.getvalue()
    assert got_diag == want_diag


def test_stream_text_sink_and_gzip_input(text, tmp_path):
    whole = engine.run(text, Options(platform="cpu", method="bayes"))
    path = tmp_path / "in.pileup.gz"
    path.write_bytes(gzip.compress(text))
    buf = io.StringIO()
    engine.run_streaming(str(path), Options(platform="cpu", method="bayes"), buf, chunk_bytes=CHUNK)
    assert buf.getvalue() == whole


def test_stream_unknown_method(text):
    buf = io.StringIO()
    assert engine.run_streaming(text, Options(platform="cpu", method="bogus"), buf) == 0
    assert buf.getvalue() == HEADER


def test_stream_rejects_nonseekable():
    with pytest.raises(TypeError):
        engine.run_streaming(io.BytesIO(b"x"), Options(platform="cpu"))


def test_fit_state_roundtrip(tmp_path):
    p = str(tmp_path / "state.npz")
    profiles = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    mult = np.array([10, 20], np.int64)
    ckpt.save_fit_state(p, profiles, mult, pi=0.01, eps=0.005, nt=[0.3, 0.2, 0.3, 0.2])
    st = ckpt.load_fit_state(p)
    assert np.array_equal(st["profiles"], profiles) and np.array_equal(st["mult"], mult)
    assert st["pi"] == 0.01 and st["eps"] == 0.005
    assert ckpt.load_fit_state(str(tmp_path / "missing.npz")) is None
    assert ckpt.FIT_STATE_VERSION == ref_ckpt.FIT_STATE_VERSION == 2


def test_fingerprints(tmp_path):
    fp_a = ckpt.input_fingerprint(b"chr1\t1\tA\t2\t..\n")
    fp_b = ckpt.input_fingerprint(b"chr1\t1\tA\t2\tCC\n")
    assert fp_a != fp_b
    p = str(tmp_path / "state.npz")
    ckpt.save_fit_state(p, np.array([[1, 2, 3, 4]]), np.array([3]), fingerprint=fp_a)
    assert ckpt.load_fit_state(p, fingerprint=fp_a) is not None
    assert ckpt.load_fit_state(p, fingerprint=fp_b) is None
    assert ckpt.load_fit_state(p) is not None
    data = b"chr1\t1\tA\t2\t..\n" * 200_000  # past the 1 MiB head and tail windows
    f = tmp_path / "in.pileup"
    f.write_bytes(data)
    assert ckpt.input_fingerprint(str(f)) == ckpt.input_fingerprint(data) == ref_ckpt.input_fingerprint(data)


def test_suffixless_checkpoint_path(tmp_path):
    p = str(tmp_path / "ckpt")  # no .npz: np.savez appends it, load must agree
    ckpt.save_fit_state(p, np.array([[5, 1, 0, 0]], np.int32), np.array([10]), fingerprint="fp1")
    assert os.path.exists(p + ".npz")
    assert ckpt.load_fit_state(p, fingerprint="fp1") is not None
    assert ckpt.load_fit_state(p, fingerprint="other") is None


def test_corrupt_sidecar_truncates_stale_output(text, tmp_path):
    want = engine.run(text, Options(platform="cpu"))
    out_path = str(tmp_path / "out.csv")
    with open(out_path, "w") as f:
        f.write(want + "STALE-TRAILING-ROWS\n" * 50)
    with open(out_path + ".progress.json", "w") as f:
        f.write("{not json")
    with open(out_path, "r+") as out:
        engine.run_streaming(text, Options(platform="cpu"), out, chunk_bytes=1 << 13,
                             progress=ckpt.StreamProgress(out_path), resume=True)
    assert open(out_path).read() == want


@pytest.mark.parametrize("method", ["bayes", "quality"])
def test_checkpoint_skips_pass1(text, tmp_path, monkeypatch, method):
    kw = {"method": method, "estimate_prior": True, "platform": "cpu"}
    path = str(tmp_path / "hist.npz")
    first = io.BytesIO()
    engine.run_streaming(text, Options(**kw), first, chunk_bytes=CHUNK, checkpoint=path)
    assert os.path.exists(path)

    def no_pass1(*a, **k):
        raise AssertionError("pass 1 ran despite the checkpoint")

    monkeypatch.setattr(engine, "accumulate_histogram", no_pass1)
    again = io.BytesIO()
    engine.run_streaming(text, Options(**kw), again, chunk_bytes=CHUNK, checkpoint=path, resume=True)
    assert again.getvalue() == first.getvalue()
    # another input's fingerprint rejects the checkpoint: pass 1 must run
    with pytest.raises(AssertionError, match="pass 1 ran"):
        engine.run_streaming(text + text[:200], Options(**kw), io.BytesIO(), chunk_bytes=CHUNK,
                             checkpoint=path, resume=True)


def _interrupted(run, text, opts, out_path, progress_cls, chunks):
    """Stream into out_path and stop after ``chunks`` chunks."""
    progress = progress_cls(out_path)
    real_save = progress.save

    class Stop(Exception):
        pass

    def save(done, written):
        real_save(done, written)
        if done >= chunks:
            raise Stop()

    progress.save = save
    with pytest.raises(Stop), open(out_path, "wb") as out:
        run(text, opts, out, chunk_bytes=1 << 13, progress=progress)
    assert progress_cls(out_path).load()[0] == chunks


@pytest.mark.parametrize("method", ["local", "quality"])
def test_pass2_resume(text, tmp_path, method):
    want = engine.run(text, Options(platform="cpu", method=method), binary=True)
    out_path = str(tmp_path / "out.csv")
    _interrupted(engine.run_streaming, text, Options(platform="cpu", method=method), out_path,
                 ckpt.StreamProgress, 2)
    progress = ckpt.StreamProgress(out_path)
    with open(out_path, "r+b") as out:
        engine.run_streaming(text, Options(platform="cpu", method=method), out, chunk_bytes=1 << 13,
                             progress=progress, resume=True)
    assert open(out_path, "rb").read() == want
    assert not os.path.exists(progress.sidecar)


@pytest.mark.parametrize("writer", ["sid_tpu", "port"])
def test_checkpoints_cross_between_packages(text, tmp_path, monkeypatch, writer):
    """A pass-1 checkpoint and an interrupted pass 2 left by one package are
    resumed by the other, with the first package's bytes."""
    ports = {"sid_tpu": (ref_engine.run_streaming, RefOptions, ref_ckpt.StreamProgress, {}),
             "port": (engine.run_streaming, Options, ckpt.StreamProgress, {"platform": "cpu"})}
    run_a, opts_a, prog_a, extra_a = ports[writer]
    run_b, opts_b, prog_b, extra_b = ports["port" if writer == "sid_tpu" else "sid_tpu"]
    kw = {"method": "likelihood_ratio", "estimate_prior": True}
    want = ref_engine.run(text, RefOptions(**kw), binary=True)
    hist = str(tmp_path / "hist")
    out_path = str(tmp_path / "out.csv")
    run_a(text, opts_a(**kw, **extra_a), io.BytesIO(), chunk_bytes=CHUNK, checkpoint=hist)
    _interrupted(run_a, text, opts_a(**kw, **extra_a), out_path, prog_a, 3)
    # pass 1 of either package would fail: the resumer must take the checkpoint
    monkeypatch.setattr(engine, "accumulate_histogram", None)
    monkeypatch.setattr(ref_stream, "accumulate_histogram", None)
    with open(out_path, "r+b") as out:
        run_b(text, opts_b(**kw, **extra_b), out, chunk_bytes=1 << 13, checkpoint=hist, resume=True,
              progress=prog_b(out_path))
    assert open(out_path, "rb").read() == want
    assert not os.path.exists(out_path + ".progress.json")
    state = (ref_ckpt if writer == "port" else ckpt).load_fit_state(hist, ckpt.input_fingerprint(text))
    assert state is not None and state["profiles"].shape[0] > 100


def test_cli_stream_checkpoint_resume_same_as_sid_tpu(text, tmp_path):
    """``--stream --checkpoint --output`` and then ``--resume``, through both
    CLIs, each in a directory of its own: the same files, stdout and stderr."""
    args = ["--platform", "cpu", "--stream", "--chunk-mb", "1", "-R", "-m", "likelihood_ratio",
            "--checkpoint", "ck", "--output", "out.csv", "in.pileup"]

    def both_runs(tool):
        cwd = tmp_path / tool
        cwd.mkdir()
        (cwd / "in.pileup").write_bytes(text)
        runs = []
        for extra in ([], ["--resume"]):
            proc = subprocess.run([os.path.join(REPO, tool)] + args + extra, capture_output=True,
                                  cwd=cwd, timeout=300)
            runs.append((proc.returncode, proc.stdout, proc.stderr, (cwd / "out.csv").read_bytes()))
        return runs + [sorted(os.listdir(cwd))]

    with ThreadPoolExecutor(2) as ex:
        got, want = ex.map(both_runs, ["sid-tpu-torch", "sid-tpu"])
    assert got == want
    assert want[0][0] == 0 and want[0][3] == want[1][3] and want[0][3].count(b"\n") > 100
    assert want[2] == ["ck.npz", "in.pileup", "out.csv"]
