"""ctypes interface to libsidtpu (``sid_tpu_torch/csrc/host/parser.cpp``, the
port's copy of ``sid_tpu/native/parser.cpp``).

Declares every entry point the port calls — the threaded parser
(``sidtpu_parse_ex``, with the quality method's inline per-site terms of
parse flags 1 and 2), the unique-profile histogram, the two ``%g`` CSV
writers, the glibc-libm erfc and LRT, the long-double ``local`` classifier,
the long-double Lynch objective and marginals, and the fused host quality
finalize — and marshals numpy arrays in and out. The (256, 4) Phred term
table the parser sums from is this module's own numpy copy
(``quality_term_tables``), injected into the library when it is configured.

The port's indexed results are written by its own library, libsidtpu_csv
(``csrc/host/csv_writer.cpp``, ``configure_csv``): every row once, in place,
into a buffer of the exact size planned first (``csv_plan``); libsidtpu's
indexed writer stays the oracle it is tested against.
"""

from __future__ import annotations

import contextlib
import ctypes
import struct
from typing import Callable, Iterator, List, Tuple

import numpy as np
from scipy.special import gammaln

from sid_tpu_torch.utils.errors import MALFORMED, MALFORMED_OR_MISSING, ErrorChannel

_vp = ctypes.c_void_p
_i32 = ctypes.c_int
_i64 = ctypes.c_int64
_f64 = ctypes.c_double
_P_I32 = ctypes.POINTER(ctypes.c_int32)
_P_U8 = ctypes.POINTER(ctypes.c_uint8)
_P_U16 = ctypes.POINTER(ctypes.c_uint16)
_P_I64 = ctypes.POINTER(ctypes.c_int64)
_P_F64 = ctypes.POINTER(ctypes.c_double)
_P_LD = ctypes.POINTER(ctypes.c_longdouble)
_P_CHAR = ctypes.POINTER(ctypes.c_char)

_SIGNATURES = {
    "sidtpu_parse_ex": (_vp, [_vp, _i64, _i32, _i32, _i32, _i32, _i32]),
    "sidtpu_num_sites": (_i64, [_vp]),
    "sidtpu_num_reads": (_i64, [_vp]),
    "sidtpu_num_errors": (_i64, [_vp]),
    "sidtpu_chrom_id": (_vp, [_vp]),
    "sidtpu_pos": (_vp, [_vp]),
    "sidtpu_ref_base": (_vp, [_vp]),
    "sidtpu_counts": (_vp, [_vp]),
    "sidtpu_read_offsets": (_vp, [_vp]),
    "sidtpu_read_code": (_vp, [_vp]),
    "sidtpu_read_strand": (_vp, [_vp]),
    "sidtpu_read_bq": (_vp, [_vp]),
    "sidtpu_read_mq": (_vp, [_vp]),
    "sidtpu_err_line": (_vp, [_vp]),
    "sidtpu_err_code": (_vp, [_vp]),
    "sidtpu_chrom_blob": (_vp, [_vp]),
    "sidtpu_chrom_blob_len": (_i64, [_vp]),
    "sidtpu_free": (None, [_vp]),
    "sidtpu_set_quality_table": (None, [_P_F64]),
    "sidtpu_num_terms": (_i64, [_vp]),
    "sidtpu_term_hom": (_vp, [_vp]),
    "sidtpu_term_het": (_vp, [_vp]),
    "sidtpu_term_major": (_vp, [_vp]),
    "sidtpu_term_second": (_vp, [_vp]),
    "sidtpu_unique_profiles": (_vp, [_P_U16, _i64, _i32]),
    "sidtpu_unique_num_classes": (_i64, [_vp]),
    "sidtpu_unique_class_profiles": (_vp, [_vp]),
    "sidtpu_unique_class_mult": (_vp, [_vp]),
    "sidtpu_unique_inverse": (_vp, [_vp]),
    "sidtpu_unique_free": (None, [_vp]),
    "sidtpu_write_csv": (_i64, [
        ctypes.c_char_p, _i64, _P_I32, _P_I32, _P_U8, _P_I32, _P_I32,
        _P_F64, _P_F64, ctypes.c_char_p, _i64, _i32, _i32,
        ctypes.POINTER(_P_CHAR),
    ]),
    "sidtpu_write_csv_indexed": (_i64, [
        ctypes.c_char_p, _i64, _P_I32, _P_I32, _P_I32, _i64, _P_U8, _P_I32,
        _P_I32, _P_F64, _P_F64, _i64, ctypes.c_char_p, _i32, _i32,
        ctypes.POINTER(_P_CHAR),
    ]),
    "sidtpu_buffer_free": (None, [_P_CHAR]),
    "sidtpu_erfc": (None, [_P_F64, _P_F64, _i64]),
    "sidtpu_lrt_pvalues": (None, [_P_F64, _P_F64, _P_F64, _i64, _i32]),
    "sidtpu_local_classify_ld": (None, [
        _P_I32, _P_F64, _P_I32, _P_I32, _f64, _f64, _f64, _i64, _P_F64,
        _P_F64, _P_U8, _i32,
    ]),
    "sidtpu_compound_nll_ld": (_f64, [_P_I32, _P_I64, _P_F64, _P_F64, _f64, _f64, _i64, _i32]),
    "sidtpu_lynch_marginals_ld": (None, [_P_I32, _P_F64, _P_F64, _f64, _i64, _P_LD, _P_LD, _i32]),
    "sidtpu_quality_finalize": (_i32, [
        _P_U16, _P_I32, _P_I32, _P_F64, _P_F64, _P_F64, _i64, _f64, _f64, _i32,
        _f64, _f64, _i64, _P_F64, _P_F64, _P_U8, _i32,
    ]),
}

_CSV_SIGNATURES = {
    "sidtpu_csv_plan": (_vp, [
        ctypes.c_char_p, _i64, _P_I32, _P_I32, _P_I32, _i64, _P_U8, _P_I32,
        _P_I32, _P_F64, _P_F64, _i64, ctypes.c_char_p, _i32, _i32, _vp,
    ]),
    "sidtpu_csv_total": (_i64, [_vp]),
    "sidtpu_csv_fill": (_i64, [_vp, _vp]),
    "sidtpu_csv_free": (None, [_vp]),
}

# parse flags of sidtpu_parse_ex: per-site quality terms inline, and terms only
PARSE_TERMS = 1
PARSE_TERMS_ONLY = 2

_term_table = None


def quality_term_tables() -> np.ndarray:
    """(256, 4) f64 table of per-read log terms by Phred value q:
    [ln(1-e), ln(e), ln(1-2e/3), ln(2e/3)] with e = 10^(-q/10) (call.cpp:331-342
    computes these per read); the expressions of sid_tpu's
    ``models/quality.py::quality_term_tables``, so the same bits."""
    global _term_table
    if _term_table is None:
        q = np.arange(256, dtype=np.float64)
        e = np.power(10.0, q / -10.0)
        with np.errstate(divide="ignore"):
            _term_table = np.stack(
                [np.log(1.0 - e), np.log(e), np.log(1.0 - 2.0 / 3.0 * e),
                 np.log(2.0 / 3.0 * e)], axis=1,
            )
    return _term_table


def configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare restype/argtypes of every entry point the port calls, and
    inject the Phred term table the parser's inline quality sums read."""
    _declare(lib, _SIGNATURES)
    tab = np.ascontiguousarray(quality_term_tables(), np.float64)
    lib.sidtpu_set_quality_table(_ptr(tab, _P_F64))  # the library copies it
    return lib


def _declare(lib: ctypes.CDLL, signatures) -> None:
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def _ptr(a: np.ndarray, ptype):
    return a.ctypes.data_as(ptype)


def encode_chrom_blob(names) -> bytes:
    """[u32 len][bytes]... — names may contain any byte."""
    return b"".join(
        struct.pack("<I", len(raw)) + raw for raw in (n.encode("latin1") for n in names)
    )


def decode_chrom_blob(blob: bytes) -> List[str]:
    out = []
    i = 0
    while i + 4 <= len(blob):
        (ln,) = struct.unpack_from("<I", blob, i)
        i += 4
        out.append(blob[i : i + ln].decode("latin1"))
        i += ln
    return out


def _as_array(ptr, ctype, count, dtype) -> np.ndarray:
    """Copy ``count`` native ``ctype`` values at ``ptr`` into a numpy array."""
    if count == 0:
        return np.zeros(0, dtype)
    arr = np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctype)), shape=(count,))
    return arr.astype(dtype, copy=True)


def _parse_in_place(lib, data, *args):
    """``sidtpu_parse_ex`` over ``data``'s own bytes (any contiguous byte
    buffer; ``np.frombuffer`` raises on another). The array that gives
    their address lives for the call alone, so no export of ``data``
    outlives it: the parse keeps copies of what it returns."""
    buf = np.frombuffer(data, np.uint8)
    return lib.sidtpu_parse_ex(buf.ctypes.data, buf.size, *args)


def parse(lib, data, parse_bq: bool, parse_mq: bool, errors: ErrorChannel,
          terms_only: bool = False) -> dict:
    """Threaded native parse of a whole buffer, read in place (bytes,
    bytearray, a memoryview or a numpy uint8 array): the PileupBatch fields
    as numpy arrays, none of them over ``data``. Malformed lines go to
    ``errors``.

    With both quality columns the parser also sums the quality method's
    per-site terms inline (``q_log_hom``, ``q_log_het``, ``q_major``,
    ``q_second``; bitwise ``models/quality.py::accumulate_read_terms``'s
    sequential order), and returns the per-read arrays unless
    ``terms_only``. With one quality column it returns the per-read arrays
    alone.
    """
    flags = 0
    if parse_bq and parse_mq:
        flags = PARSE_TERMS | (PARSE_TERMS_ONLY if terms_only else 0)
    res = _parse_in_place(lib, data, int(parse_bq), int(parse_mq), int(errors.strict), 0, flags)
    try:
        n_err = lib.sidtpu_num_errors(res)
        if n_err:
            err_lines = _as_array(lib.sidtpu_err_line(res), ctypes.c_int64, n_err, np.int64)
            err_codes = _as_array(lib.sidtpu_err_code(res), ctypes.c_int32, n_err, np.int32)
            for ln, code in zip(err_lines, err_codes):
                # strict channels raise on the first report
                errors.report(int(ln), MALFORMED_OR_MISSING if code == 1 else MALFORMED)
        n = lib.sidtpu_num_sites(res)
        blob_len = lib.sidtpu_chrom_blob_len(res)
        blob = ctypes.string_at(lib.sidtpu_chrom_blob(res), blob_len) if blob_len else b""
        fields = dict(
            chrom_id=_as_array(lib.sidtpu_chrom_id(res), ctypes.c_int32, n, np.int32),
            chrom_table=decode_chrom_blob(blob),
            pos=_as_array(lib.sidtpu_pos(res), ctypes.c_int32, n, np.int32),
            ref_base=_as_array(lib.sidtpu_ref_base(res), ctypes.c_uint8, n, np.uint8),
            counts=_as_array(
                lib.sidtpu_counts(res), ctypes.c_uint16, n * 4, np.uint16
            ).reshape(-1, 4),
        )
        if (parse_bq or parse_mq) and not flags & PARSE_TERMS_ONLY:
            r = lib.sidtpu_num_reads(res)
            fields.update(
                read_offsets=_as_array(lib.sidtpu_read_offsets(res), ctypes.c_int64, n + 1, np.int64),
                read_code=_as_array(lib.sidtpu_read_code(res), ctypes.c_int8, r, np.int8),
                read_strand=_as_array(lib.sidtpu_read_strand(res), ctypes.c_uint8, r, np.uint8),
                read_bq=_as_array(lib.sidtpu_read_bq(res), ctypes.c_uint8, r, np.uint8),
                read_mq=_as_array(lib.sidtpu_read_mq(res), ctypes.c_uint8, r, np.uint8),
            )
        if flags & PARSE_TERMS and lib.sidtpu_num_terms(res) == n:
            fields.update(
                q_log_hom=_as_array(lib.sidtpu_term_hom(res), ctypes.c_double, n, np.float64),
                q_log_het=_as_array(lib.sidtpu_term_het(res), ctypes.c_double, n, np.float64),
                q_major=_as_array(lib.sidtpu_term_major(res), ctypes.c_int8, n, np.int32),
                q_second=_as_array(lib.sidtpu_term_second(res), ctypes.c_int8, n, np.int32),
            )
        return fields
    finally:
        lib.sidtpu_free(res)


def unique_profiles(lib, counts: np.ndarray):
    """Threaded unique-profile histogram.

    Returns (profiles (U,4) int32 sorted, mult (U,) int64, inverse (N,)
    int32) — the contract of ops.profiles.unique_profiles.
    """
    arr = np.ascontiguousarray(counts, np.uint16)
    n = arr.shape[0]
    res = lib.sidtpu_unique_profiles(_ptr(arr, _P_U16), n, 0)
    try:
        u = lib.sidtpu_unique_num_classes(res)
        profiles = _as_array(
            lib.sidtpu_unique_class_profiles(res), ctypes.c_uint16, u * 4, np.int32
        ).reshape(-1, 4)
        mult = _as_array(lib.sidtpu_unique_class_mult(res), ctypes.c_int64, u, np.int64)
        inverse = _as_array(lib.sidtpu_unique_inverse(res), ctypes.c_int32, n, np.int32)
        return profiles, mult, inverse
    finally:
        lib.sidtpu_unique_free(res)


def erfc_libm(lib, x: np.ndarray) -> np.ndarray:
    """Batched glibc erfc."""
    arr = np.ascontiguousarray(x, np.float64)
    out = np.empty_like(arr)
    lib.sidtpu_erfc(_ptr(arr, _P_F64), _ptr(out, _P_F64), arr.size)
    return out


def lrt_pvalues_libm(lib, log_l0: np.ndarray, log_l1: np.ndarray) -> np.ndarray:
    """Threaded LRT p-values in one native pass (chisq, sqrt, glibc erfc,
    -inf short-circuit); stats.cpp:29-37 on log-likelihoods."""
    a, b = np.broadcast_arrays(np.asarray(log_l0, np.float64), np.asarray(log_l1, np.float64))
    a = np.ascontiguousarray(a)
    b = np.ascontiguousarray(b)
    out = np.empty_like(a)
    lib.sidtpu_lrt_pvalues(_ptr(a, _P_F64), _ptr(b, _P_F64), _ptr(out, _P_F64), a.size, 0)
    return out


def quality_finalize(lib, counts, major, second, log_hom, log_het, snp_prior: float,
                     alpha: float, lgamma_tab, underflow_log: float):
    """The fused host quality finalize (``sidtpu_quality_finalize``,
    call.cpp:344-369 in one threaded pass): allele-balance binomial, the
    80-bit underflow clamp, the prior and both glibc LRT p-values.
    Returns (is_het, p1, p2) over the N sites; raises if the table does not
    cover the largest top-2 count sum + 1."""
    n = int(np.shape(log_hom)[0])
    counts = np.ascontiguousarray(counts[:n], np.uint16)
    major = np.ascontiguousarray(major[:n], np.int32)
    second = np.ascontiguousarray(second[:n], np.int32)
    log_hom = np.ascontiguousarray(log_hom[:n], np.float64)
    log_het = np.ascontiguousarray(log_het[:n], np.float64)
    tab = np.ascontiguousarray(lgamma_tab, np.float64)
    use_prior = snp_prior > 0
    # glibc log of the same f64 arguments sid_tpu passes
    lp_hom = float(np.log(np.float64(1.0 - snp_prior))) if use_prior else 0.0
    lp_het = float(np.log(np.float64(snp_prior))) if use_prior else 0.0
    p1 = np.empty(n, np.float64)
    p2 = np.empty(n, np.float64)
    het = np.empty(n, np.uint8)
    rc = lib.sidtpu_quality_finalize(
        _ptr(counts, _P_U16), _ptr(major, _P_I32), _ptr(second, _P_I32),
        _ptr(log_hom, _P_F64), _ptr(log_het, _P_F64), _ptr(tab, _P_F64), tab.shape[0],
        lp_hom, lp_het, int(use_prior), float(alpha), float(underflow_log), n,
        _ptr(p1, _P_F64), _ptr(p2, _P_F64), _ptr(het, _P_U8), 0,
    )
    if rc != 0:
        raise ValueError(f"the lgamma table ({tab.shape[0]} entries) does not cover the sites' top-2 counts")
    return het.astype(bool), p1, p2


def mc_log_f64(profiles: np.ndarray) -> np.ndarray:
    """The f64 log multinomial coefficients the long-double classifier takes:
    gammaln(cov+1) - sum gammaln(n_i+1), the oracle's exact expression
    (sid_tpu/exact/lynch_ld.py:_mc_log_f64)."""
    prof = np.asarray(profiles, np.int64)
    cov = prof.sum(axis=-1)
    return gammaln(cov + 1).astype(np.float64) - gammaln(prof + 1).astype(
        np.float64
    ).sum(axis=-1)


def local_classify_ld(lib, profiles, major, second, error_threshold: float,
                      snp_prior: float, alpha: float):
    """Per-profile ``local`` classification in long double (call.cpp:238-273).

    The host oracle path: threaded, bitwise-identical to sid_tpu's
    native_local_classify_ld. Returns (is_het, p1, p2) over the profiles.
    """
    prof = np.ascontiguousarray(profiles, np.int32)
    u = int(prof.shape[0])
    mc_log = np.ascontiguousarray(mc_log_f64(prof), np.float64)
    major = np.ascontiguousarray(major, np.int32)
    second = np.ascontiguousarray(second, np.int32)
    p1 = np.empty(u, np.float64)
    p2 = np.empty(u, np.float64)
    is_het = np.empty(u, np.uint8)
    lib.sidtpu_local_classify_ld(
        _ptr(prof, _P_I32), _ptr(mc_log, _P_F64), _ptr(major, _P_I32),
        _ptr(second, _P_I32), float(error_threshold), float(snp_prior),
        float(alpha), u, _ptr(p1, _P_F64), _ptr(p2, _P_F64), _ptr(is_het, _P_U8), 0,
    )
    return is_het.astype(bool), p1, p2


class NativeLynchLD:
    """The long-double Lynch objective and marginals (libsidtpu
    ``sidtpu_compound_nll_ld`` / ``sidtpu_lynch_marginals_ld``, lynch.cpp:17-61
    in the reference's precision) over ``rows`` of the profiles, all of them
    when None.

    The objective of a subset is the reference's sum over those rows alone
    (NaN and <= 0 likelihoods skipped, sequential long-double sum, the +-inf
    clamp, DBL_MAX outside the box); each row's marginals do not depend on
    the others. Bitwise sid_tpu's ``exact.lynch_ld.NativeLynchLD`` on the
    same rows.
    """

    def __init__(self, lib, profiles: np.ndarray, mult: np.ndarray, nt, rows=None):
        if np.dtype(np.longdouble).itemsize != ctypes.sizeof(ctypes.c_longdouble):
            raise RuntimeError("numpy longdouble and C long double differ in layout")
        prof = np.asarray(profiles)
        mult = np.asarray(mult)
        if rows is not None:
            prof, mult = prof[rows], mult[rows]
        self._lib = lib
        self._prof = np.ascontiguousarray(prof, np.int32)
        self._mult = np.ascontiguousarray(mult, np.int64)
        self._mc_log = np.ascontiguousarray(mc_log_f64(self._prof), np.float64)
        self._nt = np.ascontiguousarray(nt, np.float64)
        self._u = int(self._prof.shape[0])

    def objective(self, theta) -> float:
        """compoundLikelihood (lynch.cpp:37-61) at theta = (pi, epsilon)."""
        return float(self._lib.sidtpu_compound_nll_ld(
            _ptr(self._prof, _P_I32), _ptr(self._mult, _P_I64),
            _ptr(self._mc_log, _P_F64), _ptr(self._nt, _P_F64),
            float(theta[0]), float(theta[1]), self._u, 0,
        ))

    def marginals(self, eps: float):
        """(L_hom, L_het) as numpy longdouble arrays at epsilon."""
        l_hom = np.empty(self._u, np.longdouble)
        l_het = np.empty(self._u, np.longdouble)
        self._lib.sidtpu_lynch_marginals_ld(
            _ptr(self._prof, _P_I32), _ptr(self._mc_log, _P_F64), _ptr(self._nt, _P_F64),
            float(eps), self._u, _ptr(l_hom, _P_LD), _ptr(l_het, _P_LD), 0,
        )
        return l_hom, l_het


def _row_arrays(result):
    """What both writers take of a result: the chromosome blob, the sites'
    chromosomes and positions, and the five answer arrays, contiguous in
    the writers' dtypes."""
    return (
        encode_chrom_blob(result.chrom_table),
        np.ascontiguousarray(result.chrom_id, np.int32),
        np.ascontiguousarray(result.pos, np.int32),
        np.ascontiguousarray(result.is_het, np.uint8),
        np.ascontiguousarray(result.major, np.int32),
        np.ascontiguousarray(result.second, np.int32),
        np.ascontiguousarray(result.conf_hom, np.float64),
        np.ascontiguousarray(result.conf_het, np.float64),
    )


def write_csv(lib, result, include_header: bool) -> bytes:
    """libsidtpu's multithreaded per-site serializer (glibc %g == ostream
    default), for results without a class table."""
    blob, chrom_id, pos, is_het, major, second, ch, ct = _row_arrays(result)
    out = _P_CHAR()
    length = lib.sidtpu_write_csv(
        blob, len(blob), _ptr(chrom_id, _P_I32), _ptr(pos, _P_I32),
        _ptr(is_het, _P_U8), _ptr(major, _P_I32), _ptr(second, _P_I32),
        _ptr(ch, _P_F64), _ptr(ct, _P_F64), result.conf_type.encode(),
        result.num_records, int(include_header), 0, ctypes.byref(out),
    )
    try:
        return ctypes.string_at(out, length)
    finally:
        lib.sidtpu_buffer_free(out)


def configure_csv(csv: ctypes.CDLL) -> ctypes.CDLL:
    """Declare restype/argtypes of libsidtpu_csv's entry points."""
    _declare(csv, _CSV_SIGNATURES)
    return csv


@contextlib.contextmanager
def csv_plan(lib, csv, result, include_header: bool) -> Iterator[Tuple[int, Callable[[int], None]]]:
    """The indexed writer's two steps, for a result with a class table:
    entered, libsidtpu_csv ``csv`` has formatted each class once with
    libsidtpu ``lib``'s ``%g`` and summed every thread's rows' bytes, and
    gives (the CSV's exact size, ``fill``); ``fill(address)`` has each
    thread write its rows in place from ``address``, which must have that
    many writable bytes. A row's chromosome or class index outside its
    table raises ``ValueError`` on entry, before anything is written. The
    plan points into the row arrays held here; it is freed at the exit."""
    blob, chrom_id, pos, is_het, major, second, ch, ct = _row_arrays(result)
    class_idx = np.ascontiguousarray(result.class_idx, np.int32)
    plan = csv.sidtpu_csv_plan(
        blob, len(blob), _ptr(chrom_id, _P_I32), _ptr(pos, _P_I32),
        _ptr(class_idx, _P_I32), result.num_records, _ptr(is_het, _P_U8), _ptr(major, _P_I32),
        _ptr(second, _P_I32), _ptr(ch, _P_F64), _ptr(ct, _P_F64), ch.shape[0],
        result.conf_type.encode(), int(include_header), 0,
        ctypes.cast(lib.sidtpu_format_g, _vp),
    )
    try:  # the plan points into the arrays above, alive until it is freed
        total = csv.sidtpu_csv_total(plan)
        if total < 0:
            raise ValueError("a row's chromosome or class index lies outside its table")

        def fill(address: int) -> None:
            written = csv.sidtpu_csv_fill(plan, address)
            if written != total:
                raise RuntimeError(f"CSV writer wrote {written} bytes of a planned {total}")

        yield total, fill
    finally:
        csv.sidtpu_csv_free(plan)


def write_csv_indexed(lib, csv, result, include_header: bool) -> np.ndarray:
    """The CSV of a result with a class table as an exact-size uint8
    array: ``csv_plan``'s plan filled into a fresh array. Byte for byte
    libsidtpu's ``sidtpu_write_csv_indexed``; ``bytes.join`` and
    ``file.write`` take the array as it is."""
    with csv_plan(lib, csv, result, include_header) as (total, fill):
        out = np.empty(total, np.uint8)
        fill(out.ctypes.data)
    return out
