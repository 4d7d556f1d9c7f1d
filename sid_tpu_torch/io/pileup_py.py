"""Pure-Python mpileup parser with reference-exact grammar.

Implements the same observable behavior as the reference parser
(pileup.cpp:13-167): field tokenization on runs of space/tab, the read-bases
column grammar ('.'/',' reference resolution, case = strand, '^x' skip,
'+N'/'-N' indel skip, everything else dropped), and Phred+33 quality decoding
clamped to a minimum of 1 (pileup.cpp:159-163).

This is the correctness baseline and fallback; the throughput path is the
multithreaded C++ parser of csrc/host/parser.cpp (the port's copy of
sid_tpu/native/parser.cpp; same grammar, property-tested against this
implementation).

Deliberately reproduced quirks:
- '.'/',' resolve through toupper/tolower of the reference base, so a
  non-ACGT reference (e.g. 'N') makes them drop (pileup.cpp:78-83 + default).
- quality chars are decoded raw: ``(byte - 33) mod 256`` then clamped to >= 1
  (uint8 wraparound for bytes < 33, pileup.cpp:159-163).
- qualities are paired *positionally* with the filtered base list: the j-th
  surviving ACGT base takes the j-th raw quality char (call.cpp:330-331 pairs
  ``bases[j]`` with ``base_qualities[j]`` even though markers/'*' entries were
  dropped from ``bases`` but not from the quality columns).
- the base-quality column token is always consumed even when not parsed
  (pileup.cpp:47-48), and a missing base-quality token with
  parse_base_qualities=True decodes an empty quality vector (the reference
  null-checks the wrong variable at pileup.cpp:52 and would segfault; we
  treat it as a parse error in strict mode).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from sid_tpu_torch.utils.errors import MALFORMED, MALFORMED_OR_MISSING, ErrorChannel

# base byte -> (code 0..3, strand 1=forward)
_BASE_CODE = {}
for _i, (_up, _lo) in enumerate(zip(b"ACGT", b"acgt")):
    _BASE_CODE[_up] = (_i, 1)
    _BASE_CODE[_lo] = (_i, 0)

_DIGITS = frozenset(b"0123456789")


def tokenize(line: bytes) -> List[bytes]:
    """Split on runs of space/tab, like strtok_r(line, " \\t") (pileup.cpp:11)."""
    out = []
    i, n = 0, len(line)
    while i < n:
        while i < n and line[i] in (0x20, 0x09):
            i += 1
        j = i
        while j < n and line[j] not in (0x20, 0x09):
            j += 1
        if j > i:
            out.append(line[i:j])
        i = j
    return out


def _atoi(tok: bytes) -> int:
    """C atoi: optional sign, leading digits, 0 on no digits."""
    i, n = 0, len(tok)
    while i < n and tok[i : i + 1].isspace():
        i += 1
    sign = 1
    if i < n and tok[i] in (0x2B, 0x2D):  # + -
        sign = -1 if tok[i] == 0x2D else 1
        i += 1
    v = 0
    while i < n and tok[i] in _DIGITS:
        v = v * 10 + (tok[i] - 0x30)
        i += 1
    return sign * v


def parse_read_bases(read_bases: bytes, reference: int) -> Tuple[List[int], List[int], List[int]]:
    """Parse one read-bases column.

    Returns (base_codes, strands, counts4). Grammar per pileup.cpp:70-153.
    ``reference`` is the reference-base byte.
    """
    codes: List[int] = []
    strands: List[int] = []
    counts = [0, 0, 0, 0]
    ref_up = ord(chr(reference).upper()) if reference < 128 else reference
    ref_lo = ord(chr(reference).lower()) if reference < 128 else reference

    i, n = 0, len(read_bases)
    while i < n:
        b = read_bases[i]
        if b == 0x2E:  # '.'
            b = ref_up
        elif b == 0x2C:  # ','
            b = ref_lo
        hit = _BASE_CODE.get(b)
        if hit is not None:
            code, strand = hit
            codes.append(code)
            strands.append(strand)
            counts[code] = (counts[code] + 1) & 0xFFFF  # uint16 semantics
        elif b == 0x5E:  # '^' skips the following mapping-quality char
            i += 1
        elif b in (0x2B, 0x2D):  # '+' / '-' indel
            if i + 1 < n and read_bases[i + 1] in _DIGITS:
                j = i + 1
                while j < n and read_bases[j] in _DIGITS:
                    j += 1
                length = int(read_bases[i + 1 : j])
                i = j + length - 1  # last consumed char; +1 below
                if i >= n:
                    break
            # '+'/'-' not followed by a digit is ignored (pileup.cpp:131-133)
        # everything else ('$', '*', 'N', 'n', '<', '>') is dropped
        i += 1
    return codes, strands, counts


def parse_qualities(tok: bytes) -> List[int]:
    """Phred+33 decode with uint8 wraparound, clamped to >= 1 (pileup.cpp:155-167)."""
    out = []
    for b in tok:
        if b in (0x09, 0x0A):  # stops at tab/newline (never present post-tokenize)
            break
        q = (b - 33) & 0xFF
        out.append(1 if q < 1 else q)
    return out


class ParsedLine:
    """Python analogue of the reference PileupLine (pileup.hpp:9-18)."""

    __slots__ = (
        "chrom", "pos", "ref_base", "counts", "codes", "strands",
        "base_qualities", "mapping_qualities",
    )

    def __init__(self):
        self.chrom = b""
        self.pos = -1
        self.ref_base = 0x4E  # 'N'
        self.counts = [0, 0, 0, 0]
        self.codes: List[int] = []
        self.strands: List[int] = []
        self.base_qualities: Optional[List[int]] = None
        self.mapping_qualities: Optional[List[int]] = None


def parse_pileup_line(
    line: bytes,
    parse_base_qualities: bool,
    parse_mapping_qualities: bool,
    errors: Optional[ErrorChannel] = None,
    line_number: int = -1,
) -> Optional[ParsedLine]:
    """Parse one mpileup line (pileup.cpp:13-68 semantics).

    Returns None if the line was malformed and the error channel is
    non-strict; raises SidParseError in strict mode (the default).
    """
    if errors is None:
        errors = ErrorChannel(strict=True)
    toks = tokenize(line)
    # field order: chrom pos ref coverage bases [bq] [mq]
    if len(toks) < 2:
        errors.report(line_number, MALFORMED, line.decode("latin1"))
        return None
    out = ParsedLine()
    out.chrom = toks[0]
    out.pos = _atoi(toks[1])
    if len(toks) < 3 or len(toks[2]) != 1:
        errors.report(line_number, MALFORMED, line.decode("latin1"))
        return None
    out.ref_base = toks[2][0]
    if len(toks) < 4:
        errors.report(line_number, MALFORMED, line.decode("latin1"))
        return None
    # coverage token (toks[3]) is only used for buffer reservation upstream
    if len(toks) < 5:
        errors.report(line_number, MALFORMED, line.decode("latin1"))
        return None
    out.codes, out.strands, out.counts = parse_read_bases(toks[4], out.ref_base)

    if parse_base_qualities:
        if len(toks) < 6:
            errors.report(line_number, MALFORMED, line.decode("latin1"))
            return None
        out.base_qualities = parse_qualities(toks[5])
    if parse_mapping_qualities:
        if len(toks) < 7:
            errors.report(line_number, MALFORMED_OR_MISSING, line.decode("latin1"))
            return None
        out.mapping_qualities = parse_qualities(toks[6])
    return out
