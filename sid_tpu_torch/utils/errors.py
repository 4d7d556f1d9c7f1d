"""Parse-error channel.

The reference throws ``std::invalid_argument("Malformed pileup line")`` and
terminates on the first bad line (pileup.cpp:22,28,34,40 — never caught).
That is *strict* mode; the non-strict channel records malformed lines with
their coordinates instead.
"""

from __future__ import annotations

import dataclasses
from typing import List

MALFORMED = "Malformed pileup line"
MALFORMED_OR_MISSING = "Malformed pileup line or missing mapping qualities"


class SidParseError(ValueError):
    """Raised in strict mode on a malformed pileup line. ``line_number`` is
    1-based and counts from the start of the input file (or bytes): a
    parse of one chunk adds the lines before it (``io.stream.parse_chunk``)."""

    def __init__(self, message: str, line_number: int = -1):
        super().__init__(message)
        self.line_number = line_number


@dataclasses.dataclass
class ParseErrorRecord:
    line_number: int  # 1-based line number within the buffer given to the parser
    message: str
    snippet: str = ""


@dataclasses.dataclass
class ErrorChannel:
    strict: bool = True
    records: List[ParseErrorRecord] = dataclasses.field(default_factory=list)

    def report(self, line_number: int, message: str, snippet: str = "") -> None:
        if self.strict:
            raise SidParseError(message, line_number)
        self.records.append(ParseErrorRecord(line_number, message, snippet[:80]))
