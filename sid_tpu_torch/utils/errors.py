"""Parse-error channel, and the error for features not yet ported.

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
    """Raised in strict mode on a malformed pileup line."""

    def __init__(self, message: str, line_number: int = -1):
        super().__init__(message)
        self.line_number = line_number


class NotPortedError(NotImplementedError):
    """A method or option of sid_tpu that this package does not run yet."""

    def __init__(self, feature: str):
        super().__init__(f"{feature} is not yet ported in sid_tpu_torch")
        self.feature = feature


@dataclasses.dataclass
class ParseErrorRecord:
    line_number: int  # 1-based line number within the parsed stream/shard
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
