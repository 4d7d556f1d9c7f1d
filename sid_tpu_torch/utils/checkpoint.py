"""Checkpoint / resume: persisted fit state and restartable streaming runs
(sid_tpu/utils/checkpoint.py; the same ``.npz`` and sidecar formats, so a
checkpoint written by either package loads in the other).

The pass-1 sufficient statistics (profile histogram, nucleotide
distribution) and the fitted (pi, epsilon) persist to an .npz, so re-runs
skip the histogram pass; streaming pass 2 records chunk-level progress in a
sidecar and resumes by truncating the output to the last completed chunk
boundary.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

FIT_STATE_VERSION = 2


def input_fingerprint(src) -> str:
    """Identity of the source pileup: size + hash of its head and tail.

    Persisted with the fit state so --checkpoint/--resume against a modified
    or different input rejects the stale histogram instead of silently
    classifying every site with the wrong model.
    """
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    window = 1 << 20
    if isinstance(src, (bytes, bytearray)):
        size = len(src)
        h.update(bytes(src[:window]))
        if size > window:
            h.update(bytes(src[-window:]))
    else:
        size = os.path.getsize(src)
        with open(src, "rb") as f:
            h.update(f.read(window))
            if size > window:
                f.seek(max(size - window, 0))
                h.update(f.read(window))
    return f"{size}:{h.hexdigest()}"


def _npz_path(path: str) -> str:
    """Normalize the checkpoint path: np.savez appends ``.npz`` when the
    suffix is missing, so save and load must agree on the real filename —
    without this, ``--checkpoint foo`` would write foo.npz, look for foo on
    resume, and silently re-run pass 1 every time."""
    return path if path.endswith(".npz") else path + ".npz"


def save_fit_state(
    path: str,
    profiles: np.ndarray,
    mult: np.ndarray,
    pi: Optional[float] = None,
    eps: Optional[float] = None,
    nt: Optional[np.ndarray] = None,
    fingerprint: str = "",
) -> None:
    np.savez_compressed(
        _npz_path(path),
        version=FIT_STATE_VERSION,
        profiles=np.asarray(profiles, np.int32),
        mult=np.asarray(mult, np.int64),
        pi=np.float64(pi if pi is not None else np.nan),
        eps=np.float64(eps if eps is not None else np.nan),
        nt=np.asarray(nt if nt is not None else [np.nan] * 4),
        fingerprint=np.str_(fingerprint),
    )


def load_fit_state(path: str, fingerprint: str = ""):
    """Returns dict with profiles/mult/pi/eps/nt; None if absent/stale.

    A non-empty ``fingerprint`` must match the persisted one — a mismatch
    (different or modified input) invalidates the checkpoint.
    """
    path = _npz_path(path)
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if int(z["version"]) != FIT_STATE_VERSION:
            return None
        saved_fp = str(z["fingerprint"]) if "fingerprint" in z else ""
        if fingerprint and saved_fp and saved_fp != fingerprint:
            return None
        out = {
            "profiles": z["profiles"],
            "mult": z["mult"],
            "pi": float(z["pi"]),
            "eps": float(z["eps"]),
            "nt": z["nt"],
        }
    if np.isnan(out["pi"]):
        out["pi"] = None
        out["eps"] = None
    return out


class StreamProgress:
    """Sidecar tracking streaming pass-2 progress for resume."""

    def __init__(self, out_path: str):
        self.sidecar = out_path + ".progress.json"
        self.out_path = out_path

    def load(self) -> Tuple[int, int]:
        """(chunks_done, bytes_written); (0, 0) when absent/corrupt."""
        try:
            with open(self.sidecar) as f:
                d = json.load(f)
            return int(d["chunks_done"]), int(d["bytes_written"])
        except Exception:
            return 0, 0

    def save(self, chunks_done: int, bytes_written: int) -> None:
        tmp = self.sidecar + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"chunks_done": chunks_done, "bytes_written": bytes_written}, f)
        os.replace(tmp, self.sidecar)

    def finish(self) -> None:
        try:
            os.remove(self.sidecar)
        except OSError:
            pass
