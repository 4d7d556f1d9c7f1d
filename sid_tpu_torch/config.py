"""Run configuration.

Mirrors the reference CLI's ``GlobalOptions`` (sid.cpp:11-17) and
``sid_tpu.config.Options`` field for field, with the same defaults, so a
run configured for one package configures the other
(``Options.from_reference``). ``platform`` names the torch device: ``None``
means ``cuda``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch


@dataclasses.dataclass
class Options:
    # --- reference-compatible options (sid.cpp:11-17) ---
    method: str = "local"
    estimate_prior: bool = False          # -R
    snp_prior: float = -1.0               # -r (<=0 means "no prior")
    significance_level: float = 0.05      # -p
    site_error_threshold: float = 0.1     # -E

    # --- framework options (no reference equivalent) ---
    # "device": per-profile math on the torch device; "exact": the host
    # long-double oracle engine.
    engine: str = "device"
    # Lynch fit backend: "auto" (exact up to 500k unique profiles, device
    # above), "exact" (host long double) or "device".
    fit_backend: str = "auto"
    # pileup parser backend: "auto"/"native" (C++ libsidtpu) or "python"
    io_backend: str = "auto"
    # LRT erfc on host glibc libm from device log-likelihoods; False is
    # sid_tpu's fused on-device LRT (the device erfc, and for
    # likelihood_ratio the BH correction, on the device)
    exact_pvalues: bool = True
    # number of devices along the site axis (None = one device, no mesh)
    mesh_devices: Optional[int] = None
    # fit the Lynch model per chromosome (parallel.pipeline)
    per_shard_fit: bool = False
    # emit reference-identical stderr diagnostics (call.cpp:72,78-80)
    diagnostics: bool = True
    # output path ("-" = stdout)
    output: str = "-"
    # streaming two-pass mode (engine.run_streaming), chunk size in MB
    stream: bool = False
    chunk_mb: int = 64
    # per-stage timing report
    profile: bool = False
    # streaming checkpoint (the pass-1 histogram, .npz) and resume
    checkpoint: Optional[str] = None
    resume: bool = False
    # multi-sample population mode: "", "pooled", or "independent"
    population: str = ""
    # multi-host data-parallel execution (parallel.distributed)
    multihost: bool = False
    # torch device for the per-profile math: "cuda" (None) or "cpu"
    platform: Optional[str] = None
    # sid_tpu's XLA cache warm-up; kept so reference configurations
    # round-trip, never acted on here
    warm_cache: bool = False

    def device(self) -> torch.device:
        """The torch device of the run: ``platform``, default cuda.

        Raises when CUDA is asked for and absent: the device stage never
        moves to the CPU unless the CPU was asked for.
        """
        device = torch.device(self.platform or "cuda")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass --platform cpu to run on the host"
            )
        return device

    def mesh(self) -> Optional[List[torch.device]]:
        """The run's device mesh (``parallel.mesh``): None without
        ``--devices``, else ``make_site_mesh(mesh_devices)`` over the
        devices of the run's platform (raises when it selects none)."""
        if self.mesh_devices is None:
            return None
        from sid_tpu_torch.parallel.mesh import make_site_mesh, platform_devices

        return make_site_mesh(self.mesh_devices, platform_devices(self.device()))

    @classmethod
    def from_reference(cls, d: dict) -> "Options":
        """The port's Options from ``dataclasses.asdict()`` of a
        ``sid_tpu`` Options (same field names, same meanings)."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"unknown option fields: {sorted(unknown)}")
        return cls(**d)

    def validate(self, allow_unknown_method: bool = False) -> None:
        """Reject inconsistent option combinations (sid_tpu's rules).

        The CLI calls this with allow_unknown_method=True: the reference
        silently prints only the CSV header for unknown -m values
        (sid.cpp:92-102), and that observable behavior is preserved.
        """
        if not allow_unknown_method and self.method not in (
            "local", "bayes", "likelihood_ratio", "quality", ""
        ):
            raise ValueError(f"unknown method: {self.method!r}")
        if self.fit_backend not in ("auto", "exact", "device"):
            raise ValueError(f"unknown fit backend: {self.fit_backend!r}")
        if self.io_backend not in ("auto", "native", "python"):
            raise ValueError(f"unknown io backend: {self.io_backend!r}")
        if self.engine not in ("device", "exact"):
            raise ValueError(f"unknown engine: {self.engine!r}")
        if self.population not in ("", "pooled", "independent"):
            raise ValueError(f"unknown population mode: {self.population!r}")
        if self.chunk_mb <= 0:
            raise ValueError("chunk_mb must be positive")
        if self.multihost and self.output in ("-", ""):
            raise ValueError("--multihost requires --output (parts merge into a file)")
        if self.multihost and self.population:
            raise ValueError("--multihost and --population are mutually exclusive")
