"""The violation record every check of the port reports, and the
tolerance check the step checks share.

The port's copy of the two pieces of ``repro.analysis.checks`` it needs:
``Violation`` (which ``schedule`` returns) and ``check_within``. The
JAX checks over traced collectives (ppermute pairs, axes, FSDP bytes,
the memory ladder) wait for the multi-GPU port (ROADMAP queue 1, item
15); the one-card step checks are in ``repro_torch.analysis.check``.
"""
from __future__ import annotations

import dataclasses

__all__ = ["Violation", "check_within"]


@dataclasses.dataclass(frozen=True)
class Violation:
    name: str
    detail: str
    where: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def check_within(
    name: str, got: float, want: float, *, tol: float = 0.01, where: str = ""
) -> list:
    """``got`` within ``tol`` (relative) of ``want``, else one
    ``bytes-mismatch`` violation labelled ``name``."""
    if abs(got - want) <= tol * max(abs(want), 1):
        return []
    return [
        Violation(
            "bytes-mismatch",
            f"{name}: traced {got} vs analytic {want} "
            f"(> {tol:.0%} apart)",
            where,
        )
    ]
