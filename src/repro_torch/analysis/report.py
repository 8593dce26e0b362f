"""Finding/Report types shared by every contract check (port of
``repro.analysis.report``).

A Finding is one violated contract: which check fired, on what target
(a kernel family, an op or a site), and an actionable message.  A Report
holds the findings, a per-target check matrix ("pass" / "fail" / "n/a")
and summary stats, and serializes to the JSON that
``repro_torch.tools.kernel_lint --json`` writes: the reference's layout
under this package's own schema name.  The checks are the reference's
but ``smem`` (the kernels' shared memory on sm_90) in place of ``vmem``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Tuple

__all__ = ["Finding", "Report", "CHECKS", "SCHEMA_VERSION"]

CHECKS: Tuple[str, ...] = (
    "completeness", "smem", "coverage", "donation", "collectives",
    "dtype_flow", "int_range", "determinism")

# Bump when the JSON layout or the check vocabulary changes.
SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Finding:
    check: str          # one of CHECKS
    target: str         # family / op / site the contract belongs to
    message: str        # actionable: what broke and what to change
    severity: str = "error"       # "error" fails --strict; "warning" never
    details: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return {"check": self.check, "target": self.target,
                "severity": self.severity, "message": self.message,
                "details": self.details}

    def __str__(self) -> str:
        return f"[{self.check}] {self.target}: {self.message}"


@dataclasses.dataclass
class Report:
    findings: List[Finding] = dataclasses.field(default_factory=list)
    # target -> check -> "pass" | "fail" | "n/a"
    matrix: Dict[str, Dict[str, str]] = dataclasses.field(default_factory=dict)
    stats: Dict[str, dict] = dataclasses.field(default_factory=dict)

    def extend(self, findings) -> None:
        self.findings.extend(findings)

    def mark(self, target: str, check: str, findings) -> None:
        """Record that ``check`` ran on ``target``; pass iff no error
        finding in ``findings`` names that (check, target)."""
        row = self.matrix.setdefault(target, {c: "n/a" for c in CHECKS})
        bad = any(f.check == check and f.target == target
                  and f.severity == "error" for f in findings)
        row[check] = "fail" if bad else "pass"

    @property
    def failures(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    def to_json(self) -> dict:
        return {
            "schema": f"repro_torch.kernel_lint/v{SCHEMA_VERSION}",
            "schema_version": SCHEMA_VERSION,
            "checks": list(CHECKS),
            "matrix": {t: dict(row) for t, row in sorted(self.matrix.items())},
            "stats": self.stats,
            "findings": [f.to_json() for f in self.findings],
            "n_errors": len(self.failures),
        }

    def to_text(self) -> str:
        lines = []
        targets = sorted(self.matrix)
        if targets:
            width = max(len(t) for t in targets)
            head = " ".join(f"{c:>12}" for c in CHECKS)
            lines.append(f"{'target':<{width}} {head}")
            for t in targets:
                row = " ".join(f"{self.matrix[t][c]:>12}" for c in CHECKS)
                lines.append(f"{t:<{width}} {row}")
        for f in self.findings:
            mark = "FAIL" if f.severity == "error" else "warn"
            lines.append(f"{mark}: {f}")
        lines.append(f"{len(self.failures)} error(s), "
                     f"{len(self.findings) - len(self.failures)} warning(s)")
        return "\n".join(lines)

    def save(self, path) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=1, sort_keys=True,
                      default=str)
            fh.write("\n")
