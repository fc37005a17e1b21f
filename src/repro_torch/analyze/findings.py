"""Common finding type + baseline machinery for the analyze passes (the
port's copy of the JAX package's ``analyze/findings.py``: fingerprints
are byte-equal, so either package reads the other's baseline).

A :class:`Finding` is one diagnostic from any pass.  Severities:

    error   breaks the self-stabilization contract or the engine's
            dataflow assumptions — always gates.
    warn    suspicious but conceivably intentional (e.g. a knob with
            no effect in this mode) — gates unless baselined.
    info    advisory (cost-plan notes) — never gates.

Baselining: a finding's :func:`fingerprint` is a stable hash of its
identity fields (pass, rule, subject, witness) — NOT its message, so
rewording a diagnostic does not invalidate the baseline.  The
port's ``analyze_baseline_torch.json`` (as the JAX package's
``analyze_baseline.json``) is a list of
``{"fp": ..., "rule": ..., "subject": ..., "note": ...}`` records;
:func:`split_baselined` partitions a finding list against it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Iterable, Optional, Sequence

SEVERITIES = ("error", "warn", "info")

#: severities that fail the gate when not baselined
GATING = ("error", "warn")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic from an analyze pass."""

    pass_name: str              # 'contract' | 'engine' | 'spec'
    rule: str                   # stable rule id, kebab-case
    severity: str               # 'error' | 'warn' | 'info'
    subject: str                # what was analyzed (spec / fn name)
    message: str                # human diagnostic
    witness: Optional[str] = None   # reproducing input, if any
    source: Optional[str] = None    # file:line when known

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}: {self.severity!r}"
            )

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fp"] = fingerprint(self)
        return d

    def __str__(self) -> str:
        loc = f" [{self.source}]" if self.source else ""
        wit = f" witness: {self.witness}" if self.witness else ""
        return (
            f"{self.severity.upper():5s} {self.pass_name}/{self.rule} "
            f"({self.subject}){loc}: {self.message}{wit}"
        )


def fingerprint(f: Finding) -> str:
    """Stable identity hash for baselining (message excluded, so
    diagnostics can be reworded without re-baselining)."""
    key = "\x1f".join(
        (f.pass_name, f.rule, f.subject, f.witness or "")
    )
    return hashlib.sha256(key.encode()).hexdigest()[:16]


def load_baseline(path: Optional[str]) -> set:
    """Load the accepted-finding fingerprints from a baseline file
    (missing path or None -> empty baseline)."""
    if path is None:
        return set()
    try:
        with open(path) as fh:
            records = json.load(fh)
    except FileNotFoundError:
        return set()
    if not isinstance(records, list):
        raise ValueError(f"baseline {path}: expected a JSON list")
    fps = set()
    for rec in records:
        if isinstance(rec, str):
            fps.add(rec)
        elif isinstance(rec, dict) and "fp" in rec:
            fps.add(str(rec["fp"]))
        else:
            raise ValueError(f"baseline {path}: bad record {rec!r}")
    return fps


def baseline_records(findings: Sequence[Finding]) -> list:
    """Serializable baseline records for ``--write-baseline``."""
    return [
        {
            "fp": fingerprint(f),
            "rule": f"{f.pass_name}/{f.rule}",
            "subject": f.subject,
            "note": f.message[:120],
        }
        for f in findings
        if f.severity in GATING
    ]


def split_baselined(
    findings: Iterable[Finding], baseline: set
) -> tuple[list, list]:
    """Partition into (fresh, baselined).  Only gating severities are
    ever baselined; info findings always land in ``fresh`` (they don't
    gate anyway)."""
    fresh: list = []
    old: list = []
    for f in findings:
        if f.severity in GATING and fingerprint(f) in baseline:
            old.append(f)
        else:
            fresh.append(f)
    return fresh, old


def gate_failures(findings: Iterable[Finding]) -> list:
    """The findings that fail the gate (gating severity)."""
    return [f for f in findings if f.severity in GATING]
