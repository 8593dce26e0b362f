"""Registry completeness: the gate every op must pass (the counterpart
of ``repro.analysis.completeness``).

For every op of ``registry.IMPLS``:

  * a ``cuda`` impl (the hand-written kernel) and a ``reference`` impl
    (its plain version, the oracle) — the reference's pallas /
    pallas-interpret / reference ladder in the port's terms;
  * a family, through ``registry._FAMILY_ALIASES``, with a
    ``registry.SMEM_MODELS`` entry;
  * a probe in ``launches.PROBES``: the launch probe ``record_launches``
    runs and the impl-signature probe ``numerics`` compares.

Besides, the attention schedules (``ops.SEQ_ATTENTION``) are the
reference's ``EXPECTED_SCHEDULES``, and every site the reference
registers (its ``registry.donation_sites()``, ``collective_sites()`` and
``numerics_sites()``, kept here as ``REFERENCE_SITES``) has a site of the
same name in the port's suite (``suite.SITES``).
"""
from __future__ import annotations

from typing import List

from repro_torch.kernels import ops, registry
from .report import Finding

__all__ = ["audit_completeness", "EXPECTED_SCHEDULES", "REFERENCE_SITES"]

EXPECTED_SCHEDULES = {
    "attention": {"reference", "flash", "flash_allgather", "flash_ring"},
}

# The reference's registered analysis sites, by kind
REFERENCE_SITES = {
    "donation": ("trainer.update_step", "pipeline.launch_chunk",
                 "pipeline.features_streamed", "pipeline.features_sharded"),
    "collectives": ("trainer.sharded_update", "attention.flash_allgather",
                    "attention.flash_ring", "pipeline.sharded_chunk"),
    "numerics": ("trainer.grad_accum", "flash.accumulators",
                 "kernels.pack_words", "kernels.encode_emit",
                 "hashing.pack_codes", "hashing.unpack_codes",
                 "hashing.feature_indices", "regen.threefry_tile",
                 "linear.bag_logits", "linear.bag_logits_packed_boundary"),
}


def audit_completeness(*, impls=None) -> List[Finding]:
    """An ``impls`` override lets a fixture show a missing impl."""
    from .launches import PROBES as probes
    from .suite import SITES as sites
    impls = registry.IMPLS if impls is None else impls
    schedules = ops.SEQ_ATTENTION
    findings: List[Finding] = []
    for op in impls:
        have = set(impls.get(op, ()))
        missing = {"cuda", "reference"} - have
        if missing:
            findings.append(Finding(
                check="completeness", target=op,
                message=(f"op {op!r} has {sorted(have)} but no "
                         f"{sorted(missing)}: every op needs its hand-written "
                         f"kernel and the plain version it is held to")))
        fam = registry.family(op)
        if fam not in registry.SMEM_MODELS:
            findings.append(Finding(
                check="completeness", target=op,
                message=(f"op {op!r} (family {fam!r}) has no SMEM_MODELS "
                         f"entry: its launches' shared memory cannot be "
                         f"budgeted; add the model and a _FAMILY_ALIASES "
                         f"entry in kernels/registry.py")))
        if op not in probes:
            findings.append(Finding(
                check="completeness", target=op,
                message=(f"op {op!r} has no probe in launches.PROBES: the "
                         f"launch and signature checks cannot run it")))
    for name, want in EXPECTED_SCHEDULES.items():
        gone = want - set(schedules)
        if gone:
            findings.append(Finding(
                check="completeness", target=name,
                message=(f"schedule family {name!r} is missing "
                         f"{sorted(gone)} (has {sorted(schedules)})")))
    names = {s.name for s in sites}
    for kind, want in REFERENCE_SITES.items():
        for site in want:
            if site not in names:
                findings.append(Finding(
                    check="completeness", target=site,
                    message=(f"the reference's {kind} site {site!r} has no "
                             f"counterpart in suite.SITES")))
    return findings
