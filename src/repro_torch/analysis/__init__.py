"""The kernel contracts of ``repro.analysis``, checked on the port's own
facts (ROADMAP A13).

The reference walks jaxprs and Pallas ``BlockSpec``s; the port has
neither (CUDA sources launched through ctypes, an eager graph), so each
contract moves to where the port's facts live: the launchers' plans and
``registry.SMEM_MODELS`` (``smem``, ``coverage``), the calls through
``registry.resolve`` (``launches``, ``compile_guard``), storage
addresses under a dispatch mode (``donation``), ``launch/collectives``'
record (``collectives``) and the ATen ops a site dispatches
(``dtype_flow``, ``int_range``, ``determinism``).  What the card alone
can say (the libraries' own shared-memory bytes, occupancy, that the
write mirrors match the kernels) ``chip_smoke.py`` checks.

    from repro_torch.analysis import run_suite
    report = run_suite()            # every family, all eight checks
    assert not report.failures, report.to_text()

``repro_torch.tools.kernel_lint`` is the command line.
"""
from .collectives import audit_collectives, check_permutation
from .compile_guard import CompileGuard, compile_guard
from .completeness import EXPECTED_SCHEDULES, REFERENCE_SITES, \
    audit_completeness
from .coverage import audit_coverage, audit_plan_coverage
from .donation import audit_donation
from .dtype_flow import accum_findings, audit_dtype_flow
from .intervals import audit_intervals
from .launches import PROBES, Launch, record_launches
from .numerics import audit_determinism, audit_trio_signatures
from .report import CHECKS, SCHEMA_VERSION, Finding, Report
from .smem import PINNED_BYTES, audit_family_smem, audit_smem
from .suite import NUMERICS_CHECKS, SITES, run_suite

__all__ = [
    "CHECKS", "NUMERICS_CHECKS", "SCHEMA_VERSION", "Finding", "Report",
    "Launch", "PROBES", "record_launches",
    "audit_smem", "audit_family_smem", "PINNED_BYTES",
    "audit_coverage", "audit_plan_coverage", "audit_donation",
    "audit_collectives", "check_permutation", "audit_completeness",
    "EXPECTED_SCHEDULES", "REFERENCE_SITES",
    "audit_dtype_flow", "accum_findings", "audit_intervals",
    "audit_determinism", "audit_trio_signatures",
    "compile_guard", "CompileGuard", "run_suite", "SITES",
]
