"""Shared-memory audit: ``registry.SMEM_MODELS`` against the block's limit
on sm_90 and a pinned fixture (the counterpart of ``repro.analysis.vmem``).

The reference reconstructs each Pallas launch's VMEM working set from its
BlockSpecs.  The port's kernels set their dynamic shared memory in their
C++ launchers (``cudaFuncSetAttribute``), so here each family's model is
evaluated on every plan of its candidate space (``registry.
plan_candidates``) plus the heuristic's own choice, at ragged
representative shapes, and a family fails when

  * a plan's bytes exceed ``registry.SMEM_BUDGET`` (the model admits a
    plan whose launch the card refuses);
  * the family has no model, or no candidate plan to enumerate;
  * the model's bytes for a kernel instantiation's worst member differ
    from the pinned fixture ``PINNED_BYTES`` (a stale model, or a kernel
    whose buffers changed without its model).

That the model equals what each library itself sets, byte for byte, and
that static plus dynamic fits the card's ``sharedMemPerBlockOptin``, is
checked on the card (``chip_smoke.py``'s contracts phase).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from repro_torch.kernels import registry
from .report import Finding

__all__ = ["audit_smem", "audit_family_smem", "family_plans",
           "PINNED_BYTES", "REP_SHAPE", "model_families"]

# Representative ragged problem: n x D x k for the CWS families, m x D x n
# for min_sum (neither a multiple of a tile), as the reference's
# _REP_SHAPE.  The flash families enumerate head dims instead.
REP_SHAPE = (300, 700, 300)
FLASH_SHAPE = (2, 300, 8, 2)              # (b, sq, h, g); D varies
FLASH_DIMS = (16, 32, 48, 64, 100, 128, 160, 192, 256)

# Each kernel instantiation's bytes at its worst member, as the kernels'
# sources give them (the fixture the models are pinned to)
PINNED_BYTES: Dict[str, Dict[str, int]] = {
    # 4 x max(bn 64 + (2 stored | 1) 3 64 32, 3 d_warps bn 32) at 16 row warps
    "cws": {"cws_split<R=1,stored>": 53248, "cws_split<R=2,stored>": 57344,
            "cws_split<R=4,stored>": 65536, "cws_split<R=8,stored>": 81920},
    "cws_rng": {"cws_split<R=1,regen>": 28672, "cws_split<R=2,regen>": 32768,
                "cws_split<R=4,regen>": 40960,
                "cws_split<R=8,regen>": 57344},
    # 4 stages x (BM + BN) 128 B + 64 B of barriers + 1 KB
    "min_sum": {"min_sum_tiled<128x128>": 132160,
                "min_sum_tiled<128x64>": 99392, "min_sum_tiled<64x64>": 66624,
                "min_sum_combine": 0, "min_sum_small": 0},
    # wgmma: (2 + 2 stages) 128 D + 2 KB; SIMT: 4 (136 D + 64 D + 64 68) at
    # D = 16 cols
    "flash_attention": {"flash_wgmma<D=64>": 83968,
                        "flash_wgmma<D=128>": 165888,
                        "flash_wgmma<D=192>": 198656,
                        "flash_wgmma<D=256>": 198656,
                        "flash_simt<cols=1>": 30208,
                        "flash_simt<cols=2>": 43008,
                        "flash_simt<cols=4>": 68608,
                        "flash_simt<cols=8>": 119808,
                        "flash_simt<cols=12>": 171008,
                        "flash_simt<cols=16>": 222208},
}
PINNED_BYTES["cws_packed"] = PINNED_BYTES["cws"]
PINNED_BYTES["cws_rng_packed"] = PINNED_BYTES["cws_rng"]
PINNED_BYTES["flash_attention_step"] = PINNED_BYTES["flash_attention"]


def model_families() -> tuple:
    """Every family an op of the registry belongs to."""
    return tuple(dict.fromkeys(registry.family(op) for op in registry.IMPLS))


def family_plans(fam: str, *, exhaustive: bool = False,
                 sms: int = registry.H100_SMS) -> list:
    """The plans audited for ``fam``: every candidate at the
    representative shape(s) and the heuristic's choice there."""
    if fam in registry.FLASH_FAMILIES:
        dims = range(1, 257) if exhaustive else FLASH_DIMS
        shapes = [FLASH_SHAPE + (d,) for d in dims]
    else:
        shapes = [REP_SHAPE]
        if exhaustive:
            shapes += [(1, 1, 1), (7, 33, 65), (12000, 784, 12000),
                       (65535 * 128, 64, 32)]
    plans = []
    for shape in shapes:
        cands = registry.plan_candidates(fam, shape)
        plans += [registry.plan_of(fam, shape, c, sms) for c in cands]
        plans.append(registry.plan_of(fam, shape, None, sms))
    return list(dict.fromkeys(plans))


def audit_family_smem(fam: str, *, budget: Optional[int] = None,
                      pinned: Optional[Dict[str, int]] = None,
                      exhaustive: bool = False,
                      stats: Optional[Dict] = None) -> List[Finding]:
    """Audit one family; ``budget`` / ``pinned`` overrides let the
    fixtures show an over-budget and a stale model."""
    findings: List[Finding] = []
    budget = registry.SMEM_BUDGET if budget is None else budget
    model = registry.SMEM_MODELS.get(fam)
    if model is None:
        return [Finding(check="smem", target=fam, message=(
            f"family {fam!r} has no SMEM_MODELS entry: its launches' "
            f"shared memory cannot be budgeted; add a model in "
            f"kernels/registry.py"))]
    try:
        plans = family_plans(fam, exhaustive=exhaustive)
    except KeyError as e:
        plans, why = [], str(e)
    else:
        why = ""
    if not plans:
        return [Finding(check="smem", target=fam, message=(
            f"family {fam!r} enumerates no candidate plan {why}: add its "
            f"plan space to registry.plan_candidates"))]
    worst: Dict[str, int] = {}
    ratio = 0.0
    for plan in plans:
        for k in model.launches(plan):
            worst[k.kernel] = max(worst.get(k.kernel, 0), k.smem)
            ratio = max(ratio, k.smem / budget)
            if k.smem > budget:
                findings.append(Finding(
                    check="smem", target=fam,
                    message=(f"plan {plan}: {k.kernel} sets {k.smem} B of "
                             f"dynamic shared memory, over the block's "
                             f"{budget} B on sm_90: the launch is refused; "
                             f"shrink the candidate space or the buffers"),
                    details={"kernel": k.kernel, "bytes": k.smem,
                             "budget": budget}))
    pinned = PINNED_BYTES.get(fam, {}) if pinned is None else pinned
    for kernel, got in sorted(worst.items()):
        want = pinned.get(kernel)
        if want is None:
            findings.append(Finding(
                check="smem", target=fam,
                message=(f"{kernel} has no pinned bytes in PINNED_BYTES: "
                         f"pin its worst member's {got} B so a change to "
                         f"the model shows"), details={"kernel": kernel}))
        elif got != want:
            findings.append(Finding(
                check="smem", target=fam,
                message=(f"{kernel}: the model gives {got} B at its worst "
                         f"member but the fixture pins {want} B: a stale "
                         f"model, or buffers changed in the source without "
                         f"it"), details={"kernel": kernel, "model": got,
                                          "pinned": want}))
    if stats is not None:
        stats[fam] = {"n_plans": len(plans), "kernels": worst,
                      "max_model_over_limit": round(ratio, 4)}
    return findings


def audit_smem(families: Optional[Iterable[str]] = None, *,
               exhaustive: bool = False,
               stats: Optional[Dict] = None) -> List[Finding]:
    findings: List[Finding] = []
    for fam in (families or model_families()):
        findings.extend(audit_family_smem(fam, exhaustive=exhaustive,
                                          stats=stats))
    return findings
