"""Kernel implementations by op, chosen by the input tensor's device
(port of ``repro.kernels.registry``).

Each op has three implementations: ``cuda``, the hand-written kernel,
for CUDA tensors, ``reference``, its plain PyTorch version, for CPU
tensors, and ``meta``, for ``meta`` tensors (the dry run and the
contract audits of ``repro_torch.analysis``): the output's shapes, no
arithmetic; rows 8 and 9 (``flash_attention``, ``flash_attention_step``)
also count the call's work.  The tensor's device alone chooses; there is
no fallback from one to the other, and an op without a ``meta`` route
raises on ``meta`` tensors.

Also here, the reference's two tuning tables in the port's terms:

  * the plan table (the reference's block table): per kernel family and
    pow2-bucketed shape, the plan its kernel runs on instead of the
    heuristic's: a CWS family's ``SplitPlan`` fields (rows per thread,
    row warps, splits) or ``min_sum``'s ``GramPlan`` choice (tile,
    splits, small).  ``cws_hash.split_plan`` and ``minmax_gram.gram_plan``
    consult it on an exact key match; an entry that is not legal for the
    shape raises there.  ``repro_torch.tools.autotune_blocks`` measures
    and saves it;
  * the serving bucket ladder per family, ``DEFAULT_SERVE_BUCKETS`` for
    a family with no entry.

Both start empty: nothing is loaded unless a caller loads it.

And the kernels' shared-memory models (the reference's ``_VMEM_MODELS``):
``SMEM_MODELS`` gives, per kernel family, the kernel instantiations a
launch on a plan runs and the dynamic shared-memory bytes each launcher
sets for it, with the body's accumulator dtype; ``SMEM_BUDGET`` is a
block's opt-in limit on sm_90; ``plan_candidates`` is each family's legal
plan space at a shape.  ``repro_torch.analysis.smem`` audits the models
here, and ``chip_smoke.py`` holds them to the libraries' own bytes.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels import cws_hash, flash_attention, minmax_gram

IMPLS: Dict[str, Dict[str, Callable]] = {
    "cws_encode": {"cuda": cws_hash.cws_encode_cuda,
                   "reference": cws_hash.cws_encode_plain,
        "meta": cws_hash.cws_encode_meta},
    "cws_encode_rng": {"cuda": cws_hash.cws_encode_rng_cuda,
                       "reference": cws_hash.cws_encode_rng_plain,
        "meta": cws_hash.cws_encode_rng_meta},
    "cws_encode_packed": {"cuda": cws_hash.cws_encode_packed_cuda,
                          "reference": cws_hash.cws_encode_packed_plain,
        "meta": cws_hash.cws_encode_packed_meta},
    "cws_encode_rng_packed": {
        "cuda": cws_hash.cws_encode_rng_packed_cuda,
        "reference": cws_hash.cws_encode_rng_packed_plain,
        "meta": cws_hash.cws_encode_rng_packed_meta},
    "cws_hash": {"cuda": cws_hash.cws_hash_cuda,
                 "reference": cws_hash.cws_hash_plain,
        "meta": cws_hash.cws_hash_meta},
    "cws_hash_rng": {"cuda": cws_hash.cws_hash_rng_cuda,
                     "reference": cws_hash.cws_hash_rng_plain,
        "meta": cws_hash.cws_hash_rng_meta},
    "min_sum": {"cuda": minmax_gram.min_sum_cuda,
                "reference": minmax_gram.min_sum_plain,
                "meta": minmax_gram.min_sum_meta},
    "minmax_gram": {"cuda": minmax_gram.minmax_gram_cuda,
                    "reference": minmax_gram.minmax_gram_plain,
                    "meta": minmax_gram.minmax_gram_meta},
    "flash_attention": {
        "cuda": flash_attention.flash_attention_fwd_cuda,
        "reference": flash_attention.flash_attention_fwd_plain,
        "meta": flash_attention.flash_attention_fwd_meta},
    "flash_attention_step": {
        "cuda": flash_attention.flash_attention_step_cuda,
        "reference": flash_attention.flash_attention_step_plain,
        "meta": flash_attention.flash_attention_step_meta},
}

_FAMILY_ALIASES = {"cws_encode": "cws", "cws_encode_rng": "cws_rng",
                   "cws_encode_packed": "cws_packed",
                   "cws_encode_rng_packed": "cws_rng_packed",
                   "cws_hash": "cws", "cws_hash_rng": "cws_rng",
                   "minmax_gram": "min_sum", "gram": "min_sum"}


def family(op: str) -> str:
    """Op name -> kernel family name (the reference's aliases)."""
    return _FAMILY_ALIASES.get(op, op)


def auto_impl(device: torch.device) -> str:
    kind = torch.device(device).type
    return kind if kind in ("cuda", "meta") else "reference"


# Callables ``hook(op, impl, args, kwargs)`` told of each call made through
# ``resolve`` before it runs: ``repro_torch.analysis``'s recorders.  Empty
# unless an audit is recording.
RESOLVE_HOOKS: list = []


def resolve(op: str, device: torch.device):
    """The implementation of ``op`` for tensors on ``device``."""
    table = IMPLS.get(op)
    if table is None:
        raise KeyError(f"no implementations registered for op {op!r}")
    impl = auto_impl(device)
    if impl not in table:
        raise KeyError(f"op {op!r} has no {impl} route")
    fn = table[impl]
    if not RESOLVE_HOOKS:
        return fn

    def told(*args, **kwargs):
        for hook in tuple(RESOLVE_HOOKS):
            hook(op, impl, args, kwargs)
        return fn(*args, **kwargs)
    return told


# ---------------------------------------------------------------------------
# the plan table
# ---------------------------------------------------------------------------

CWS_FAMILIES = ("cws", "cws_rng", "cws_packed", "cws_rng_packed")
PLAN_FAMILIES = CWS_FAMILIES + ("min_sum",)
_ENTRY_KEYS = {"cws": ("rows_per_thread", "row_warps", "splits"),
               "min_sum": ("tile", "splits", "small")}

# (family, n, D, k) pow2-bucketed -> a plan entry (``check_entry``'s form);
# for min_sum the key is (m, D, n), as in the reference
BLOCK_TABLE: Dict[Tuple[str, int, int, int], dict] = {}


def _bucket(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


def table_key(op: str, n: int, d: int, k: int) -> Tuple[str, int, int, int]:
    """The plan table's key for a problem shape: the family and the dims
    rounded up to powers of two (the reference's bucketing); ``n x D x
    k`` for the CWS families, ``m x D x n`` for min_sum."""
    return (family(op), _bucket(n), _bucket(d), _bucket(k))


def check_entry(fam: str, entry) -> dict:
    """A plan entry in canonical form; raises on a family without plans,
    missing or extra fields, or values no kernel instantiation takes.
    Whether the plan fits a shape is checked where it is used."""
    if fam not in PLAN_FAMILIES:
        raise ValueError(f"no plan table for family {fam!r}; families: "
                         f"{PLAN_FAMILIES}")
    want = _ENTRY_KEYS["min_sum" if fam == "min_sum" else "cws"]
    if not isinstance(entry, dict) or set(entry) != set(want):
        raise ValueError(f"a {fam} plan entry has the fields {want}; got "
                         f"{entry!r}")
    if fam == "min_sum":
        out = {"tile": tuple(int(v) for v in entry["tile"]),
               "splits": int(entry["splits"]),
               "small": bool(entry["small"])}
        if out["small"]:
            if out["splits"] != 1:
                raise ValueError(f"a small-mode min_sum plan has one slice; "
                                 f"got {entry!r}")
        elif (out["tile"] not in minmax_gram.GRAM_TILES
              or out["splits"] not in minmax_gram.GRAM_SPLITS):
            raise ValueError(f"min_sum plan {entry!r}: tile one of "
                             f"{minmax_gram.GRAM_TILES}, splits one of "
                             f"{minmax_gram.GRAM_SPLITS}")
        return out
    out = {name: int(entry[name]) for name in want}
    cws_hash.check_plan_fields(**out)
    return out


def update_block_table(entries: Dict[Tuple[str, int, int, int], dict]
                       ) -> None:
    """Install entries keyed ``(op, n, D, k)`` as ``table_key`` builds
    them; every entry is checked first, so a bad one installs nothing."""
    checked = {(family(op), n, d, k): check_entry(family(op), v)
               for (op, n, d, k), v in entries.items()}
    BLOCK_TABLE.update(checked)


def clear_block_table() -> None:
    BLOCK_TABLE.clear()


def plan_entry(op: str, n: int, d: int, k: int) -> Optional[dict]:
    """The table's entry for ``op`` at this shape, or None."""
    return BLOCK_TABLE.get(table_key(op, n, d, k))


def _entry_json(entry: dict) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in entry.items()}


def save_block_table(path, entries: Optional[Dict] = None) -> None:
    """Persist (a subset of) the plan table as JSON: ``"family:n:d:k" ->
    entry``; round-trips through ``load_block_table``."""
    entries = BLOCK_TABLE if entries is None else entries
    obj = {f"{family(op)}:{n}:{d}:{k}": _entry_json(
        check_entry(family(op), v))
           for (op, n, d, k), v in sorted(entries.items())}
    pathlib.Path(path).write_text(json.dumps(obj, indent=1))


def load_block_table(path) -> Dict[Tuple[str, int, int, int], dict]:
    """Load a ``save_block_table`` file into the plan table; returns the
    parsed entries."""
    obj = json.loads(pathlib.Path(path).read_text())
    entries = {}
    for key, v in obj.items():
        op, n, d, k = key.split(":")
        entries[(op, int(n), int(d), int(k))] = v
    update_block_table(entries)
    return {(family(op), n, d, k): BLOCK_TABLE[(family(op), n, d, k)]
            for (op, n, d, k) in entries}


# ---------------------------------------------------------------------------
# shared-memory models and the plan space
# ---------------------------------------------------------------------------

# A block's opt-in shared memory on sm_90 (``sharedMemPerBlockOptin``;
# csrc/flash_attention_wgmma.cu's SMEM_LIMIT)
SMEM_BUDGET = 232448
# SMs of an H100 SXM: the plans the CPU audits enumerate
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class KernelLaunch:
    """One kernel instantiation a launch runs: its name as the library's
    query functions take it, its block size and the dynamic shared-memory
    bytes its launcher sets."""

    kernel: str
    threads: int
    smem: int


@dataclasses.dataclass(frozen=True)
class SmemModel:
    """A family's shared-memory model: ``launches(plan)`` is what a launch
    on ``plan`` runs (``KernelLaunch``es), ``accum`` the dtype its body
    accumulates in (C++, so the dtype-flow audit reads it here), and
    ``source`` the file whose launchers set the bytes."""

    source: str
    accum: torch.dtype
    launches: Callable


def split_smem_bytes(rows_per_thread: int, row_warps: int,
                     stored: bool) -> int:
    """``csrc/cws_split.cu:launch_r``'s bytes: the walk's staging (log x
    (bn, 64), one or two (64, 32) buffers of r, log c and beta) or the d
    warps' partial triples, whichever is larger."""
    bn = rows_per_thread * row_warps
    d_warps = cws_hash.SPLIT_WARPS // row_warps
    chunk, tile = cws_hash.SPLIT_CHUNK, cws_hash.SPLIT_CHUNK * \
        cws_hash.SPLIT_HASH_TILE
    staging = bn * chunk + (2 if stored else 1) * 3 * tile
    partial = 3 * d_warps * bn * cws_hash.SPLIT_HASH_TILE
    return 4 * max(staging, partial)


def _split_launches(stored: bool):
    def launches(plan) -> Tuple[KernelLaunch, ...]:
        r = plan.rows_per_thread
        return (KernelLaunch(
            f"cws_split<R={r},{'stored' if stored else 'regen'}>",
            32 * cws_hash.SPLIT_WARPS,
            split_smem_bytes(r, plan.row_warps, stored)),)
    return launches


# (RM, RN, WM, WN) of each tile's instantiation (csrc/minmax_gram.cu)
GRAM_TILE_SHAPES = {(128, 128): (8, 8, 4, 2), (128, 64): (8, 4, 4, 2),
                    (64, 64): (4, 8, 4, 1)}
GRAM_STAGES = 4


def gram_smem_bytes(tile) -> int:
    """``Tile::SMEM``: the ring's stages of x and y rows (128 bytes a row
    a stage), a full and an empty barrier a stage, 1 KB of alignment."""
    stage = (tile[0] + tile[1]) * 128
    return GRAM_STAGES * stage + 16 * GRAM_STAGES + 1024


def _gram_launches(plan) -> Tuple[KernelLaunch, ...]:
    if plan.small:
        return (KernelLaunch("min_sum_small",
                             minmax_gram.GRAM_SMALL_THREADS, 0),)
    _, _, wm, wn = GRAM_TILE_SHAPES[plan.tile]
    tiled = KernelLaunch(f"min_sum_tiled<{plan.tile[0]}x{plan.tile[1]}>",
                         32 + 32 * wm * wn, gram_smem_bytes(plan.tile))
    if plan.splits == 1:
        return (tiled,)
    return tiled, KernelLaunch("min_sum_combine", 256, 0)


def flash_smem_bytes(body: str, d: int) -> int:
    """The flash launchers' bytes.  wgmma: two Q tiles, the K and V
    stages (four, or as many as fit the block's limit), the barriers and
    1 KB of alignment; SIMT: q and k d-major (stride 68), the v tile and
    the p tile, fp32."""
    if body == "wgmma":
        tile = 128 * d
        stages = min(4, (SMEM_BUDGET - 2048 - 2 * tile) // (2 * tile))
        return 2 * tile + 2 * stages * tile + 2048
    ld = flash_attention.FLASH_BQ + 4
    return 4 * (2 * d * ld + flash_attention.FLASH_BK * d
                + flash_attention.FLASH_BK * ld)


def _flash_launches(plan) -> Tuple[KernelLaunch, ...]:
    name = (f"flash_wgmma<D={plan.d}>" if plan.body == "wgmma" else
            f"flash_simt<cols={plan.cols}>")
    return (KernelLaunch(name, plan.threads,
                         flash_smem_bytes(plan.body, plan.d)),)


_SPLIT_SOURCE = "src/repro_torch/csrc/cws_split.cu"
_FLASH_SOURCE = "src/repro_torch/csrc/flash_attention*.cu"
SMEM_MODELS: Dict[str, SmemModel] = {
    "cws": SmemModel(_SPLIT_SOURCE, torch.float32, _split_launches(True)),
    "cws_rng": SmemModel(_SPLIT_SOURCE, torch.float32,
                         _split_launches(False)),
    "cws_packed": SmemModel(_SPLIT_SOURCE, torch.float32,
                            _split_launches(True)),
    "cws_rng_packed": SmemModel(_SPLIT_SOURCE, torch.float32,
                                _split_launches(False)),
    "min_sum": SmemModel("src/repro_torch/csrc/minmax_gram.cu",
                         torch.float32, _gram_launches),
    "flash_attention": SmemModel(_FLASH_SOURCE, torch.float32,
                                 _flash_launches),
    "flash_attention_step": SmemModel(_FLASH_SOURCE, torch.float32,
                                      _flash_launches),
}
STORED_FAMILIES = ("cws", "cws_packed")
FLASH_FAMILIES = ("flash_attention", "flash_attention_step")


def plan_candidates(op: str, shape) -> list:
    """Every plan entry ``op``'s family can launch at ``shape``: ``n x D x
    k`` for a CWS family and ``m x D x n`` for min_sum (the plan table's
    entries: ``check_entry``'s form), ``(b, sq, h, g, d)`` for rows 8-9
    (``{"body", "dtype"}``: every body that takes that head dim)."""
    fam = family(op)
    if fam in FLASH_FAMILIES:
        d = shape[-1]
        out = [{"body": "simt", "dtype": dt}
               for dt in ("float32", "bfloat16")]
        if d in flash_attention.WGMMA_HEAD_DIMS:
            out.append({"body": "wgmma", "dtype": "bfloat16"})
        return out
    n, d, k = shape
    if fam == "min_sum":
        chunks = -(-d // minmax_gram.GRAM_CHUNK)
        out = [{"tile": t, "splits": s, "small": False}
               for t in minmax_gram.GRAM_TILES
               for s in minmax_gram.GRAM_SPLITS if s <= chunks]
        return out + [{"tile": (0, 0), "splits": 1, "small": True}]
    if fam not in CWS_FAMILIES:
        raise KeyError(f"no plan space for op {op!r}")
    out = []
    for rows in cws_hash.SPLIT_ROWS_PER_THREAD:
        for warps in cws_hash.SPLIT_ROW_WARPS:
            for splits in cws_hash.SPLIT_SIZES:
                try:
                    cws_hash.check_plan(cws_hash.SplitPlan(
                        n, d, k, rows, warps, splits))
                except ValueError:
                    continue
                out.append({"rows_per_thread": rows, "row_warps": warps,
                            "splits": splits})
    return out


def plan_of(op: str, shape, entry: Optional[dict] = None,
            sms: int = H100_SMS):
    """The kernel's plan object for ``entry`` of ``plan_candidates(op,
    shape)``, or with ``entry`` None the heuristic's own choice (no
    table consulted): a ``SplitPlan``, a ``GramPlan`` or a
    ``FlashPlan``."""
    fam = family(op)
    if fam in FLASH_FAMILIES:
        b, sq, h, g, d = shape
        dtype = getattr(torch, (entry or {}).get("dtype", "bfloat16"))
        return flash_attention.flash_plan(b, sq, h, g, d, dtype,
                                          (entry or {}).get("body"))
    n, d, k = shape
    if fam == "min_sum":
        if entry is None:
            return minmax_gram.gram_plan(n, k, d, sms)
        if entry["small"]:
            return minmax_gram.gram_plan(n, k, d, sms, small=True)
        return minmax_gram.gram_plan(n, k, d, sms, tile=tuple(entry["tile"]),
                                     splits=entry["splits"])
    if entry is None:
        return cws_hash.split_plan(n, d, k, sms,
                                   stored=fam in STORED_FAMILIES)
    return cws_hash.check_plan(cws_hash.SplitPlan(n, d, k, **entry))


# ---------------------------------------------------------------------------
# serving shape buckets
# ---------------------------------------------------------------------------

# Padded request-batch shapes the serving runner warms, per kernel family.
DEFAULT_SERVE_BUCKETS: Tuple[int, ...] = (1, 8, 32, 128, 512)

SERVE_BUCKET_TABLE: Dict[str, Tuple[int, ...]] = {}


def _check_buckets(buckets) -> Tuple[int, ...]:
    out = tuple(int(b) for b in buckets)
    if not out or any(b <= 0 for b in out) or list(out) != sorted(set(out)):
        raise ValueError(
            f"serve buckets must be a strictly increasing tuple of "
            f"positive row counts; got {buckets!r}")
    return out


def serve_buckets(op: str = "cws") -> Tuple[int, ...]:
    """The padded-batch ladder the serving runner uses for ``op``'s
    family: the table's entry if one was installed, else the default
    ladder."""
    return SERVE_BUCKET_TABLE.get(family(op), DEFAULT_SERVE_BUCKETS)


def update_serve_buckets(entries: Dict[str, Tuple[int, ...]]) -> None:
    checked = {family(op): _check_buckets(v) for op, v in entries.items()}
    SERVE_BUCKET_TABLE.update(checked)


def clear_serve_buckets() -> None:
    SERVE_BUCKET_TABLE.clear()


def save_serve_buckets(path, entries: Optional[Dict] = None) -> None:
    """Persist the bucket table as JSON (``"family" -> [rows...]``);
    round-trips through ``load_serve_buckets``."""
    entries = SERVE_BUCKET_TABLE if entries is None else entries
    obj = {family(op): list(_check_buckets(v))
           for op, v in sorted(entries.items())}
    pathlib.Path(path).write_text(json.dumps(obj, indent=1))


def load_serve_buckets(path) -> Dict[str, Tuple[int, ...]]:
    """Load a ``save_serve_buckets`` file into the bucket table; returns
    the parsed entries."""
    obj = json.loads(pathlib.Path(path).read_text())
    entries = {family(op): _check_buckets(v) for op, v in obj.items()}
    update_serve_buckets(entries)
    return entries
