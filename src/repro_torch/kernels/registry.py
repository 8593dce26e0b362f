"""Kernel implementations by op, chosen by the input tensor's device
(port of ``repro.kernels.registry``).

Each op has two implementations: ``cuda``, the hand-written kernel,
for CUDA tensors, and ``reference``, its plain PyTorch version, for CPU
tensors.  Rows 8 and 9 (``flash_attention``, ``flash_attention_step``)
have a third, ``meta``, for ``meta`` tensors (the dry run): the output's
shapes and the call's work counted, no arithmetic.  The tensor's device
alone chooses; there is no fallback from one to the other, and an op
without a ``meta`` route raises on ``meta`` tensors.

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
"""
from __future__ import annotations

import json
import pathlib
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels import cws_hash, flash_attention, minmax_gram

IMPLS: Dict[str, Dict[str, Callable]] = {
    "cws_encode": {"cuda": cws_hash.cws_encode_cuda,
                   "reference": cws_hash.cws_encode_plain},
    "cws_encode_rng": {"cuda": cws_hash.cws_encode_rng_cuda,
                       "reference": cws_hash.cws_encode_rng_plain},
    "cws_encode_packed": {"cuda": cws_hash.cws_encode_packed_cuda,
                          "reference": cws_hash.cws_encode_packed_plain},
    "cws_encode_rng_packed": {
        "cuda": cws_hash.cws_encode_rng_packed_cuda,
        "reference": cws_hash.cws_encode_rng_packed_plain},
    "cws_hash": {"cuda": cws_hash.cws_hash_cuda,
                 "reference": cws_hash.cws_hash_plain},
    "cws_hash_rng": {"cuda": cws_hash.cws_hash_rng_cuda,
                     "reference": cws_hash.cws_hash_rng_plain},
    "min_sum": {"cuda": minmax_gram.min_sum_cuda,
                "reference": minmax_gram.min_sum_plain},
    "minmax_gram": {"cuda": minmax_gram.minmax_gram_cuda,
                    "reference": minmax_gram.minmax_gram_plain},
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


def resolve(op: str, device: torch.device):
    """The implementation of ``op`` for tensors on ``device``."""
    table = IMPLS.get(op)
    if table is None:
        raise KeyError(f"no implementations registered for op {op!r}")
    impl = auto_impl(device)
    if impl not in table:
        raise KeyError(f"op {op!r} has no {impl} route")
    return table[impl]


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
