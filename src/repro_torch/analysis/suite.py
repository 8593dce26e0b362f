"""The whole contract suite: one call, one Report (the counterpart of
``repro.analysis.suite``).

``run_suite()`` runs the eight checks:

  completeness  the registry per op (cuda + reference impls, a shared-
                memory model, a probe), the attention schedules, a
                counterpart for every reference site
  smem          ``registry.SMEM_MODELS`` over every candidate plan: within
                sm_90's block limit, pinned to the fixture
  coverage      each kernel's write arithmetic, mirrored from its source:
                every output element written once, on ragged shapes
  donation      results alias no reused buffer or undeclared argument, and
                in-place writes reach only declared arguments
  collectives   bound axes, true-permutation ring shifts, no sum of a sum,
                the blessed sums' count, a step's counts by kind and axes
  dtype_flow    no unblessed float narrowing, no sub-fp32 product while
                cuBLAS may reduce it at that precision, fp32 carries and
                (from the models) fp32 kernel accumulators
  int_range     no int32 wrap, shifts in range, exact int-to-float
                conversions, in-table gathers, on boundary inputs
  determinism   no global-generator draw, no unblessed float scatter, no
                stray collective; the impls agree on signatures

The sites are one explicit list here, ``SITES``, each built on demand
(the reference registers its sites from the modules that own them; the
port keeps them beside the checks so no module imports the analysis).
Their names are the reference's; ``repro_torch.tools.kernel_lint`` is the
command line.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Iterable, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels import registry
from .collectives import audit_collectives
from .completeness import audit_completeness
from .coverage import audit_coverage
from .donation import audit_donation
from .dtype_flow import accum_findings, audit_dtype_flow
from .intervals import audit_intervals
from .launches import PROBES, _rows, record_launches
from .numerics import audit_determinism, audit_trio_signatures
from .report import CHECKS, Finding, Report
from .smem import audit_smem, model_families

__all__ = ["run_suite", "SITES", "Site", "NUMERICS_CHECKS"]

NUMERICS_CHECKS = ("dtype_flow", "int_range", "determinism")


@dataclasses.dataclass(frozen=True)
class Site:
    """A named call the suite audits: ``case()`` is a context manager
    yielding ``{"fn", "args", ...options}`` (a fake or one-rank process
    group lives for the block)."""

    name: str
    kind: str                # "donation" | "collectives" | "numerics"
    case: Callable
    checks: Tuple[str, ...] = ()


# ---------------------------------------------------------------------------
# process groups for the sites
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _fake(world: int, rank: int = 0):
    from repro_torch.launch.dryrun import fake_group
    with fake_group(world, rank):
        yield


@contextlib.contextmanager
def _one_rank():
    """A one-rank gloo group in this process (an in-memory store)."""
    if dist.is_initialized():
        raise RuntimeError("the site starts its own one-rank process "
                           "group; one is already initialized")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the linear path's sites
# ---------------------------------------------------------------------------

def _pipe(device="cpu", **spec):
    from repro_torch.core.regen import prng_key
    from repro_torch.pipeline.featurize import FeaturePipeline, FeatureSpec
    return FeaturePipeline.create_regen(
        prng_key(0), 24, FeatureSpec(**{"num_hashes": 16, "b_i": 4, **spec}),
        row_chunk=8, device=device)


def _update(n_micro: int, mesh=None, device="cpu"):
    from repro_torch.core.linear_model import (TrainCfg, init_bag,
                                               make_linear_tx)
    from repro_torch.training.linear_trainer import (_bag_logits_fn,
                                                     _make_update_step)
    pipe = _pipe(device)
    ndev = 1 if mesh is None else mesh.shape["data"]
    cfg = TrainCfg(n_classes=3, steps=4, batch_size=2 * ndev)
    tx = make_linear_tx(cfg)
    params = init_bag(pipe.num_features, 3, device=device)
    step = _make_update_step(cfg, tx, n_micro, _bag_logits_fn(pipe), mesh)
    n = cfg.batch_size // ndev
    if device == "meta":
        fb = torch.empty((n, 16), dtype=torch.int32, device="meta")
        yb = torch.empty((n,), dtype=torch.int64, device="meta")
    else:
        fb = pipe.features(_rows(n, 24))
        yb = torch.arange(n) % 3
    return step, (params, tx.init(params), fb, yb, 0), params


# the bag head's and the global norm's float64 sums, each rounded once to
# float32 (the same float32 on every device)
F64_SUMS = ("float64->float32",)

# the bag head's float scatters, blessed with their reasons
BAG_SCATTERS = {
    "index_add": "the bag head's CPU backward (core/linear_model.py): a "
                 "serial loop over the indices in order, one fixed order",
    "index_put": "the bag head's CUDA backward (core/linear_model.py): "
                 "index_put_(accumulate=True) sorts the indices stably and "
                 "sums each index's run in that order",
}


@contextlib.contextmanager
def _update_step():
    step, args, _ = _update(1)
    yield {"fn": step, "args": args}


@contextlib.contextmanager
def _grad_accum():
    step, args, _ = _update(2)
    yield {"fn": step, "args": args, "allow": BAG_SCATTERS,
           "allow_narrow": F64_SUMS}


@contextlib.contextmanager
def _launch_chunk():
    pipe = _pipe()
    yield {"fn": pipe.launch_chunk, "args": (_rows(8, 24),)}


@contextlib.contextmanager
def _features_streamed():
    pipe = _pipe()
    yield {"fn": pipe.features, "args": (_rows(27, 24),)}    # a ragged tail


@contextlib.contextmanager
def _features_sharded():
    from repro_torch.launch.mesh import make_data_mesh
    with _one_rank():
        mesh = make_data_mesh()
        pipe = _pipe()
        yield {"fn": lambda x: pipe.features(x, mesh=mesh),
               "args": (_rows(7, 24),)}


@contextlib.contextmanager
def _fused_adamw():
    from repro_torch.optim import fused_adamw_apply
    g = torch.Generator().manual_seed(5)
    params = {"w": torch.randn((6, 5), generator=g), "b": torch.zeros(5)}
    grads = {k: torch.randn(v.shape, generator=g) for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    step = torch.zeros((), dtype=torch.int32)

    def fn(p, gr, m, v, s):
        return fused_adamw_apply(p, gr, m, v, s, lr=1e-3, weight_decay=0.1)
    yield {"fn": fn, "args": (params, grads, mu, nu, step),
           "mutates": (0, 2, 3), "allow_narrow": F64_SUMS}


@contextlib.contextmanager
def _snapshot():
    from repro_torch.checkpoint.checkpointer import _snapshot as snap
    g = torch.Generator().manual_seed(6)
    tree = {"params": {"w": torch.randn((4, 3), generator=g),
                       "b": torch.randn(3, generator=g)},
            "step": torch.tensor(7)}
    yield {"fn": lambda t: snap(7, t, None, None, None), "args": (tree,)}


@contextlib.contextmanager
def _sharded_update():
    from repro_torch.launch.mesh import make_data_mesh
    with _fake(2):
        mesh = make_data_mesh()
        step, args, params = _update(1, mesh, device="meta")
        yield {"fn": step, "args": args, "mesh_axes": mesh.axis_names,
               # the reference's: one sum per gradient leaf and the loss
               "expected_sums": len(params) + 1, "sum_axes": ("data",)}


@contextlib.contextmanager
def _sharded_chunk():
    from repro_torch.launch.mesh import make_data_mesh
    with _fake(2):
        mesh = make_data_mesh()
        pipe = _pipe("meta")
        x = torch.empty((16, 24), device="meta")
        # featurization is parallel over rows: no sum at all
        yield {"fn": lambda x: pipe.launch_chunk(x, mesh=mesh), "args": (x,),
               "mesh_axes": mesh.axis_names, "expected_sums": 0}


def _attn_case(fn):
    from repro_torch.launch.mesh import make_mesh

    @contextlib.contextmanager
    def case():
        with _fake(2):
            mesh = make_mesh(1, 2)
            q = torch.empty((1, 8, 2, 8), device="meta")
            yield {"fn": lambda q, k, v: fn(q, k, v, mesh),
                   "args": (q, q.clone(), q.clone()),
                   "mesh_axes": mesh.axis_names, "expected_sums": 0}
    return case


def _allgather(q, k, v, mesh):
    from repro_torch.kernels.flash_attention import sharded_flash_attention
    return sharded_flash_attention(q, k, v, window=0, mesh=mesh,
                                   seq_axes=("model",))


def _ring_grad(q, k, v, mesh):
    from repro_torch.kernels.flash_attention import ring_flash_attention
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = ring_flash_attention(q, k, v, window=0, mesh=mesh,
                               seq_axes=("model",))
    return torch.autograd.grad(out.sum(), (q, k, v))


def _lm_step(rules=None, dtype="float32", device="cpu"):
    from repro_torch import configs
    from repro_torch.training import trainer as T
    cfg = dataclasses.replace(configs.get_config("gemma3_12b", "smoke"),
                              dtype=dtype)
    hp = T.TrainHparams(n_microbatches=2)
    if device == "meta":
        from repro_torch.launch.dryrun import build
        _, _, state, local = build(cfg, hp, rules, kind="train", seq_len=64,
                                   global_batch=4)
        return cfg, hp, T.make_train_step(cfg, hp, rules), state, local
    g = torch.Generator().manual_seed(0)
    state = T.init_train_state(cfg, hp, generator=g, device=device)
    ids = torch.randint(0, cfg.vocab, (2, 64), generator=g)
    return cfg, hp, T.make_train_step(cfg, hp), state, {"inputs": ids,
                                                       "labels": ids}


@contextlib.contextmanager
def _lm_sharded_step():
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.sharding import make_rules
    from .collectives import step_counts
    with _fake(4):
        rules = make_rules(Mesh({"data": 2, "model": 2}))
        cfg, hp, step, state, local = _lm_step(rules, device="meta")
        yield {"fn": step, "args": (state, local),
               "mesh_axes": rules.mesh.axis_names, "double_sums": False,
               "expected_counts": step_counts(
                   cfg, rules, hp, rows=local["inputs"].shape[0],
                   seq_len=64)}


@contextlib.contextmanager
def _lm_numerics():
    _, _, step, state, batch = _lm_step(dtype="bfloat16")
    # the bf16 copy of the fp32 masters; the global norm's float64 sums
    yield {"fn": step, "args": (state, batch),
           "allow_narrow": ("float32->bfloat16",) + F64_SUMS}


# ---------------------------------------------------------------------------
# the numerics sites on boundary inputs
# ---------------------------------------------------------------------------

def _codes(shape, lo, hi, seed=0):
    g = torch.Generator().manual_seed(seed)
    c = torch.randint(lo, hi + 1, shape, generator=g, dtype=torch.int64)
    c.view(-1)[:2] = torch.tensor([lo, hi])      # both extremes present
    return c.to(torch.int32)


@contextlib.contextmanager
def _pack_words():
    from repro_torch.core.hashing import pack_codes
    yield {"fn": lambda c: pack_codes(c, b=8), "args": (_codes((8, 32), 0,
                                                               255),)}


TOP_HASHES = 1 << 23      # k = 2^23 at b = 8: the top index is 2^31 - 1


@contextlib.contextmanager
def _encode_emit():
    from repro_torch.core.hashing import encode, feature_indices
    g = torch.Generator().manual_seed(1)
    i = torch.randint(-1, 2 ** 20, (1, TOP_HASHES), generator=g,
                      dtype=torch.int32)
    i[0, -1] = 2 ** 20 - 1
    t = torch.randint(-2 ** 30, 2 ** 30, (1, TOP_HASHES), generator=g,
                      dtype=torch.int32)

    def fn(i, t):
        return feature_indices(encode(i, t, b_i=4, b_t=4), b_i=4, b_t=4)
    yield {"fn": fn, "args": (i, t)}


@contextlib.contextmanager
def _pack_codes():
    from repro_torch.core.hashing import pack_codes
    yield {"fn": lambda c: pack_codes(c, b=8),
           "args": (_codes((6, 9), -1, 255),)}


@contextlib.contextmanager
def _unpack_codes():
    from repro_torch.core.hashing import unpack_codes, words_to_uint32
    words = torch.tensor([[0, 2 ** 32 - 1, 2 ** 31], [1, 2 ** 31 - 1, 255],
                          [2 ** 32 - 1] * 3, [0] * 3], dtype=torch.int64)
    yield {"fn": lambda p: unpack_codes(p, 9, b=8),
           "args": (words_to_uint32(words),)}


@contextlib.contextmanager
def _feature_indices():
    from repro_torch.core.hashing import feature_indices
    yield {"fn": lambda c: feature_indices(c, b_i=8),
           "args": (_codes((4, 9), -1, 255),)}


ONE_HOT_SCATTER = {"scatter_add": "one_hot_features adds ones: each sum is "
                                  "a count, exact in float32 while it stays "
                                  "below 2^24"}


@contextlib.contextmanager
def _one_hot():
    from repro_torch.core.hashing import one_hot_features
    yield {"fn": lambda c: one_hot_features(c, b_i=2),
           "args": (_codes((4, 9), -1, 3),), "allow": ONE_HOT_SCATTER}


@contextlib.contextmanager
def _threefry_tile():
    from repro_torch.core.regen import regen_tile
    yield {"fn": lambda k0, k1: regen_tile(k0, k1, 2 ** 32 - 16,
                                           2 ** 32 - 8, 8, 16),
           "args": (2 ** 32 - 1, 2 ** 32 - 1), "allow_wrap": True}


@contextlib.contextmanager
def _bag_logits():
    from repro_torch.core.linear_model import LinearParams, bag_logits
    g = torch.Generator().manual_seed(2)
    w = torch.randn((96, 3), generator=g)
    idx = torch.randint(-2 ** 31, 2 ** 31 - 1, (4, 6), generator=g,
                        dtype=torch.int64).to(torch.int32)
    idx[0, :2] = torch.tensor([-2 ** 31, 2 ** 31 - 1])
    yield {"fn": lambda w, b, i: bag_logits(LinearParams(w, b), i),
           "args": (w, torch.zeros(3), idx), "allow_narrow": F64_SUMS}


@contextlib.contextmanager
def _bag_logits_packed():
    from repro_torch.core.hashing import packed_width
    from repro_torch.core.linear_model import (LinearParams,
                                               bag_logits_packed,
                                               check_bag_table_size)
    k, b = TOP_HASHES, 8
    w = torch.empty((check_bag_table_size(k, b), 3), device="meta")
    packed = torch.empty((2, packed_width(k, b)), dtype=torch.uint32,
                         device="meta")
    yield {"fn": lambda w, bias, p: bag_logits_packed(
               LinearParams(w, bias), p, num_hashes=k, b=b),
           "args": (w, torch.empty(3, device="meta"), packed)}


@contextlib.contextmanager
def _flash_accumulators():
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    g = torch.Generator().manual_seed(3)
    q = torch.randn((1, 64, 2, 16), generator=g).to(torch.bfloat16)
    yield {"fn": lambda q, k, v: flash_attention_fwd(q, k, v),
           "args": (q, q.clone(), q.clone()),
           # the fp32 scores and accumulators, emitted once in bf16
           "allow_narrow": ("float32->bfloat16",)}


SITES: Tuple[Site, ...] = (
    Site("trainer.update_step", "donation", _update_step),
    Site("pipeline.launch_chunk", "donation", _launch_chunk),
    Site("pipeline.features_streamed", "donation", _features_streamed),
    Site("pipeline.features_sharded", "donation", _features_sharded),
    Site("optim.fused_adamw", "donation", _fused_adamw),
    Site("checkpoint.save_async_snapshot", "donation", _snapshot),
    Site("trainer.sharded_update", "collectives", _sharded_update),
    Site("pipeline.sharded_chunk", "collectives", _sharded_chunk),
    Site("attention.flash_allgather", "collectives", _attn_case(_allgather)),
    Site("attention.flash_ring", "collectives", _attn_case(_ring_grad)),
    Site("trainer.lm_sharded_step", "collectives", _lm_sharded_step),
    Site("trainer.grad_accum", "numerics", _grad_accum),
    Site("trainer.lm_step", "numerics", _lm_numerics,
         ("dtype_flow", "determinism")),
    Site("flash.accumulators", "numerics", _flash_accumulators,
         ("dtype_flow", "determinism")),
    Site("optim.fused_adamw_carry", "numerics", _fused_adamw,
         ("dtype_flow", "determinism")),
    Site("kernels.pack_words", "numerics", _pack_words),
    Site("kernels.encode_emit", "numerics", _encode_emit),
    Site("hashing.pack_codes", "numerics", _pack_codes),
    Site("hashing.unpack_codes", "numerics", _unpack_codes),
    Site("hashing.feature_indices", "numerics", _feature_indices),
    Site("hashing.one_hot_features", "numerics", _one_hot),
    Site("regen.threefry_tile", "numerics", _threefry_tile),
    Site("linear.bag_logits", "numerics", _bag_logits),
    Site("linear.bag_logits_packed_boundary", "numerics",
         _bag_logits_packed, ("int_range",)),
)


def _launch_probe(op: str) -> list:
    """The op's launch probe through the registry: it must record one
    launch whose plan and kernels the cuda route would run."""
    from repro_torch.kernels import ops as kernel_ops
    args, kwargs = PROBES[op]()
    call = getattr(kernel_ops, op)
    try:
        launches = record_launches(call, *args, **kwargs)
    except Exception as e:   # noqa: BLE001 - reported as a finding
        return [Finding(check="completeness", target=op,
                        message=f"the launch probe raised {e!r}")]
    mine = [lc for lc in launches if lc.op == op]
    if not mine or mine[0].plan is None or not mine[0].kernels:
        return [Finding(check="completeness", target=op, message=(
            f"the launch probe of {op!r} recorded no launch with a plan "
            f"and kernels: {launches}"))]
    return []


def run_site(site: Site, checks=CHECKS) -> list:
    """(check, findings) of every check of ``checks`` that ``site``
    takes."""
    out = []
    with site.case() as case:
        fn, args = case["fn"], case["args"]
        if site.kind == "donation" and "donation" in checks:
            out.append(("donation", audit_donation(
                fn, args, mutates=case.get("mutates", ()), name=site.name)))
        if site.kind == "collectives" and "collectives" in checks:
            out.append(("collectives", audit_collectives(
                fn, args, name=site.name, mesh_axes=case.get("mesh_axes"),
                expected_sums=case.get("expected_sums"),
                sum_axes=case.get("sum_axes"),
                expected_counts=case.get("expected_counts"),
                double_sums=case.get("double_sums", True))))
        if site.kind == "numerics":
            wanted = site.checks or NUMERICS_CHECKS
            if "dtype_flow" in checks and "dtype_flow" in wanted:
                out.append(("dtype_flow", audit_dtype_flow(
                    fn, args, name=site.name,
                    allow_narrow=case.get("allow_narrow", ()))))
            if "int_range" in checks and "int_range" in wanted:
                out.append(("int_range", audit_intervals(
                    fn, args, name=site.name,
                    allow_wrap=case.get("allow_wrap", False))))
            if "determinism" in checks and "determinism" in wanted:
                out.append(("determinism", audit_determinism(
                    fn, args, name=site.name, allow=case.get("allow", {}))))
    return out


def run_suite(families: Optional[Iterable[str]] = None, *,
              checks: Iterable[str] = CHECKS,
              exhaustive: bool = False) -> Report:
    checks = tuple(checks)
    rep = Report()
    fams = tuple(families) if families else model_families()
    ops = [op for op in registry.IMPLS
           if not families or registry.family(op) in fams or op in fams]

    if "completeness" in checks:
        found = audit_completeness()
        for op in ops:
            if op in PROBES:
                found += _launch_probe(op)
        rep.extend(found)
        for op in ops:
            rep.mark(op, "completeness", found)
        rep.stats["completeness"] = {"ops": len(ops)}

    if "smem" in checks:
        stats: dict = {}
        found = audit_smem(fams, exhaustive=exhaustive, stats=stats)
        rep.extend(found)
        rep.stats["smem"] = stats
        for fam in fams:
            rep.mark(fam, "smem", found)

    if "coverage" in checks:
        stats = {}
        found = audit_coverage(fams, stats=stats)
        rep.extend(found)
        rep.stats["coverage"] = stats
        for fam in fams:
            rep.mark(fam, "coverage", found)

    if "dtype_flow" in checks:
        for fam in fams:
            found = accum_findings(fam)
            rep.extend(found)
            rep.mark(fam, "dtype_flow", found)

    if "determinism" in checks:
        found = audit_trio_signatures(families)
        rep.extend(found)
        for op in ops:
            rep.mark(op, "determinism", found)

    for site in SITES:
        for check, found in run_site(site, checks):
            rep.extend(found)
            rep.mark(site.name, check, found)
    return rep
