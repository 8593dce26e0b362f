"""The kernel contracts (``repro_torch.analysis``, ROADMAP A13).

  * a fixture that makes each check fire: an over-budget and a stale
    shared-memory model, plans that write an output twice or never, a
    returned alias, undeclared in-place writes, an unbound axis, a
    non-permutation ring, a gradient summed twice, an unblessed
    narrowing, a bf16 product while cuBLAS may reduce it in bf16, a float
    loop carry in bf16, a wrapping int32 add, an out-of-table gather, a
    global-generator draw, an unblessed float ``index_add_``, drifted
    impl signatures, a missing impl, a retraced shape under
    ``compile_guard`` and an exception that propagates through it;
  * held against the reference: ``check_bag_table_size`` accepts and
    refuses the same (k, b); every reference site has its counterpart;
    the reference's expected psum counts on ``pipeline.sharded_chunk``
    and ``trainer.sharded_update`` equal the port's counted sums;
  * the suite is green on the port and covers every family and site;
    the CLI's ``--all --strict --json``.
"""
import dataclasses
import json
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.core import linear_model as ref_linear  # noqa: E402

from repro_torch import analysis as A  # noqa: E402
from repro_torch.analysis import suite as S  # noqa: E402
from repro_torch.core import linear_model as t_linear  # noqa: E402
from repro_torch.kernels import cws_hash, minmax_gram, registry  # noqa: E402
from repro_torch.launch import collectives as coll  # noqa: E402
from repro_torch.launch.dryrun import fake_group  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _fires(findings, check, text=""):
    assert any(f.check == check and text in f.message for f in findings), \
        [str(f) for f in findings]


# ---------------------------------------------------------------------------
# fixtures that make each check fire
# ---------------------------------------------------------------------------

class _Doubled(minmax_gram.GramPlan):
    """Every block walks every other unit from its own: units run twice."""

    def block_units(self, b):
        return range(b % max(self.blocks // 2, 1), self.units,
                     max(self.blocks // 2, 1))


class _Short(cws_hash.SplitPlan):
    """One row tile short of the rows."""

    @property
    def grid(self):
        x, y, z = super().grid
        return x, y - 1, z


def _smem_over_budget():
    return A.audit_family_smem("min_sum", budget=100_000)


def _smem_stale():
    pinned = dict(A.PINNED_BYTES["cws"], **{"cws_split<R=8,stored>": 77824})
    return A.audit_family_smem("cws", pinned=pinned)


def _smem_no_model():
    return A.audit_family_smem("no_such_family")


def _coverage_double():
    plan = minmax_gram.gram_plan(150, 90, 99, 132, tile=(64, 64), splits=2)
    plan = _Doubled(**dataclasses.asdict(plan))
    return A.audit_plan_coverage("min_sum", plan)


def _coverage_missing():
    plan = _Short(77, 150, 70, 2, 4, 1)
    return A.audit_plan_coverage("cws_rng", plan)


_BUF = torch.zeros(4)


def _returned_alias():
    def fn(x):
        _BUF.copy_(x)
        return _BUF[:2]
    return A.audit_donation(fn, (torch.ones(4),), name="alias")


def _returned_arg():
    return A.audit_donation(lambda x: x.view(2, 2), (torch.ones(4),))


def _undeclared_write():
    return A.audit_donation(lambda x: x.add_(1.0).sum(), (torch.ones(4),))


def _with_fake(fn, mesh_shape=None):
    with fake_group(2, 0):
        mesh = Mesh(mesh_shape or {"data": 2})
        return A.audit_collectives(lambda: fn(mesh), (),
                                   mesh_axes=mesh.axis_names)


def _unbound_axis():
    return _with_fake(lambda m: coll.all_gather_dim(
        torch.empty(2, 3, device="meta"), m, "model"))


def _bad_ring():
    return _with_fake(lambda m: coll._record(
        "send_recv", m, "data", 4, 4, pairs=[(0, 1), (1, 1)]))


def _double_sum():
    def fn(m):
        g = [torch.empty(3, device="meta")]
        return coll.axis_mean(coll.axis_mean(g, m, "data"), m, "data")
    return _with_fake(fn)


def _narrowing():
    return A.audit_dtype_flow(lambda x: x.to(torch.bfloat16) * 2,
                              (torch.ones(4),))


def _bf16_product(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", True)
    a = torch.ones(4, 4, dtype=torch.bfloat16)
    return A.audit_dtype_flow(lambda a: a @ a, (a,))


def _bf16_carry():
    def fn(g):
        acc = torch.zeros(3, dtype=torch.bfloat16)
        for t in g:
            acc.add_(t)
        return acc
    return A.audit_dtype_flow(fn, (torch.ones(3, 3, dtype=torch.bfloat16),))


def _int32_wrap():
    a = torch.tensor([2 ** 30, 1], dtype=torch.int32)
    return A.audit_intervals(lambda a: a + a, (a,))


def _out_of_table():
    return A.audit_intervals(
        lambda t: t.index_select(0, torch.tensor([0, 5])), (torch.ones(5),))


def _global_draw():
    return A.audit_determinism(lambda: torch.rand(3), ())


def _float_index_add():
    def fn(t):
        return t.index_add_(0, torch.tensor([0, 0]), torch.ones(2, 2))
    return A.audit_determinism(fn, (torch.zeros(3, 2),))


def _drifted_signature():
    impls = {"cws_hash": dict(registry.IMPLS["cws_hash"],
                              cuda=lambda x, parameters: None)}
    return A.audit_trio_signatures(impls=impls)


def _missing_impl():
    impls = {"min_sum": {"reference": minmax_gram.min_sum_plain}}
    return A.audit_completeness(impls=impls)


FIRES = [
    ("smem over budget", _smem_over_budget, "smem", "over the block"),
    ("smem stale model", _smem_stale, "smem", "stale model"),
    ("smem no model", _smem_no_model, "smem", "no SMEM_MODELS"),
    ("coverage double write", _coverage_double, "coverage", "more than once"),
    ("coverage missed tile", _coverage_missing, "coverage", "never written"),
    ("donation reused buffer", _returned_alias, "donation", "reuses"),
    ("donation aliased argument", _returned_arg, "donation", "argument"),
    ("donation undeclared write", _undeclared_write, "donation",
     "does not declare"),
    ("collectives unbound axis", _unbound_axis, "collectives", "carry no"),
    ("collectives non-permutation", _bad_ring, "collectives",
     "permutation"),
    ("collectives double sum", _double_sum, "collectives", "already summed"),
    ("dtype_flow narrowing", _narrowing, "dtype_flow", "float32->bfloat16"),
    ("dtype_flow bf16 carry", _bf16_carry, "dtype_flow", "accumulated"),
    ("int_range wrap", _int32_wrap, "int_range", "wraps"),
    ("int_range gather", _out_of_table, "int_range", "table of 5 rows"),
    ("determinism global draw", _global_draw, "determinism",
     "global generator"),
    ("determinism float index_add", _float_index_add, "determinism",
     "index_add_"),
    ("determinism drifted signature", _drifted_signature, "determinism",
     "takes"),
    ("completeness missing impl", _missing_impl, "completeness", "cuda"),
]


@pytest.mark.parametrize("what,make,check,text", FIRES,
                         ids=[f[0] for f in FIRES])
def test_each_check_fires_on_its_fixture(what, make, check, text):
    _fires(make(), check, text)


def test_bf16_product_fires_while_the_flag_is_true(monkeypatch):
    _fires(_bf16_product(monkeypatch), "dtype_flow", "reduced_precision")
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", False)
    a = torch.ones(4, 4, dtype=torch.bfloat16)
    assert A.audit_dtype_flow(lambda a: a @ a, (a,)) == []


def test_blessings_silence_only_what_they_name():
    def fn(t):
        return t.index_add_(0, torch.tensor([0, 0]), torch.ones(2, 2))
    assert A.audit_determinism(fn, (torch.zeros(3, 2),),
                               allow={"index_add": "a serial loop"}) == []
    g = torch.Generator().manual_seed(0)
    assert A.audit_determinism(lambda: torch.rand(3, generator=g), ()) == []
    a = torch.tensor([2 ** 30, 1], dtype=torch.int32)
    assert A.audit_intervals(lambda a: a + a, (a,), allow_wrap=True) == []
    assert A.audit_dtype_flow(lambda x: x.to(torch.bfloat16), (
        torch.ones(2),), allow_narrow=("float32->bfloat16",)) == []
    assert A.check_permutation([(0, 1), (1, 0)], 2) == []
    assert A.check_permutation([(0, 1), (1, 1)], 2)
    assert A.check_permutation([(0, 1)], 2)


def test_compile_guard_counts_signatures_and_lets_errors_through():
    from repro_torch.kernels import ops
    x = torch.rand(5, 8)
    with pytest.raises(AssertionError, match="2 distinct signature"):
        with A.compile_guard() as g:
            g.watch("min_sum")
            ops.min_sum(x, x)
            ops.min_sum(x[:3], x)
    with pytest.raises(ZeroDivisionError):
        with A.compile_guard() as g:
            g.watch(minmax_gram.min_sum_plain, expect=5)
            ops.min_sum(x, x)
            1 / 0
    with A.compile_guard() as g:
        g.watch("min_sum", expect=1)
        for _ in range(3):
            ops.min_sum(x, x)


# ---------------------------------------------------------------------------
# the port's own sites under compile_guard
# ---------------------------------------------------------------------------

def _regen_pipe(**spec):
    from repro_torch.core.regen import prng_key
    from repro_torch.pipeline.featurize import FeaturePipeline, FeatureSpec
    return FeaturePipeline.create_regen(
        prng_key(0), 24, FeatureSpec(**{"num_hashes": 16, "b_i": 4, **spec}),
        row_chunk=8, device="cpu")


@pytest.mark.parametrize("rows,expect", [(24, 1), (27, 2)])
def test_streamed_featurize_launches_one_shape_a_chunk(rows, expect):
    pipe = _regen_pipe()
    with A.compile_guard() as g:
        g.watch("cws_encode_rng", expect=expect)
        pipe.features(torch.rand(rows, 24))


def test_serving_runner_launches_one_shape_a_bucket():
    from repro_torch.serving.runner import BucketRunner
    pipe = _regen_pipe()
    params = t_linear.init_bag(pipe.num_features, 3, device="cpu")
    runner = BucketRunner(params, pipe, buckets=(1, 4, 16))
    with A.compile_guard() as g:
        g.watch("cws_encode_rng", expect=len(runner.buckets))
        runner.warmup()
        for n in (1, 3, 9, 16):
            runner.score(torch.rand(n, 24).numpy())


def test_streamed_trainer_launches_one_shape():
    from repro_torch.core.regen import prng_key
    from repro_torch.training.linear_trainer import fit_linear_streamed
    pipe = _regen_pipe()
    x, y = torch.rand(40, 24), torch.arange(40) % 3
    cfg = t_linear.TrainCfg(n_classes=3, steps=6, batch_size=8)
    with A.compile_guard() as g:
        g.watch("cws_encode_rng", expect=1)
        fit_linear_streamed(t_linear.init_bag(pipe.num_features, 3,
                                              device="cpu"),
                            pipe, x, y, cfg=cfg, shuffle_key=prng_key(0))


def test_launch_records_carry_the_cuda_plan_and_its_bytes():
    from repro_torch.kernels import ops
    args, kwargs = A.PROBES["cws_encode"]()
    (launch,) = A.record_launches(ops.cws_encode, *args, **kwargs)
    assert launch.impl == "reference" and launch.family == "cws"
    assert launch.plan == cws_hash.split_plan(13, 150, 70, 132, stored=True)
    (k,) = launch.kernels
    assert k.smem == registry.split_smem_bytes(
        launch.plan.rows_per_thread, launch.plan.row_warps, True)
    q, kk, v = A.PROBES["flash_attention"]()[0]
    (launch,) = A.record_launches(ops.flash_attention, q.to(torch.bfloat16),
                                  kk.to(torch.bfloat16),
                                  v.to(torch.bfloat16))
    assert launch.plan.body == "simt" and launch.plan.cols == 4


# ---------------------------------------------------------------------------
# held against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b", [1, 2, 4, 8])
def test_table_bound_accepts_and_refuses_as_the_reference(b):
    for k in (1, 2 ** 20, 2 ** 23, 2 ** 23 + 1, 2 ** 24, 2 ** 30, 2 ** 31):
        try:
            want = ref_linear.check_bag_table_size(k, b)
        except ValueError:
            with pytest.raises(ValueError):
                t_linear.check_bag_table_size(k, b)
        else:
            assert t_linear.check_bag_table_size(k, b) == want


@pytest.fixture(scope="module")
def ref_sites():
    from repro.analysis.suite import register_builtin_sites
    from repro.kernels import registry as ref_registry
    register_builtin_sites()
    return ref_registry


def test_every_reference_site_has_its_counterpart(ref_sites):
    got = {s.name for s in S.SITES}
    for kind, fn in (("donation", ref_sites.donation_sites),
                     ("collectives", ref_sites.collective_sites),
                     ("numerics", ref_sites.numerics_sites)):
        names = {s.name for s in fn()}
        assert names == set(A.REFERENCE_SITES[kind])
        assert names <= got


@pytest.mark.parametrize("name", ["pipeline.sharded_chunk",
                                  "trainer.sharded_update"])
def test_expected_psums_equal_the_counted_sums(ref_sites, name):
    ref = next(s for s in ref_sites.collective_sites() if s.name == name)
    want = ref.build()["expected_psums"]
    site = next(s for s in S.SITES if s.name == name)
    with site.case() as case:
        _, _, sums = A.collectives.record_collectives(case["fn"],
                                                      *case["args"])
    assert sum(n for axes, n, _ in sums if axes == ("data",)) == want
    assert all(axes == ("data",) for axes, _, _ in sums)


# ---------------------------------------------------------------------------
# the suite on the port, and the CLI
# ---------------------------------------------------------------------------

def test_suite_is_green_and_covers_every_family_and_site():
    rep = A.run_suite()
    assert not rep.failures, rep.to_text()
    fams = {registry.family(op) for op in registry.IMPLS}
    for fam in fams:
        assert rep.matrix[fam]["smem"] == "pass"
        assert rep.matrix[fam]["coverage"] == "pass"
        assert rep.matrix[fam]["dtype_flow"] == "pass"
    for op in registry.IMPLS:
        assert rep.matrix[op]["completeness"] == "pass"
        assert rep.matrix[op]["determinism"] == "pass"
    for site in S.SITES:
        assert "pass" in rep.matrix[site.name].values(), site.name


def test_cli_all_strict_json(tmp_path):
    out = tmp_path / "lint.json"
    env = dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m",
                           "repro_torch.tools.kernel_lint", "--all",
                           "--strict", "--json", str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rep = json.loads(out.read_text())
    assert rep["schema"] == "repro_torch.kernel_lint/v1"
    assert rep["n_errors"] == 0 and "smem" in rep["checks"]
