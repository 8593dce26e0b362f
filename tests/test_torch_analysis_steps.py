"""The collectives a sharded LM train step's layout implies
(``analysis.collectives.step_counts``, ROADMAP A13) held against the dry
run's counts, all ten archs at smoke width on a fake group at (2, 2) and
(2, 2, 2); heads that do not divide over tp, the ring, and a rank with
fewer rows than microbatches (ROADMAP C11).  The reduced-precision
finding on the LM step (ROADMAP C12) before and after the fix, and
``tools/hlo_top``'s attribution.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.analysis import audit_dtype_flow  # noqa: E402
from repro_torch.analysis.collectives import step_counts  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from repro_torch.models.sharding import make_rules  # noqa: E402
from repro_torch.training import trainer as t_trainer  # noqa: E402

MESHES = {"2x2": {"data": 2, "model": 2},
          "2x2x2": {"pod": 2, "data": 2, "model": 2}}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _held(cfg, hp, mesh, seq_len, global_batch):
    world = 1
    for v in mesh.values():
        world *= v
    graph = dryrun.dry_cell(cfg, hp, mesh, 0, kind="train", seq_len=seq_len,
                            global_batch=global_batch)["graph"]
    got = {k: dict(v) for k, v in graph.collective_axes.items() if v}
    with dryrun.fake_group(world, 0):
        rules = make_rules(Mesh(mesh))
        ranks = rules.axes_size(rules.rules.get("batch"))
        # a batch that does not divide over its ranks stays whole
        rows = global_batch // ranks if global_batch % ranks == 0 \
            else global_batch
        want = step_counts(cfg, rules, hp, rows=rows, seq_len=seq_len)
    assert got == want
    return got


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", t_configs.ARCHS)
def test_step_counts_equal_the_dry_run(arch, mesh):
    got = _held(t_configs.get_config(arch, "smoke"), t_trainer.TrainHparams(),
                MESHES[mesh], 64, 8)
    assert got["all_reduce"], got          # the global norm at least


@pytest.mark.parametrize("arch,over,micro", [
    ("starcoder2_7b", {}, 1),                      # 6 heads over 4
    ("gemma3_12b", dict(attn_impl="flash", attn_chunk=32, n_heads=6,
                        attn_ring_min_sk=64), 1),   # the ring, 6 over 4
    ("gemma3_12b", {}, 4)])                        # 1 row, 4 microbatches
def test_step_counts_on_other_routes(arch, over, micro):
    cfg = dataclasses.replace(t_configs.get_config(arch, "smoke"), **over)
    got = _held(cfg, t_trainer.TrainHparams(n_microbatches=micro),
                {"data": 1, "model": 4}, 128, 1)
    if "attn_ring_min_sk" in over:
        assert got["send_recv"]["model"] > 0
    if micro > 1:
        assert "send_recv" not in got


def _lm_step():
    cfg = dataclasses.replace(t_configs.get_config("gemma3_12b", "smoke"),
                              dtype="bfloat16")
    hp = t_trainer.TrainHparams()
    g = torch.Generator().manual_seed(0)
    state = t_trainer.init_train_state(cfg, hp, generator=g, device="cpu")
    ids = torch.randint(0, cfg.vocab, (1, 32), generator=g)
    return t_trainer.make_train_step(cfg, hp), state, {"inputs": ids,
                                                       "labels": ids}


def test_lm_step_reduces_in_fp32(monkeypatch):
    """ROADMAP C12: PyTorch lets cuBLAS reduce bf16 products in bf16 by
    default; the LM's forward pins fp32 reduction.  Without the pin the
    dtype-flow audit fires on the step's bf16 products."""
    step, state, batch = _lm_step()
    narrow = ("float32->bfloat16", "float64->float32")
    matmul = torch.backends.cuda.matmul
    monkeypatch.setattr(matmul, "allow_bf16_reduced_precision_reduction",
                        True)
    monkeypatch.setattr(t_model, "pin_fp32_reduction", lambda: None)
    found = audit_dtype_flow(step, (state, batch), allow_narrow=narrow)
    assert any("reduced_precision" in f.message for f in found), found
    monkeypatch.undo()
    monkeypatch.setattr(matmul, "allow_bf16_reduced_precision_reduction",
                        True)
    assert audit_dtype_flow(step, (state, batch), allow_narrow=narrow) == []
    assert matmul.allow_bf16_reduced_precision_reduction is False
    assert matmul.allow_fp16_reduced_precision_reduction is False


def test_hlo_top_attributes_a_cell(capsys):
    from repro_torch.tools import hlo_top
    assert hlo_top.main(["--arch", "olmoe_1b_7b", "--shape", "train_4k",
                         "--variant", "smoke", "--top", "4"]) == 0
    out = capsys.readouterr().out
    assert "== DOT FLOPS" in out and "== COLLECTIVE BYTES" in out
    assert "models/moe.py" in out or "models/attention.py" in out
