"""Port parity: the LM trainer's sharding specs (``param_pspecs``,
``state_pspecs``, ``cache_pspecs``, ``input_specs``) against the
reference's, spec for spec, for all ten configs, full and smoke, at eight
meshes.

The reference's spec functions take an ``AbstractMesh`` and need no
device; the port's take rules over a stand-in mesh with ``.shape`` (its
spec functions read the axis sizes alone).  Both trees are flattened in
the reference's leaf order and compared entry by entry: a reference
``PartitionSpec`` as a tuple equals the port's spec tuple.
"""
import dataclasses
from types import SimpleNamespace

import jax
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import sharding as ref_sharding  # noqa: E402
from repro.training import trainer as ref_trainer  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.models import sharding as t_sharding  # noqa: E402
from repro_torch.training import trainer as t_trainer  # noqa: E402

MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (1, 4), (16, 16),
          (2, 16, 16)]
ARCHS = ref_configs.ARCHS


def _rules(shape):
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    ref = ref_sharding.make_rules(AbstractMesh(shape, names))
    port = t_sharding.make_rules(
        SimpleNamespace(shape=dict(zip(names, shape))))
    return ref, port


def _ref_leaves(tree):
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, P))


def _port_leaves(specs, like):
    """The port's spec leaves at the positions of ``like``'s tensors."""
    return [s for _, s in t_sharding.named_specs(like, specs)]


def _same(port, ref):
    ref = [None if r is None else tuple(r) for r in ref]
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a == b, (i, a, b)


def _cfg_pair(arch, variant):
    return (ref_configs.get_config(arch, variant),
            t_configs.get_config(arch, variant))


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_param_and_state_specs_equal_the_reference(mesh, variant):
    ref_rules, port_rules = _rules(mesh)
    for arch in ARCHS:
        rc, tc = _cfg_pair(arch, variant)
        like = t_trainer.init_model(tc, device="meta")
        _same(_port_leaves(t_trainer.param_pspecs(tc, port_rules), like),
              _ref_leaves(ref_trainer.param_pspecs(rc, ref_rules)))
        for compress in (False, True):
            hr = ref_trainer.TrainHparams(compress_grads=compress)
            ht = t_trainer.TrainHparams(compress_grads=compress)
            state = t_trainer.init_train_state(tc, ht, device="meta")
            got = t_trainer.state_pspecs(tc, port_rules, ht)
            want = ref_trainer.state_pspecs(rc, ref_rules, hr)
            _same(_port_leaves(got, state), _ref_leaves(want))
            assert (got.ef_residual is None) == (not compress)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_cache_specs_equal_the_reference(mesh, variant):
    ref_rules, port_rules = _rules(mesh)
    for arch in ARCHS:
        rc, tc = _cfg_pair(arch, variant)
        for batch, max_len, long in ((4, 64, False), (1, 96, True),
                                     (32, 2048, False), (1, 4096, True)):
            like = t_trainer.init_caches(tc, batch, max_len, device="meta")
            got = t_trainer.cache_pspecs(tc, port_rules, batch=batch,
                                         max_len=max_len, long=long)
            want = ref_trainer.cache_pspecs(rc, ref_rules, batch=batch,
                                            max_len=max_len, long=long)
            _same(_port_leaves(got, like), _ref_leaves(want))


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_input_specs_equal_the_reference(mesh):
    ref_rules, port_rules = _rules(mesh)
    dt = {"int32": torch.int32, "bfloat16": torch.bfloat16}
    for arch in ARCHS:
        for variant in ("full", "smoke"):
            rc, tc = _cfg_pair(arch, variant)
            for shape in ("train", "prefill", "decode"):
                for seq, batch in ((4096, 256), (128, 1), (32, 6)):
                    got = t_trainer.input_specs(tc, port_rules, shape=shape,
                                                seq_len=seq,
                                                global_batch=batch)
                    want = ref_trainer.input_specs(
                        rc, ref_rules, shape=shape, seq_len=seq,
                        global_batch=batch)
                    assert sorted(got) == sorted(want)
                    for key, w in want.items():
                        g = got[key]
                        assert g.shape == tuple(w.shape), key
                        assert g.dtype == dt[str(w.dtype)], key
                        spec = None if w.sharding is None else \
                            tuple(w.sharding.spec)
                        assert g.spec == spec, (key, g.spec, spec)


def test_train_input_is_batch_sharded():
    """The issue's check of the reference: a train batch shards its rows
    over ``data`` at (16, 16), the sequence whole."""
    _, port_rules = _rules((16, 16))
    cfg = t_configs.get_config("gemma3_12b")
    got = t_trainer.input_specs(cfg, port_rules, shape="train",
                                seq_len=4096, global_batch=256)
    assert got["inputs"].spec == ("data", None)
    assert got["labels"].spec == ("data", None)


def test_degraded_dims_are_replicated():
    """A dim that does not divide stays whole: starcoder2's 36 heads x 128
    over model = 16 divide, its 4 kv heads' 512 do too, a smoke config's
    64-wide d_model over 16 x 16 does, and a vocab of 512 over 16."""
    _, rules = _rules((16, 16))
    tc = dataclasses.replace(t_configs.get_config("starcoder2_7b", "smoke"),
                             d_model=40)
    specs = t_trainer.param_pspecs(tc, rules)
    assert specs["units"]["block0"]["mixer"]["wq"] == (None, None, "model")
    assert specs["units"]["block0"]["mixer"]["wo"] == (None, "model", None)
    assert specs["embed"]["tokens"] == (None, None)
