"""Guards on the port's boundaries.

  * no module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
    ``jax`` or anything of ``repro`` (an AST scan, and an import of every
    module in a subprocess where both are blocked);
  * an entry point given no device raises when CUDA is absent, instead of
    running quietly on the CPU;
  * the CPU path (serving, training, and the min-max kernel and
    estimator path) runs the plain versions and leaves the kernel launch
    counters at 0,
    and a CUDA launcher given a CPU tensor raises rather than falling
    back.
"""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core.cws import CWSParams
from repro_torch.core import GRAM_FNS
from repro_torch.core import linear_model as tlm
from repro_torch.core.kernel_svm import best_accuracy_over_C
from repro_torch.kernels import cws_hash, minmax_gram, ops, registry
from repro_torch.pipeline import FeaturePipeline, FeatureSpec
from repro_torch.serving import ServingService, load_bundle, save_bundle
from repro_torch.training import fit_linear_streamed, streamed_accuracy

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _forbidden(mod):
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_and_repro_blocked():
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import sys, importlib\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def _tiny_bundle(tmp_path):
    spec = FeatureSpec(num_hashes=8, b_i=2)
    pipe = FeaturePipeline.create_regen(np.array([1, 2], np.uint32), 6, spec,
                                        device="cpu")
    params = interop.linear_params(np.ones((pipe.num_features, 2)),
                                   np.zeros(2), device="cpu")
    save_bundle(tmp_path / "model", params, pipe)
    return tmp_path / "model", spec


def test_entry_points_without_device_raise_when_cuda_absent(tmp_path,
                                                            monkeypatch):
    path, spec = _tiny_bundle(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FeaturePipeline.create_regen(np.array([1, 2], np.uint32), 6, spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_bundle(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingService.from_bundle(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.linear_params(np.ones((3, 2)), np.zeros(2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.svm_model(np.ones((2, 3)), np.ones((2, 3)), np.arange(2))
    for init, args in ((tlm.init_bag, (8, 2)),
                       (tlm.init_bag_packed, (8, 2, 2)),
                       (tlm.init_dense, (6, 2)),
                       (tlm.init_hashed, (8, 4, 2))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init(*args)
    with pytest.raises(RuntimeError, match="not available"):
        load_bundle(path, device="cuda")


def test_lm_trainer_without_device_raises_when_cuda_absent(tmp_path,
                                                           monkeypatch):
    """The LM trainer's entry points default to the card: without one
    they raise, and the driver's default device does too."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as t_train
    from repro_torch.training import TrainHparams, init_train_state
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, hp = get_config("gemma3_12b", "smoke"), TrainHparams()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(cfg, hp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_train.build_trainer(cfg, hp, global_batch=2, seq_len=8,
                              ckpt_dir="")
    with pytest.raises(RuntimeError, match="not available"):
        t_train.main(["--arch", "gemma3_12b", "--steps", "1",
                      "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.lm_train_state(None, cfg)


def test_cpu_path_runs_plain_versions_and_no_kernel(tmp_path):
    cws_hash.reset_launches()
    path, _ = _tiny_bundle(tmp_path)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.abs(rng.standard_normal((5, 6)))
                         .astype(np.float32))
    params = CWSParams(*(torch.rand(6, 8) + 0.5 for _ in range(3)))
    ops.cws_encode(x, params, b_i=2)
    ops.cws_encode_packed(x, params, b_i=2)
    ops.cws_encode_rng(x, (1, 2), 8, b_i=2)
    ops.cws_encode_rng_packed(x, (1, 2), 8, b_i=2)
    with ServingService.from_bundle(path, device="cpu") as svc:
        svc.score(x.numpy())
    # training: the streamed trainer (tensor and host rows) and fit_linear
    params, pipe = load_bundle(path, device="cpu")
    y = torch.arange(5) % 2
    cfg = tlm.TrainCfg(n_classes=2, steps=3, batch_size=2)
    for rows in (x, x.numpy()):
        fit_linear_streamed(params, pipe, rows, y if rows is x else y.numpy(),
                            cfg=cfg)
    streamed_accuracy(params, pipe, x, y)
    tlm.fit_linear(params, pipe.features(x), y, cfg=cfg, kind="bag")
    assert cws_hash.LAUNCHES == dict.fromkeys(cws_hash.LAUNCHES, 0)


def test_cpu_min_max_path_runs_plain_versions_and_no_kernel():
    """The estimator and kernel-machine entry points on CPU tensors: raw
    hashes, codes, every Gram and the SVM, with no kernel launched."""
    cws_hash.reset_launches()
    minmax_gram.reset_launches()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(np.abs(rng.standard_normal((12, 6)))
                         .astype(np.float32))
    y = torch.arange(12) % 3
    params = CWSParams(*(torch.rand(6, 8) + 0.5 for _ in range(3)))
    ops.cws_hash(x, params)
    pipe = FeaturePipeline.create_regen(np.array([1, 2], np.uint32), 6,
                                        FeatureSpec(num_hashes=8, b_i=0),
                                        device="cpu")
    pipe.codes(x)
    for gram in GRAM_FNS.values():
        best_accuracy_over_C(gram(x, x), gram(x, x), y, y, n_classes=3,
                             Cs=(1.0,), sweeps=1)
    assert cws_hash.LAUNCHES == dict.fromkeys(cws_hash.LAUNCHES, 0)
    assert minmax_gram.LAUNCHES == {"min_sum": 0}


def test_cuda_launcher_refuses_cpu_tensors():
    x = torch.rand(3, 6)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cws_hash.cws_encode_rng_cuda(x, (1, 2), 8, b_i=2)
    assert registry.resolve("cws_encode", torch.device("cpu")) is \
        cws_hash.cws_encode_plain
    assert registry.resolve("cws_encode_rng", torch.device("cuda", 0)) is \
        cws_hash.cws_encode_rng_cuda
    assert registry.family("cws_encode_rng_packed") == "cws_rng_packed"


@pytest.mark.parametrize("launcher,args", [
    (cws_hash.cws_hash_cuda, lambda x: (CWSParams(*(torch.rand(6, 8),) * 3),)),
    (cws_hash.cws_hash_rng_cuda, lambda x: ((1, 2), 8)),
    (minmax_gram.min_sum_cuda, lambda x: (x,)),
    (minmax_gram.minmax_gram_cuda, lambda x: (x,)),
])
def test_min_max_cuda_launchers_refuse_cpu_tensors(launcher, args):
    x = torch.rand(3, 6)
    with pytest.raises(ValueError, match="CUDA tensor"):
        launcher(x, *args(x))


def test_min_max_ops_registered_by_device():
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    for op, mod in (("cws_hash", cws_hash), ("cws_hash_rng", cws_hash),
                    ("min_sum", minmax_gram), ("minmax_gram", minmax_gram)):
        assert registry.resolve(op, cpu) is getattr(mod, op + "_plain")
        assert registry.resolve(op, cuda) is getattr(mod, op + "_cuda")
    assert [registry.family(op) for op in ("cws_hash", "cws_hash_rng",
                                           "minmax_gram", "gram")] == \
        ["cws", "cws_rng", "min_sum", "min_sum"]


def test_lm_train_cpu_path_launches_no_kernel():
    """A train step on the CPU, flash route and all, runs the plain
    versions: the kernel counters stay at 0."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.training import (TrainHparams, init_train_state,
                                      make_train_step)
    cfg = dataclasses.replace(get_config("gemma3_12b", "smoke"),
                              attn_impl="flash")
    hp = TrainHparams(n_microbatches=2)
    state = init_train_state(cfg, hp, device="cpu")
    x = torch.randint(0, cfg.vocab, (2, 2 * cfg.attn_chunk + 1))
    fa.reset_launches()
    state, metrics = make_train_step(cfg, hp)(
        state, {"inputs": x[:, :-1], "labels": x[:, 1:]})
    assert torch.isfinite(metrics["loss"]) and int(state.step) == 1
    assert set(fa.LAUNCHES.values()) == {0}
    assert set(fa.BODY_LAUNCHES.values()) == {0}
