"""Served-model bundles on disk, in the reference's format.

A bundle directory holds

    bundle.json   format tag, mode, FeatureSpec fields, dim, n_classes,
                  row_chunk and the pipeline fingerprint
    arrays.npz    w (F, C), b (C,), and the CWS state: key_words (2,)
                  uint32 in regen mode, else r/log_c/beta (D, k) fp32

which is ``repro.serving.bundle``'s layout (``FORMAT`` below), so a
bundle exported by the JAX package loads here and the reverse also works.
``load_bundle`` verifies the rebuilt pipeline's fingerprint against the
manifest.  The writer goes through a tmp dir and an atomic rename, and
moves an existing bundle aside before replacing it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.linear_model import LinearParams, validate_bag_features
from repro_torch.device import resolve_device
from repro_torch.pipeline import FeaturePipeline, FeatureSpec

FORMAT = "repro-served-model/v1"

__all__ = ["save_bundle", "load_bundle", "FORMAT"]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_bundle(path, params: LinearParams, pipe: FeaturePipeline) -> None:
    """Write a served-model bundle directory (atomically) for
    ``(params, pipe)``; the table is validated against the pipeline."""
    validate_bag_features(params, pipe.num_features, spec=pipe.spec)
    path = pathlib.Path(path)
    manifest = {
        "format": FORMAT,
        "mode": "regen" if pipe.param_free else "stored",
        "spec": dataclasses.asdict(pipe.spec),
        "dim": int(pipe.dim),
        "n_classes": int(params.b.shape[0]),
        "row_chunk": int(pipe.row_chunk),
        "fingerprint": pipe.fingerprint(),
    }
    arrays = {"w": _np(params.w), "b": _np(params.b)}
    if pipe.param_free:
        arrays["key_words"] = np.asarray(pipe._key_words, np.uint32)
    else:
        s = pipe._state()
        arrays.update(r=_np(s.r), log_c=_np(s.log_c), beta=_np(s.beta))
    tmp = path.with_name(path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "bundle.json").write_text(json.dumps(manifest, indent=1))
    if path.exists():
        # a non-empty directory cannot be rename-replaced: move the old
        # bundle aside, install the new one, then drop the old, so a
        # complete bundle is on disk at every instant
        old = path.with_name(path.name + ".old")
        if old.exists():
            shutil.rmtree(old)
        os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old)
    else:
        os.replace(tmp, path)


def load_bundle(path, *, device=None,
                **pipe_kw) -> Tuple[LinearParams, FeaturePipeline]:
    """Bundle dir -> ``(params, pipe)`` on ``device`` (the card unless
    ``device="cpu"``), fingerprint-verified."""
    device = resolve_device(device)
    path = pathlib.Path(path)
    manifest = json.loads((path / "bundle.json").read_text())
    if manifest.get("format") != FORMAT:
        raise ValueError(
            f"{path} is not a served-model bundle (format="
            f"{manifest.get('format')!r}; expected {FORMAT!r})")
    with np.load(path / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    spec = FeatureSpec(**manifest["spec"])
    pipe_kw.setdefault("row_chunk", manifest.get("row_chunk", 8192))
    if manifest["mode"] == "regen":
        pipe = FeaturePipeline.create_regen(arrays["key_words"],
                                            manifest["dim"], spec,
                                            device=device, **pipe_kw)
    else:
        pipe = FeaturePipeline.from_arrays(arrays["r"], arrays["log_c"],
                                           arrays["beta"], spec,
                                           device=device, **pipe_kw)
    fp = pipe.fingerprint()
    if fp != manifest["fingerprint"]:
        raise ValueError(
            f"bundle {path} fingerprint mismatch: manifest says "
            f"{manifest['fingerprint']} but the reconstructed pipeline "
            f"fingerprints as {fp} — arrays and manifest have drifted")
    params = LinearParams(
        torch.as_tensor(arrays["w"], dtype=torch.float32, device=device),
        torch.as_tensor(arrays["b"], dtype=torch.float32, device=device))
    validate_bag_features(params, pipe.num_features, spec=pipe.spec)
    return params, pipe
