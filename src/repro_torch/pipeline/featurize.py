"""CWS sampling -> b-bit encoding -> embedding-bag indices, as one pipeline
(port of ``repro.pipeline.featurize``).

    pipe = FeaturePipeline.create_regen(key_words, dim, FeatureSpec(1024, 8))
    idx  = pipe.features(x)          # (n, k) int32 into pipe.num_features

``hashes`` / ``codes`` give the raw (i*, t*) and the per-hash codes for
the collision estimators.  ``features`` streams ``row_chunk`` rows per
kernel launch.  PyTorch runs eagerly, so a ragged last chunk needs no
padding to avoid a recompile: each launch is sized to its rows.  The
pipeline lives on one device; its kernels are the CUDA ones for a CUDA
pipeline and the plain versions for a CPU pipeline.

Data axis: ``mesh=`` (``repro_torch.launch.mesh``) on ``launch_chunk``,
``feature_chunks`` and ``features`` splits each chunk's rows over the
mesh's ``data`` ranks in contiguous blocks, as ``P("data")`` lays them
out: every rank featurizes its block with the same kernel on the same
(replicated) launch state, and the blocks come back to every rank in
rank order through ``collectives.all_gather_dim``.  The outputs are
integers, so the result equals the unsharded one bit for bit.  A chunk
whose rows do not divide over the axis is padded with all-zero rows
(bucket 0), which are cut off again.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core.cws import (CWSParams, cws_hash_reference,
                                  cws_hash_regen, make_cws_params)
from repro_torch.core.hashing import (check_packed_bits, encode,
                                      feature_indices, hashed_dim,
                                      pack_codes, packed_width, unpack_codes)
from repro_torch.core.regen import key_words
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, registry
from repro_torch.launch.mesh import data_axis_size


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """k hashes, 2^{b_i+b_t} buckets each; ``packed`` emits the b-bit codes
    as (n, ceil(k*b/32)) uint32 words instead of (n, k) int32 indices."""
    num_hashes: int
    b_i: int
    b_t: int = 0
    packed: bool = False

    @property
    def width(self) -> int:
        return 1 << (self.b_i + self.b_t)

    @property
    def bits(self) -> int:
        return self.b_i + self.b_t

    @property
    def packed_words(self) -> int:
        return packed_width(self.num_hashes, self.bits)

    @property
    def num_features(self) -> int:
        return hashed_dim(self.num_hashes, self.b_i, self.b_t)


class FeaturePipeline:
    """CWS featurization bound to one (params, spec) pair, or in param-free
    mode to one (key words, spec) pair: two uint32 words from which every
    launch regenerates its parameters."""

    def __init__(self, params: Optional[CWSParams], spec: FeatureSpec, *,
                 row_chunk: int = 8192, regen_key=None,
                 dim: Optional[int] = None, device=None):
        if params is None:
            if regen_key is None or dim is None:
                raise ValueError(
                    "param-free mode needs regen_key and dim "
                    "(use FeaturePipeline.create_regen)")
            self._key_words = key_words(regen_key)
            self.dim = int(dim)
            self.device = resolve_device(device)
        elif regen_key is not None:
            raise ValueError("pass either params or regen_key, not both")
        else:
            if spec.num_hashes > params.num_hashes:
                raise ValueError(
                    f"spec asks for {spec.num_hashes} hashes but params "
                    f"carry only {params.num_hashes}")
            self._key_words = None
            self.dim = params.dim
            self.device = params.device
        self.params = params
        self.spec = spec
        if spec.packed:
            self._require_bucketed("FeatureSpec(packed=True)")
            check_packed_bits(spec.bits)
        self.row_chunk = row_chunk
        self._sliced_state = None

    @classmethod
    def create(cls, generator: torch.Generator, dim: int, spec: FeatureSpec,
               **kw) -> "FeaturePipeline":
        """Stored-parameter pipeline with fresh parameters drawn from
        ``generator``, on the generator's device."""
        return cls(make_cws_params(generator, dim, spec.num_hashes), spec,
                   **kw)

    @classmethod
    def from_arrays(cls, r, log_c, beta, spec: FeatureSpec, *, device=None,
                    **kw) -> "FeaturePipeline":
        """Stored-parameter pipeline from (D, k) arrays (numpy or tensors),
        e.g. a bundle's or the reference's parameters."""
        dev = resolve_device(device)
        as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                         device=dev).contiguous()
        return cls(CWSParams(as_t(r), as_t(log_c), as_t(beta)), spec, **kw)

    @classmethod
    def create_regen(cls, key, dim: int, spec: FeatureSpec,
                     **kw) -> "FeaturePipeline":
        """Param-free pipeline: stores only the two key words of ``key``."""
        return cls(None, spec, regen_key=key, dim=dim, **kw)

    def with_key(self, key) -> "FeaturePipeline":
        """A fresh-parameter replica of a param-free pipeline."""
        if not self.param_free:
            raise ValueError("with_key is for param-free pipelines; "
                             "stored-param pipelines rebuild via create()")
        return FeaturePipeline(None, self.spec, row_chunk=self.row_chunk,
                               regen_key=key, dim=self.dim,
                               device=self.device)

    @property
    def param_free(self) -> bool:
        return self.params is None

    @property
    def num_features(self) -> int:
        return self.spec.num_features

    def fingerprint(self) -> dict:
        """The feature space and a crc32 digest of the launch state: the
        reference's digest over the same numpy bytes (two uint32 key words,
        or the float32 r/log_c/beta matrices), so bundles verify across
        the two frameworks."""
        if self.param_free:
            data = np.asarray(self._key_words, np.uint32).tobytes()
        else:
            s = self._state()
            data = b"".join(m.detach().cpu().numpy().tobytes()
                            for m in (s.r, s.log_c, s.beta))
        return {"spec": dataclasses.asdict(self.spec),
                "dim": int(self.dim),
                "param_free": bool(self.param_free),
                "digest": f"{zlib.crc32(data) & 0xFFFFFFFF:08x}"}

    def _state(self):
        """The launch state: the (k-sliced) CWSParams, or the key words."""
        if self.param_free:
            return self._key_words
        if self.spec.num_hashes == self.params.num_hashes:
            return self.params
        if self._sliced_state is None:
            self._sliced_state = self.params.slice_hashes(
                0, self.spec.num_hashes)
        return self._sliced_state

    def _op_name(self) -> str:
        op = "cws_encode_rng" if self.param_free else "cws_encode"
        return op + "_packed" if self.spec.packed else op

    def _as_rows(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def _launch_with(self, x: torch.Tensor, state) -> torch.Tensor:
        """One kernel launch on explicit state (CWSParams or key words)."""
        fn = registry.resolve(self._op_name(), x.device)
        if self.param_free:
            return fn(x, state, self.spec.num_hashes, b_i=self.spec.b_i,
                      b_t=self.spec.b_t)
        return fn(x, state, b_i=self.spec.b_i, b_t=self.spec.b_t)

    def _empty(self, n: int = 0) -> torch.Tensor:
        if self.spec.packed:
            return torch.zeros((n, self.spec.packed_words),
                               dtype=torch.int32,
                               device=self.device).view(torch.uint32)
        return torch.zeros((n, self.spec.num_hashes), dtype=torch.int32,
                           device=self.device)

    # -- public API ----------------------------------------------------

    def chunk_rows(self, mesh=None) -> int:
        """The streaming chunk: ``row_chunk`` rows, or under a mesh
        ``lcm(row_chunk, ndev)``, so every full chunk splits evenly over
        the ``data`` axis."""
        if mesh is None:
            return self.row_chunk
        return math.lcm(self.row_chunk, data_axis_size(mesh))

    def launch_chunk(self, xc, *, mesh=None) -> torch.Tensor:
        """ONE kernel launch (a rank): xc (m, D) nonneg -> (m, k) int32
        indices (or (m, words) uint32 in packed mode).  With ``mesh`` each
        rank launches on its block of m / ndev rows and the blocks are
        gathered; m must divide by the axis."""
        self._require_bucketed("launch_chunk")
        if mesh is None:
            return self._launch_with(self._as_rows(xc), self._state())
        ndev = data_axis_size(mesh)
        if xc.shape[0] % ndev:
            raise ValueError(
                f"launch_chunk under mesh= needs rows divisible by the "
                f"data axis ({ndev}); got {xc.shape[0]} — pad the chunk "
                f"(chunk_rows(mesh) gives the streaming shape)")
        return self._sharded(xc, 0, xc.shape[0], mesh)

    def _local_rows(self, x, lo: int, hi: int, mesh) -> torch.Tensor:
        """This rank's block of rows ``[lo, hi)`` of ``x`` (host or device
        rows) on the pipeline's device, the span padded with all-zero rows
        to a multiple of the ``data`` axis: rank r of ndev takes the r-th
        of ndev equal blocks."""
        ndev = data_axis_size(mesh)
        m = hi - lo
        block = (m + (-m) % ndev) // ndev
        a = min(lo + mesh.axis_index("data") * block, hi)
        b = min(a + block, hi)
        rows = self._as_rows(x[a:b])
        if b - a < block:
            rows = torch.cat([rows, rows.new_zeros((block - (b - a),
                                                    rows.shape[1]))])
        return rows

    def _sharded(self, x, lo: int, hi: int, mesh) -> torch.Tensor:
        """Rows ``[lo, hi)`` featurized over the ``data`` axis: one launch
        on this rank's block, the blocks gathered in rank order, the pad
        rows cut off."""
        from repro_torch.launch.collectives import all_gather_dim
        local = self._launch_with(self._local_rows(x, lo, hi, mesh),
                                  self._state())
        words = local.view(torch.int32) if self.spec.packed else local
        out = all_gather_dim(words, mesh, "data", dim=0)[:hi - lo]
        return out.view(torch.uint32) if self.spec.packed else out

    def feature_chunks(self, x, *, mesh=None):
        """Yields ``(lo, hi, features[lo:hi])`` per ``chunk_rows(mesh)``
        rows, so a consumer never holds the whole (n, k) feature matrix;
        host rows cross to the device one chunk (a rank: one block) at a
        time."""
        self._require_bucketed("feature_chunks")
        rows = self.chunk_rows(mesh)
        for lo in range(0, x.shape[0], rows):
            hi = min(lo + rows, x.shape[0])
            if mesh is None:
                yield lo, hi, self.launch_chunk(x[lo:hi])
            else:
                yield lo, hi, self._sharded(x, lo, hi, mesh)

    def features(self, x, *, mesh=None) -> torch.Tensor:
        """x (n, D) nonneg -> (n, k) int32 indices into ``num_features``,
        or (n, ``spec.packed_words``) uint32 in packed mode; with ``mesh``
        every launch is split over its ``data`` axis (n below the axis
        size leaves some ranks nothing but pad rows)."""
        self._require_bucketed("features")
        if x.shape[0] == 0:
            return self._empty()
        if x.shape[0] <= self.chunk_rows(mesh):
            if mesh is None:
                return self.launch_chunk(x)
            return self._sharded(x, 0, x.shape[0], mesh)
        return torch.cat([out for _, _, out in
                          self.feature_chunks(x, mesh=mesh)], dim=0)

    def hashes(self, x):
        """Stage 1 alone, for estimator sweeps that reuse one hash pass
        across many (b_i, b_t) encodings: x (n, D) nonneg -> (i*, t*) each
        (n, k) int32, through the raw hash kernel in one launch."""
        if x.shape[0] == 0:
            z = torch.zeros((0, self.spec.num_hashes), dtype=torch.int32,
                            device=self.device)
            return z, z
        x = self._as_rows(x)
        if self.param_free:
            return ops.cws_hash_rng(x, self._key_words, self.spec.num_hashes)
        return ops.cws_hash(x, self._state())

    def codes(self, x) -> torch.Tensor:
        """Per-hash codes without feature offsets (collision estimators);
        all-zero rows keep the sentinel -1."""
        i_star, t_star = self.hashes(x)
        return encode(i_star, t_star, b_i=self.spec.b_i, b_t=self.spec.b_t)

    def features_from_hashes(self, i_star, t_star) -> torch.Tensor:
        """Stages 2 and 3 on precomputed (i*, t*)."""
        self._require_bucketed("features_from_hashes")
        codes = encode(i_star, t_star, b_i=self.spec.b_i, b_t=self.spec.b_t)
        if self.spec.packed:
            return pack_codes(codes, b=self.spec.bits)
        return feature_indices(codes, b_i=self.spec.b_i, b_t=self.spec.b_t)

    def unpack_features(self, packed: torch.Tensor) -> torch.Tensor:
        """Packed words -> the (n, k) int32 global indices the unpacked
        pipeline emits."""
        if not self.spec.packed:
            raise ValueError("unpack_features needs a packed=True spec")
        codes = unpack_codes(packed, self.spec.num_hashes, b=self.spec.bits)
        offs = torch.arange(self.spec.num_hashes, dtype=torch.int64,
                            device=packed.device) * self.spec.width
        return (offs + codes).to(torch.int32)

    def staged_reference(self, x) -> torch.Tensor:
        """The unchunked staged oracle (the counter-spec regen path in
        param-free mode)."""
        x = self._as_rows(x)
        if self.param_free:
            i_star, t_star = cws_hash_regen(x, self._key_words,
                                            self.spec.num_hashes)
        else:
            i_star, t_star = cws_hash_reference(x, self._state())
        return self.features_from_hashes(i_star, t_star)

    def scoring_chunk_fn(self):
        """The online-serving launch: ``fn(xc, state, table) -> (m, C)``
        float32 logits, the encode kernel feeding ``bag_logits`` (or
        ``bag_logits_packed`` for packed specs)."""
        self._require_bucketed("scoring_chunk_fn")
        from repro_torch.core.linear_model import (bag_logits,
                                                   bag_logits_packed)
        spec = self.spec

        def score(xc, state, table):
            feats = self._launch_with(xc, state)
            if spec.packed:
                return bag_logits_packed(table, feats,
                                         num_hashes=spec.num_hashes,
                                         b=spec.bits)
            return bag_logits(table, feats)

        return score

    def _require_bucketed(self, method: str) -> None:
        """Embedding-bag expansion needs b_i >= 1: b_i = 0 keeps i* in
        full, so indices would not be bounded by ``num_features``."""
        if self.spec.b_i == 0:
            raise ValueError(
                f"{method} requires b_i >= 1 (b_i = 0 keeps i* in full, so "
                f"indices are not bounded by num_features = "
                f"{self.spec.num_features})")
