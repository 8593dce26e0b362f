"""Device meshes over ``torch.distributed`` with the reference's axis
names ``("data", "model")``.

Port of ``repro.launch.mesh``.  A mesh lays the ranks of a process group
out row-major over its axes, as ``jax.make_mesh`` lays out devices: rank
``d * model + m`` sits at ``data = d``, ``model = m``.  For every axis,
and for the two axes together, the mesh holds this rank's process group
along it (the ranks that differ from this one only in those axes, in
axis order), this rank's index along it (``jax.lax.axis_index``) and its
size (``mesh.shape[a]``).

Nothing here initializes a process group: the caller runs
``torch.distributed.init_process_group`` (its backend, address, world size
and rank) first, and the mesh's groups take that backend; ``host_group``
is a gloo group over all the mesh's ranks for host-side agreement (a fake
one under the ``fake`` backend of the dry run, ``launch.dryrun``).
Without an initialized process group the only mesh is the one of a
single rank, which holds no groups and needs no communication.  Building a mesh
creates its groups, which is collective: every rank of the default group
builds the same mesh, in the same order.
"""
from __future__ import annotations

import datetime
import itertools
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str], None]


def _names(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """``shape`` maps each axis name to its size, in axis order."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = 1
        for n in self.shape.values():
            if n < 1:
                raise ValueError(f"mesh axis sizes must be >= 1: {shape}")
            self.size *= n
        if dist.is_initialized():
            self.rank, world = dist.get_rank(), dist.get_world_size()
        else:
            self.rank, world = 0, 1
        if self.size > world:
            raise ValueError(f"a mesh of {self.size} ranks {self.shape} "
                             f"needs as many processes; the process group "
                             f"has {world}")
        # every subset of the axes (the groups along it), built on every
        # rank of the default group in one order, members or not
        self._groups = {}
        self._ranks = {}
        for n_ax in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, n_ax):
                self._build(axes)
        # a gloo group over every rank of the mesh for host-side agreement
        # (checkpoint commits), used from writer threads as well: a group
        # of its own, so it never interleaves with the axes' collectives.
        # Under a ``fake`` default group (the dry run, which moves no data)
        # it is a fake group too: a fake group cannot build a gloo one
        self.host_group = None
        if dist.is_initialized():
            backend = "fake" if dist.get_backend() == "fake" else "gloo"
            self.host_group = dist.new_group(list(range(self.size)),
                                             backend=backend)
        if self.rank >= self.size:
            raise ValueError(f"rank {self.rank} lies outside a mesh of "
                             f"{self.size} ranks {self.shape}")
        self.coords = self._coords(self.rank)

    def _coords(self, rank: int) -> Dict[str, int]:
        out = {}
        for a in reversed(self.axis_names):
            out[a] = rank % self.shape[a]
            rank //= self.shape[a]
        return {a: out[a] for a in self.axis_names}

    def _rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def _build(self, axes: Tuple[str, ...]) -> None:
        """One group per fixed value of the other axes; keep this rank's."""
        others = [a for a in self.axis_names if a not in axes]
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in others)):
            base = dict(zip(others, fixed))
            ranks = [self._rank_of({**base, **dict(zip(axes, idx))})
                     for idx in itertools.product(*(range(self.shape[a])
                                                    for a in axes))]
            group = None
            if dist.is_initialized():
                group = dist.new_group(ranks)
            if self.rank in ranks:
                self._groups[axes] = group
                self._ranks[axes] = ranks

    def _key(self, axes: Axes) -> Tuple[str, ...]:
        names = _names(axes)
        for a in names:
            if a not in self.shape:
                raise ValueError(f"mesh axes {self.axis_names} carry no "
                                 f"{a!r} axis")
        return tuple(a for a in self.axis_names if a in names)

    def group(self, axes: Axes):
        """This rank's process group along ``axes`` (None on a one-rank
        mesh without a process group)."""
        return self._groups[self._key(axes)]

    def ranks(self, axes: Axes):
        """The global ranks of this rank's group along ``axes``, in the
        order of its index along them."""
        return list(self._ranks[self._key(axes)])

    def axis_index(self, axes: Axes) -> int:
        """This rank's index along ``axes``, the axes taken row-major (the
        reference's ``_shard_index``)."""
        idx = 0
        for a in self._key(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def make_mesh(data: int, model: int) -> Mesh:
    """A (data, model) mesh over the first data * model ranks."""
    return Mesh({"data": data, "model": model})


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh: (data=16, model=16), or with
    ``multi_pod`` (pod=2, data=16, model=16); raises, naming the ranks it
    needs, when the process group is smaller."""
    shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    need = 1
    for n in shape.values():
        need *= n
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < need:
        raise ValueError(f"the production mesh {shape} needs {need} ranks; "
                         f"the process group has {world}")
    return Mesh(shape)


def make_local_mesh() -> Mesh:
    """Every rank of the process group as a (data=N, model=1) mesh; one
    rank without a process group."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(n, 1)


def make_data_mesh(ndev: Optional[int] = None) -> Mesh:
    """A pure data-parallel (data=ndev, model=1) mesh over the first
    ``ndev`` ranks; ``None`` takes every rank (same as make_local_mesh)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if ndev is None else ndev
    if n > world:
        raise ValueError(f"asked for {n} ranks but only {world} exist")
    return make_mesh(n, 1)


def data_axis_size(mesh: Mesh) -> int:
    """Number of ranks along the ``data`` axis: the shard count of every
    data-parallel launch."""
    if "data" not in mesh.shape:
        raise ValueError(
            f"mesh axes {tuple(mesh.shape)} carry no 'data' axis; "
            f"data-parallel paths shard over 'data' (see make_*_mesh)")
    return mesh.shape["data"]


def axis_size(mesh: Mesh, axes: Axes) -> int:
    """Product of the named mesh axis sizes.  ``axes`` is a name, a tuple
    of names, or None/() -> 1."""
    size = 1
    for a in _names(axes):
        size *= mesh.shape[a]
    return size


def join_torchrun_group(device: str):
    """Join ``torchrun``'s process group (gloo, ``env://``) when its
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) is set and no group exists yet; returns (this rank's
    device: ``cuda:{LOCAL_RANK % device_count}`` for a CUDA device,
    whether this call made the group, which its caller then destroys)."""
    if "RANK" not in os.environ or dist.is_initialized():
        return device, False
    dist.init_process_group("gloo", init_method="env://",
                            timeout=datetime.timedelta(seconds=600))
    if device.startswith("cuda") and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = f"cuda:{local % torch.cuda.device_count()}"
    return device, True
