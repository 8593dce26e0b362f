"""The top FLOP, byte and collective contributors of one dry-run cell, by
op and module path (twin of the reference's ``tools/hlo_top.py``).

The reference reads a cell's cached HLO text.  The port has no HLO: this
runs the cell's step once on the ``meta`` device at one rank's shards,
as ``repro_torch.launch.dryrun`` does (a ``fake`` process group, the
production mesh), under ``launch.hlo_analysis``'s counting rules, and
attributes each counted matrix product, each row 8 / 9 call on its
``meta`` route and each collective to its ATen op (or kernel, or
collective kind and mesh axes) and to the innermost frame of the port
that issued it (``models/attention.py:attention_tp``).  A train step
runs at its own microbatch count, with no extrapolation.

    python -m repro_torch.tools.hlo_top --arch gemma3_12b --shape train_4k
    python -m repro_torch.tools.hlo_top --arch granite_34b \\
        --shape decode_32k --multipod --top 20
    python -m repro_torch.tools.hlo_top --arch olmoe_1b_7b \\
        --shape prefill_32k --variant smoke      # seconds, on a CPU
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
from collections import defaultdict

import torch
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import SHAPES, get_config
from repro_torch.kernels import flash_attention, registry
from repro_torch.launch import collectives, dryrun
from repro_torch.launch.hlo_analysis import _nbytes
from repro_torch.launch.mesh import Mesh
from repro_torch.models.sharding import make_rules
from repro_torch.training.trainer import make_serve_steps, make_train_step

_PKG = pathlib.Path(__file__).resolve().parents[1]
_SKIP = ("launch/hlo_analysis.py", "launch/collectives.py",
         "tools/hlo_top.py", "kernels/registry.py", "analysis/")


def module_path() -> str:
    """``file:function`` of the innermost frame in the port, past the
    counting and collective machinery."""
    f = sys._getframe(1)
    while f is not None:
        path = pathlib.Path(f.f_code.co_filename)
        try:
            rel = path.resolve().relative_to(_PKG).as_posix()
        except ValueError:
            rel = None
        if rel is not None and not rel.startswith(_SKIP):
            return f"{rel}:{f.f_code.co_name}"
        f = f.f_back
    return "?"


class Attribution(torch.utils._python_dispatch.TorchDispatchMode):
    """FLOPs and bytes of the counted products by (op, module path), and
    the collectives' and rows 8-9's work by the same keys."""

    def __init__(self):
        super().__init__()
        self.flops = defaultdict(float)
        self.bytes = defaultdict(float)
        self.coll = defaultdict(float)
        self.calls = defaultdict(int)
        self._pending = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            key = (func._overloadpacket.__name__, module_path())
            self.flops[key] += formula(*args, **kwargs, out_val=out)
            self.bytes[key] += sum(_nbytes(t) for t in tree_leaves(
                (args, kwargs, out)))
        return out

    def on_collective(self, call):
        key = (f"{call['kind']} over {','.join(call['axes'])}",
               module_path())
        self.coll[key] += call["bytes"]
        self.calls[key] += 1

    def _settle(self):
        if self._pending is not None:
            key, before = self._pending
            after = {op: dict(w) for op, w in
                     flash_attention.META_WORK.items()}
            for op, w in after.items():
                self.flops[key] += w["flops"] - before[op]["flops"]
                self.bytes[key] += w["bytes"] - before[op]["bytes"]
        self._pending = None

    def on_resolve(self, op, impl, args, kwargs):
        self._settle()
        self._pending = ((f"{op} ({impl} route)", module_path()),
                         {o: dict(w) for o, w in
                          flash_attention.META_WORK.items()})


def attribute(cfg, hp, mesh_shape: dict, rank: int, *, kind: str,
              seq_len: int, global_batch: int, long: bool = False):
    """Run one step of the cell on ``meta`` under ``Attribution``."""
    world = 1
    for n in mesh_shape.values():
        world *= n
    att = Attribution()
    with dryrun.fake_group(world, rank):
        rules = make_rules(Mesh(mesh_shape))
        _, params, held, local = dryrun.build(
            cfg, hp, rules, kind=kind, seq_len=seq_len,
            global_batch=global_batch, long=long)
        collectives.CALL_HOOKS.append(att.on_collective)
        registry.RESOLVE_HOOKS.append(att.on_resolve)
        try:
            with att:
                if kind == "train":
                    make_train_step(cfg, hp, rules)(held, local)
                else:
                    prefill_step, decode_one = make_serve_steps(cfg, rules)
                    with torch.no_grad():
                        if kind == "prefill":
                            prefill_step(params, local["inputs"], held)
                        else:
                            decode_one(params, local["tokens"], torch.tensor(
                                seq_len - 1, dtype=torch.int32), held)
            att._settle()
        finally:
            collectives.CALL_HOOKS.remove(att.on_collective)
            registry.RESOLVE_HOOKS.remove(att.on_resolve)
    return att


def report(att: Attribution, top: int) -> str:
    lines = []
    for title, table in (("DOT FLOPS", att.flops), ("BYTES", att.bytes),
                         ("COLLECTIVE BYTES", att.coll)):
        rows = sorted(table.items(), key=lambda kv: -kv[1])
        lines.append(f"== {title}: total {sum(table.values()):.3e} ==")
        for (op, where), v in rows[:top]:
            n = f" calls={att.calls[(op, where)]}" if table is att.coll \
                else ""
            lines.append(f"  {v:.3e}  {op[:40]:<40} in {where}{n}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="hlo_top", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--variant", default="full", choices=("full", "smoke"),
                    help="smoke: the arch's smoke config at the cell's "
                         "shape cut to 64 tokens and 8 rows (fast)")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    seq_len, global_batch, kind = SHAPES[args.shape]
    if args.variant == "smoke":
        cfg = get_config(args.arch, "smoke")
        seq_len, global_batch = 64, 8
        mesh = {"data": 2, "model": 2}
        if args.multipod:
            mesh = {"pod": 2, **mesh}
    else:
        cfg = dryrun.cell_config(args.arch)
        mesh = dryrun.production_shape(args.multipod)
    hp = dryrun.cell_hparams(args.arch, kind)
    if args.variant == "smoke":
        hp = dataclasses.replace(hp, n_microbatches=1)
    att = attribute(cfg, hp, mesh, 0, kind=kind, seq_len=seq_len,
                    global_batch=global_batch,
                    long=args.shape.startswith("long"))
    print(f"{args.arch} {args.shape} on {mesh} at rank 0 "
          f"({args.variant}; meta device, counts of this CPU)")
    print(report(att, args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
