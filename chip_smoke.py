#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):

  1. device   - require CUDA; print the card's name and power limit;
  2. build    - nvcc-build the encode kernels from ``src/repro_torch/csrc``
                and print the compiler's per-kernel registers, shared
                memory and spills;
  3. parity   - each of the four encode kernels against its plain PyTorch
                version on the card, exactly (integer outputs), at the
                serving shapes, at ragged shapes with all-zero rows for
                b_t in {0, 2} and packed b in {1, 2, 4, 8}, and in one wide
                launch at D = 65,536;
  4. slice    - the serving path at the paper configuration's full width
                (D = 256, k = 1024, 10 classes): four bundles (regen,
                stored, regen+packed b = 8, stored+packed b = 4), each
                booted with ``ServingService.from_bundle(device="cuda")``
                and sent ~200 synthetic requests through its gateway.  The
                launch counters are zeroed just before and read just after;
                the features of every served batch are held exactly, and
                served logits within a tolerance, against offline
                ``pipe.features(x)`` and ``bag_logits`` of them;
  5. times    - each kernel and its plain version timed with CUDA events
                at (512, 256, 1024) and (512, 65,536, 1024), beside the
                least time the card could take for the same work.

The line before the last is ``nvidia-smi``'s name and power limit, the
one before it a JSON summary of every kernel; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# The paper configuration (src/repro/configs/minmax_paper.py:CONFIG).
DIM, NUM_HASHES, B_I, N_CLASSES = 256, 1024, 8, 10
BUCKETS = (1, 8, 32, 128, 512)
WIDE_DIM = 65536          # the widest D in the reference's block table
REQUESTS, MAX_ROWS = 200, 48
DEVICE = "cuda"

# Published H100 SXM peaks (NVIDIA data sheet): 3.35 TB/s device memory,
# 67 TFLOP/s fp32 outside the tensor cores.  Integer and transcendental
# operations are counted at the fp32 rate, one each, and only the work the
# function needs: no kernel can take less time than this bound.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
THREEFRY_OPS = 117        # 20 rounds of add/rotate/xor + key injections

KERNELS = {
    # name: (replaces, regen, packed)
    "cws_encode_rng": ("src/repro/kernels/cws_hash.py:431", True, False),
    "cws_encode": ("src/repro/kernels/cws_hash.py:246", False, False),
    "cws_encode_rng_packed": ("src/repro/kernels/cws_hash.py:534", True,
                              True),
    "cws_encode_packed": ("src/repro/kernels/cws_hash.py:488", False, True),
}
SOURCE = "src/repro_torch/csrc/cws_encode.cu"


def sparse_rows(rng, n, d, density=0.3, zero_rows=()):
    x = np.abs(rng.standard_normal((n, d))).astype(np.float32)
    x *= rng.random((n, d)) < density
    for r in zero_rows:
        if r < n:
            x[r] = 0.0
    return x


def stored_params(rng, d, k, device):
    from repro_torch.core.cws import CWSParams
    r = (rng.standard_exponential((d, k)) +
         rng.standard_exponential((d, k))).astype(np.float32)
    c = (rng.standard_exponential((d, k)) +
         rng.standard_exponential((d, k))).astype(np.float32)
    beta = rng.random((d, k), dtype=np.float32)
    to = lambda a: torch.from_numpy(a).to(device)
    return CWSParams(to(r), to(np.log(c)), to(beta))


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class KernelCase:
    """One kernel's CUDA launcher and plain version on fixed inputs."""

    def __init__(self, name, x, b_i, b_t, params=None, key=None, k=None):
        from repro_torch.kernels import cws_hash as K
        self.name, self.x, self.b_i, self.b_t = name, x, b_i, b_t
        _, self.regen, self.packed = KERNELS[name]
        state = (key, k) if self.regen else (params,)
        self.args = (x,) + state
        self.cuda = getattr(K, name + "_cuda")
        self.plain = getattr(K, name + "_plain")
        self.k = k if self.regen else params.num_hashes

    def run(self, fn):
        out = fn(*self.args, b_i=self.b_i, b_t=self.b_t)
        return out.view(torch.int32) if self.packed else out

    def compare(self):
        got, want = self.run(self.cuda), self.run(self.plain)
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise AssertionError(f"{self.name}: shape {tuple(got.shape)} "
                                 f"!= plain {tuple(want.shape)}")
        if self.packed:   # packed words compare as the same 32 bits
            diff = got.to(torch.int64) & 0xFFFFFFFF
            diff = (diff - (want.to(torch.int64) & 0xFFFFFFFF)).abs()
        else:
            diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
        return int((diff != 0).sum()), int(diff.max()) if diff.numel() else 0

    def bound_ms(self):
        n, d = self.x.shape
        k = self.k
        out_bytes = (n * math.ceil(k * (self.b_i + self.b_t) / 32) * 4
                     if self.packed else 4 * n * k)
        nbytes = 4 * n * d + out_bytes + (0 if self.regen else 12 * d * k)
        # one IEEE division + ~8 fp32 operations per (row, d, hash) with
        # x > 0 (zero entries skip the update)
        ops = int((self.x > 0).sum()) * k * 9
        if self.regen:   # 3 threefry + 4 log1p + 1 log per (d, hash)
            ops += d * k * (3 * THREEFRY_OPS + 5)
        t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_parity(dev, results):
    from repro_torch.kernels.cws_hash import LAUNCHES
    rng = np.random.default_rng(11)
    key = tuple(int(w) for w in rng.integers(0, 2 ** 32, 2, dtype=np.uint64))

    def check(name, n, d, k, b_i, b_t, zero_rows=()):
        x = torch.from_numpy(sparse_rows(rng, n, d, zero_rows=zero_rows)
                             ).to(dev)
        params = None if KERNELS[name][1] else stored_params(rng, d, k, dev)
        case = KernelCase(name, x, b_i, b_t, params=params, key=key, k=k)
        bad, err = case.compare()
        r = results[name]
        r["checked"] += 1
        r["mismatches"] += bad
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if bad:
            raise AssertionError(f"{name} (n={n}, D={d}, k={k}, b_i={b_i}, "
                                 f"b_t={b_t}): {bad} outputs differ from "
                                 f"the plain version")

    for name, (_, _, packed) in KERNELS.items():
        for n in BUCKETS:
            check(name, n, DIM, NUM_HASHES, B_I, 0)
        ragged = dict(n=37, d=300, k=70, zero_rows=(0, 5, 36))
        if packed:
            for b in (1, 2, 4, 8):
                check(name, b_i=b, b_t=0, **ragged)
            for b in (4, 8):
                check(name, b_i=b - 2, b_t=2, **ragged)
        else:
            for b_t in (0, 2):
                check(name, b_i=4, b_t=b_t, **ragged)
        check(name, 512, WIDE_DIM, NUM_HASHES, B_I, 0)
        r = results[name]
        print(f"parity {name}: {r['checked']} shapes (serving n in "
              f"{BUCKETS} at D={DIM} k={NUM_HASHES}; ragged 37x300x70 with "
              f"zero rows; 512x{WIDE_DIM}x{NUM_HASHES}); mismatches "
              f"{r['mismatches']}; launches {LAUNCHES[name]}")


def make_bundles(bundle_root):
    """The four served models at CONFIG width, weights from a seed."""
    from repro_torch.core.linear_model import LinearParams
    from repro_torch.pipeline import FeaturePipeline, FeatureSpec
    from repro_torch.serving import save_bundle
    rng = np.random.default_rng(2015)
    modes = {"regen": ("cws_encode_rng", False, B_I),
             "stored": ("cws_encode", False, B_I),
             "regen_packed": ("cws_encode_rng_packed", True, 8),
             "stored_packed": ("cws_encode_packed", True, 4)}
    out = {}
    for mode, (kernel, packed, b_i) in modes.items():
        spec = FeatureSpec(NUM_HASHES, b_i, packed=packed)
        if mode.startswith("regen"):
            kw = rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
            pipe = FeaturePipeline.create_regen(kw, DIM, spec, device="cpu")
        else:
            p = stored_params(rng, DIM, NUM_HASHES, "cpu")
            pipe = FeaturePipeline(p, spec)
        w = (0.01 * rng.standard_normal((spec.num_features, N_CLASSES))
             ).astype(np.float32)
        b = (0.01 * rng.standard_normal(N_CLASSES)).astype(np.float32)
        path = bundle_root / mode
        save_bundle(path, LinearParams(torch.from_numpy(w),
                                       torch.from_numpy(b)), pipe)
        out[mode] = (kernel, path)
    return out


def tap_features(pipe, log):
    """Keep every served batch's rows and features: the tensor the
    runner's scoring launch hands to the bag gather (no copy, no sync)."""
    launch = pipe._launch_with

    def tapped(x, state):
        feats = launch(x, state)
        log.append((x, feats))
        return feats

    pipe._launch_with = tapped


def check_served_features(mode, pipe, xs, log):
    """The served features, request by request, equal offline
    ``pipe.features(x)`` exactly.  The gateway is FIFO and packs whole
    requests at the front of each batch, the rest being all-zero pad rows,
    whose features must equal those of zero rows offline."""
    as_bits = lambda t: t.view(torch.int32)
    i = 0
    for xb, feats in log:
        xb, off = xb.cpu().numpy(), 0
        while (i < len(xs) and off + xs[i].shape[0] <= xb.shape[0]
               and np.array_equal(xb[off:off + xs[i].shape[0]], xs[i])):
            m = xs[i].shape[0]
            if not torch.equal(as_bits(feats[off:off + m]),
                               as_bits(pipe.features(xs[i]))):
                raise AssertionError(f"{mode}: request {i} served features "
                                     f"differ from offline features")
            off, i = off + m, i + 1
        if off == 0 or xb[off:].any():
            raise AssertionError(f"{mode}: a served batch is not whole "
                                 f"requests in order followed by zero rows")
        if off < xb.shape[0] and not torch.equal(
                as_bits(feats[off:]), as_bits(pipe.features(xb[off:]))):
            raise AssertionError(f"{mode}: pad rows' served features differ "
                                 f"from offline features")
    if i != len(xs):
        raise AssertionError(f"{mode}: {len(xs) - i} requests never matched "
                             f"a served batch")


def phase_slice(card, results):
    from repro_torch.core.linear_model import bag_logits, bag_logits_packed
    from repro_torch.kernels import cws_hash as K
    from repro_torch.launch.serve import synthetic_rows
    from repro_torch.serving import ServingService, load_bundle

    bundle_root = ROOT / "build" / "chip_smoke_bundles"
    shutil.rmtree(bundle_root, ignore_errors=True)
    bundles = make_bundles(bundle_root)

    # the main path: four replicas, each booted from its bundle and sent
    # synthetic traffic through the gateway; counters zeroed just before
    K.reset_launches()
    served = {}
    for mode, (kernel, path) in bundles.items():
        rng = np.random.default_rng(7)
        xs = [synthetic_rows(rng, int(rng.integers(1, MAX_ROWS + 1)), DIM)
              for _ in range(REQUESTS)]
        # the burst is submitted at once, so the backlog bound must admit
        # all of it (the default 4,096 rows would shed part of it)
        with ServingService.from_bundle(
                path, device=DEVICE,
                max_queue_rows=REQUESTS * MAX_ROWS) as svc:
            batches = []   # after warmup: only the traffic's batches
            tap_features(svc.runner.pipe, batches)
            t0 = time.perf_counter()
            futs = [svc.submit(x) for x in xs]
            outs = [f.result(timeout=120.0) for f in futs]
            wall = time.perf_counter() - t0
            stats = svc.stats()
        served[mode] = (kernel, xs, outs, wall, stats, batches)
    launches = dict(K.LAUNCHES)
    for name in KERNELS:
        results[name]["launches"] = launches[name]

    for mode, (kernel, xs, outs, wall, stats, batches) in served.items():
        if launches[kernel] == 0:
            raise AssertionError(f"{mode}: kernel {kernel} was never "
                                 f"launched on the main path")
        params, pipe = load_bundle(bundles[mode][1], device=DEVICE)
        _, cpu_pipe = load_bundle(bundles[mode][1], device="cpu")
        spec = pipe.spec
        check_served_features(mode, pipe, xs, batches)
        worst = 0.0
        for i, (x, got) in enumerate(zip(xs, outs)):
            feats = pipe.features(x)
            if spec.packed:
                want = bag_logits_packed(params, feats,
                                         num_hashes=spec.num_hashes,
                                         b=spec.bits)
            else:
                want = bag_logits(params, feats)
            want = want.cpu().numpy()
            if got.shape != want.shape or not np.isfinite(got).all():
                raise AssertionError(f"{mode}: request {i} gave "
                                     f"{got.shape} / non-finite logits")
            # float32 sums of k = 1024 table rows in another order
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
            worst = max(worst, float(np.abs(got - want).max()))
            # on a few requests the offline features also equal the plain
            # CPU path's
            if i < 5:
                plain = cpu_pipe.features(x)
                if not torch.equal(plain.view(torch.int32),
                                   feats.view(torch.int32).cpu()):
                    raise AssertionError(f"{mode}: request {i} features "
                                         f"differ from the plain CPU path")
        lat = stats["latency_ms"]
        print(f"slice {mode} [{card}]: {REQUESTS} requests "
              f"({stats['rows']} rows, {stats['batches']} batches) in "
              f"{wall:.4f} s -> {REQUESTS / wall:.1f} req/s; latency p50 "
              f"{lat['p50']:.3f} ms p99 {lat['p99']:.3f} ms; {kernel} "
              f"launches {launches[kernel]}; max |served - offline| logit "
              f"{worst:.3g}; served features of {len(batches)} batches "
              f"equal offline features exactly")
        results[kernel]["slice"] = {
            "mode": mode, "req_per_s": REQUESTS / wall,
            "p50_ms": lat["p50"], "p99_ms": lat["p99"],
            "rows": stats["rows"], "batches": stats["batches"]}
    shutil.rmtree(bundle_root, ignore_errors=True)


def phase_times(dev, results):
    rng = np.random.default_rng(5)
    key = (0x2F0A1C3B, 0x9E3779B9)
    for d, tag in ((DIM, ""), (WIDE_DIM, "_wide")):
        x = torch.from_numpy(sparse_rows(rng, 512, d)).to(dev)
        params = stored_params(rng, d, NUM_HASHES, dev)
        for name in KERNELS:
            b_i = 4 if name == "cws_encode_packed" else B_I
            case = KernelCase(name, x, b_i, 0, params=params, key=key,
                              k=NUM_HASHES)
            wide = d == WIDE_DIM
            ms = time_ms(lambda: case.run(case.cuda), reps=5 if wide else 50)
            plain_ms = time_ms(lambda: case.run(case.plain),
                               reps=1 if wide else 10, warmup=1)
            bound, by = case.bound_ms()
            r = results[name]
            r["ms" + tag], r["plain_ms" + tag] = ms, plain_ms
            r["bound_ms" + tag], r["bound_by" + tag] = bound, by
            print(f"time {name} (512, {d}, {NUM_HASHES}) b={b_i}: kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} "
                  f"ms ({by}); library call: none (no PyTorch op computes "
                  f"the CWS encode)")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from repro_torch.kernels.build import cws_encode_library

    dev = torch.device(DEVICE)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"device: {name} (count {torch.cuda.device_count()}); "
          f"nvidia-smi: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    built = cws_encode_library()
    print(f"build: {built.path.name} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {built.seconds:.2f} s)")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print("  " + line.strip())

    results = {k: {"checked": 0, "mismatches": 0, "max_abs_err": 0,
                   "launches": 0} for k in KERNELS}
    phase_parity(dev, results)
    phase_slice(smi, results)
    phase_times(dev, results)

    kernels = []
    for k, (replaces, _, _) in KERNELS.items():
        r = results[k]
        kernels.append({"name": k, "route": "cuda", "source": SOURCE,
                        "replaces": replaces, "launches": r["launches"],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None,
                        "ms_wide": r["ms_wide"],
                        "plain_ms_wide": r["plain_ms_wide"],
                        "bound_ms_wide": r["bound_ms_wide"],
                        "bound_by_wide": r["bound_by_wide"],
                        "shapes_checked": r["checked"],
                        "mismatches": r["mismatches"],
                        "slice": r["slice"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
