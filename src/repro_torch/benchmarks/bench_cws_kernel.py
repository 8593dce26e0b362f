"""CWS hashing and min-max Gram throughput on the port's kernels (twin of
``benchmarks/bench_cws_kernel.py``).

Three records, on the reference's own rows (``rand_nonneg`` on its keys)
and parameters (``make_cws_params_jax``), b_i = 8, b_t = 0:

  * ``BENCH_cws_fused``: the fused featurization (``pipe.features``, TPU
    row 2, ``cws_encode``) against its staged composition (``hashes``,
    row 5, then ``features_from_hashes``); the two must be equal, as the
    reference asserts.  Where the reference timed its Pallas kernel in
    interpret mode, the plain version's time at (64, 128, 64);
  * ``BENCH_cws_regen``: stored against regenerated parameters (rows 2
    and 1) with the input bytes modelled on the port's plans
    (``split_plan``: x read once per 32-hash tile, stored r / log c / beta
    once per row tile, no parameter bytes regenerated); row 1 must equal
    its plain version bit for bit at (64, 128, 64);
  * ``BENCH_cws_kernel``: the raw hashes (rows 5 and 6) and the min-max
    Gram (row 7) at the reference's ``run()`` shapes, with the Gram's
    rate.

Grids: ``--fast`` (256, 128, 128), else (512, 256, 256), (1,024, 512,
512), (2,048, 512, 1,024); ``run()``'s (256, 256, 256) at ``--fast``,
else (1,024, 512, 512).  Times are wall microseconds with the device
drained (``timed``: one untimed call, then ``REPEATS``), on the device
the record's ``device`` names; plans are those of that card, or of an
H100's 132 SMs on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.benchmarks.common import (check, emit, meta, rand_nonneg,
                                           save_json, timed)
from repro_torch.core import CWSParams, make_cws_params_jax
from repro_torch.core.regen import prng_key
from repro_torch.device import resolve_device, sm_count
from repro_torch.kernels import cws_hash, ops
from repro_torch.pipeline import FeaturePipeline, FeatureSpec

RECORDS = ("BENCH_cws_fused", "BENCH_cws_regen", "BENCH_cws_kernel")
B_I, B_T = 8, 0
REPEATS = 3
SMALL = (64, 128, 64)
H100_SMS = 132      # the plans recorded by a CPU run


def grid(fast: bool):
    return [(256, 128, 128)] if fast else [(512, 256, 256),
                                           (1024, 512, 512),
                                           (2048, 512, 1024)]


def run_shape(fast: bool):
    return (256, 256, 256) if fast else (1024, 512, 512)


def gram_rows(fast: bool) -> int:
    return 256 if fast else 512


def stored_params(key, d: int, k: int, dev) -> CWSParams:
    p = make_cws_params_jax(key, d, k)
    return CWSParams(*(m.to(dev) for m in (p.r, p.log_c, p.beta)))


def _sms(dev: torch.device) -> int:
    return sm_count(dev.index) if dev.type == "cuda" else H100_SMS


def _key(n, d, k) -> str:
    return f"n{n}_d{d}_k{k}"


def bench_fused_vs_staged(fast: bool, dev: torch.device) -> dict:
    """Fused (one launch -> final indices) against staged (raw hashes ->
    encode -> offsets) featurization on the grid."""
    rec = {"b_i": B_I, "b_t": B_T, "grid": {}}
    for (n, d, k) in grid(fast):
        x = rand_nonneg(prng_key(n + k), (n, d), device=dev)
        pipe = FeaturePipeline(stored_params(prng_key(7), d, k, dev),
                               FeatureSpec(k, b_i=B_I, b_t=B_T))

        def staged():
            i_s, t_s = pipe.hashes(x)
            return pipe.features_from_hashes(i_s, t_s)

        out_f, us_fused = timed(dev, pipe.features, x, repeats=REPEATS)
        out_s, us_staged = timed(dev, staged, repeats=REPEATS)
        rec["grid"][_key(n, d, k)] = {
            "fused_us": us_fused, "staged_us": us_staged,
            "speedup": us_staged / max(us_fused, 1e-9),
            "fused_equals_staged": bool(torch.equal(out_f, out_s))}
        emit(f"cws_fused/{_key(n, d, k)}", us_fused,
             f"staged={us_staged:.0f}us "
             f"x{us_staged / max(us_fused, 1e-9):.2f}")

    # the plain version's cost at the reference's interpret-mode shape
    n, d, k = SMALL
    x = rand_nonneg(prng_key(3), (n, d), device=dev)
    p = stored_params(prng_key(4), d, k, dev)
    _, us = timed(dev, cws_hash.cws_encode_plain, x, p, b_i=B_I)
    emit("cws_fused/plain(64x128x64)", us, "the plain version")
    rec["plain_us_64x128x64"] = us
    return rec


def tile_traffic(plan: cws_hash.SplitPlan, *, stored: bool) -> dict:
    """Modelled input bytes of one launch on ``plan``: x once per hash
    tile, stored r / log c / beta once per row tile (none regenerated)."""
    hash_tiles, row_tiles, _ = plan.grid
    x_bytes = hash_tiles * 4 * plan.n * plan.d
    param_bytes = row_tiles * 12 * plan.d * plan.k if stored else 0
    return {"x_bytes": x_bytes, "param_bytes": param_bytes,
            "total_in_bytes": x_bytes + param_bytes}


def plan_fields(plan: cws_hash.SplitPlan, sms: int) -> dict:
    return {"rows_per_thread": plan.rows_per_thread,
            "row_warps": plan.row_warps, "splits": plan.splits,
            "grid": list(plan.grid), "sms": sms}


def bench_stored_vs_regen(fast: bool, dev: torch.device) -> dict:
    """Stored against regenerated parameters: wall time and modelled
    input bytes on the plans each launch takes; then row 1 against its
    plain version at (64, 128, 64)."""
    sms = _sms(dev)
    rec = {"b_i": B_I, "b_t": B_T, "grid": {}}
    for (n, d, k) in grid(fast):
        x = rand_nonneg(prng_key(n + k), (n, d), device=dev)
        key = prng_key(11)
        spec = FeatureSpec(k, b_i=B_I, b_t=B_T)
        stored = FeaturePipeline(stored_params(key, d, k, dev), spec)
        regen = FeaturePipeline.create_regen(key, d, spec, device=dev)
        _, us_stored = timed(dev, stored.features, x, repeats=REPEATS)
        _, us_regen = timed(dev, regen.features, x, repeats=REPEATS)
        sp = cws_hash.split_plan(n, d, k, sms, stored=True, op="cws_encode")
        rp = cws_hash.split_plan(n, d, k, sms, op="cws_encode_rng")
        entry = {
            "stored": {"wall_us": us_stored, "plan": plan_fields(sp, sms),
                       **tile_traffic(sp, stored=True)},
            "regen": {"wall_us": us_regen, "plan": plan_fields(rp, sms),
                      **tile_traffic(rp, stored=False)},
        }
        entry["input_traffic_ratio"] = (entry["stored"]["total_in_bytes"]
                                        / entry["regen"]["total_in_bytes"])
        rec["grid"][_key(n, d, k)] = entry
        emit(f"cws_regen/{_key(n, d, k)}", us_regen,
             f"stored={us_stored:.0f}us param_bytes 0 vs "
             f"{entry['stored']['param_bytes']} "
             f"(in-traffic x{entry['input_traffic_ratio']:.3f})")

    n, d, k = SMALL
    x = rand_nonneg(prng_key(3), (n, d), device=dev)
    key = prng_key(12)
    want, us = timed(dev, cws_hash.cws_encode_rng_plain, x, key, k, b_i=B_I)
    got = ops.cws_encode_rng(x, key, k, b_i=B_I)
    rec["regen_bit_exact"] = bool(torch.equal(got, want))
    rec["plain_us_64x128x64"] = us
    emit("cws_regen/plain(64x128x64)", us,
         f"the plain version; row 1 bit-exact: {rec['regen_bit_exact']}")
    return rec


def run(fast: bool = False, *, device=None, out=None) -> dict:
    dev = resolve_device(device)
    n, d, k = run_shape(fast)
    x = rand_nonneg(prng_key(0), (n, d), device=dev)
    params = stored_params(prng_key(1), d, k, dev)
    kern = {"shape": [n, d, k]}
    _, kern["cws_hash_us"] = timed(dev, ops.cws_hash, x, params,
                                   repeats=REPEATS)
    emit("cws/cws_hash", kern["cws_hash_us"], "stored parameters")
    _, kern["cws_hash_rng_us"] = timed(dev, ops.cws_hash_rng, x,
                                       prng_key(2), k, repeats=REPEATS)
    emit("cws/cws_hash_rng", kern["cws_hash_rng_us"],
         "0 bytes of stored r/c/beta")
    xs = rand_nonneg(prng_key(3), SMALL[:2], device=dev)
    ps = stored_params(prng_key(4), SMALL[1], SMALL[2], dev)
    _, kern["plain_cws_hash_us_64x128x64"] = timed(dev, cws_hash.
                                                   cws_hash_plain, xs, ps)

    fused = bench_fused_vs_staged(fast, dev)
    regen = bench_stored_vs_regen(fast, dev)

    # the min-max Gram on the min-sum kernel
    m = gram_rows(fast)
    y = rand_nonneg(prng_key(5), (m, d), device=dev)
    _, us = timed(dev, ops.minmax_gram, x, y, repeats=REPEATS)
    flops = 2 * m * n * d
    kern["minmax_gram"] = {"x_rows": n, "y_rows": m, "d": d, "us": us,
                           "gflop_per_s": flops / us / 1e3}
    emit("minmax_gram/min_sum", us, f"{flops / us / 1e3:.2f} GFLOP/s")

    records = {"BENCH_cws_fused": fused, "BENCH_cws_regen": regen,
               "BENCH_cws_kernel": kern}
    for name, rec in records.items():
        rec.update(meta(dev, "jax", fast))
        save_json(name, rec, out)
    return records


def claims(records: dict) -> dict:
    """The reference's asserts: fused == staged on every grid shape, row 1
    bit-exact against its plain version at (64, 128, 64)."""
    fused = records["BENCH_cws_fused"]["grid"]
    return {"fused == staged": all(e["fused_equals_staged"]
                                   for e in fused.values()),
            "regen kernel == its plain version": bool(
                records["BENCH_cws_regen"]["regen_bit_exact"])}


def check_claims(records: dict) -> dict:
    return check("cws_kernel", claims(records))


def launches(records: dict) -> dict:
    """The kernel launches ``run`` makes, by kernel: ``REPEATS`` + 1 a
    timed call, and row 1 once more at (64, 128, 64)."""
    g = len(records["BENCH_cws_fused"]["grid"])
    t = REPEATS + 1
    return {"cws_hash": t + g * t,            # run(), each staged pass
            "cws_hash_rng": t,
            "cws_encode": 2 * g * t,          # fused, stored
            "cws_encode_rng": g * t + 1,      # regen, the bit-exact check
            "min_sum": t}
