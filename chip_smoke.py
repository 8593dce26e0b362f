#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):

  1. device   - require CUDA; print the card's name and power limit, and
                the lane issue rate the bounds use (SMs x 128 lanes x the
                maximum SM clock, read from the card);
  2. build    - nvcc-build the CWS kernels' two bodies (pair and split),
                the min-sum Gram kernel and the flash-attention kernels'
                two bodies (SIMT and wgmma) from ``src/repro_torch/csrc``,
                one nvcc per source, started together, and print the
                compiler's per-kernel registers, shared memory and spills;
                then count the two CWS bodies' SASS instructions
                (``cuobjdump -xelf`` + ``nvdisasm -gi`` on the built
                libraries): per nonzero (row, d, hash) step and per
                regenerated (d, hash), the design floors of the times
                phase ("not measured" where the disassembly fails);
  3. parity   - each of the six CWS kernels against its plain PyTorch
                version on the card, exactly (integer outputs): the four
                encodes at the serving shapes, at ragged shapes with
                all-zero rows for b_t in {0, 2} and packed b in
                {1, 2, 4, 8}, and in one wide launch at D = 65,536; the
                raw (i*, t*) hashes at the serving shapes, ragged with
                all-zero rows, the estimator's (2, 2000, 1024), a row
                pushing t* to the +-2^30 clip, and 512 x 65,536 x 1024;
                rows 6 and 3 (on the split body) also at n in {2, 3, 17},
                D = 1,000, k = 1,000, D = 65,536 at two rows, 1,024 rows
                and D too short to split further, each with an all-zero
                row, asserting that the plans covered S in {1, 2, 4, 8},
                and on the pair body at 512 x 256 x 1024;
                the min-sum kernel (``min_sum``, ``minmax_gram``) at
                ragged, block-edge, suite and long-D shapes within the
                bound its fp32 sums allow; the flash-attention kernel in
                fp32 and bf16 over 64 shapes each (the reference test's
                cases, D in 64/128/256, H/G in 1/2/9/48, ragged S, windows,
                q_base with Sq < Sk, gemma3's (4, 2048), nemotron's 96/8
                heads at D = 192, the sequence-parallel all-gather route's
                q rows against 2,048 keys) within its stated tolerance, bf16
                at D in 64/128/192/256 on the wgmma body and the rest on
                the SIMT body; the block-resumable flash kernel (row 9) step by
                step against its plain version, each virtual rank's chain
                over K/V shards in the ring's order (ragged shards, windows
                0 and 1,024, gemma3's heads at 8,192 rows a shard), fully
                masked shards handing the carry back unchanged, and each
                finalized chain against the one-shot row-8 kernel;
  4. slice    - the serving path at the paper configuration's full width
                (D = 256, k = 1024, 10 classes): four bundles (regen,
                stored, regen+packed b = 8, stored+packed b = 4), each
                booted with ``ServingService.from_bundle(device="cuda")``
                and sent ~200 synthetic requests through its gateway.  The
                launch counters are zeroed just before and read just after;
                the features of every served batch are held exactly, and
                served logits within a tolerance, against offline
                ``pipe.features(x)`` and ``bag_logits`` of them; by body,
                every row-3 launch (regen+packed) ran on the split body
                and every other encode on the pair body;
  5. kernel machine - Table 1 on the "template" suite at full size (1,200
                train / 800 test rows, D = 256, 6 classes): the four
                Grams through ``GRAM_FNS`` and ``best_accuracy_over_C``
                over C in 0.01 ... 1000 with 20 sweeps, then the staged
                hash pass of Figs 7-8 (stored parameters, k = 1024) whose
                full-scheme collision estimates are held against the
                min-max Gram; min-max accuracy must reach linear's and
                agree with the plain path on the CPU within 0.5 pp;
  6. estimator - Figs 4-5 at 2^16-document word pairs (HONG-KONG,
                CREDIT-CARD): K from the min-sum kernel, 300 Monte-Carlo
                reps of ``pipe.with_key(key).hashes(x)`` at k = 1024, and
                the full / 0-bit / 1-bit bias and MSE at k in
                {1, 4, ..., 1024} with the benchmark's own assertions; K at
                4,096 documents against the JAX package's stored values;
                all 600 row-6 launches on the split body; the phase's wall
                time beside its launches' device time (600 x kernel ms at
                each pair's shape);
  7. lm       - gemma3_12b at full width and depth, attn_impl "flash":
                the fp32 prefill + decode logits against one cached forward
                (prompt 600, 4 steps); then the masters cast once to bf16
                and the main path, ``serve_lm`` (4 x 2,048-token prompts,
                flash prefill, 16 greedy decode steps), which must launch
                the flash kernel once per attention layer (48), all on the
                wgmma body (the fp32 check all on the SIMT body); the same
                prefill through the plain attention, within a stated
                tolerance; the CWS head on the pooled hidden state
                (``cws_encode``), its codes equal to the CPU path's;
  8. seq-parallel - gemma3_12b at full width cut to 6 layers, its
                sequence sharded over four ranks of the ``model`` axis
                (``torch.multiprocessing``; on one card the ranks share it
                over gloo, CUDA tensors through host copies, since NCCL
                takes one rank a card): the ring run (1 x 32,768 tokens,
                every layer on the ring: 24 row-9 launches a rank, no row
                8) and the all-gather run (1 x 2,048: 6 row-8 launches a
                rank, no row 9), fp32 (SIMT body) then bf16 (wgmma body),
                the gathered hidden states
                and each rank's last-position logits against the one-device
                forward on the same weights; the transport, host bytes and
                each rank's peak memory.  With four cards, once more over
                NCCL, one rank a card, at full depth;
  9. times    - each kernel and its plain version timed with CUDA events
                (rows 8 and 9: the wgmma and the SIMT body on the same
                inputs, in turns, the wgmma body required to be faster;
                rows 6 and 3: the split and the pair body on the same
                inputs, in turns, each beside its design floor from the
                SASS counts, at (512, 256, 1024), (512, 65,536, 1024) and,
                for row 6, the estimator's (2, 2,000, 1,024)),
                beside the least time the card could take for the same
                work and a PyTorch call as yardstick where one exists
                (``torch.cdist(p=1)`` for the Gram,
                ``scaled_dot_product_attention`` for flash attention, at
                the slice's global and local layers and at S = 32,768, and
                for row 9 on one ring step's q rows and K/V shard).

Phases 4-8 are the main paths: each zeroes the launch counters just
before it and reads them just after, and fails if a kernel it runs was
never launched (phase 8 in every rank, and in sum).  The line before the
last is ``nvidia-smi``'s name and power limit, the one before it a JSON
summary of every kernel; the last line is ``{"ok": true, "device":
{...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import math
import pathlib
import re
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

# Table 1 (benchmarks/table1_kernel_svm.py) and Figs 4-5
# (benchmarks/fig45_cws_mse.py) as the reference's benchmarks run them.
TABLE1_KERNELS = ("linear", "min-max", "n-min-max", "intersection")
C_GRID = (0.01, 0.1, 1.0, 10.0, 100.0, 1000.0)
SWEEPS = 20
EST_ROWS = 64             # test rows whose hashed estimates are checked
PAIRS = ("HONG-KONG", "CREDIT-CARD")
N_DOCS, SUPPORT_CAP, REPS = 2 ** 16, 2000, 300
KS = (1, 4, 16, 64, 256, 1024)
FIG45_JSON = ROOT / "benchmarks" / "results" / "fig45_cws_mse.json"
GRAM_TIMING = ((1200, 1200, 256), (12000, 12000, 784))

# Published H100 SXM memory rate (NVIDIA data sheet).  Operations are
# counted at the lane issue rate read from the card (``lane_rate``): one
# fp32, integer, compare or transcendental step per lane per cycle, and
# only the work the function needs, so no kernel can take less time.
PEAK_BYTES_S = 3.35e12
LANES_PER_SM = 128
THREEFRY_OPS = 117        # 20 rounds of add/rotate/xor + key injections
U32 = 2.0 ** -24          # fp32 unit roundoff
QUEUE_AHEAD_CYCLES = 20_000_000   # ~10 ms of sleep ahead of a timing

KERNELS = {
    # name: (replaces, regen, emit)
    "cws_encode_rng": ("src/repro/kernels/cws_hash.py:431", True, "index"),
    "cws_encode": ("src/repro/kernels/cws_hash.py:246", False, "index"),
    "cws_encode_rng_packed": ("src/repro/kernels/cws_hash.py:534", True,
                              "packed"),
    "cws_encode_packed": ("src/repro/kernels/cws_hash.py:488", False,
                          "packed"),
    "cws_hash": ("src/repro/kernels/cws_hash.py:213", False, "raw"),
    "cws_hash_rng": ("src/repro/kernels/cws_hash.py:395", True, "raw"),
}
ENCODES = [k for k, v in KERNELS.items() if v[2] != "raw"]
RAW = [k for k, v in KERNELS.items() if v[2] == "raw"]
SOURCE = "src/repro_torch/csrc/cws_encode.cu"
# rows 6 and 3 run on the split body; the pair body is their yardstick
CWS_SOURCES = {"split": "src/repro_torch/csrc/cws_regen_split.cu",
               "pair": SOURCE}
PAIR_ROWS = 16            # rows a pair-body block holds (cws_encode.cu:BN)
# Parity shapes (n, D, k) the split body adds: n in {2, 3, 17}, a D that
# no S x 64 divides (1,000 at S = 8), k = 1,000 (not a multiple of the
# 32-hash tile), D = 65,536 at two rows, 1,024 rows (S = 1 on 132 SMs),
# and D too short to split further (S = 1, 2, 4 on any card)
SPLIT_PARITY = ((2, DIM, NUM_HASHES), (3, DIM, NUM_HASHES),
                (17, DIM, NUM_HASHES), (2, 1000, NUM_HASHES),
                (8, DIM, 1000), (2, WIDE_DIM, NUM_HASHES),
                (1024, DIM, NUM_HASHES), (3, 100, 70), (2, 200, 70),
                (2, 300, 70))
# SASS regions (the [sass: ...] marks in the CWS sources): an instruction
# counts for a region when its source line, or a line its code was inlined
# at, lies inside the marks
SASS_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+([^;]*?)\s*;")
SASS_LOC = re.compile(r'(?:File|inlined at) "([^"]+)", line (\d+)')
SASS_FUNC = re.compile(r"^\.text\.(\S+):$")
SASS_MARK = re.compile(r"//\s*\[sass:\s*(/?)(\w+)\]")
SASS_ARGS = re.compile(r"kernelIL[ib](\d+)EL[ib](\d+)EL[ib](\d+)EE")
ROTATES_PER_REGEN = 60    # three threefry-2x32 of 20 rotations each
GRAM = ("min_sum", "src/repro/kernels/minmax_gram.py:66",
        "src/repro_torch/csrc/minmax_gram.cu")
# rows 8 and 9: (name, replaces, the bf16 body's source); both bodies'
# sources, by body
FLASH = ("flash_attention_fwd", "src/repro/kernels/flash_attention.py:117",
         "src/repro_torch/csrc/flash_attention_wgmma.cu")
STEP = ("flash_attention_step", "src/repro/kernels/flash_attention.py:218",
        "src/repro_torch/csrc/flash_attention_wgmma.cu")
FLASH_SOURCES = {"wgmma": "src/repro_torch/csrc/flash_attention_wgmma.cu",
                 "simt": "src/repro_torch/csrc/flash_attention.cu"}

# The LM slice: gemma3_12b (src/repro/configs/gemma3_12b.py:CONFIG) at full
# width and depth with attn_impl="flash", served as ``serve_lm`` serves it:
# 4 prompts of 2,048 tokens (above attn_chunk = 512, so prefill routes to
# the flash kernel, and above the 1,024 window, so the local caches fill by
# the roll), then 16 greedy decode steps.  Weights from LM_SEED.
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN, LM_SEED = "gemma3_12b", 4, 2048, 17, 2026
FP32_BATCH, FP32_PROMPT, FP32_STEPS = 2, 600, 4
CWS_CLASSES = 10
# (batch, sequence, window) of the flash timings at gemma3's heads: the
# slice's global and local layers, and prefill_32k's sequence length
FLASH_TIMING = ((4, 2048, 0), (4, 2048, 1024), (1, 32768, 0),
                (1, 32768, 1024))
# The sequence-parallel slice: gemma3_12b at full width, depth cut from 48
# to 6 layers (one 5 local : 1 global period: four replicated copies of 48
# layers do not fit one card), its sequence sharded over SP_RANKS ranks of
# the ``model`` axis.  The ring run takes prefill_32k's 32,768 tokens (batch
# cut from 32 to 1), so every layer's global K/V is at least RING_MIN_SK and
# routes to the ring; the all-gather run takes 2,048 tokens, below it.
# Weights from SP_SEED, drawn on every rank from the same seed.
SP_LAYERS, SP_RANKS, SP_BATCH, SP_SEED = 6, 4, 1, 2027
SP_RING_PROMPT, SP_AG_PROMPT = 32768, 2048
SP_FULL_DEPTH = 48
# Row 9's parity cases: (b, n virtual ranks, S per rank, H, G, D, window),
# chained over the shards in each virtual rank's ring order: ragged shards
# (100 and 1,000 rows, not multiples of the 64-key tile), windows 0 and
# 1,024, and gemma3's heads at prefill_32k's S per rank
STEP_PARITY = ((2, 4, 100, 4, 2, 64, 0), (2, 4, 100, 4, 2, 64, 48),
               (1, 4, 1000, 8, 4, 128, 0), (1, 4, 1000, 8, 4, 128, 1024),
               (1, 4, 8192, 16, 8, 256, 0), (1, 4, 8192, 16, 8, 256, 1024))
# row 9 timed at one ring step's shapes, (B, S a rank, H, G, D) in bf16:
# q rows of rank 1 against the K/V shard of (label, shard, window): its own
# (diagonal), rank 0's (earlier, fully visible), its own under the window
STEP_TIMING_SHAPE = (1, 8192, 16, 8, 256)
STEP_TIMING = (("diagonal", 1, 0), ("earlier", 0, 0), ("window", 1, 1024))
TENSOR_FLOPS_PER_SM_CLK = 4096    # dense bf16 tensor-core flops per SM clock
FMA_FLOPS_PER_SM_CLK = 2 * LANES_PER_SM

# Tolerances.  Flash kernel vs its plain version: both sum in fp32 (the
# scores over D <= 256 products, the softmax and p . v over up to 32k
# keys), in other orders, on N(0, 1) inputs whose outputs are O(1): fp32
# |dout| <= FLASH_TOL (1 + |out|).  bf16: the same fp32 results round once
# to bf16, so two results a few 1e-7 apart may land one output ulp apart,
# at most 2^-7 relative: |dout| <= FLASH_TOL + 2^-7 |out|.
FLASH_TOL = 2e-5
BF16_ULP = 2.0 ** -7
# The LM prefill with the kernel vs with the plain version, bf16: the
# attention outputs differ by such one-ulp flips, which 48 layers of bf16
# rounding carry on to the logits, so |dlogit| <= 0.1 max |logit| (a wrong
# mask or a skipped tile moves them by the order of max |logit|).  fp32
# prefill + decode vs one forward over the whole sequence: only sums in
# other orders, which the CPU tests hold to 1e-4 max |logit| through the
# smoke models; 48 layers get twice that: |dlogit| <= 2e-4 max |logit|.
LM_BF16_TOL = 0.1
LM_FP32_TOL = 2e-4
# The sequence-parallel forward vs the one-device forward on the same
# weights: the ring folds K/V shard by shard and the GEMMs run at another
# M, so only the order of the fp32 sums differs: the hidden states and
# last-position logits within LM_FP32_TOL of their max.  In bf16 the
# attention outputs flip by an ulp and the GEMMs round at other places,
# which 6 layers carry on: LM_BF16_TOL of the max, and equal argmax ids.


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


def nvidia_smi(query: str = "name,power.limit", units=True) -> str:
    fmt = "--format=csv,noheader" + ("" if units else ",nounits")
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", fmt],
                         capture_output=True, text=True, check=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0]


def lane_rate():
    """(operations/s, SMs, MHz): one operation per lane per cycle, on
    every SM, at the card's maximum SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm", units=False))
    return sms * LANES_PER_SM * mhz * 1e6, sms, mhz


def bound(nbytes, ops, peak_ops):
    """(least ms, what bounds it) for ``nbytes`` moved and ``ops`` done."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


class KernelCase:
    """One CWS kernel's CUDA launcher and plain version on fixed inputs."""

    def __init__(self, name, x, b_i=0, b_t=0, params=None, key=None,
                 k=None):
        from repro_torch.kernels import cws_hash as K
        self.name, self.x, self.b_i, self.b_t = name, x, b_i, b_t
        _, self.regen, self.emit = KERNELS[name]
        state = (key, k) if self.regen else (params,)
        self.args = (x,) + state
        self.cuda = getattr(K, name + "_cuda")
        self.plain = getattr(K, name + "_plain")
        self.k = k if self.regen else params.num_hashes

    def run(self, fn, **body):
        """``fn`` on the case's inputs; ``body`` (``body="pair"``) picks
        the device body of rows 6 and 3."""
        if self.emit == "raw":        # (i*, t*) stacked: (2, n, k)
            return torch.stack(fn(*self.args, **body))
        out = fn(*self.args, b_i=self.b_i, b_t=self.b_t, **body)
        return out.view(torch.int32) if self.emit == "packed" else out

    def compare(self, **body):
        """([mismatches per output], max |difference|): one output, or
        i* and t* for the raw hashes."""
        got, want = self.run(self.cuda, **body), self.run(self.plain)
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise AssertionError(f"{self.name}: shape {tuple(got.shape)} "
                                 f"!= plain {tuple(want.shape)}")
        if self.emit == "packed":   # packed words compare as the same bits
            diff = got.to(torch.int64) & 0xFFFFFFFF
            diff = (diff - (want.to(torch.int64) & 0xFFFFFFFF)).abs()
        else:
            diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
        parts = diff if self.emit == "raw" else diff[None]
        bad = [int((p != 0).sum()) for p in parts]
        return bad, int(diff.max()) if diff.numel() else 0

    def bound_ms(self, peak_ops):
        n, d = self.x.shape
        k = self.k
        if self.emit == "packed":
            out_bytes = n * math.ceil(k * (self.b_i + self.b_t) / 32) * 4
        else:
            out_bytes = (8 if self.emit == "raw" else 4) * n * k
        nbytes = 4 * n * d + out_bytes + (0 if self.regen else 12 * d * k)
        # one IEEE division + ~8 fp32 operations per (row, d, hash) with
        # x > 0 (zero entries skip the update)
        ops = int((self.x > 0).sum()) * k * 9
        if self.regen:   # 3 threefry + 4 log1p + 1 log per (d, hash)
            ops += d * k * (3 * THREEFRY_OPS + 5)
        return bound(nbytes, ops, peak_ops)

    def floor_ms(self, peak_ops, counts, body):
        """A body's design floor: its SASS instructions for this run's
        work at one instruction per lane per cycle: a fast-path step per
        nonzero (row, d, hash), a regeneration per (d, hash) per row tile
        it regenerates in (zero entries, log x staging and the emit not
        counted); None without counts."""
        from repro_torch.kernels.cws_hash import sm_count, split_plan
        n, d = self.x.shape
        emit = 2 if self.emit == "raw" else 1
        track_t = self.emit == "raw" or self.b_t > 0
        if body == "split":
            plan = split_plan(n, d, self.k, sm_count(0))
            c = sass_lookup(counts, body, emit, track_t,
                            plan.rows_per_thread)
            tiles = plan.grid[1]
        else:
            c = sass_lookup(counts, body, emit, track_t)
            tiles = -(-n // PAIR_ROWS)
        if c is None or c["regen"] is None:
            return None
        ops = (int((self.x > 0).sum()) * self.k * c["step"]
               + d * self.k * tiles * c["regen"])
        return ops / peak_ops * 1e3


def sass_regions(source):
    """{region: [(first, last) line]} of the ``[sass: name]`` ...
    ``[sass: /name]`` marks in ``source``."""
    spans, opened = {}, {}
    for no, line in enumerate((ROOT / source).read_text().splitlines(), 1):
        m = SASS_MARK.search(line)
        if m and m.group(1):
            spans.setdefault(m.group(2), []).append((opened.pop(m.group(2)),
                                                     no))
        elif m:
            opened[m.group(2)] = no
    return spans


def disassemble(lib_path):
    """SASS of a built library with line and inlining info: ``cuobjdump
    -xelf`` takes out its cubin, ``nvdisasm -gi`` disassembles it (the
    CWS libraries build with ``-lineinfo``)."""
    tool = lambda name: shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    work = ROOT / "build" / "sass" / lib_path.stem
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    subprocess.run([tool("cuobjdump"), "-xelf", "all", str(lib_path)],
                   cwd=work, check=True, capture_output=True, timeout=120)
    cubins = sorted(work.glob("*.cubin"))
    if not cubins:
        raise RuntimeError(f"no cubin in {lib_path.name}")
    out = subprocess.run([tool("nvdisasm"), "-gi", "-c", str(cubins[0])],
                         check=True, capture_output=True, text=True,
                         timeout=300)
    return out.stdout


def sass_counts(body, lib_path):
    """Per kernel instantiation of a CWS body: its template arguments and,
    from its SASS, the instructions of one nonzero (row, d, hash) step on
    the division's fast path (the ``inner`` region over its MUFU.RCP count,
    less the slow-path call sequence the fast path branches over; for the
    split body plus its share of the per-column loads and loop, the
    ``column`` region outside ``inner`` over the rows a thread holds) and
    of one regenerated (d, hash) (the ``regen`` region over its rotations
    / 60)."""
    source = CWS_SOURCES[body]
    spans = sass_regions(source)
    name = pathlib.Path(source).name
    kernels, func, locs, fresh = {}, None, set(), True
    for line in disassemble(lib_path).splitlines():
        m = SASS_FUNC.match(line.strip())
        if m:
            func, locs = m.group(1), set()
            kernels[func] = {r: {"n": 0, "rcp": 0, "rot": 0, "slow": 0,
                                 "in_slow": False, "fchk": False}
                             for r in spans}
            continue
        if "//##" in line:
            if fresh:
                locs, fresh = set(), False
            locs |= {int(no) for f, no in SASS_LOC.findall(line)
                     if f.endswith(name)}
            continue
        m = SASS_INSN.search(line)
        if not (m and func):
            continue
        fresh = True
        words = m.group(1).split()
        op = words[1] if words[0].startswith("@") and len(words) > 1 \
            else words[0]
        for region, lines in spans.items():
            if not any(lo < no < hi for no in locs for lo, hi in lines):
                continue
            c = kernels[func][region]
            c["n"] += 1
            c["rcp"] += op.startswith("MUFU.RCP")
            c["rot"] += op.startswith("SHF.L.W")
            if op.startswith("FCHK"):
                c["fchk"] = True
            elif c["fchk"] and op.startswith("BRA"):   # fast path jumps on
                c["fchk"], c["in_slow"] = False, True
            elif op.startswith("BSYNC"):
                c["in_slow"] = False
            elif c["in_slow"]:
                c["slow"] += 1
    counts = []
    for func, regions in kernels.items():
        args = SASS_ARGS.search(func)
        inner, regen = regions.get("inner"), regions.get("regen")
        if not args or not inner or not inner["rcp"]:
            continue
        a, emit, track_t = (int(v) for v in args.groups())
        rows = a if body == "split" else 1   # pair: a is the Regen flag
        step = (inner["n"] - inner["slow"]) / inner["rcp"]
        column = regions.get("column")
        if column:   # the loop over columns, unrolled rcp / rows times
            step += (column["n"] - inner["n"]) / (inner["rcp"] / rows) / rows
        entry = {"body": body, "emit": emit, "track_t": bool(track_t),
                 "rows": rows, "regen_mode": body == "split" or bool(a),
                 "step_static": inner["n"] / inner["rcp"], "step": step,
                 "regen": None}
        if regen and regen["rot"]:
            entry["regen"] = regen["n"] / max(
                1, round(regen["rot"] / ROTATES_PER_REGEN))
        counts.append(entry)
    return counts


def sass_lookup(counts, body, emit, track_t, rows=1):
    """The counted instantiation a launch of ``body`` ran, or None."""
    for c in counts or ():
        if (c["body"] == body and c["emit"] == emit and c["regen_mode"]
                and c["track_t"] == track_t and c["rows"] == rows):
            return c
    return None


def time_ms(fn, reps, warmup=2):
    """Mean device ms of ``fn`` over ``reps`` calls, between CUDA events.
    A sleep kernel queued ahead of the start event (~10 ms) lets the host
    enqueue the calls before the card reaches them, so a kernel shorter
    than its call's host cost is timed on the card and not at the host's
    enqueue rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def clip_case(rng, dev):
    """A stored-parameter case whose t* lands on the +-2^30 clip: tiny r
    on two thirds of the hashes, entries of 1e25-1e30 in row 0 and of
    1e-30-1e-25 in row 1 (|log u / r| ~ 6e9), row 2 all zero."""
    from repro_torch.core.cws import CWSParams
    d, k = 40, 96
    r = np.full((d, k), 1e-8, np.float32)
    r[:, ::3] = rng.uniform(0.5, 2.0, (d, k // 3)).astype(np.float32)
    log_c = rng.standard_normal((d, k)).astype(np.float32)
    beta = rng.random((d, k), dtype=np.float32)
    x = np.zeros((3, d), np.float32)
    x[0, ::2] = 10.0 ** rng.uniform(25, 30, d // 2)
    x[1, 1::2] = 10.0 ** -rng.uniform(25, 30, d // 2)
    to = lambda a: torch.from_numpy(a).to(dev)
    return to(x), CWSParams(to(r), to(log_c), to(beta))


def phase_parity(dev, results):
    from repro_torch.kernels.cws_hash import (BODY_LAUNCHES, LAUNCHES,
                                              SPLIT_KERNELS, SPLIT_SIZES,
                                              sm_count, split_plan)
    rng = np.random.default_rng(11)
    key = tuple(int(w) for w in rng.integers(0, 2 ** 32, 2, dtype=np.uint64))

    def check(name, n, d, k, b_i=0, b_t=0, zero_rows=(), x=None,
              params=None, body=None):
        if x is None:
            x = torch.from_numpy(sparse_rows(rng, n, d, zero_rows=zero_rows)
                                 ).to(dev)
        if params is None and not KERNELS[name][1]:
            params = stored_params(rng, d, k, dev)
        case = KernelCase(name, x, b_i, b_t, params=params, key=key, k=k)
        bad, err = case.compare(**({} if body is None else {"body": body}))
        if name in SPLIT_KERNELS and body is None:
            s = split_plan(x.shape[0], x.shape[1], k, sm_count(0)).splits
            results[name]["splits"][s] = results[name]["splits"].get(s, 0) + 1
        r = results[name]
        r["checked"] += 1
        r["mismatches"] += sum(bad)
        if len(bad) == 2:
            r["mismatches_i"] += bad[0]
            r["mismatches_t"] += bad[1]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if sum(bad):
            raise AssertionError(f"{name} (n={n}, D={d}, k={k}, b_i={b_i}, "
                                 f"b_t={b_t}): {bad} outputs differ from "
                                 f"the plain version")
        return case

    ragged = dict(n=37, d=300, k=70, zero_rows=(0, 5, 36))
    for name in ENCODES:
        packed = KERNELS[name][2] == "packed"
        for n in BUCKETS:
            check(name, n, DIM, NUM_HASHES, B_I, 0)
        if packed:
            for b in (1, 2, 4, 8):
                check(name, b_i=b, b_t=0, **ragged)
            for b in (4, 8):
                check(name, b_i=b - 2, b_t=2, **ragged)
        else:
            for b_t in (0, 2):
                check(name, b_i=4, b_t=b_t, **ragged)
        check(name, 512, WIDE_DIM, NUM_HASHES, B_I, 0)
        extra = ""
        if name in SPLIT_KERNELS:
            for n, d, k in SPLIT_PARITY + ((2, SUPPORT_CAP, NUM_HASHES),):
                check(name, n, d, k, B_I, 0, zero_rows=(1,))
            check(name, 512, DIM, NUM_HASHES, B_I, 0, body="pair")
            extra = (f"; split body also at (n, D, k) in {SPLIT_PARITY} and "
                     f"2x{SUPPORT_CAP}x{NUM_HASHES} (row 1 all zero), S "
                     f"used {dict(sorted(results[name]['splits'].items()))}"
                     f"; the pair body at 512x{DIM}x{NUM_HASHES}")
        r = results[name]
        print(f"parity {name}: {r['checked']} shapes (serving n in "
              f"{BUCKETS} at D={DIM} k={NUM_HASHES}; ragged 37x300x70 with "
              f"zero rows; 512x{WIDE_DIM}x{NUM_HASHES}{extra}); mismatches "
              f"{r['mismatches']}; launches {LAUNCHES[name]}")

    x_clip, p_clip = clip_case(rng, dev)
    for name in RAW:
        for n in BUCKETS:
            check(name, n, DIM, NUM_HASHES)
        check(name, **ragged)
        check(name, 2, SUPPORT_CAP, NUM_HASHES)
        if name == "cws_hash":
            case = check(name, 3, x_clip.shape[1], p_clip.num_hashes,
                         x=x_clip, params=p_clip)
            t_star = case.run(case.cuda)[1]
            if not ((t_star[0] == 2 ** 30).any() and
                    (t_star[1] == -2 ** 30).any()):
                raise AssertionError("cws_hash: the clip row never reached "
                                     "t* = +-2^30")
            clip = "t* clipped to +-2^30 in rows 0 and 1"
        else:   # regenerated r cannot be made tiny: extreme entries only
            x = torch.from_numpy(np.array(
                [[3e38, 0.0, 1.2e-38] * 20, [0.0, 1e30, 1e-30] * 20],
                np.float32)).to(dev)
            check(name, 2, 60, 96, x=x)
            clip = "rows of 3e38 and 1.2e-38 entries"
        check(name, 512, WIDE_DIM, NUM_HASHES)
        extra = ""
        if name in SPLIT_KERNELS:
            for n, d, k in SPLIT_PARITY:
                check(name, n, d, k, zero_rows=(1,))
            check(name, 512, DIM, NUM_HASHES, body="pair")
            extra = (f"; split body also at (n, D, k) in {SPLIT_PARITY} "
                     f"(row 1 all zero), S used "
                     f"{dict(sorted(results[name]['splits'].items()))}; the "
                     f"pair body at 512x{DIM}x{NUM_HASHES}")
        r = results[name]
        print(f"parity {name}: {r['checked']} shapes (serving n in "
              f"{BUCKETS} at D={DIM} k={NUM_HASHES}; ragged 37x300x70 with "
              f"zero rows; 2x{SUPPORT_CAP}x{NUM_HASHES}; {clip}; "
              f"512x{WIDE_DIM}x{NUM_HASHES}{extra}); mismatches i* "
              f"{r['mismatches_i']} t* {r['mismatches_t']}; launches "
              f"{LAUNCHES[name]}")
    for name in SPLIT_KERNELS:
        missing = set(SPLIT_SIZES) - set(results[name]["splits"])
        if missing:
            raise AssertionError(f"{name}: the split body's parity cases "
                                 f"never ran S in {sorted(missing)}")
    print(f"parity: launches by CWS body {dict(BODY_LAUNCHES)}")


def gram_rows(rng, n, d, zero_rows=()):
    """Sparse heavy-tailed nonnegative rows, as the suites have."""
    x = sparse_rows(rng, n, d, density=0.4, zero_rows=zero_rows)
    return x * np.exp(rng.standard_normal((n, d))).astype(np.float32)


def gram_worst(x, y):
    """Worst ratio of |cuda - plain| to its bound, for S and for K.  All
    terms are nonnegative and two recursive fp32 sums of D terms in other
    orders differ by at most ~2·D·2^-24·S, so |S_cuda - S_plain| <=
    2·D·2^-24·S_plain + 1e-30; K = S / (sum x + sum y - S) then has a
    relative bound of 4·D·2^-24."""
    from repro_torch.kernels import minmax_gram as G
    d = x.shape[1]
    s_cuda, s_plain = G.min_sum_cuda(x, y), G.min_sum_plain(x, y)
    k_cuda, k_plain = G.minmax_gram_cuda(x, y), G.minmax_gram_plain(x, y)
    torch.cuda.synchronize()
    for got, want in ((s_cuda, s_plain), (k_cuda, k_plain)):
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"min_sum (D={d}): shape "
                                 f"{tuple(got.shape)} or non-finite values")
    ds = (s_cuda.double() - s_plain.double()).abs()
    dk = (k_cuda.double() - k_plain.double()).abs()
    ratio_s = float((ds / (2 * d * U32 * s_plain.double() + 1e-30)).max())
    ratio_k = float((dk / (4 * d * U32 * k_plain.double().abs() + 1e-30)
                     ).max())
    return ratio_s, ratio_k, float(ds.max())


def phase_gram_parity(dev, results):
    from repro_torch.kernels.minmax_gram import LAUNCHES
    rng = np.random.default_rng(12)
    shapes = ([((37, 29, 300), (0, 17), (5,))] +
              [((m, n, d), (), ()) for m in (63, 64, 65)
               for n in (63, 64, 65) for d in (63, 64, 65)] +
              [((800, 1200, 256), (), ()), ((64, 64, WIDE_DIM), (), ())])
    r = results[GRAM[0]]
    worst = (0.0, 0.0)
    for (m, n, d), zx, zy in shapes:
        x = torch.from_numpy(gram_rows(rng, m, d, zx)).to(dev)
        y = torch.from_numpy(gram_rows(rng, n, d, zy)).to(dev)
        ratio_s, ratio_k, err = gram_worst(x, y)
        r["checked"] += 1
        r["max_abs_err"] = max(r["max_abs_err"], err)
        worst = (max(worst[0], ratio_s), max(worst[1], ratio_k))
        if ratio_s > 1 or ratio_k > 1:
            raise AssertionError(f"min_sum ({m}, {n}, {d}): |cuda - plain| "
                                 f"at {ratio_s:.3g} (S) / {ratio_k:.3g} (K) "
                                 f"of the bound")
    r["worst_ratio_S"], r["worst_ratio_K"] = worst
    print(f"parity min_sum / minmax_gram: {r['checked']} shapes (ragged "
          f"37x29x300 with zero rows; 63/64/65 in each dimension; "
          f"800x1200x256; 64x64x{WIDE_DIM}); worst |cuda - plain| / bound "
          f"{worst[0]:.4g} (S, bound 2·D·2^-24·S) and {worst[1]:.4g} (K, "
          f"bound 4·D·2^-24·K); max |dS| {r['max_abs_err']:.4g}; launches "
          f"{LAUNCHES['min_sum']}")


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
    launches, bodies = dict(K.LAUNCHES), dict(K.BODY_LAUNCHES)
    for name in ENCODES:
        results[name]["launches"] = launches[name]
    # by body: every row-3 launch on the split body, the rest on the pair
    split = sum(launches[k] for k in K.SPLIT_KERNELS)
    if bodies != {"split": split, "pair": sum(launches.values()) - split}:
        raise AssertionError(f"slice: launches by body {bodies} for kernel "
                             f"launches {launches}")
    print(f"slice: launches by CWS body {bodies} (split: "
          f"cws_encode_rng_packed; pair: the other encodes)")

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


def reset_all_launches():
    from repro_torch.kernels import cws_hash, flash_attention, minmax_gram
    cws_hash.reset_launches()
    minmax_gram.reset_launches()
    flash_attention.reset_launches()


def read_launches():
    from repro_torch.kernels import cws_hash, flash_attention, minmax_gram
    return {**cws_hash.LAUNCHES, **minmax_gram.LAUNCHES,
            **flash_attention.LAUNCHES}


def require_launched(phase, launches, names):
    for name in names:
        if launches[name] == 0:
            raise AssertionError(f"{phase}: kernel {name} was never "
                                 f"launched on the main path")


def phase_kernel_machine(dev, card, results):
    """Table 1's exact-kernel SVM on the template suite, then the staged
    hash pass of Figs 7-8 on the same rows."""
    from repro_torch.core import (GRAM_FNS, collision_estimate,
                                  full_collision_estimate)
    from repro_torch.core.kernel_svm import best_accuracy_over_C
    from repro_torch.data.synthetic import CLASSIFICATION_SUITES
    from repro_torch.pipeline import FeaturePipeline, FeatureSpec
    ds = CLASSIFICATION_SUITES["template"]()
    xtr, xte = (torch.from_numpy(a).to(dev) for a in (ds.x_train, ds.x_test))
    ytr, yte = (torch.from_numpy(a).to(dev) for a in (ds.y_train, ds.y_test))

    reset_all_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    accs, secs = {}, {}
    for name in TABLE1_KERNELS:
        t1 = time.perf_counter()
        ktr, kte = GRAM_FNS[name](xtr, xtr), GRAM_FNS[name](xte, xtr)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        accs[name], _ = best_accuracy_over_C(
            ktr, kte, ytr, yte, n_classes=ds.n_classes, Cs=C_GRID,
            sweeps=SWEEPS)
        secs[name] = (t2 - t1, time.perf_counter() - t2)
        if name == "min-max":
            k_est = kte[:EST_ROWS]
    pipe = FeaturePipeline.create(
        torch.Generator(device=dev).manual_seed(2015), ds.x_train.shape[1],
        FeatureSpec(NUM_HASHES, b_i=0))
    i_tr, t_tr = pipe.hashes(xtr)
    i_te, t_te = pipe.hashes(xte[:EST_ROWS])
    est_full = full_collision_estimate(i_te[:, None], t_te[:, None],
                                       i_tr[None], t_tr[None])
    est_0bit = collision_estimate(i_te[:, None], i_tr[None])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    require_launched("kernel machine", launches, ("min_sum", "cws_hash"))

    if accs["min-max"] < accs["linear"]:
        raise AssertionError(f"min-max accuracy {accs['min-max']} below "
                             f"linear {accs['linear']}")
    # the same run of the min-max column through the plain path on the CPU
    xtr_c, xte_c = xtr.cpu(), xte.cpu()
    acc_cpu, _ = best_accuracy_over_C(
        GRAM_FNS["min-max"](xtr_c, xtr_c), GRAM_FNS["min-max"](xte_c, xtr_c),
        ytr.cpu(), yte.cpu(), n_classes=ds.n_classes, Cs=C_GRID,
        sweeps=SWEEPS)
    gap_pp = 100 * abs(accs["min-max"] - acc_cpu)
    if gap_pp > 0.5:
        raise AssertionError(f"min-max accuracy {accs['min-max']} on the "
                             f"card vs {acc_cpu} on the CPU plain path")
    # the full scheme's collision rate estimates K_MM without bias, with
    # the binomial spread sqrt(K (1 - K) / k) over 64 x 1,200 pairs
    err = (est_full - k_est).double()
    theory = float((k_est * (1 - k_est) / NUM_HASHES).double().mean().sqrt())
    bias_full, rmse_full = float(err.mean()), float(err.pow(2).mean().sqrt())
    bias_0bit = float((est_0bit - k_est).double().mean())
    if abs(bias_full) > 0.003 or rmse_full > 1.3 * theory:
        raise AssertionError(f"hashed estimate of K_MM: bias {bias_full}, "
                             f"rmse {rmse_full} vs binomial {theory}")
    results["kernel_machine"] = {
        "accuracy": accs, "accuracy_min_max_cpu": acc_cpu, "wall_s": wall,
        "gram_s": {k: v[0] for k, v in secs.items()},
        "dual_cd_s": {k: v[1] for k, v in secs.items()},
        "launches": {k: launches[k] for k in ("min_sum", "cws_hash")},
        "est_bias_full": bias_full, "est_rmse_full": rmse_full,
        "est_rmse_binomial": theory, "est_bias_0bit": bias_0bit}
    for name in ("min_sum", "cws_hash"):
        results[name]["launches"] += launches[name]
    print(f"slice kernel machine [{card}]: template suite "
          f"{tuple(ds.x_train.shape)} train / {tuple(ds.x_test.shape)} test, "
          f"{ds.n_classes} classes; best accuracy over C "
          + ", ".join(f"{k} {100 * v:.2f}%" for k, v in accs.items())
          + f"; min-max on the CPU plain path {100 * acc_cpu:.2f}% "
          f"(gap {gap_pp:.3f} pp); Gram s "
          + ", ".join(f"{k} {v[0]:.4f}" for k, v in secs.items())
          + "; dual CD s (6 C x 6 classes, 20 sweeps x 1,200 coordinates) "
          + ", ".join(f"{k} {v[1]:.3f}" for k, v in secs.items())
          + f"; hashed K_MM (k={NUM_HASHES}, {EST_ROWS}x{xtr.shape[0]} "
          f"pairs) full scheme bias {bias_full:.3g} rmse {rmse_full:.4g} "
          f"(binomial {theory:.4g}), 0-bit bias {bias_0bit:.3g}; phase "
          f"{wall:.3f} s; launches min_sum {launches['min_sum']}, "
          f"cws_hash {launches['cws_hash']}")


def compacted_pair(pair, n_docs):
    """A word pair restricted to its union support, capped at 2,000
    coordinates as ``benchmarks/fig45_cws_mse.py`` does: (2, D) float32."""
    from repro_torch.data.synthetic import word_pair
    u, v = word_pair(pair, n_docs=n_docs)
    support = np.flatnonzero((u > 0) | (v > 0))
    if len(support) > SUPPORT_CAP:
        support = np.random.default_rng(0).choice(support, SUPPORT_CAP,
                                                  replace=False)
    return np.stack([u[support], v[support]])


def pair_k(x, dev):
    """K_MM of the two rows of x through the min-sum kernel."""
    from repro_torch.core.kernels import minmax_gram
    xd = torch.from_numpy(x).to(dev)
    return float(minmax_gram(xd[:1], xd[1:])[0, 0])


def phase_estimator(dev, card, results):
    """Figs 4-5: Monte-Carlo bias and MSE of the full, 0-bit and 1-bit
    estimators of K_MM against K (1 - K) / k."""
    from repro_torch.core import collision_estimate, full_collision_estimate
    from repro_torch.kernels import cws_hash as CWS
    from repro_torch.pipeline import FeaturePipeline, FeatureSpec
    rng = np.random.default_rng(45)
    kmax = max(KS)
    rows = {}
    reset_all_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for pair in PAIRS:
        x = compacted_pair(pair, N_DOCS)
        k_true = pair_k(x, dev)
        xd = torch.from_numpy(x).to(dev)
        keys = rng.integers(0, 2 ** 32, (REPS, 2),
                            dtype=np.uint64).astype(np.uint32)
        pipe = FeaturePipeline.create_regen(keys[0], x.shape[1],
                                            FeatureSpec(kmax, b_i=1),
                                            device=dev)
        i_all = torch.empty((REPS, 2, kmax), dtype=torch.int32, device=dev)
        t_all = torch.empty_like(i_all)
        for r, key in enumerate(keys):
            i_all[r], t_all[r] = pipe.with_key(key).hashes(xd)
        row = {"K": k_true, "D": x.shape[1], "ks": {}}
        for k in KS:
            iu, iv = i_all[:, 0, :k], i_all[:, 1, :k]
            tu, tv = t_all[:, 0, :k], t_all[:, 1, :k]
            ests = {"full": full_collision_estimate(iu, tu, iv, tv),
                    "0bit": collision_estimate(iu, iv),
                    "1bit": full_collision_estimate(iu, tu & 1, iv, tv & 1)}
            d = {"theory": k_true * (1 - k_true) / k}
            for scheme, e in ests.items():
                e = e.double().cpu().numpy()
                d["bias_" + scheme] = float(e.mean() - k_true)
                d["mse_" + scheme] = float(((e - k_true) ** 2).mean())
            row["ks"][k] = d
        rows[pair] = row
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    bodies = dict(CWS.BODY_LAUNCHES)
    require_launched("estimator", launches, ("cws_hash_rng", "min_sum"))
    if launches["cws_hash_rng"] != len(PAIRS) * REPS:
        raise AssertionError(f"estimator: cws_hash_rng launched "
                             f"{launches['cws_hash_rng']} times, not "
                             f"{len(PAIRS)} x {REPS}")
    if bodies != {"split": len(PAIRS) * REPS, "pair": 0}:
        raise AssertionError(f"estimator: launches by CWS body {bodies}, "
                             f"not all {len(PAIRS) * REPS} on the split body")
    # the phase's wall time beside its launches' device time: one launch
    # of each pair's shape timed with CUDA events, times its launches
    device_s = 0.0
    for pair in PAIRS:
        xd = torch.from_numpy(compacted_pair(pair, N_DOCS)).to(dev)
        device_s += REPS * time_ms(lambda: CWS.cws_hash_rng_cuda(
            xd, keys[0], kmax), reps=50) / 1e3
    # the benchmark's own assertions (fig45_cws_mse.py:97-101)
    for pair, row in rows.items():
        for k in (64, 256, 1024):
            d = row["ks"][k]
            if not (d["mse_0bit"] < 3.0 * d["theory"] + 1e-6
                    and abs(d["bias_0bit"]) < 0.03):
                raise AssertionError(f"estimator {pair} k={k}: {d}")
    # K at the fast mode's 4,096 documents against the JAX package's
    # stored values, within the min-max bound 4·D·2^-24
    stored = json.loads(FIG45_JSON.read_text())
    k4096 = {}
    for pair in PAIRS:
        x = compacted_pair(pair, 4096)
        got, want = pair_k(x, dev), stored[pair]["K"]
        k4096[pair] = (got, want)
        if abs(got - want) > 4 * x.shape[1] * U32 * want:
            raise AssertionError(f"estimator {pair}: K at 4,096 documents "
                                 f"{got} vs stored {want}")
    results["estimator"] = {"pairs": rows, "wall_s": wall,
                            "hash_device_s": device_s, "bodies": bodies,
                            "K_4096": k4096, "reps": REPS,
                            "launches": {k: launches[k] for k in
                                         ("cws_hash_rng", "min_sum")}}
    for name in ("cws_hash_rng", "min_sum"):
        results[name]["launches"] += launches[name]
    for pair, row in rows.items():
        big = row["ks"][kmax]
        print(f"slice estimator {pair} [{card}]: D={row['D']} K={row['K']:.8f}"
              f" (K at 4,096 docs {k4096[pair][0]:.8f}, stored "
              f"{k4096[pair][1]:.8f}); k={kmax}: bias full "
              f"{big['bias_full']:+.3g} 0-bit {big['bias_0bit']:+.3g} 1-bit "
              f"{big['bias_1bit']:+.3g}; mse full {big['mse_full']:.4g} 0-bit "
              f"{big['mse_0bit']:.4g} 1-bit {big['mse_1bit']:.4g} theory "
              f"{big['theory']:.4g}; mse_0bit / theory at k in {KS}: "
              + " ".join(f"{d['mse_0bit'] / d['theory']:.3f}"
                         for d in row["ks"].values()))
    print(f"slice estimator: {len(PAIRS)} pairs x {REPS} reps in "
          f"{wall:.3f} s; launches cws_hash_rng {launches['cws_hash_rng']} "
          f"(by body {bodies}), min_sum {launches['min_sum']}; the "
          f"cws_hash_rng launches' device time (launches x kernel ms at each "
          f"pair's shape) {device_s:.4f} s, {100 * device_s / wall:.1f}% of "
          f"the phase: the rest is the host's loop, the estimators and "
          f"their copies")


def flash_inputs(rng, b, sq, sk, h, g, d, dtype, dev):
    """N(0, 1) q (b, sq, h, d), k and v (b, sk, g, d), made with numpy."""
    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            dev, dtype)
    return draw(b, sq, h, d), draw(b, sk, g, d), draw(b, sk, g, d)


def flash_worst(q, k, v, window, q_base):
    """(worst |cuda - plain| / tolerance, max |cuda - plain|)."""
    from repro_torch.kernels import flash_attention as fa
    got = fa.flash_attention_fwd_cuda(q, k, v, window=window, q_base=q_base)
    want = fa.flash_attention_fwd_plain(q, k, v, window=window,
                                        q_base=q_base)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != q.dtype or \
            not torch.isfinite(got).all():
        raise AssertionError(f"flash {tuple(q.shape)}: shape, dtype or "
                             f"non-finite output")
    got, want = got.float(), want.float()
    return out_ratio(got, want, q.dtype), float((got - want).abs().max())


def out_ratio(got, want, dtype):
    """Worst |got - want| / the flash kernels' output tolerance."""
    rel = BF16_ULP if dtype == torch.bfloat16 else FLASH_TOL
    return float(((got - want).abs() / (FLASH_TOL + rel * want.abs())).max())


def phase_flash_parity(dev, results):
    """The flash kernel against its plain version in the working dtype, on
    the body ``flash_body`` picks for each case."""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(8)
    cases = []   # (b, sq, sk, h, g, d, window, q_base)
    # the reference test's CASES (tests/test_flash_attention.py)
    for b, s_, h, g, d, w in ((1, 64, 4, 2, 16, 0), (2, 128, 4, 1, 32, 0),
                              (1, 96, 6, 3, 16, 0), (2, 128, 4, 4, 16, 32),
                              (1, 256, 8, 2, 64, 64), (1, 64, 2, 2, 128, 0)):
        cases.append((b, s_, s_, h, g, d, w, 0))
    # head dims x GQA ratios 1, 2, 9, 48 at ragged lengths, causal and
    # windowed, and a window longer than the sequence
    for d in (64, 128, 256):
        for (h, g), s_ in zip(((4, 4), (4, 2), (18, 2), (48, 1)),
                              (1000, 2047, 1000, 2047)):
            for w in (0, 1024, 4096):
                cases.append((1, s_, s_, h, g, d, w, 0))
    # q rows at a global offset: Sq < Sk
    for d in (64, 256):
        for w in (0, 256):
            cases.append((2, 300, 1000, 8, 2, d, w, 700))
            cases.append((1, 77, 1500, 4, 4, d, w, 1000))
    # the slice's own shapes: gemma3_12b's heads at (4, 2048)
    for w in (0, 1024):
        cases.append((LM_BATCH, LM_PROMPT, LM_PROMPT, 16, 8, 256, w, 0))
    # nemotron's heads (96/8, r = 12) at D = 192, the wgmma body's fourth
    # head dim, at ragged lengths, causal and windowed
    for s_ in (1000, 2047):
        for w in (0, 1024):
            cases.append((1, s_, s_, 96, 8, 192, w, 0))
    # the sequence-parallel all-gather route's own shapes: each rank's
    # S/n q rows at q_base = rank * S/n against the all-gathered K/V
    sl = SP_AG_PROMPT // SP_RANKS
    allgather = {(SP_BATCH, sl, SP_AG_PROMPT, 16, 8, 256, w, rank * sl)
                 for w in (0, 1024) for rank in range(SP_RANKS)}
    cases += sorted(allgather)
    r = results[FLASH[0]]
    worst, ag_worst = {}, {}
    fa.reset_launches()
    for dtype in (torch.float32, torch.bfloat16):
        for b, sq, sk, h, g, d, w, qb in cases:
            q, k, v = flash_inputs(rng, b, sq, sk, h, g, d, dtype, dev)
            ratio, err = flash_worst(q, k, v, w, qb)
            r["checked"] += 1
            r["max_abs_err"] = max(r["max_abs_err"], err)
            key = str(dtype).split(".")[1]
            case = (b, sq, sk, h, g, d, w, qb)
            if ratio > worst.get(key, (-1.0,))[0]:
                worst[key] = (ratio, case, err)
            if case in allgather:
                ag_worst[key] = max(ag_worst.get(key, 0.0), ratio)
            if ratio > 1:
                raise AssertionError(
                    f"flash {key} (b={b}, Sq={sq}, Sk={sk}, H={h}, G={g}, "
                    f"D={d}, window={w}, q_base={qb}): |cuda - plain| at "
                    f"{ratio:.3g} of the tolerance (max {err:.3g})")
    bodies = dict(fa.BODY_LAUNCHES)
    want = {"wgmma": sum(fa.flash_body(torch.bfloat16, c[5]) == "wgmma"
                         for c in cases)}
    want["simt"] = 2 * len(cases) - want["wgmma"]
    if bodies != want:
        raise AssertionError(f"flash parity: cases by body {bodies}, not "
                             f"{want}")
    r["worst"] = {k: {"ratio": v[0], "case": v[1], "max_abs_err": v[2]}
                  for k, v in worst.items()}
    r["allgather_worst"] = ag_worst
    r["parity_bodies"] = bodies
    print(f"parity flash_attention_fwd: {r['checked']} cases (the reference "
          f"test's six; D in 64/128/256 x H/G in 1/2/9/48 at S = 1000/2047, "
          f"window 0/1024/4096; q_base 700/1000 with Sq < Sk; gemma3 "
          f"(4, 2048) 16/8 heads D = 256, window 0/1024; nemotron 96/8 "
          f"heads D = 192 at S = 1000/2047, window 0/1024; the all-gather "
          f"route's ({SP_BATCH}, {SP_AG_PROMPT // SP_RANKS}) q rows at "
          f"q_base = rank * {SP_AG_PROMPT // SP_RANKS} against "
          f"{SP_AG_PROMPT} keys, window 0/1024), fp32 and bf16; "
          + "; ".join(f"worst {k} |cuda - plain| / tolerance {v[0]:.4g} at "
                      f"(b, Sq, Sk, H, G, D, window, q_base) = {v[1]}, max "
                      f"{v[2]:.3g}" for k, v in worst.items())
          + "; worst of the all-gather route's cases: "
          + ", ".join(f"{k} {v:.4g}" for k, v in ag_worst.items())
          + f" (tolerance fp32 {FLASH_TOL:g}(1 + |out|), bf16 {FLASH_TOL:g}"
          f" + 2^-7 |out|); cases by body {bodies} (wgmma: bf16 at D in "
          f"{fa.WGMMA_HEAD_DIMS})")


def carry_ratio(got, want, dtype):
    """Worst |kernel - plain| / tolerance of a carry: m and l within
    FLASH_TOL (1 + |x|) (fp32 in both dtypes), the finalized output within
    row 8's output tolerance.  Returns (ratio, max |output difference|)."""
    from repro_torch.kernels import flash_attention as fa
    ratio = max(float(((g - w).abs() / (FLASH_TOL * (1 + w.abs()))).max())
                for g, w in zip(got[:2], want[:2]))
    go = fa.finalize(got, dtype)[0].float()
    wo = fa.finalize(want, dtype)[0].float()
    return max(ratio, out_ratio(go, wo, dtype)), float((go - wo).abs().max())


def phase_step_parity(dev, results):
    """Row 9 against its plain version, step by step, each virtual rank's
    chain over the K/V shards in the ring's order (shard (me - s) mod n at
    step s), fed the kernel's own carry; then the finalized chain against
    the one-shot row-8 kernel at the same q rows.  A shard wholly outside
    a rank's causal or window range must hand the carry back unchanged."""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(10)
    r = results[STEP[0]]
    worst = {}
    fa.reset_launches()
    want_bodies = {"wgmma": 0, "simt": 0}
    for b, n, sl, h, g, d, w in STEP_PARITY:
        for dtype in (torch.float32, torch.bfloat16):
            # n steps and one one-shot row 8 for each of the n ranks
            want_bodies[fa.flash_body(dtype, d)] += n * (n + 1)
            key = str(dtype).split(".")[1]
            q, k, v = flash_inputs(rng, b, n * sl, n * sl, h, g, d, dtype,
                                   dev)
            for me in range(n):
                ql = q[:, me * sl:(me + 1) * sl]
                carry = None
                for step in range(n):
                    j = (me - step) % n
                    ks, vs = (t[:, j * sl:(j + 1) * sl] for t in (k, v))
                    args = dict(q_base=me * sl, k_base=j * sl, window=w)
                    got = fa.flash_attention_step_cuda(ql, ks, vs, carry,
                                                       **args)
                    want = fa.flash_attention_step_plain(ql, ks, vs, carry,
                                                         **args)
                    torch.cuda.synchronize()
                    masked = j > me or (w > 0 and (j + 1) * sl - 1 <=
                                        me * sl - w)
                    if masked:
                        if not all(torch.equal(a, c)
                                   for a, c in zip(got, carry)):
                            raise AssertionError(
                                f"step: a fully masked shard (rank {me}, "
                                f"shard {j}, {(b, sl, h, g, d, w)}) changed "
                                f"the carry")
                        r["masked"] += 1
                    ratio, err = carry_ratio(got, want, dtype)
                    r["checked"] += 1
                    r["max_abs_err"] = max(r["max_abs_err"], err)
                    case = (b, n, sl, h, g, d, w, me, j)
                    if ratio > worst.get(key, (-1.0,))[0]:
                        worst[key] = (ratio, case, err)
                    if ratio > 1:
                        raise AssertionError(
                            f"step {key} (b, n, S/n, H, G, D, window, "
                            f"rank, shard) = {case}: |cuda - plain| at "
                            f"{ratio:.3g} of the tolerance")
                    carry = got
                out = fa.finalize(carry, dtype)[0].float()
                one = fa.flash_attention_fwd_cuda(
                    ql, k, v, window=w, q_base=me * sl).float()
                ratio = out_ratio(out, one, dtype)
                r["chain_worst"][key] = max(r["chain_worst"].get(key, 0.0),
                                            ratio)
                if ratio > 1:
                    raise AssertionError(
                        f"step {key}: the chain of rank {me} of "
                        f"{(b, n, sl, h, g, d, w)} vs the one-shot kernel at "
                        f"{ratio:.3g} of the tolerance")
            del q, k, v
    torch.cuda.empty_cache()
    bodies = dict(fa.BODY_LAUNCHES)
    if bodies != want_bodies:
        raise AssertionError(f"step parity: launches by body {bodies}, not "
                             f"{want_bodies}")
    r["worst"] = {k: {"ratio": v[0], "case": v[1], "max_abs_err": v[2]}
                  for k, v in worst.items()}
    r["parity_bodies"] = bodies
    print(f"parity flash_attention_step: {r['checked']} steps ({r['masked']} "
          f"on fully masked shards, carry unchanged) over "
          f"(b, n, S/n, H, G, D, window) in {STEP_PARITY}, fp32 and bf16, "
          f"each virtual rank's chain in ring order; "
          + "; ".join(f"worst {k} |cuda - plain| / tolerance {v[0]:.4g} at "
                      f"(b, n, S/n, H, G, D, window, rank, shard) = {v[1]}, "
                      f"max |dout| {v[2]:.3g}" for k, v in worst.items())
          + "; chain vs one-shot row 8: "
          + ", ".join(f"{k} {v:.4g}" for k, v in r["chain_worst"].items())
          + f" of the tolerance (m, l within {FLASH_TOL:g}(1 + |x|), out "
          f"fp32 {FLASH_TOL:g}(1 + |out|), bf16 {FLASH_TOL:g} + 2^-7 |out|);"
          f" launches by body {bodies} (fp32 on the SIMT body, bf16 on the "
          f"wgmma body)")


@contextlib.contextmanager
def plain_flash():
    """Run the flash op's plain version on CUDA tensors (the comparison
    prefill only; the port never does)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import registry
    table = registry.IMPLS["flash_attention"]
    kernel = table["cuda"]
    table["cuda"] = fa.flash_attention_fwd_plain
    try:
        yield
    finally:
        table["cuda"] = kernel


def lm_fp32_consistency(params, cfg, dev):
    """The reference's test_prefill_then_decode_matches_forward at full
    width, fp32 compute: prefill FP32_PROMPT tokens, decode FP32_STEPS,
    and hold the logits against one cached forward over the sequence."""
    from repro_torch.models import decode_step, forward, init_caches, prefill
    from repro_torch.models.layers import lm_logits
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    seq = FP32_PROMPT + FP32_STEPS
    x = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab, (FP32_BATCH, seq))).to(dev)
    caches = init_caches(cfg32, FP32_BATCH, seq, device=dev)
    logits, caches = prefill(params, x[:, :FP32_PROMPT], cfg32, caches)
    outs = [logits]
    for t in range(FP32_PROMPT, seq - 1):
        logits, caches = decode_step(params, x[:, t:t + 1], t, cfg32, caches)
        outs.append(logits)
    del caches
    hidden, _, _ = forward(params, x, cfg32, caches=init_caches(
        cfg32, FP32_BATCH, seq, device=dev), update_cache=True)
    want = lm_logits(params["embed"], hidden[:, FP32_PROMPT - 1:seq - 1],
                     cfg32)
    got = torch.stack(outs, 1)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError("fp32 prefill + decode: shape or non-finite "
                             "logits")
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    if err > LM_FP32_TOL * scale:
        raise AssertionError(f"fp32 prefill + decode vs forward: max "
                             f"|dlogit| {err:.4g} > {LM_FP32_TOL:g} x "
                             f"{scale:.4g}")
    return {"max_abs_err": err, "max_logit": scale, "rel": err / scale,
            "argmax_agree": agree}


def device_profile(fn):
    """Run ``fn`` under ``torch.profiler``: (device seconds, the kernels
    by device time as (name, seconds, calls), flash kernel seconds).
    Only the device's own events count: the host operators that launched
    them carry the same time as their self device time.  The flash kernel
    is either body's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e6, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and
                   e.self_device_time_total > 0), key=lambda r: -r[1])
    flash = sum(r[1] for r in rows if "flash_fwd_kernel" in r[0] or
                "flash_wgmma_kernel" in r[0])
    return sum(r[1] for r in rows), rows, flash


def lm_breakdown(params, cfg, prompts, dev, decode_wall_s):
    """Where a warm prefill and a decode step spend the card's time: the
    profiler's device seconds against the wall time of the same work
    unprofiled (the prefill timed here, the decode from serve_lm)."""
    from repro_torch.models import decode_step, init_caches, prefill
    caches = init_caches(cfg, LM_BATCH, LM_PROMPT + LM_GEN, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = prefill(params, prompts, cfg, caches)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    caches = init_caches(cfg, LM_BATCH, LM_PROMPT + LM_GEN, device=dev)
    pre = device_profile(lambda: prefill(params, prompts, cfg, caches))
    tokens = logits[:, :cfg.vocab].argmax(-1)[:, None]
    steps = 4

    def decode():
        for t in range(steps):
            decode_step(params, tokens, LM_PROMPT + t, cfg, caches)
    dec = device_profile(decode)
    if pre[0] == 0 or dec[0] == 0:
        raise AssertionError("lm breakdown: the profiler recorded no device "
                             "time; time with CUDA events instead")
    step_s = decode_wall_s / (LM_GEN - 1)
    out = {"prefill_warm_ms": warm_s * 1e3,
           "prefill_device_ms": pre[0] * 1e3,
           "prefill_flash_ms": pre[2] * 1e3,
           "prefill_busy": pre[0] / warm_s,
           "decode_step_ms": step_s * 1e3,
           "decode_step_device_ms": dec[0] / steps * 1e3,
           "decode_busy": dec[0] / steps / step_s,
           "prefill_kernels": sum(r[2] for r in pre[1]),
           "decode_kernels_per_step": sum(r[2] for r in dec[1]) / steps,
           "prefill_top": [[n[:60], t * 1e3, c] for n, t, c in pre[1][:6]],
           "decode_top": [[n[:60], t / steps * 1e3, c // steps]
                          for n, t, c in dec[1][:6]]}
    print(f"lm breakdown: warm prefill {out['prefill_warm_ms']:.1f} ms, of "
          f"which the card is busy {out['prefill_device_ms']:.1f} ms "
          f"({100 * out['prefill_busy']:.1f}%), the flash kernel "
          f"{out['prefill_flash_ms']:.1f} ms, {out['prefill_kernels']} "
          f"kernels; decode step {out['decode_step_ms']:.2f} ms, the card "
          f"busy {out['decode_step_device_ms']:.2f} ms "
          f"({100 * out['decode_busy']:.1f}%), "
          f"{out['decode_kernels_per_step']:.0f} kernels a step; prefill "
          f"top kernels (ms, "
          f"calls): " + "; ".join(f"{n} {t:.1f} x{c}" for n, t, c in
                                  out["prefill_top"])
          + "; decode top kernels per step (ms, calls): "
          + "; ".join(f"{n} {t:.3f} x{c}" for n, t, c in out["decode_top"]))
    return out


def phase_lm(dev, card, results):
    """gemma3_12b at full width and depth: the fp32 decode/forward check,
    then the main path (``serve_lm``: flash prefill + greedy decode), the
    same prefill with the plain attention, and the CWS head on the pooled
    hidden state."""
    from repro_torch.configs import get_config
    from repro_torch.core.cws import CWSParams
    from repro_torch.kernels import cws_hash
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import parser, serve_lm
    from repro_torch.models import (cast_params, forward, init_caches,
                                    init_model, prefill)
    from repro_torch.models.cws_head import (cws_head_logits, head_pipeline,
                                             init_cws_head, pool_hidden)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: fp32 checks need them off")
    cfg = dataclasses.replace(get_config(LM_ARCH, "full"), attn_impl="flash")
    n_attn = cfg.n_layers   # every block of gemma3 is attention
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator(dev).manual_seed(LM_SEED), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    masters_gb = torch.cuda.memory_allocated() / 1e9

    reset_all_launches()
    fp32 = lm_fp32_consistency(params, cfg, dev)
    fp32["flash_launches"] = read_launches()["flash_attention_fwd"]
    fp32["body_launches"] = dict(fa.BODY_LAUNCHES)
    if fp32["flash_launches"] != 2 * n_attn or \
            fp32["body_launches"] != {"wgmma": 0, "simt": 2 * n_attn}:
        raise AssertionError(f"fp32 check: {fp32['flash_launches']} flash "
                             f"launches, by body {fp32['body_launches']}; "
                             f"want {2 * n_attn}, all on the SIMT body")
    print(f"slice lm fp32 [{card}]: {LM_ARCH} full width, {cfg.n_layers} "
          f"layers, fp32 masters {masters_gb:.2f} GB drawn on the card in "
          f"{init_s:.2f} s; prefill {FP32_BATCH}x{FP32_PROMPT} + "
          f"{FP32_STEPS} decode steps vs one cached forward: max |dlogit| "
          f"{fp32['max_abs_err']:.4g} ({fp32['rel']:.3g} of max |logit| "
          f"{fp32['max_logit']:.4g}; limit {LM_FP32_TOL:g}); argmax agree "
          f"{fp32['argmax_agree']:.3f}; flash launches "
          f"{fp32['flash_launches']} (by body {fp32['body_launches']})")

    # the masters cast once to bf16: the same bits as casting at each use
    cast_params(params, cfg.compute_dtype)
    torch.cuda.empty_cache()
    args = parser().parse_args([
        "--arch", LM_ARCH, "--variant", "full", "--attn-impl", "flash",
        "--batch", str(LM_BATCH), "--prompt-len", str(LM_PROMPT),
        "--gen", str(LM_GEN), "--seed", str(LM_SEED), "--device", DEVICE])

    # the main path, counters zeroed just before and read just after
    reset_all_launches()
    out = serve_lm(args, params=params)
    launches = read_launches()
    bodies = dict(fa.BODY_LAUNCHES)
    require_launched("lm", launches, (FLASH[0],))
    if launches[FLASH[0]] != n_attn or \
            bodies != {"wgmma": n_attn, "simt": 0}:
        raise AssertionError(f"lm: {launches[FLASH[0]]} flash launches in "
                             f"one prefill, by body {bodies}; want {n_attn}, "
                             f"all on the wgmma body")
    results[FLASH[0]]["launches"] = launches[FLASH[0]]
    results[FLASH[0]]["body_launches"] = bodies
    gen = out["generated"]
    if gen.shape != (LM_BATCH, LM_GEN) or not (
            (gen >= 0) & (gen < cfg.vocab)).all():
        raise AssertionError(f"lm: generated ids {gen.shape} out of range")
    flash_logits = out["prefill_logits"].float()
    prompts = out["prompts"]

    # the same prefill through the plain attention; then warm ones through
    # the kernel, timed and profiled
    with plain_flash():
        plain_logits, _ = prefill(params, prompts, cfg, init_caches(
            cfg, LM_BATCH, LM_PROMPT + LM_GEN, device=dev))
    plain_logits = plain_logits.float()
    if not torch.isfinite(flash_logits).all() or \
            flash_logits.shape != (LM_BATCH, cfg.padded_vocab):
        raise AssertionError("lm: prefill logits non-finite or misshapen")
    scale = float(plain_logits.abs().max())
    err = float((flash_logits - plain_logits).abs().max())
    agree = float((flash_logits[:, :cfg.vocab].argmax(-1) ==
                   plain_logits[:, :cfg.vocab].argmax(-1)).float().mean())
    if err > LM_BF16_TOL * scale:
        raise AssertionError(f"lm: flash vs plain prefill max |dlogit| "
                             f"{err:.4g} > {LM_BF16_TOL:g} x {scale:.4g}")
    breakdown = lm_breakdown(params, cfg, prompts, dev, out["decode_s"])
    warm_ms = breakdown["prefill_warm_ms"]

    # the paper's head on the pooled hidden state (cws_encode kernel)
    hidden, _, _ = forward(params, prompts, cfg)
    feats = pool_hidden(hidden).float()
    del hidden
    head = init_cws_head(torch.Generator(dev).manual_seed(LM_SEED),
                         cfg.d_model, k=cfg.cws_k, b_i=cfg.cws_b_i,
                         n_classes=CWS_CLASSES)
    head = head._replace(table=torch.from_numpy(
        np.random.default_rng(14).standard_normal(
            tuple(head.table.shape), np.float32)).to(dev))
    cws_hash.reset_launches()
    head_logits = cws_head_logits(head, feats, b_i=cfg.cws_b_i)
    cws_launches = cws_hash.LAUNCHES["cws_encode"]
    if cws_launches == 0:
        raise AssertionError("cws head: cws_encode was never launched")
    idx = head_pipeline(head, b_i=cfg.cws_b_i).features(torch.relu(feats))
    torch.cuda.synchronize()
    cpu_head = head._replace(
        cws=CWSParams(head.cws.r.cpu(), head.cws.log_c.cpu(),
                      head.cws.beta.cpu()),
        table=head.table.cpu(), bias=head.bias.cpu())
    cpu_idx = head_pipeline(cpu_head, b_i=cfg.cws_b_i).features(
        torch.relu(feats.cpu()))
    if not torch.equal(idx.cpu(), cpu_idx):
        raise AssertionError("cws head: card and CPU hash codes differ")
    # float32 sums of k = 512 table rows in another order
    cpu_logits = cws_head_logits(cpu_head, feats.cpu(), b_i=cfg.cws_b_i)
    np.testing.assert_allclose(head_logits.cpu().numpy(), cpu_logits.numpy(),
                               rtol=1e-5, atol=1e-5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    results["lm"] = {
        "arch": LM_ARCH, "batch": LM_BATCH, "prompt": LM_PROMPT,
        "decode_steps": LM_GEN - 1, "prefill_ms": out["prefill_ms"],
        "prefill_warm_ms": warm_ms, "decode_s": out["decode_s"],
        "decode_tok_s": out["decode_tok_s"], "flash_launches": launches[
            FLASH[0]], "body_launches": bodies,
        "flash_vs_plain_max_abs": err, "max_logit": scale,
        "greedy_agree": agree, "fp32": fp32, "cws_encode_launches":
        cws_launches, "peak_gb": peak_gb, "masters_gb": masters_gb,
        "init_s": init_s, "first_ids": gen[0].tolist(),
        "breakdown": breakdown}
    print(f"slice lm [{card}]: {LM_ARCH} full width and depth, attn_impl "
          f"flash, bf16 weights cast once at load; prefill {LM_BATCH}x"
          f"{LM_PROMPT} {out['prefill_ms']:.1f} ms (warm {warm_ms:.1f} ms),"
          f" decode {LM_GEN - 1} steps {out['decode_tok_s']:.1f} tok/s; "
          f"flash launches {launches[FLASH[0]]} (= {n_attn} attention "
          f"layers; by body {bodies}); prefill logits vs the plain "
          f"attention: max |dlogit| "
          f"{err:.4g} ({err / scale:.3g} of max |logit| {scale:.4g}; limit "
          f"{LM_BF16_TOL:g}), greedy agree {agree:.3f}; CWS head (k = "
          f"{cfg.cws_k}, b_i = {cfg.cws_b_i}, D = {cfg.d_model}) cws_encode "
          f"launches {cws_launches}, codes equal the CPU path's; peak "
          f"memory {peak_gb:.2f} GB (torch.cuda.max_memory_allocated); "
          f"first ids {gen[0][:8].tolist()}")
    del params, out, plain_logits, flash_logits
    torch.cuda.empty_cache()


def _leaves(tree):
    out = []
    for val in tree.values():
        out.extend(_leaves(val) if isinstance(val, dict) else [val])
    return out


def sp_rank(rank, world, init_method, spec):
    """One rank of the sequence-parallel phase, in a process of its own:
    writes its report to ``spec["outdir"]/rank{rank}.json``."""
    import datetime
    import torch.distributed as dist
    dev = torch.device(spec["device_type"],
                       rank if spec["backend"] == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(spec["backend"], init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(minutes=20))
    try:
        report = sp_rank_body(rank, world, dev, spec)
        pathlib.Path(spec["outdir"], f"rank{rank}.json").write_text(
            json.dumps(report))
    finally:
        dist.destroy_process_group()


def sp_rank_body(rank, world, dev, spec):
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import cast_params, init_model
    from repro_torch.models.sharding import make_rules
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: fp32 checks need them off")
    cfg = dataclasses.replace(get_config(LM_ARCH, "full"),
                              n_layers=spec["layers"], attn_impl="flash")
    mesh = make_mesh(1, world)
    rules = make_rules(mesh)
    route = collectives.transport(dist.get_backend(mesh.group("model")), dev)
    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator(dev).manual_seed(SP_SEED), dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    # the same weights on every rank: every leaf's sum, gathered
    sums = torch.stack([t.double().sum() for t in _leaves(params)])
    every = collectives.all_gather_dim(sums[None], mesh, "model", dim=0)
    if not (every == every[:1]).all():
        raise AssertionError(f"rank {rank}: the ranks' weights differ")
    report = {"rank": rank, "device": str(dev), "transport": route,
              "init_s": init_s, "masters_gb": sum(
                  t.numel() * t.element_size() for t in _leaves(params)) /
              1e9, "runs": []}
    for dtype in ("float32", "bfloat16"):
        if dtype == "bfloat16":
            cast_params(params, torch.bfloat16)
            torch.cuda.empty_cache()
        cfg_d = dataclasses.replace(cfg, dtype=dtype)
        for prompt in (spec["ring_prompt"], spec["ag_prompt"]):
            report["runs"].append(sp_run(rank, world, dev, mesh, rules,
                                         params, cfg_d, prompt))
    return report


def sp_run(rank, world, dev, mesh, rules, params, cfg, prompt):
    """One sequence-parallel forward of a (SP_BATCH, prompt) batch on every
    rank; rank 0 then runs the one-device forward on the same weights and
    compares the gathered hidden states and each rank's last-position
    logits with it."""
    import torch.distributed as dist
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import collectives
    from repro_torch.models import forward
    from repro_torch.models.layers import lm_logits
    from repro_torch.models.sharding import (gather_shards, local_shard,
                                             use_rules)
    ring = fa.use_ring(prompt, world, threshold=cfg.attn_ring_min_sk or None)
    tokens = torch.from_numpy(np.random.default_rng(SP_SEED + prompt).integers(
        0, cfg.vocab, (SP_BATCH, prompt))).to(dev)
    local = local_shard(tokens, rules, "batch", "sp")
    dist.barrier()
    fa.reset_launches()
    collectives.reset_host_copies()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize(dev)
    # the main path, counters zeroed just before and read just after
    t0 = time.perf_counter()
    with use_rules(rules):
        hidden, _, _ = forward(params, local, cfg)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    bodies = dict(fa.BODY_LAUNCHES)
    host = dict(collectives.HOST_COPIES)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    n_attn = cfg.n_layers
    want = {STEP[0]: world * n_attn if ring else 0,
            FLASH[0]: 0 if ring else n_attn}
    body = fa.flash_body(cfg.compute_dtype, cfg.head_dim_)
    want_bodies = {"wgmma": 0, "simt": 0}
    want_bodies[body] = sum(want.values())
    if launches != want or bodies != want_bodies:
        raise AssertionError(f"rank {rank}, {cfg.dtype} S = {prompt}: "
                             f"launches {launches}, by body {bodies}; not "
                             f"{want}, {want_bodies}")
    last = lm_logits(params["embed"], hidden[:, -1:], cfg)[:, 0].float()
    run = {"dtype": cfg.dtype, "prompt": prompt,
           "route": "ring" if ring else "allgather", "launches": launches,
           "body_launches": bodies,
           "host_bytes": host["bytes"], "host_tensors": host["tensors"],
           "peak_gb": peak_gb, "forward_s": wall,
           "local_tokens": list(local.shape)}
    hid_all = gather_shards(hidden, rules, (SP_BATCH, prompt, cfg.d_model),
                            "batch", "sp")
    last_all = collectives.all_gather_dim(last, mesh, "model", dim=0)
    del hidden
    if rank == 0:
        ref, _, _ = forward(params, tokens, cfg)      # one device: row 8
        sl = prompt // world
        idx = [(m + 1) * sl - 1 for m in range(world)]
        ref_last = lm_logits(params["embed"], ref[:, idx], cfg).float()
        got_last = last_all.reshape(world, SP_BATCH, -1).transpose(0, 1)
        torch.cuda.synchronize(dev)
        if not torch.isfinite(hid_all).all() or hid_all.shape != ref.shape:
            raise AssertionError("sequence-parallel hidden states: "
                                 "non-finite or misshapen")
        h_scale = float(ref.float().abs().max())
        h_err = float((hid_all.float() - ref.float()).abs().max())
        l_scale = float(ref_last.abs().max())
        l_err = float((got_last - ref_last).abs().max())
        agree = bool((got_last[..., :cfg.vocab].argmax(-1) ==
                      ref_last[..., :cfg.vocab].argmax(-1)).all())
        tol = LM_FP32_TOL if cfg.dtype == "float32" else LM_BF16_TOL
        run.update(hidden_err=h_err, hidden_scale=h_scale, logit_err=l_err,
                   logit_scale=l_scale, argmax_equal=agree, tol=tol)
        if h_err > tol * h_scale or l_err > tol * l_scale:
            raise AssertionError(
                f"sequence-parallel vs one-device forward, {cfg.dtype} S = "
                f"{prompt}: max |dhidden| {h_err:.4g} (max {h_scale:.4g}), "
                f"max |dlogit| {l_err:.4g} (max {l_scale:.4g}); limit "
                f"{tol:g} of the max")
        if cfg.dtype == "bfloat16" and not agree:
            raise AssertionError(f"sequence-parallel vs one-device forward, "
                                 f"bf16 S = {prompt}: argmax ids differ")
        del ref
    del hid_all, last_all
    torch.cuda.empty_cache()
    dist.barrier()
    return run


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_seq_parallel(backend, world, layers):
    """Spawn ``world`` ranks of the sequence-parallel phase; their reports,
    with the launch totals checked."""
    outdir = ROOT / "build" / "seq_parallel" / backend
    shutil.rmtree(outdir, ignore_errors=True)
    outdir.mkdir(parents=True)
    spec = {"backend": backend, "layers": layers, "device_type": DEVICE,
            "ring_prompt": SP_RING_PROMPT, "ag_prompt": SP_AG_PROMPT,
            "outdir": str(outdir)}
    import torch.multiprocessing
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    torch.multiprocessing.spawn(
        sp_rank, args=(world, f"tcp://localhost:{free_port()}", spec),
        nprocs=world, join=True)
    wall = time.perf_counter() - t0
    reports = [json.loads((outdir / f"rank{r}.json").read_text())
               for r in range(world)]
    shutil.rmtree(outdir, ignore_errors=True)
    for i, run in enumerate(reports[0]["runs"]):
        total = {name: sum(rep["runs"][i]["launches"][name]
                           for rep in reports) for name in (STEP[0], FLASH[0])}
        bodies = {name: sum(rep["runs"][i]["body_launches"][name]
                            for rep in reports) for name in ("wgmma", "simt")}
        ring = run["route"] == "ring"
        want = {STEP[0]: world * world * layers if ring else 0,
                FLASH[0]: 0 if ring else world * layers}
        # gemma3's D = 256: bf16 on the wgmma body, fp32 on the SIMT body
        body = "wgmma" if run["dtype"] == "bfloat16" else "simt"
        want_bodies = {"wgmma": 0, "simt": 0}
        want_bodies[body] = sum(want.values())
        if total != want or bodies != want_bodies:
            raise AssertionError(f"sequence-parallel {run['dtype']} S = "
                                 f"{run['prompt']}: launches {total}, by "
                                 f"body {bodies}; not {want}, {want_bodies}")
        run["total_launches"] = total
        run["total_body_launches"] = bodies
    return {"backend": backend, "world": world, "layers": layers,
            "wall_s": wall, "ranks": reports}


def phase_seq_parallel(card, results):
    """gemma3_12b at full width, 6 layers, its sequence sharded over four
    ranks of the ``model`` axis: the ring run (32,768 tokens) and the
    all-gather run (2,048), fp32 then bf16, each against the one-device
    forward on the same weights.  On one card the four ranks share it
    over gloo (NCCL takes one rank a card); with four cards the phase runs
    once more over NCCL, one rank a card, at full depth."""
    out = run_seq_parallel("gloo", SP_RANKS, SP_LAYERS)
    results["seq_parallel"] = {"gloo": out}
    report_seq_parallel(out, card)
    ring_bf16 = next(r for r in out["ranks"][0]["runs"]
                     if r["route"] == "ring" and r["dtype"] == "bfloat16")
    results[STEP[0]]["launches"] = ring_bf16["total_launches"][STEP[0]]
    results[STEP[0]]["body_launches"] = ring_bf16["total_body_launches"]
    if torch.cuda.device_count() >= SP_RANKS:
        nccl = run_seq_parallel("nccl", SP_RANKS, SP_FULL_DEPTH)
        results["seq_parallel"]["nccl"] = nccl
        report_seq_parallel(nccl, card)
    else:
        print(f"seq-parallel nccl: not run: {torch.cuda.device_count()} "
              f"card(s); the NCCL path (one rank a card, full depth) needs "
              f"{SP_RANKS}")


def report_seq_parallel(out, card):
    ranks = out["ranks"]
    how = ("gloo, CUDA tensors through host copies, four ranks on one card"
           if ranks[0]["transport"] == "gloo+host" else
           f"{ranks[0]['transport']}, one rank a card")
    print(f"seq-parallel [{card}]: {LM_ARCH} full width, {out['layers']} "
          f"layers, {out['world']} ranks (data 1 x model {out['world']}), "
          f"transport {how}; fp32 masters {ranks[0]['masters_gb']:.2f} GB a "
          f"rank, the same on every rank (checksummed), drawn in "
          f"{max(r['init_s'] for r in ranks):.2f} s; whole phase "
          f"{out['wall_s']:.1f} s")
    shared = ranks[0]["transport"] == "gloo+host"
    for i, run in enumerate(ranks[0]["runs"]):
        per = [r["runs"][i] for r in ranks]
        h_rel = run["hidden_err"] / run["hidden_scale"]
        l_rel = run["logit_err"] / run["logit_scale"]
        print(f"  {run['dtype']} S = {run['prompt']} ({run['route']}, "
              f"{run['local_tokens'][1]} tokens a rank): launches "
              f"{run['total_launches']} in all, by body "
              f"{run['total_body_launches']}; host copies "
              f"{[p['host_bytes'] for p in per]} bytes a rank; peak "
              f"{[round(p['peak_gb'], 2) for p in per]} GB a rank; forward "
              f"{[round(p['forward_s'], 3) for p in per]} s a rank ("
              + ("four ranks sharing one card: not a speed of the ring"
                 if shared else "one rank a card")
              + f"); vs the one-device forward: max |dhidden| "
              f"{run['hidden_err']:.4g} ({h_rel:.3g} of "
              f"{run['hidden_scale']:.4g}), last-position max |dlogit| "
              f"{run['logit_err']:.4g} ({l_rel:.3g} of "
              f"{run['logit_scale']:.4g}), limit {run['tol']:g} of the max; "
              f"argmax ids equal: {run['argmax_equal']}")


def visible_pairs(sq, sk, window, q_base=0):
    """(query, key) pairs the causal / window mask lets through."""
    pos = np.arange(sq, dtype=np.int64) + q_base
    hi = np.minimum(pos + 1, sk)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else 0
    return int(np.maximum(hi - lo, 0).sum())


def time_bodies(run, reps, warmup=1):
    """``run(body)`` timed on the wgmma and the SIMT body in turns (wgmma,
    simt, simt, wgmma): ({body: mean ms}, {body: [the two readings]}).
    Raises unless the wgmma body is the faster."""
    readings = {"wgmma": [], "simt": []}
    for body in ("wgmma", "simt", "simt", "wgmma"):
        readings[body].append(time_ms(lambda: run(body), reps=reps,
                                      warmup=warmup))
    ms = {b: sum(v) / len(v) for b, v in readings.items()}
    if ms["wgmma"] >= ms["simt"]:
        raise AssertionError(f"the wgmma body ({ms['wgmma']:.4f} ms) is not "
                             f"faster than the SIMT body ({ms['simt']:.4f} "
                             f"ms) on the same inputs")
    return ms, readings


def phase_flash_times(dev, results, mhz, sms):
    """The flash kernel at the slice's layers and at prefill_32k's length,
    the wgmma and the SIMT body on the same inputs, beside the bound, the
    wgmma design's own floor, the plain version and SDPA as a
    yardstick."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import flash_attention as fa
    tensor_rate = sms * TENSOR_FLOPS_PER_SM_CLK * mhz * 1e6
    fma_rate = sms * FMA_FLOPS_PER_SM_CLK * mhz * 1e6
    rng = np.random.default_rng(9)
    h, g, d = 16, 8, 256
    for b, s_, w in FLASH_TIMING:
        q, k, v = flash_inputs(rng, b, s_, s_, h, g, d, torch.bfloat16, dev)
        long = s_ > 4096
        ms, readings = time_bodies(lambda body: fa.flash_attention_fwd_cuda(
            q, k, v, window=w, body=body), reps=3 if long else 10)
        plain_ms = time_ms(lambda: fa.flash_attention_fwd_plain(
            q, k, v, window=w), reps=1 if long else 3, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if w == 0:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, enable_gqa=True)
        else:
            # a boolean mask for the window.  With enable_gqa and a mask
            # PyTorch would take its math path, which at S = 32,768 writes
            # (H, S, S) scores; so k and v are repeated to the query heads
            # first (outside the timing) and the memory-efficient path is
            # asked for
            i = torch.arange(s_, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
            kt, vt = (t.repeat_interleave(h // g, dim=1) for t in (kt, vt))

            def lib():
                with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                    return F.scaled_dot_product_attention(qt, kt, vt,
                                                          attn_mask=mask)
        lib_ms = time_ms(lib, reps=3 if long else 10, warmup=1)
        pairs = visible_pairs(s_, s_, w) * b * h
        flops = 4 * d * pairs
        nbytes = 2 * (2 * b * s_ * h * d + 2 * b * s_ * g * d)
        bound_ms, by = bound(nbytes, flops, tensor_rate)
        # the wgmma design's own floor: p . v twice (hi and lo), 6 D flops
        floor_ms = bound(nbytes, 6 * d * pairs, tensor_rate)[0]
        fma_ms = flops / fma_rate * 1e3
        results[FLASH[0]]["times"].append({
            "shape": [b, s_, h, g, d], "window": w, "ms": ms["wgmma"],
            "simt_ms": ms["simt"], "readings": readings,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "floor_6d_ms": floor_ms, "fp32_fma_bound_ms": fma_ms,
            "library_ms": lib_ms, "visible_pairs": pairs, "flops": flops,
            "bytes": nbytes})
        print(f"time flash_attention_fwd (B, S) = ({b}, {s_}) H/G {h}/{g} "
              f"D {d} window {w} bf16: wgmma body {ms['wgmma']:.4f} ms, SIMT "
              f"body {ms['simt']:.4f} ms (in turns: {readings}), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}; dense bf16 "
              f"{tensor_rate / 1e12:.1f} TFLOP/s, {flops / 1e9:.2f} GFLOP at "
              f"4 D a pair on {nbytes / 1e6:.1f} MB), the wgmma design's "
              f"floor (6 D a pair) {floor_ms:.4f} ms, fp32-FMA bound "
              f"{fma_ms:.4f} ms ({fma_rate / 1e12:.2f} TFLOP/s); library call "
              f"scaled_dot_product_attention {lib_ms:.4f} ms "
              + ("(causal, enable_gqa" if w == 0 else
                 "(boolean window mask, memory-efficient path, k/v repeated"
                 " to the query heads")
              + "; a yardstick, the port never calls it)")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()


def phase_step_times(dev, results, mhz, sms):
    """Row 9 alone at one ring step's shapes, the wgmma and the SIMT body
    on the same inputs, beside its bound, the wgmma design's floor, its
    plain version and SDPA on the same (q, k shard) and mask without a
    carry."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import flash_attention as fa
    tensor_rate = sms * TENSOR_FLOPS_PER_SM_CLK * mhz * 1e6
    rng = np.random.default_rng(12)
    b, s_, h, g, d = STEP_TIMING_SHAPE
    q, k, v = flash_inputs(rng, b, s_, s_, h, g, d, torch.bfloat16, dev)
    carry = fa.init_carry(b, s_, h, d, dev)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    for label, shard, w in STEP_TIMING:
        q_base, k_base = s_, shard * s_
        args = dict(q_base=q_base, k_base=k_base, window=w)
        ms, readings = time_bodies(lambda body: fa.flash_attention_step_cuda(
            q, k, v, carry, body=body, **args), reps=10)
        plain_ms = time_ms(lambda: fa.flash_attention_step_plain(
            q, k, v, carry, **args), reps=3, warmup=1)
        if w == 0:
            # q rows at q_base against keys at k_base: the diagonal shard
            # is causal, an earlier one fully visible
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=q_base == k_base, enable_gqa=True)
            lib_note = ("causal" if q_base == k_base else "no mask") + \
                ", enable_gqa"
        else:
            i = torch.arange(s_, device=dev)
            pos, key = i[:, None] + q_base, i[None, :] + k_base
            mask = (key <= pos) & (key > pos - w)
            kr, vr = (t.repeat_interleave(h // g, dim=1) for t in (kt, vt))

            def lib():
                with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                    return F.scaled_dot_product_attention(qt, kr, vr,
                                                          attn_mask=mask)
            lib_note = ("boolean window mask, memory-efficient path, k/v "
                        "repeated to the query heads")
        lib_ms = time_ms(lib, reps=10, warmup=1)
        pairs = visible_pairs(s_, s_, w, q_base - k_base) * b * h
        flops = 4 * d * pairs
        # q, k, v read once in bf16; the carry read and written once, fp32
        nbytes = 2 * (b * s_ * h * d + 2 * b * s_ * g * d) + \
            2 * 4 * (2 * b * s_ * h + b * s_ * h * d)
        bound_ms, by = bound(nbytes, flops, tensor_rate)
        floor_ms = bound(nbytes, 6 * d * pairs, tensor_rate)[0]
        results[STEP[0]]["times"].append({
            "shape": [b, s_, h, g, d], "shard": label, "q_base": q_base,
            "k_base": k_base, "window": w, "ms": ms["wgmma"],
            "simt_ms": ms["simt"], "readings": readings,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "floor_6d_ms": floor_ms, "library_ms": lib_ms,
            "visible_pairs": pairs, "flops": flops, "bytes": nbytes})
        print(f"time flash_attention_step ({label} shard: q rows at "
              f"{q_base}, k rows at {k_base}, window {w}) (B, Sq, Sk) = "
              f"({b}, {s_}, {s_}) H/G {h}/{g} D {d} bf16, fp32 carry: wgmma "
              f"body {ms['wgmma']:.4f} ms, SIMT body {ms['simt']:.4f} ms (in "
              f"turns: {readings}), plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({by}; {flops / 1e9:.2f} GFLOP at 4 D a "
              f"pair, {tensor_rate / 1e12:.1f} TFLOP/s, {nbytes / 1e6:.1f} "
              f"MB), the wgmma design's floor (6 D a pair) {floor_ms:.4f} "
              f"ms; "
              f"library call scaled_dot_product_attention on the same q and "
              f"k shard, no carry ({lib_note}) {lib_ms:.4f} ms (the nearest "
              f"single PyTorch call; the port never calls it)")
    del q, k, v, qt, kt, vt, carry
    torch.cuda.empty_cache()


def time_cws_bodies(case, reps):
    """Rows 6 and 3 on the split and the pair body on the same inputs, in
    turns (split, pair, pair, split): ({body: mean ms}, {body: [the two
    readings]})."""
    readings = {"split": [], "pair": []}
    for body in ("split", "pair", "pair", "split"):
        readings[body].append(time_ms(lambda: case.run(case.cuda, body=body),
                                      reps=reps))
    return {b: sum(v) / len(v) for b, v in readings.items()}, readings


def cws_times(case, reps, plain_reps, peak_ops, counts):
    """One CWS kernel's times at one shape: the kernel (for rows 6 and 3
    the split body, with the pair body beside it and each body's design
    floor), the plain version, the bound."""
    from repro_torch.kernels.cws_hash import (SPLIT_KERNELS, sm_count,
                                              split_plan)
    t = {"shape": list(case.x.shape) + [case.k], "library_ms": None}
    if case.name in SPLIT_KERNELS:
        ms, readings = time_cws_bodies(case, reps)
        plan = split_plan(*case.x.shape, case.k, sm_count(0))
        t.update(ms=ms["split"], pair_ms=ms["pair"], readings=readings,
                 floor_ms=case.floor_ms(peak_ops, counts, "split"),
                 pair_floor_ms=case.floor_ms(peak_ops, counts, "pair"),
                 plan={"rows_per_thread": plan.rows_per_thread,
                       "row_warps": plan.row_warps, "splits": plan.splits,
                       "blocks": plan.blocks})
    else:
        t["ms"] = time_ms(lambda: case.run(case.cuda), reps=reps)
    t["plain_ms"] = time_ms(lambda: case.run(case.plain), reps=plain_reps,
                            warmup=1)
    t["bound_ms"], t["bound_by"] = case.bound_ms(peak_ops)
    return t


def cws_time_line(name, t, b=None):
    n, d, k = t["shape"]
    head = f"time {name} ({n}, {d}, {k})" + ("" if b is None else f" b={b}")
    floor = lambda v: "not measured" if v is None else f"{v:.4f} ms"
    if "pair_ms" in t:
        p = t["plan"]
        body = (f"split body {t['ms']:.4f} ms (design floor "
                f"{floor(t['floor_ms'])}; plan {p['rows_per_thread']} rows a "
                f"thread x {p['row_warps']} row warps, S = {p['splits']}, "
                f"{p['blocks']} blocks), pair body {t['pair_ms']:.4f} ms "
                f"(design floor {floor(t['pair_floor_ms'])}) (in turns: "
                f"{t['readings']})")
    else:
        body = f"kernel {t['ms']:.4f} ms"
    return (f"{head}: {body}, plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}); library call: none "
            f"(no PyTorch op computes CWS)")


def phase_times(dev, results, peak_ops, counts):
    rng = np.random.default_rng(5)
    key = (0x2F0A1C3B, 0x9E3779B9)
    for d, tag in ((DIM, ""), (WIDE_DIM, "_wide")):
        x = torch.from_numpy(sparse_rows(rng, 512, d)).to(dev)
        params = stored_params(rng, d, NUM_HASHES, dev)
        for name in ENCODES:
            b_i = 4 if name == "cws_encode_packed" else B_I
            case = KernelCase(name, x, b_i, 0, params=params, key=key,
                              k=NUM_HASHES)
            wide = d == WIDE_DIM
            t = cws_times(case, 5 if wide else 50, 1 if wide else 10,
                          peak_ops, counts)
            r = results[name]
            for key_ in ("ms", "plain_ms", "bound_ms", "bound_by",
                         "pair_ms", "floor_ms", "pair_floor_ms"):
                if key_ in t:
                    r[key_ + tag] = t[key_]
            r.setdefault("times", []).append(t)
            print(cws_time_line(name, t, b_i))

    # the raw hashes: serving and wide shapes, and the estimator's pair
    est = torch.from_numpy(compacted_pair("CREDIT-CARD", N_DOCS)).to(dev)
    shapes = [(torch.from_numpy(sparse_rows(rng, 512, d)).to(dev), reps)
              for d, reps in ((DIM, 50), (WIDE_DIM, 5))] + [(est, 50)]
    for x, reps in shapes:
        n, d = x.shape
        params = stored_params(rng, d, NUM_HASHES, dev)
        for name in RAW:
            case = KernelCase(name, x, params=params, key=key, k=NUM_HASHES)
            t = cws_times(case, reps, 1 if d == WIDE_DIM else 10, peak_ops,
                          counts)
            results[name]["times"].append(t)
            print(cws_time_line(name, t))

    # the min-sum Gram: the suite's train Gram and an MNIST-variations
    # train Gram (Table 1's M-Rotate / M-Image shape, synthetic rows)
    from repro_torch.data.synthetic import CLASSIFICATION_SUITES
    from repro_torch.kernels import minmax_gram as G
    suite = torch.from_numpy(CLASSIFICATION_SUITES["template"]().x_train)
    for m, n, d in GRAM_TIMING:
        if (m, d) == tuple(suite.shape):
            x = y = suite.to(dev)
        else:
            x = torch.from_numpy(gram_rows(rng, m, d)).to(dev)
            y = x
        big = m * n > 10 ** 7
        ms = time_ms(lambda: G.min_sum_cuda(x, y), reps=5 if big else 50)
        plain_ms = time_ms(lambda: G.min_sum_plain(x, y),
                           reps=1 if big else 5, warmup=1)
        lib_ms = time_ms(lambda: torch.cdist(x, y, p=1),
                         reps=2 if big else 20, warmup=1)
        bound_ms, by = bound(4 * (m + n) * d + 4 * m * n, 2 * m * n * d,
                             peak_ops)
        results[GRAM[0]]["times"].append({
            "shape": [m, n, d], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": lib_ms})
        print(f"time min_sum ({m}, {n}, {d}): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}); library "
              f"call torch.cdist(p=1) {lib_ms:.4f} ms (a yardstick: "
              f"S = (sum x + sum y - L1) / 2; the port never calls it)")


def build_all():
    """Build every kernel library at once, one nvcc per source; return
    the two CWS bodies' libraries by body."""
    from repro_torch.kernels.build import (cws_encode_library,
                                           cws_regen_split_library,
                                           flash_attention_library,
                                           flash_attention_wgmma_library,
                                           minmax_gram_library)
    libs = (cws_encode_library, cws_regen_split_library, minmax_gram_library,
            flash_attention_library, flash_attention_wgmma_library)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        futs = [pool.submit(f) for f in libs]
        built = [f.result() for f in futs]
    wall = time.perf_counter() - t0
    for lib in built:
        print(f"build: {lib.path.name} (nvcc {lib.seconds:.2f} s)")
        for line in lib.log.splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                print("  " + line.strip())
    print(f"build: {len(built)} libraries in {wall:.2f} s")
    return {"pair": built[0], "split": built[1]}


def count_instructions(cws_libs):
    """SASS instruction counts of the two CWS bodies (``sass_counts``),
    printed by instantiation; None, and "not measured", where the
    disassembly fails."""
    counts = []
    for body, lib in cws_libs.items():
        try:
            got = sass_counts(body, lib.path)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            print(f"sass {body} body ({lib.path.name}): not measured ({e})")
            return None
        if not got:
            print(f"sass {body} body ({lib.path.name}): not measured (no "
                  f"marked region found in the disassembly)")
            return None
        for c in got:
            if not c["regen_mode"]:
                continue
            regen = ("not found" if c["regen"] is None
                     else f"{c['regen']:.0f}")
            emit = ("index", "packed", "raw")[c["emit"]]
            print(f"sass {body} body ({CWS_SOURCES[body]}): emit {emit}, "
                  f"t* tracked {c['track_t']}, {c['rows']} rows a thread: "
                  f"{c['step']:.2f} instructions a nonzero (row, d, hash) "
                  f"step on the division's fast path ({c['step_static']:.1f} "
                  f"static in the step's region a division), {regen} a "
                  f"regenerated (d, hash)")
        counts += got
    return counts


def kernel_entry(name, source, replaces, r, primary):
    """One kernel's line of the JSON summary; ``primary`` is the timing
    that stands for it (the shape its main path gives it)."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": primary["ms"],
            "plain_ms": primary["plain_ms"],
            "bound_ms": primary["bound_ms"],
            "bound_by": primary["bound_by"],
            "library_ms": primary["library_ms"],
            "shapes_checked": r["checked"], "mismatches": r["mismatches"]}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    peak_ops, sms, mhz = lane_rate()
    print(f"device: {name} (count {torch.cuda.device_count()}); "
          f"nvidia-smi: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; lane issue rate {sms} SMs x "
          f"{LANES_PER_SM} lanes x {mhz:.0f} MHz = {peak_ops / 1e12:.3f} "
          f"T operations/s (the bounds' operation rate); memory "
          f"{PEAK_BYTES_S / 1e12:.2f} TB/s")

    cws_libs = build_all()
    counts = count_instructions(cws_libs)

    from repro_torch.kernels.cws_hash import SPLIT_KERNELS
    results = {k: {"checked": 0, "mismatches": 0, "max_abs_err": 0,
                   "launches": 0} for k in KERNELS}
    for k in RAW:
        results[k].update(mismatches_i=0, mismatches_t=0, times=[])
    for k in SPLIT_KERNELS:
        results[k]["splits"] = {}
    results[GRAM[0]] = {"checked": 0, "mismatches": 0, "max_abs_err": 0.0,
                        "launches": 0, "times": []}
    results[FLASH[0]] = {"checked": 0, "mismatches": 0, "max_abs_err": 0.0,
                         "launches": 0, "times": []}
    results[STEP[0]] = {"checked": 0, "mismatches": 0, "max_abs_err": 0.0,
                        "launches": 0, "times": [], "masked": 0,
                        "chain_worst": {}}
    phase_parity(dev, results)
    phase_gram_parity(dev, results)
    phase_flash_parity(dev, results)
    phase_step_parity(dev, results)
    phase_slice(smi, results)
    phase_kernel_machine(dev, smi, results)
    phase_estimator(dev, smi, results)
    phase_lm(dev, smi, results)
    phase_seq_parallel(smi, results)
    phase_times(dev, results, peak_ops, counts)
    phase_flash_times(dev, results, mhz, sms)
    phase_step_times(dev, results, mhz, sms)

    def cws_entry(k, primary):
        r = results[k]
        split = k in SPLIT_KERNELS
        entry = kernel_entry(k, CWS_SOURCES["split" if split else "pair"],
                             KERNELS[k][0], r, primary)
        entry.update(body="split" if split else "pair", times=r["times"])
        if split:
            entry.update(sources=CWS_SOURCES, pair_ms=primary["pair_ms"],
                         floor_ms=primary["floor_ms"],
                         pair_floor_ms=primary["pair_floor_ms"],
                         parity_splits=r["splits"])
        return entry

    kernels = []
    for k in ENCODES:
        r = results[k]
        entry = cws_entry(k, r["times"][0])
        entry.update(ms_wide=r["ms_wide"], plain_ms_wide=r["plain_ms_wide"],
                     bound_ms_wide=r["bound_ms_wide"],
                     bound_by_wide=r["bound_by_wide"], slice=r["slice"])
        kernels.append(entry)
    for k in RAW:
        r = results[k]
        # the main path's shape: the suite's rows (stored) or the
        # estimator's pair (regen); (512, 256, 1024) stands for the former
        primary = r["times"][2] if k == "cws_hash_rng" else r["times"][0]
        entry = cws_entry(k, primary)
        entry.update(mismatches_i=r["mismatches_i"],
                     mismatches_t=r["mismatches_t"])
        kernels.append(entry)
    r = results[GRAM[0]]
    entry = kernel_entry(GRAM[0], GRAM[2], GRAM[1], r, r["times"][0])
    entry.update(worst_ratio_S=r["worst_ratio_S"],
                 worst_ratio_K=r["worst_ratio_K"], times=r["times"],
                 kernel_machine=results["kernel_machine"],
                 estimator={k: v for k, v in results["estimator"].items()
                            if k != "pairs"})
    kernels.append(entry)
    r = results[FLASH[0]]
    # the main path's most frequent launch: a local layer of the slice
    primary = next(t for t in r["times"]
                   if t["shape"][:2] == [LM_BATCH, LM_PROMPT] and
                   t["window"] > 0)
    entry = kernel_entry(FLASH[0], FLASH[2], FLASH[1], r, primary)
    entry.update(sources=FLASH_SOURCES, body_launches=r["body_launches"],
                 simt_ms=primary["simt_ms"], worst=r["worst"],
                 parity_bodies=r["parity_bodies"], times=r["times"],
                 lm=results["lm"])
    kernels.append(entry)
    r = results[STEP[0]]
    # the main path's most frequent computing launch: a local layer's
    # resident (diagonal) shard under the window
    primary = next(t for t in r["times"] if t["shard"] == "window")
    entry = kernel_entry(STEP[0], STEP[2], STEP[1], r, primary)
    entry.update(sources=FLASH_SOURCES, body_launches=r["body_launches"],
                 simt_ms=primary["simt_ms"],
                 parity_bodies=r["parity_bodies"], worst=r["worst"],
                 chain_worst=r["chain_worst"],
                 masked_steps=r["masked"], times=r["times"],
                 seq_parallel=results["seq_parallel"])
    kernels.append(entry)
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels, "lane_rate_ops_s": peak_ops}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
