"""Build the CUDA sources with nvcc and load them with ctypes.

Each source under ``repro_torch/csrc/`` compiles on first use into a shared
library with a plain C interface, under ``build/kernels/`` at the root of
the checkout, named by a hash of the source, the headers beside it
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds and
an unchanged one loads at once.  Nothing here runs at
import time: a machine without ``nvcc`` imports the package and uses the
plain PyTorch paths on CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"

# No --use_fast_math anywhere.  Each library takes its own flags, and the
# flags enter its hash.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
# No fused multiply-add either: the CWS kernels must round each division,
# product and sum as the reference does, bit for bit.  Line info leaves the
# code as it is and lets a disassembly attribute each SASS instruction to
# its source line (chip_smoke.py's instruction counts).
EXACT_FLAGS = NVCC_FLAGS + ("--fmad=false", "-lineinfo")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


class BuiltLibrary:
    """A loaded kernel library with the compiler's report of its build."""

    def __init__(self, lib: ctypes.CDLL, path: pathlib.Path, log: str,
                 seconds: float):
        self.lib = lib
        self.path = path
        self.log = log            # nvcc's -Xptxas -v output ("" if cached)
        self.seconds = seconds    # build wall time (0 if cached)


def build(source: str, flags=EXACT_FLAGS) -> BuiltLibrary:
    """Compile ``csrc/<source>`` with ``flags`` unless a library for this
    exact source and flag set is already built; load it either way."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest = hashlib.sha256(digest.digest() +
                            " ".join(flags).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"{src.stem}-{digest}.so"
    log, seconds = "", 0.0
    if not out.exists():
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([nvcc_path(), *flags, "-o", tmp,
                                   str(src)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                                   f"{proc.stderr}")
            os.replace(tmp, out)   # atomic: concurrent builders never see
        finally:                   # a half-written library
            if os.path.exists(tmp):
                os.unlink(tmp)
        log = proc.stdout + proc.stderr
        seconds = time.perf_counter() - t0
    return BuiltLibrary(ctypes.CDLL(str(out)), out, log, seconds)


def _declare(built: BuiltLibrary, signatures) -> BuiltLibrary:
    """Declare each launcher's ctypes signature: pointers and the stream
    as c_void_p, so none is cut to 32 bits; every launcher returns its
    cudaError_t as an int."""
    for name, argtypes in signatures.items():
        fn = getattr(built.lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return built


@functools.lru_cache(maxsize=None)
def cws_encode_library() -> BuiltLibrary:
    """The CWS kernels' one-thread-per-pair body (``csrc/cws_encode.cu``):
    the four encode launchers and the two raw (i*, t*) launchers (the
    regenerated packed and raw ones are the split body's yardstick); key
    words as c_uint32."""
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    return _declare(build("cws_encode.cu"), {
        "cws_encode_launch": (p, p, p, p, i, i, i, i, i, p, p),
        "cws_encode_rng_launch": (p, u, u, i, i, i, i, i, p, p),
        "cws_encode_packed_launch": (p, p, p, p, i, i, i, i, i, p, i, p),
        "cws_encode_rng_packed_launch": (p, u, u, i, i, i, i, i, p, i, p),
        "cws_hash_launch": (p, p, p, p, i, i, i, p, p, p),
        "cws_hash_rng_launch": (p, u, u, i, i, i, p, p, p),
    })


@functools.lru_cache(maxsize=None)
def cws_regen_split_library() -> BuiltLibrary:
    """The regenerated-parameter CWS body with D split across a cluster
    (``csrc/cws_regen_split.cu``): rows 6 (raw) and 3 (packed), each taking
    its plan's rows per thread, row warps and splits as ints."""
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    return _declare(build("cws_regen_split.cu"), {
        "cws_regen_split_hash_launch": (p, u, u, i, i, i, i, i, i, p, p, p),
        "cws_regen_split_packed_launch": (p, u, u, i, i, i, i, i, i, i, i,
                                          p, i, p),
    })


@functools.lru_cache(maxsize=None)
def minmax_gram_library() -> BuiltLibrary:
    """The min-sum Gram kernel's library (``csrc/minmax_gram.cu``)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return _declare(build("minmax_gram.cu"), {
        "min_sum_launch": (p, p, i, i, i, p, p),
    })


@functools.lru_cache(maxsize=None)
def flash_attention_library() -> BuiltLibrary:
    """The flash-attention kernels' library (``csrc/flash_attention.cu``):
    the one-shot forward (row 8) and the block-resumable step (row 9).
    Their outputs are compared within a tolerance, not bit for bit, so it
    builds with fused multiply-adds (``NVCC_FLAGS``); the scale goes over
    as a c_float."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _declare(build("flash_attention.cu", NVCC_FLAGS), {
        "flash_attention_fwd_launch": (p, p, p, p, i, i, i, i, i, i, i, i,
                                       f, i, p),
        "flash_attention_step_launch": (p, p, p, p, p, p, p, p, p, i, i, i,
                                        i, i, i, i, i, i, f, i, p),
    })


@functools.lru_cache(maxsize=None)
def flash_attention_wgmma_library() -> BuiltLibrary:
    """The flash kernels' tensor-core body (``csrc/flash_attention_wgmma.cu``:
    rows 8 and 9 for bf16 at D in 64/128/192/256), built like the SIMT
    body with ``NVCC_FLAGS``; it reaches ``cuTensorMapEncodeTiled`` through
    the runtime, so it links no driver library."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _declare(build("flash_attention_wgmma.cu", NVCC_FLAGS), {
        "flash_attention_wgmma_fwd_launch": (p, p, p, p, i, i, i, i, i, i,
                                             i, i, f, p),
        "flash_attention_wgmma_step_launch": (p, p, p, p, p, p, p, p, p, i,
                                              i, i, i, i, i, i, i, i, f, p),
    })
