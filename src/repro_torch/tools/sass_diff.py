"""Whether two trees' CUDA sources compile to the same device code.

Builds each of the four kernel sources of ``--parent`` (a directory
holding another tree's ``csrc``, e.g. ``git archive HEAD
src/repro_torch/csrc | tar -x -C build/parent``) and of this tree with
``kernels/build.py``'s flags, then compares, source by source, the
``-Xptxas -v`` lines (registers, stack, spills per entry function) and
each function's SASS (``cuobjdump -sass``, addresses and encodings
dropped), matching functions by name past the anonymous namespace, whose
id nvcc derives from the file:

    python -m repro_torch.tools.sass_diff \\
        --parent build/parent/src/repro_torch/csrc

It needs the CUDA toolkit (``nvcc``, ``cuobjdump``); the outputs go under
``build/sass_diff/``.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import pathlib
import re
import subprocess
import sys

from repro_torch.kernels import build as B

SOURCES = {"cws_split.cu": B.EXACT_FLAGS, "minmax_gram.cu": B.EXACT_FLAGS,
           "flash_attention.cu": B.NVCC_FLAGS,
           "flash_attention_wgmma.cu": B.NVCC_FLAGS}
KERNEL = re.compile(r"(cws_split_kernel|min_sum_[a-z]+_kernel|"
                    r"flash_fwd_kernel|flash_wgmma_kernel)([^'\s]*)")


def compile_one(src: pathlib.Path, flags, out: pathlib.Path) -> str:
    proc = subprocess.run([B.nvcc_path(), *flags, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return proc.stdout + proc.stderr


def _name(mangled: str) -> str:
    """A kernel's name and template arguments, past the namespace."""
    k = KERNEL.search(mangled)
    return k.group(1) + k.group(2) if k else mangled


def ptxas_lines(log: str) -> list:
    """Each entry function's name (past the namespace) with its resource
    lines (registers, stack, spills), sorted by name."""
    entries = []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            entries.append([_name(m.group(1))])
        elif entries and ("Used" in ln or "bytes stack" in ln):
            entries[-1].append(ln.strip())
    return sorted(tuple(e) for e in entries)


def sass_functions(lib: pathlib.Path) -> dict:
    text = subprocess.run(["cuobjdump", "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = _name(m.group(1))
            funcs[cur] = []
        elif cur and line.strip().startswith("/*") and ";" in line:
            ins = re.sub(r"/\*[0-9a-fx]+\*/", "", line).strip()
            funcs[cur].append(re.sub(r"_Z\w+", "SYM", ins))
    return funcs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=
                                 argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--parent", required=True,
                    help="the other tree's csrc directory")
    args = ap.parse_args(argv)
    out = B.BUILD_DIR.parent / "sass_diff"
    out.mkdir(parents=True, exist_ok=True)
    trees = {"parent": pathlib.Path(args.parent), "this": B.CSRC}
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        logs = {(name, tag): pool.submit(compile_one, root / name, flags,
                                         out / f"{tag}_{name}.so")
                for name, flags in SOURCES.items()
                for tag, root in trees.items()}
        logs = {k: f.result() for k, f in logs.items()}
    same = True
    for name in SOURCES:
        a, b = (ptxas_lines(logs[(name, t)]) for t in trees)
        fa, fb = (sass_functions(out / f"{t}_{name}.so") for t in trees)
        equal = [k for k in fa if fb.get(k) == fa[k]]
        ok = a == b and len(equal) == len(fa) == len(fb)
        same &= ok
        print(f"{name}: ptxas -v {len(a)} / {len(b)} entries "
              f"({'identical' if a == b else 'differ'}); SASS "
              f"{len(fa)} / {len(fb)} functions, {len(equal)} identical, "
              f"{sum(len(v) for v in fb.values())} instructions")
    print("device code identical" if same else "device code differs")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
