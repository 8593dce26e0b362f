"""Docs smoke for the port (twin of the reference's
``tools/run_doc_snippets.py``): the docs cannot rot silently.

Two phases over ``README.md`` and ``docs/*.md``:

  1. **snippets**: every fenced ```python block that imports
     ``repro_torch`` runs, each in a fresh namespace, in file order, on
     the CPU (run as a command, it makes no card visible to them).
     Blocks are self-contained by convention; shell lines and sketches
     that need more than one process go in ```text blocks.
  2. **lint**: every dotted ``repro_torch.*`` name must resolve by import
     + getattr; every ``src/repro_torch/...`` and ``tests/test_torch_...``
     path must exist, and every ``python -m repro_torch....`` target must
     be a module of the port.

    PYTHONPATH=src python -m repro_torch.tools.run_doc_snippets

Exit code: 0 green, 1 on any failure (each failure is printed).
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import pathlib
import re
import sys
import traceback

ROOT = pathlib.Path(__file__).resolve().parents[3]

FENCE_RE = re.compile(r"^[ \t]*```python\s*$(.*?)^[ \t]*```\s*$",
                      re.M | re.S)
IMPORTS_PORT_RE = re.compile(r"^\s*(?:from|import)\s+repro_torch\b", re.M)
SYMBOL_RE = re.compile(r"\brepro_torch(?:\.[A-Za-z_][A-Za-z0-9_]*)+")
PATH_RE = re.compile(r"\b(?:src/repro_torch/[\w./-]*\.(?:py|cu|cuh|json|md)"
                     r"|tests/test_torch_\w*\.py)\b")
MODULE_RE = re.compile(r"python3? -m (repro_torch(?:\.\w+)+)")


def doc_files(extra=()):
    files = [ROOT / "README.md", *sorted((ROOT / "docs").glob("*.md"))]
    files += [pathlib.Path(p) for p in extra]
    return [f for f in files if f.exists()]


def extract_snippets(text: str):
    """(line_number, source) of each fenced python block that imports the
    port, its indentation (a block inside a list item) removed."""
    out = []
    for m in FENCE_RE.finditer(text):
        src = m.group(1)
        if not IMPORTS_PORT_RE.search(src):
            continue
        lines = src.splitlines()
        indent = min((len(l) - len(l.lstrip()) for l in lines if l.strip()),
                     default=0)
        line = text[:m.start()].count("\n") + 2   # first line inside fence
        out.append((line, "\n".join(l[indent:] for l in lines)))
    return out


def run_snippets(path: pathlib.Path) -> list[str]:
    failures = []
    for line, src in extract_snippets(path.read_text()):
        ns = {"__name__": "__doc_snippet__"}
        try:
            exec(compile(src, f"{path.name}:{line}", "exec"), ns)
        except Exception:
            failures.append(
                f"{path.name}:{line}: snippet raised\n"
                + "".join(traceback.format_exc(limit=3)))
    return failures


def resolve_symbol(dotted: str) -> bool:
    """Import the longest module prefix of ``dotted``, then walk the
    remaining parts as attributes."""
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        try:
            for attr in parts[i:]:
                obj = getattr(obj, attr)
        except AttributeError:
            return False
        return True
    return False


def lint(path: pathlib.Path) -> list[str]:
    failures = []
    text = path.read_text()
    for dotted in sorted(set(SYMBOL_RE.findall(text))):
        if not resolve_symbol(dotted):
            failures.append(f"{path.name}: `{dotted}` does not resolve "
                            f"(import/getattr failed)")
    for rel in sorted(set(PATH_RE.findall(text))):
        if not (ROOT / rel).exists():
            failures.append(f"{path.name}: referenced file `{rel}` "
                            f"does not exist")
    for mod in sorted(set(MODULE_RE.findall(text))):
        if importlib.util.find_spec(mod) is None:
            failures.append(f"{path.name}: `python -m {mod}` names no "
                            f"module")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tools.run_doc_snippets")
    ap.add_argument("--lint-only", action="store_true")
    ap.add_argument("--snippets-only", action="store_true")
    ap.add_argument("--extra", nargs="*", default=(),
                    help="additional markdown files to check")
    args = ap.parse_args(argv)

    failures = []
    for path in doc_files(args.extra):
        if not args.lint_only:
            failures += run_snippets(path)
        if not args.snippets_only:
            failures += lint(path)
        print(f"checked {path.relative_to(ROOT)}", flush=True)

    for f in failures:
        print(f"FAIL {f}", file=sys.stderr, flush=True)
    n_ok = "all green" if not failures else f"{len(failures)} failure(s)"
    print(f"docs-smoke: {n_ok}")
    return 1 if failures else 0


if __name__ == "__main__":
    # the snippets run on the CPU: a snippet that reaches for the card
    # raises here rather than passing on a machine that has one (set for
    # this process only, before anything initialises CUDA)
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    raise SystemExit(main())
