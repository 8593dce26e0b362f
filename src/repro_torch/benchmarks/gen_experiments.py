"""The data-driven tables of the dry run and the roofline, as markdown on
stdout (port of ``benchmarks/gen_experiments.py``).

For each production mesh (16 x 16, then 2 x 16 x 16): the dry run's
table (``launch.dryrun.table``: a rank's state + cache bytes, step FLOPs,
collective bytes and calls) and the roofline's (``roofline.
markdown_table`` at the H100's constants).  The reference splices its
tables into an ``EXPERIMENTS.md``; the port keeps its numbers in
``PERF.md``, so this prints and writes nothing.

  PYTHONPATH=src python -m repro_torch.benchmarks.gen_experiments
"""
from __future__ import annotations

from repro_torch.benchmarks import roofline
from repro_torch.launch import dryrun

MESHES = ((False, "16x16", "single pod (16 x 16 = 256 cards)"),
          (True, "2x16x16", "multi-pod (2 x 16 x 16 = 512 cards)"))


def render() -> str:
    c = roofline.constants()
    peaks = (f"H100: {c['PEAK_FLOPS'] / 1e12:,.1f} TFLOP/s bf16, "
             f"{c['HBM_BW'] / 1e12:.2f} TB/s HBM, "
             f"{c['LINK_BW'] / 1e9:.0f} GB/s a card")
    out = []
    for multi_pod, mesh, title in MESHES:
        out += [f"## Dry run — {title}", "",
                dryrun.table(roofline.DRYRUN, multi_pod), ""]
    for multi_pod, mesh, title in MESHES:
        out += [f"## Roofline — {title} ({peaks})", "",
                roofline.markdown_table(mesh), ""]
    return "\n".join(out)


def main() -> str:
    text = render()
    print(text)
    return text


if __name__ == "__main__":
    main()
