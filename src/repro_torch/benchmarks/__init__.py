"""The paper's benchmarks as PyTorch twins of the reference's
``benchmarks/*.py`` (Tables 1-2, Figures 4-8), one module per script.

Each twin keeps its script's sizes, keys, seeds, ``--fast`` reductions,
CSV rows and JSON keys, and draws the reference's own data
(``data.synthetic``, ``core.cws.make_cws_params_jax``).
Its ``run(fast, device=, out=)`` saves the JSON records (plus ``device``,
``draws`` and ``fast`` entries) and returns them by record name;
``check_claims(records)`` asserts the script's paper claims with their
thresholds.  ``python -m repro_torch.benchmarks.run`` drives them.
``reference/`` holds the reference's own ``--fast`` records, which the
twins are held against.
"""
