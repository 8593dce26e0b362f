"""The reference's ``examples/`` as entry points of the port
(``python -m repro_torch.examples.<name>``): ``cws_classification`` (the
paper's whole path), ``quickstart``, ``serve_lm`` and ``train_lm``.  Each
runs on the card unless given ``--device cpu``."""
