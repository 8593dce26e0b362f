"""Train an LM from the assigned-architecture pool with the full
production stack: FSDP x TP sharding rules, gradient accumulation, async
checkpointing, watchdog, restart-on-failure (port of
``examples/train_lm.py``: it hands over to ``repro_torch.launch.train``).

The smoke config is the default; on more cards pass ``--variant full``
and a mesh under ``torchrun`` (``python -m repro_torch.launch.dryrun``
counts the 16x16 / 2x16x16 meshes).

    PYTHONPATH=src python -m repro_torch.examples.train_lm \
        --arch starcoder2_7b --steps 100 --ckpt-dir /tmp/ckpt [--device cpu]
"""
from __future__ import annotations

from repro_torch.launch.train import main as train_main


def main(argv=None):
    return train_main(argv)


if __name__ == "__main__":
    main()
