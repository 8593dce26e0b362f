"""Port parity: the LM train step against the reference's
``make_train_step(cfg, hp, None)`` on ``gemma3_12b`` smoke with flash
attention in 2 microbatches, with int8 compression, and with bf16 masters
(stochastic rounding).  The check and its tolerances are
``tests/test_torch_lm_train.py``'s; these variants run from a file of
their own so that test workers share the work.
"""
import pytest

from test_torch_lm_train import (HERE, VARIANTS, check_train_steps,  # noqa: F401
                                 few_threads)


@pytest.mark.parametrize("variant",
                         sorted(v for v in VARIANTS if v not in HERE))
def test_train_steps_track_the_reference(variant):
    check_train_steps(variant)
