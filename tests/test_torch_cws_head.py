"""Port parity: the CWS classifier head on an LM backbone.

The reference's CWS parameters and a random table are carried across;
features are made with numpy (negative entries included, which the head's
ReLU drops).  The hash codes (bag indices) must match exactly, as the CWS
kernels' plain versions do elsewhere; the logits are fp32 sums of k table
rows in another order: ``rtol = atol = 1e-5``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import cws_head as ref_head  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels import cws_hash  # noqa: E402
from repro_torch.models import cws_head as t_head  # noqa: E402

TOL = 1e-5


def _heads(d, k, b_i, n_classes, seed):
    ref = ref_head.init_cws_head(jax.random.PRNGKey(seed), d, k=k, b_i=b_i,
                                 n_classes=n_classes)
    table = np.random.default_rng(seed).standard_normal(
        (k, 1 << b_i, n_classes)).astype(np.float32)
    bias = np.arange(n_classes, dtype=np.float32) * 0.1
    ref = ref._replace(table=jnp.asarray(table), bias=jnp.asarray(bias))
    port = t_head.CWSHeadParams(
        cws=interop.cws_params(*(np.asarray(a) for a in (
            ref.cws.r, ref.cws.log_c, ref.cws.beta)), device="cpu"),
        table=torch.from_numpy(table), bias=torch.from_numpy(bias))
    return ref, port


@pytest.mark.parametrize("b_i", [4, 8])
def test_cws_head_logits_match_reference(b_i):
    d, k, n_classes = 48, 64, 5
    ref, port = _heads(d, k, b_i, n_classes, seed=b_i)
    rng = np.random.default_rng(b_i)
    hidden = rng.standard_normal((3, 7, d)).astype(np.float32)
    hidden[2] = -np.abs(hidden[2])          # pools to an all-zero row
    feats_ref = ref_head.pool_hidden(jnp.asarray(hidden))
    feats = t_head.pool_hidden(torch.from_numpy(hidden))
    np.testing.assert_allclose(feats.numpy(), np.asarray(feats_ref),
                               rtol=TOL, atol=TOL)

    cws_hash.reset_launches()
    idx_ref = ref_head.head_pipeline(ref, b_i=b_i).features(
        jax.nn.relu(feats_ref))
    idx = t_head.head_pipeline(port, b_i=b_i).features(torch.relu(feats))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    want = ref_head.cws_head_logits(ref, feats_ref, b_i=b_i)
    got = t_head.cws_head_logits(port, feats, b_i=b_i)
    assert got.shape == (3, n_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    # the CPU path runs the plain versions: no kernel launch
    assert cws_hash.LAUNCHES == dict.fromkeys(cws_hash.LAUNCHES, 0)


def test_init_cws_head_shapes():
    head = t_head.init_cws_head(torch.Generator().manual_seed(0), 32, k=16,
                                b_i=3, n_classes=4)
    assert tuple(head.cws.r.shape) == (32, 16)
    assert tuple(head.table.shape) == (16, 8, 4)
    assert not head.table.any() and not head.bias.any()
