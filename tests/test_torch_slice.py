"""The whole ported slice at small width, against the JAX reference.

``repro`` builds and exports a served model (the paper config's smoke
width: D = 32, k = 64, 4 classes); the port boots
``ServingService.from_bundle(..., device="cpu")`` on it with the default
bucket ladder and serves synthetic traffic through its gateway.  Each
response is held against ``repro``'s offline
``bag_logits(params, pipe.features(x))`` (rtol 1e-5 / atol 1e-6: float32
sums of k gathered rows in another order), and the port's features of the
same rows against ``repro``'s exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.minmax_paper import SMOKE
from repro.core import linear_model as jlm
from repro.pipeline import FeaturePipeline as JPipe
from repro.pipeline import FeatureSpec as JSpec
from repro.serving import save_bundle as jsave
from repro_torch.kernels import registry
from repro_torch.launch.serve import synthetic_rows
from repro_torch.serving import ServingService

# (mode, packed, b_i): the four bundle modes the serving path reaches
MODES = [("regen", False, SMOKE.b_i), ("stored", False, SMOKE.b_i),
         ("regen", True, 8), ("stored", True, SMOKE.b_i)]


@pytest.mark.parametrize("mode,packed,b_i", MODES)
def test_served_slice_matches_reference_offline(mode, packed, b_i,
                                                tmp_path):
    spec = JSpec(num_hashes=SMOKE.num_hashes, b_i=b_i, packed=packed)
    make = JPipe.create if mode == "stored" else JPipe.create_regen
    jpipe = make(jax.random.PRNGKey(5), SMOKE.dim, spec)
    rng = np.random.default_rng(17)
    jparams = jlm.LinearParams(
        jnp.asarray(0.1 * rng.standard_normal(
            (jpipe.num_features, SMOKE.n_classes)), jnp.float32),
        jnp.asarray(0.1 * rng.standard_normal(SMOKE.n_classes),
                    jnp.float32))
    jsave(tmp_path / "model", jparams, jpipe)

    xs = [synthetic_rows(rng, int(rng.integers(1, 49)), SMOKE.dim)
          for _ in range(16)]
    xs[3][:] = 0.0                                  # an all-zero request
    with ServingService.from_bundle(tmp_path / "model",
                                    device="cpu") as svc:
        assert svc.runner.buckets == registry.DEFAULT_SERVE_BUCKETS
        futs = [svc.submit(x) for x in xs]
        served = [f.result(timeout=60) for f in futs]
        pipe = svc.runner.pipe
        stats = svc.stats()
    assert stats["completed"] == len(xs)
    assert stats["compile_count"] == len(registry.DEFAULT_SERVE_BUCKETS)
    # the reference scores all rows in one call (rows are independent),
    # so it compiles once instead of once per request size
    x_all = np.concatenate(xs)
    jfeats = jpipe.features(jnp.asarray(x_all))
    if packed:
        want = jlm.bag_logits_packed(jparams, jfeats,
                                     num_hashes=spec.num_hashes, b=spec.bits)
    else:
        want = jlm.bag_logits(jparams, jfeats)
    np.testing.assert_allclose(np.concatenate(served), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(pipe.features(x_all).numpy(),
                                  np.asarray(jfeats))
