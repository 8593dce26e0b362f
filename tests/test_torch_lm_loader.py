"""Port parity: the restartable batch loaders (``repro_torch.data.loader``)
against the reference's (``repro.data.loader``), bit for bit: the token
loader across seeds, global batches and process slices, the feature
loader across seeds, and both through snapshot / restore."""
import numpy as np
import pytest

from repro.data import loader as ref
from repro.data import synthetic as ref_synthetic
from repro_torch.data import loader as port
from repro_torch.data import synthetic as port_synthetic


def _take(ld, n):
    return [next(ld) for _ in range(n)]


def _same(a, b):
    assert len(a) == len(b)
    for (x1, y1), (x2, y2) in zip(a, b):
        assert x1.dtype == x2.dtype and y1.dtype == y2.dtype
        np.testing.assert_array_equal(x1, x2)
        np.testing.assert_array_equal(y1, y2)


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 - 1])
@pytest.mark.parametrize("vocab,batch,seq", [(100, 4, 16), (262144, 2, 64),
                                             (49152, 8, 33)])
def test_token_batches_equal_the_reference(seed, vocab, batch, seq):
    kw = dict(vocab=vocab, global_batch=batch, seq_len=seq, seed=seed)
    got = _take(port.TokenBatchLoader(**kw), 4)
    _same(got, _take(ref.TokenBatchLoader(**kw), 4))
    for toks, labels in got:
        assert toks.shape == (batch, seq) and toks.dtype == np.int32
        assert ((toks >= 0) & (toks < vocab)).all()
        np.testing.assert_array_equal(toks[:, 1:], labels[:, :-1])


@pytest.mark.parametrize("count", [2, 4])
def test_token_process_slices_equal_the_reference(count):
    for index in range(count):
        kw = dict(vocab=1000, global_batch=8, seq_len=24, seed=5,
                  process_index=index, process_count=count)
        lp = port.TokenBatchLoader(**kw)
        assert lp.local_batch == 8 // count
        _same(_take(lp, 3), _take(ref.TokenBatchLoader(**kw), 3))


def test_token_snapshot_restore_across_packages():
    kw = dict(vocab=100, global_batch=4, seq_len=16, seed=3)
    a = port.TokenBatchLoader(**kw)
    _take(a, 5)
    snap = a.snapshot()
    assert snap == {"step": 5, "seed": 3}
    rest = _take(a, 3)
    for cls in (port.TokenBatchLoader, ref.TokenBatchLoader):
        b = cls(**kw)
        b.restore(snap)
        _same(_take(b, 3), rest)
    r = ref.TokenBatchLoader(**kw)
    _take(r, 5)
    assert r.snapshot() == snap
    with pytest.raises(AssertionError, match="seed"):
        port.TokenBatchLoader(**{**kw, "seed": 4}).restore(snap)


@pytest.mark.parametrize("seed", [0, 11])
def test_feature_batches_and_restore_equal_the_reference(seed):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((50, 7)).astype(np.float32)
    y = rng.integers(0, 3, 50).astype(np.int32)
    lp = port.FeatureBatchLoader(x, y, batch_size=9, seed=seed)
    lr = ref.FeatureBatchLoader(x, y, batch_size=9, seed=seed)
    _same(_take(lp, 4), _take(lr, 4))
    snap = lp.snapshot()
    assert snap == lr.snapshot() == {"step": 4, "seed": seed}
    rest = _take(lp, 2)
    b = port.FeatureBatchLoader(x, y, batch_size=9, seed=seed)
    b.restore(snap)
    _same(_take(b, 2), rest)
    _same(_take(lr, 2), rest)


@pytest.mark.parametrize("seed,vocab,length", [(0, 100, 1000),
                                               (7, 262144, 4096),
                                               (2 ** 31 - 1, 49152, 333)])
def test_token_stream_equals_the_reference(seed, vocab, length):
    got = port_synthetic.token_stream(seed, vocab, length)
    want = ref_synthetic.token_stream(seed, vocab, length)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
