"""Port parity: flash attention (TPU kernel table row 8).

The port's ``flash_attention_fwd`` on CPU tensors runs its plain version
(``chip_smoke.py`` holds the CUDA kernel against that on the card); here
it is compared with the reference's Pallas kernel in interpret mode on
the same inputs, made with numpy.

Tolerances.  Both sides compute the scores, the softmax and p . v in
fp32; only the order of the sums differs (the reference walks k tiles of
``block`` keys with an online softmax, the port's plain version takes each
row at once).  With N(0, 1) inputs and D <= 128 the outputs are O(1), and
reordered fp32 sums of a few hundred terms differ by a few 1e-7: the fp32
bound is ``atol = rtol = 1e-5``.  In bf16 the inputs round identically
(round-to-nearest-even in both) and the fp32 results then round once to
bf16, so two results a few 1e-7 apart can land one bf16 ulp apart: at most
2^-7 relative (one ulp at the bottom of a binade), plus the fp32 term.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import flash_attention_fwd as ref_flash  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, registry  # noqa: E402

FP32_TOL = 1e-5
BF16_ULP = 2.0 ** -7

# the reference test's CASES (tests/test_flash_attention.py):
# (b, s, h, g, d, window, block)
CASES = [
    (1, 64, 4, 2, 16, 0, 32),
    (2, 128, 4, 1, 32, 0, 64),
    (1, 96, 6, 3, 16, 0, 32),       # non-divisible seq vs block
    (2, 128, 4, 4, 16, 32, 32),     # sliding window, MHA
    (1, 256, 8, 2, 64, 64, 64),     # sliding window, GQA
    (1, 64, 2, 2, 128, 0, 64),      # wide head dim
]


def _inputs(seed, b, sq, sk, h, g, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, g, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, g, d)).astype(np.float32)
    return q, k, v


def _both(q, k, v, *, window, block, dtype, q_base=0):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    want = ref_flash(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                     window=window, blk_q=block, blk_k=block,
                     interpret=True,
                     q_base=None if q_base == 0 else jnp.int32(q_base))
    got = fa.flash_attention_fwd(*(torch.from_numpy(a).to(tdt)
                                   for a in (q, k, v)),
                                 window=window, q_base=q_base)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


def _check(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=FP32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,g,d,window,block", CASES)
def test_plain_matches_reference_kernel(b, s, h, g, d, window, block, dtype):
    q, k, v = _inputs(b * 100 + s, b, s, s, h, g, d)
    got, want = _both(q, k, v, window=window, block=block, dtype=dtype)
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 48])
def test_q_base_offsets_global_mask(window, dtype):
    """A q shard at global offset q_base (Sq < Sk) against the full k/v:
    the reference kernel and the port agree, and the port's shard equals
    its slice of the full-sequence result."""
    b, s, h, g, d, blk = 1, 128, 4, 2, 16, 32
    q, k, v = _inputs(11, b, s, s, h, g, d)
    tdt = getattr(torch, dtype)
    full = fa.flash_attention_fwd(*(torch.from_numpy(a).to(tdt)
                                    for a in (q, k, v)), window=window)
    for lo in (32, 96):
        got, want = _both(q[:, lo:lo + 32], k, v, window=window, block=blk,
                          dtype=dtype, q_base=lo)
        _check(got, want, dtype)
        np.testing.assert_array_equal(got, full[:, lo:lo + 32].float().numpy())


def test_ragged_gqa_ratio_and_window_longer_than_sequence():
    """Sq not a multiple of any tile, 6 query heads over one kv head, and
    a window longer than the sequence (the same as causal)."""
    q, k, v = _inputs(5, 2, 75, 75, 6, 1, 24)
    got, want = _both(q, k, v, window=500, block=32, dtype="float32")
    _check(got, want, "float32")
    causal = fa.flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_array_equal(got, causal.numpy())


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    fa.reset_launches()
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 1, 40, 40, 4, 2, 8))
    out = ops.flash_attention(q, k, v, window=16)
    assert torch.equal(out, fa.flash_attention_fwd_plain(q, k, v, window=16))
    assert fa.LAUNCHES == {"flash_attention_fwd": 0,
                           "flash_attention_step": 0}


def test_registry_picks_the_kernel_by_device():
    assert registry.resolve("flash_attention", torch.device("cpu")) is \
        fa.flash_attention_fwd_plain
    assert registry.resolve("flash_attention", torch.device("cuda", 0)) is \
        fa.flash_attention_fwd_cuda


def test_cuda_launcher_refuses_cpu_tensors_instead_of_falling_back():
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 1, 8, 8, 2, 1, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_fwd_cuda(q, k, v)
    assert fa.LAUNCHES["flash_attention_fwd"] == 0


def test_cuda_tensor_without_a_card_raises(monkeypatch):
    """With no card, asking for CUDA raises; nothing runs on the CPU in its
    place."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_caches, init_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("gemma3_12b", "smoke")
    with pytest.raises(RuntimeError, match="not available"):
        init_model(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_caches(cfg, 1, 8)
    with pytest.raises((RuntimeError, AssertionError)):
        ops.flash_attention(*(torch.zeros(1, 8, 2, 8, device="cuda")
                              for _ in range(3)))


@pytest.mark.parametrize("shapes,match", [
    (((1, 8, 3, 8), (1, 8, 2, 8), (1, 8, 2, 8)), "group"),
    (((1, 8, 4, 8), (1, 8, 2, 8), (1, 9, 2, 8)), "differ"),
    (((1, 8, 4, 8), (2, 8, 2, 8), (2, 8, 2, 8)), "batch"),
    (((8, 4, 8), (1, 8, 2, 8), (1, 8, 2, 8)), "B, Sq, H, D"),
])
def test_bad_shapes_raise(shapes, match):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_fwd(q, k, v)


@pytest.mark.parametrize("dtype,d,body", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 192, "wgmma"), (torch.bfloat16, 256, "wgmma"),
    (torch.bfloat16, 16, "simt"), (torch.bfloat16, 32, "simt"),
    (torch.bfloat16, 96, "simt"), (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt"), (torch.float32, 256, "simt"),
])
def test_flash_body_table(dtype, d, body):
    """bf16 at the full configs' head dims runs on the tensor cores; fp32
    and every other head dim on the SIMT body."""
    assert fa.flash_body(dtype, d) == body


def test_tma_refuses_misaligned_tensors():
    """The wgmma body reads q, k and v by TMA: a base pointer or a row
    stride that is not a multiple of 16 bytes raises, and no copy is made
    to hide it."""
    buf = torch.zeros(4096, dtype=torch.bfloat16)
    fa.check_tma("q", buf[:2 * 8 * 64].view(1, 8, 2, 64))
    with pytest.raises(ValueError, match="16-byte"):
        fa.check_tma("q", buf[1:1 + 2 * 8 * 64].view(1, 8, 2, 64))
    with pytest.raises(ValueError, match="16-byte"):
        fa.check_tma("k", buf[:8 * 12].view(1, 8, 1, 12))


def test_forcing_a_body_that_does_not_take_the_inputs_raises():
    with pytest.raises(ValueError, match="does not take"):
        fa._pick_body("wgmma", torch.float32, 128)
    with pytest.raises(ValueError, match="does not take"):
        fa._pick_body("wgmma", torch.bfloat16, 32)
    with pytest.raises(ValueError, match="does not take"):
        fa._pick_body("tensor", torch.bfloat16, 64)
    assert fa._pick_body(None, torch.bfloat16, 64) == "wgmma"
    assert fa._pick_body("simt", torch.bfloat16, 64) == "simt"


def test_cpu_tensors_count_no_body_launch():
    """bf16 at D = 64, which a card would run on the wgmma body, runs the
    plain version on CPU tensors and counts no launch of either body."""
    fa.reset_launches()
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(4, 1, 40, 40, 4, 2, 64))
    ops.flash_attention(q, k, v, window=16)
    fa.flash_attention_step(q, k, v, None, q_base=0, k_base=0)
    assert fa.BODY_LAUNCHES == {"wgmma": 0, "simt": 0}
    assert fa.LAUNCHES == {"flash_attention_fwd": 0,
                           "flash_attention_step": 0}
