"""The arithmetic of the flash kernels' tensor-core body (rows 8 and 9 in
bf16, ``csrc/flash_attention_wgmma.cu``), emulated tile by tile.

The CUDA body runs only on the card, where ``chip_smoke.py`` holds it
against the plain version.  Here a plain emulation of its arithmetic
(defined in this file, not in the package) shows that the design keeps
the reference's function within the tolerances the port states: bf16 q,
k and v; products exact in fp32 (bf16 x bf16 fits fp32's mantissa);
64-row q tiles, each walking only the 64-key tiles its rows can see, in
ascending order; the finite -1e30 mask; the online softmax in fp32; p
split into bf16 hi = bf16(p) and lo = bf16(p - hi), each multiplied by v
and summed in fp32; l the sum of the fp32 p; row 9 adding p = 0 for a
masked key.  The emulation is held against the port's plain versions and
the JAX package's Pallas kernels (interpret mode, small blocks), on inputs
made with numpy from seeds.

Tolerances are the port's bf16 ones, unchanged: an output within
``2e-5 + 2^-7 |out|`` (the fp32 results round once to bf16, so two results
a few 1e-7 apart may land one bf16 ulp apart), the carry's m and l within
``2e-5 (1 + |x|)``.  Against the JAX kernel the carry is compared where a
row has seen a key (the reference keeps tile-dependent l and acc in a row
that has not; ``test_torch_ring_attention.py`` says why).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_fwd as ref_fwd, flash_attention_step as ref_step)
from repro_torch.kernels import flash_attention as fa  # noqa: E402

TOL = 2e-5
BF16_ULP = 2.0 ** -7
NEG_INF = -1e30
TILE = 64
BLOCK = 32


def _qkv(seed, b, sq, sk, h, g, d):
    """bf16 q (b, sq, h, d), k and v (b, sk, g, d) from N(0, 1) draws."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s, np.float32)).to(
        torch.bfloat16) for s in ((b, sq, h, d), (b, sk, g, d), (b, sk, g, d)))


def _tiles(i0, i1, sk, window, q_base, k_base):
    """The 64-key tiles rows [i0, i1) can see, as the kernel walks them."""
    q_first, q_last = i0 + q_base, i1 - 1 + q_base
    k_end = min(sk, q_last + 1 - k_base)
    k_begin = max(0, q_first - window + 1 - k_base) if window > 0 else 0
    return range(k_begin // TILE, -(-k_end // TILE) if k_end > 0 else 0)


def _split(p, lo_term):
    hi = p.to(torch.bfloat16).float()
    if not lo_term:
        return hi, torch.zeros_like(p)
    return hi, (p - hi).to(torch.bfloat16).float()


def _emulate(q, k, v, carry, *, window, q_base, k_base, masked_p_zero,
             lo_term=True):
    """The body's arithmetic on (b, sq, h, d) q and (b, sk, g, d) k, v:
    the updated fp32 carry (m, l of shape (b, sq, h, 1), acc (b, sq, h,
    d))."""
    b, sq, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    r = h // g
    qf = q.float()
    kf = k.float().repeat_interleave(r, dim=2)     # (b, sk, h, d)
    vf = v.float().repeat_interleave(r, dim=2)
    m, l, acc = (t.clone() for t in carry)
    scale = d ** -0.5
    for i0 in range(0, sq, TILE):
        i1 = min(i0 + TILE, sq)
        qt = qf[:, i0:i1].permute(0, 2, 1, 3)      # (b, h, rows, d)
        mt = m[:, i0:i1, :, 0].permute(0, 2, 1)     # (b, h, rows)
        lt = l[:, i0:i1, :, 0].permute(0, 2, 1)
        at = acc[:, i0:i1].permute(0, 2, 1, 3)
        pos = torch.arange(i0, i1)[:, None] + q_base
        for t in _tiles(i0, i1, sk, window, q_base, k_base):
            j = torch.arange(t * TILE, (t + 1) * TILE)
            inside = j < sk
            kt = torch.zeros(b, h, TILE, d)
            vt = torch.zeros(b, h, TILE, d)
            kt[:, :, inside] = kf[:, j[inside]].permute(0, 2, 1, 3)
            vt[:, :, inside] = vf[:, j[inside]].permute(0, 2, 1, 3)
            jg = j[None, :] + k_base
            ok = inside[None, :] & (jg <= pos)
            if window > 0:
                ok &= jg > pos - window
            s = torch.where(ok, (qt @ kt.transpose(-1, -2)) * scale,
                            torch.tensor(NEG_INF))
            m_new = torch.maximum(mt, s.amax(-1))
            corr = torch.exp(mt - m_new)
            p = torch.exp(s - m_new[..., None])
            if masked_p_zero:
                p = torch.where(ok, p, torch.zeros(()))
            hi, lo = _split(p, lo_term)
            lt = corr * lt + p.sum(-1)
            at = corr[..., None] * at + hi @ vt + lo @ vt
            mt = m_new
        m[:, i0:i1, :, 0] = mt.permute(0, 2, 1)
        l[:, i0:i1, :, 0] = lt.permute(0, 2, 1)
        acc[:, i0:i1] = at.permute(0, 2, 1, 3)
    return m, l, acc


def emulate_fwd(q, k, v, *, window=0, q_base=0, lo_term=True):
    """Row 8: acc / max(l, 1e-30) in fp32, before the output's rounding."""
    b, sq, h, d = q.shape
    m, l, acc = _emulate(q, k, v, fa.init_carry(b, sq, h, d, "cpu"),
                         window=window, q_base=q_base, k_base=0,
                         masked_p_zero=False, lo_term=lo_term)
    return acc / l.clamp_min(1e-30)


def emulate_step(q, k, v, carry, *, q_base, k_base, window=0):
    b, sq, h, d = q.shape
    if carry is None:
        carry = fa.init_carry(b, sq, h, d, "cpu")
    return _emulate(q, k, v, carry, window=window, q_base=q_base,
                    k_base=k_base, masked_p_zero=True)


def _out_ratio(got, want):
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (TOL + BF16_ULP * want.abs())).max())


def _carry_ratio(got, want):
    return max(float(((g - w).abs() / (TOL * (1 + w.abs()))).max())
               for g, w in zip(got[:2], want[:2]))


def _ref_fwd(q, k, v, *, window, q_base):
    j = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
         for t in (q, k, v)]
    out = ref_fwd(*j, window=window, blk_q=BLOCK, blk_k=BLOCK,
                  interpret=True,
                  q_base=None if q_base == 0 else jnp.int32(q_base))
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


# (b, sq, sk, h, g, d, window, q_base): r = h / g in {1, 2, 9}, D in {64,
# 128}, ragged lengths (not multiples of the 64-key tile), windows 0 and
# 32, q rows at a global offset against longer k/v
FWD_CASES = [
    (1, 100, 100, 2, 2, 64, 0, 0),
    (2, 70, 70, 4, 2, 128, 32, 0),
    (1, 90, 90, 9, 1, 64, 0, 0),
    (1, 90, 90, 9, 1, 128, 32, 0),
    (1, 40, 130, 4, 2, 64, 32, 90),
    (1, 50, 150, 2, 1, 128, 0, 100),
]


@pytest.mark.parametrize("case", FWD_CASES)
def test_fwd_emulation_matches_plain_and_reference(case):
    b, sq, sk, h, g, d, w, qb = case
    q, k, v = _qkv(sum(case), b, sq, sk, h, g, d)
    got = emulate_fwd(q, k, v, window=w, q_base=qb).to(torch.bfloat16)
    plain = fa.flash_attention_fwd_plain(q, k, v, window=w, q_base=qb)
    assert _out_ratio(got, plain) <= 1
    assert _out_ratio(got, _ref_fwd(q, k, v, window=w, q_base=qb)) <= 1


@pytest.mark.parametrize("case", FWD_CASES[:4])
def test_hi_lo_split_is_ten_times_closer_than_one_bf16_p(case):
    """In fp32, before the output's rounding, against the plain version on
    the same (bf16-valued) inputs: the split's worst error is at least
    10x smaller than that of one bf16 p without the lo term."""
    b, sq, sk, h, g, d, w, qb = case
    q, k, v = _qkv(sum(case) + 1, b, sq, sk, h, g, d)
    want = fa.flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                        window=w, q_base=qb)
    split = float((emulate_fwd(q, k, v, window=w, q_base=qb) -
                   want).abs().max())
    single = float((emulate_fwd(q, k, v, window=w, q_base=qb,
                                lo_term=False) - want).abs().max())
    assert single >= 10 * split, (split, single)


# (b, sq a shard, shards, h, g, d, window): each virtual rank's chain over
# the shards in ring order (shard (me - s) mod n at step s)
CHAIN_CASES = [
    (1, 64, 4, 4, 2, 64, 0),
    (1, 64, 4, 9, 1, 64, 32),
    (2, 64, 4, 2, 2, 128, 32),
]


@pytest.mark.parametrize("case", CHAIN_CASES)
def test_step_chain_matches_plain_and_reference(case):
    b, sl, n, h, g, d, w = case
    q, k, v = _qkv(sum(case), b, n * sl, n * sl, h, g, d)
    for me in range(n):
        ql = q[:, me * sl:(me + 1) * sl]
        mine, ref = None, None
        for step in range(n):
            j = (me - step) % n
            ks, vs = (t[:, j * sl:(j + 1) * sl] for t in (k, v))
            args = dict(q_base=me * sl, k_base=j * sl, window=w)
            got = emulate_step(ql, ks, vs, mine, **args)
            plain = fa.flash_attention_step_plain(ql, ks, vs, mine, **args)
            assert _carry_ratio(got, plain) <= 1
            assert _out_ratio(fa.finalize(got, torch.bfloat16)[0],
                              fa.finalize(plain, torch.bfloat16)[0]) <= 1
            ref = ref_step(*(jnp.asarray(t.float().numpy()).astype(
                jnp.bfloat16) for t in (ql, ks, vs)), ref,
                q_base=me * sl, k_base=j * sl, window=w, blk_q=BLOCK,
                blk_k=BLOCK, interpret=True)
            mine = got
        # after the whole chain every row has seen a key: the carries agree
        # everywhere, and so do the finalized outputs
        want = tuple(torch.from_numpy(np.array(t)) for t in ref)
        assert _carry_ratio(mine, want) <= 1
        assert _out_ratio(fa.finalize(mine, torch.bfloat16)[0],
                          fa.finalize(want, torch.bfloat16)[0]) <= 1


@pytest.mark.parametrize("window", [0, 32])
def test_masked_step_returns_its_carry_bit_for_bit(window):
    """A shard no row can see walks no tile; in a shard some rows of a tile
    see, the rows that see none add p = 0 and keep their carry exactly."""
    b, sl, h, g, d = 1, 64, 4, 2, 64
    q, k, v = _qkv(7 + window, b, 3 * sl, 3 * sl, h, g, d)
    ql = q[:, sl:2 * sl]
    carry = emulate_step(ql, k[:, :sl], v[:, :sl], None, q_base=sl,
                         k_base=0, window=window)
    later = emulate_step(ql, k[:, 2 * sl:], v[:, 2 * sl:], carry, q_base=sl,
                         k_base=2 * sl, window=window)
    assert all(torch.equal(a, c) for a, c in zip(later, carry))
    # keys 32..95 from q rows 64..127 (window 32 for rows 64..): rows that
    # see none of them keep the carry; the tile is walked all the same
    if window:
        part = emulate_step(ql, k[:, 32:96], v[:, 32:96], carry, q_base=sl,
                            k_base=32, window=window)
        pos = torch.arange(sl, 2 * sl)
        blind = pos - window + 1 > 95
        assert blind.any() and (~blind).any()
        for a, c in zip(part, carry):
            assert torch.equal(a[:, blind], c[:, blind])
