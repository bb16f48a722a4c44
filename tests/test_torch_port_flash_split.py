"""The arithmetic of the tensor-core flash kernels (``kernels/csrc/
flash_mma.cuh``), emulated in PyTorch on the CPU and held against float64.

* float32 operands run 3xTF32: x = hi + lo with hi = x rounded to TF32 (10
  mantissa bits, to nearest even, as ``cvt.rn.tf32.f32`` rounds; done here
  by bit masking) and lo = x - hi, which the tensor core truncates to TF32;
  a product is lo*hi + hi*lo + hi*hi, float32 sums.
* bfloat16 operands: their products are exact in float32; the float32
  probabilities P (and dS^T) enter their products as two bf16 terms,
  hi = bf16(p), lo = bf16(p - hi).

Checks: (a) the emulated 3xTF32 forward (o, lse), dq and dkv (dk, dv) are
within twice the plain float32 version's error against float64; (b) the
emulated bf16 kernels' outputs equal the plain version's bf16 outputs to
within one bf16 unit in the last place; (c) both hold where q and k are four
times larger and the softmax is nearly one-hot. A single bf16 term for P
(and P^T, dS, dS^T) fails (b), and a single TF32 term fails (a) by far: both
are checked, so the tests can tell. Shapes (1,2,256,64) and (1,1,256,32); no
card.

The float32 sums here round to nearest. The tensor cores add into their
accumulators with truncation, which the kernels counter with partial sums of
32 keys; that is held on the card by ``chip_smoke.py``, not here.

The float32 forward and dkv at D = 64 and 128, and dq at D = 64, run on
wgmma, on the planes of the split pass
(``kernels.flash_attention.flash_split``, one pass per backward call for
dq and dkv): hi rounded to TF32 to nearest as above (left to the tensor
core's truncation, the forward and dkv land at up to 3.3 times the plain
version's error on these cases, outside the gate), the sums over keys
(queries in dkv) in partials of 32. Their emulation is held to the same
gate with its one-term control, and the split pass's plain version is
pinned: the backward's fourteen planes in order, transposition and the
order of each 8 rows, inverted back to the operands bit for bit.
"""

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one intra-op thread)
from pai_tpu_torch.kernels import flash_attention as fa

LOG2E = 1.4426950408889634
BLOCK_K = 64  # the forward kernel's K/V tile at D = 32 and 64


def tf32_round(x):
    """x rounded to TF32 as cvt.rn.tf32.f32 rounds a finite float32: to
    nearest, ties to the even neighbour."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x0FFF + ((bits >> 13) & 1)) & -0x2000).view(
        torch.float32)


def tf32_truncate(x):
    """What the tensor core reads of a float32 passed as TF32."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split_tf32(x):
    hi = tf32_round(x)
    return hi, tf32_truncate(x - hi)


def mm_3xtf32(a, b):
    """a @ b as the kernels' three TF32 terms, small ones first."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo)) \
        + torch.matmul(a_hi, b_hi)


def split_bf16(p):
    hi = p.bfloat16().float()
    return hi, (p - hi).bfloat16().float()


def mm_split_p(p, b):
    """P @ b for float32 P and bf16-exact b: two bf16 terms of P."""
    hi, lo = split_bf16(p)
    return torch.matmul(lo, b) + torch.matmul(hi, b)


def mm_single_p(p, b):
    return torch.matmul(p.bfloat16().float(), b)


def emulate_forward(q, k, v, mm_qk, mm_pv, block_k=BLOCK_K):
    """The forward kernel's loop: S per K/V tile of `block_k` keys in log2
    units, online softmax from m = -inf, O += P V; returns (o float32,
    lse)."""
    b, h, t, d = q.shape
    scale = LOG2E / d ** 0.5
    m = torch.full((b, h, t, 1), float("-inf"))
    l = torch.zeros((b, h, t, 1))
    acc = torch.zeros((b, h, t, d))
    for k0 in range(0, t, block_k):
        s = mm_qk(q, k[:, :, k0:k0 + block_k].transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + mm_pv(p, v[:, :, k0:k0 + block_k])
        m = m_new
    lse = (m + torch.log2(l)) / LOG2E
    return acc / l, lse.reshape(b * h, t)


def emulate_dq(q, k, v, do, lse, delta, mm_qk, mm_dsk, block_k=None):
    """The dq kernel: per key tile of `block_k` keys (all of them by
    default) S = Q K^T, dP = dO V^T, P, dS, then dQ += dS K (dS straight
    from the accumulator, as the A operand), dQ times s^2 at the end."""
    b, h, t, d = q.shape
    block_k = block_k or t
    lse2 = lse.reshape(b, h, t, 1) * LOG2E
    acc = torch.zeros((b, h, t, d))
    for k0 in range(0, t, block_k):
        kt, vt = k[:, :, k0:k0 + block_k], v[:, :, k0:k0 + block_k]
        s = mm_qk(q, kt.transpose(-1, -2))
        dp = mm_qk(do, vt.transpose(-1, -2))
        p = torch.exp2(s * (LOG2E / d ** 0.5) - lse2)
        ds = p * (dp - delta.reshape(b, h, t, 1))
        acc = acc + mm_dsk(ds, kt)
    return acc * d ** -0.5


def emulate_dkv(q, k, v, do, lse, delta, mm_kq, mm_pd):
    """The dkv kernel: S^T = K Q^T, dP^T = V dO^T, P^T, dS^T, then
    dV = P^T dO and dK = s^2 dS^T Q."""
    b, h, t, d = q.shape
    st = mm_kq(k, q.transpose(-1, -2))
    dpt = mm_kq(v, do.transpose(-1, -2))
    lse2 = lse.reshape(b, h, 1, t) * LOG2E
    pt = torch.exp2(st * (LOG2E / d ** 0.5) - lse2)
    dst = pt * (dpt - delta.reshape(b, h, 1, t))
    return mm_pd(dst, q) * d ** -0.5, mm_pd(pt, do)


def reference64(q, k, v, do):
    """(o, lse, dk, dv, dq) in float64 by the definitions."""
    q, k, v, do = (x.double() for x in (q, k, v, do))
    b, h, t, d = q.shape
    logits = torch.matmul(q, k.transpose(-1, -2)) * d ** -0.5
    lse = torch.logsumexp(logits, -1, keepdim=True)
    p = torch.exp(logits - lse)
    o = torch.matmul(p, v)
    delta = (do * o).sum(-1, keepdim=True)
    ds = p * (torch.matmul(do, v.transpose(-1, -2)) - delta)
    dk = torch.matmul(ds.transpose(-1, -2), q) * d ** -0.5
    dv = torch.matmul(p.transpose(-1, -2), do)
    dq = torch.matmul(ds, k) * d ** -0.5
    return o, lse.reshape(b * h, t), dk, dv, dq


def inputs(shape, seed, peak):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.normal(0.0, 1.0, shape).astype(
        np.float32)) for _ in range(4))
    return q * peak, k * peak, v, do


def max_err(x, ref):
    return float((x.double() - ref).abs().max())


CASES = [((1, 2, 256, 64), 0, 1.0), ((1, 1, 256, 32), 1, 1.0),
         ((1, 2, 256, 64), 2, 4.0), ((1, 1, 256, 32), 3, 4.0)]


@pytest.mark.parametrize("shape,seed,peak", CASES)
def test_3xtf32_within_twice_the_float32_error(shape, seed, peak):
    q, k, v, do = inputs(shape, seed, peak)
    o64, lse64, dk64, dv64, _ = reference64(q, k, v, do)
    o, lse = emulate_forward(q, k, v, mm_3xtf32, mm_3xtf32)
    plain_o, plain_lse = fa.flash_attention_plain(q, k, v, emit_lse=True)
    for got, plain, ref in ((o, plain_o, o64), (lse, plain_lse, lse64)):
        assert max_err(got, ref) <= 2.0 * max_err(plain, ref)
    # dkv from the plain forward's o and lse, as the kernel is called
    delta = fa._delta(plain_o, do)
    dk, dv = emulate_dkv(q, k, v, do, plain_lse, delta, mm_3xtf32, mm_3xtf32)
    _, plain_dk, plain_dv = fa.flash_attention_backward_plain(
        q, k, v, plain_o, plain_lse, do)
    for got, plain, ref in ((dk, plain_dk, dk64), (dv, plain_dv, dv64)):
        assert max_err(got, ref) <= 2.0 * max_err(plain, ref)
    # TF32 alone (one term) is far outside: the split is what keeps float32
    one = emulate_forward(q, k, v, lambda a, b: torch.matmul(
        tf32_round(a), tf32_round(b)), lambda a, b: torch.matmul(
        tf32_round(a), tf32_round(b)))[0]
    assert max_err(one, o64) > 8.0 * max_err(plain_o, o64)


def within_one_ulp(got, want):
    """|got - want| <= one bf16 unit in the last place of the larger, for
    every element; elements under 2^-8 of the largest output are held to the
    unit at that magnitude (2^-15 of the largest): there both sides are
    float32 sums whose last bits already differ by more than the element."""
    floor = 2.0 ** -8 * float(want.float().abs().max())
    mag = torch.maximum(got.float().abs(), want.float().abs()).clamp_min(floor)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool(((got.float() - want.float()).abs() <= ulp).all())


@pytest.mark.parametrize("shape,seed,peak", CASES)
def test_bf16_split_p_within_one_ulp_of_the_plain_version(shape, seed, peak):
    q, k, v, do = (x.bfloat16() for x in inputs(shape, seed, peak))
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    plain_o, plain_lse = fa.flash_attention_plain(q, k, v, emit_lse=True)
    o, lse = emulate_forward(qf, kf, vf, torch.matmul, mm_split_p)
    assert within_one_ulp(o.bfloat16(), plain_o)
    np.testing.assert_allclose(lse.numpy(), plain_lse.numpy(), rtol=1e-5,
                               atol=1e-5)
    _, plain_dk, plain_dv = fa.flash_attention_backward_plain(
        q, k, v, plain_o, plain_lse, do)
    delta = fa._delta(plain_o, do)
    dk, dv = emulate_dkv(qf, kf, vf, dof, plain_lse, delta, torch.matmul,
                         mm_split_p)
    assert within_one_ulp(dk.bfloat16(), plain_dk)
    assert within_one_ulp(dv.bfloat16(), plain_dv)
    # a single bf16 term for P, P^T and dS^T would not hold it
    o1 = emulate_forward(qf, kf, vf, torch.matmul, mm_single_p)[0]
    assert not within_one_ulp(o1.bfloat16(), plain_o)
    dk1, dv1 = emulate_dkv(qf, kf, vf, dof, plain_lse, delta, torch.matmul,
                           mm_single_p)
    assert not within_one_ulp(dk1.bfloat16(), plain_dk)
    assert not within_one_ulp(dv1.bfloat16(), plain_dv)


@pytest.mark.parametrize("shape,seed,peak", CASES)
def test_dq_3xtf32_within_twice_the_float32_error(shape, seed, peak):
    q, k, v, do = inputs(shape, seed, peak)
    dq64 = reference64(q, k, v, do)[4]
    plain_o, plain_lse = fa.flash_attention_plain(q, k, v, emit_lse=True)
    delta = fa._delta(plain_o, do)
    dq = emulate_dq(q, k, v, do, plain_lse, delta, mm_3xtf32, mm_3xtf32)
    plain_dq = fa.flash_attention_backward_plain(
        q, k, v, plain_o, plain_lse, do)[0]
    assert max_err(dq, dq64) <= 2.0 * max_err(plain_dq, dq64)


@pytest.mark.parametrize("shape,seed,peak", CASES)
def test_dq_bf16_split_ds_within_one_ulp_of_the_plain_version(shape, seed,
                                                              peak):
    q, k, v, do = (x.bfloat16() for x in inputs(shape, seed, peak))
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    plain_o, plain_lse = fa.flash_attention_plain(q, k, v, emit_lse=True)
    plain_dq = fa.flash_attention_backward_plain(
        q, k, v, plain_o, plain_lse, do)[0]
    delta = fa._delta(plain_o, do)
    dq = emulate_dq(qf, kf, vf, dof, plain_lse, delta, torch.matmul,
                    mm_split_p)
    assert within_one_ulp(dq.bfloat16(), plain_dq)
    # a single bf16 term for dS would not hold it
    dq1 = emulate_dq(qf, kf, vf, dof, plain_lse, delta, torch.matmul,
                     mm_single_p)
    assert not within_one_ulp(dq1.bfloat16(), plain_dq)


def test_tf32_rounding_is_round_to_nearest_even():
    """The bit-masking rounding against a direct definition: 10 mantissa bits
    kept, halfway cases to the even neighbour (either way, either sign),
    carries into the exponent."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + 1.5 * ulp,
                      -(1.0 + 1.5 * ulp), 1.0 + ulp / 2 + 2 ** -20,
                      1.0 + ulp / 2 - 2 ** -20, 2.0 - ulp / 2, 3.0, 0.0],
                     dtype=torch.float32)
    want = torch.tensor([1.0, -1.0, 1.0 + 2 * ulp, -(1.0 + 2 * ulp),
                         1.0 + ulp, 1.0, 2.0, 3.0, 0.0], dtype=torch.float32)
    assert torch.equal(tf32_round(x), want)
    # hi and lo are TF32 values; what the split loses is lo's truncation,
    # under one TF32 unit of lo: below 2^-21 of x
    x = torch.from_numpy(np.random.default_rng(9).normal(size=4096).astype(
        np.float32))
    hi, lo = split_tf32(x)
    assert torch.equal(tf32_truncate(hi), hi)
    assert torch.equal(tf32_truncate(lo), lo)
    rel = (hi.double() + lo.double() - x.double()).abs() / x.double().abs()
    assert 0.0 < float(rel.max()) < 2.0 ** -21


# ---------------------------------------------------------------------------
# the float32 forward and dkv on wgmma (flash_attention.cu,
# flash_attention_bwd.cu): the split pass's planes (hi rounded to nearest,
# lo = x - hi, which the tensor core truncates), three products a step, and
# the products that sum over keys (or queries) in partials of 32
# ---------------------------------------------------------------------------
PARTIAL = 32  # kPnKeys
WGMMA_BLOCK_K = {64: 64, 128: 32}  # the float32 forward's key tile per D
# the float32 dq (64-key tiles at D = 64) adds each 32-key partial of
# dS K into dQ in turn, so its sum is emulated one 32-key tile at a time
WGMMA_DQ_BLOCK_K = PARTIAL


def mm_3xtf32_partials(a, b):
    """a @ b summed over a's last axis in partials of 32, each partial
    three TF32 terms, the partials added in float32 in order."""
    out = None
    for k0 in range(0, a.shape[-1], PARTIAL):
        part = mm_3xtf32(a[..., k0:k0 + PARTIAL], b[..., k0:k0 + PARTIAL, :])
        out = part if out is None else out + part
    return out


@pytest.mark.parametrize("shape,seed,peak", CASES)
def test_wgmma_3xtf32_within_twice_the_float32_error(shape, seed, peak):
    """The float32 wgmma route's arithmetic, forward (o, lse), dq and dkv
    (dk, dv), within twice the plain float32 version's error against
    float64; TF32 alone (one term) far outside."""
    q, k, v, do = inputs(shape, seed, peak)
    o64, lse64, dk64, dv64, dq64 = reference64(q, k, v, do)
    block_k = WGMMA_BLOCK_K.get(shape[-1], 64)
    o, lse = emulate_forward(q, k, v, mm_3xtf32, mm_3xtf32_partials,
                                   block_k)
    plain_o, plain_lse = fa.flash_attention_plain(q, k, v, emit_lse=True)
    for got, plain, ref in ((o, plain_o, o64), (lse, plain_lse, lse64)):
        assert max_err(got, ref) <= 2.0 * max_err(plain, ref)
    delta = fa._delta(plain_o, do)
    dk, dv = emulate_dkv(q, k, v, do, plain_lse, delta, mm_3xtf32,
                         mm_3xtf32_partials)
    dq = emulate_dq(q, k, v, do, plain_lse, delta, mm_3xtf32,
                    mm_3xtf32_partials, WGMMA_DQ_BLOCK_K)
    plain_dq, plain_dk, plain_dv = fa.flash_attention_backward_plain(
        q, k, v, plain_o, plain_lse, do)
    for got, plain, ref in ((dk, plain_dk, dk64), (dv, plain_dv, dv64),
                            (dq, plain_dq, dq64)):
        assert max_err(got, ref) <= 2.0 * max_err(plain, ref)

    def one_term(a, b):
        return torch.matmul(tf32_round(a), tf32_round(b))

    o1 = emulate_forward(q, k, v, one_term, one_term, block_k)[0]
    assert max_err(o1, o64) > 8.0 * max_err(plain_o, o64)
    dk1, dv1 = emulate_dkv(q, k, v, do, plain_lse, delta, one_term,
                           one_term)
    assert max_err(dk1, dk64) > 8.0 * max_err(plain_dk, dk64)
    assert max_err(dv1, dv64) > 8.0 * max_err(plain_dv, dv64)
    dq1 = emulate_dq(q, k, v, do, plain_lse, delta, one_term, one_term,
                     WGMMA_DQ_BLOCK_K)
    assert max_err(dq1, dq64) > 8.0 * max_err(plain_dq, dq64)


def _packed_operands(seed, t=256, heads=2, d=64):
    """q, k, v as strided views of one packed (N, T, heads, 3, D) tensor,
    as the attention block hands them over, and a contiguous do."""
    rng = np.random.default_rng(seed)
    packed = torch.from_numpy(rng.normal(0.0, 1.0, (2, t, heads, 3, d))
                              .astype(np.float32))
    q, k, v = (packed[:, :, :, i].permute(0, 2, 1, 3) for i in range(3))
    do = torch.from_numpy(rng.normal(0.0, 1.0, q.shape).astype(np.float32))
    return q, k, v, do


@pytest.mark.parametrize("d", [64, 128])
def test_split_planes_invert_to_the_operands(d):
    """The split pass's plain version on packed views: per operand its
    K-major hi and lo, then its transposed ones, in the backward's order
    (q, k both; v K-major; do both: fourteen planes, read by dq and dkv);
    hi is the operand rounded to TF32 (to nearest even), hi + lo is the
    operand bit for bit, and each transposed plane, its groups of 8 rows put
    back in order and transposed, is the K-major one."""
    xs = _packed_operands(20 + d, d=d)
    assert not xs[0].is_contiguous()
    modes = fa.BACKWARD_SPLIT
    planes = fa.flash_split(xs, modes)  # CPU tensors: the plain one
    assert torch.equal(planes, fa.flash_split_plain(xs, modes))
    assert planes.shape == (fa.split_planes(modes), xs[0].numel())
    assert planes.shape[0] == 14
    assert modes == (fa.SPLIT_BOTH, fa.SPLIT_BOTH, fa.SPLIT_KMAJOR,
                     fa.SPLIT_BOTH)
    b, h, t, _ = xs[0].shape
    # the order in which the accumulator's fragment holds 8 columns
    order = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])
    inverse = torch.argsort((torch.arange(0, t, 8)[:, None] + order)
                            .reshape(t))
    at = 0
    firsts = []  # each operand's first plane
    for x, mode in zip(xs, modes):
        firsts.append(at)
        kmajor = []
        if mode & fa.SPLIT_KMAJOR:
            hi, lo = (planes[at + i].view(b, h, t, d) for i in range(2))
            assert torch.equal(hi, tf32_round(x))
            assert torch.equal(tf32_round(hi), hi)
            assert torch.equal(hi + lo, x)
            kmajor = [hi, lo]
            at += 2
        if mode & fa.SPLIT_TRANSPOSED:
            back = [planes[at + i].view(b, h, d, t)[..., inverse]
                    .transpose(-1, -2) for i in range(2)]
            assert torch.equal(back[0] + back[1], x)
            assert torch.equal(back[0], tf32_round(x))
            for got, want in zip(back, kmajor):
                assert torch.equal(got, want)
            at += 2
    assert at == planes.shape[0]
    # in order: q hi, lo, q^T hi, lo (0-3); k, k^T (4-7); v (8, 9); do,
    # do^T (10-13), as the kernels index them
    assert firsts == [0, 4, 8, 10]
    # the forward's planes: q and k K-major, v transposed
    forward = fa.flash_split(xs[:3], fa.FORWARD_SPLIT)
    assert torch.equal(forward[:4], planes[[0, 1, 4, 5]])
    assert torch.equal(forward[4:], fa.flash_split(xs[2:3],
                                                   (fa.SPLIT_TRANSPOSED,)))


def test_split_routes_and_refusals():
    """float32 at D = 64 and 128 splits (the wgmma route), nothing else
    does; the split pass refuses other head dims, types and modes."""
    for d, dtype, splits in ((64, torch.float32, True),
                             (128, torch.float32, True),
                             (32, torch.float32, False),
                             (256, torch.float32, False),
                             (64, torch.bfloat16, False)):
        assert fa._splits(torch.zeros((1, 1, 128, d), dtype=dtype)) is splits
    x = torch.zeros((1, 1, 128, 32))
    with pytest.raises(ValueError):
        fa.flash_split((x,), (fa.SPLIT_KMAJOR,))
    y = torch.zeros((1, 1, 128, 64))
    with pytest.raises(ValueError):
        fa.flash_split((y.bfloat16(),), (fa.SPLIT_KMAJOR,))
    with pytest.raises(ValueError):
        fa.flash_split((y,), (4,))
    with pytest.raises(ValueError):
        fa.flash_split((y,) * 5, (1,) * 5)
