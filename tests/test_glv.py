"""GLV endomorphism Shamir ladder (curve/glv.py).

Covers: the (β, λ) constant pairing against the host oracle, the
soundness lattice bound behind the "w = a + λb is uniform over 2^bits
values" claim, device ladder correctness vs the host oracle (including
edge weights: all-ones halves, a zero half, the top bit alone), weight
validation, and the fused-tier weight-and-sum stage under GLV weights.
"""

import jax
import pytest

from bn254_tpu.constants import P, R
from bn254_tpu.curve import glv as GLV
from bn254_tpu.curve import g1 as DG1
from bn254_tpu.curve import jacobian as J
from bn254_tpu.dist import batch_verify as BV
from bn254_tpu.fields import limbs as L
from bn254_tpu.host import curve as HC
from bn254_tpu.utils import convert as CV


def test_beta_lambda_pairing():
    """φ(P) = (βx, y) equals [λ]P on the curve (host oracle)."""
    assert (GLV.BETA**3) % P == 1 and GLV.BETA != 1
    assert (GLV.LAMBDA**3) % R == 1 and GLV.LAMBDA != 1
    for k in (1, 5, 12345):
        pt = HC.g1_mul(HC.G1_ONE, k)
        x, y = HC.g1_to_affine(pt)
        lx, ly = HC.g1_to_affine(HC.g1_mul(pt, GLV.LAMBDA))
        assert (x * GLV.BETA % P, y) == (lx, ly)


def test_glv_injectivity_lattice_bound():
    """No nonzero (Δa, Δb) with both < 2^64 satisfies Δa + λΔb ≡ 0 (r):
    the lattice's shortest vector has Euclidean norm ≈ 2^127 > √2·2^64,
    so (a, b) -> a + λb is injective on [0, 2^64)^2 and the RLC forgery
    bound is a true 2^-128."""
    u, v = (R, 0), (-GLV.LAMBDA, 1)

    def n2(a):
        return a[0] * a[0] + a[1] * a[1]

    while True:
        if n2(u) < n2(v):
            u, v = v, u
        m = round((u[0] * v[0] + u[1] * v[1]) / n2(v))
        if m == 0:
            break
        u = (u[0] - m * v[0], u[1] - m * v[1])
    shortest_sq = min(n2(u), n2(v))
    assert shortest_sq > 2 * (1 << 64) ** 2


def _dev_points(ks):
    pts = [HC.g1_mul(HC.G1_ONE, k) for k in ks]
    x, y = CV.g1_batch_to_device_affine(pts)
    return pts, J.JPoint(x, y, L.mont_one(x.batch_shape))


def test_shamir_scan_matches_host_oracle():
    """Device [a]P + [b]φ(P) == host [a + λb mod r]P (16-bit halves keep
    the CPU scan compile snappy; covers (1,0), (0,b), a=b, random)."""
    ks = [3, 7, 11, 13]
    pairs = [(1, 0), (0, 0x9A3F), (0x51C2, 0x51C2), (0xBEEF, 0x1234)]
    pts, p_dev = _dev_points(ks)
    w = GLV.glv_weights_to_device(pairs, bits=32)
    out = jax.jit(GLV.shamir_scalar_mul)(p_dev, w)
    got = DG1.to_host_affine(out)
    for pt, (a, b), g in zip(pts, pairs, got):
        scalar = (a + GLV.LAMBDA * b) % R
        want = HC.g1_to_affine(HC.g1_mul(pt, scalar))
        assert g == want, (a, b)


def test_shamir_identity_weight_zero():
    """(a, b) = (0, 0) maps every point to the identity."""
    _, p_dev = _dev_points([5, 6])
    w = GLV.glv_weights_to_device([(0, 0), (0, 0)], bits=8)
    out = jax.jit(GLV.shamir_scalar_mul)(p_dev, w)
    assert DG1.to_host_affine(out) == [None, None]


def test_shamir_edge_weights_match_host_oracle():
    """Edge weight halves (all ones, a zero half, the top bit alone, a
    unit) through the device ladder == host [a + λb mod r]P."""
    ks = [2, 9, 4, 8]
    pairs = [(0xA7, 0x15), (0x01, 0x00), (0xFF, 0xFF), (0x00, 0x80)]
    pts, p_dev = _dev_points(ks)
    w = GLV.glv_weights_to_device(pairs, bits=16)
    got = DG1.to_host_affine(jax.jit(GLV.shamir_scalar_mul)(p_dev, w))
    for pt, (a, b), g in zip(pts, pairs, got):
        scalar = (a + GLV.LAMBDA * b) % R
        assert g == HC.g1_to_affine(HC.g1_mul(pt, scalar)), (a, b)


def test_glv_weight_validation():
    with pytest.raises(ValueError):
        GLV.glv_weights_to_device([(1 << 16, 0)], bits=32)
    with pytest.raises(ValueError):
        GLV.glv_weights_to_device([(0, 1 << 16)], bits=32)
    w = GLV.random_glv_weights(5, bits=32)
    assert w.bits == 32 and w.half_bits == 16
    vals = GLV.weight_values(w)
    assert vals[0] == 1 and all(v != 0 for v in vals)


def test_plain_weight_validation_uniform():
    """Oversize plain weights raise on EVERY entrypoint (ADVICE r3)."""
    big = 1 << 200
    with pytest.raises(ValueError):
        BV._resolve_weights([1, big], nbits=128)
    # per-call nbits overrides the config default
    BV._resolve_weights([1, (1 << 200) - 1], nbits=256)


def test_weight_and_sum_glv_matches_host():
    """The fused tier's weighting stage under GLV weights reproduces the
    host oracle's [w]H and Σ[w]sig."""
    B = 4
    hs = [HC.g1_mul(HC.G1_ONE, 3 + i) for i in range(B)]
    ss = [HC.g1_mul(HC.G1_ONE, 50 + i) for i in range(B)]
    hx, hy = CV.g1_batch_to_device_affine(hs)
    sx, sy = CV.g1_batch_to_device_affine(ss)
    pairs = [(1, 0), (0x55, 0xAA), (0x0F, 0xF0), (0x93, 0x01)]
    w = GLV.glv_weights_to_device(pairs, bits=16)

    whx, why, ssx, ssy = jax.jit(
        BV._weight_and_sum, static_argnames=("nbits",)
    )(hx, hy, sx, sy, w, nbits=w.half_bits)

    scalars = [(a + GLV.LAMBDA * b) % R for a, b in pairs]
    want_h = [
        HC.g1_to_affine(HC.g1_mul(h, s)) for h, s in zip(hs, scalars)
    ]
    acc = HC.G1_IDENTITY
    for s_pt, s_val in zip(ss, scalars):
        acc = HC.g1_add(acc, HC.g1_mul(s_pt, s_val))
    want_s = HC.g1_to_affine(acc)

    got_hx = L.to_ints(L.from_mont(whx))
    got_hy = L.to_ints(L.from_mont(why))
    for j in range(B):
        assert (int(got_hx[j]), int(got_hy[j])) == want_h[j]
    assert (
        int(L.to_int(L.from_mont(ssx))),
        int(L.to_int(L.from_mont(ssy))),
    ) == want_s
