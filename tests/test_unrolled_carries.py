"""Carry/borrow chains (the lax.scan forms in fields/limbs.py) vs
Python-int references: signed and unsigned carry propagation, offset
subtraction, negation, limb normalisation of lazy columns, conditional
subtraction and comparison at the threshold edges, eager and jitted.
"""

import random

import jax
import numpy as np

from bn254_tpu.constants import LIMB_BITS, MONT_R, P
from bn254_tpu.fields import limbs as L


def _rand_el(rng, n, vmax=P):
    return L.from_ints([rng.randrange(vmax) for _ in range(n)], vmax=vmax)


def _vals(el):
    return [int(v) for v in L.to_ints(el.arr).reshape(-1)]


def _normalised(el):
    return int(np.asarray(el.arr).max()) < 1 << LIMB_BITS


def test_sub_neg_norm_unrolled():
    rng = random.Random(31)
    n = 97
    a = _rand_el(rng, n)
    b = L.add_mod(_rand_el(rng, n), _rand_el(rng, n))  # lazy limbs
    av, bv = _vals(a), _vals(b)

    sub = L.sub_mod(a, b)
    neg = L.neg_mod(b)
    norm = L.norm_limbs(b)
    lazy_cols = L.El(b.arr * np.uint32(9), b.vmax * 9, b.lmax * 9)
    norm9 = L.norm_limbs(lazy_cols)

    for el in (sub, neg, norm, norm9):
        assert _normalised(el) and el.lmax == 1 << LIMB_BITS
        assert all(v < el.vmax for v in _vals(el))
    assert [v % P for v in _vals(sub)] == [(x - y) % P for x, y in zip(av, bv)]
    assert [v % P for v in _vals(neg)] == [(-y) % P for y in bv]
    assert _vals(norm) == bv  # value unchanged, limbs carried
    assert _vals(norm9) == [9 * y for y in bv]


def test_cond_sub_lt_unrolled():
    rng = random.Random(37)
    # values straddling the threshold, including exact-equality edges
    vals = [0, 1, P - 1, P, P + 1, 2 * P - 1, 2 * P, 3 * P // 2] + [
        rng.randrange(3 * P) for _ in range(120)
    ]
    a = L.from_ints(vals, vmax=3 * P)

    cs = L.cond_sub(a, P)
    lt = np.asarray(L.lt_const(a, P))
    canon = L.canon(a)

    assert _vals(cs) == [v - P if v >= P else v for v in vals]
    assert lt.tolist() == [v < P for v in vals]
    assert _vals(canon) == [v % P for v in vals]


def test_unrolled_inside_jit():
    """The carry chains trace and compile under jit (batch shapes) and
    agree with eager execution bit for bit."""
    rng = random.Random(41)
    n = 64
    a = _rand_el(rng, n)
    b = _rand_el(rng, n)

    def f(a, b):
        s = L.sub_mod(a, b)
        m = L.mont_mul(s, b)
        return L.canon(m)

    out = jax.jit(f)(a, b)
    assert np.array_equal(np.asarray(out.arr), np.asarray(f(a, b).arr))
    rinv = pow(MONT_R, -1, P)
    for x, y, g in zip(_vals(a), _vals(b), _vals(out)):
        assert g == ((x - y) * y * rinv) % P
