"""The leaf CIOS Montgomery multiply (limbs.mont_mul) vs the oracle.

mont_mul is the one multiply under every field operation on every
backend (a `lax.scan` over a's limbs). This suite requires value
equality against the Python-int Montgomery oracle, canonical limbs and
the documented output bounds — on random inputs at a 1024-lane batch
and at a lane count that is not a power of two, boundary inputs (limbs
at the 2^16-1 limb-lazy maximum, values near the vmax contract),
zero/one/p edge values, and a broadcast (18,) x (18, B) operand pair;
jitted and eager results must agree bit for bit.
"""

import random

import jax
import numpy as np

from bn254_tpu.constants import LIMB_BITS, MONT_R, NLIMBS, P
from bn254_tpu.fields import limbs as L

RINV = pow(MONT_R, -1, P)
BLOCK = 1024


def _oracle(a_vals, b_vals):
    return [(a * b * RINV) % P for a, b in zip(a_vals, b_vals)]


def _jit_mul(a_el, b_el):
    return jax.jit(lambda a, b: L.mont_mul(a, b))(a_el, b_el)


def _check(a_el, b_el):
    out = _jit_mul(a_el, b_el)
    arr = np.asarray(out.arr)
    assert arr.shape == np.broadcast_shapes(a_el.arr.shape, b_el.arr.shape)
    assert int(arr.max()) < 1 << LIMB_BITS  # limb-normalised output
    a_vals = L.to_ints(a_el.arr).reshape(-1)
    b_vals = L.to_ints(b_el.arr).reshape(-1)
    got = L.to_ints(arr).reshape(-1)
    want = _oracle(a_vals, b_vals)
    for g, w in zip(got, want):
        assert int(g) < out.vmax  # the static bound holds
        assert int(g) % P == w % P


def test_kernel_random_block_aligned():
    rng = random.Random(101)
    n = BLOCK
    a = L.from_ints([rng.randrange(P) for _ in range(n)], vmax=P)
    b = L.from_ints([rng.randrange(P) for _ in range(n)], vmax=P)
    _check(a, b)


def test_kernel_random_padded_lanes():
    """A lane count that is not a power of two."""
    rng = random.Random(103)
    n = BLOCK + 37
    a = L.from_ints([rng.randrange(P) for _ in range(n)], vmax=P)
    b = L.from_ints([rng.randrange(P) for _ in range(n)], vmax=P)
    _check(a, b)


def _lazy_boundary_el(n, top, rng=None, jitter=False):
    """Limb-lazy El with limbs at the 2^16-1 maximum and value ~top*2^255.

    Builds the raw limb array directly (bypassing from_ints' canonical
    radix-2^15 split) to hit mont_mul's true input contract: limbs up
    to 2^16-1 as produced by one lazy add of two normalised elements.
    """
    arr = np.full((NLIMBS, n), (1 << 16) - 1, dtype=np.uint32)
    arr[NLIMBS - 1, :] = top
    if jitter:
        for j in range(n):
            i = rng.randrange(NLIMBS - 1)
            arr[i, j] = rng.randrange(1 << 16)
    vals = L.to_ints(arr).reshape(-1)
    vmax = int(max(vals)) + 1
    return L.El(jax.numpy.asarray(arr), vmax, 1 << 16)


def test_kernel_boundary_lazy_limbs():
    """Limbs at 2^16-1 (limb-lazy max) and values near the vmax contract:
    a.vmax*b.vmax + R*p must stay under 2^538 — pick top limbs so the
    product bound is within ~2x of the limit."""
    rng = random.Random(107)
    n = BLOCK
    a = _lazy_boundary_el(n, top=0x7F, rng=rng, jitter=True)
    b = _lazy_boundary_el(n, top=0x7F, rng=rng, jitter=True)
    assert a.vmax * b.vmax + MONT_R * P < 1 << 538
    assert a.vmax * b.vmax + MONT_R * P > 1 << 520  # genuinely near the top
    _check(a, b)


def test_kernel_zero_and_one():
    ints = [0, 1, P - 1, P, MONT_R % P] + [2**k for k in range(0, 255, 16)]
    a = L.from_ints(ints)
    b = L.from_ints(list(reversed(ints)))
    _check(a, b)
    eager = L.mont_mul(a, b)
    assert np.array_equal(np.asarray(eager.arr),
                          np.asarray(_jit_mul(a, b).arr))


def test_kernel_broadcasting():
    """(18,) x (18, B) broadcast: the scalar operand fans out per lane."""
    rng = random.Random(109)
    n = 64
    a = L.from_ints(rng.randrange(P))  # scalar El (18,)
    b = L.from_ints([rng.randrange(P) for _ in range(n)], vmax=P)
    a_col = L.El(a.arr[:, None], a.vmax, a.lmax)
    _check(a_col, b)
    full = L.El(jax.numpy.broadcast_to(a.arr[:, None], (NLIMBS, n)),
                a.vmax, a.lmax)
    assert np.array_equal(np.asarray(_jit_mul(a_col, b).arr),
                          np.asarray(_jit_mul(full, b).arr))
