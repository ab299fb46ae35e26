"""Field-op bundles exposing Fq (limbs) and Fq2 (tower) through one interface.

Lets the branch-free Jacobian curve arithmetic in `jacobian.py` be written
once and instantiated for both G1 (coords in Fq) and G2 (coords in Fq2),
mirroring how the host oracle shares `_FieldOps` (host/curve.py) — but here
every op is a batched device tensor op in the Montgomery <= 2p domain.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..fields import limbs as L
from ..fields import tower as T


class FqOps:
    """Fq: elements are (18, *batch) uint32 Montgomery limb tensors."""

    @staticmethod
    def add(a, b):
        return L.add_mod(a, b)

    @staticmethod
    def sub(a, b):
        return L.sub_mod(a, b)

    @staticmethod
    def mul(a, b):
        return L.mont_mul(a, b)

    @staticmethod
    def sq(a):
        return L.mont_sqr(a)

    @staticmethod
    def neg(a):
        return L.neg_mod(a)

    @staticmethod
    def double(a):
        return L.add_mod(a, a)

    @staticmethod
    def mul_small(a, k):
        return L.mul_small(a, k)

    @staticmethod
    def inv(a):
        return L.inv_mod(a)

    @staticmethod
    def is_zero(a):
        return L.is_zero(a)

    @staticmethod
    def eq(a, b):
        return L.eq(a, b)

    @staticmethod
    def select(mask, t, f):
        return L.select(mask, t, f)

    @staticmethod
    def zero(batch_shape=()):
        return L.mont_zero(batch_shape)

    @staticmethod
    def one(batch_shape=()):
        return L.mont_one(batch_shape)

    @staticmethod
    def batch_shape(a):
        return a.batch_shape

    @staticmethod
    def retag(a, vmax):
        e = L.norm_limbs(a) if a.lmax > (1 << 16) else a
        return L.retag(e, vmax, 1 << 16)


class Fq2Ops:
    """Fq2: elements are tower.Fq2 named tuples of Montgomery limb tensors."""

    @staticmethod
    def add(a, b):
        return T.fq2_add(a, b)

    @staticmethod
    def sub(a, b):
        return T.fq2_sub(a, b)

    @staticmethod
    def mul(a, b):
        return T.fq2_mul(a, b)

    @staticmethod
    def sq(a):
        return T.fq2_sq(a)

    @staticmethod
    def neg(a):
        return T.fq2_neg(a)

    @staticmethod
    def double(a):
        return T.fq2_double(a)

    @staticmethod
    def mul_small(a, k):
        return T.fq2_mul_small(a, k)

    @staticmethod
    def inv(a):
        return T.fq2_inv(a)

    @staticmethod
    def is_zero(a):
        return T.fq2_is_zero(a)

    @staticmethod
    def eq(a, b):
        return T.fq2_eq(a, b)

    @staticmethod
    def select(mask, t, f):
        return T.fq2_select(mask, t, f)

    @staticmethod
    def zero(batch_shape=()):
        return T.fq2_zero(batch_shape)

    @staticmethod
    def one(batch_shape=()):
        return T.fq2_one(batch_shape)

    @staticmethod
    def batch_shape(a):
        return a.c0.batch_shape

    @staticmethod
    def retag(a, vmax):
        return T.fq2_retag(a, vmax)
