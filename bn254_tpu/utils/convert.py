"""Host protocol objects <-> device tensors (the tensor boundary).

Batched conversions between the protocol layer's Python-int points/keys
and the device's Montgomery limb tensors.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..constants import MONT_R, NLIMBS, P
from ..errors import ToAffineConversionError
from ..fields import limbs as L
from ..fields import tower as T
from ..host import curve as HC


def _host_to_mont(v: int) -> int:
    """Montgomery conversion on the host (one Python bigint mul) — avoids
    an eager device mont_mul (a device dispatch) per tensor."""
    return (v * MONT_R) % P


def g1_batch_to_device_affine(points_jac):
    """List of host Jacobian G1 points -> (x, y) Montgomery limb tensors
    of shape (18, B). Identity points are not supported here (callers
    pass hash points / signatures, which are never the identity in valid
    flows); use the inf-mask variants if needed."""
    affs = [HC.g1_to_affine(p) for p in points_jac]
    if any(a is None for a in affs):
        # the reference's CurveError::ToAffineConversion path
        # (/root/reference/src/error.rs:37): identity has no affine form
        raise ToAffineConversionError("identity point in G1 batch")
    xs = L.from_ints([_host_to_mont(a[0]) for a in affs], vmax=P)
    ys = L.from_ints([_host_to_mont(a[1]) for a in affs], vmax=P)
    return xs, ys


def g2_batch_to_device_affine(points_jac):
    """List of host Jacobian G2 points -> (Fq2 x, Fq2 y) limb tensors."""
    affs = [HC.g2_to_affine(p) for p in points_jac]
    if any(a is None for a in affs):
        raise ToAffineConversionError("identity point in G2 batch")

    def fq2(vals):
        return T.Fq2(
            L.from_ints([_host_to_mont(v[0]) for v in vals], vmax=P),
            L.from_ints([_host_to_mont(v[1]) for v in vals], vmax=P),
        )

    return fq2([a[0] for a in affs]), fq2([a[1] for a in affs])


def scalars_to_device(scalars) -> jnp.ndarray:
    """List of ints < 2^256 -> (18, B) canonical limb tensor (no Montgomery).

    vmax is PINNED to 2^256 rather than from_ints' data-dependent
    default (max value + 1): El bounds are static jit-cache metadata, so
    a data-dependent bound would hand every batch of scalars a fresh
    program signature — e.g. each chunk of the config-5 stream silently
    recompiled its scalar-mul fixtures in round 4. Scalar consumers
    (ladders) read bits, never the bound, so the wide pin is free.
    """
    vals = list(scalars)
    for v in vals:
        if int(v) >> 256:
            raise ValueError(f"scalar {int(v):#x} exceeds 256 bits")
    return L.from_ints(vals, vmax=1 << 256)


def g2_const_affine(point_jac, batch_shape=()):
    """Single host G2 point -> broadcast device affine (Fq2 x, Fq2 y)."""
    aff = HC.g2_to_affine(point_jac)

    def bc(v):
        return L.bcast_to(L.from_ints(_host_to_mont(v), vmax=P), batch_shape)

    return (
        T.Fq2(bc(aff[0][0]), bc(aff[0][1])),
        T.Fq2(bc(aff[1][0]), bc(aff[1][1])),
    )
