"""Device pairing-path unit tests on the CPU backend (tiny batches).

Covers the pieces the golden end-to-end vectors exercise only on an accelerator:
the Granger-Scott cyclotomic square, the windowed u-exponentiation, the
full final exponentiation, and the 2-pair product check (reference
semantics: ecdsa.rs:49-64 pairing equation).
"""

import random

import jax
import numpy as np
import pytest

from bn254_tpu.constants import P, R, U
from bn254_tpu.fields import limbs as L
from bn254_tpu.fields import tower as T
from bn254_tpu.host import field as HF
from bn254_tpu.pairing import final_exp as FE

random.seed(20260818)

B = 2  # tiny batch: keeps the CPU compiles small


def _rnd_fq12_host():
    return tuple(
        tuple((random.randrange(P), random.randrange(P)) for _ in range(3))
        for _ in range(2)
    )


def _easy_host(f):
    g = HF.fq12_mul(HF.fq12_conj(f), HF.fq12_inv(f))
    return HF.fq12_mul(HF.fq12_frob(g, 2), g)


def _cyclotomic_batch():
    return [_easy_host(_rnd_fq12_host()) for _ in range(B)]


def _to_device(hs):
    def conv(path):
        return L.to_mont(L.from_ints([path(h) for h in hs]))

    return T.Fq12(
        *[
            T.Fq6(
                *[
                    T.Fq2(
                        conv(lambda h, i=i, j=j: h[i][j][0]),
                        conv(lambda h, i=i, j=j: h[i][j][1]),
                    )
                    for j in range(3)
                ]
            )
            for i in range(2)
        ]
    )


def _from_device(d):
    out = []
    for b in range(B):
        out.append(
            tuple(
                tuple(
                    (
                        int(L.to_ints(L.from_mont(d[i][j].c0))[b]),
                        int(L.to_ints(L.from_mont(d[i][j].c1))[b]),
                    )
                    for j in range(3)
                )
                for i in range(2)
            )
        )
    return out


def test_cyc_sq_matches_generic_sq():
    hs = _cyclotomic_batch()
    dev = _to_device(hs)
    got = _from_device(jax.jit(T.fq12_cyc_sq)(T.fq12_retag(dev)))
    for h, g in zip(hs, got):
        assert HF.fq12_eq(HF.fq12_sq(h), g)


def test_exp_u_windowed_matches_host_pow():
    hs = _cyclotomic_batch()
    dev = _to_device(hs)
    got = _from_device(jax.jit(FE.exp_u)(T.fq12_retag(dev)))
    for h, g in zip(hs, got):
        assert HF.fq12_eq(HF.fq12_pow(h, U), g)


def test_final_exp_matches_canonical_pow():
    hs = [_rnd_fq12_host() for _ in range(B)]
    dev = _to_device(hs)
    got = _from_device(jax.jit(FE.final_exp)(T.fq12_retag(dev)))
    exp = (P**12 - 1) // R
    for h, g in zip(hs, got):
        assert HF.fq12_eq(HF.fq12_pow(h, exp), g)


def test_pairing_check_batch():
    """e(H, pk) * e(sig, -G2) == 1 iff sig = sk*H, pk = sk*G2."""
    from bn254_tpu.dist import batch_verify as BV
    from bn254_tpu.host import curve as HC
    from bn254_tpu.utils import convert as CV

    sks = [12345, 67890]
    hpts = [HC.g1_mul(HC.G1_ONE, 7 + i) for i in range(B)]
    sigs = [HC.g1_mul(h, k) for h, k in zip(hpts, sks)]
    pks = [HC.g2_mul(HC.G2_ONE, k) for k in sks]
    # corrupt the second signature
    sigs[1] = HC.g1_mul(sigs[1], 2)

    hx, hy = CV.g1_batch_to_device_affine(hpts)
    sx, sy = CV.g1_batch_to_device_affine(sigs)
    pqx, pqy = CV.g2_batch_to_device_affine(pks)
    ok = np.asarray(BV.verify_batch_independent_staged(hx, hy, sx, sy, pqx, pqy))
    assert ok.tolist() == [True, False]
