"""Static-bound pinning regression tests.

A benchmark once crashed at TRACE time: `hash/tai_batch.py`'s odd-y
negation (`neg_mod` of a STD_BOUND-tagged pow output) produced a value
bound just above STD_BOUND, and `pairing/miller.py:_pin_el`'s `retag`
asserted when the Miller loop pinned it. Tests that build every input
with vmax=P never see that. These tests make the whole regression class
CI-visible:

1. metadata-only (`jax.eval_shape`, no compile): `_pin_el` must accept
   the static bounds of EVERY producer that feeds the Miller loop — real
   `hash_to_g1_batch` outputs, `to_affine` outputs, codec conversions —
   and the full pipeline must trace end-to-end on real hash-output
   bounds.
2. numeric: `_pin_el` preserves the residue through its vreduce path;
   on truncated schedules the scan Miller loop and exp_u equal a plain
   Python composition of the same step functions (the scan/cond digit
   machinery is exercised against a reference without it); and real
   hash outputs pipe through `verify_batch_independent_staged`
   end-to-end at batch 4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from bn254_tpu.constants import MONT_R, P
from bn254_tpu.fields import limbs as L
from bn254_tpu.fields import tower as T
from bn254_tpu.fields.limbs import STD_BOUND
from bn254_tpu.hash import tai_batch as TB
from bn254_tpu.host import curve as HC
from bn254_tpu.host import field as HF
from bn254_tpu.pairing import final_exp as FE
from bn254_tpu.pairing import miller as M
from bn254_tpu.utils import convert as CV

# four equal-length messages whose try-and-increment counter is < 4
# (ctrs 0, 2, 0, 1), so the device hash resolves all without fallback
MSGS = [b"sample", b"helloo", b"pin002", b"pin003"]


@functools.lru_cache(maxsize=1)
def _hash_batch():
    """Real device hash outputs (production static bounds), batch 4.

    Deliberately EAGER: jitting the whole hash program is a multi-minute
    XLA-CPU compile, while eager runs as small cached executables (the
    same trade test_device_hash makes via hash_to_g1_device)."""
    blocks, w, s = TB.prepare_blocks_host(MSGS)
    return TB.hash_to_g1_batch(jnp.asarray(blocks), w, s, k_candidates=4)


# ---------------------------------------------------------------------------
# 1. metadata-only: every Miller-loop producer must pin
# ---------------------------------------------------------------------------


def _abstract(el: L.El) -> L.El:
    """Concrete El -> same static bounds over ShapeDtypeStruct leaves."""
    return L.El(
        jax.ShapeDtypeStruct(el.arr.shape, el.arr.dtype), el.vmax, el.lmax
    )


def test_pin_accepts_hash_output_bounds():
    """The exact trace-time crash: pin real hash_to_g1_batch outputs.

    eval_shape runs the full static-bound bookkeeping without compiling
    or executing anything, so a bound regression anywhere in the hash ->
    pin chain fails here as the AssertionError it raises at trace time.
    """
    blocks, w, s = TB.prepare_blocks_host(MSGS)

    def produce_and_pin(blocks):
        x, y, found, ctr = TB.hash_to_g1_batch(blocks, w, s, k_candidates=4)
        return M._pin_el(x), M._pin_el(y)

    jax.eval_shape(produce_and_pin, jnp.asarray(blocks))


def test_pin_accepts_to_affine_and_codec_bounds():
    from bn254_tpu.curve import g1 as DG1
    from bn254_tpu.curve import jacobian as J

    # codec conversions (vmax = P by construction)
    sx, sy = CV.g1_batch_to_device_affine([HC.g1_mul(HC.G1_ONE, 5)])
    M._pin_el(_abstract(sx)), M._pin_el(_abstract(sy))

    # to_affine outputs of a worst-case-tagged Jacobian point
    def affine_and_pin(x, y, z):
        ax, ay, inf = DG1.to_affine(J.JPoint(x, y, z))
        return M._pin_el(ax), M._pin_el(ay)

    worst = L.El(
        jax.ShapeDtypeStruct((18, 4), jnp.uint32), STD_BOUND, 1 << 16
    )
    jax.eval_shape(affine_and_pin, worst, worst, worst)


def test_pin_accepts_neg_mod_of_std_bound():
    """neg_mod of a STD_BOUND-tagged element exceeds STD_BOUND; the pin
    must value-reduce it instead of asserting (the regression class)."""
    el = L.El(jax.ShapeDtypeStruct((18, 4), jnp.uint32), STD_BOUND, 1 << 15)
    neg = jax.eval_shape(lambda e: L.neg_mod(e), el)
    assert neg.vmax > STD_BOUND  # precondition: this IS the bad producer
    out = jax.eval_shape(lambda e: M._pin_el(L.neg_mod(e)), el)
    assert out.vmax <= STD_BOUND and out.lmax <= 1 << 16


def test_unrolled_pipeline_traces_on_hash_bounds(monkeypatch):
    """Trace (eval_shape, no compile) the pipeline — device hash ->
    independent pairing check with per-tuple final exps — the program
    shape that crashed. Catches any static-bound assert anywhere in the
    composition at real producer bounds.

    Schedules are truncated (6 NAF digits incl. a nonzero one + both
    Frobenius adds; 3 exp_u windows incl. a zero one): every loop body
    pins its carriers to the (STD_BOUND, 2^16) fixed point, so the
    static-bound space after digit 1 is identical for all later digits —
    the truncation loses no bound coverage."""
    from bn254_tpu.dist import batch_verify as BV

    naf6 = M._ATE_NAF[:6]
    win3 = FE._U_WINDOWS[:3]
    assert any(d != 0 for d in naf6) and 0 in win3
    monkeypatch.setattr(M, "_ATE_NAF", naf6)
    monkeypatch.setattr(FE, "_U_WINDOWS", win3)

    blocks, w, s = TB.prepare_blocks_host(MSGS)
    sx, sy = CV.g1_batch_to_device_affine(
        [HC.g1_mul(HC.G1_ONE, 3 + i) for i in range(4)]
    )
    pqx, pqy = CV.g2_batch_to_device_affine(
        [HC.g2_mul(HC.G2_ONE, 3 + i) for i in range(4)]
    )

    def pipeline(blocks, sx, sy, pqx, pqy):
        hx, hy, found, _ = TB.hash_to_g1_batch(blocks, w, s, k_candidates=4)
        return BV.verify_batch_independent(hx, hy, sx, sy, pqx, pqy), found

    jax.eval_shape(pipeline, jnp.asarray(blocks), sx, sy, pqx, pqy)


# ---------------------------------------------------------------------------
# 2. numeric coverage
# ---------------------------------------------------------------------------


def test_pin_el_preserves_residue_through_vreduce():
    vals = [123456789 * MONT_R % P, P - 1, 0, (1 << 200) % P]
    base = L.retag(L.norm_limbs(L.from_ints(vals, vmax=P)), STD_BOUND)
    pinned = M._pin_el(L.neg_mod(base))  # vmax > STD_BOUND going in
    got = [int(v) for v in L.to_ints(L.canon(pinned))]
    assert got == [(P - v) % P for v in vals]


def _canon12(x):
    return np.stack([np.asarray(L.canon(e).arr) for e in T._fq12_els(x)])


def _miller_reference(xp, yp, qx, qy, naf):
    """The Miller recurrence as a plain Python loop over the same step
    functions (no scan, no cond, no digit select) — eager, so every op
    runs as its own small cached program."""
    batch = xp.batch_shape
    f = M._pin_fq12(T.fq12_one(batch))
    t = M._pin_proj(M.ProjG2(qx, qy, T.fq2_one(batch)))
    nqy = M._pin_fq2(T.fq2_neg(qy))

    def fold(f, t, step, *args):
        t, (a, b, c) = step(t, *args)
        return M._pin_fq12(M.fq12_mul_line(f, a, b, c)), M._pin_proj(t)

    for d in naf:
        f = T.fq12_sq(f)
        f, t = fold(f, t, M._dbl_step, xp, yp)
        if d:
            f, t = fold(f, t, M._add_step, qx, qy if d > 0 else nqy, xp, yp)
    q1x, q1y = M._twist_frob(qx, qy, 1)
    q2x, q2y = M._twist_frob(qx, qy, 2)
    f, t = fold(f, t, M._add_step, q1x, q1y, xp, yp)
    f, t = fold(f, t, M._add_step, q2x, T.fq2_neg(q2y), xp, yp)
    return f


def test_miller_unrolled_matches_scan_truncated_real_hash():
    """Scan Miller loop (digit scan + cond add branch + sign select) ==
    the plain Python composition of the same steps, on a truncated NAF
    schedule with both add signs, driven by REAL hash outputs
    (production bounds)."""
    hx, hy, found, _ = _hash_batch()
    assert bool(np.asarray(found).all())
    take2 = lambda e: L.elmap(lambda a: a[:, :2], e)
    hx, hy = take2(hx), take2(hy)
    pqx, pqy = CV.g2_batch_to_device_affine(
        [HC.g2_mul(HC.G2_ONE, 3 + i) for i in range(2)]
    )
    naf = (1, -1)
    got = _canon12(_miller_reference(hx, hy, pqx, pqy, naf))
    scan = jax.jit(lambda a, b, c, d: M.miller_loop(a, b, c, d, naf=naf))
    want = _canon12(scan(hx, hy, pqx, pqy))
    assert np.array_equal(got, want)


def test_exp_u_unrolled_matches_scan_truncated():
    """Scan exp_u (masked table select, multiply by one on zero windows)
    == a plain Python window loop that skips zero windows, on a
    cyclotomic input (easy-part image), batch 2."""
    import random

    random.seed(20260820)
    hs = [
        tuple(
            tuple((random.randrange(P), random.randrange(P)) for _ in range(3))
        for _ in range(2))
        for _ in range(2)
    ]
    hs = [
        HF.fq12_mul(
            HF.fq12_frob(g := HF.fq12_mul(HF.fq12_conj(f), HF.fq12_inv(f)), 2),
            g,
        )
        for f in hs
    ]

    def conv(path):
        return L.to_mont(L.from_ints([path(h) for h in hs]))

    dev = T.fq12_retag(T.Fq12(
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
    ))
    # one zero and one nonzero window
    windows = tuple(FE._U_WINDOWS[:2])
    assert 0 in windows and any(w for w in windows)

    f2 = T.fq12_retag(T.fq12_cyc_sq(dev))
    table = {1: dev, 2: f2, 3: T.fq12_retag(T.fq12_mul(f2, dev))}
    acc = dev
    for w in windows:
        acc = T.fq12_retag(T.fq12_cyc_sq(T.fq12_retag(T.fq12_cyc_sq(acc))))
        if w:
            acc = T.fq12_retag(T.fq12_mul(acc, table[w]))
    got = _canon12(acc)
    scan = jax.jit(lambda f: FE.exp_u(f, window_digits=windows))
    want = _canon12(scan(dev))
    assert np.array_equal(got, want)


def test_hash_to_verify_end_to_end_cpu():
    """REAL device-hash outputs through verify_batch_independent_staged
    (default CPU scan path): accept one, reject a tampered tuple.

    Batch 2 on purpose: the staged pipeline then compiles at exactly the
    (18, 2, 2) shapes test_device_pairing already uses, so the session
    pays the miller-scan XLA compile once, not twice."""
    from bn254_tpu.dist import batch_verify as BV
    from bn254_tpu.hash.tai import hash_to_g1_affine

    msgs2 = MSGS[:2]
    hx, hy, found, _ = _hash_batch()
    assert bool(np.asarray(found).all())
    take2 = lambda e: L.elmap(lambda a: a[:, :2], e)
    hx, hy = take2(hx), take2(hy)
    sks = [7, 11]
    hpts = [HC.g1_from_affine(hash_to_g1_affine(m)) for m in msgs2]
    sigs = [HC.g1_mul(h, k) for h, k in zip(hpts, sks)]
    pks = [HC.g2_mul(HC.G2_ONE, k) for k in sks]
    sigs[1] = HC.g1_mul(sigs[1], 3)  # tamper
    sx, sy = CV.g1_batch_to_device_affine(sigs)
    pqx, pqy = CV.g2_batch_to_device_affine(pks)
    ok = np.asarray(
        BV.verify_batch_independent_staged(hx, hy, sx, sy, pqx, pqy)
    )
    assert ok.tolist() == [True, False]
