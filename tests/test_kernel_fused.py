"""Tower-level operations vs the pure-Python host oracle.

fq2/fq12 multiplications at a batch that is not a power of two, an
unbatched NumPy constant operand broadcast against a batch, the
fixed-exponent pow at the two production exponents, and every loop
body's trace at a realistic batch (eval_shape, no compile).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np

from bn254_tpu.constants import MONT_R, P
from bn254_tpu.fields import limbs as L
from bn254_tpu.fields import tower as T
from bn254_tpu.host import field as HF
from bn254_tpu.pairing import final_exp as FE
from bn254_tpu.pairing import miller as M

RNG = random.Random(20260819)


def _mont(vals, vmax=P):
    return L.from_ints([v * MONT_R % P for v in vals], vmax=vmax)


def _fq2_dev(hs):
    return T.Fq2(_mont([h[0] for h in hs]), _mont([h[1] for h in hs]))


def _fq2_host(d):
    c0 = L.to_ints(L.from_mont(d.c0)).reshape(-1)
    c1 = L.to_ints(L.from_mont(d.c1)).reshape(-1)
    return [(int(a), int(b)) for a, b in zip(c0, c1)]


def _rnd_fq2(n):
    return [(RNG.randrange(P), RNG.randrange(P)) for _ in range(n)]


def test_fused_op_machinery_interpret_bit_exact():
    """fq2_mul (3 leaf multiplies, Karatsuba glue) at 1030 lanes — not a
    power of two — equals the host oracle lane by lane, jitted and eager
    bit for bit."""
    a, b = _rnd_fq2(1030), _rnd_fq2(1030)
    da, db = _fq2_dev(a), _fq2_dev(b)
    out = jax.jit(T.fq2_mul)(da, db)
    assert _fq2_host(out) == [HF.fq2_mul(x, y) for x, y in zip(a, b)]
    eager = T.fq2_mul(da, db)
    for e, j in zip(eager, out):
        assert np.array_equal(np.asarray(e.arr), np.asarray(j.arr))


def test_fused_op_unbatched_const_operand():
    """An UNBATCHED (18,) NumPy constant operand (const_fq2) broadcasts
    per the limbs._bc convention against a (18, 64) batch."""
    a = _rnd_fq2(64)
    c = T.const_fq2((5, 7))  # (18,) numpy-backed constant components
    out = jax.jit(T.fq2_mul)(_fq2_dev(a), c)
    assert _fq2_host(out) == [HF.fq2_mul(x, (5, 7)) for x in a]


def test_pow_fixed_fused_matches_scan():
    """pow_fixed at the two production exponents (Fermat inverse p-2,
    sqrt (p+1)/4) and two small ones == Python pow, lane by lane."""
    vals = [RNG.randrange(1, P) for _ in range(6)]
    a = _mont(vals)
    for exponent in (P - 2, (P + 1) // 4, 1, 5):
        got = L.to_ints(L.from_mont(
            jax.jit(lambda x, e=exponent: L.pow_fixed(x, e))(a)
        )).reshape(-1)
        assert [int(g) for g in got] == [pow(v, exponent, P) for v in vals]


def test_kernel_bodies_trace_without_captured_arrays():
    """Every loop body of the pipeline — the Miller loop, exp_u, the GLV
    ladder, the fixed pow — traces at a 2048-lane batch via eval_shape
    (static bounds and shapes only; nothing compiles)."""
    from bn254_tpu.curve import glv as GLV
    from bn254_tpu.curve import jacobian as JJ

    def mk(shape=(2048,)):
        return L.El(jax.ShapeDtypeStruct((18,) + shape, jnp.uint32),
                    L.STD_BOUND, 1 << 16)

    e = mk()
    f2 = T.Fq2(e, e)
    f12 = T.Fq12(*[T.Fq6(f2, f2, f2) for _ in range(2)])
    w = GLV.GlvWeights(L.El(mk().arr, 1 << 64, 1 << 15),
                       L.El(mk().arr, 1 << 64, 1 << 15), 128)

    out = jax.eval_shape(M.miller_loop, e, e, f2, f2)
    assert out.c0.c0.c0.arr.shape == (18, 2048)
    out = jax.eval_shape(FE.exp_u, f12)
    assert out.c1.c2.c1.arr.shape == (18, 2048)
    out = jax.eval_shape(GLV.shamir_scalar_mul, JJ.JPoint(e, e, e), w)
    assert out.z.arr.shape == (18, 2048)
    out = jax.eval_shape(L.inv_mod, e)
    assert out.arr.shape == (18, 2048)
