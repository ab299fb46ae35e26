"""Mesh collectives on the virtual 8-device CPU mesh.

Covers the cross-chip machinery (Fq12-product all-reduce, G1-sum
all-reduce) with cheap shard functions; the full sharded verification
step is exercised by __graft_entry__.dryrun_multichip (heavier compile).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as PSpec

from bn254_tpu.curve import g1 as DG1
from bn254_tpu.dist import collectives as COLL
from bn254_tpu.fields import limbs as L
from bn254_tpu.fields import tower as T
from bn254_tpu.host import curve as C
from bn254_tpu.host import field as HF


N_DEV = 8


@pytest.fixture(scope="module")
def mesh():
    devs = jax.devices()
    if len(devs) < N_DEV:
        pytest.skip(f"need {N_DEV} devices, have {len(devs)}")
    return Mesh(np.array(devs[:N_DEV]), axis_names=("batch",))


def test_fq12_allreduce_mul(mesh):
    import random

    random.seed(7)
    from bn254_tpu.constants import P

    hs = [
        tuple(
            tuple((random.randrange(P), random.randrange(P)) for _ in range(3))
            for _ in range(2)
        )
        for _ in range(N_DEV)
    ]

    def conv(path):
        return L.to_mont(L.from_ints([path(h) for h in hs]))

    dev = T.Fq12(
        T.Fq6(
            *[
                T.Fq2(
                    conv(lambda h, i=i: h[0][i][0]),
                    conv(lambda h, i=i: h[0][i][1]),
                )
                for i in range(3)
            ]
        ),
        T.Fq6(
            *[
                T.Fq2(
                    conv(lambda h, i=i: h[1][i][0]),
                    conv(lambda h, i=i: h[1][i][1]),
                )
                for i in range(3)
            ]
        ),
    )

    def shard_fn(f):
        # each shard holds one Fq12 (batch dim 1); drop it, reduce, return
        f1 = jax.tree_util.tree_map(lambda x: x[:, 0], f)
        out = COLL.fq12_allreduce_mul(f1, "batch", N_DEV)
        return jax.tree_util.tree_map(lambda x: x[:, None], out)

    fn = jax.jit(
        jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=PSpec(None, "batch"),
            out_specs=PSpec(None, "batch"),
            check_vma=False,
        )
    )
    out = fn(dev)
    # every shard must hold the full product
    outs = T.fq12_to_host(out)
    expected = HF.FQ12_ONE
    for h in hs:
        expected = HF.fq12_mul(expected, h)
    expected = HF._canon12(expected)
    for j in range(N_DEV):
        got = tuple(
            tuple((int(c2[0][j]), int(c2[1][j])) for c2 in c6) for c6 in outs
        )
        assert got == expected, f"shard {j} product mismatch"


def _rand_fq12_host(rng, n):
    from bn254_tpu.constants import P

    return [
        tuple(
            tuple((rng.randrange(P), rng.randrange(P)) for _ in range(3))
            for _ in range(2)
        )
        for _ in range(n)
    ]


def _fq12_to_device(hs):
    def conv(path):
        return L.to_mont(L.from_ints([path(h) for h in hs]))

    return T.Fq12(
        *[
            T.Fq6(
                *[
                    T.Fq2(
                        conv(lambda h, s=s, i=i: h[s][i][0]),
                        conv(lambda h, s=s, i=i: h[s][i][1]),
                    )
                    for i in range(3)
                ]
            )
            for s in range(2)
        ]
    )


@pytest.mark.parametrize("n_dev", [3, 5, 6, 7])
def test_fq12_allreduce_mul_non_power_of_two(n_dev):
    """The binary-expansion all-reduce must be exact for ANY axis size."""
    import random

    devs = jax.devices()
    if len(devs) < n_dev:
        pytest.skip(f"need {n_dev} devices, have {len(devs)}")
    mesh = Mesh(np.array(devs[:n_dev]), axis_names=("batch",))
    rng = random.Random(11 + n_dev)
    hs = _rand_fq12_host(rng, n_dev)
    dev = _fq12_to_device(hs)

    def shard_fn(f):
        f1 = jax.tree_util.tree_map(lambda x: x[:, 0], f)
        out = COLL.fq12_allreduce_mul(f1, "batch", n_dev)
        return jax.tree_util.tree_map(lambda x: x[:, None], out)

    fn = jax.jit(
        jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=PSpec(None, "batch"),
            out_specs=PSpec(None, "batch"),
            check_vma=False,
        )
    )
    outs = T.fq12_to_host(fn(dev))
    expected = HF.FQ12_ONE
    for h in hs:
        expected = HF.fq12_mul(expected, h)
    expected = HF._canon12(expected)
    for j in range(n_dev):
        got = tuple(
            tuple((int(c2[0][j]), int(c2[1][j])) for c2 in c6) for c6 in outs
        )
        assert got == expected, f"shard {j} product mismatch (n={n_dev})"


def test_allreduce_rejects_bad_axis_size():
    from bn254_tpu.errors import InvalidLengthError

    with pytest.raises(InvalidLengthError):
        COLL.allreduce_monoid(None, None, "batch", 0)


def test_fq12_allreduce_shard_order_invariance(mesh):
    """Determinism across shard orders (SURVEY §5.2): the all-reduce is a
    commutative monoid — permuting which rank holds which contribution
    must produce bit-identical products on every rank."""
    import random

    rng = random.Random(23)
    hs = _rand_fq12_host(rng, N_DEV)

    def run(order):
        dev = _fq12_to_device([hs[i] for i in order])

        def shard_fn(f):
            f1 = jax.tree_util.tree_map(lambda x: x[:, 0], f)
            out = COLL.fq12_allreduce_mul(f1, "batch", N_DEV)
            return jax.tree_util.tree_map(lambda x: x[:, None], out)

        fn = jax.jit(
            jax.shard_map(
                shard_fn,
                mesh=mesh,
                in_specs=PSpec(None, "batch"),
                out_specs=PSpec(None, "batch"),
                check_vma=False,
            )
        )
        out = fn(dev)
        # canonical host values: must be identical across orders
        return T.fq12_to_host(out)

    base = run(list(range(N_DEV)))
    perm = run(list(reversed(range(N_DEV))))
    for c6b, c6p in zip(base, perm):
        for c2b, c2p in zip(c6b, c6p):
            for eb, ep in zip(c2b, c2p):
                assert np.array_equal(np.asarray(eb), np.asarray(ep))


def test_fq12_allreduce_run_to_run_determinism(mesh):
    """Same seed => bit-identical Fq12 product bits across two runs."""
    import random

    rng = random.Random(29)
    hs = _rand_fq12_host(rng, N_DEV)
    dev = _fq12_to_device(hs)

    def shard_fn(f):
        f1 = jax.tree_util.tree_map(lambda x: x[:, 0], f)
        out = COLL.fq12_allreduce_mul(f1, "batch", N_DEV)
        return jax.tree_util.tree_map(lambda x: x[:, None], out)

    fn = jax.jit(
        jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=PSpec(None, "batch"),
            out_specs=PSpec(None, "batch"),
            check_vma=False,
        )
    )
    a = jax.tree_util.tree_map(np.asarray, fn(dev))
    b = jax.tree_util.tree_map(np.asarray, fn(dev))
    la = jax.tree_util.tree_leaves(a)
    lb = jax.tree_util.tree_leaves(b)
    assert all(np.array_equal(x, y) for x, y in zip(la, lb))


def test_g1_allreduce_add(mesh):
    pts = [C.g1_mul(C.G1_ONE, 3 + 5 * i) for i in range(N_DEV)]
    dev = DG1.from_host(pts)

    def shard_fn(p):
        p1 = jax.tree_util.tree_map(lambda x: x[:, 0], p)
        out = COLL.jacobian_allreduce_add(p1, DG1.add, "batch", N_DEV)
        return jax.tree_util.tree_map(lambda x: x[:, None], out)

    fn = jax.jit(
        jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=PSpec(None, "batch"),
            out_specs=PSpec(None, "batch"),
            check_vma=False,
        )
    )
    res = DG1.to_host_affine(fn(dev))
    expected = C.g1_to_affine(C.g1_mul(C.G1_ONE, sum(3 + 5 * i for i in range(N_DEV))))
    for j in range(N_DEV):
        assert res[j] == expected, f"shard {j} sum mismatch"


def test_scaling_report_round_count(monkeypatch):
    """allreduce_monoid's ppermute round count for any axis size is the
    documented floor(log2 n) doubling rounds plus one permute per extra
    set bit of n: count actual _ppermute_shift calls with the monoid run
    off-mesh, for every axis size 2..17, power-of-two or not."""
    for n in range(2, 18):
        calls = []
        monkeypatch.setattr(
            COLL, "_ppermute_shift",
            lambda x, axis_name, axis_size, shift: calls.append(shift) or x,
        )
        COLL.allreduce_monoid(1.0, lambda a, b: a, "batch", n)
        want = (n.bit_length() - 1) + (bin(n).count("1") - 1)
        assert len(calls) == want, (
            f"axis size {n}: expected {want} rounds, "
            f"collective ran {len(calls)}"
        )
