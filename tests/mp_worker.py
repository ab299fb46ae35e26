"""Worker process for the multi-process distributed test (not a pytest file).

Launched N times by tests/test_multiprocess.py with
  python mp_worker.py <process_id> <num_processes> <port>
Each process contributes one CPU device to a process-spanning mesh and
runs the FULL sharded fused verification pipeline (weight ladders, Miller
loops, cross-PROCESS Fq12-product all-reduce over gloo, G1 sum
all-reduce, shared final exponentiation) on a valid batch and a tampered
batch. Prints MP-RESULT lines the parent asserts on.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.pop("XLA_FLAGS", None)  # exactly one local CPU device

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
from bn254_tpu.utils.jcache import enable as _enable_jax_cache
_enable_jax_cache()


def main():
    proc_id, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

    from bn254_tpu.config import Config
    from bn254_tpu.dist import mesh as MESH

    started = MESH.initialize(
        Config.from_env(
            coordinator_address=f"127.0.0.1:{port}",
            num_processes=nproc,
            process_id=proc_id,
        )
    )
    assert started, "distributed init returned False"
    pid, pcount = MESH.process_info()
    assert (pid, pcount) == (proc_id, nproc)
    n_dev = len(jax.devices())
    assert n_dev == nproc, f"expected {nproc} global devices, got {n_dev}"
    print(f"MP-INIT proc={proc_id} global_devices={n_dev}", flush=True)

    from bn254_tpu.dist import batch_verify as BV
    from bn254_tpu.hash.tai import hash_to_g1
    from bn254_tpu.host import curve as HC
    from bn254_tpu.protocol.types import PrivateKey
    from bn254_tpu.utils import convert as CV

    mesh = MESH.make_mesh(axis_name="batch")

    # fixtures must be IDENTICAL on every process (SPMD input contract)
    B = 2 * nproc  # two tuples per shard
    msgs = [b"mp-%d" % i for i in range(B)]
    sks = [PrivateKey(424243 + 13 * i) for i in range(B)]
    hpts = [hash_to_g1(m) for m in msgs]
    sigs = [HC.g1_mul(h, k.scalar) for h, k in zip(hpts, sks)]
    pks = [HC.g2_mul(HC.G2_ONE, k.scalar) for k in sks]
    weights = [1] + [0x9E3779B97F4A7C15 + 2 * i for i in range(B - 1)]

    hx, hy = CV.g1_batch_to_device_affine(hpts)
    sx, sy = CV.g1_batch_to_device_affine(sigs)
    pqx, pqy = CV.g2_batch_to_device_affine(pks)

    run = BV.make_sharded_verifier(mesh, "batch")
    ok = bool(jax.device_get(run(hx, hy, sx, sy, pqx, pqy, weights)))
    print(f"MP-RESULT proc={proc_id} valid={ok}", flush=True)

    # tampered batch (signature 3 signed with the wrong key) must reject
    sigs_bad = list(sigs)
    sigs_bad[3] = HC.g1_mul(hpts[3], sks[2].scalar)
    sxb, syb = CV.g1_batch_to_device_affine(sigs_bad)
    bad = bool(jax.device_get(run(hx, hy, sxb, syb, pqx, pqy, weights)))
    print(f"MP-RESULT proc={proc_id} tampered={bad}", flush=True)

    assert ok and not bad

    if os.environ.get("MP_BENCH_COLLECTIVE"):
        _bench_collective(mesh, proc_id, nproc)

    print(f"MP-DONE proc={proc_id}", flush=True)


def _bench_collective(mesh, proc_id: int, nproc: int):
    """Time the cross-PROCESS Fq12-product all-reduce alone (VERDICT r4
    #8): the cross-process per-round collective cost, measured
    on this real jax.distributed gloo cluster over TCP instead of taken
    from the literature. A no-collective program with the same launch/
    sync structure is timed too; the difference isolates the collective.
    """
    import time

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as PSpec

    from bn254_tpu.constants import P
    from bn254_tpu.dist import collectives as COLL
    from bn254_tpu.dist import mesh as MESH
    from bn254_tpu.fields import limbs as L
    from bn254_tpu.fields import tower as T

    def el(seed):
        return L.from_ints(
            [(seed * 0x9E3779B9 + i) % P for i in range(nproc)], vmax=P
        )

    f = T.Fq12(*[T.Fq6(*[T.Fq2(el(6 * h + 2 * v), el(6 * h + 2 * v + 1))
                         for v in range(3)]) for h in range(2)])
    (f,) = MESH.shard_tree((f,), mesh, "batch")
    spec = PSpec(None, "batch")

    def coll_fn(x):
        x = jax.tree_util.tree_map(lambda a: a[..., 0], x)
        return T.fq12_retag(COLL.fq12_allreduce_mul(x, "batch", nproc))

    def base_fn(x):
        x = jax.tree_util.tree_map(lambda a: a[..., 0], x)
        return T.fq12_retag(T.fq12_mul(x, x))

    coll_jit = jax.jit(jax.shard_map(
        coll_fn, mesh=mesh, in_specs=(spec,), out_specs=PSpec(),
        check_vma=False,
    ))
    base_jit = jax.jit(jax.shard_map(
        base_fn, mesh=mesh, in_specs=(spec,), out_specs=PSpec(),
        check_vma=False,
    ))

    def timed(fn, reps=64):
        out = fn(f)  # warm (compile)
        np.asarray(jax.device_get(out.c0.c0.c0.arr))
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(f)
            # sync EVERY iteration: each gloo round trip must complete
            # before the next starts, so reps don't pipeline
            np.asarray(jax.device_get(out.c0.c0.c0.arr[0]))
        return (time.perf_counter() - t0) / reps

    t_coll = timed(coll_jit)
    t_base = timed(base_jit)
    if proc_id == 0:
        print(
            f"MP-COLL nproc={nproc} t_coll_us={t_coll*1e6:.1f} "
            f"t_base_us={t_base*1e6:.1f} "
            f"t_round_us={(t_coll-t_base)*1e6:.1f}",
            flush=True,
        )


if __name__ == "__main__":
    main()
