#!/usr/bin/env python
"""Benchmark harness: BLS aggregate-signature throughput on one chip.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N}

Headline metric (default --mode adaptive): per-tuple verification
results at fused-RLC cost — device hash-to-G1 (masked K-candidate
search) + GLV weight ladders + one batched Miller loop + ONE shared
final exponentiation, with per-tuple bools produced device-side from
the RLC pre-check and an exact independent-tier fallback on rejection
(semantics: a forged batch slips past the pre-check with probability
~2^-rlc_bits over the weight draw — dist/batch_verify.py). The
pre-check decision bit rides an ASYNC device->host copy so back-to-back
batches pipeline without a mid-path stall; the bench resolves and
asserts every batch's decision after timing. vs_baseline is the speedup
over the single-threaded host (pure-Python-int) oracle doing the same
work — the closest stand-in for the reference's single-core Rust path,
since the reference publishes no numbers (BASELINE.md).

Timing uses tools/timing.measure: windows of back-to-back runs, each
ending in `jax.block_until_ready`. The JSON line names the device and
the card's name and power limit (`nvidia-smi`); the bench refuses to run
without a GPU unless BN254_FORCE_CPU asks for the CPU explicitly.

Extra detail lines go to stderr; pass --json-only to suppress them.
Flags: --smoke (tiny sizes for CI), --batch N,
--mode {independent,fused,sharded,fp12}.

What each measured program contains (honesty contract):
  adaptive    — device hash-to-G1 + RLC pre-check (one shared final
                exp) + device-side per-tuple bools; the decision
                readback overlaps the next rep (hash IN).
  independent — device hash-to-G1 + per-tuple pairing checks (hash IN).
  fused       — device hash-to-G1 + RLC weighting + one product check
                with ONE shared final exp (hash IN; config 4 on 1 chip).
  sharded     — the fused pipeline through `make_sharded_verifier` over
                a Mesh of all local devices of the default platform.
                Hash IN.
  fp12        — a dependent chain of whole-Fq12 muls (BASELINE metric 2).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def device_fields() -> dict:
    """The device as JAX reports it plus the card's name and power limit
    (`nvidia-smi`); "not measured" where there is no nvidia-smi."""
    import subprocess

    import jax

    d = jax.devices()
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        card = "not measured"
    return {"device": {"platform": d[0].platform, "kind": d[0].device_kind,
                       "count": len(d)},
            "card": card}


def bench_fp12_mul(args):
    """Fp12 muls/sec/chip (BASELINE.md metric 2): a jitted chain of
    dependent fq12_muls over a large batch."""
    import secrets

    import jax

    from bn254_tpu.constants import MONT_R, P
    from bn254_tpu.fields import limbs as L
    from bn254_tpu.fields import tower as T
    from tools.timing import measure, measure_compile_and_first

    B = args.batch or (128 if args.smoke else 8192)
    CHAIN = 4 if args.smoke else 16

    def rnd_el():
        return L.from_ints(
            [secrets.randbelow(P) * MONT_R % P for _ in range(B)], vmax=P
        )

    def rnd12():
        return T.Fq12(*[T.Fq6(*[T.Fq2(rnd_el(), rnd_el()) for _ in range(3)])
                        for _ in range(2)])

    a, b = rnd12(), rnd12()

    @jax.jit
    def chain(a, b):
        for _ in range(CHAIN):
            a = T.fq12_retag(T.fq12_mul(a, b))
        return a

    cold, _ = measure_compile_and_first(chain, a, b)
    log(f"fp12 chain compile+first (cold): {cold:.1f}s")
    dt = measure(chain, a, b, reps=2 if args.smoke else 8, inner=CHAIN)
    rate = B / dt
    log(f"fp12_mul: {dt*1e6:.1f} us per batch-{B} mul (warm)")
    print(json.dumps({
        "metric": "fp12_muls_per_sec_per_chip",
        "value": round(rate, 1),
        "unit": "muls/s",
        "vs_baseline": 1.0,
        **device_fields(),
    }), flush=True)


def bench_fused_chunked(args):
    """BASELINE config 5 existence proof: a ~1M-tuple fused verification
    streamed through HBM-sized chunks on ONE chip.

    The fused check's reductions are monoids (Fq12 product, G1 sum), so
    the batch runs as `--chunks` repetitions of the compiled local stage
    (device hash + GLV weight ladders + Miller loops + chunk reductions
    — the identical per-shard program of the mesh-sharded tier) plus two
    O(1) accumulators and ONE shared final exponentiation. The measured
    program contains the hash (honesty contract of --mode fused).

    The fixture (sigs, pks) is generated ON DEVICE (host signing of 1M
    tuples would take hours); sk_i are small odd ints — irrelevant to
    the measurement, since every verification kernel is fixed-schedule
    and input-value-independent. K=32 hash candidates: per-message miss
    probability 2^-32, so no host fallback is needed even at 1M.
    """
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from bn254_tpu.curve import g1 as DG1
    from bn254_tpu.curve import g2 as DG2
    from bn254_tpu.curve import glv as GLV
    from bn254_tpu.curve import jacobian as JJ
    from bn254_tpu.dist import batch_verify as BV
    from bn254_tpu.fields import limbs as L
    from bn254_tpu.hash import tai_batch as TB
    from bn254_tpu.utils import convert as CV
    from tools.timing import measure, measure_compile_and_first

    B = args.batch or (256 if args.smoke else 1048576)
    nch = args.chunks
    assert B % nch == 0, "batch must divide chunks"
    CH = B // nch
    K = 8 if args.smoke else 32

    t0 = time.time()
    msgs = [b"bench1m-%08d" % i for i in range(B)]
    blocks_np, ctr_word, ctr_shift = TB.prepare_blocks_host(msgs)
    log(f"host block prep: {time.time()-t0:.1f}s for B={B}")

    # Every first call below cold-compiles a chunk-shape program (the
    # compile itself is host-synchronous), so each first call is timed
    # and logged; CH=8192 reuses the fused-tier bench's stage programs
    # from the persistent cache.
    def timed_first(name, f, *a):
        tc = time.time()
        out = f(*a)
        log(f"  first call (compile) {name}: {time.time()-tc:.1f}s")
        return out

    t0 = time.time()
    _hash_jit = jax.jit(
        functools.partial(TB.hash_to_g1_batch, k_candidates=K)
    )
    sk_host = [((0x1234567 + 977 * i) % (1 << 30)) | 1 for i in range(B)]
    sig_mul = jax.jit(
        lambda hx, hy, sk: DG1.to_affine(
            DG1.scalar_mul(
                JJ.JPoint(hx, hy, L.mont_one(hx.batch_shape)), sk, 32
            )
        )
    )
    g2gen = DG2.generator((CH,))
    pk_mul = jax.jit(
        lambda sk: DG2.to_affine(DG2.scalar_mul(g2gen, sk, 32))
    )
    blocks_dev, sxs, sys, pqxs, pqys = [], [], [], [], []
    hx0 = hy0 = None
    for ci in range(nch):
        bl = jnp.asarray(blocks_np[ci * CH : (ci + 1) * CH])
        blocks_dev.append(bl)
        sk = CV.scalars_to_device(sk_host[ci * CH : (ci + 1) * CH])
        if ci == 0:
            hx, hy, found, _ = timed_first(
                f"hash K={K} [CH={CH}]", _hash_jit, bl, ctr_word, ctr_shift
            )
            sx, sy, _ = timed_first("sig scalar_mul", sig_mul, hx, hy, sk)
            pqx, pqy, _ = timed_first("pk G2 scalar_mul", pk_mul, sk)
            hx0, hy0 = hx, hy
        else:
            hx, hy, found, _ = _hash_jit(bl, ctr_word, ctr_shift)
            sx, sy, _ = sig_mul(hx, hy, sk)
            pqx, pqy, _ = pk_mul(sk)
        assert bool(np.asarray(found).all()), "fixture hash miss"
        sxs.append(sx)
        sys.append(sy)
        pqxs.append(pqx)
        pqys.append(pqy)
        if ci and ci % 16 == 0:
            log(f"  fixture chunk {ci}/{nch} ({time.time()-t0:.1f}s)")
    log(f"device fixture: {time.time()-t0:.1f}s ({nch} chunks of {CH})")

    w = BV.random_weights(B)
    ws = [
        BV._slice_batch(w, slice(ci * CH, (ci + 1) * CH))
        for ci in range(nch)
    ]
    from bn254_tpu.pairing import final_exp as FEX
    from bn254_tpu.pairing.pairing import _is_one_jit

    points = functools.partial(BV._fused_points_jit, nbits=w.half_bits)

    # pre-compile the streaming-stage programs on chunk 0, logged (a
    # stall here is attributable; everything after is warm)
    pts0 = timed_first(
        "fused_points [CH]", points,
        hx0, hy0, sxs[0], sys[0], pqxs[0], pqys[0], ws[0],
    )
    f0 = timed_first("miller_reduce [CH+1]", BV._miller_reduce_jit, *pts0)
    f0 = timed_first("chunk_combine", BV._chunk_combine_jit, f0, f0)
    timed_first(
        "final_exp_staged + is_one",
        lambda f: _is_one_jit(FEX.final_exp_staged(f)),
        f0,
    )

    def fn():
        f_acc = None
        founds = []
        for ci in range(nch):
            hx, hy, found, _ = _hash_jit(
                blocks_dev[ci], ctr_word, ctr_shift
            )
            pts = points(
                hx, hy, sxs[ci], sys[ci], pqxs[ci], pqys[ci], ws[ci]
            )
            f_c = BV._miller_reduce_jit(*pts)
            founds.append(found)
            f_acc = (
                f_c if f_acc is None
                else BV._chunk_combine_jit(f_acc, f_c)
            )
        ok = _is_one_jit(FEX.final_exp_staged(f_acc))
        return ok, jnp.stack(founds)

    cold, (ok0, found0) = measure_compile_and_first(fn)
    assert bool(np.asarray(found0).all()), "device hash missed a message"
    assert bool(np.asarray(ok0)), "chunked benchmark batch failed!"
    log(f"compile+first run (cold): {cold:.1f}s")
    dev_time = measure(fn, reps=1 if args.smoke else 2)
    rate = B / dev_time
    log(f"device (warm): {dev_time:.2f} s for {B} verifies "
        f"-> {rate:.1f} verifications/s/chip")
    print(json.dumps({
        "metric": "bls_verifications_per_sec_per_chip[fused_chunked]",
        "value": round(rate, 2),
        "unit": "verifications/s",
        "vs_baseline": 0.0,
        "cold_compile_s": round(cold, 1),
        "batch": B,
        "chunks": nch,
        **device_fields(),
    }), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--chunks", type=int, default=1,
                    help="stream --mode fused through this many chunks "
                    "(config-5 1M path; device-generated fixture)")
    ap.add_argument("--sharded-chunk", type=int, default=None,
                    help="with --mode sharded: stream the batch through "
                    "the mesh in chunks of this size (per-chunk sharded "
                    "Miller + collective, one shared final exp — the "
                    "full config-5 structure)")
    ap.add_argument("--mode", default="adaptive",
                    choices=["independent", "adaptive", "fused", "sharded",
                             "fp12"],
                    help="adaptive (default headline): per-tuple bools "
                    "at fused-RLC cost with exact independent fallback")
    ap.add_argument("--prewarm", default="auto",
                    choices=["auto", "on", "off"],
                    help="parallel AOT pre-compile of the stage programs "
                    "before the timed region (auto: only when the "
                    "persistent cache looks cold; counted into "
                    "cold_compile_s)")
    ap.add_argument("--pipeline", default="staged",
                    choices=["staged", "mono"],
                    help="staged: several small jitted programs (compiles "
                    "in seconds, same math); mono: one monolithic program")
    ap.add_argument("--json-only", action="store_true")
    args = ap.parse_args()

    import jax

    # BN254_FORCE_CPU=1: run the bench on the virtual CPU mesh (tiny
    # --smoke sizes; its numbers are not device numbers).
    if os.environ.get("BN254_FORCE_CPU"):
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        log(f"no GPU found (JAX device: {jax.devices()[0].platform}); "
            "set BN254_FORCE_CPU=1 to run on the CPU")
        sys.exit(2)

    from bn254_tpu.utils.jcache import enable as _enable_jax_cache

    _enable_jax_cache()

    if args.mode == "fp12":
        return bench_fp12_mul(args)
    if args.mode == "fused" and args.chunks > 1:
        return bench_fused_chunked(args)

    import jax.numpy as jnp
    import numpy as np

    from bn254_tpu import ECDSA, PrivateKey, PublicKey
    from bn254_tpu.dist import batch_verify as BV
    from bn254_tpu.hash import tai_batch as TB
    from bn254_tpu.hash.tai import hash_to_g1
    from bn254_tpu.host import curve as HC
    from bn254_tpu.utils import convert as CV
    from tools.timing import measure, measure_compile_and_first

    dev = jax.devices()[0]
    log(f"device: {dev.platform} {dev.device_kind}")

    # config 3 (independent) is specified at batch 64+ (we use 4096 for
    # steady-state); config 4 (fused/sharded product check) and the
    # adaptive headline at 8192.
    B = args.batch or (
        8 if args.smoke
        else (4096 if args.mode == "independent" else 8192)
    )

    # ---- build a valid batch (host-side fixtures) ----
    # Messages are filtered to those whose try-and-increment counter is
    # < K_CANDIDATES so the device hash resolves the whole batch (its
    # runtime is input-independent — all K candidates are computed for
    # every message — so this filtering does not bias the measurement;
    # production api.batch_verify handles the ~2^-K tail via the host
    # fallback in hash/tai_batch.py).
    from bn254_tpu.hash.tai import hash_to_g1_with_ctr

    K_CANDIDATES = 8
    t0 = time.time()
    msgs, hpts = [], []
    i = 0
    while len(msgs) < B:
        m = b"bench-msg-%06d" % i
        i += 1
        (hx_a, hy_a), ctr = hash_to_g1_with_ctr(m)
        if ctr < K_CANDIDATES:
            msgs.append(m)
            hpts.append(HC.g1_from_affine((hx_a, hy_a)))
    sks = [PrivateKey(0x1234567 + 977 * i) for i in range(B)]
    sigs = [HC.g1_mul(h, k.scalar) for h, k in zip(hpts, sks)]
    pks = [HC.g2_mul(HC.G2_ONE, k.scalar) for k in sks]
    log(f"fixture build: {time.time()-t0:.1f}s for B={B}")

    t0 = time.time()
    sx, sy = CV.g1_batch_to_device_affine(sigs)
    pqx, pqy = CV.g2_batch_to_device_affine(pks)
    blocks_np, ctr_word, ctr_shift = TB.prepare_blocks_host(msgs)
    blocks = jnp.asarray(blocks_np)
    log(f"host->device conversion: {time.time()-t0:.1f}s")

    # ---- device benchmark ----
    if args.mode == "independent":
        # config 3, hash INCLUDED: device SHA-256 K-candidate search +
        # per-tuple pairing checks. A tuple whose hash misses all K
        # counters (prob ~2^-K per msg) would need the host fallback;
        # the bench asserts none did.
        from functools import partial

        if args.pipeline == "mono":

            @partial(jax.jit, static_argnames=("k",))
            def config3(blocks, sx, sy, pqx, pqy, k):
                hx, hy, found, _ = TB.hash_to_g1_batch(
                    blocks, ctr_word, ctr_shift, k_candidates=k
                )
                ok = BV.verify_batch_independent(hx, hy, sx, sy, pqx, pqy)
                return ok, found
        else:
            _hash_jit = jax.jit(
                TB.hash_to_g1_batch, static_argnames=("k_candidates",)
            )

            def config3(blocks, sx, sy, pqx, pqy, k):
                hx, hy, found, _ = _hash_jit(
                    blocks, ctr_word, ctr_shift, k_candidates=k
                )
                ok = BV.verify_batch_independent_staged(
                    hx, hy, sx, sy, pqx, pqy
                )
                return ok, found

        sxe, sye = sx, sy

        def fn():
            return config3(blocks, sxe, sye, pqx, pqy, K_CANDIDATES)

        cold, (ok0, found0) = measure_compile_and_first(fn)
        ok0, found0 = np.asarray(ok0), np.asarray(found0)
        assert found0.all(), "device hash missed a message (raise K)"
        assert ok0.all(), "benchmark batch failed verification!"
        reps = 1 if args.smoke else 4
        dev_time = measure(fn, reps=reps)
    else:
        # configs 4(-5): RLC product check, ONE shared final exp. The
        # measured program includes the device hash (same honesty
        # standard as the independent mode — round 2 used host-side
        # hash points here and under-counted).
        from functools import partial

        _hash_jit = jax.jit(
            partial(TB.hash_to_g1_batch, k_candidates=K_CANDIDATES)
        )
        w = BV.random_weights(B)  # GlvWeights (config.glv_weights default)
        from bn254_tpu import config as _C

        if not _C.DEFAULT.glv_weights:
            # validated at conversion, device-resident across reps
            w = BV.weights_to_device(BV.random_weights_plain(B))

        if args.mode == "sharded":
            from jax.sharding import Mesh

            devs = np.array(jax.devices())
            mesh = Mesh(devs, ("batch",))
            log(f"sharded mode: mesh axis 'batch' over {devs.size} "
                f"{devs.flat[0].platform} device(s)")
            run_sharded = BV.make_sharded_verifier(mesh, "batch")

            def fn0(hx, hy, sx, sy, pqx, pqy, w):
                return run_sharded(
                    hx, hy, sx, sy, pqx, pqy, w, chunk=args.sharded_chunk
                )
        elif args.mode == "adaptive":
            # per-tuple bools via the RLC pre-check fast path (all-valid
            # batch -> ONE shared final exp). defer=True: the per-tuple
            # answer is a DEVICE broadcast of the pre-check bit and the
            # decision readback rides async, so the measured reps
            # pipeline back-to-back with no mid-path host stall; every
            # rep's decision is resolved (and asserted) after timing.
            results = []

            def fn0(hx, hy, sx, sy, pqx, pqy, w):
                res = BV.verify_batch_adaptive(
                    hx, hy, sx, sy, pqx, pqy, weights=w, defer=True
                )
                results.append(res)
                return res.per_tuple
        else:
            fn0 = BV.verify_batch_fused_staged

        def fn():
            hx, hy, found, _ = _hash_jit(blocks, ctr_word, ctr_shift)
            return fn0(hx, hy, sx, sy, pqx, pqy, w), found

        # Cold-start: on a fresh machine (empty persistent cache) the
        # stage programs compile sequentially at first call and jit
        # dispatch then RE-traces what an AOT warm-up already traced.
        # dist/precompile.py fixes both: every stage is lowered ONCE
        # (out_info chaining), compiled CONCURRENTLY (XLA compiles with
        # the GIL released), and the measured fn then executes the
        # Compiled handles DIRECTLY (same programs, zero retrace).
        # Skipped on the CPU, when the cache is warm (jit dispatch loads
        # cache entries in seconds) or for modes it doesn't cover.
        # prewarm_s counts into cold_compile_s (honesty contract).
        from bn254_tpu import config as _CB

        prewarm_s = 0.0
        runner = None
        if (
            args.prewarm != "off"
            and args.mode in ("adaptive", "fused")
            and _CB.platform() != "cpu"
        ):
            from bn254_tpu.dist import precompile as PC

            # threshold 4: a warmed headline cache holds ~7 entries (the
            # sub-second programs fall below jax's min-persist time and
            # are never written), a fresh machine holds 0-1
            n_cached = PC.cache_entry_count()
            if args.prewarm == "on" or n_cached < 4:
                log(f"parallel AOT prewarm ({n_cached} cache entries)...")
                prewarm_s, ptimes, runner = PC.prewarm_adaptive(
                    B, k_candidates=K_CANDIDATES, workers=8, log=log
                )
                log(f"prewarm: {prewarm_s:.1f}s wall "
                    f"(sum of stages {sum(ptimes.values()):.1f}s)")
            else:
                log(f"prewarm skipped (cache warm: {n_cached} entries)")

        if runner is not None:
            # direct-AOT path: identical stage programs, no retracing
            if args.mode == "adaptive":

                def fn():
                    per, ok, found = runner(blocks, sx, sy, pqx, pqy, w)
                    return per, found
            else:

                def fn():
                    per, ok, found = runner(blocks, sx, sy, pqx, pqy, w)
                    return ok, found

        cold, (ok0, found0) = measure_compile_and_first(fn)
        cold += prewarm_s
        assert bool(np.asarray(found0).all()), \
            "device hash missed a message (raise K)"
        assert bool(np.asarray(ok0).all()), "fused benchmark batch failed!"
        reps = 1 if args.smoke else 4
        dev_time = measure(fn, reps=reps)
        if args.mode == "adaptive":
            # resolve every deferred decision (none may need fallback)
            for res in results:
                assert bool(np.asarray(res.resolve()).all()), \
                    "adaptive batch failed after resolve!"
            log(f"adaptive: resolved {len(results)} deferred decisions, "
                "all accepted (no fallback launched)")

    log(f"compile+first run (cold): {cold:.1f}s")
    dev_rate = B / dev_time
    log(f"device (warm): {dev_time*1e3:.1f} ms for {B} verifies "
        f"-> {dev_rate:.1f} verifications/s/chip")

    # ---- host-oracle baseline (sample a few) ----
    nb = min(3, B)
    t0 = time.time()
    for i in range(nb):
        pk = PublicKey(pks[i])
        from bn254_tpu.protocol.types import Signature

        ECDSA.verify(msgs[i], Signature(sigs[i]), pk)
    host_rate = nb / (time.time() - t0)
    log(f"host oracle: {host_rate:.2f} verifications/s (single-threaded)")

    result = {
        "metric": f"bls_verifications_per_sec_per_chip[{args.mode}]",
        "value": round(dev_rate, 2),
        "unit": "verifications/s",
        "vs_baseline": round(dev_rate / host_rate, 2),
        "cold_compile_s": round(cold, 1),
        "batch": B,
        **device_fields(),
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
