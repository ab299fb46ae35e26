"""Concurrent AOT pre-compilation of the adaptive staged pipeline.

Cold first contact is dominated by compiling the staged pipeline's
programs, which compile SEQUENTIALLY at first call. The stages are
INDEPENDENT XLA programs and XLA compiles with the GIL released, so
compiling them concurrently on a thread pool cuts the compile wall
toward max(per-stage).

Tracing is the other half of a cold start, and jitted dispatch would
REPEAT it after an AOT warm-up (`.lower().compile()` does not populate
the jit dispatch cache). Two design rules follow:

  * trace ONCE: each stage is lowered and its `Lowered.out_info`
    (aval pytree WITH the El vmax/lmax aux) feeds the next stage's
    lowering — no separate eval_shape pass, no device work;
  * execute the AOT executables DIRECTLY: `prewarm_adaptive` returns a
    runner that calls the `Compiled` handles with the same host-side
    retag glue as `verify_batch_fused_staged` + `final_exp_staged`
    + the adaptive broadcast, so the production-equivalent pipeline
    runs with ZERO retracing and zero persistent-cache round trips.

The compiled executables also land in the persistent cache
(utils/jcache.py), so later sessions' ordinary jit dispatch gets warm
loads too.

Correctness of the aval derivation is testable, not assumed:
`validate()` builds a REAL fixture, converts it exactly as bench.py
does, and compares aval fingerprints plus the hash stage's lowered-HLO
text (tests/test_precompile.py runs it on CPU, plus an end-to-end
equivalence check of the runner against the normal jitted pipeline).

Cache-key identity note: the hash program mirrors bench.py's exact
construction (jax.jit over a functools.partial — the partial form and
the static_argnames form lower to DIFFERENT module names, hence
different persistent-cache keys; do not "clean this up" without
re-warming every cache).
"""

from __future__ import annotations

import functools
import os
import time
from concurrent.futures import ThreadPoolExecutor

import jax

from ..fields import limbs as L
from ..fields import tower as T
from ..hash import tai_batch as TB
from ..pairing import final_exp as FE
from ..pairing import pairing as DP
from . import batch_verify as BV


def _sds(shape, dtype=None):
    import jax.numpy as jnp

    return jax.ShapeDtypeStruct(tuple(shape), dtype or jnp.uint32)


def _resize_el(el: L.El, B: int) -> L.El:
    """Abstract El with the trailing batch dim set to B, same bounds."""
    shape = el.arr.shape[:-1] + (B,)
    return L.El(_sds(shape, el.arr.dtype), el.vmax, el.lmax)


def _resize_tree(tree, B: int):
    """Batch-resize every El leaf of an El/Fq2/GlvWeights/... tree."""
    if isinstance(tree, L.El):
        return _resize_el(tree, B)
    if isinstance(tree, BV.GLV.GlvWeights):
        return BV.GLV.GlvWeights(
            _resize_el(tree.a, B), _resize_el(tree.b, B), tree.bits
        )
    return type(tree)(*[_resize_tree(c, B) for c in tree])


def _hash_jit(k_candidates: int):
    """bench.py's exact hash-program construction (see module docstring
    for why the partial form is load-bearing)."""
    return jax.jit(
        functools.partial(TB.hash_to_g1_batch, k_candidates=k_candidates)
    )


def _tiny_input_avals(B: int):
    """(sig El, pk Fq2, weights) avals at batch B, derived from a tiny
    REAL conversion so the aux bounds are by-construction identical to
    what bench.py's host->device conversion produces."""
    from ..curve import glv as GLV
    from ..host import curve as HC
    from ..utils import convert as CV

    # two real points through the production converters (host math only)
    pts1 = [HC.G1_ONE, HC.g1_mul(HC.G1_ONE, 7)]
    pts2 = [HC.G2_ONE, HC.g2_mul(HC.G2_ONE, 7)]
    sx, _sy = CV.g1_batch_to_device_affine(pts1)
    pqx, _pqy = CV.g2_batch_to_device_affine(pts2)

    from .. import config as C

    bits = C.DEFAULT.rlc_bits
    if C.DEFAULT.glv_weights:
        w = GLV.glv_weights_to_device([(1, 0), (1, 1)], bits)
    else:
        w = BV.weights_to_device([1, 2], bits)

    el = _resize_tree(sx, B)
    fq2 = _resize_tree(pqx, B)
    wav = _resize_tree(w, B)
    return el, fq2, wav


def lower_adaptive(B: int, k_candidates: int = 8, msg_len: int = 16,
                   log=None):
    """Single-trace lowering of every adaptive-pipeline stage at batch
    B. Each stage's `out_info` (avals incl. El aux) feeds the next
    stage, exactly mirroring `verify_batch_fused_staged` +
    `final_exp_staged` + the per-tuple broadcast. No device work.

    Returns (lowered, meta): lowered = [(name, jax.stages.Lowered)],
    meta = dict(nbits=..., B=..., k=..., cw=..., cs=...).

    msg_len: message length in bytes (fixes the SHA block count; bench
    uses 16-byte messages -> 1 block)."""
    import jax.numpy as jnp

    blocks_np, cw, cs = TB.prepare_blocks_host([b"x" * msg_len])
    a_blocks = _sds((B,) + blocks_np.shape[1:], jnp.uint32)

    lowered = []

    def low(name, fn, *args, **kwargs):
        t0 = time.time()
        lw = fn.lower(*args, **kwargs)
        lowered.append((name, lw))
        if log:
            log(f"  lowered {name}: {time.time() - t0:.1f}s")
        return lw.out_info

    hjit = _hash_jit(k_candidates)
    hx_s, hy_s, _, _ = low("hash", hjit, a_blocks, cw, cs)

    el, fq2, w = _tiny_input_avals(B)
    nbits = w.half_bits if isinstance(w, BV.GLV.GlvWeights) else w.bits
    if isinstance(w, BV.PlainWeights):  # _resolve_weights unwraps it
        w = w.w

    pts_s = low("fused_points", BV._fused_points_jit,
                hx_s, hy_s, el, el, fq2, fq2, w, nbits=nbits)
    f_s = low("miller_reduce", BV._miller_reduce_jit, *pts_s)

    # final_exp_staged: retag -> easy -> exp_u x3 (ONE program:
    # easy/exp_u both retag their output to the same bound, so the aval
    # is a fixed point) -> hard.
    e_s = low("fe_easy", FE._easy_jit, T.fq12_retag(f_s))
    u_s = low("fe_exp_u", FE._exp_u_jit, e_s)
    h_s = low("fe_hard", FE._hard_jit, e_s, u_s, u_s, u_s)
    ok_s = low("is_one", DP._is_one_jit, h_s)
    low("bcast_ok", BV._bcast_ok_jit, ok_s, n=B)

    meta = dict(nbits=nbits, B=B, k=k_candidates,
                cw=cw, cs=cs, msg_len=msg_len)
    return lowered, meta


def compile_parallel(lowered, workers: int = 8, log=None):
    """Compile lowered stages on a thread pool (the XLA compile runs in
    C++ with the GIL released). Returns ({name: Compiled},
    {name: seconds}). Executables also land in the persistent cache."""
    compiled, times = {}, {}

    def one(item):
        name, low = item
        t0 = time.time()
        compiled[name] = low.compile()
        times[name] = round(time.time() - t0, 1)
        if log:
            log(f"  compiled {name}: {times[name]}s")

    with ThreadPoolExecutor(max_workers=workers) as ex:
        list(ex.map(one, lowered))
    return compiled, times


class PrewarmedAdaptive:
    """Direct-AOT execution of the adaptive pipeline: the `Compiled`
    stage handles with the same host-side retag glue as
    `verify_batch_fused_staged`/`final_exp_staged` — zero
    retracing, bit-identical math.

    __call__(blocks, sx, sy, pqx, pqy, w) -> (per_tuple, ok, found):
    per_tuple/ok stay on device (no host sync — the adaptive tier's
    deferred-decision property is preserved)."""

    def __init__(self, compiled: dict, meta: dict):
        self.c = compiled
        self.meta = meta

    def __call__(self, blocks, sx, sy, pqx, pqy, w):
        c, m = self.c, self.meta
        if isinstance(w, BV.PlainWeights):  # lowered against the raw El
            w = w.w
        hx, hy, found, _ = c["hash"](blocks, m["cw"], m["cs"])
        pts = c["fused_points"](hx, hy, sx, sy, pqx, pqy, w)
        f = c["miller_reduce"](*pts)
        f = c["fe_easy"](T.fq12_retag(f))
        t1 = c["fe_exp_u"](f)
        t2 = c["fe_exp_u"](t1)
        t3 = c["fe_exp_u"](t2)
        h = c["fe_hard"](f, t1, t2, t3)
        ok = c["is_one"](h)
        per_tuple = c["bcast_ok"](ok)
        return per_tuple, ok, found


def prewarm_adaptive(B: int, k_candidates: int = 8, msg_len: int = 16,
                     workers: int = 8, log=None):
    """Lower + parallel-compile the adaptive pipeline at batch B.
    Returns (total_wall_s, {name: compile_s}, PrewarmedAdaptive)."""
    t0 = time.time()
    lowered, meta = lower_adaptive(B, k_candidates, msg_len, log=log)
    t_lower = time.time() - t0
    if log:
        log(f"lowered {len(lowered)} stages in {t_lower:.1f}s")
    compiled, times = compile_parallel(lowered, workers=workers, log=log)
    return time.time() - t0, times, PrewarmedAdaptive(compiled, meta)


def cache_entry_count() -> int:
    """Entries in this platform's persistent-cache subdir (0 when the
    machine is fresh — the auto-prewarm signal)."""
    from ..utils import jcache

    try:
        return sum(
            1 for f in os.listdir(jcache.cache_dir()) if f.endswith("-cache")
        )
    except OSError:
        return 0


# ---------------------------------------------------------------------------
# validation: the abstract derivation must match the real pipeline
# ---------------------------------------------------------------------------


def _aval_fingerprint(tree):
    """(treedef incl. El aux, [shape/dtype/weak per leaf])."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return (
        str(treedef),
        [
            (tuple(x.shape), str(x.dtype), bool(getattr(x, "weak_type", False)))
            for x in leaves
        ],
    )


def validate(B: int = 4, k_candidates: int = 8, msg_len: int = 16):
    """Prove the abstract stage inputs match a REAL fixture's: builds B
    host tuples exactly as bench.py does, converts them with the
    production converters, and compares aval fingerprints of the
    pipeline inputs plus the lowered-HLO text of the first stage.
    Raises AssertionError on any mismatch. Host/CPU-safe."""
    from ..host import curve as HC
    from ..protocol.types import PrivateKey
    from ..utils import convert as CV

    assert msg_len == 16, "bench messages are 16 bytes"
    msgs = [b"bench-msg-%06d" % i for i in range(B)]
    sks = [PrivateKey(0x1234567 + 977 * i) for i in range(B)]
    from ..hash.tai import hash_to_g1

    hpts = [hash_to_g1(m) for m in msgs]
    sigs = [HC.g1_mul(h, k.scalar) for h, k in zip(hpts, sks)]
    pks = [HC.g2_mul(HC.G2_ONE, k.scalar) for k in sks]

    import jax.numpy as jnp

    sx, sy = CV.g1_batch_to_device_affine(sigs)
    pqx, pqy = CV.g2_batch_to_device_affine(pks)
    blocks_np, cw, cs = TB.prepare_blocks_host(msgs)
    blocks = jnp.asarray(blocks_np)
    w_real = BV.random_weights(B)

    el, fq2, w_abs = _tiny_input_avals(B)
    checks = {
        "sig_el": (sx, el),
        "pk_fq2": (pqx, fq2),
        "weights": (w_real, w_abs),
        "blocks": (blocks, _sds((B,) + blocks_np.shape[1:], jnp.uint32)),
    }
    for name, (real, abs_) in checks.items():
        fr, fa = _aval_fingerprint(real), _aval_fingerprint(abs_)
        assert fr == fa, f"{name} aval mismatch:\n real={fr}\n abs ={fa}"

    # the first stage's lowered HLO must be byte-identical between the
    # concrete call (what bench dispatches) and the abstract one
    hjit = _hash_jit(k_candidates)
    real_txt = _hash_jit(k_candidates).lower(blocks, cw, cs).as_text()
    abs_txt = hjit.lower(
        _sds((B,) + blocks_np.shape[1:], jnp.uint32), cw, cs
    ).as_text()
    assert real_txt == abs_txt, "hash stage HLO differs (abstract vs real)"
    return True
