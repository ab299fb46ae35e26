"""The AOT prewarm must compile exactly the production programs.

If the derived avals (shapes, dtypes, weak-typing, El vmax/lmax aux)
drift from what bench.py's host->device conversion actually produces,
the prewarm compiles programs nobody will ever dispatch and the cold
first-contact win silently evaporates. `precompile.validate` pins the
fingerprints plus the hash stage's lowered-HLO text, and the runner
equivalence test proves the direct-AOT execution path computes the
same answer as the normal jitted pipeline. Runs on the CPU backend
(avals and stage chaining are platform-agnostic at the jit boundary).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bn254_tpu.dist import batch_verify as BV
from bn254_tpu.dist import precompile as PC
from bn254_tpu.hash import tai_batch as TB


def test_validate_abstract_inputs_match_real():
    assert PC.validate(4) is True


def test_lower_chain_covers_pipeline():
    lowered, meta = PC.lower_adaptive(8)
    names = [n for n, _ in lowered]
    # the core programs must always be present; the widen/narrow pair
    # only on platforms running the wide scalar final exp
    for required in ("hash", "fused_points", "miller_reduce", "fe_easy",
                     "fe_exp_u", "fe_hard", "is_one", "bcast_ok"):
        assert required in names, names
    assert meta["B"] == 8 and meta["nbits"] > 0


def test_resize_keeps_aux():
    from bn254_tpu.fields import limbs as L

    el = L.from_ints([1, 2], vmax=1 << 64)
    r = PC._resize_el(el, 16)
    assert r.arr.shape == (el.arr.shape[0], 16)
    assert (r.vmax, r.lmax) == (el.vmax, el.lmax)
    assert isinstance(r.arr, jax.ShapeDtypeStruct)


@pytest.mark.skipif(
    not os.environ.get("BN254_RUN_SLOW"),
    reason="compiles the full pipeline twice on CPU (~25 min on a "
    "2-core host); the GPU bench --prewarm path asserts the same "
    "end-to-end equivalence on every run. Set BN254_RUN_SLOW=1.",
)
@pytest.mark.isolated
def test_prewarmed_runner_matches_jitted_pipeline():
    """End-to-end: the direct-AOT runner's (per_tuple, ok, found) must
    equal the normal jitted pipeline's on a real valid batch."""
    from bn254_tpu.hash.tai import hash_to_g1_with_ctr
    from bn254_tpu.host import curve as HC
    from bn254_tpu.protocol.types import PrivateKey
    from bn254_tpu.utils import convert as CV

    B, K = 8, 8
    # messages whose try-and-increment counter resolves within K (same
    # filter bench.py applies), so the valid batch must verify
    msgs, hpts = [], []
    i = 0
    while len(msgs) < B:
        m = b"bench-msg-%06d" % i
        i += 1
        (ax, ay), ctr = hash_to_g1_with_ctr(m)
        if ctr < K:
            msgs.append(m)
            hpts.append(HC.g1_from_affine((ax, ay)))
    sks = [PrivateKey(0x1234567 + 977 * j) for j in range(B)]
    sigs = [HC.g1_mul(h, k.scalar) for h, k in zip(hpts, sks)]
    pks = [HC.g2_mul(HC.G2_ONE, k.scalar) for k in sks]

    sx, sy = CV.g1_batch_to_device_affine(sigs)
    pqx, pqy = CV.g2_batch_to_device_affine(pks)
    blocks_np, cw, cs = TB.prepare_blocks_host(msgs)
    blocks = jnp.asarray(blocks_np)
    w = BV.random_weights(B)

    _, _, runner = PC.prewarm_adaptive(B, k_candidates=K, workers=2)
    per, ok, found = runner(blocks, sx, sy, pqx, pqy, w)

    hjit = jax.jit(functools.partial(TB.hash_to_g1_batch, k_candidates=K))
    hx, hy, found2, _ = hjit(blocks, cw, cs)
    ok2 = BV.verify_batch_fused_staged(hx, hy, sx, sy, pqx, pqy, w)

    assert np.array_equal(np.asarray(found), np.asarray(found2))
    assert np.asarray(found).all()
    assert bool(np.asarray(ok)) == bool(np.asarray(ok2)) is True
    per = np.asarray(per)
    assert per.shape == (B,) and per.all()
