"""The one backend decision (`config.platform`) and what follows it.

The field engine takes one form on every platform (lax.scan carry chains
and CIOS steps: tiny loop bodies whose compile time stays bounded on
XLA:GPU), so the traced programs must not depend on the platform. The
persistent compile cache does: off on the CPU, and at a fixed path (or
`JAX_COMPILATION_CACHE_DIR`) elsewhere.
"""

import os

import jax
import jax.numpy as jnp
import pytest

from bn254_tpu import config as C
from bn254_tpu.fields import limbs as L
from bn254_tpu.fields import tower as T
from bn254_tpu.utils import jcache


def _el(n=4):
    return L.El(jnp.ones((18, n), jnp.uint32), L.P, 1 << 15)


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_field_code_is_platform_independent(monkeypatch, platform):
    """mont_mul and the carry chains trace to the same scan programs
    whatever the platform reports, with no Pallas call anywhere."""
    a = _el()
    cols = jnp.ones((18, 4), jnp.uint32)

    def traces():
        return (
            str(jax.make_jaxpr(lambda x, y: L.mont_mul(x, y).arr)(a, a)),
            str(jax.make_jaxpr(lambda c: L._carry_u(c, 18, 1 << 16))(cols)),
        )

    want = traces()
    monkeypatch.setattr(C, "platform", lambda: platform)
    got = traces()
    assert got == want
    for text in got:
        assert "scan" in text and "pallas_call" not in text


def test_tower_op_traces_without_dispatch(monkeypatch):
    """fq12_mul is one traced program of scans (no nested step-body
    dispatch) on a platform reported as "gpu"."""
    monkeypatch.setattr(C, "platform", lambda: "gpu")
    e = _el()
    f2 = T.Fq2(e, e)
    f12 = T.Fq12(*[T.Fq6(f2, f2, f2) for _ in range(2)])
    text = str(jax.make_jaxpr(T.fq12_mul)(f12, f12))
    assert "scan" in text and "pallas_call" not in text


def test_platform_reads_config_without_backend(monkeypatch):
    """With a platform named in the settings, the decision never asks
    jax.default_backend() (which would initialise the backend before a
    multi-process worker's jax.distributed.initialize)."""
    def boom():
        raise AssertionError("default_backend() must not be called")

    monkeypatch.setattr(jax, "default_backend", boom)
    assert jax.config.jax_platforms == "cpu"  # tests/conftest.py names it
    assert C.platform() == "cpu"


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jcache.cache_dir() == str(tmp_path)


def test_cache_dir_default_is_fixed(monkeypatch):
    """Without the env var the path depends only on the checkout, the
    platform and the JAX version: two calls (and two processes) agree."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(C, "platform", lambda: "gpu")
    d = jcache.cache_dir()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert d == os.path.join(repo, ".jax_cache", f"gpu-jax{jax.__version__}")
    assert jcache.cache_dir() == d


def test_cache_disabled_on_cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jcache.enable().startswith("<disabled")
    assert not jax.config.jax_enable_compilation_cache
