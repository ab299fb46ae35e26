"""Test configuration.

Tests run on a virtual 8-device CPU mesh (no accelerator required) so that the
multi-chip sharding paths are exercised in CI, per SURVEY.md §4. The env
vars must be set before JAX is imported anywhere.
"""

import os
import sys

# Force CPU even if the environment preselects an accelerator: the test
# suite targets the virtual 8-device CPU mesh, never the real card.
# The in-process config update below is authoritative pre-backend-init.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# jcache.enable() DISABLES the persistent compilation cache on the CPU
# backend (deserializing persisted XLA:CPU executables segfaulted test
# sessions — see utils/jcache.py); tests rely on jax's in-memory cache.
import jax

jax.config.update("jax_platforms", "cpu")
from bn254_tpu.utils.jcache import enable as _enable_jax_cache
_enable_jax_cache()

# ---------------------------------------------------------------------------
# Subprocess isolation for compile-heavy dist tests (VERDICT r4 weak #1)
# ---------------------------------------------------------------------------
# A full-suite session deterministically crashes XLA:CPU (SIGABRT/
# SIGSEGV inside backend_compile_and_load) when it re-compiles one of
# the big staged-pipeline programs after ~49 tests' worth of accumulated
# in-process compile state; each crashing test passes in a fresh
# process. Until the upstream compiler bug is fixed, tests marked
# `isolated` execute in a fresh python subprocess (one per test), the
# same way test_multiprocess.py already isolates its workers.

import subprocess

import pytest

_ISOLATED_ENV = "BN254_TEST_ISOLATED"
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "isolated: run this test in a fresh python subprocess "
        "(XLA:CPU accumulated-compile-state crash hygiene)",
    )


def _subprocess_runtest(item):
    def run():
        env = dict(os.environ)
        env[_ISOLATED_ENV] = "1"
        r = subprocess.run(
            [
                sys.executable, "-m", "pytest", "-q", "-x",
                "-p", "no:cacheprovider", item.nodeid,
            ],
            cwd=_REPO,
            env=env,
            capture_output=True,
            text=True,
            timeout=1800,
        )
        if r.returncode != 0:
            tail = "\n".join(
                (r.stdout + "\n" + r.stderr).splitlines()[-40:]
            )
            pytest.fail(
                f"isolated subprocess for {item.nodeid} failed "
                f"(rc={r.returncode}):\n{tail}",
                pytrace=False,
            )

    return run


def pytest_collection_modifyitems(config, items):
    if os.environ.get(_ISOLATED_ENV):
        return  # already inside a child: run normally
    for item in items:
        if item.get_closest_marker("isolated"):
            item.runtest = _subprocess_runtest(item)
