"""chip_smoke.py's contract pieces that a CPU can check: the result line,
the refusal of a CPU device, and a non-zero exit with no result line
when the script runs where JAX finds no GPU."""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _module():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Dev:
    def __init__(self, platform, kind):
        self.platform = platform
        self.device_kind = kind


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_shape(count):
    cs = _module()
    devs = [_Dev("gpu", "NVIDIA H100 80GB HBM3")] * count
    line = cs.result_line(devs)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": count},
    }


def test_refuses_cpu_device():
    cs = _module()
    with pytest.raises(SystemExit) as e:
        cs.require_gpu(jax.devices())
    assert e.value.code not in (0, None)


def test_refuses_too_few_gpus():
    cs = _module()
    with pytest.raises(SystemExit) as e:
        cs.require_gpu([_Dev("gpu", "H100")] * 2, count=4)
    assert e.value.code not in (0, None)
    cs.require_gpu([_Dev("gpu", "H100")] * 4, count=4)  # enough: no exit


def test_script_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, SCRIPT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
