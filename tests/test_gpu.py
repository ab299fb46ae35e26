"""Checks that mean something only on the card (marker `gpu`).

The decision is made inside the `gpu` fixture, never at import, so every
pytest worker collects the same tests; on the CPU they skip with a
reason. `chip_smoke.py` runs the same checks on the card.
"""

import importlib.util
import os

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this on the card")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
def test_field_and_pairing_bit_exact_on_card(gpu):
    ph = gpu.Phases()
    gpu.phase_field(ph)
    gpu.phase_pairing(ph)
