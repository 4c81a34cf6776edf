"""The device compress path on an NVIDIA GPU against the host C++ reference:
exact per-chunk probabilities, a container byte-identical to the CPU
backend's, and a host decode that restores the input. These are the checks
chip_smoke.py runs (both call avrecode_jax.checks).

Run on the card with the CPU backend alongside (the reference container):
  JAX_PLATFORMS=cuda,cpu python -m pytest tests/test_gpu.py
Without a GPU every test skips."""
import os

import pytest

pytestmark = pytest.mark.gpu

BENCHDATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "benchdata")
PROFILE2_CLIPS = [("bench.mp4", 0), ("multigop720.mp4", 1)]


@pytest.fixture(scope="module")
def cpu_reference():
    """Skips unless JAX's default device is a GPU; returns the CPU device the
    reference containers are made on."""
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda,cpu on the card)")
    return jax.devices("cpu")[0]


def _clip(name: str) -> bytes:
    with open(os.path.join(BENCHDATA, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("clip,chunk_mode", PROFILE2_CLIPS)
def test_gpu_differential(cpu_reference, clip, chunk_mode):
    from avrecode_jax import checks
    assert checks.chunk_differential(_clip(clip), chunk_mode=chunk_mode,
                                     model_profile=2) > 0


@pytest.mark.parametrize("clip,chunk_mode", PROFILE2_CLIPS)
def test_gpu_container_matches_cpu(cpu_reference, clip, chunk_mode):
    from avrecode_jax import checks
    checks.container_matches(_clip(clip), cpu_reference, chunk_mode=chunk_mode)


def test_gpu_profile0(cpu_reference):
    from avrecode_jax import checks
    data = _clip("multigop.mp4")
    assert checks.chunk_differential(data, chunk_mode=0, model_profile=0) > 0
    checks.container_matches(data, cpu_reference, model_profile=0)
