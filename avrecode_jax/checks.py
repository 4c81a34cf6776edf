"""Bit-exactness checks of the device compress path against the host C++
reference (the plain serial implementation). tests/test_gpu.py and
chip_smoke.py both call these, so what the tests check and what the chip
smoke runs cannot drift. The product gate is exact equality: no tolerance.

Failures raise MismatchError (not `assert`, which `python -O` strips)."""
from __future__ import annotations

import numpy as np

from . import device, pipeline


class MismatchError(AssertionError):
    pass


def chunk_differential(data: bytes, *, chunk_mode: int, model_profile: int,
                       batch_size: int = 4096) -> int:
    """Device probabilities (on JAX's default device) against the host C++
    model's on every chunk, exactly. Returns the number of chunks checked."""
    an = device.analyze(data, chunk_mode=chunk_mode, batch_size=batch_size,
                        model_profile=model_profile)
    for i, c in enumerate(an.chunks):
        got = device.device_probs(an, c)
        if not np.array_equal(got, c.host_probs):
            bad = (int(np.count_nonzero(got != c.host_probs))
                   if got.shape == c.host_probs.shape else "shape")
            raise MismatchError(f"chunk {i}: {bad} of {len(c.host_probs)} device "
                                f"probabilities differ from the host model's")
    return len(an.chunks)


def check_roundtrip(data: bytes, container: bytes) -> None:
    """The host serial decoder must restore `data` byte for byte."""
    dec, _ = pipeline.decompress(container)
    if dec != data:
        raise MismatchError(f"host decoder restored {len(dec)} B that differ "
                            f"from the {len(data)} B input")


def container_matches(data: bytes, reference_device, **compress_kw) -> bytes:
    """device.compress on JAX's default device must make the same container,
    byte for byte, as on `reference_device`, and that container must decode
    on the host. Returns the container."""
    import jax
    comp, _ = device.compress(data, **compress_kw)
    with jax.default_device(reference_device):
        ref, _ = device.compress(data, **compress_kw)
    if comp != ref:
        raise MismatchError(f"container ({len(comp)} B) differs from the one made "
                            f"on {reference_device} ({len(ref)} B)")
    check_roundtrip(data, comp)
    return comp


def mesh_matches(data: bytes, mesh, *, chunk_mode: int, force_lanes: int,
                 batch_size: int = 4096) -> bytes:
    """device.compress_mesh over `mesh` must make the same container, byte
    for byte, as single-device device.compress with the same lane count, and
    that container must decode on the host. Returns the container."""
    kw = dict(chunk_mode=chunk_mode, batch_size=batch_size, force_lanes=force_lanes)
    comp_mesh, _ = device.compress_mesh(data, mesh, **kw)
    comp_single, _ = device.compress(data, **kw)
    if comp_mesh != comp_single:
        raise MismatchError(f"mesh {dict(mesh.shape)} container ({len(comp_mesh)} B) "
                            f"differs from the single-device one ({len(comp_single)} B)")
    check_roundtrip(data, comp_mesh)
    return comp_mesh
