"""Direct entropy-coder unit tests (the reference
property-tests its coder the same way, reference test/arithmetic_code.cpp):

- randomized rANS property test with per-context biases, cross-checking the
  JAX encoder against the C++ encoder byte-for-byte and the C++ decoder
  against the source bits;
- truncated / garbage blob behavior (clean errors, never crashes);
- randomized CabacEncoder <-> CabacDecoder differential (flush and renorm
  edges no x264 stream emits);
- opt-in ThreadSanitizer run over every threaded pipeline (ARTC_TSAN=1).
"""
import ctypes
import os
import subprocess

import numpy as np
import pytest

from avrecode_jax import host

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _selftest_lib():
    lib = host.lib()
    if not hasattr(lib, "_selftest_ready"):
        lib.artc_rans_encode.restype = ctypes.c_int
        lib.artc_rans_encode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_uint64, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.artc_rans_decode.restype = ctypes.c_int
        lib.artc_rans_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.artc_cabac_fuzz.restype = ctypes.c_int
        lib.artc_cabac_fuzz.argtypes = [ctypes.c_uint64, ctypes.c_int]
        lib._selftest_ready = True
    return lib


def _random_biased_stream(rng, n, n_ctx=37):
    """Per-context random biases, the reference's property-test shape
    (test/arithmetic_code.cpp:49-111): context probabilities in (0,1), bits
    sampled accordingly, per-bin prob = the context's (q15, clamped)."""
    ctx_p = rng.uniform(0.02, 0.98, n_ctx)
    ctx = rng.integers(0, n_ctx, n)
    p = ctx_p[ctx]
    bits = (rng.random(n) < p).astype(np.uint8)
    probs = np.clip((p * 32768).astype(np.uint32), 1, 32767).astype(np.uint16)
    return bits, probs


def _c_encode(bits, probs, lanes):
    lib = _selftest_lib()
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    rc = lib.artc_rans_encode(
        bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        probs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        len(bits), lanes, ctypes.byref(out), ctypes.byref(out_len))
    assert rc == 0, lib.artc_last_error().decode()
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.artc_free(out)


def _c_decode(blob, probs, n):
    lib = _selftest_lib()
    bits_out = np.zeros(n, np.uint8)
    rc = lib.artc_rans_decode(
        blob, len(blob), probs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        n, bits_out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return rc, bits_out


@pytest.mark.parametrize("lanes", [1, 4, 64])
@pytest.mark.parametrize("n", [1, 17, 5000])
def test_rans_randomized_roundtrip(lanes, n):
    rng = np.random.default_rng(lanes * 1000 + n)
    bits, probs = _random_biased_stream(rng, n)
    blob = _c_encode(bits, probs, lanes)
    rc, dec = _c_decode(blob, probs, n)
    assert rc == 0
    assert np.array_equal(dec, bits)


@pytest.mark.parametrize("lanes", [1, 4, 64])
def test_rans_jax_encoder_byte_identical(lanes):
    from avrecode_jax.ops import lanes as lx
    rng = np.random.default_rng(lanes)
    bits, probs = _random_biased_stream(rng, 4096)
    blob_c = _c_encode(bits, probs, lanes)
    blob_j = lx.encode_interleaved(bits, probs, lanes)
    assert blob_j == blob_c


def test_rans_extreme_probs_roundtrip():
    """p=1/32768 and p=32767/32768 bins (the clamp extremes) must survive."""
    rng = np.random.default_rng(7)
    n = 2048
    bits = rng.integers(0, 2, n).astype(np.uint8)
    probs = np.where(bits == 1, 32767, 1).astype(np.uint16)  # always-cheap
    blob = _c_encode(bits, probs, 4)
    rc, dec = _c_decode(blob, probs, n)
    assert rc == 0 and np.array_equal(dec, bits)
    probs_bad = np.where(bits == 1, 1, 32767).astype(np.uint16)  # worst case
    blob2 = _c_encode(bits, probs_bad, 4)
    rc2, dec2 = _c_decode(blob2, probs_bad, n)
    assert rc2 == 0 and np.array_equal(dec2, bits)


def test_rans_truncated_and_garbage_blobs_error_cleanly():
    rng = np.random.default_rng(3)
    bits, probs = _random_biased_stream(rng, 3000)
    blob = _c_encode(bits, probs, 4)
    for cut in (0, 4, 7, len(blob) // 2, len(blob) - 1):
        rc, _ = _c_decode(blob[:cut], probs, 3000)
        assert rc == -1, f"truncation at {cut} must fail cleanly"
    garbage = bytes(rng.integers(0, 256, 64, dtype=np.uint8))
    rc, _ = _c_decode(garbage, probs[:16], 16)
    assert rc == -1


@pytest.mark.parametrize("seed", [1, 2, 3, 0xDEADBEEF])
@pytest.mark.parametrize("n", [1, 100, 20000])
def test_cabac_encoder_decoder_differential(seed, n):
    lib = _selftest_lib()
    rc = lib.artc_cabac_fuzz(seed, n)
    assert rc == 0, lib.artc_last_error().decode()


@pytest.mark.parametrize("mps_pct", [50, 90, 99])
@pytest.mark.parametrize("seed", [7, 11, 0xC0FFEE])
def test_cabac_encoder_carry_stress(seed, mps_pct):
    """MPS-biased streams drive contexts to their extreme probability states,
    where the byte-wise encoder's deferred-0xff runs and held-byte carry
    ripples (cabac.h shovel) occur constantly — differential vs the decoder
    over long streams."""
    lib = _selftest_lib()
    rc = lib.artc_cabac_fuzz_biased(seed, 200_000, mps_pct)
    assert rc == 0, lib.artc_last_error().decode()


def test_tsan_clean(corpus_dir, tmp_path):
    """Builds the library under ThreadSanitizer and drives the threaded
    pipelines (pass-1 walkers, sectioned model pool, probe threads, parallel
    decompress) through real clips. Runs by default on one small clip
    (~25 s); set ARTC_TSAN=1 for the full multi-clip sweep."""
    exe = str(tmp_path / "tsan_check")
    subprocess.run(
        ["g++", "-fsanitize=thread", "-O1", "-g", "-std=c++17",
         "-I", os.path.join(REPO, "avrecode_jax", "native"),
         "-o", exe,
         os.path.join(REPO, "avrecode_jax", "native", "recode.cc"),
         os.path.join(REPO, "tools", "tsan_check.cc"),
         "-lpthread"],
        check=True, capture_output=True)
    names = (("ipb_high.mp4", "multislice.264")
             if os.environ.get("ARTC_TSAN") else ("multislice.264",))
    clips = [os.path.join(corpus_dir, c) for c in names]
    res = subprocess.run([exe] + clips, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "ThreadSanitizer" not in res.stderr, res.stderr[-2000:]


def test_div_q_magic_exact():
    """PriorModel::div_q replaces the hot-loop hardware divisions with
    round-up magic multipliers: floor(n/d) == (n * ceil(2^36/d)) >> 36 for
    n < 2^25, d <= 2048. Verify the identity at the adversarial points (the
    floor boundaries n = k*d - 1 and k*d, plus the bound extremes) for every
    denominator — format-defining, must hold exactly."""
    import numpy as np
    rng = np.random.default_rng(7)
    for d in range(1, 2049):
        m = ((1 << 36) + d - 1) // d
        kmax = ((1 << 25) - 1) // d
        ks = np.unique(np.concatenate([
            np.array([1, 2, kmax], dtype=np.int64),
            rng.integers(1, kmax + 1, 256, dtype=np.int64),
        ]))
        for n in (ks * d - 1, np.minimum(ks * d, (1 << 25) - 1)):
            assert np.array_equal((n.astype(np.uint64) * np.uint64(m)) >> np.uint64(36),
                                  (n // d).astype(np.uint64)), d
