"""ctypes bindings to the native host library (libartc.so).

The native library holds the H.264 entropy engine, prior model, rANS lanes,
and container pipelines (avrecode_jax/native/). It is built on demand by one
compiler call (build_native); the Python layer stays a thin, dependency-free
wrapper (no pybind11).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from dataclasses import dataclass, field

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")
_BUILD_DIR = os.path.join(_NATIVE_DIR, "build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libartc.so")

N_KLASSES = 11
KLASS_NAMES = ["other", "sig", "eob", "res", "bypass_other", "bypass_res", "terminate", "sign", "cbf", "skip", "mvd_sign"]


class ArtcStatsC(ctypes.Structure):
    _fields_ = [
        ("input_bytes", ctypes.c_uint64),
        ("output_bytes", ctypes.c_uint64),
        ("cabac_in_bytes", ctypes.c_uint64),
        ("recoded_bytes", ctypes.c_uint64),
        ("literal_bytes", ctypes.c_uint64),
        ("n_slices", ctypes.c_int32),
        ("n_fallback", ctypes.c_int32),
        ("n_chunks", ctypes.c_int32),
        ("total_bins", ctypes.c_uint64),
        ("klass_mbits", ctypes.c_uint64 * N_KLASSES),
        ("klass_count", ctypes.c_uint64 * N_KLASSES),
        ("klass_cabac_mbits", ctypes.c_uint64 * N_KLASSES),
        ("eob_cabac_mbits", ctypes.c_uint64),
        ("nz_mbits", ctypes.c_uint64),
        ("nz_count", ctypes.c_uint64),
        ("eob_count", ctypes.c_uint64),
        ("ref_mbits", ctypes.c_uint64),
    ]


@dataclass
class Stats:
    input_bytes: int = 0
    output_bytes: int = 0
    cabac_in_bytes: int = 0
    recoded_bytes: int = 0
    literal_bytes: int = 0
    n_slices: int = 0
    n_fallback: int = 0
    n_chunks: int = 0
    total_bins: int = 0
    bill: dict = field(default_factory=dict)
    # Reference-model head-to-head total (bytes the reference's model would
    # have spent on the same bins; 0 unless ARTC_REFMODEL=1 — refmodel.h).
    ref_model_bytes: float = 0.0

    @classmethod
    def from_c(cls, c: ArtcStatsC) -> "Stats":
        bill = {
            KLASS_NAMES[i]: {
                "count": int(c.klass_count[i]),
                "bytes": c.klass_mbits[i] / 8000.0,
                "cabac_bytes": c.klass_cabac_mbits[i] / 8000.0,
            }
            for i in range(N_KLASSES)
        }
        bill["nz"] = {"count": int(c.nz_count), "bytes": c.nz_mbits / 8000.0}
        bill["eob_free_bins"] = {
            "count": int(c.eob_count),
            "bytes": 0.0,
            "cabac_bytes": c.eob_cabac_mbits / 8000.0,
        }
        return cls(
            ref_model_bytes=c.ref_mbits / 8000.0,
            input_bytes=int(c.input_bytes),
            output_bytes=int(c.output_bytes),
            cabac_in_bytes=int(c.cabac_in_bytes),
            recoded_bytes=int(c.recoded_bytes),
            literal_bytes=int(c.literal_bytes),
            n_slices=int(c.n_slices),
            n_fallback=int(c.n_fallback),
            n_chunks=int(c.n_chunks),
            total_bins=int(c.total_bins),
            bill=bill,
        )


def _needs_rebuild() -> bool:
    if not os.path.exists(_LIB_PATH):
        return True
    lib_mtime = os.path.getmtime(_LIB_PATH)
    for root, _dirs, files in os.walk(_NATIVE_DIR):
        if root.startswith(_BUILD_DIR):
            continue
        for fn in files:
            if fn.endswith((".h", ".cc")):
                if os.path.getmtime(os.path.join(root, fn)) > lib_mtime:
                    return True
    return False


def _build_id() -> str:
    """Build provenance baked into the container header (recode.h
    ARTC_BUILD_ID): the git revision of the sources, or "nogit" outside a
    git checkout."""
    try:
        r = subprocess.run(["git", "rev-parse", "--short=12", "HEAD"], cwd=_NATIVE_DIR,
                           capture_output=True, text=True)
    except FileNotFoundError:
        return "nogit"
    return r.stdout.strip() if r.returncode == 0 and r.stdout.strip() else "nogit"


def build_native(force: bool = False) -> str:
    """Builds libartc.so if missing, stale or `force`d; returns its path.

    recode.cc is the library's only translation unit, so the build is one
    compiler call. It is tuned for the building host (-march=native), which
    is why the library is always built on the machine that loads it. The
    output is renamed into place, so concurrent builders (test workers) never
    load a half-written library. NDEBUG: the hot loops carry liberal asserts;
    production error handling is exceptions plus the compress-time byte-exact
    verification gate."""
    if not force and not _needs_rebuild():
        return _LIB_PATH
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    r = subprocess.run(
        ["c++", "-std=c++17", "-O3", "-Wall", "-DNDEBUG", "-march=native",
         "-shared", "-fPIC", "-pthread", f"-DARTC_BUILD_ID=\"{_build_id()}\"",
         f"-I{_NATIVE_DIR}", "-o", tmp, os.path.join(_NATIVE_DIR, "recode.cc")],
        capture_output=True, text=True)
    if r.returncode != 0:
        raise NativeError(f"native build failed:\n{r.stderr[-4000:]}")
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


_lib = None


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(build_native())
        _lib.artc_compress.restype = ctypes.c_int
        _lib.artc_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ArtcStatsC),
        ]
        _lib.artc_decompress.restype = ctypes.c_int
        _lib.artc_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ArtcStatsC),
        ]
        _lib.artc_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        _lib.artc_last_error.restype = ctypes.c_char_p
        _lib.artc_container_version.restype = ctypes.c_int
    return _lib


def container_version() -> int:
    """The native library's ATRC container version (recode.h)."""
    return int(lib().artc_container_version())


class NativeError(RuntimeError):
    pass


def _call(fn, data: bytes, *args) -> tuple[bytes, Stats]:
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    st = ArtcStatsC()
    rc = fn(data, len(data), *args, ctypes.byref(out), ctypes.byref(out_len), ctypes.byref(st))
    if rc != 0:
        raise NativeError(lib().artc_last_error().decode())
    try:
        result = ctypes.string_at(out, out_len.value)
    finally:
        lib().artc_free(out)
    return result, Stats.from_c(st)


def compress(data: bytes, lanes: int = 16, chunk_mode: int = 0,
             batch_size: int = 1, model_profile: int = 0) -> tuple[bytes, Stats]:
    return _call(lib().artc_compress, data, lanes, chunk_mode, batch_size, model_profile)


def decompress(data: bytes) -> tuple[bytes, Stats]:
    return _call(lib().artc_decompress, data)
