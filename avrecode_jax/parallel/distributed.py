"""Multi-host orchestration: corpus-scale recompression over jax.distributed.

The reference has no distributed story whatsoever (strictly single-threaded,
reference recode.cpp:122; SURVEY.md §2.9/§5). This module is the framework's
scale-out layer:

  - host axis: independent *files* (or file shards) are distributed
    round-robin across processes — recompression is embarrassingly parallel
    at file granularity, and per-IDR chunking (chunk_mode=1) makes even a
    single huge file splittable into independent work units.
  - device axis: within a host, chunks shard over the local mesh
    (parallel/mesh.py, 'gop' axis) and rANS lanes over 'lane'.
  - pipeline: host-side syntax analysis (C++ thread pool, GIL released
    during the ctypes call) overlaps the previous file's device model pass —
    a two-stage producer/consumer pipeline, since the host walk and the
    device scan use disjoint resources.

Stats are merged across hosts with a single psum over a fixed-width stats
vector (the only cross-host collective; everything else is file-local).
"""
from __future__ import annotations

import concurrent.futures as _fut
import os
import time
from dataclasses import dataclass, field

import numpy as np

from .. import device as dev
from .. import host


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """Initializes jax.distributed when a multi-process run is configured.

    Returns (process_index, process_count). Single-process (no coordinator
    and no JAX_COORDINATOR env) is a no-op — the local path stays usable
    without any cluster setup.
    """
    import jax
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR", "")
    if coordinator:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1")),
            process_id=process_id if process_id is not None
            else int(os.environ.get("JAX_PROCESS_ID", "0")),
        )
    return jax.process_index(), jax.process_count()


@dataclass
class CorpusReport:
    files: int = 0
    input_bytes: int = 0
    output_bytes: int = 0
    failures: int = 0
    wall_s: float = 0.0
    per_file: list = field(default_factory=list)  # (path, in, out, seconds)

    @property
    def ratio(self) -> float:
        return self.output_bytes / self.input_bytes if self.input_bytes else 1.0


def _compress_one(path: str, out_dir: str, use_device: bool, chunk_mode: int,
                  batch_size: int, verify: bool) -> tuple[str, int, int, float]:
    with open(path, "rb") as f:
        data = f.read()
    t0 = time.time()
    if use_device:
        comp, _ = dev.compress(data, chunk_mode=chunk_mode, batch_size=batch_size)
    else:
        comp, _ = host.compress(data, chunk_mode=chunk_mode, batch_size=batch_size)
    if verify:
        back, _ = host.decompress(comp)
        if back != data:
            raise RuntimeError(f"roundtrip mismatch for {path}")
    out_path = os.path.join(out_dir, os.path.basename(path) + ".atrc")
    # Atomic write: an output file existing at all means it is complete, so
    # resumed runs can trust existence (interrupted writes leave only .tmp).
    tmp_path = out_path + ".tmp"
    with open(tmp_path, "wb") as f:
        f.write(comp)
    os.replace(tmp_path, out_path)
    return out_path, len(data), len(comp), time.time() - t0


def _resume_done(path: str, out_dir: str) -> tuple[str, int, int, float] | None:
    """Returns the completed-file record if `path` was already recompressed
    (checkpoint/resume: outputs are written atomically, so an existing
    container with the right magic AND the current format version is
    complete — a stale container from an older round would no longer
    decompress, so it must be redone, not skipped)."""
    out_path = os.path.join(out_dir, os.path.basename(path) + ".atrc")
    try:
        with open(out_path, "rb") as f:
            hdr = f.read(5)
        if hdr[:4] != b"ATRC" or len(hdr) < 5 or hdr[4] != host.container_version():
            return None
        return out_path, os.path.getsize(path), os.path.getsize(out_path), 0.0
    except OSError:
        return None


def corpus_compress(paths: list[str], out_dir: str, *, use_device: bool = False,
                    chunk_mode: int = 1, batch_size: int = 4096, verify: bool = True,
                    host_workers: int = 2, resume: bool = False) -> CorpusReport:
    """Recompresses a corpus, sharded across jax processes.

    Host-path files run concurrently on a thread pool (the C++ pipeline
    releases the GIL and is internally chunk-parallel); device-path files are
    serialized on the accelerator but their host analysis overlaps the
    previous file's device work through the executor.

    Every process works on its `process_index`-strided subset; the merged
    report (all files) is returned on every process via a psum collective.
    """
    import jax
    import jax.numpy as jnp

    pidx, pcount = jax.process_index(), jax.process_count()
    os.makedirs(out_dir, exist_ok=True)
    mine = [p for i, p in enumerate(sorted(paths)) if i % pcount == pidx]
    rep = CorpusReport()
    t0 = time.time()
    if resume:
        remaining = []
        for p in mine:
            done = _resume_done(p, out_dir)
            if done is not None:
                rep.files += 1
                rep.input_bytes += done[1]
                rep.output_bytes += done[2]
                rep.per_file.append(done)
            else:
                remaining.append(p)
        mine = remaining
    with _fut.ThreadPoolExecutor(max_workers=max(1, host_workers)) as ex:
        futs = {ex.submit(_compress_one, p, out_dir, use_device, chunk_mode,
                          batch_size, verify): p for p in mine}
        for fu in _fut.as_completed(futs):
            try:
                out_path, n_in, n_out, secs = fu.result()
                rep.files += 1
                rep.input_bytes += n_in
                rep.output_bytes += n_out
                rep.per_file.append((out_path, n_in, n_out, secs))
            except Exception:
                rep.failures += 1
    rep.wall_s = time.time() - t0

    if pcount > 1:
        # One fixed-width psum merges the scalar stats across hosts.
        local = jnp.asarray(
            [rep.files, rep.input_bytes, rep.output_bytes, rep.failures], jnp.int64)
        total = np.asarray(_psum_across_processes(local))
        rep.files, rep.input_bytes, rep.output_bytes, rep.failures = (
            int(total[0]), int(total[1]), int(total[2]), int(total[3]))
    return rep


def _psum_across_processes(x):
    """All-reduce a small vector over every device of every process."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    try:  # jax >= 0.8 top-level API; the experimental path is deprecated
        from jax import shard_map
    except ImportError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map

    devices = np.array(jax.devices())
    mesh = Mesh(devices, ("d",))
    n = len(devices)
    # Each process contributes its value once (on its first local device),
    # zeros elsewhere, then psum over the device axis.
    contrib = np.zeros((n,) + x.shape, dtype=np.int64)
    first_local = jax.process_index() * jax.local_device_count()
    contrib[first_local] = np.asarray(x)

    @jax.jit
    def reduce(c):
        return shard_map(lambda v: jax.lax.psum(v[0], "d"), mesh=mesh,
                         in_specs=P("d"), out_specs=P())(c)

    return reduce(contrib)
