"""Device mesh construction for GOP x lane sharding.

The framework's parallel axes (SURVEY.md §2.9, §5 — all new design; the
reference is single-threaded):
  - 'gop':  data parallelism over independent chunks (IDR-delimited GOPs).
            Chunks share no model or CABAC state by construction (per-chunk
            estimator tables), so this axis scales linearly.
  - 'lane': within-chunk parallelism over rANS entropy lanes; lanes are
            independent streams, so the lane-encode scan shards with no
            collectives. Cross-axis reductions (byte totals, billing) are
            psums (NCCL between GPUs).
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_gop: int | None = None, n_lane: int = 1, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_gop is None:
        n_gop = n // n_lane
    assert n_gop * n_lane <= n, f"mesh {n_gop}x{n_lane} needs {n_gop * n_lane} devices, have {n}"
    arr = np.array(devices[: n_gop * n_lane]).reshape(n_gop, n_lane)
    return Mesh(arr, axis_names=("gop", "lane"))
