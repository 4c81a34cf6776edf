#!/usr/bin/env python3
"""Chip smoke: the device compress path on NVIDIA GPUs, end to end.

Drives device.compress — the host C++ syntax walk, the ANL5 chunk export, the
on-device wire expand, frozen-batch model scan and rANS lane scan, the host
container pack — over the committed real clips, and holds it to the host C++
reference: exact probabilities on every chunk, a container byte-identical to
the one JAX's CPU backend makes, and a host decode that restores the input.

Phases, in one process (any failure exits non-zero before the result line):
  1. device: a GPU is required, with no CPU fallback; prints the card and its
     power limit.
  2. native build: libartc.so rebuilt from the checkout's sources (set-up).
  3. model profile 2 on benchdata/bench.mp4 (chunk_mode 0) and
     benchdata/multigop720.mp4 (chunk_mode 1): cold and warm wall times,
     the per-chunk differential, container equality with the CPU backend,
     the host roundtrip, per-program device time and the device idle share
     from a profiler trace of one warm run, and peak device memory.
  4. model profile 0 on benchdata/multigop.mp4: differential, container
     equality with the CPU backend, host roundtrip.

--four-cards runs only the sharded path: device.compress_mesh over four GPUs
with (gop, lane) meshes (4, 1) and (2, 2), each container byte-identical to
single-card device.compress and decoded on the host.

Usage: python chip_smoke.py [--four-cards]
The last line of stdout is the JSON result; everything else comes before it.
"""
import argparse
import glob
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BENCHDATA = os.path.join(REPO, "benchdata")
TRACE_DIR = os.path.join(REPO, ".smoke", "trace")
WINDOW = "chip_smoke.window"
# Stage -> the jitted programs (XLA module names) that implement it. Kernels
# inside XLA:GPU command buffers keep their module name but not their op-level
# scopes, so the module is the stable key.
STAGES = {
    "expand": ("jit_wire_expand4_blob", "jit_dual0_expand"),
    "model_scan": ("jit_model_pass_v4",),
    "lane_scan": ("jit__lane_scan_dev",),
    "compaction": ("jit__lane_compact",),
}


def say(tag: str, **fields) -> None:
    print(f"{tag} {json.dumps(fields)}", flush=True)


def require_gpus(n: int):
    """Phase 1: JAX must see at least `n` GPUs; anything else is a failure,
    never a CPU fallback."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n:
        print(f"chip_smoke: needs {n} GPU(s), JAX sees "
              f"{[f'{d.platform}:{d.device_kind}' for d in devs]}", file=sys.stderr)
        raise SystemExit(2)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    say("device", platform=devs[0].platform, kind=devs[0].device_kind, count=len(devs))
    print(f"card: {card[0]}", flush=True)
    return devs


def _union_ns(spans, lo, hi) -> int:
    total, end = 0, lo
    for s, e in sorted(spans):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def reduce_trace(xplane_path: str) -> dict:
    """Per-stage device time, device busy time and idle share over the
    WINDOW annotation of one profiler trace. Busy is the union of all
    device-plane events (kernels and copies); idle share is 1 - busy/window."""
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(xplane_path)
    spans, by_module, window = [], {}, None
    for plane in pd.planes:
        device_plane = plane.name.startswith("/device:")
        for line in plane.lines:
            for ev in line.events:
                if device_plane:
                    spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                    mod = dict(ev.stats).get("hlo_module")
                    if mod:
                        by_module[mod] = by_module.get(mod, 0.0) + ev.duration_ns
                elif ev.name == WINDOW:
                    window = (ev.start_ns, ev.start_ns + ev.duration_ns)
    if window is None or not spans:
        raise RuntimeError(f"trace has no {WINDOW!r} window or no device events")
    lo, hi = window
    busy = _union_ns(spans, lo, hi)
    stage_ms = {st: sum(by_module.pop(m, 0.0) for m in mods) / 1e6
                for st, mods in STAGES.items()}
    stage_ms["other_programs"] = sum(by_module.values()) / 1e6
    return {"window_ms": (hi - lo) / 1e6, "device_busy_ms": busy / 1e6,
            "idle_share": 1.0 - busy / (hi - lo), "device_ms": stage_ms,
            "other_modules": sorted(by_module)}


def traced(fn) -> dict:
    import jax
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    with jax.profiler.trace(TRACE_DIR):
        with jax.profiler.TraceAnnotation(WINDOW):
            fn()
    path = glob.glob(os.path.join(TRACE_DIR, "**", "*.xplane.pb"), recursive=True)[0]
    out = reduce_trace(path)
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    return out


def read_clip(name: str) -> bytes:
    with open(os.path.join(BENCHDATA, name), "rb") as f:
        return f.read()


def profile2_clip(name: str, chunk_mode: int, cpu) -> None:
    """Phase 3 for one clip."""
    import jax
    from avrecode_jax import checks, device
    data = read_clip(name)
    t0 = time.perf_counter()
    comp, _ = device.compress(data, chunk_mode=chunk_mode)
    cold_s = time.perf_counter() - t0
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        device.compress(data, chunk_mode=chunk_mode)
        warm.append(time.perf_counter() - t0)
    warm_s = statistics.median(warm)
    n_chunks = checks.chunk_differential(data, chunk_mode=chunk_mode, model_profile=2)
    checks.container_matches(data, cpu, chunk_mode=chunk_mode)
    prof = traced(lambda: device.compress(data, chunk_mode=chunk_mode))
    say("profile2", clip=name, chunk_mode=chunk_mode, input_bytes=len(data),
        container_bytes=len(comp), ratio=len(comp) / len(data),
        chunks=n_chunks, differential="exact", cpu_container="identical",
        roundtrip="exact", cold_s=cold_s, warm_s=warm, warm_median_s=warm_s,
        compile_s=cold_s - warm_s, warm_mb_s=len(data) / 1e6 / warm_s,
        peak_bytes_in_use=jax.devices()[0].memory_stats()["peak_bytes_in_use"],
        **prof)


def profile0_clip(name: str, cpu) -> None:
    """Phase 4: the profile-0 device path (device_probs -> run_chunk_v2_tables)."""
    from avrecode_jax import checks
    data = read_clip(name)
    t0 = time.perf_counter()
    n_chunks = checks.chunk_differential(data, chunk_mode=0, model_profile=0)
    comp = checks.container_matches(data, cpu, model_profile=0)
    say("profile0", clip=name, chunks=n_chunks, differential="exact",
        cpu_container="identical", roundtrip="exact", container_bytes=len(comp),
        ratio=len(comp) / len(data), wall_s=time.perf_counter() - t0)


def four_cards(devs) -> None:
    """The sharded path over four GPUs against single-card device.compress."""
    from avrecode_jax import checks, device
    from avrecode_jax.parallel.mesh import make_mesh
    data = read_clip("multigop720.mp4")
    lanes = 64  # divisible by every lane-axis size below
    for n_gop, n_lane in ((4, 1), (2, 2)):
        mesh = make_mesh(n_gop=n_gop, n_lane=n_lane, devices=devs[:4])
        t0 = time.perf_counter()
        comp = checks.mesh_matches(data, mesh, chunk_mode=1, force_lanes=lanes)
        wall_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        device.compress_mesh(data, mesh, chunk_mode=1, force_lanes=lanes)
        mesh_s = time.perf_counter() - t0
        say("four_cards", clip="multigop720.mp4", mesh=[n_gop, n_lane], lanes=lanes,
            container_bytes=len(comp), single_card="identical", roundtrip="exact",
            check_wall_s=wall_s, mesh_compress_again_s=mesh_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args(argv)
    devs = require_gpus(4 if args.four_cards else 1)

    import jax
    from avrecode_jax import device, host
    cache = device.ensure_compile_cache()
    say("compile_cache", dir=cache,
        entries_before=len(os.listdir(cache)) if os.path.isdir(cache) else 0)
    if args.four_cards:
        host.lib()
        four_cards(devs)
    else:
        t0 = time.perf_counter()
        host.build_native(force=True)
        say("native_build", seconds=time.perf_counter() - t0)
        cpu = jax.devices("cpu")[0]
        profile2_clip("bench.mp4", 0, cpu)
        profile2_clip("multigop720.mp4", 1, cpu)
        profile0_clip("multigop.mp4", cpu)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
