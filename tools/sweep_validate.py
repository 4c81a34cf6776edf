#!/usr/bin/env python3
"""Randomized validation sweep: synthesizes x264 streams across randomized
configurations (profile, pixfmt, QP/CRF, slices, bframes, refs, MBAFF,
CABAC/CAVLC, containers) plus walker-driven spec-valid synthetic streams
(tools/make_synth.cc: PAFF, SP, separate planes), and roundtrips every one
through the product pipeline. Any fallback slice or roundtrip mismatch is a
failure. Prints one JSON summary line; non-zero exit on any failure.

Usage: sweep_validate.py [n_configs] [seed]
"""
import json
import os
import random
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def build(tool, tmp, libs):
    out = os.path.join(tmp, tool)
    subprocess.run(["g++", "-O2", f"-I{REPO}", "-o", out,
                    os.path.join(REPO, "tools", f"{tool}.cc")] + libs,
                   check=True, capture_output=True)
    return out


def main():
    n_cfg = int(sys.argv[1]) if len(sys.argv) > 1 else 24
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    rng = random.Random(seed)
    from avrecode_jax import pipeline

    tmp = tempfile.mkdtemp(prefix="artc_sweep_")
    gen = build("make_corpus", tmp, ["-lavcodec", "-lavformat", "-lavutil"])
    synth = build("make_synth", tmp, ["-lavcodec", "-lavutil"])

    rows, failures = [], 0

    def roundtrip(path, label):
        nonlocal failures
        with open(path, "rb") as f:
            data = f.read()
        try:
            rep = pipeline.roundtrip(data)
            ok = rep.ok and rep.stats.n_fallback == 0
            rows.append({"label": label, "ok": bool(ok),
                         "ratio": round(rep.ratio, 4),
                         "slices": rep.stats.n_slices,
                         "fallback": rep.stats.n_fallback})
        except Exception as e:  # noqa: BLE001 — a sweep must report, not die
            ok = False
            rows.append({"label": label, "ok": False, "error": str(e)[:120]})
        if not ok:
            failures += 1
            print(f"FAIL {label}: {rows[-1]}", file=sys.stderr)

    # Randomized x264 configs.
    for i in range(n_cfg):
        profile, pixfmt = rng.choice([
            ("baseline", "420"), ("main", "420"), ("high", "420"),
            ("high422", "422"), ("high10", "420p10"), ("high444", "444"),
        ])
        cabac = 0 if profile == "baseline" else rng.choice([0, 1])
        if profile in ("high422", "high444") and cabac == 0:
            cabac = rng.choice([0, 1])
        container = rng.choice([".264", ".mp4", ".mkv", ".ts", ".avi", ".mov", ".flv", ".mpg"])
        kv = {
            "w": rng.choice([128, 160, 320]), "h": rng.choice([96, 128, 240]),
            "frames": rng.randint(4, 14), "gop": rng.choice([4, 8, 250]),
            "bframes": 0 if profile == "baseline" else rng.choice([0, 2, 3]),
            "slices": rng.choice([1, 1, 2, 3]), "qp": rng.randint(8, 45),
            "seed": rng.randint(1, 9999), "profile": profile,
            "pixfmt": pixfmt, "cabac": cabac,
        }
        xp = []
        if rng.random() < 0.4:
            xp.append(f"ref={rng.randint(1, 8)}")
        if rng.random() < 0.3 and kv["bframes"]:
            xp.append("weightb=1")
        if rng.random() < 0.3:
            xp.append("weightp=2")
        if rng.random() < 0.3 and cabac:
            xp.append("8x8dct=1")
        if rng.random() < 0.2 and pixfmt == "420" and profile != "baseline":
            xp.append("interlaced=1")  # MBAFF
        if xp:
            kv["xparams"] = ":".join(xp)
        out = os.path.join(tmp, f"cfg{i}{container}")
        args = [gen, out] + [f"{k}={v}" for k, v in kv.items()]
        r = subprocess.run(args, capture_output=True)
        if r.returncode != 0:
            rows.append({"label": f"cfg{i}", "ok": True, "skipped": "encoder rejected config"})
            continue
        roundtrip(out, f"cfg{i} {profile}/{pixfmt} cabac={cabac} {container}")

    # Walker-driven synthesis (configs x264 cannot emit): PAFF CABAC/CAVLC,
    # I_PCM under PAFF, separate colour planes (make_synth.cc k=v options).
    synth_cfgs = [
        ("paff_cabac", ["paff=1", "cavlc=0"]),
        ("paff_cavlc", ["paff=1", "cavlc=1"]),
        ("paff_pcm", ["paff=1", "pcm=1"]),
        ("sep_planes", ["planes=3"]),
    ]
    for name, opts in synth_cfgs:
        out = os.path.join(tmp, f"synth_{name}.264")
        r = subprocess.run([synth, out, f"seed={seed}", "w=64", "h=64"] + opts,
                           capture_output=True)
        if r.returncode != 0:
            rows.append({"label": f"synth {name}", "ok": False,
                         "error": r.stderr.decode()[-120:]})
            failures += 1
            continue
        roundtrip(out, f"synth {name}")

    print(json.dumps({"configs": len(rows), "failures": failures,
                      "rows": rows}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
