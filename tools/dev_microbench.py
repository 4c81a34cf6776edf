#!/usr/bin/env python3
"""Device-chain microbench: times the production expand / model / lane scan
programs on the largest chunk with inputs resident on the GPU, each timing
block synced with jax.block_until_ready.

Usage: dev_microbench.py [clip] [reps]
Prints one JSON line with per-phase ms on the largest chunk + the chain
Mbins/s, and the card it ran on. Run it as the only JAX process on the card:
a JAX process reserves most of the card's memory, so a second one fails for
want of memory.
"""
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    clip = sys.argv[1] if len(sys.argv) > 1 else os.path.join(REPO, "benchdata", "bench.mp4")
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    import jax
    import numpy as np
    from avrecode_jax import device
    from avrecode_jax.ops import model_pass as mp
    from avrecode_jax.ops import lanes as lx

    data = open(clip, "rb").read()
    t0 = time.time()
    an = device.analyze(data, batch_size=4096, model_profile=2, want_probs=True)
    print(f"analyze {time.time()-t0:.2f}s ({len(an.chunks)} chunks)", file=sys.stderr)

    cache = {}
    staged = [device._stage_v4(an, c, cache=cache) for c in an.chunks]
    big = max(range(len(staged)), key=lambda i: staged[i].n)
    st = staged[big]
    c = an.chunks[big]

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"dev_microbench: needs a GPU, JAX's default device is "
                         f"{dev.platform}")
    sync = jax.block_until_ready

    # warm all programs
    ex = mp.wire_expand4_blob(st.blob, st.sc, **st.statics["expand"])
    sync(ex[0])
    probs, bits = mp.model_pass_v4(*ex[:4], ex[5], ex[6], ex[4],
                                   st.dual0, sig0_idx=st.s_idx, sig0_val=st.s_val,
                                   **st.statics["model"])
    sync(probs)
    ok = bool(np.array_equal(np.asarray(probs)[:c.n], c.host_probs))
    K = device.pick_lanes(st.n)
    h = lx.encode_interleaved_start(bits, probs, st.n, K)
    sync(h[3])
    print(f"warm done, differential ok={ok}", file=sys.stderr)

    def timeit(fn):
        best = float("inf")
        for _ in range(reps):
            t0 = time.time()
            out = fn()
            sync(out)
            best = min(best, time.time() - t0)
        return best

    t_expand = timeit(lambda: mp.wire_expand4_blob(st.blob, st.sc,
                                                   **st.statics["expand"])[0])
    t_exp_model = timeit(lambda: device._exec_v4(st)[0])

    def chain():
        p, b = device._exec_v4(st)
        return lx.encode_interleaved_start(b, p, st.n, K)[3]
    t_chain = timeit(chain)

    # The chain from DENSE resident planes (~11 B/bin uploaded instead of
    # the ANL5 wire): model + lane scan without the wire expand.
    dense = sync([jax.device_put(np.asarray(x)) for x in ex[:7]])

    def dense_chain():
        p, b = mp.model_pass_v4(*dense[:4], dense[5], dense[6], dense[4],
                                st.dual0, sig0_idx=st.s_idx, sig0_val=st.s_val,
                                **st.statics["model"])
        return lx.encode_interleaved_start(b, p, st.n, K)[3]
    sync(dense_chain())  # warm
    t_dense = timeit(dense_chain)

    print(json.dumps({
        "device_kind": dev.device_kind,
        "clip": os.path.basename(clip), "chunk_bins": int(st.n), "m": int(st.m),
        "reps": reps, "differential_ok": ok,
        "expand_ms": round(t_expand * 1e3, 1),
        "expand_model_ms": round(t_exp_model * 1e3, 1),
        "chain_ms": round(t_chain * 1e3, 1),
        "chain_mbins_s": round(st.m / t_chain / 1e6, 1),
        "dense_chain_ms": round(t_dense * 1e3, 1),
        "dense_chain_mbins_s": round(st.m / t_dense / 1e6, 1),
        "wire_mb": round(sum(s.wire_nbytes for s in staged) / 1e6, 1),
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
