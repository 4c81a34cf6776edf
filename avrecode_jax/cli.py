"""CLI: recode [compress|decompress|roundtrip] <input> [output]

Command surface matches the reference (reference recode.cpp:1627-1659);
roundtrip prints the compression ratio and container overhead like the
reference's report (recode.cpp:1606-1618), as JSON.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import pipeline


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="avrecode-jax", description=__doc__)
    p.add_argument("command", choices=["compress", "decompress", "roundtrip", "corpus",
                                       "info"])
    p.add_argument("input", help="file; for corpus: a directory or glob of files")
    p.add_argument("output", nargs="?")
    p.add_argument("--lanes", type=int, default=16, help="rANS entropy lanes per chunk")
    p.add_argument("--chunk-mode", type=int, default=0, choices=[0, 1],
                   help="0 = whole-file chunk (max ratio); 1 = chunk per IDR GOP (parallel)")
    p.add_argument("--bill", action="store_true", help="print per-class bit accounting (JSON)")
    p.add_argument("--bill-table", action="store_true",
                   help="print a human-readable ours-vs-CABAC cost table to stderr")
    p.add_argument("--device", action="store_true",
                   help="corpus: use the JAX device path per file (one JAX "
                        "process per GPU: a second one on the same card fails "
                        "for want of memory)")
    p.add_argument("--host-workers", type=int, default=2,
                   help="corpus: concurrent files per process")
    p.add_argument("--resume", action="store_true",
                   help="corpus: skip inputs whose output container already "
                        "exists (outputs are written atomically)")
    args = p.parse_args(argv)

    if args.command == "corpus":
        # Multi-host corpus recompression (parallel/distributed.py): files
        # shard across jax processes; single-process runs need no cluster.
        # With --device, give each GPU one process: a JAX process reserves
        # most of its card's memory, so a second one there fails for memory.
        import glob
        import os
        from .parallel import distributed as dist
        if not args.output:
            p.error("corpus requires an output directory")
        if os.path.isdir(args.input):
            paths = [os.path.join(args.input, n) for n in sorted(os.listdir(args.input))
                     if os.path.isfile(os.path.join(args.input, n))]
        else:
            paths = sorted(glob.glob(args.input))
        if not paths:
            p.error(f"no input files match {args.input!r}")
        pidx, pcount = dist.init_distributed()
        rep = dist.corpus_compress(paths, args.output, use_device=args.device,
                                   chunk_mode=args.chunk_mode,
                                   host_workers=args.host_workers,
                                   resume=args.resume)
        print(json.dumps({
            "process": f"{pidx}/{pcount}",
            "files": rep.files,
            "failures": rep.failures,
            "input_bytes": rep.input_bytes,
            "output_bytes": rep.output_bytes,
            "ratio": rep.ratio,
            "wall_s": round(rep.wall_s, 2),
            "mb_s": round(rep.input_bytes / 1e6 / rep.wall_s, 3) if rep.wall_s else 0.0,
        }))
        return 0 if rep.failures == 0 else 1

    with open(args.input, "rb") as f:
        data = f.read()

    if args.command == "info":
        # ATRC header provenance dump (v26: version + writing build id; the
        # reference's recode.proto Metadata defined these but never wrote
        # them). Pure header parse — no decode.
        from . import host
        if data[:4] != b"ATRC" or len(data) < 6:
            print(json.dumps({"error": "not an ATRC container"}))
            return 1
        version = data[4]
        build_id = "pre-v26"
        if version >= 26:
            bl = data[5]
            build_id = data[6:6 + bl].decode("ascii", "replace")
        print(json.dumps({
            "container_version": version,
            "build_id": build_id,
            "reader_version": host.container_version(),
            "readable": version == host.container_version(),
            "bytes": len(data),
        }))
        return 0

    if args.command == "compress":
        out, st = pipeline.compress(data, lanes=args.lanes, chunk_mode=args.chunk_mode)
        if not args.output:
            p.error("compress requires an output path")
        with open(args.output, "wb") as f:
            f.write(out)
        report = {
            "ratio": len(out) / len(data),
            "input_bytes": len(data),
            "output_bytes": len(out),
            "slices": st.n_slices,
            "fallback_slices": st.n_fallback,
            "chunks": st.n_chunks,
            "bins": st.total_bins,
        }
        if args.bill:
            report["bill"] = st.bill
        print(json.dumps(report))
        return 0

    if args.command == "decompress":
        out, st = pipeline.decompress(data)
        if not args.output:
            p.error("decompress requires an output path")
        with open(args.output, "wb") as f:
            f.write(out)
        print(json.dumps({"output_bytes": len(out), "slices": st.n_slices}))
        return 0

    rep = pipeline.roundtrip(data, lanes=args.lanes, chunk_mode=args.chunk_mode)
    if args.bill_table:
        from .utils.billing import format_bill
        print(format_bill(rep.stats), file=sys.stderr)
    report = {
        "roundtrip_ok": rep.ok,
        "ratio": rep.ratio,
        "input_bytes": rep.input_bytes,
        "compressed_bytes": rep.compressed_bytes,
        "container_overhead": rep.container_overhead,
        "slices": rep.stats.n_slices,
        "fallback_slices": rep.stats.n_fallback,
    }
    if args.bill:
        report["bill"] = rep.stats.bill
    print(json.dumps(report))
    if args.output and rep.ok:
        comp, _ = pipeline.compress(data, lanes=args.lanes, chunk_mode=args.chunk_mode)
        with open(args.output, "wb") as f:
            f.write(comp)
    return 0 if rep.ok else 1


if __name__ == "__main__":
    sys.exit(main())
