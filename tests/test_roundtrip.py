"""End-to-end bit-exactness gates (the reference's acceptance test shape,
reference recode.cpp:1594-1624 / SURVEY.md §4)."""
import os
import subprocess

import pytest

from avrecode_jax import pipeline

CLIPS = ["i_main.264", "ipb_high.264", "ipb_high.mp4", "ipb_high.mkv",
         "ipb_high.mov", "multislice.264",
         "stress_wpred.264", "stress_aud.mp4", "stress_cavlc.264",
         "c422.264", "c422.mp4", "pcm_cabac.264", "pcm_cavlc.264",
         "pcm_mixed.mp4", "mbaff.264", "mbaff422.mp4", "hi10.264",
         "cavlc_b8.264", "c444.264", "c444p10i.264",
         "cav422.264", "cav10.264", "cav444.264",
         "cavmbaff.264", "cavmbaff422.264", "mono.264", "monocav.264",
         # PAFF field pictures (synthesized; x264 is MBAFF-only)
         "paff_i.264", "paff_ip.264", "paff_pcm.264", "synth_prog.264",
         "sepplanes.264", "paff_cavlc.264", "synth_cavlc.264", "sp_cavlc.264"]


@pytest.mark.parametrize("clip", CLIPS)
def test_roundtrip_bit_exact(corpus_dir, clip):
    with open(os.path.join(corpus_dir, clip), "rb") as f:
        data = f.read()
    rep = pipeline.roundtrip(data)
    assert rep.ok, f"roundtrip not bit-exact for {clip}"
    assert rep.stats.n_slices > 0
    assert rep.stats.n_fallback == 0, "no slice should fall back on supported streams"


@pytest.mark.parametrize("clip", ["ipb_high.264"])
def test_roundtrip_gop_chunks(corpus_dir, clip):
    """chunk_mode=1 (per-IDR chunks) must stay bit-exact with >1 chunk."""
    with open(os.path.join(corpus_dir, clip), "rb") as f:
        data = f.read()
    rep = pipeline.roundtrip(data, chunk_mode=1)
    assert rep.ok
    assert rep.stats.n_chunks >= 2


@pytest.mark.parametrize("lanes", [1, 4, 64])
def test_roundtrip_lane_counts(corpus_dir, lanes):
    with open(os.path.join(corpus_dir, "i_main.264"), "rb") as f:
        data = f.read()
    rep = pipeline.roundtrip(data, lanes=lanes)
    assert rep.ok


def test_unsupported_fallback(corpus_dir):
    """Corrupt slice payloads fall back to literal passthrough (reference
    parity: skip_coded, recode.cpp:1289-1296) and stay bit-exact."""
    with open(os.path.join(corpus_dir, "ipb_high.264"), "rb") as f:
        data = bytearray(f.read())
    data[len(data) // 2] ^= 0xFF  # corrupt a payload byte mid-stream
    rep = pipeline.roundtrip(bytes(data))
    assert rep.ok
    assert rep.stats.n_fallback > 0


def test_mkv_recompresses_without_fallback(corpus_dir):
    """H.264-in-MKV demuxes natively (mkv.h): every slice recompresses — no
    literal degradation (the reference got MKV via libavformat,
    recode.cpp:92)."""
    with open(os.path.join(corpus_dir, "ipb_high.mkv"), "rb") as f:
        data = f.read()
    rep = pipeline.roundtrip(data)
    assert rep.ok
    assert rep.stats.n_slices > 0
    assert rep.stats.n_fallback == 0
    assert rep.ratio < 1.0


def test_fmp4_recompresses_without_fallback(corpus_dir):
    """Fragmented MP4 (DASH/CMAF): sample extents come from moof/traf/trun
    runs (tfhd/trex defaults, default-base-is-moof offsets) rather than stbl
    tables — every slice must still recompress with zero fallbacks (parity
    with the reference's libavformat ingestion, recode.cpp:92, 118)."""
    with open(os.path.join(corpus_dir, "ipb_frag.mp4"), "rb") as f:
        data = f.read()
    rep = pipeline.roundtrip(data)
    assert rep.ok
    assert rep.stats.n_slices > 0
    assert rep.stats.n_fallback == 0
    assert rep.ratio < 1.0


def test_flv_recompresses_without_fallback(corpus_dir):
    """H.264-in-FLV demuxes natively (flv.h): avcC from the sequence-header
    video tag, AVCC samples from NALU tags — every slice recompresses with
    zero fallbacks (parity with the reference's libavformat ingestion)."""
    with open(os.path.join(corpus_dir, "ipb_high.flv"), "rb") as f:
        data = f.read()
    rep = pipeline.roundtrip(data)
    assert rep.ok
    assert rep.stats.n_slices > 0
    assert rep.stats.n_fallback == 0
    assert rep.ratio < 1.0


def test_ps_recompresses_without_fallback(corpus_dir):
    """MPEG-PS (program stream): PES packets fragment slices like TS; the
    extractor (ps.h) reassembles the video ES and rides the same run-map
    transport, recompressing with zero fallbacks. (The reference stored PS
    essentially raw — its memmem segmentation cannot locate PES-fragmented
    slices.)"""
    with open(os.path.join(corpus_dir, "ipb_high.mpg"), "rb") as f:
        data = f.read()
    rep = pipeline.roundtrip(data)
    assert rep.ok
    assert rep.stats.n_slices > 0
    assert rep.stats.n_fallback == 0
    assert rep.ratio < 1.0


def test_ts_recompresses(corpus_dir):
    """MPEG-TS fragments every slice across 188-byte packets — the v17
    transport reassembles the elementary stream, recompresses it with zero
    fallbacks, and weaves the TS/PES skeleton back around it bit-exactly.
    (The reference's memmem segmentation cannot locate fragmented slices, so
    it stores TS essentially raw — this is a capability win.)"""
    with open(os.path.join(corpus_dir, "ipb_high.ts"), "rb") as f:
        data = f.read()
    rep = pipeline.roundtrip(data)
    assert rep.ok
    assert rep.stats.n_slices > 0
    assert rep.stats.n_fallback == 0
    assert rep.ratio < 1.0


def test_avi_recompresses(corpus_dir):
    """RIFF/AVI carries Annex-B access units in movi chunks; the per-chunk
    NAL scan (native/avi.h) must keep chunk headers out of NAL extents so
    every slice recompresses (a whole-file scan leaves trailing RIFF bytes
    glued to frame-final NALs and those slices fall back)."""
    with open(os.path.join(corpus_dir, "ipb_high.avi"), "rb") as f:
        data = f.read()
    rep = pipeline.roundtrip(data)
    assert rep.ok
    assert rep.stats.n_slices > 0
    assert rep.stats.n_fallback == 0
    assert rep.ratio < 1.0


def test_ts_multiplexed_pids(corpus_dir):
    """TS with other PIDs interleaved (null packets + a fake audio PES):
    foreign packets belong to the skeleton; the video ES must still
    reassemble and recompress with zero fallbacks."""
    with open(os.path.join(corpus_dir, "ipb_high.ts"), "rb") as f:
        data = f.read()
    assert len(data) % 188 == 0
    rng = __import__("random").Random(3)
    out = bytearray()
    audio_cc = 0
    for i in range(0, len(data), 188):
        out += data[i:i + 188]
        r = rng.random()
        if r < 0.15:  # null packet
            out += bytes([0x47, 0x1F, 0xFF, 0x10]) + bytes(184)
        elif r < 0.25:  # fake audio PES packet on an unannounced PID (0x200)
            pes = bytes([0x47, 0x42, 0x00, 0x10 | (audio_cc & 0xF)])
            audio_cc += 1
            payload = bytes([0, 0, 1, 0xC0, 0, 20, 0x80, 0x00, 0x00]) + bytes(
                rng.randrange(256) for _ in range(175))
            out += pes + payload
    rep = pipeline.roundtrip(bytes(out))
    assert rep.ok
    assert rep.stats.n_slices > 0
    assert rep.stats.n_fallback == 0


def test_non_video_passthrough():
    """Arbitrary non-video bytes roundtrip as a pure-literal container."""
    data = bytes(range(256)) * 40
    rep = pipeline.roundtrip(data)
    assert rep.ok


def test_billing_populated(corpus_dir):
    with open(os.path.join(corpus_dir, "ipb_high.264"), "rb") as f:
        data = f.read()
    rep = pipeline.roundtrip(data)
    bill = rep.stats.bill
    assert bill["sig"]["count"] > 0
    assert bill["eob_free_bins"]["count"] > 0  # zero-cost EOB bins exercised
    assert bill["res"]["count"] > 0


def test_syntax_engine_byte_exact(corpus_dir, check_syntax_tool):
    """Every CABAC slice decodes + re-encodes byte-exactly (M2 gate)."""
    for clip in ["i_main.264", "ipb_high.264", "multislice.264", "mbaff.264"]:
        out = subprocess.run(
            [check_syntax_tool, os.path.join(corpus_dir, clip)],
            capture_output=True, text=True,
        )
        assert out.returncode == 0, out.stdout + out.stderr
        assert " fail=0 " in out.stdout


@pytest.mark.parametrize("batch", [1, 4096, 32768])
def test_roundtrip_batched_model(corpus_dir, batch):
    """Batched estimator updates (device formulation) stay bit-exact at any B."""
    with open(os.path.join(corpus_dir, "ipb_high.264"), "rb") as f:
        data = f.read()
    rep = pipeline.roundtrip(data, batch_size=batch)
    assert rep.ok


def test_cavlc_recompression(corpus_dir):
    """CAVLC slices are re-coded (capability extension: the reference passes
    them through raw) and must both roundtrip bit-exactly and actually
    compress."""
    with open(os.path.join(corpus_dir, "cavlc.mp4"), "rb") as f:
        data = f.read()
    rep = pipeline.roundtrip(data)
    assert rep.ok
    assert rep.stats.n_slices > 0 and rep.stats.n_fallback == 0
    assert rep.ratio < 0.98, f"CAVLC should compress, got {rep.ratio}"  # tiny test clip: modest win


def test_container_provenance(corpus_dir, capsys):
    """v26 header provenance: the container records the writing build id, the
    CLI `info` command dumps it, and a version-skew rejection names both
    versions (parity with recode.proto:2-7 Metadata, which the reference
    never populated)."""
    import json
    from avrecode_jax import cli, host
    with open(os.path.join(corpus_dir, "ipb_high.264"), "rb") as f:
        data = f.read()
    comp, _ = pipeline.compress(data)
    assert comp[:4] == b"ATRC" and comp[4] == host.container_version()
    path = os.path.join(corpus_dir, "prov.atrc")
    with open(path, "wb") as f:
        f.write(comp)
    assert cli.main(["info", path]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["readable"] and rep["container_version"] == host.container_version()
    assert rep["build_id"] and rep["build_id"] != "pre-v26"
    # version skew rejects with a message naming both versions
    bad = bytearray(comp)
    bad[4] = 250
    with pytest.raises(Exception, match="250"):
        pipeline.decompress(bytes(bad))


def test_decompress_fuzz_safety(corpus_dir):
    """Truncated/corrupted/garbage containers must raise clean errors or be
    caught by the integrity CRC — never crash or return wrong bytes
    silently."""
    import random
    from avrecode_jax import host
    with open(os.path.join(corpus_dir, "i_main.264"), "rb") as f:
        data = f.read()
    comp, _ = pipeline.compress(data)
    rng = random.Random(11)
    for trial in range(40):
        b = bytearray(comp)
        if trial % 3 == 0:
            b = b[:rng.randrange(len(b))]
        elif trial % 3 == 1:
            for _ in range(rng.randrange(1, 6)):
                b[rng.randrange(len(b))] ^= rng.randrange(1, 256)
        else:
            b = bytearray(rng.randbytes(rng.randrange(4, 2048)))
        try:
            out, _ = pipeline.decompress(bytes(b))
            assert out == data  # undetected-corruption case must still be right
        except host.NativeError:
            pass
