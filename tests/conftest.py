import os
import subprocess

import pytest

# The suite runs on JAX's CPU backend, with a virtual 8-device CPU mesh for
# the sharding tests. GPU-marked tests run on the card when JAX_PLATFORMS
# names it: JAX_PLATFORMS=cuda,cpu python -m pytest tests/test_gpu.py
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault(
    "XLA_FLAGS",
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8",
)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU; skips without one")
    config.addinivalue_line("markers", "slow: left out of the tier-1 run (-m 'not slow')")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")


def _build_tool(name: str, tmp: str, extra: list[str]) -> str | None:
    src = os.path.join(TOOLS, f"{name}.cc")
    out = os.path.join(tmp, name)
    try:
        subprocess.run(
            ["g++", "-O2", f"-I{REPO}", "-o", out, src] + extra,
            check=True, capture_output=True,
        )
        return out
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None


@pytest.fixture(scope="session")
def corpus_dir(tmp_path_factory):
    """Generates a small x264 test corpus (skips dependents if libx264 absent)."""
    tmp = str(tmp_path_factory.mktemp("corpus"))
    gen = _build_tool("make_corpus", tmp, ["-lavcodec", "-lavformat", "-lavutil"])
    if gen is None:
        pytest.skip("libavcodec/libx264 not available to generate corpus")
    specs = {
        "i_main.264": "w=128 h=96 frames=3 gop=1 bframes=0 profile=main qp=28",
        "ipb_high.264": "w=160 h=128 frames=12 gop=6 bframes=2 profile=high qp=26",
        "ipb_high.mp4": "w=160 h=128 frames=12 gop=6 bframes=2 profile=high qp=26",
        "ipb_high.mkv": "w=160 h=128 frames=12 gop=6 bframes=2 profile=high qp=26",
        "ipb_high.ts": "w=160 h=128 frames=12 gop=6 bframes=2 profile=high qp=26",
        "ipb_high.avi": "w=160 h=128 frames=12 gop=6 bframes=2 profile=high qp=26",
        "ipb_high.mov": "w=160 h=128 frames=12 gop=6 bframes=2 profile=high qp=26",
        # Fragmented MP4 (DASH/CMAF): samples enumerated from moof/traf/trun
        # runs with tfhd/trex defaults instead of stbl tables.
        "ipb_frag.mp4": ("w=160 h=128 frames=12 gop=6 bframes=2 profile=high "
                         "qp=26 frag=1"),
        "ipb_high.flv": "w=160 h=128 frames=12 gop=6 bframes=2 profile=high qp=26",
        # MPEG-PS (VOB-style MPEG-2 packs; PES-fragmented like TS).
        "ipb_high.mpg": "w=160 h=128 frames=12 gop=6 bframes=2 profile=high qp=26",
        "multislice.264": "w=320 h=240 frames=6 gop=3 bframes=1 profile=high qp=24 slices=3",
        # Extreme QPs stress the slim wire's width space (qp51: near-empty
        # residuals -> tiny COO runs / small wa/wb; qp6: dense residuals ->
        # wide runs) — the no-straddle unpack must be exact at every width.
        "q51.mp4": "w=320 h=240 frames=12 gop=6 bframes=2 profile=high qp=51",
        "q6.mp4": "w=160 h=128 frames=4 gop=2 bframes=1 profile=high qp=6",
        "cavlc.mp4": "w=128 h=96 frames=4 profile=baseline cabac=0 bframes=0",
        # Stress configs: multi-ref, weighted P+B pred, all partitions,
        # trellis, AUD NALs, custom deblock (walker must not fall back).
        "stress_wpred.264": ("w=160 h=128 frames=10 qp=24 slices=2 bframes=3 "
                             "xparams=ref=8:weightp=2:weightb=1:b-adapt=2:"
                             "direct=auto:partitions=all:subme=9:trellis=2"),
        "stress_aud.mp4": ("w=176 h=144 frames=10 crf=30 slices=2 bframes=2 "
                           "preset=slow xparams=ref=5:weightp=2:aud=1:"
                           "deblock=-2,-2"),
        "stress_cavlc.264": ("w=160 h=128 frames=8 qp=14 cabac=0 bframes=0 "
                             "profile=baseline slices=2 "
                             "xparams=ref=4:partitions=all"),
        # CAVLC high profile: B slices (all partition/direct/sub types) and
        # the 8x8 transform (flag only — residuals stay 4x4-interleaved).
        "cavlc_b8.264": ("w=160 h=128 frames=10 qp=22 cabac=0 bframes=2 "
                         "profile=high seed=4 "
                         "xparams=8x8dct=1:ref=3:partitions=all:weightb=1"),
        # 4:2:2 chroma (high422): exercises 8-coeff chroma DC blocks, the
        # cat-3 gt1 ctx cap, and the 2x4 chroma AC grid.
        "c422.264": ("w=160 h=128 frames=8 qp=20 bframes=2 slices=2 "
                     "profile=high422 pixfmt=422"),
        "c422.mp4": ("w=176 h=144 frames=6 crf=26 bframes=2 "
                     "profile=high422 pixfmt=422 xparams=8x8dct=1"),
        # I_PCM macroblocks: pure-noise frames at very low QP with psy off
        # make x264 pick PCM (raw samples beat residual coding). Exercises the
        # CABAC flush/align/reinit path and x264's nonzero pad-bit stuffing.
        "pcm_cabac.264": ("w=128 h=96 frames=2 qp=1 profile=high noise=1 "
                          "bframes=0 xparams=psy=0"),
        "pcm_cavlc.264": ("w=128 h=96 frames=2 qp=2 profile=baseline noise=1 "
                          "bframes=0 cabac=0 xparams=psy=0"),
        # Mixed PCM + coded MBs (structured content at low QP).
        "pcm_mixed.mp4": ("w=160 h=128 frames=4 qp=2 profile=high bframes=1 "
                          "xparams=psy=0"),
        # CAVLC beyond 4:2:0/8-bit: 4:2:2 chroma DC (nC==-2 coeff_token +
        # 9-9(b) total_zeros), 10-bit (AVC-Intra-style), 4:4:4 per-plane
        # luma-semantics residuals with the gray cbp me(v) mapping.
        "cav422.264": ("w=160 h=128 frames=6 qp=20 cabac=0 bframes=2 "
                       "profile=high422 pixfmt=422"),
        "cav10.264": ("w=160 h=128 frames=6 qp=14 cabac=0 bframes=1 "
                      "profile=high10 pixfmt=420p10"),
        "cav444.264": ("w=160 h=128 frames=6 qp=20 cabac=0 bframes=1 "
                       "profile=high444 pixfmt=444"),
        # Monochrome (4:0:0): no chroma syntax at all; CAVLC uses the gray
        # cbp mapping; CABAC skips chroma pred / cbp bins.
        "mono.264": "w=160 h=128 frames=6 qp=24 bframes=1 profile=high pixfmt=400",
        "monocav.264": "w=160 h=128 frames=6 qp=24 cabac=0 bframes=0 pixfmt=400",
        # CAVLC MBAFF: pair addressing, mb_field flag read/inference (7.4.4),
        # 6.4.12 neighbour mapping on the total_coeff state, te(v) ref bound
        # doubling for field MBs.
        "cavmbaff.264": ("w=160 h=128 frames=8 qp=24 cabac=0 bframes=2 "
                         "profile=high seed=6 xparams=interlaced=1:ref=3"),
        "cavmbaff422.264": ("w=176 h=144 frames=6 qp=22 cabac=0 bframes=1 "
                            "profile=high422 pixfmt=422 xparams=interlaced=1"),
        # MBAFF interlaced coding: pair addressing, mb_field flags + inference,
        # field/frame neighbor mapping (6.4.12), field sig ctx banks, doubled
        # field reference lists, mvd unit scaling.
        "mbaff.264": ("w=160 h=128 frames=10 qp=25 bframes=2 profile=high "
                      "seed=5 xparams=interlaced=1:ref=3"),
        "mbaff422.mp4": ("w=176 h=144 frames=6 qp=24 bframes=2 "
                         "profile=high422 pixfmt=422 xparams=interlaced=1"),
        # High 10 (10-bit): wider levels, 2-byte-ish I_PCM samples, negative
        # SliceQPY clamp in context init.
        "hi10.264": ("w=160 h=128 frames=8 qp=12 bframes=2 slices=2 "
                     "profile=high10 pixfmt=420p10 xparams=8x8dct=1:ref=4"),
        # High 4:4:4 Predictive: per-plane luma-shaped residuals with the
        # Cb/Cr extension context banks (cats 6-13), coded 8x8 cbf, no chroma
        # pred mode / chroma cbp bins.
        "c444.264": ("w=176 h=144 frames=8 qp=20 bframes=2 slices=2 "
                     "profile=high444 pixfmt=444 seed=3 "
                     "xparams=ref=4:partitions=all:trellis=2"),
        "c444p10i.264": ("w=128 h=96 frames=6 qp=18 bframes=1 "
                         "profile=high444 pixfmt=444p10 xparams=interlaced=1"),
    }
    for name, args in specs.items():
        subprocess.run(
            [gen, os.path.join(tmp, name)] + args.split(),
            check=True, capture_output=True,
        )
    # PAFF field pictures: x264 only implements MBAFF, so these are produced
    # by tools/make_synth.cc (walker-driven synthesis, validated against the
    # system libavcodec under AV_EF_EXPLODE inside the tool itself).
    synth = _build_tool("make_synth", tmp, ["-lavcodec", "-lavutil"])
    if synth is not None:
        synth_specs = {
            "paff_i.264": "w=160 h=128 fields=6 ptype=0 seed=2",
            "paff_ip.264": "w=160 h=128 fields=10 ptype=1 seed=3 slices=2",
            "paff_pcm.264": "w=160 h=128 fields=4 ptype=1 pcm=1 seed=4",
            "synth_prog.264": "w=160 h=128 fields=6 paff=0 seed=5",
            # separate_colour_plane: self-consistency only (libavcodec has no
            # separate-plane support at all — no oracle exists).
            "sepplanes.264": "w=160 h=128 fields=4 planes=3 ptype=1 seed=7",
            # CAVLC field pictures + CAVLC value-generation cross-check.
            "paff_cavlc.264": "w=160 h=128 fields=8 cavlc=1 ptype=1 seed=9",
            "synth_cavlc.264": "w=160 h=128 fields=6 cavlc=1 paff=0 ptype=1 pcm=1 seed=10",
            # SP switching slices (entropy layer == P; header adds
            # sp_for_switch_flag + slice_qs_delta).
            "sp_cavlc.264": "w=160 h=128 fields=6 cavlc=1 paff=0 ptype=2 seed=12",
        }
        for name, args in synth_specs.items():
            subprocess.run(
                [synth, os.path.join(tmp, name)] + args.split(),
                check=True, capture_output=True,
            )
    return tmp


@pytest.fixture(scope="session")
def check_syntax_tool(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tools"))
    tool = _build_tool("check_syntax", tmp, [])
    if tool is None:
        pytest.skip("could not build check_syntax")
    return tool
