"""Differential tests: device model implementations vs the host C++ model.

Runs on JAX's CPU backend (conftest sets JAX_PLATFORMS=cpu unless it is
already set) — semantics only, not performance."""
import os

import numpy as np
import pytest


@pytest.fixture(scope="module")
def small_clip(corpus_dir):
    with open(os.path.join(corpus_dir, "i_main.264"), "rb") as f:
        return f.read()


def test_jax_model_pass_bit_exact(small_clip):
    from avrecode_jax import device
    an = device.analyze(small_clip, batch_size=2048)
    for c in an.chunks:
        probs = device.device_probs(an, c)
        assert np.array_equal(probs, c.host_probs)


def test_jax_lanes_byte_identical(small_clip):
    from avrecode_jax import device, pipeline
    comp_dev, _ = device.compress(small_clip, batch_size=2048)
    dec, _ = pipeline.decompress(comp_dev)
    assert dec == small_clip


def test_refprior_constants_match_native(small_clip):
    """models/refprior.py is documentation of format-defining constants; the
    analysis export header carries the native values — they must agree across
    all three layers (C++, Python docs, device pass defaults)."""
    from avrecode_jax import device
    from avrecode_jax.models.refprior import MODEL_FAMILIES
    from avrecode_jax.ops import model_pass as mp
    cfg = MODEL_FAMILIES["refprior"]
    an = device.analyze(small_clip, batch_size=1024)
    assert an.fast_w == cfg.fast_window
    assert an.slow_w == cfg.slow_window
    assert an.sig_w == cfg.sig_window
    assert (an.sig_alpha & 0xFFFF) == cfg.sig_mix_alpha
    # v18: the off weight is probe-chosen per file from the candidate set
    assert (an.sig_alpha >> 16) in cfg.sig_mix_alpha_off_cands
    assert an.n_sig == 1 << cfg.sig_hash_bits
    assert mp.PROB_BITS == cfg.prob_bits
    assert mp.RES_DIR_ALPHA == cfg.res_dir_alpha
    assert mp.RES_DIR_K == cfg.res_dir_fast_boost
    assert (0, 2) == cfg.profiles


def test_removed_ema_profile_rejected(small_clip):
    """Profile 1 (division-free EMA) was removed in favour of the XLA
    super-batched pass; requesting it must fail loudly, not silently
    miscode."""
    from avrecode_jax import pipeline
    with pytest.raises(Exception):
        pipeline.compress(small_clip, model_profile=1)


def test_model_pass_v2_bit_exact_all_impls(small_clip):
    """The fast path (host-shipped prefix counts + super-batched dicts) must
    match the host and the reference impls bit-for-bit."""
    from avrecode_jax import device
    from avrecode_jax.ops import model_pass as mp
    an = device.analyze(small_clip, batch_size=1024)
    c = an.chunks[0]
    for sup in (1, 4):
        p = mp.run_chunk_v2(c.bit, c.kind, c.key, c.prior, c.pre_ones, c.pre_tot,
                            c.dual0, 1024, sup, an.fast_w, an.slow_w, an.sig_w,
                            an.sig_alpha, an.n_sig)
        assert np.array_equal(p, c.host_probs), f"sup={sup}"


def test_model_pass_v2_pcm_stream(corpus_dir):
    """PCM (kind-3 passthrough) bins must stay batch-aligned between the host
    pending stream and the device trace stream."""
    from avrecode_jax import device, pipeline
    with open(os.path.join(corpus_dir, "pcm_mixed.mp4"), "rb") as f:
        data = f.read()
    an = device.analyze(data, batch_size=512)
    for c in an.chunks:
        probs = device.device_probs(an, c, impl="v2")
        assert np.array_equal(probs, c.host_probs)
    comp_dev, _ = device.compress(data, batch_size=512)
    dec, _ = pipeline.decompress(comp_dev)
    assert dec == data


def test_frozen_profile_roundtrip(small_clip):
    """model_profile=2 (frozen batches) is a valid container variant."""
    from avrecode_jax import pipeline
    rep = pipeline.roundtrip(small_clip, batch_size=1024, model_profile=2)
    assert rep.ok


def test_slim_wire_bit_exact(small_clip):
    """The slim (ANL2) wire format + frozen-batch device pass must reproduce
    the host profile-2 probabilities bit-for-bit, including prior-dictionary
    escapes and the on-device COO delta reconstruction."""
    from avrecode_jax import device
    an = device.analyze(small_clip, batch_size=1024, model_profile=2)
    assert an.slim
    for c in an.chunks:
        probs = device.device_probs(an, c)
        assert np.array_equal(probs, c.host_probs)
        # the slim wire must be a few bytes/bin, not tens
        wire = (c.packed.nbytes + c.prior_idx.nbytes + c.dk_d.nbytes +
                c.dk_s.nbytes + c.coo_slot.nbytes * 3 + c.dual0.nbytes)
        assert wire < 8 * c.n + c.dual0.nbytes


@pytest.mark.parametrize("clip", ["q51.mp4", "q6.mp4"])
def test_slim_wire_extreme_widths(corpus_dir, clip):
    """Extreme QPs exercise unusual pack widths (wa/wb/wcs) in the
    no-straddle wire (BitPacker::put_ns / _unpack_dev): qp51 yields tiny
    frequency runs (small widths), qp6 dense ones. Bit-exact differential +
    roundtrip per chunk."""
    from avrecode_jax import device, pipeline
    with open(os.path.join(corpus_dir, clip), "rb") as f:
        data = f.read()
    an = device.analyze(data, batch_size=1024, model_profile=2)
    assert an.slim
    widths = set()
    for c in an.chunks:
        widths.add((c.wa, c.wb, c.wcs))
        assert np.array_equal(device.device_probs(an, c), c.host_probs)
    rep = pipeline.roundtrip(data, batch_size=1024, model_profile=2)
    assert rep.ok, widths


def test_slim_multichunk_roundtrip(corpus_dir):
    """Slim path over per-GOP chunks (chunk_mode=1) through the host decoder."""
    from avrecode_jax import device, pipeline
    with open(os.path.join(corpus_dir, "ipb_high.mp4"), "rb") as f:
        data = f.read()
    an = device.analyze(data, batch_size=512, chunk_mode=1, model_profile=2)
    assert an.slim and len(an.chunks) > 1
    for c in an.chunks:
        assert np.array_equal(device.device_probs(an, c), c.host_probs)
    comp, _ = device.compress(data, batch_size=512, chunk_mode=1)
    dec, _ = pipeline.decompress(comp)
    assert dec == data


def test_warm_sectioned_roundtrip(corpus_dir, monkeypatch):
    """v16 warm-started sections: force a seeded multi-section split on a
    small clip, verify the bit-exact host roundtrip and the device
    differential with a nonzero sparse sig0 start state (chunks 1+ start
    from chunk 0's table snapshot)."""
    from avrecode_jax import device, pipeline
    with open(os.path.join(corpus_dir, "multislice.264"), "rb") as f:
        data = f.read()
    monkeypatch.setenv("ARTC_SECTION_BINS", "150000")
    monkeypatch.setenv("ARTC_SEED_BINS", "100000")
    monkeypatch.setenv("ARTC_WARM_BINS", "120000")
    comp, st = pipeline.compress(data)
    assert st.n_chunks > 1
    dec, _ = pipeline.decompress(comp)
    assert dec == data
    an = device.analyze(data, batch_size=256, model_profile=2)
    assert len(an.chunks) > 1
    assert any(c.sig0_idx is not None and len(c.sig0_idx) for c in an.chunks[1:])
    for c in an.chunks:
        assert np.array_equal(device.device_probs(an, c), c.host_probs)


def test_warm_sectioned_profile0_device_differential(corpus_dir, monkeypatch):
    """Profile-0 (immediate-increment) warm sections: chunk-0's table
    snapshot is captured mid-batch, so before v22 it could carry
    over-window counts that the host would halve at first-touch flush but
    the device pass halves elementwise every sub-batch. The v22 normalized
    snapshot makes both sides provably coincide — this differential pins
    that on a real multi-section trace with warm-started chunks."""
    from avrecode_jax import device, pipeline
    with open(os.path.join(corpus_dir, "multislice.264"), "rb") as f:
        data = f.read()
    monkeypatch.setenv("ARTC_SECTION_BINS", "150000")
    monkeypatch.setenv("ARTC_SEED_BINS", "100000")
    monkeypatch.setenv("ARTC_WARM_BINS", "120000")
    comp, st = pipeline.compress(data, batch_size=256)
    assert st.n_chunks > 1
    dec, _ = pipeline.decompress(comp)
    assert dec == data
    an = device.analyze(data, batch_size=256, model_profile=0)
    assert not an.slim and len(an.chunks) > 1
    for c in an.chunks:
        assert np.array_equal(device.device_probs(an, c), c.host_probs)


def test_cavlc_device_differential(corpus_dir):
    """CAVLC slices ride the same trace/bin transport as CABAC: the slim wire
    + device pass must reproduce the host probs bit-exactly on a CAVLC clip
    (incl. the kKindPrior I_PCM-style passthrough bins), and the device
    container must decode on the host."""
    from avrecode_jax import device, pipeline
    with open(os.path.join(corpus_dir, "cavlc_b8.264"), "rb") as f:
        data = f.read()
    an = device.analyze(data, batch_size=512, model_profile=2)
    assert an.slim and an.chunks
    for c in an.chunks:
        assert np.array_equal(device.device_probs(an, c), c.host_probs)
    comp, _ = device.compress(data, batch_size=512)
    dec, _ = pipeline.decompress(comp)
    assert dec == data


def test_model_pass_mm_impl_bit_exact(small_clip):
    """The sort-free (masked-matmul) prefix formulation must match the
    sort-based one bit-for-bit on real traces."""
    from avrecode_jax import device
    from avrecode_jax.ops import model_pass as mp
    an = device.analyze(small_clip, batch_size=1024)
    c = an.chunks[0]
    a = mp.run_chunk(c.bit, c.kind, c.key, c.prior, c.dual0, 1024,
                     an.fast_w, an.slow_w, an.sig_w, an.sig_alpha, an.n_sig,
                     impl="sort")
    b = mp.run_chunk(c.bit, c.kind, c.key, c.prior, c.dual0, 1024,
                     an.fast_w, an.slow_w, an.sig_w, an.sig_alpha, an.n_sig,
                     impl="mm")
    import numpy as np
    assert np.array_equal(a, b)
    assert np.array_equal(a, c.host_probs)
