"""Sharded recompression step: GOP-parallel model pass + lane-parallel rANS
encode over a jax.sharding.Mesh via shard_map.

This is the framework's "training step" analogue — the adaptive-model scan IS
the learning loop — jitted over the full mesh:
  - chunk tensors shard over 'gop' (each device owns whole chunks, with their
    own estimator tables: deterministic, zero cross-chunk state by format
    design — recode.h chunking);
  - the rANS lane-encode scan shards over 'lane' (lanes are independent
    subsequences of the pair stream);
  - global statistics (total payload words, billing sums) reduce with psum
    over both axes.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.8 top-level API; the experimental path is deprecated
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from ..ops import model_pass as mp
from ..ops import lanes as lx


def sharded_v4_compress_step(mesh: Mesh, *, batch: int, sup: int, fast_w: int,
                             slow_w: int, sig_w: int, sig_alpha: int, ud: int,
                             us: int, ns: int, n_sig: int, K_total: int,
                             layout: tuple):
    """Builds the jitted PRODUCT mesh step over the ANL5 wire: each device
    receives its chunks' fused bit-packed blobs (device._build_blob4 with a
    mesh-uniform layout), expands them on chip (wire_expand4_blob — the same
    ~2.3 B/bin wire the single-chip path ships, instead of the ~6 B/bin dense
    planes the pre-blob mesh paid), models them with the frozen-batch v3
    core, lane-scans over 'lane', and psums the payload-word total over both
    axes. The outputs reassemble into byte-identical
    RansInterleaved blobs -> a real ATRC container (device.compress_mesh),
    decodable by the host serial decoder.

    Inputs (G = chunks, multiple of mesh 'gop'; layout/ud/us/ns are the
    mesh-uniform maxima; M = ns*sup*batch):
      blob: uint32[G, W] fused ANL5 planes (pad chunks: zero planes but VALID
        dk scratch rows — v3_core's sorted-unique scatters need live keys)
      sc: int32[G, 6] = [wa, wb, wcs, n, n_coo, ud_real] per chunk
      dual0: uint16[G, n_dual, 4]
      sig0_idx: uint32[G, SK]; sig0_val: uint16[G, SK, 2] — sparse sig start
        state (v16 warm-started chunks; pad rows target n_sig and drop)
      n_arr: int32[G] live bins per chunk (lane-scan validity)
    Returns (x_final uint32[G, K], words uint16[G, T, K], emits bool[G, T, K],
    probs uint16[G, M], total_words int32[])."""
    n_lane = mesh.shape["lane"]
    assert K_total % n_lane == 0
    k_local = K_total // n_lane
    M = ns * sup * batch

    def step(blob, sc, dual0, sig0_idx, sig0_val, n_arr):
        def per_chunk(bl, s, d0, si, sv):
            bit, kind, slot, prior, deltas, dk_d, dk_s = mp.wire_expand4_blob(
                bl, s, m=M, nsub=ns * sup, U=ud + us, ud=ud, us=us, ns=ns,
                batch=batch, layout=layout, mesh=True)
            probs = mp.v3_core(
                bit, kind, slot, prior, dk_d, dk_s, deltas, d0, batch=batch,
                sup=sup, fast_w=fast_w, slow_w=slow_w, sig_w=sig_w,
                sig_alpha=sig_alpha, ud=ud, us=us, n_sig=n_sig,
                sig0_idx=si, sig0_val=sv)
            return probs, bit
        probs, bits = jax.vmap(per_chunk)(blob, sc, dual0, sig0_idx, sig0_val)
        G_l = probs.shape[0]
        T = M // K_total
        lane_idx = jax.lax.axis_index("lane")

        def lane_encode(b, p, n):
            bt = b.astype(jnp.uint32).reshape(T, K_total)
            pt = jnp.maximum(p.astype(jnp.uint32), 1).reshape(T, K_total)
            vt = (jax.lax.iota(jnp.int32, M) < n).reshape(T, K_total)
            sl = lane_idx * k_local
            bt_l = jax.lax.dynamic_slice_in_dim(bt, sl, k_local, axis=1)
            pt_l = jax.lax.dynamic_slice_in_dim(pt, sl, k_local, axis=1)
            vt_l = jax.lax.dynamic_slice_in_dim(vt, sl, k_local, axis=1)
            return lx._lane_scan(bt_l, pt_l, vt_l)

        x_final, words, emits = jax.vmap(lane_encode)(
            bits, probs.astype(jnp.uint32), n_arr)
        # Total payload words (incl. 2 state words per lane stream) across the
        # whole mesh: psum over both axes.
        total_words = jax.lax.psum(
            jax.lax.psum(jnp.sum(emits.astype(jnp.int32)) + 2 * G_l * k_local,
                         "lane"), "gop")
        return x_final, words, emits, probs, total_words

    sharded = shard_map(
        step, mesh=mesh,
        in_specs=(P("gop", None), P("gop", None), P("gop", None, None),
                  P("gop", None), P("gop", None, None), P("gop")),
        out_specs=(P("gop", "lane"), P("gop", None, "lane"), P("gop", None, "lane"),
                   P("gop", None), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def sharded_recompress_step(mesh: Mesh, batch: int, fast_w: int = 48, slow_w: int = 640,
                            sig_w: int = 80, sig_alpha: int = 1):
    """Builds the jitted sharded step.

    Inputs (G = number of chunk rows, a multiple of mesh 'gop' size; N = padded
    pairs per chunk; K = lanes, a multiple of mesh 'lane' size):
      bits, kinds, keys, priors: int32[G, N]
      dual0: int32[G, n_dual, 4]   sig0: int32[G, n_sig, 2]
    Returns:
      probs: uint16[G, N]
      x_final: uint32[G, K], words: uint16[G, T, K], emits: bool[G, T, K]
      total_words: int32[] (psum over the whole mesh)
    """

    def per_chunk(bits, kinds, keys, priors, dual0, sig0):
        # [G_local, ...] -> vmap the per-chunk model pass over local chunks.
        probs = jax.vmap(
            lambda b, k, y, p, d, s: mp.model_pass(
                b, k, y, p, d, s, batch=batch, fast_w=fast_w, slow_w=slow_w,
                sig_w=sig_w, sig_alpha=sig_alpha)
        )(bits, kinds, keys, priors, dual0, sig0)
        return probs

    def step(bits, kinds, keys, priors, dual0, sig0):
        # 'gop' axis: each device processes its local chunks.
        probs = per_chunk(bits, kinds, keys, priors, dual0, sig0)
        # 'lane' axis: reshape each chunk's pair stream to [T, K] and run the
        # lane scan on the local lane shard.
        G, N = bits.shape
        K = jax.lax.psum(1, "lane") * _lanes_per_shard
        T = N // K
        k_local = _lanes_per_shard
        lane_idx = jax.lax.axis_index("lane")

        def lane_encode(b, p):
            bt = b.reshape(T, K).astype(jnp.uint32)
            pt = p.reshape(T, K).astype(jnp.uint32)
            sl = lane_idx * k_local
            bt_l = jax.lax.dynamic_slice_in_dim(bt, sl, k_local, axis=1)
            pt_l = jax.lax.dynamic_slice_in_dim(pt, sl, k_local, axis=1)
            valid = jnp.ones_like(bt_l, dtype=bool)
            return lx._lane_scan(bt_l, pt_l, valid)

        x_final, words, emits = jax.vmap(lane_encode)(bits, probs.astype(jnp.uint32))
        total_words = jax.lax.psum(
            jax.lax.psum(jnp.sum(emits.astype(jnp.int32)) + 2 * x_final.shape[0] *
                         x_final.shape[1], "lane"), "gop")
        return probs, x_final, words, emits, total_words

    _lanes_per_shard = 0  # bound below

    def build(K_total: int):
        nonlocal _lanes_per_shard
        n_lane = mesh.shape["lane"]
        assert K_total % n_lane == 0
        _lanes_per_shard = K_total // n_lane
        sharded = shard_map(
            step, mesh=mesh,
            in_specs=(P("gop", None), P("gop", None), P("gop", None), P("gop", None),
                      P("gop", None, None), P("gop", None, None)),
            out_specs=(P("gop", None), P("gop", "lane"), P("gop", None, "lane"),
                       P("gop", None, "lane"), P()),
            check_vma=False,
        )
        return jax.jit(sharded)

    return build
