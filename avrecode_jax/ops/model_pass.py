"""Batched adaptive-model probability pass on device (JAX).

Computes the per-bin 15-bit probabilities for a chunk's coded-bin stream,
bit-exactly matching the host C++ ModelEncoder (avrecode_jax/native/recode.h)
under the batched-update semantics (avrecode_jax/native/model.h note_coded /
flush_updates):

  - count increments are visible immediately -> within a batch this is a
    per-key *segmented prefix sum* (sort by key, cumsum, unsort): fully
    data-parallel;
  - window halving happens only at batch boundaries -> a masked elementwise
    pass over the estimator tables;
  - probabilities are pure integer gathers + arithmetic.

The whole chunk is a `lax.scan` over batches with the estimator tables as
carry. All arithmetic is int32 with floor division, matching the C++ unsigned
math exactly (all operands positive and < 2^31).

This is the data-parallel answer to the reference's strictly serial per-bin
model loop (reference recode.cpp:1057-1058, 1175-1179): the serial dependency
is reduced to one cheap table update per 16k bins.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

PROB_BITS = 15
PROB_SCALE = 1 << PROB_BITS


def _clamp_prob(p):
    return jnp.clip(p, 1, PROB_SCALE - 1)


def _halve_while(x_pos, x_neg, window, iters=16):
    # Replicates: while (pos+neg > window) { pos=(pos+1)>>1; neg=(neg+1)>>1; }
    for _ in range(iters):
        mask = (x_pos + x_neg) > window
        x_pos = jnp.where(mask, (x_pos + 1) >> 1, x_pos)
        x_neg = jnp.where(mask, (x_neg + 1) >> 1, x_neg)
    return x_pos, x_neg


def _halve_iters(window: int, batch: int) -> int:
    """Provable unrolled-iteration count for _halve_while.

    Start-of-sub-batch totals are <= window (estimator seeds are within their
    windows and every staging pass re-halves), and one sub-batch adds at most
    `batch` observations to a key, so the pre-halve total T0 <= window + batch.
    Each masked halving maps t -> at most (t+2)/2 (both halves round up), so
    the worst-case trajectory is computable exactly.
    """
    t, k = window + batch, 0
    while t > window:
        t = (t + 2) >> 1
        k += 1
    return k


def _div_floor(num, den):
    """Exact floor(num / den) for 0 <= num < 2^31, 0 < den < 2^16 and a
    quotient <= 2^15 (every caller's), without an integer divide.

    float32 path + integer fixup: with quotients <= 2^15 a +-1 fixup
    tolerates relative error up to 2^-15 in the float estimate — a ~500 ulp
    budget against the <= 2 ulp of any convert/multiply/reciprocal chain.
    The fixup recovers the exact integer floor, so the result is bit-exact
    on every backend (tests/test_exact_arith.py checks the whole domain).
    """
    q = (num.astype(jnp.float32) * (1.0 / den.astype(jnp.float32))).astype(jnp.int32)
    r = num - q * den
    return q + (r >= den).astype(jnp.int32) - (r < 0).astype(jnp.int32)


def _div_floor2(num, den):
    """floor(num / den), exact for 0 <= num < 2^24 and 0 < den < 2^16 (vs
    _div_floor's 2^15 quotient bound): num and den convert exactly, so the
    float32 estimate's absolute error is < 2 there (<= 2 roundings x 2^-24
    relative), and two fixup rounds correct +-2.
    Used for the wire-unpack position divides, where num ranges over the
    padded bin count m (< 2^24 by construction, asserted at staging)."""
    q = (num.astype(jnp.float32) * (1.0 / den.astype(jnp.float32))).astype(jnp.int32)
    for _ in range(2):
        r = num - q * den
        q = q + (r >= den).astype(jnp.int32) - (r < 0).astype(jnp.int32)
    return q


# Residual-level bins (container v15): Dirichlet count-weighted mix with the
# mirrored-CABAC prior, selected per bin by the prior's bit-15 tag on
# kKindDual bins. Must match native/model.h kResDirAlpha / kResDirFastBoost.
RES_DIR_ALPHA = 32
RES_DIR_K = 2


def _dual_prob(dfp, dfn, dsp, dsn, prior_f, tag):
    """kKindDual probability: fixed-weight linear mix (mb-layer/cbf bins),
    or — when the prior is bit-15 tagged — the v15 Dirichlet count-weighted
    res mix. Replicates PriorModel::prob_for / dual_prob bit-exactly."""
    ps = _div_floor(dsp << PROB_BITS, dsp + dsn)
    pf = _div_floor(dfp << PROB_BITS, dfp + dfn)
    lin = jnp.where(prior_f > 0, (3 * (pf + ps) + 2 * prior_f) >> 3, (pf + ps) >> 1)
    dirich = _div_floor(((RES_DIR_K * dfp + dsp) << PROB_BITS) + RES_DIR_ALPHA * prior_f,
                        RES_DIR_K * (dfp + dfn) + dsp + dsn + RES_DIR_ALPHA)
    return _clamp_prob(jnp.where(tag != 0, dirich, lin)), _clamp_prob(ps)


@functools.partial(jax.jit,
                   static_argnames=("batch", "sup", "fast_w", "slow_w", "sig_w", "sig_alpha"))
def model_pass_v2(kinds, priors, pre1, pret, bin_u, dk_d, dk_s, dd, ds, dual0, sig0,
                  batch: int, sup: int, fast_w: int, slow_w: int, sig_w: int, sig_alpha: int):
    """Prefix-free super-batched model pass (the fast path).

    Identical output to model_pass (immediate-increment batched semantics);
    all within-batch prefix counts and per-key batch deltas arrive
    precomputed from the host's serial walk, so the device does only:

      per super-step (`sup` batches):
        2 sorted-unique row gathers (the step's distinct dual / sig keys),
        a dense staging loop producing each sub-batch's start-of-batch dict
        state (apply host deltas + halve — (U, 6) elementwise),
        1 gather distributing staged state to bins,
        dense probability math,
        2 sorted-unique scatter-sets writing the final rows back.

    Random-memory ops per super-step: 5, touching U rows + sup*batch bins;
    everything else is dense elementwise work.

    Shapes (ns = number of super-steps, B = batch, U = ud + us):
      kinds/priors/pre1/pret/bin_u: int32[ns, sup, B]; bin_u in [0, U) over
        the concatenated (dual ++ sig) dict space; ext/pad bins point at the
        last dual pad entry (rows initialized to 1 — no div-by-zero).
      dk_d: int32[ns, ud] sorted unique dual rows (padded with extension
        scratch rows n_dual, n_dual+1, ... so hints stay valid).
      dk_s: int32[ns, us] likewise for sig.
      dd: int32[ns, sup, ud, 2] per-sub-batch (ones, total) deltas; ds same
        for sig.
      dual0: int32[n_dual + ud, 4]; sig0: int32[n_sig + us, 2].
    """
    ud = dk_d.shape[1]
    us = dk_s.shape[1]
    alpha_on = sig_alpha & 0xFFFF
    alpha_off = (sig_alpha >> 16) or alpha_on
    it_f = _halve_iters(fast_w, batch)
    it_s = _halve_iters(slow_w, batch)
    it_g = _halve_iters(sig_w, batch)

    def step(tables, xs):
        dual, sig = tables
        kind, prior, p1, pt, bu, kd, ks, ddel, sdel = xs
        dstate0 = dual.at[kd].get(unique_indices=True, indices_are_sorted=True)
        sstate0 = sig.at[ks].get(unique_indices=True, indices_are_sorted=True)

        def stage(carry, deltas):
            dst, sst = carry
            d_one, d_tot = deltas[0][:, 0], deltas[0][:, 1]
            s_one, s_tot = deltas[1][:, 0], deltas[1][:, 1]
            cst = jnp.concatenate([
                jnp.concatenate([dst, jnp.ones((ud, 2), jnp.int32)], axis=1),
                jnp.concatenate([jnp.ones((us, 4), jnp.int32), sst], axis=1),
            ], axis=0)  # (U, 6) start-of-sub-batch state
            nfp = dst[:, 0] + d_one
            nfn = dst[:, 1] + (d_tot - d_one)
            nsp = dst[:, 2] + d_one
            nsn = dst[:, 3] + (d_tot - d_one)
            nfp, nfn = _halve_while(nfp, nfn, fast_w, it_f)
            nsp, nsn = _halve_while(nsp, nsn, slow_w, it_s)
            gp = sst[:, 0] + s_one
            gn = sst[:, 1] + (s_tot - s_one)
            gp, gn = _halve_while(gp, gn, sig_w, it_g)
            return (jnp.stack([nfp, nfn, nsp, nsn], axis=1),
                    jnp.stack([gp, gn], axis=1)), cst

        (dfin, sfin), cstates = jax.lax.scan(stage, (dstate0, sstate0), (ddel, sdel))
        # One gather distributes every sub-batch's staged state to its bins.
        sub_idx = (jax.lax.broadcasted_iota(jnp.int32, (sup, batch), 0) * (ud + us)
                   + bu.reshape(sup, batch)).reshape(-1)
        st = cstates.reshape(sup * (ud + us), 6)[sub_idx]  # (sup*B, 6)

        kind_f = kind.reshape(-1)
        # Sig priors carry the mix weight in bit 15 (PriorModel::kPriorOffTag):
        # set = off-mode (weight alpha_off), clear = on-mode (weight alpha_on).
        prior_raw = prior.reshape(-1)
        prior_f = prior_raw & 0x7FFF
        alpha_v = jnp.where(prior_raw >> 15 != 0, alpha_off, alpha_on)
        ones_f = p1.reshape(-1)
        zeros_f = pt.reshape(-1) - ones_f
        dfp = st[:, 0] + ones_f
        dfn = st[:, 1] + zeros_f
        dsp = st[:, 2] + ones_f
        dsn = st[:, 3] + zeros_f
        spos = st[:, 4] + ones_f
        sneg = st[:, 5] + zeros_f
        p_dual, p_slow = _dual_prob(dfp, dfn, dsp, dsn, prior_f, prior_raw >> 15)
        p_sig = _clamp_prob(_div_floor((spos << PROB_BITS) + alpha_v * prior_f,
                                       spos + sneg + alpha_v))
        prob = jnp.where(kind_f == 0, p_dual, jnp.where(kind_f == 1, p_slow, p_sig))
        prob = jnp.where(kind_f == 3, _clamp_prob(prior_f), prob)

        dual = dual.at[kd].set(dfin, unique_indices=True, indices_are_sorted=True)
        sig = sig.at[ks].set(sfin, unique_indices=True, indices_are_sorted=True)
        return (dual, sig), prob.astype(jnp.uint16)

    (_, _), probs = jax.lax.scan(step, (dual0, sig0),
                                 (kinds, priors, pre1, pret, bin_u, dk_d, dk_s, dd, ds))
    return probs.reshape(-1)


def _unpack_dev(words, pos, w):
    """Gathers w-bit no-straddle entries out of a packed word stream: entry j
    lives entirely inside word j // (32//w) at bit offset (j % (32//w)) * w
    (recode.cc BitPacker::put_ns) — ONE word gather per entry instead of a
    straddling pair. w is a TRACED scalar, so chunks with different pack
    widths reuse one compiled program."""
    epw = 32 // w
    q = _div_floor2(pos, epw)
    off = ((pos - q * epw) * w).astype(jnp.uint32)
    mask = (jnp.uint32(1) << jnp.uint32(w)) - 1
    return ((words[q] >> off) & mask).astype(jnp.int32)


@jax.jit
def dual0_expand(rows, idx, esc_idx, esc_val):
    """ANL5 dual0 row-dictionary -> dense uint16[n_dual, 4] on device. The
    dual table rows are massively redundant (recode.cc write_slim_chunk dual0
    dict: ~0.2 MB wire instead of 1.42 MB dense); this tiny gather + escape
    scatter runs once per distinct table per compress."""
    d = rows[jnp.minimum(idx.astype(jnp.int32), rows.shape[0] - 1)]
    return d.at[esc_idx.astype(jnp.int32)].set(esc_val, mode="drop")


# Fused-blob segment order (word lengths derived from the element counts in
# `layout`); device._build_blob4 packs the blob with the identical layout.
def _blob_layout_words(layout, nsub: int, ns: int, ud: int, us: int):
    Lh, La, Lb, Lc, npi, ne, nc, ncc = layout
    sizes = [Lh, La, Lb, Lc,          # u32 word streams (hdr/a/b/cs)
             npi // 4,                # prior_idx u8[npi]
             128,                     # pdict u16[256]
             ne,                      # esc_idx u32[ne]
             ne // 2,                 # esc_val u16[ne]
             (nsub + 1) // 2,         # coo_cnt u16[nsub]
             nc // 4,                 # coo_nib u8[nc] (ones | tot<<4)
             ncc,                     # cesc_idx u32[ncc]
             ncc,                     # cesc_val u16[ncc, 2]
             ns * ud,                 # dk_d u32[ns, ud]
             ns * us]                 # dk_s u32[ns, us]
    offs = [0]
    for s in sizes:
        offs.append(offs[-1] + s)
    return offs


@functools.partial(jax.jit, static_argnames=("m", "nsub", "U", "ud", "us",
                                              "ns", "batch", "layout", "mesh"))
def wire_expand4_blob(blob, sc, *, m: int, nsub: int, U: int, ud: int,
                      us: int, ns: int, batch: int, layout: tuple,
                      mesh: bool = False):
    """ANL5 wire decompression from ONE fused u32 blob (all per-chunk planes
    at 4-byte-aligned offsets) + one i32 scalar vector [wa, wb, wcs, n,
    n_coo] (+ ud_real under mesh=True). A single host->device transfer per
    chunk replaces ~15 separate uploads; segment views are static slices +
    bitcasts, free under XLA.

    `layout` = (Lh, La, Lb, Lc, npi, ne, nc, ncc) element counts (already
    bucketed by the host so program variants stay bounded). mesh=True runs
    with mesh-uniform static shapes: `ud` is the mesh-wide dual-dict maximum
    and the chunk's real width arrives traced in sc[5] (slots shift up into
    the uniform space). Returns (bit, kind, slot, prior) int32[m] + deltas
    uint16[nsub, U, 2] + the dk_d/dk_s key tables riding the blob.

    The wire decompression itself (recode.cc write_slim_chunk): 4-bit header
    nibbles -> (bit, kind, class) per bin; two cumulative sums re-index the
    hot (wa-bit) / cold (wb-bit) rank substreams; a bin's slot is its
    sub-batch COO run entry at that rank (runs are frequency-ordered by the
    host, so hot slots ride wa bits); COO slots double as the update-delta
    scatter source; bins [n, m) synthesize the pad pattern (kind 3, slot
    ud-1, prior 1) on device instead of being uploaded. Pack widths
    (wa, wb, wcs) and true lengths (n, n_coo) arrive traced, so only shape
    buckets — not widths — create program variants.

    Random-index gathers are the costly operations here, so everything with
    statically-known positions is dense elementwise work: the header
    nibbles expand by broadcast-shift (no gather), the per-bin COO run base
    broadcasts from the per-sub-batch starts (no gather), and the prior
    vector pads statically instead of re-gathering itself. The remaining
    data-dependent gathers (rank substreams) run in PROMISE_IN_BOUNDS mode —
    pos_a <= nA and pos_b <= nB by construction, the host sizes La/Lb for
    exactly those entry counts, and a final straddle read lands at worst on
    the next segment's first word — skipping the clamp compare+select XLA
    would otherwise apply per element."""
    offs = _blob_layout_words(layout, nsub, ns, ud, us)
    Lh, La, Lb, Lc, npi, ne, nc, ncc = layout

    def seg(k):
        return jax.lax.slice(blob, (offs[k],), (offs[k + 1],))

    def as_u16(x):
        return jax.lax.bitcast_convert_type(x, jnp.uint16).reshape(-1)

    def as_u8(x):
        return jax.lax.bitcast_convert_type(x, jnp.uint8).reshape(-1)

    def unpack_routed(pos, base, w):
        """w-bit no-straddle entries (recode.cc BitPacker::put_ns: entry j
        lives wholly inside word j // (32//w)) at per-element (stream base,
        entry index) — absolute blob offsets, no bounds clamp (see docstring
        for the in-bounds argument). Routing the hot/cold streams through
        ONE unpack halves the gather count; the no-straddle layout halves it
        again (no straddle gather — the rank pair is the largest expand
        term)."""
        epw = 32 // w
        q = _div_floor2(pos, epw)
        wi = base + q
        off = ((pos - q * epw) * w).astype(jnp.uint32)
        dn = jax.lax.GatherDimensionNumbers(
            offset_dims=(), collapsed_slice_dims=(0,), start_index_map=(0,))
        pb = jax.lax.GatherScatterMode.PROMISE_IN_BOUNDS
        w0 = jax.lax.gather(blob, wi[:, None], dn, slice_sizes=(1,), mode=pb)
        mask = (jnp.uint32(1) << jnp.uint32(w)) - 1
        return ((w0 >> off) & mask).astype(jnp.int32)

    wa, wb, wcs, n, n_coo = sc[0], sc[1], sc[2], sc[3], sc[4]
    i = jax.lax.iota(jnp.int32, m)
    live_n = i < n
    # Header nibbles: dense broadcast-shift expand (8 nibbles per word).
    nib = ((seg(0)[:, None] >> (4 * jax.lax.iota(jnp.uint32, 8))[None, :]) & 15)
    nib = nib.reshape(-1).astype(jnp.int32)
    hdr = (jax.lax.slice(nib, (0,), (m,)) if Lh * 8 >= m
           else jnp.pad(nib, (0, m - Lh * 8)))
    bit = jnp.where(live_n, hdr >> 3, 0)
    kind = jnp.where(live_n, (hdr >> 1) & 3, 3)
    cls = hdr & 1
    live = live_n & (kind != 3)
    a_sel = (live & (cls == 0)).astype(jnp.int32)
    b_sel = (live & (cls == 1)).astype(jnp.int32)
    pos_a = jnp.cumsum(a_sel) - a_sel
    pos_b = jnp.cumsum(b_sel) - b_sel
    rank = unpack_routed(jnp.where(cls == 1, pos_b, pos_a),
                         jnp.where(cls == 1, offs[2], offs[1]),
                         jnp.where(cls == 1, wb, wa))
    # COO slots: clamped unpack (the bucketed nc can overrun the packed
    # stream's true bit length, so PROMISE would be unsound here).
    cs = _unpack_dev(seg(3), jax.lax.iota(jnp.int32, nc), wcs)
    if mesh:
        # Mesh-uniform dict space (static ud = UD maximum): this chunk's own
        # sig slots start at its real (traced) dual width — shift them up so
        # sig rows land at [UD, UD+us) in the uniform space.
        ud_real = sc[5]
        cs = jnp.where(cs >= ud_real, cs + (ud - ud_real), cs)
    coo_cnt = as_u16(seg(8))[:nsub]
    cnts = coo_cnt.astype(jnp.int32)
    starts = jnp.cumsum(cnts) - cnts
    sbase = jnp.broadcast_to(starts[:, None], (nsub, batch)).reshape(-1)
    dn1 = jax.lax.GatherDimensionNumbers(
        offset_dims=(), collapsed_slice_dims=(0,), start_index_map=(0,))
    pb = jax.lax.GatherScatterMode.PROMISE_IN_BOUNDS
    # Per-bin slot lookup: sbase + rank < n_coo <= nc for live bins by
    # construction (rank < its sub-batch's run length, whose segment ends
    # within the stream); dead bins read entry 0 (sbase alone can equal
    # n_coo == nc for trailing empty sub-batches) — PROMISE skips the
    # per-element clamp.
    sidx = jnp.where(live, sbase + rank, 0)
    slot = jnp.where(live, jax.lax.gather(cs, sidx[:, None], dn1,
                                          slice_sizes=(1,), mode=pb), ud - 1)
    # Priors: dict gather (u8 index < 256 = the dict segment's element count,
    # PROMISE-safe) + escape scatter on the npi-domain, padded/sliced
    # statically to m (never a self-gather), neutral 1 beyond n.
    pr = jax.lax.gather(as_u16(seg(5)), as_u8(seg(4)).astype(jnp.int32)[:, None],
                        dn1, slice_sizes=(1,), mode=pb).astype(jnp.int32)
    pr = pr.at[seg(6).astype(jnp.int32)].set(as_u16(seg(7)).astype(jnp.int32),
                                             mode="drop")
    prf = (jax.lax.slice(pr, (0,), (m,)) if npi >= m
           else jnp.pad(pr, (0, m - npi)))
    prior = jnp.where(live_n, prf, 1)
    # Update-delta table: per-entry sub-batch index rebuilt from coo_cnt
    # segment starts, (ones, tot) widened from u8 with the exact >255
    # escapes scattered on top.
    mark = jnp.zeros((nc + 1,), jnp.int32).at[starts].add(1, mode="drop")
    coo_sub = jnp.cumsum(mark[:nc]) - 1
    livec = jax.lax.iota(jnp.int32, nc) < n_coo
    flat = jnp.where(livec, coo_sub * U + cs, nsub * U)
    # (ones, tot) ride one u32 per entry so the table scatter moves half the
    # elements; the bitcast back to u16 pairs is free. Dead entries all write
    # the scratch slot nsub*U, which the slice below drops: racing writes
    # there are never read.
    nib = as_u8(seg(9)).astype(jnp.uint32)
    v32 = (nib & 15) | ((nib >> 4) << 16)
    ce = as_u16(seg(11)).reshape(ncc, 2).astype(jnp.uint32)
    v32 = v32.at[seg(10).astype(jnp.int32)].set(ce[:, 0] | (ce[:, 1] << 16),
                                                mode="drop")
    tbl = jnp.zeros((nsub * U + 1,), jnp.uint32)
    tbl = tbl.at[flat].set(v32, mode="drop", unique_indices=True)
    deltas = jax.lax.bitcast_convert_type(tbl[:nsub * U],
                                          jnp.uint16).reshape(nsub, U, 2)
    dk_d = seg(12).reshape(ns, ud)
    dk_s = seg(13).reshape(ns, us)
    return bit, kind, slot, prior, deltas, dk_d, dk_s


@functools.partial(jax.jit,
                   static_argnames=("batch", "sup", "fast_w", "slow_w", "sig_w", "sig_alpha",
                                    "ud", "us", "n_sig"))
def model_pass_v4(bit_all, kind_all, slot_all, prior_all, dk_d, dk_s, deltas, dual0_u16,
                  batch: int, sup: int, fast_w: int, slow_w: int, sig_w: int,
                  sig_alpha: int, ud: int, us: int, n_sig: int = 1 << 17,
                  sig0_idx=None, sig0_val=None):
    """Frozen-batch pass over wire_expand4's pre-split planes (the ANL5 path);
    returns (probs uint16[m], bits int32[m]). Same core as model_pass_v3."""
    probs = v3_core(bit_all, kind_all, slot_all, prior_all, dk_d, dk_s, deltas,
                    dual0_u16, batch=batch, sup=sup, fast_w=fast_w, slow_w=slow_w,
                    sig_w=sig_w, sig_alpha=sig_alpha, ud=ud, us=us, n_sig=n_sig,
                    sig0_idx=sig0_idx, sig0_val=sig0_val)
    return probs, bit_all


def v3_core(bit_all, kind_all, slot_all, prior_all, dk_d, dk_s,
            deltas, dual0_u16, *, batch: int, sup: int,
            fast_w: int, slow_w: int, sig_w: int, sig_alpha: int, ud: int, us: int,
            n_sig: int = 1 << 17, sig0_idx=None, sig0_val=None):
    """Frozen-batch (model profile 2) pass over the slim wire format.

    The wire carries ~3 bytes/bin
    (u16 packed bit<<15|kind<<13|slot, u8 prior dict index) plus the sparse
    per-sub-batch update deltas; everything wide is reconstructed on device.
    Under profile 2 probabilities read tables as of the last batch flush, so
    the within-batch prefix machinery of model_pass_v2 vanishes entirely —
    per bin state IS the staged start-of-sub-batch dict state.

    bit/kind/slot/prior_all: int[ns*sup*B] (padded; pad = kind 3, slot ud-1,
      bit 0, prior 1) — model_pass_v3 unpacks them from the u16 wire word
    dk_d/dk_s: int32[ns, ud/us] per-super-step sorted-unique key rows
    deltas:   uint16[ns*sup, U, 2] per-sub-batch per-slot (ones, total)
      update table, reconstructed on device by wire_expand
    dual0_u16: uint16[n_dual, 4] seeded dual table (widened on device)

    Returns probs uint16[m]. Bit-identical to the host profile-2 ModelEncoder
    (native/model.h note_coded profile 2 path).
    """
    U = ud + us
    m = bit_all.shape[0]
    ns = m // (sup * batch)
    alpha_on = sig_alpha & 0xFFFF
    alpha_off = (sig_alpha >> 16) or alpha_on
    it_f = _halve_iters(fast_w, batch)
    it_s = _halve_iters(slow_w, batch)
    it_g = _halve_iters(sig_w, batch)

    bit_all = bit_all.astype(jnp.int32)
    kind_all = kind_all.astype(jnp.int32)
    slot_all = slot_all.astype(jnp.int32)
    prior_all = prior_all.astype(jnp.int32)
    dk_d = dk_d.astype(jnp.int32)
    dk_s = dk_s.astype(jnp.int32)
    tbl = deltas.astype(jnp.int32).reshape(ns, sup, U, 2)
    dd = tbl[:, :, :ud, :]
    ds = tbl[:, :, ud:, :]

    dual0 = jnp.concatenate([dual0_u16.astype(jnp.int32),
                             jnp.ones((1 + ud, 4), jnp.int32)], axis=0)
    # Sig start state: zeros (cold) with the sparse v16 warm rows scattered in
    # (indices >= n_sig, incl. the pad sentinel, drop).
    sig_base = jnp.zeros((n_sig, 2), jnp.int32)
    if sig0_idx is not None:
        sig_base = sig_base.at[sig0_idx.astype(jnp.int32)].set(
            sig0_val.astype(jnp.int32), mode="drop")
    sig0 = jnp.concatenate([sig_base, jnp.ones((us, 2), jnp.int32)], axis=0)

    sh = (ns, sup, batch)

    def step(tables, xs):
        dual, sig = tables
        bit, kind, slot, prior_raw, kd, ks, ddel, sdel = xs
        dstate0 = dual.at[kd].get(unique_indices=True, indices_are_sorted=True)
        sstate0 = sig.at[ks].get(unique_indices=True, indices_are_sorted=True)

        def stage(carry, deltas):
            dst, sst = carry
            d_one, d_tot = deltas[0][:, 0], deltas[0][:, 1]
            s_one, s_tot = deltas[1][:, 0], deltas[1][:, 1]
            cst = jnp.concatenate([
                jnp.concatenate([dst, jnp.ones((ud, 2), jnp.int32)], axis=1),
                jnp.concatenate([jnp.ones((us, 4), jnp.int32), sst], axis=1),
            ], axis=0)  # (U, 6) start-of-sub-batch state
            nfp = dst[:, 0] + d_one
            nfn = dst[:, 1] + (d_tot - d_one)
            nsp = dst[:, 2] + d_one
            nsn = dst[:, 3] + (d_tot - d_one)
            nfp, nfn = _halve_while(nfp, nfn, fast_w, it_f)
            nsp, nsn = _halve_while(nsp, nsn, slow_w, it_s)
            gp = sst[:, 0] + s_one
            gn = sst[:, 1] + (s_tot - s_one)
            gp, gn = _halve_while(gp, gn, sig_w, it_g)
            return (jnp.stack([nfp, nfn, nsp, nsn], axis=1),
                    jnp.stack([gp, gn], axis=1)), cst

        (dfin, sfin), cstates = jax.lax.scan(stage, (dstate0, sstate0), (ddel, sdel))
        sub_idx = (jax.lax.broadcasted_iota(jnp.int32, (sup, batch), 0) * U
                   + slot.reshape(sup, batch)).reshape(-1)
        st = cstates.reshape(sup * U, 6)[sub_idx]  # (sup*B, 6)

        kind_f = kind.reshape(-1)
        prior_raw = prior_raw.reshape(-1)
        prior_f = prior_raw & 0x7FFF
        alpha_v = jnp.where(prior_raw >> 15 != 0, alpha_off, alpha_on)
        # Frozen semantics: the staged state IS the per-bin state (no within-
        # batch prefix adders).
        p_dual, p_slow = _dual_prob(st[:, 0], st[:, 1], st[:, 2], st[:, 3],
                                    prior_f, prior_raw >> 15)
        p_sig = _clamp_prob(_div_floor((st[:, 4] << PROB_BITS) + alpha_v * prior_f,
                                       st[:, 4] + st[:, 5] + alpha_v))
        prob = jnp.where(kind_f == 0, p_dual, jnp.where(kind_f == 1, p_slow, p_sig))
        prob = jnp.where(kind_f == 3, _clamp_prob(prior_f), prob)

        dual = dual.at[kd].set(dfin, unique_indices=True, indices_are_sorted=True)
        sig = sig.at[ks].set(sfin, unique_indices=True, indices_are_sorted=True)
        return (dual, sig), prob.astype(jnp.uint16)

    (_, _), probs = jax.lax.scan(
        step, (dual0, sig0),
        (bit_all.reshape(sh), kind_all.reshape(sh), slot_all.reshape(sh),
         prior_all.reshape(sh), dk_d, dk_s, dd, ds))
    return probs.reshape(-1)


@functools.partial(jax.jit, static_argnames=("batch", "fast_w", "slow_w", "sig_w", "sig_alpha"))
def model_pass_dict(bits, kinds, priors, bin_u, dict_keys, dual0, sig0, batch: int,
                    fast_w: int, slow_w: int, sig_w: int, sig_alpha: int):
    """Dictionary-compacted model pass: bit-identical to model_pass, ~10x fewer
    random-memory operations.

    The host pre-computes, per batch, the set of *distinct* unified keys (the
    "dictionary", U entries, U << batch) and each bin's index into it. The
    batch step then becomes dense work on (batch, U) one-hot matrices:

      - per-bin estimator state = one-hot @ dict_rows  (a matrix product,
        exact in fp32);
      - within-batch per-key exclusive prefix counts = exclusive cumsum of the
        one-hot columns;
      - per-key update totals = column sums;
      - table gather/scatter touches only U rows per batch instead of `batch`
        elements — the XLA scatter/gather cost (tens of ns per random row) is
        what bounds the plain formulation.

    bits/kinds/priors/bin_u: int32[n_batches, batch]; bin_u in [0, U).
    dict_keys: int32[n_batches, U] unified keys (dual key, or n_dual + sig
    key, scratch = n_dual - 1 for padding); every row's entries are unique.
    """
    n_dual = dual0.shape[0]
    n_sig = sig0.shape[0]  # includes a trailing scratch row
    u_width = dict_keys.shape[1]
    alpha_on = sig_alpha & 0xFFFF
    alpha_off = (sig_alpha >> 16) or alpha_on

    def step(tables, xs):
        dual, sig = tables
        bit, kind, prior, bu, dk = xs
        prior_tag = prior >> 15  # off-mode sig mix-weight tag (bit 15)
        prior = prior & 0x7FFF
        is_sig_row = dk >= n_dual
        # Rows of the *other* table alias that table's scratch row (never a
        # live key — a live row must have exactly one dict entry writing it).
        drow = jnp.where(is_sig_row, n_dual - 1, dk)
        srow = jnp.where(is_sig_row, dk - n_dual, n_sig - 1)
        dstate = dual[drow]  # (U, 4)
        sstate = sig[srow]   # (U, 2)

        iota_u = jax.lax.broadcasted_iota(jnp.int32, (batch, u_width), 1)
        onehot = bu[:, None] == iota_u           # (B, U) bool
        oh_i = onehot.astype(jnp.int32)
        o1 = oh_i * bit[:, None]
        ex_ones = jnp.cumsum(o1, axis=0) - o1    # exclusive per-key prefix
        ex_tot = jnp.cumsum(oh_i, axis=0) - oh_i
        pre_ones = jnp.sum(jnp.where(onehot, ex_ones, 0), axis=1)
        pre_tot = jnp.sum(jnp.where(onehot, ex_tot, 0), axis=1)
        pre_zeros = pre_tot - pre_ones

        # Per-bin start-of-batch state via one-hot contraction (counts and
        # states < 2^24, exact in fp32).
        oh_f = onehot.astype(jnp.float32)
        dmat = jax.lax.dot(oh_f, dstate.astype(jnp.float32),
                           precision=jax.lax.Precision.HIGHEST).astype(jnp.int32)
        smat = jax.lax.dot(oh_f, sstate.astype(jnp.float32),
                           precision=jax.lax.Precision.HIGHEST).astype(jnp.int32)
        dfp = dmat[:, 0] + pre_ones
        dfn = dmat[:, 1] + pre_zeros
        dsp = dmat[:, 2] + pre_ones
        dsn = dmat[:, 3] + pre_zeros
        spos = smat[:, 0] + pre_ones
        sneg = smat[:, 1] + pre_zeros

        is_ext = kind == 3
        p_dual, p_slow = _dual_prob(dfp, dfn, dsp, dsn, prior, prior_tag)
        alpha_v = jnp.where(prior_tag != 0, alpha_off, alpha_on)
        p_sig = _clamp_prob(((spos << PROB_BITS) + alpha_v * prior) //
                            (spos + sneg + alpha_v))
        prob = jnp.where(kind == 0, p_dual, jnp.where(kind == 1, p_slow, p_sig))
        prob = jnp.where(is_ext, _clamp_prob(prior), prob)

        # Per-dict-row update totals. kind masking matches model_pass: ext
        # bins update nothing; sig bins only the sig table. A sig row's bins
        # are all kind==2, so its dual delta is zero by construction (and vice
        # versa) — no explicit row routing needed.
        m_dual = ((kind != 2) & (kind != 3)).astype(jnp.int32)
        m_sig = (kind == 2).astype(jnp.int32)
        d_ones = jnp.sum(oh_i * (bit * m_dual)[:, None], axis=0)
        d_tot = jnp.sum(oh_i * m_dual[:, None], axis=0)
        s_ones = jnp.sum(oh_i * (bit * m_sig)[:, None], axis=0)
        s_tot = jnp.sum(oh_i * m_sig[:, None], axis=0)

        # Updated + halved rows, written back with scatter-set. Duplicate row
        # targets arise only where multiple dict entries alias a scratch row
        # (never a live key), so value races touch garbage rows only.
        nfp = dstate[:, 0] + d_ones
        nfn = dstate[:, 1] + (d_tot - d_ones)
        nsp = dstate[:, 2] + d_ones
        nsn = dstate[:, 3] + (d_tot - d_ones)
        nfp, nfn = _halve_while(nfp, nfn, fast_w)
        nsp, nsn = _halve_while(nsp, nsn, slow_w)
        new_d = jnp.stack([nfp, nfn, nsp, nsn], axis=1)
        gp = sstate[:, 0] + s_ones
        gn = sstate[:, 1] + (s_tot - s_ones)
        gp, gn = _halve_while(gp, gn, sig_w)
        new_s = jnp.stack([gp, gn], axis=1)
        dual = dual.at[drow].set(new_d)
        sig = sig.at[srow].set(new_s)
        return (dual, sig), prob.astype(jnp.uint16)

    (_, _), probs = jax.lax.scan(step, (dual0, sig0), (bits, kinds, priors, bin_u, dict_keys))
    return probs.reshape(-1)


@functools.partial(jax.jit,
                   static_argnames=("batch", "fast_w", "slow_w", "sig_w", "sig_alpha", "impl"))
def model_pass(bits, kinds, keys, priors, dual0, sig0, batch: int, fast_w: int, slow_w: int,
               sig_w: int, sig_alpha: int, impl: str = "sort"):
    """Returns probs (uint16[n_pairs_padded]) for the padded pair stream.

    bits/kinds/keys/priors: int32[n_batches * batch] (padded; padding must use
    the scratch dual key = dual0.shape[0] - 1 with bit 0).
    dual0: int32[n_dual + 1, 4] seeded (fp, fn, sp, sn); last row is scratch.
    sig0: int32[n_sig, 2] (pos, neg) start state (zeros).
    impl: "sort" = stable-argsort segmented prefix sums (a sort network);
          "mm" = tril-masked key-equality matmul (exclusive per-key prefix
          counts as an fp32 contraction — exact for batch <= 2^20, no
          sort). Bit-identical outputs; pick by measured speed.
    """
    if impl not in ("sort", "mm"):
        raise ValueError(f"model_pass impl must be 'sort' or 'mm', got {impl!r}")
    n = bits.shape[0]
    assert n % batch == 0
    n_batches = n // batch
    n_dual = dual0.shape[0]  # includes scratch row
    alpha_on = sig_alpha & 0xFFFF
    alpha_off = (sig_alpha >> 16) or alpha_on

    shape_b = (n_batches, batch)
    bits_b = bits.reshape(shape_b)
    kinds_b = kinds.reshape(shape_b)
    keys_b = keys.reshape(shape_b)
    priors_b = priors.reshape(shape_b)

    def step(tables, xs):
        dual, sig = tables
        bit, kind, key, prior = xs
        prior_tag = prior >> 15  # off-mode sig mix-weight tag (bit 15)
        prior = prior & 0x7FFF
        is_sig = kind == 2
        # kind 3 = prior passthrough (CABAC-parity EOB bins): no table read or
        # update — retarget them at the scratch row so the prefix machinery
        # never mixes them into a live key's segment.
        is_ext = kind == 3
        key = jnp.where(is_ext, n_dual - 1, key)
        # Unified key space for the within-batch prefix machinery.
        ukey = jnp.where(is_sig, key + n_dual, key)

        if impl == "mm":
            # pre_ones[i] = #{j < i : ukey_j == ukey_i, bit_j = 1} as a
            # masked matmul: M[i,j] = (ukey_i == ukey_j) & (j < i), then
            # (pre_ones, pre_tot) = M @ [bit, 1]. Counts < 2^20 are exact in
            # fp32; a matrix product replaces the sort network.
            pos_idx = jnp.arange(batch, dtype=jnp.int32)
            m = ((ukey[:, None] == ukey[None, :]) &
                 (pos_idx[None, :] < pos_idx[:, None]))
            rhs = jnp.stack([bit, jnp.ones_like(bit)], axis=1)
            pre = jax.lax.dot(m.astype(jnp.float32), rhs.astype(jnp.float32),
                              precision=jax.lax.Precision.HIGHEST)
            pre = pre.astype(jnp.int32)
            pre_ones = pre[:, 0]
            pre_tot = pre[:, 1]
            pre_zeros = pre_tot - pre_ones
        else:
            order = jnp.argsort(ukey, stable=True)
            ukey_s = ukey[order]
            ones_s = bit[order]
            start = jnp.concatenate(
                [jnp.ones((1,), jnp.bool_), ukey_s[1:] != ukey_s[:-1]])
            ex_ones = jnp.cumsum(ones_s) - ones_s  # exclusive cumsum
            pos_idx = jnp.arange(batch, dtype=jnp.int32)
            # Segment-start baselines via running max (cumsums nondecreasing).
            seg_ex_ones = jax.lax.cummax(jnp.where(start, ex_ones, -1))
            seg_first = jax.lax.cummax(jnp.where(start, pos_idx, -1))
            pre_ones_s = ex_ones - seg_ex_ones
            pre_tot_s = pos_idx - seg_first
            # Unsort.
            inv = jnp.zeros_like(order).at[order].set(pos_idx)
            pre_ones = pre_ones_s[inv]
            pre_tot = pre_tot_s[inv]
            pre_zeros = pre_tot - pre_ones

        # Effective estimator state for each pair. Sig keys index a different
        # table; route each gather/scatter to its own space (the other side
        # reads/writes the scratch row so indices stay in bounds).
        dkey = jnp.where(is_sig, n_dual - 1, key)  # scratch row for sig pairs
        skey = jnp.where(is_sig, key, 0)
        dfp = dual[dkey, 0] + pre_ones
        dfn = dual[dkey, 1] + pre_zeros
        dsp = dual[dkey, 2] + pre_ones
        dsn = dual[dkey, 3] + pre_zeros
        spos = sig[skey, 0] + pre_ones
        sneg = sig[skey, 1] + pre_zeros

        # Three-voice mix when a mirrored-CABAC prior rides along (mb-layer
        # ctx bins); plain fast+slow otherwise (prior == 0 sentinel); v15
        # Dirichlet res mix when the prior is bit-15 tagged.
        p_dual, p_slow = _dual_prob(dfp, dfn, dsp, dsn, prior, prior_tag)
        alpha_v = jnp.where(prior_tag != 0, alpha_off, alpha_on)
        p_sig = _clamp_prob(((spos << PROB_BITS) + alpha_v * prior) //
                            (spos + sneg + alpha_v))
        prob = jnp.where(kind == 0, p_dual, jnp.where(kind == 1, p_slow, p_sig))
        prob = jnp.where(is_ext, _clamp_prob(prior), prob)

        # Batch-boundary update: scatter-add totals, then masked halving.
        d_ones = jnp.where(is_sig | is_ext, 0, bit)
        d_zero = jnp.where(is_sig | is_ext, 0, 1 - bit)
        s_ones = jnp.where(is_sig, bit, 0)
        s_zero = jnp.where(is_sig, 1 - bit, 0)
        dual = dual.at[dkey, 0].add(d_ones)
        dual = dual.at[dkey, 1].add(d_zero)
        dual = dual.at[dkey, 2].add(d_ones)
        dual = dual.at[dkey, 3].add(d_zero)
        sig = sig.at[skey, 0].add(s_ones)
        sig = sig.at[skey, 1].add(s_zero)
        fp, fn = _halve_while(dual[:, 0], dual[:, 1], fast_w)
        sp, sn = _halve_while(dual[:, 2], dual[:, 3], slow_w)
        dual = jnp.stack([fp, fn, sp, sn], axis=1)
        sp2, sn2 = _halve_while(sig[:, 0], sig[:, 1], sig_w)
        sig = jnp.stack([sp2, sn2], axis=1)
        return (dual, sig), prob.astype(jnp.uint16)

    (_, _), probs = jax.lax.scan(step, (dual0, sig0), (bits_b, kinds_b, keys_b, priors_b))
    return probs.reshape(-1)


def _bucket(n_batches: int) -> int:
    # Pad the batch count to a power of two so XLA programs are reused across
    # chunks of different sizes (padding batches only touch the scratch row).
    b = 1
    while b < n_batches:
        b *= 2
    return b


def default_impl() -> str:
    import os
    return os.environ.get("ARTC_MODEL_IMPL", "v2")


def default_sup() -> int:
    # Super-step size (batches per model-scan step): larger steps amortize
    # the fixed cost of the 5 random-memory ops per step until the staging
    # state stops fitting; 128 balances that against padding waste (streams
    # pad to sup*batch) and dictionary export size. Not yet re-swept on a
    # GPU.
    import os
    return int(os.environ.get("ARTC_MODEL_SUP", "128"))


def build_dicts(kind_p, key_p, n_dual_ext, batch):
    """Per-batch unique-key dictionaries for the dict impl (host-side numpy).

    Returns (bin_u int32[n_batches, batch], dict_keys int32[n_batches, U])
    where U is a power-of-two bucket of the max per-batch unique count.
    Unified key space: dual keys as-is (ext bins retargeted at the scratch
    row n_dual_ext - 1, matching model_pass), sig keys offset by n_dual_ext.
    """
    scratch = n_dual_ext - 1
    ukey = np.where(kind_p == 3, scratch, key_p.astype(np.int64))
    ukey = np.where(kind_p == 2, key_p.astype(np.int64) + n_dual_ext, ukey)
    nb = len(ukey) // batch
    ukey_b = ukey.reshape(nb, batch)
    uniqs = []
    invs = np.empty((nb, batch), np.int32)
    for i in range(nb):
        u, inv = np.unique(ukey_b[i], return_inverse=True)
        uniqs.append(u)
        invs[i] = inv.astype(np.int32)
    u_width = _bucket(max(len(u) for u in uniqs))
    dict_keys = np.full((nb, u_width), scratch, np.int32)
    for i, u in enumerate(uniqs):
        dict_keys[i, :len(u)] = u.astype(np.int32)
    # Padding entries duplicate the scratch key; they only ever re-write the
    # scratch rows (value races on garbage), live rows keep unique writers.
    return invs, dict_keys


def build_v2_inputs(bit_p, kind_p, key_p, n_dual_ext, n_sig, batch, sup):
    """Host-side (numpy) preprocessing for model_pass_v2: per-super-step
    sorted-unique dictionaries, per-bin dict indices, per-sub-batch per-entry
    (ones, total) deltas."""
    n = len(kind_p)
    ns = n // (sup * batch)
    off = np.int64(1) << 32
    sent = off * 2
    ukey = np.where(kind_p == 2, key_p.astype(np.int64) + off, key_p.astype(np.int64))
    ukey = np.where(kind_p == 3, sent, ukey)  # ext/pad bins own no dict entry
    slab = ukey.reshape(ns, sup * batch)
    uniqs, invs, nds = [], [], []
    for i in range(ns):
        u, inv = np.unique(slab[i], return_inverse=True)
        if u[-1] == sent:
            u = u[:-1]
        uniqs.append(u)
        invs.append(inv.astype(np.int32))
        nds.append(int(np.searchsorted(u, off)))
    max_d = max((nds[i] for i in range(ns)), default=0)
    max_s = max((len(uniqs[i]) - nds[i] for i in range(ns)), default=0)
    ud = _bucket(max_d + 1)
    us = _bucket(max_s + 1)
    dk_d = np.empty((ns, ud), np.int32)
    dk_s = np.empty((ns, us), np.int32)
    bin_u = np.empty((ns, sup * batch), np.int32)
    dd = np.zeros((ns, sup, ud, 2), np.int32)
    ds = np.zeros((ns, sup, us, 2), np.int32)
    bit_i = bit_p.astype(np.int32)
    m_dual = ((kind_p == 0) | (kind_p == 1)).astype(np.int32).reshape(ns, sup, batch)
    m_sig = (kind_p == 2).astype(np.int32).reshape(ns, sup, batch)
    bit_3 = bit_i.reshape(ns, sup, batch)
    for i in range(ns):
        u, inv, nd = uniqs[i], invs[i], nds[i]
        nu = len(u)
        dk_d[i, :nd] = u[:nd].astype(np.int32)
        dk_d[i, nd:] = n_dual_ext + np.arange(ud - nd, dtype=np.int32)
        dk_s[i, :nu - nd] = (u[nd:] - off).astype(np.int32)
        dk_s[i, nu - nd:] = n_sig + np.arange(us - (nu - nd), dtype=np.int32)
        bu = np.where(inv < nd, inv,
                      np.where(inv < nu, ud + inv - nd, ud - 1))
        bin_u[i] = bu
        inv3 = inv.reshape(sup, batch)
        for s in range(sup):
            iv = inv3[s]
            w_d = m_dual[i, s]
            w_s = m_sig[i, s]
            dd[i, s, :nd, 1] = np.bincount(iv, weights=w_d, minlength=nu)[:nd]
            dd[i, s, :nd, 0] = np.bincount(iv, weights=w_d * bit_3[i, s], minlength=nu)[:nd]
            ds[i, s, :nu - nd, 1] = np.bincount(iv, weights=w_s, minlength=nu)[nd:nu]
            ds[i, s, :nu - nd, 0] = np.bincount(iv, weights=w_s * bit_3[i, s],
                                                minlength=nu)[nd:nu]
    return bin_u, dk_d, dk_s, dd, ds, ud, us


def run_chunk_v2(bit, kind, key, prior, pre_ones, pre_tot, dual0, batch, sup,
                 fast_w, slow_w, sig_w, sig_alpha, n_sig, sig0=None):
    """numpy in/out wrapper for the fast path: pads the stream to whole
    super-steps (padding bins become kind-3 no-ops), builds the dictionary
    inputs, runs the jitted pass, trims."""
    n = len(bit)
    if n == 0:
        return np.zeros(0, np.uint16)
    n_dual = dual0.shape[0] + 1  # + legacy scratch row (ext retarget target)
    span = sup * batch
    m = _bucket(-(-n // span)) * span
    pad = m - n
    ns = m // span
    kind_p = np.concatenate([kind.astype(np.int32), np.full(pad, 3, np.int32)])
    bit_p = np.concatenate([bit.astype(np.int32), np.zeros(pad, np.int32)])
    key_p = np.concatenate([key.astype(np.int32), np.zeros(pad, np.int32)])
    prior_p = np.concatenate([prior.astype(np.int32), np.ones(pad, np.int32)])
    pre1_p = np.concatenate([pre_ones.astype(np.int32), np.zeros(pad, np.int32)])
    pret_p = np.concatenate([pre_tot.astype(np.int32), np.zeros(pad, np.int32)])
    bin_u, dk_d, dk_s, dd, ds, ud, us = build_v2_inputs(
        bit_p, kind_p, key_p, n_dual, n_sig, batch, sup)
    dual_ext = np.concatenate(
        [dual0.astype(np.int32), np.ones((1 + ud, 4), np.int32)], axis=0)
    sig_base = np.zeros((n_sig, 2), np.int32) if sig0 is None else sig0.astype(np.int32)
    sig_ext = np.concatenate([sig_base, np.ones((us, 2), np.int32)], axis=0)
    sh = (ns, sup, batch)
    probs = model_pass_v2(
        jnp.asarray(kind_p.reshape(sh)), jnp.asarray(prior_p.reshape(sh)),
        jnp.asarray(pre1_p.reshape(sh)), jnp.asarray(pret_p.reshape(sh)),
        jnp.asarray(bin_u.reshape(sh)), jnp.asarray(dk_d), jnp.asarray(dk_s),
        jnp.asarray(dd), jnp.asarray(ds), jnp.asarray(dual_ext), jnp.asarray(sig_ext),
        batch=int(batch), sup=int(sup), fast_w=int(fast_w), slow_w=int(slow_w),
        sig_w=int(sig_w), sig_alpha=int(sig_alpha))
    return np.asarray(probs)[:n]


def run_chunk_v2_tables(kind, prior, pre_ones, pre_tot, v2_m, bin_u, dk_d, dk_s, dd, ds,
                        dual0, batch, sup, fast_w, slow_w, sig_w, sig_alpha, n_sig,
                        sig0=None):
    """Fast path with C++-precomputed dictionary tables (artc_analyze)."""
    n = len(kind)
    if n == 0:
        return np.zeros(0, np.uint16)
    m = int(v2_m)
    pad = m - n
    ns = m // (sup * batch)
    ud = dk_d.shape[1]
    us = dk_s.shape[1]
    kind_p = np.concatenate([kind.astype(np.int32), np.full(pad, 3, np.int32)])
    prior_p = np.concatenate([prior.astype(np.int32), np.ones(pad, np.int32)])
    pre1_p = np.concatenate([pre_ones.astype(np.int32), np.zeros(pad, np.int32)])
    pret_p = np.concatenate([pre_tot.astype(np.int32), np.zeros(pad, np.int32)])
    dual_ext = np.concatenate(
        [dual0.astype(np.int32), np.ones((1 + ud, 4), np.int32)], axis=0)
    sig_base = np.zeros((n_sig, 2), np.int32) if sig0 is None else sig0.astype(np.int32)
    sig_ext = np.concatenate([sig_base, np.ones((us, 2), np.int32)], axis=0)
    sh = (ns, sup, batch)
    probs = model_pass_v2(
        jnp.asarray(kind_p.reshape(sh)), jnp.asarray(prior_p.reshape(sh)),
        jnp.asarray(pre1_p.reshape(sh)), jnp.asarray(pret_p.reshape(sh)),
        jnp.asarray(bin_u.astype(np.int32).reshape(sh)), jnp.asarray(dk_d),
        jnp.asarray(dk_s), jnp.asarray(dd), jnp.asarray(ds), jnp.asarray(dual_ext),
        jnp.asarray(sig_ext), batch=int(batch), sup=int(sup), fast_w=int(fast_w),
        slow_w=int(slow_w), sig_w=int(sig_w), sig_alpha=int(sig_alpha))
    return np.asarray(probs)[:n]


def run_chunk(bit, kind, key, prior, dual0, batch, fast_w, slow_w, sig_w, sig_alpha, n_sig,
              impl=None, sig0=None):
    """numpy in/out convenience wrapper: pads, runs the jitted pass, trims."""
    n = len(bit)
    if n == 0:
        return np.zeros(0, np.uint16)
    impl = impl or default_impl()
    n_dual = dual0.shape[0]
    m = _bucket(-(-n // batch)) * batch
    pad = m - n
    scratch = n_dual  # extra scratch row index
    bit_p = np.concatenate([bit.astype(np.int32), np.zeros(pad, np.int32)])
    kind_p = np.concatenate([kind.astype(np.int32), np.zeros(pad, np.int32)])
    key_p = np.concatenate([key.astype(np.int32), np.full(pad, scratch, np.int32)])
    prior_p = np.concatenate([prior.astype(np.int32), np.zeros(pad, np.int32)])
    dual_ext = np.concatenate([dual0.astype(np.int32), np.ones((1, 4), np.int32)], axis=0)
    sig_base = np.zeros((n_sig, 2), np.int32) if sig0 is None else sig0.astype(np.int32)
    if impl == "dict":
        nb = m // batch
        bin_u, dict_keys = build_dicts(kind_p, key_p, n_dual + 1, batch)
        sig_ext = np.concatenate([sig_base, np.zeros((1, 2), np.int32)], axis=0)
        probs = model_pass_dict(
            jnp.asarray(bit_p.reshape(nb, batch)), jnp.asarray(kind_p.reshape(nb, batch)),
            jnp.asarray(prior_p.reshape(nb, batch)), jnp.asarray(bin_u),
            jnp.asarray(dict_keys), jnp.asarray(dual_ext), jnp.asarray(sig_ext),
            batch=int(batch), fast_w=int(fast_w), slow_w=int(slow_w), sig_w=int(sig_w),
            sig_alpha=int(sig_alpha))
        return np.asarray(probs)[:n]
    probs = model_pass(
        jnp.asarray(bit_p), jnp.asarray(kind_p), jnp.asarray(key_p), jnp.asarray(prior_p),
        jnp.asarray(dual_ext), jnp.asarray(sig_base), batch=int(batch), fast_w=int(fast_w),
        slow_w=int(slow_w), sig_w=int(sig_w), sig_alpha=int(sig_alpha),
        impl=impl)
    return np.asarray(probs)[:n]
