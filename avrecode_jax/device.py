"""Device compress path: host analysis -> JAX model pass + rANS lanes ->
container assembly.

The host C++ does the serial syntax walk and exports, per chunk, the coded-bin
stream plus the seeded estimator tables (artc_session_analyze2, or streamed
per chunk through artc_session_analyze_begin/_chunk); the device computes all
probabilities (ops/model_pass.py) and encodes the rANS lanes (ops/lanes.py);
the host packs the container (artc_session_pack). The C++ serial decompressor
reads the result — a genuine cross-implementation roundtrip.
"""
from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np

from . import host

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_COMPILE_CACHE = os.path.join(_REPO, ".jax_cache")


def ensure_compile_cache() -> str:
    """Turns on JAX's persistent compilation cache and returns its directory.

    JAX_COMPILATION_CACHE_DIR, when set, is read by JAX itself and nothing is
    set here. Otherwise the cache lives at a fixed directory inside the
    checkout: the directory is part of what a later run looks up, so it never
    depends on a temp dir, a pid or the time."""
    import jax
    if not jax.config.jax_compilation_cache_dir:
        jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE)
    return jax.config.jax_compilation_cache_dir


@dataclass
class ChunkAnalysis:
    bit: np.ndarray    # uint8[n]
    kind: np.ndarray   # uint8[n]
    key: np.ndarray    # uint32[n]
    prior: np.ndarray  # uint16[n]
    pre_ones: np.ndarray  # uint16[n] — within-batch per-key exclusive 1-count
    pre_tot: np.ndarray   # uint16[n] — within-batch per-key exclusive total
    host_probs: np.ndarray  # uint16[n] — C++ reference, for differential tests
    dual0: np.ndarray  # int32[n_dual, 4]
    # model_pass_v2 tables (C++-precomputed; see recode.cc artc_analyze)
    v2_m: int = 0                      # padded stream length (ns * sup * batch)
    v2_bin_u: np.ndarray | None = None   # uint32[m]
    v2_dk_d: np.ndarray | None = None    # int32[ns, ud]
    v2_dk_s: np.ndarray | None = None    # int32[ns, us]
    v2_dd: np.ndarray | None = None      # int32[ns, sup, ud, 2]
    v2_ds: np.ndarray | None = None      # int32[ns, sup, us, 2]
    # sparse sig start state (v16 warm-started chunks; empty = cold zeros)
    sig0_idx: np.ndarray | None = None  # uint32[k]
    sig0_val: np.ndarray | None = None  # int32[k, 2]


def _np_unpack(words: np.ndarray, pos: np.ndarray, w: int) -> np.ndarray:
    """Host-side mirror of ops.model_pass._unpack_dev: w-bit no-straddle
    entries out of a u32 word stream (recode.cc BitPacker::put_ns — entry j
    lives wholly inside word j // (32//w))."""
    epw = 32 // w
    q = pos.astype(np.int64) // epw
    off = ((pos.astype(np.int64) - q * epw) * w).astype(np.uint64)
    wd = words.astype(np.uint64)
    return (wd[q] >> off) & np.uint64((1 << w) - 1)


@dataclass
class SlimChunk:
    """One chunk of the slim (ANL5) analysis export — the bit-packed ~2.3-
    bytes/bin wire format for the frozen-batch (profile 2) device path. See
    recode.cc write_slim_chunk for the layout. The packed planes travel to
    the device verbatim (wire_expand4_blob unpacks them on chip); `.packed`,
    `.coo_slot` and `.dual0` reconstruct the dense views for host-side
    consumers (tests, the mesh dual0 input)."""
    n: int
    ns: int
    ud: int
    us: int
    m: int
    batch: int             # sub-batch size (for the .packed reconstruction)
    pdict: np.ndarray      # uint16[<=255] prior dictionary
    esc_idx: np.ndarray    # uint32[n_esc]
    esc_val: np.ndarray    # uint16[n_esc]
    wa: int                # hot rank width (bits)
    wb: int                # cold rank width (bits)
    wcs: int               # COO slot width (bits)
    hdr_words: np.ndarray  # uint32[] 4-bit nibbles: bit<<3 | kind<<1 | cls
    a_words: np.ndarray    # uint32[] wa-bit hot ranks (nA entries)
    b_words: np.ndarray    # uint32[] wb-bit cold ranks (nB entries)
    nA: int
    nB: int
    prior_idx: np.ndarray  # uint8[n]   (255 = escape)
    dk_d: np.ndarray       # uint32[ns, ud]
    dk_s: np.ndarray       # uint32[ns, us]
    # dual0 row dictionary (ANL5): rows u16[nd, 4], u8 index per table row
    # (255 = escape), exact escape rows. Chunks >= 2 alias chunk 1's.
    d0_rows: np.ndarray    # uint16[nd, 4]
    d0_idx: np.ndarray     # uint8[n_dual]
    d0_esc_idx: np.ndarray  # uint32[j]
    d0_esc_val: np.ndarray  # uint16[j, 4]
    coo_cnt: np.ndarray    # uint16[ns*sup]
    n_coo: int
    cs_words: np.ndarray   # uint32[] wcs-bit COO slots (freq-ordered runs)
    coo_nib: np.ndarray    # uint8[n_coo]: min(ones,15) | min(tot,15)<<4
    host_probs: np.ndarray | None  # uint16[n] (differential testing only)
    # sparse sig start state (v16 warm-started chunks; empty = cold zeros)
    sig0_idx: np.ndarray | None = None  # uint32[k]
    sig0_val: np.ndarray | None = None  # uint16[k, 2]
    # COO escape list: entries whose (ones, tot) exceeded the nibble
    cesc_idx: np.ndarray | None = None  # uint32[j]
    cesc_val: np.ndarray | None = None  # uint16[j, 2]
    dual0_inline: bool = True  # False = aliases the previous chunk's tables
    sig0_inline: bool = True

    @property
    def dual0(self) -> np.ndarray:
        """Dense uint16[n_dual, 4] dual table (host-side dict expand, cached;
        the device path expands the dict form on chip instead)."""
        v = getattr(self, "_dual0", None)
        if v is None:
            v = self.d0_rows[np.minimum(self.d0_idx, len(self.d0_rows) - 1)]
            if len(self.d0_esc_idx):
                v[self.d0_esc_idx.astype(np.int64)] = self.d0_esc_val
            object.__setattr__(self, "_dual0", v)
        return v

    @property
    def coo_slot(self) -> np.ndarray:
        """Dense uint16[n_coo] COO slots (host-side unpack, cached)."""
        v = getattr(self, "_coo_slot", None)
        if v is None:
            v = _np_unpack(self.cs_words, np.arange(self.n_coo), self.wcs
                           ).astype(np.uint16)
            object.__setattr__(self, "_coo_slot", v)
        return v

    @property
    def packed(self) -> np.ndarray:
        """Dense uint16[n] bit<<15 | kind<<13 | slot (host-side unpack of the
        nibble + rank planes, cached) — the pre-v4 wire word, for host-side
        consumers."""
        v = getattr(self, "_packed", None)
        if v is not None:
            return v
        i = np.arange(self.n, dtype=np.int64)
        hdr = _np_unpack(self.hdr_words, i, 4).astype(np.int64)
        bit = hdr >> 3
        kind = (hdr >> 1) & 3
        cls = hdr & 1
        live = kind != 3
        a_sel = live & (cls == 0)
        b_sel = live & (cls == 1)
        pos_a = np.cumsum(a_sel) - a_sel
        pos_b = np.cumsum(b_sel) - b_sel
        rank = np.where(
            cls == 1, _np_unpack(self.b_words, pos_b, self.wb).astype(np.int64),
            _np_unpack(self.a_words, pos_a, self.wa).astype(np.int64))
        cs = self.coo_slot.astype(np.int64)
        cnts = self.coo_cnt.astype(np.int64)
        starts = np.cumsum(cnts) - cnts
        sub = i // self.batch
        if len(cs):
            sidx = np.clip(starts[sub] + rank, 0, len(cs) - 1)
            slot = np.where(live, cs[sidx], self.ud - 1)
        else:
            slot = np.full(self.n, self.ud - 1, np.int64)
        v = ((bit << 15) | (kind << 13) | slot).astype(np.uint16)
        object.__setattr__(self, "_packed", v)
        return v


@dataclass
class Analysis:
    chunks: list[ChunkAnalysis] | list[SlimChunk]
    lanes: int
    batch: int
    n_dual: int
    n_sig: int
    fast_w: int
    slow_w: int
    sig_w: int
    sig_alpha: int
    profile: int = 0
    sup: int = 16
    slim: bool = False


def analyze(data: bytes, lanes: int = 16, chunk_mode: int = 0, batch_size: int = 1,
            model_profile: int = 0, sup: int = 0, slim: bool | None = None,
            want_probs: bool = True) -> Analysis:
    """Runs the host syntax walk and exports the device model-pass inputs.

    slim (default: model_profile == 2) selects the ~3-bytes/bin ANL2 wire
    format (frozen-batch semantics); want_probs additionally exports the
    host-computed probabilities for differential testing."""
    from .ops import model_pass as mp
    if sup <= 0:
        sup = mp.default_sup()
    if slim is None:
        slim = model_profile == 2
    lib = _session_lib()
    h = lib.artc_session_open(data, len(data), lanes, chunk_mode, batch_size, model_profile)
    if not h:
        raise host.NativeError(lib.artc_last_error().decode())
    try:
        flags = (1 if slim else 0) | (2 if (slim and want_probs) else 0)
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_size_t()
        rc = lib.artc_session_analyze2(h, sup, flags, ctypes.byref(out),
                                       ctypes.byref(out_len))
        if rc != 0:
            raise host.NativeError(lib.artc_last_error().decode())
        try:
            raw = ctypes.string_at(out, out_len.value)
        finally:
            lib.artc_free(out)
    finally:
        lib.artc_session_close(h)
    return _parse_analysis(raw)


_HDR_BYTES = 48  # magic + 11 u32 header fields


def _parse_header(raw: bytes) -> tuple[Analysis, int]:
    """Parses the shared analysis header (recode.cc write_analyze_header) into
    an empty Analysis + the chunk count."""
    hdr = np.frombuffer(raw[:_HDR_BYTES], dtype=np.uint32)
    magic = int(hdr[0])
    assert magic in (0x5A4C4E41, 0x354C4E41), hex(magic)  # 'ANLZ' | 'ANL5'
    slim = magic == 0x354C4E41
    (n_chunks, lanes_out, batch, profile, n_dual, n_sig, fast_w, slow_w,
     sig_w, sig_alpha, sup_out) = (int(x) for x in hdr[1:12])
    an = Analysis([], lanes_out, batch, n_dual, n_sig, fast_w, slow_w,
                  sig_w, sig_alpha, profile, sup_out, slim=slim)
    return an, n_chunks


def _parse_analysis(raw: bytes) -> Analysis:
    buf = np.frombuffer(raw, dtype=np.uint8)
    an, n_chunks = _parse_header(raw)
    pos = _HDR_BYTES

    def u32():
        nonlocal pos
        v = int(buf[pos:pos + 4].view(np.uint32)[0])
        pos += 4
        return v

    def u64():
        nonlocal pos
        v = int(buf[pos:pos + 8].view(np.uint64)[0])
        pos += 8
        return v

    def arr(dtype, count):
        nonlocal pos
        nbytes = np.dtype(dtype).itemsize * count
        v = buf[pos:pos + nbytes].view(dtype).copy()
        pos += nbytes
        return v

    n_dual = an.n_dual
    sup_out = an.sup
    chunks = an.chunks
    if an.slim:
        prev = None
        while pos < len(buf) and len(chunks) < n_chunks:
            c = _parse_slim_chunk(buf[pos:], an, prev)
            pos += c._raw_len
            chunks.append(c)
            prev = c
        assert len(chunks) == n_chunks
        return an
    for _ in range(n_chunks):
        n = u64()
        bit = arr(np.uint8, n)
        kind = arr(np.uint8, n)
        key = arr(np.uint32, n)
        prior = arr(np.uint16, n)
        pre_ones = arr(np.uint16, n)
        pre_tot = arr(np.uint16, n)
        probs = arr(np.uint16, n)
        dual0 = arr(np.uint16, 4 * n_dual).astype(np.int32).reshape(n_dual, 4)
        n_sig_nz = u32()
        sig0_idx = arr(np.uint32, n_sig_nz)
        sig0_pos = arr(np.uint16, n_sig_nz)
        sig0_neg = arr(np.uint16, n_sig_nz)
        ns = u32()
        ud = u32()
        us = u32()
        m = u64()
        bin_u = arr(np.uint32, m)
        dk_d = arr(np.uint32, ns * ud).astype(np.int32).reshape(ns, ud)
        dk_s = arr(np.uint32, ns * us).astype(np.int32).reshape(ns, us)
        dd = arr(np.uint16, ns * sup_out * ud * 2).astype(np.int32).reshape(ns, sup_out, ud, 2)
        ds = arr(np.uint16, ns * sup_out * us * 2).astype(np.int32).reshape(ns, sup_out, us, 2)
        chunks.append(ChunkAnalysis(bit, kind, key, prior, pre_ones, pre_tot, probs, dual0,
                                    int(m), bin_u, dk_d, dk_s, dd, ds,
                                    sig0_idx=sig0_idx,
                                    sig0_val=np.stack([sig0_pos, sig0_neg],
                                                      axis=1).astype(np.int32)))
    return an


def _parse_slim_chunk(buf: np.ndarray, an: Analysis, prev: SlimChunk | None) -> SlimChunk:
    """Parses one ANL5 chunk (recode.cc write_slim_chunk layout). `prev` is
    the previously parsed chunk — warm chunks >= 2 alias its dual0/sig0
    instead of carrying their own (flags bits 1/2)."""
    pos = 0

    def u8():
        nonlocal pos
        v = int(buf[pos])
        pos += 1
        return v

    def u16():
        nonlocal pos
        v = int(buf[pos:pos + 2].view(np.uint16)[0])
        pos += 2
        return v

    def u32():
        nonlocal pos
        v = int(buf[pos:pos + 4].view(np.uint32)[0])
        pos += 4
        return v

    def u64():
        nonlocal pos
        v = int(buf[pos:pos + 8].view(np.uint64)[0])
        pos += 8
        return v

    def arr(dtype, count):
        nonlocal pos
        nbytes = np.dtype(dtype).itemsize * count
        v = buf[pos:pos + nbytes].view(dtype).copy()
        pos += nbytes
        return v

    n = u64()
    ns = u32()
    ud = u32()
    us = u32()
    m = u64()
    flags = u8()
    ndict = u16()
    pdict = arr(np.uint16, ndict)
    n_esc = u32()
    esc_idx = arr(np.uint32, n_esc)
    esc_val = arr(np.uint16, n_esc)
    wa = u8()
    wb = u8()
    wcs = u8()
    nw_hdr = u64()
    hdr_words = arr(np.uint32, nw_hdr)
    nA = u64()
    nwA = u64()
    a_words = arr(np.uint32, nwA)
    nB = u64()
    nwB = u64()
    b_words = arr(np.uint32, nwB)
    prior_idx = arr(np.uint8, n)
    dk_d = arr(np.uint32, ns * ud).reshape(ns, ud)
    dk_s = arr(np.uint32, ns * us).reshape(ns, us)
    dual0_inline = not (flags & 2)
    if dual0_inline:
        nd = u16()
        d0_rows = arr(np.uint16, 4 * nd).reshape(nd, 4)
        d0_idx = arr(np.uint8, an.n_dual)
        ndesc = u32()
        d0_esc_idx = arr(np.uint32, ndesc)
        d0_esc_val = arr(np.uint16, 4 * ndesc).reshape(ndesc, 4)
    else:
        assert prev is not None, "shared dual0 with no previous chunk"
        d0_rows, d0_idx = prev.d0_rows, prev.d0_idx
        d0_esc_idx, d0_esc_val = prev.d0_esc_idx, prev.d0_esc_val
    sig0_inline = not (flags & 4)
    if sig0_inline:
        n_sig_nz = u32()
        sig0_idx = arr(np.uint32, n_sig_nz)
        sig0_pos = arr(np.uint16, n_sig_nz)
        sig0_neg = arr(np.uint16, n_sig_nz)
        sig0_val = np.stack([sig0_pos, sig0_neg], axis=1)
    else:
        assert prev is not None, "shared sig0 with no previous chunk"
        sig0_idx, sig0_val = prev.sig0_idx, prev.sig0_val
    n_coo = u64()
    coo_cnt = arr(np.uint16, ns * an.sup)
    nw_cs = u64()
    cs_words = arr(np.uint32, nw_cs)
    coo_nib = arr(np.uint8, n_coo)
    n_cesc = u32()
    cesc_idx = arr(np.uint32, n_cesc)
    cesc_ones = arr(np.uint16, n_cesc)
    cesc_tot = arr(np.uint16, n_cesc)
    probs = arr(np.uint16, n) if flags & 1 else None
    c = SlimChunk(int(n), ns, ud, us, int(m), an.batch, pdict, esc_idx, esc_val,
                  wa, wb, wcs, hdr_words, a_words, b_words, int(nA), int(nB),
                  prior_idx, dk_d, dk_s, d0_rows, d0_idx, d0_esc_idx, d0_esc_val,
                  coo_cnt, int(n_coo), cs_words, coo_nib, probs,
                  sig0_idx=sig0_idx, sig0_val=sig0_val,
                  cesc_idx=cesc_idx,
                  cesc_val=np.stack([cesc_ones, cesc_tot], axis=1),
                  dual0_inline=dual0_inline, sig0_inline=sig0_inline)
    object.__setattr__(c, "_raw_len", pos)
    return c


def _bucket_pow2(x: int, lo: int = 16) -> int:
    b = lo
    while b < x:
        b *= 2
    return b


def _bucket_lin(x: int, step: int = 1 << 18) -> int:
    """Linear bucketing for big variable-size wire arrays: pow2 overshoots by
    up to 2x (real transfer bytes); 256Ki steps keep the program-variant count
    small while capping padding waste."""
    if x <= 1 << 18:
        return _bucket_pow2(x)
    return -(-x // step) * step


def _sig0_dense(chunk, n_sig: int) -> np.ndarray | None:
    """Dense sig start state from the chunk's sparse v16 warm rows (None =
    cold zeros)."""
    if chunk.sig0_idx is None or len(chunk.sig0_idx) == 0:
        return None
    s = np.zeros((n_sig, 2), np.int32)
    s[chunk.sig0_idx.astype(np.int64)] = chunk.sig0_val.astype(np.int32)
    return s


def _sig0_sparse_padded(chunk, n_sig: int):
    """(idx, val) padded to a power-of-two length for the v3 wire (pad rows
    target n_sig = dropped by the device scatter); (None, None) = cold."""
    if chunk.sig0_idx is None or len(chunk.sig0_idx) == 0:
        return None, None
    k = _bucket_pow2(len(chunk.sig0_idx))
    idx = np.full(k, n_sig, np.uint32)
    idx[:len(chunk.sig0_idx)] = chunk.sig0_idx
    val = np.zeros((k, 2), np.uint16)
    val[:len(chunk.sig0_idx)] = chunk.sig0_val
    return idx, val


def _wlen(a) -> int:
    """Bucketed u32 word length for a bit-packed stream segment."""
    return _bucket_lin(max(len(a), 2), step=1 << 16)


def _chunk_layout(c: SlimChunk) -> tuple:
    """This chunk's own bucketed blob layout (Lh, La, Lb, Lc, npi, ne, nc,
    ncc) — see ops/model_pass._blob_layout_words. The mesh path takes the
    elementwise max over chunks instead (every entry class is closed under
    max: word lengths stay word lengths, pow2s stay pow2s, npi stays a
    multiple of 4)."""
    n_cesc = len(c.cesc_idx) if c.cesc_idx is not None else 0
    return (_wlen(c.hdr_words), _wlen(c.a_words), _wlen(c.b_words),
            _wlen(c.cs_words), _bucket_lin(max(c.n, 1)),
            _bucket_pow2(max(len(c.esc_idx), 1)), _bucket_lin(max(c.n_coo, 1)),
            _bucket_pow2(max(n_cesc, 1)))


def _build_blob4(an: Analysis, c: SlimChunk, layout: tuple,
                 dk_d: np.ndarray | None = None,
                 dk_s: np.ndarray | None = None,
                 ud_mesh: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Packs one slim chunk's ANL5 planes into the fused u32 blob + scalar
    vector (see ops/model_pass.wire_expand4_blob for the layout contract).
    `layout` may be wider than the chunk's own buckets (mesh uniformization).
    dk_d/dk_s override the chunk's key tables (the mesh pads them to uniform
    shapes with scratch rows); ud_mesh switches to the 6-entry mesh scalar
    vector carrying the chunk's real dual width."""
    from .ops import model_pass as mp
    n = c.n
    npi, ne, nc, ncc = layout[4:]
    if dk_d is None:
        dk_d, dk_s = c.dk_d, c.dk_s
    ns_l, ud_l = dk_d.shape
    us_l = dk_s.shape[1]
    nsub_l = ns_l * an.sup
    offs = mp._blob_layout_words(layout, nsub_l, ns_l, ud_l, us_l)
    blob = np.zeros(offs[-1], np.uint32)

    def put32(k, a):
        blob[offs[k]:offs[k] + len(a)] = a

    def view(k, dtype):
        return blob[offs[k]:offs[k + 1]].view(dtype)

    put32(0, c.hdr_words)
    put32(1, c.a_words)
    put32(2, c.b_words)
    put32(3, c.cs_words)
    view(4, np.uint8)[:n] = c.prior_idx
    pd = view(5, np.uint16)
    pd[:] = 1  # unused dict rows stay neutral
    pd[:len(c.pdict)] = c.pdict
    ei = view(6, np.uint32)
    ei[:] = npi  # pad entries drop in the scatter
    ei[:len(c.esc_idx)] = c.esc_idx
    view(7, np.uint16)[:len(c.esc_val)] = c.esc_val
    view(8, np.uint16)[:len(c.coo_cnt)] = c.coo_cnt
    view(9, np.uint8)[:c.n_coo] = c.coo_nib
    ci = view(10, np.uint32)
    ci[:] = nc  # pad rows drop
    n_cesc = len(c.cesc_idx) if c.cesc_idx is not None else 0
    if n_cesc:
        ci[:n_cesc] = c.cesc_idx
        view(11, np.uint16).reshape(ncc, 2)[:n_cesc] = c.cesc_val
    put32(12, np.ascontiguousarray(dk_d, dtype=np.uint32).reshape(-1))
    put32(13, np.ascontiguousarray(dk_s, dtype=np.uint32).reshape(-1))
    if ud_mesh is not None:
        sc = np.array([c.wa, c.wb, c.wcs, n, c.n_coo, c.ud], np.int32)
    else:
        sc = np.array([c.wa, c.wb, c.wcs, n, c.n_coo], np.int32)
    return blob, sc


@dataclass
class StagedChunk:
    """Device-resident inputs for one slim chunk's v4 pass (the output of
    _stage_v4): one fused blob + one scalar vector + the (cached) shared
    tables, plus the static shape parameters the jitted programs key on."""
    blob: object          # device uint32[total_words]
    sc: object            # device int32[5] = [wa, wb, wcs, n, n_coo]
    dual0: object         # device uint16[n_dual, 4]
    s_idx: object | None  # device uint32[k] (v16 warm sig rows) or None
    s_val: object | None
    n: int
    m: int
    layout: tuple         # (Lh, La, Lb, Lc, npi, ne, nc, ncc)
    statics: dict         # static kwargs for wire_expand4_blob/model_pass_v4
    wire_nbytes: int      # bytes actually uploaded for this chunk (blob + sc
    #                       + any cache-missed shared tables)


def _stage_v4(an: Analysis, c: SlimChunk, cache: dict | None = None) -> StagedChunk:
    """Packs one slim chunk's bit-packed ANL5 planes into ONE fused u32 blob
    and uploads it (plus a 5-scalar vector): one host->device transfer per
    chunk instead of ~15 separate `jnp.asarray` uploads.
    Segment order/padding must mirror ops/model_pass._blob_layout_words.

    The per-bin transfer is the 4-bit header nibble + the wa/wb-bit rank +
    the u8 prior index (~1.7 B/bin) instead of the dense u16 packed word
    (+1 B prior, ~3 B/bin); everything dense is reconstructed on the device
    (cumsum re-indexing, dict gathers — see ops/model_pass.wire_expand4_blob).

    `cache` (id(array) -> device array) dedupes uploads of tables aliased
    across chunks: warm chunks >= 2 share chunk 1's dual0/sig0, and re-sending
    ~1.4 MB of dual0 per chunk would forfeit the aliasing the wire format
    already does."""
    ensure_compile_cache()
    import jax.numpy as jnp
    from .ops import model_pass as mp
    ns, ud, us, m, n = c.ns, c.ud, c.us, c.m, c.n
    assert m < 1 << 24, m  # _div_floor2 exactness bound (wire unpack divides)
    nsub = ns * an.sup
    wire_nbytes = 0

    def dev(a, owner=None, tag=""):
        """Uploads `a` once per identity of `owner` (default: `a` itself).
        The cache entry HOLDS the owner array: that pins its id() for the
        cache's lifetime, so a freed chunk's id being recycled by a later
        chunk's table can never alias a stale device array (the `is` check
        double-guards)."""
        nonlocal wire_nbytes
        if cache is None:
            wire_nbytes += a.nbytes
            return jnp.asarray(a)
        owner = a if owner is None else owner
        k = (tag, id(owner))
        ent = cache.get(k)
        if ent is not None and ent[0] is owner:
            return ent[1]
        v = jnp.asarray(a)
        cache[k] = (owner, v)
        wire_nbytes += a.nbytes
        return v

    layout = _chunk_layout(c)
    blob, sc = _build_blob4(an, c, layout)

    s_idx, s_val = _sig0_sparse_padded(c, an.n_sig)
    if s_idx is not None:
        s_idx = dev(s_idx, owner=c.sig0_idx, tag="sig0i")
        s_val = dev(s_val, owner=c.sig0_idx, tag="sig0v")

    def dual0_dev():
        """Ships the ANL5 dual0 row-dict (~0.2 MB) and expands it on device;
        the expanded table is cached per distinct source table (chunks >= 2
        alias chunk 1's)."""
        nonlocal wire_nbytes
        owner = c.d0_idx
        if cache is not None:
            ent = cache.get(("dual0x", id(owner)))
            if ent is not None and ent[0] is owner:
                return ent[1]
        ned = _bucket_pow2(max(len(c.d0_esc_idx), 1))
        ei = np.full(ned, len(c.d0_idx), np.uint32)  # pad rows drop
        ei[:len(c.d0_esc_idx)] = c.d0_esc_idx
        ev = np.zeros((ned, 4), np.uint16)
        ev[:len(c.d0_esc_idx)] = c.d0_esc_val
        rows = np.zeros((256, 4), np.uint16)
        rows[:len(c.d0_rows)] = c.d0_rows
        v = mp.dual0_expand(jnp.asarray(rows), jnp.asarray(c.d0_idx),
                            jnp.asarray(ei), jnp.asarray(ev))
        wire_nbytes += rows.nbytes + c.d0_idx.nbytes + ei.nbytes + ev.nbytes
        if cache is not None:
            cache[("dual0x", id(owner))] = (owner, v)
        return v

    dual0 = dual0_dev()
    blob_dev = jnp.asarray(blob)
    sc_dev = jnp.asarray(sc)
    wire_nbytes += blob.nbytes + sc.nbytes
    statics = dict(
        expand=dict(m=int(m), nsub=int(nsub), U=int(ud + us), ud=int(ud),
                    us=int(us), ns=int(ns), batch=int(an.batch), layout=layout),
        model=dict(batch=int(an.batch), sup=int(an.sup), fast_w=int(an.fast_w),
                   slow_w=int(an.slow_w), sig_w=int(an.sig_w),
                   sig_alpha=int(an.sig_alpha), ud=int(ud), us=int(us),
                   n_sig=int(an.n_sig)))
    return StagedChunk(blob_dev, sc_dev, dual0, s_idx, s_val, int(n), int(m),
                       layout, statics, wire_nbytes)


def _exec_v4(st: StagedChunk):
    """Runs the jitted expand + frozen-batch pass over a staged chunk.
    Returns device-resident (probs uint16[m], bits int32[m])."""
    from .ops import model_pass as mp
    bit, kind, slot, prior, deltas, dk_d, dk_s = mp.wire_expand4_blob(
        st.blob, st.sc, **st.statics["expand"])
    return mp.model_pass_v4(bit, kind, slot, prior, dk_d, dk_s, deltas,
                            st.dual0, sig0_idx=st.s_idx, sig0_val=st.s_val,
                            **st.statics["model"])


def _run_v4(an: Analysis, c: SlimChunk, cache: dict | None = None):
    """Stage + run one slim chunk; returns (probs uint16[m], bits int32[m])."""
    return _exec_v4(_stage_v4(an, c, cache))


def device_probs(an: Analysis, chunk, impl: str | None = None) -> np.ndarray:
    """Runs the JAX model pass for one chunk; returns uint16 probs."""
    ensure_compile_cache()
    from .ops import model_pass as mp
    if an.slim:
        probs, _ = _run_v4(an, chunk)
        return np.asarray(probs)[:chunk.n]
    impl = impl or mp.default_impl()
    sig0 = _sig0_dense(chunk, an.n_sig)
    if impl == "v2":
        if chunk.v2_bin_u is not None:
            return mp.run_chunk_v2_tables(
                chunk.kind, chunk.prior, chunk.pre_ones, chunk.pre_tot, chunk.v2_m,
                chunk.v2_bin_u, chunk.v2_dk_d, chunk.v2_dk_s, chunk.v2_dd, chunk.v2_ds,
                chunk.dual0, an.batch, an.sup, an.fast_w, an.slow_w, an.sig_w,
                an.sig_alpha, an.n_sig, sig0=sig0)
        return mp.run_chunk_v2(chunk.bit, chunk.kind, chunk.key, chunk.prior,
                               chunk.pre_ones, chunk.pre_tot, chunk.dual0, an.batch,
                               mp.default_sup(), an.fast_w, an.slow_w, an.sig_w,
                               an.sig_alpha, an.n_sig, sig0=sig0)
    return mp.run_chunk(chunk.bit, chunk.kind, chunk.key, chunk.prior, chunk.dual0,
                        an.batch, an.fast_w, an.slow_w, an.sig_w, an.sig_alpha, an.n_sig,
                        impl=impl, sig0=sig0)


def pick_lanes(n_pairs: int) -> int:
    """Adaptive lane count: wide enough to keep the sequential lane scan
    short, lean enough that per-lane flush overhead (~6 B) stays well under
    0.1% of payload."""
    k = 16
    while k < 128 and n_pairs // k > 32768:
        k *= 2
    return k


def device_blob(an: Analysis, chunk, probs: np.ndarray | None = None,
                force_lanes: int | None = None) -> bytes:
    """Encodes one chunk's rANS blob on device; byte-identical to the C++
    RansInterleaved format (the blob self-describes its lane count).

    Slim chunks stay fully device-resident: the model pass's (probs, bits)
    feed the lane scan without any per-bin re-upload, and the lane output is
    compacted on device before download."""
    from .ops import lanes as lx
    if an.slim:
        probs_dev, bits_dev = _run_v4(an, chunk)
        return lx.encode_interleaved_dev(bits_dev, probs_dev, chunk.n,
                                         force_lanes or pick_lanes(chunk.n))
    if probs is None:
        probs = device_probs(an, chunk)
    return lx.encode_interleaved(chunk.bit, probs,
                                 force_lanes or pick_lanes(len(chunk.bit)))


def _session_lib():
    lib = host.lib()
    if not hasattr(lib, "_session_ready"):
        lib.artc_session_open.restype = ctypes.c_void_p
        lib.artc_session_open.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
            ctypes.c_int,
        ]
        lib.artc_session_analyze2.restype = ctypes.c_int
        lib.artc_session_analyze2.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.artc_session_analyze_begin.restype = ctypes.c_int
        lib.artc_session_analyze_begin.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ]
        lib.artc_session_analyze_header.restype = ctypes.c_int
        lib.artc_session_analyze_header.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.artc_session_analyze_chunk.restype = ctypes.c_int
        lib.artc_session_analyze_chunk.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.artc_session_pack.restype = ctypes.c_int
        lib.artc_session_pack.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(host.ArtcStatsC),
        ]
        lib.artc_session_close.restype = None
        lib.artc_session_close.argtypes = [ctypes.c_void_p]
        lib._session_ready = True
    return lib


def compress(data: bytes, lanes: int = 16, chunk_mode: int = 0,
             batch_size: int = 4096, model_profile: int = 2,
             force_lanes: int | None = None,
             info: dict | None = None) -> tuple[bytes, host.Stats]:
    """Full device-path compression (model + entropy on the JAX device). One
    native session shares pass1/nz-mode state between analysis and packing.

    Default model_profile=2 (frozen batches): measured +0.10pp ratio on
    bench.mp4 vs profile 0, in exchange for a ~20x smaller host->device
    transfer (the bit-packed ANL5 export).

    The slim path is fully pipelined (the reference pays its stages serially
    — its single fused pass recode.cpp:1102-1309 has nothing to overlap):
    artc_session_analyze_begin spawns host workers that walk + export chunks
    concurrently; the loop below fetches chunk i as soon as its export is
    ready, dispatches its fused-blob upload + model pass + lane scan
    asynchronously, then kicks chunk i-1's lane compaction (one tiny counts
    readback) — so the host walk, the host->device transfer, and the device
    compute of different chunks run at the same time and the bulk blob
    downloads at the end find everything already compacted.

    `info`, if given, is filled with measurement ground truth: wire_bytes
    (actual host->device upload bytes incl. cached shared tables) and
    per-phase wall times."""
    import time
    from .ops import model_pass as mp
    ensure_compile_cache()
    lib = _session_lib()
    h = lib.artc_session_open(data, len(data), lanes, chunk_mode, batch_size, model_profile)
    if not h:
        raise host.NativeError(lib.artc_last_error().decode())
    try:
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_size_t()
        if model_profile == 2:
            from .ops import lanes as lx
            timing = os.environ.get("ARTC_TIMING", "") not in ("", "0")
            n_chunks = lib.artc_session_analyze_begin(h, mp.default_sup(), 0)
            if n_chunks < 0:
                raise host.NativeError(lib.artc_last_error().decode())
            rc = lib.artc_session_analyze_header(h, ctypes.byref(out),
                                                 ctypes.byref(out_len))
            if rc != 0:
                raise host.NativeError(lib.artc_last_error().decode())
            try:
                an, _ = _parse_header(ctypes.string_at(out, out_len.value))
            finally:
                lib.artc_free(out)
            cache: dict = {}
            handles: list = []
            compacted: list = []
            prev = None
            wire_bytes = 0
            t_start = time.monotonic()
            for i in range(n_chunks):
                t0 = time.monotonic() if timing else 0.0
                rc = lib.artc_session_analyze_chunk(h, i, ctypes.byref(out),
                                                    ctypes.byref(out_len))
                if rc != 0:
                    raise host.NativeError(lib.artc_last_error().decode())
                try:
                    raw = ctypes.string_at(out, out_len.value)
                finally:
                    lib.artc_free(out)
                c = _parse_slim_chunk(np.frombuffer(raw, np.uint8), an, prev)
                prev = c
                st = _stage_v4(an, c, cache=cache)
                wire_bytes += st.wire_nbytes
                probs, bits = _exec_v4(st)
                handles.append(lx.encode_interleaved_start(
                    bits, probs, c.n, force_lanes or pick_lanes(c.n)))
                if timing:
                    print(f"[artc] device chunk {i}: fetch+dispatch "
                          f"{time.monotonic() - t0:.3f}s "
                          f"({st.wire_nbytes >> 20} MiB wire)", flush=True)
                if i > 0:
                    t0 = time.monotonic() if timing else 0.0
                    compacted.append(lx.encode_interleaved_compact(handles[i - 1]))
                    if timing:
                        print(f"[artc] device chunk {i - 1}: compact "
                              f"{time.monotonic() - t0:.3f}s", flush=True)
            if handles:
                compacted.append(lx.encode_interleaved_compact(handles[-1]))
            t_emit = time.monotonic()
            blobs = []
            for i, ch in enumerate(compacted):
                t0 = time.monotonic() if timing else 0.0
                blobs.append(lx.encode_interleaved_emit(ch))
                if timing:
                    print(f"[artc] device chunk {i}: emit "
                          f"{time.monotonic() - t0:.3f}s", flush=True)
            if timing:
                print(f"[artc] device wire total {wire_bytes / 1e6:.1f} MB",
                      flush=True)
            if info is not None:
                info["wire_bytes"] = wire_bytes
                info["n_chunks"] = n_chunks
                info["dispatch_s"] = t_emit - t_start
                info["emit_s"] = time.monotonic() - t_emit
        else:
            rc = lib.artc_session_analyze2(h, mp.default_sup(), 0,
                                           ctypes.byref(out), ctypes.byref(out_len))
            if rc != 0:
                raise host.NativeError(lib.artc_last_error().decode())
            try:
                raw = ctypes.string_at(out, out_len.value)
            finally:
                lib.artc_free(out)
            an = _parse_analysis(raw)
            blobs = [device_blob(an, c, force_lanes=force_lanes) for c in an.chunks]
        return _pack_session(lib, h, blobs)
    finally:
        lib.artc_session_close(h)


def _pack_session(lib, h, blobs: list[bytes]) -> tuple[bytes, host.Stats]:
    blob_cat = b"".join(blobs)
    lens = (ctypes.c_uint64 * len(blobs))(*[len(b) for b in blobs])
    pout = ctypes.POINTER(ctypes.c_uint8)()
    pout_len = ctypes.c_size_t()
    st = host.ArtcStatsC()
    rc = lib.artc_session_pack(h, blob_cat, lens, len(blobs),
                               ctypes.byref(pout), ctypes.byref(pout_len),
                               ctypes.byref(st))
    if rc != 0:
        raise host.NativeError(lib.artc_last_error().decode())
    try:
        result = ctypes.string_at(pout, pout_len.value)
    finally:
        lib.artc_free(pout)
    return result, host.Stats.from_c(st)


def compress_mesh(data: bytes, mesh, lanes: int = 16, chunk_mode: int = 1,
                  batch_size: int = 4096, sup: int = 0,
                  force_lanes: int | None = None) -> tuple[bytes, host.Stats]:
    """Mesh-sharded device compression of a REAL clip into a REAL container.

    The host walk exports slim chunks (GOP chunks under chunk_mode=1,
    picture-boundary sections under 0), streamed through the analyze_begin/
    analyze_chunk ABI so the walk workers overlap the fetch loop; every chunk
    is packed into a fused ANL5 blob with a MESH-UNIFORM layout (the same
    ~1.7 B/bin wire the single-chip path ships — expansion happens on each
    device inside the step) and the whole set runs as ONE jitted shard_map
    step over the (gop, lane) mesh — on-chip wire expand + frozen-batch model
    scan per chunk on the gop axis, rANS lane scan on the lane axis, stats
    psum'd over both. The gathered lane outputs reassemble into
    byte-identical RansInterleaved blobs and the session packs the same ATRC
    container the single-device path emits; the host serial decoder reads it
    back bit-exactly.
    (SURVEY.md §2.9 GOP-parallel sharding; the reference has no multi-device
    story at all.)"""
    import jax.numpy as jnp
    from .ops import lanes as lx
    from .ops import model_pass as mp
    from .parallel.pipeline import sharded_v4_compress_step
    ensure_compile_cache()
    if sup <= 0:
        sup = mp.default_sup()
    lib = _session_lib()
    h = lib.artc_session_open(data, len(data), lanes, chunk_mode, batch_size, 2)
    if not h:
        raise host.NativeError(lib.artc_last_error().decode())
    try:
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_size_t()
        n_chunks = lib.artc_session_analyze_begin(h, sup, 0)
        if n_chunks < 0:
            raise host.NativeError(lib.artc_last_error().decode())
        rc = lib.artc_session_analyze_header(h, ctypes.byref(out),
                                             ctypes.byref(out_len))
        if rc != 0:
            raise host.NativeError(lib.artc_last_error().decode())
        try:
            an, _ = _parse_header(ctypes.string_at(out, out_len.value))
        finally:
            lib.artc_free(out)
        chunks: list[SlimChunk] = []
        prev = None
        for i in range(n_chunks):
            rc = lib.artc_session_analyze_chunk(h, i, ctypes.byref(out),
                                                ctypes.byref(out_len))
            if rc != 0:
                raise host.NativeError(lib.artc_last_error().decode())
            try:
                raw = ctypes.string_at(out, out_len.value)
            finally:
                lib.artc_free(out)
            prev = _parse_slim_chunk(np.frombuffer(raw, np.uint8), an, prev)
            chunks.append(prev)
        G = len(chunks)
        n_gop = mesh.shape["gop"]
        G_pad = -(-G // n_gop) * n_gop
        UD = max(c.ud for c in chunks)
        US = max(c.us for c in chunks)
        NS = max(c.ns for c in chunks)
        M = NS * sup * an.batch
        assert M < 1 << 24, M  # _div_floor2 exactness bound (wire unpack)
        K = force_lanes or pick_lanes(max(c.n for c in chunks))
        n_dual_ext = an.n_dual + 1
        # Mesh-uniform blob layout: elementwise max over chunks (closed under
        # max per entry class — see _chunk_layout).
        layout = tuple(max(col) for col in zip(*(_chunk_layout(c) for c in chunks)))

        # Default dict rows = per-column scratch keys (distinct within a row;
        # live rows overwrite below, and a chunk's own pad keys occupy
        # [n_dual_ext, n_dual_ext + ud) so the column-based fill can't collide).
        dk_d0 = n_dual_ext + np.arange(UD, dtype=np.uint32)
        dk_s0 = an.n_sig + np.arange(US, dtype=np.uint32)
        W = mp._blob_layout_words(layout, NS * sup, NS, UD, US)[-1]
        blob = np.zeros((G_pad, W), np.uint32)
        sc = np.zeros((G_pad, 6), np.int32)
        sc[:, 5] = UD  # pad chunks: no slot shift
        dual0 = np.ones((G_pad, an.n_dual, 4), np.uint16)
        n_arr = np.zeros((G_pad,), np.int32)
        SK = _bucket_pow2(max(max((len(c.sig0_idx) if c.sig0_idx is not None else 0)
                                  for c in chunks), 1))
        sig0_idx = np.full((G_pad, SK), an.n_sig, np.uint32)  # pad rows drop
        sig0_val = np.zeros((G_pad, SK, 2), np.uint16)
        # Pad chunks still need live scratch dict keys (v3_core's sorted-unique
        # scatters require distinct rows), so fill every row's dk segments.
        offs = mp._blob_layout_words(layout, NS * sup, NS, UD, US)
        blob[:, offs[12]:offs[13]] = np.broadcast_to(dk_d0, (NS, UD)).reshape(-1)
        blob[:, offs[13]:offs[14]] = np.broadcast_to(dk_s0, (NS, US)).reshape(-1)
        for g, c in enumerate(chunks):
            dk_d = np.broadcast_to(dk_d0, (NS, UD)).copy()
            dk_s = np.broadcast_to(dk_s0, (NS, US)).copy()
            dk_d[:c.ns, :c.ud] = c.dk_d
            dk_s[:c.ns, :c.us] = c.dk_s
            bl, s = _build_blob4(an, c, layout, dk_d=dk_d, dk_s=dk_s, ud_mesh=UD)
            blob[g] = bl
            sc[g] = s
            dual0[g] = c.dual0
            n_arr[g] = c.n
            if c.sig0_idx is not None and len(c.sig0_idx):
                sig0_idx[g, :len(c.sig0_idx)] = c.sig0_idx
                sig0_val[g, :len(c.sig0_idx)] = c.sig0_val

        step = sharded_v4_compress_step(
            mesh, batch=int(an.batch), sup=int(sup), fast_w=int(an.fast_w),
            slow_w=int(an.slow_w), sig_w=int(an.sig_w), sig_alpha=int(an.sig_alpha),
            ud=int(UD), us=int(US), ns=int(NS), n_sig=int(an.n_sig),
            K_total=int(K), layout=layout)
        x_final, words, emits, _, total_words = step(
            *(jnp.asarray(a) for a in (blob, sc, dual0, sig0_idx, sig0_val, n_arr)))
        x_final = np.asarray(x_final)
        words = np.asarray(words)
        emits = np.asarray(emits)
        assert int(total_words) > 0
        blobs = [lx.assemble_blob(x_final[g], words[g], emits[g], chunks[g].n, K)
                 for g in range(G)]
        return _pack_session(lib, h, blobs)
    finally:
        lib.artc_session_close(h)
