"""K-lane interleaved binary rANS encoding on device (JAX).

Byte-identical to the host codec (avrecode_jax/native/rans.h
RansInterleaved::encode). Each lane encodes its strided subsequence in
reverse; because rANS is carry-free and the probabilities are precomputed by
the model pass, all K lanes advance in lockstep as one vectorized
`lax.scan` over time — the structure the reference's carry-propagating serial
range coder cannot offer (reference arithmetic_code.h:147-180; SURVEY.md
§2.1).

The scan emits at most one u16 word per (step, lane); the final per-lane
streams are a mask-compaction done on host (O(output bytes))."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

PROB_BITS = 15
PROB_SCALE = 1 << PROB_BITS
RANS_L = 1 << 16


@functools.partial(jax.jit, static_argnames=())
def _lane_scan(bits_tk, probs_tk, valid_tk):
    """bits/probs/valid: [T, K]. Returns (x_final[K], words[T, K], emit[T, K]).

    Processes t = T-1 .. 0 (reverse scan); emissions stacked at their t index,
    so reading words[t] for ascending t with the emit mask yields the lane
    stream tail in final order (see rans.h stream layout)."""
    K = bits_tk.shape[1]
    x0 = jnp.full((K,), RANS_L, jnp.uint32)

    def step(x, xs):
        bit, p, valid = xs
        p = p.astype(jnp.uint32)
        f = jnp.where(bit == 1, p, PROB_SCALE - p)
        c = jnp.where(bit == 1, PROB_SCALE - p, jnp.zeros_like(p))
        x_max = f << 17
        emit = (x >= x_max) & valid
        word = (x & 0xFFFF).astype(jnp.uint16)
        x1 = jnp.where(emit, x >> 16, x)
        x2 = ((x1 // f) << PROB_BITS) + (x1 % f) + c
        x = jnp.where(valid, x2, x)
        return x, (word, emit)

    x_final, (words, emits) = jax.lax.scan(step, x0, (bits_tk, probs_tk, valid_tk),
                                           reverse=True)
    return x_final, words, emits


def _bucket(t: int) -> int:
    b = 1
    while b < t:
        b *= 2
    return b


@functools.partial(jax.jit, static_argnames=("T", "K"))
def _lane_scan_dev(bits_m, probs_m, n, T: int, K: int):
    """Device-resident variant of _lane_scan: consumes the model pass's
    on-device (bits, probs) directly (no re-upload of per-bin arrays) and
    keeps words/emits on device for _lane_compact. `n` is a dynamic scalar
    so one program serves every chunk length within a (T, K) bucket."""
    size = T * K
    b = bits_m[:size].astype(jnp.uint32).reshape(T, K)
    p = probs_m[:size].astype(jnp.uint32).reshape(T, K)
    valid = (jax.lax.iota(jnp.int32, size) < n).reshape(T, K)
    p = jnp.where(valid, jnp.maximum(p, 1), 1)  # guard padding against div-0
    x0 = jnp.full((K,), RANS_L, jnp.uint32)

    def step(x, xs):
        bit, pp, v = xs
        f = jnp.where(bit == 1, pp, PROB_SCALE - pp)
        c = jnp.where(bit == 1, PROB_SCALE - pp, jnp.zeros_like(pp))
        x_max = f << 17
        emit = (x >= x_max) & v
        word = (x & 0xFFFF).astype(jnp.uint16)
        x1 = jnp.where(emit, x >> 16, x)
        x2 = ((x1 // f) << PROB_BITS) + (x1 % f) + c
        x = jnp.where(v, x2, x)
        return x, (word, emit)

    # unroll=8 amortizes the per-step loop overhead of the sequential scan;
    # not yet re-swept on a GPU.
    x_final, (words, emits) = jax.lax.scan(step, x0, (b, p, valid),
                                           reverse=True, unroll=8)
    counts = jnp.sum(emits.astype(jnp.int32), axis=0)
    return x_final, words, emits, counts


@functools.partial(jax.jit, static_argnames=("maxW",))
def _lane_compact(words, emits, maxW: int):
    """Compacts the sparse emissions on device so the download is ~the
    compressed payload (maxW*K u16) instead of the full [T, K] words+emits
    (~47 MB for a 15M-bin chunk)."""
    T, K = words.shape
    e = emits.astype(jnp.int32)
    pos = jnp.cumsum(e, axis=0) - e
    lane = jax.lax.broadcasted_iota(jnp.int32, (T, K), 1)
    flat = jnp.where(emits, pos * K + lane, maxW * K)
    out = jnp.zeros((maxW * K,), jnp.uint16).at[flat.reshape(-1)].set(
        words.reshape(-1), mode="drop", unique_indices=True)
    return out.reshape(maxW, K)


def assemble_blob(x_final: np.ndarray, words: np.ndarray, emits: np.ndarray,
                  n: int, K: int) -> bytes:
    """Builds the RansInterleaved wire blob from raw scan outputs
    (x_final uint32[K], words uint16[T, K], emits bool[T, K])."""
    out = bytearray()
    out += np.uint32(K).tobytes()
    out += np.uint32(n).tobytes()
    lane_words = []
    for l in range(K):
        tail = words[:, l][emits[:, l]]
        stream = np.concatenate([
            np.array([x_final[l] >> 16, x_final[l] & 0xFFFF], np.uint16),
            tail.astype(np.uint16)])
        lane_words.append(stream)
    for l in range(K):
        out += np.uint32(len(lane_words[l])).tobytes()
    for l in range(K):
        out += lane_words[l].astype("<u2").tobytes()
    return bytes(out)


def encode_interleaved_start(bits_dev, probs_dev, n: int, K: int):
    """Dispatches a chunk's lane scan from device-resident bits/probs and
    returns an opaque handle WITHOUT any blocking readback — the caller can
    keep staging the next chunk (host analyze / uploads) while this one
    computes. encode_interleaved_finish turns the handle into the blob."""
    if n == 0:
        return (None, None, None, None, n, K)
    T = _bucket(-(-n // K))
    size = T * K
    m = bits_dev.shape[0]
    if m < size:
        bits_dev = jnp.pad(bits_dev, (0, size - m))
        probs_dev = jnp.pad(probs_dev, (0, size - m), constant_values=1)
    x_final, words, emits, counts = _lane_scan_dev(bits_dev, probs_dev, n, T=T, K=K)
    return (x_final, words, emits, counts, n, K)


def encode_interleaved_compact(handle):
    """Phase 2 of the staged encode: reads back the per-lane word COUNTS (K
    ints — one tiny sync that completes when the lane scan does), then
    dispatches the on-device compaction asynchronously. Splitting this from
    the bulk tail download lets the compress pipeline kick chunk i's
    compaction while chunk i+1 still computes, so the big downloads in
    encode_interleaved_emit find their data already compacted."""
    x_final, words, emits, counts, n, K = handle
    if n == 0:
        return (None, None, None, n, K)
    counts_h = np.asarray(counts)
    maxW = _bucket(max(int(counts_h.max()), 1))
    tail_dev = _lane_compact(words, emits, maxW)
    return (x_final, tail_dev, counts_h, n, K)


def encode_interleaved_emit(chandle) -> bytes:
    """Phase 3: downloads the compacted tail + final states and assembles the
    RansInterleaved wire blob; byte-identical to encode_interleaved / the host
    codec (rans.h)."""
    x_final, tail_dev, counts_h, n, K = chandle
    if n == 0:
        return encode_interleaved(np.zeros(0, np.uint8), np.zeros(0, np.uint16), K)
    tail = np.asarray(tail_dev)
    x_final = np.asarray(x_final)
    out = bytearray()
    out += np.uint32(K).tobytes()
    out += np.uint32(n).tobytes()
    for l in range(K):
        out += np.uint32(int(counts_h[l]) + 2).tobytes()
    for l in range(K):
        head = np.array([x_final[l] >> 16, x_final[l] & 0xFFFF], np.uint16)
        out += head.astype("<u2").tobytes()
        out += tail[:counts_h[l], l].astype("<u2").tobytes()
    return bytes(out)


def encode_interleaved_finish(handle) -> bytes:
    """Syncs one encode_interleaved_start handle into the RansInterleaved wire
    blob; byte-identical to encode_interleaved / the host codec (rans.h)."""
    return encode_interleaved_emit(encode_interleaved_compact(handle))


def encode_interleaved_dev(bits_dev, probs_dev, n: int, K: int) -> bytes:
    """Full chunk encode from device-resident bits/probs; byte-identical to
    encode_interleaved / the host codec (native/rans.h)."""
    return encode_interleaved_finish(encode_interleaved_start(bits_dev, probs_dev, n, K))


def encode_interleaved(bits: np.ndarray, probs: np.ndarray, K: int) -> bytes:
    """Full chunk encode; returns the wire-format blob (see rans.h)."""
    n = len(bits)
    T = _bucket(-(-n // K)) if n else 0
    pad = T * K - n
    bits_p = np.concatenate([bits.astype(np.uint32), np.zeros(pad, np.uint32)])
    probs_p = np.concatenate([probs.astype(np.uint32), np.ones(pad, np.uint32)])
    valid_p = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    # lane l owns indices l, l+K, ... -> reshape to [T, K]
    bits_tk = bits_p.reshape(T, K) if T else np.zeros((0, K), np.uint32)
    probs_tk = probs_p.reshape(T, K) if T else np.zeros((0, K), np.uint32)
    valid_tk = valid_p.reshape(T, K) if T else np.zeros((0, K), bool)

    if T:
        x_final, words, emits = _lane_scan(jnp.asarray(bits_tk), jnp.asarray(probs_tk),
                                           jnp.asarray(valid_tk))
        x_final = np.asarray(x_final)
        words = np.asarray(words)
        emits = np.asarray(emits)
    else:
        x_final = np.full((K,), RANS_L, np.uint32)
        words = np.zeros((0, K), np.uint16)
        emits = np.zeros((0, K), bool)

    out = bytearray()
    out += np.uint32(K).tobytes()
    out += np.uint32(n).tobytes()
    lane_words = []
    for l in range(K):
        tail = words[:, l][emits[:, l]]
        stream = np.concatenate([
            np.array([x_final[l] >> 16, x_final[l] & 0xFFFF], np.uint16), tail.astype(np.uint16)])
        lane_words.append(stream)
    for l in range(K):
        out += np.uint32(len(lane_words[l])).tobytes()
    for l in range(K):
        out += lane_words[l].astype("<u2").tobytes()
    return bytes(out)
