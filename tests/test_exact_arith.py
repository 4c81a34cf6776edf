"""The float32-reciprocal floor divisions of the device model pass
(ops/model_pass._div_floor, _div_floor2) against exact integer floor
division over their whole stated domains. They run on JAX's default backend,
so the same tests check a GPU when JAX_PLATFORMS names one."""
import numpy as np
from hypothesis import example, given, settings
from hypothesis import strategies as st

N = 64  # one fixed shape, so each jitted division compiles once


def _run(fn, pairs):
    import jax
    num = np.zeros(N, np.int32)
    den = np.ones(N, np.int32)
    for i, (a, b) in enumerate(pairs):
        num[i], den[i] = a, b
    got = np.asarray(jax.jit(fn)(num, den))
    np.testing.assert_array_equal(got, num // den)


@st.composite
def _div_floor_pair(draw):
    """0 <= num < 2^31, 0 < den < 2^16, num // den <= 2^15."""
    den = draw(st.integers(1, (1 << 16) - 1))
    r = draw(st.integers(0, den - 1))
    q = draw(st.integers(0, 1 << 15))
    q = min(q, ((1 << 31) - 1 - r) // den)
    return q * den + r, den


@st.composite
def _div_floor2_pair(draw):
    """0 <= num < 2^24, 0 < den < 2^16."""
    return draw(st.integers(0, (1 << 24) - 1)), draw(st.integers(1, (1 << 16) - 1))


@settings(deadline=None, max_examples=300)
@given(st.lists(_div_floor_pair(), min_size=1, max_size=N))
@example([((1 << 15) * 1, 1), (32767 * 65535 + 65534, 65535), ((1 << 31) - 1, 65535),
          (0, 1), ((1 << 15) * 3 - 1, 3)])
def test_div_floor_exact(pairs):
    from avrecode_jax.ops import model_pass as mp
    _run(mp._div_floor, pairs)


@settings(deadline=None, max_examples=300)
@given(st.lists(_div_floor2_pair(), min_size=1, max_size=N))
@example([((1 << 24) - 1, 1), ((1 << 24) - 1, 3), ((1 << 24) - 1, 5), ((1 << 24) - 2, 6),
          ((1 << 24) - 1, 10), ((1 << 24) - 1, 65535), (0, 7)])
def test_div_floor2_exact(pairs):
    from avrecode_jax.ops import model_pass as mp
    _run(mp._div_floor2, pairs)
