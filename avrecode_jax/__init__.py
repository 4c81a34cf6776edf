"""avrecode_jax — lossless H.264 recompression with a JAX device path.

A from-scratch re-architecture of ddkang/avrecode: native C++ host engine
(H.264 entropy layer, CABAC, prior model, rANS lanes, container) plus plain
JAX/XLA device programs for batched model evaluation and lane-parallel
entropy coding, sharded over GOP x lane meshes.
"""
__version__ = "0.1.0"

from . import pipeline  # noqa: F401
