"""Content-defined chunking of the port: the spec and counters (copies of
the JAX package's jax-free ``chunker/spec.py`` and ``chunker/observe.py``)
and the host chunker kinds, copies of its ``chunker/{cpu,native,vector}.py``:
the scalar numpy scan, the C++ rolling scan (``chunker/csrc/``, built by
g++ at first use) and the vectorized scan.  The device scan is K1
(``ops/rolling_hash.py``, ``models/backends.py``'s ``"cuda"`` kind)."""

from .spec import (CHUNK_FORMAT, DEFAULT_PARAMS, TEST_PARAMS, WINDOW,
                   ChunkerParams, buzhash_subtables, buzhash_table,
                   select_cuts)
from .cpu import CpuChunker, chunk_bounds, candidates
from .vector import ResilientVectorFactory, VectorChunker

__all__ = ["CHUNK_FORMAT", "DEFAULT_PARAMS", "TEST_PARAMS", "WINDOW",
           "ChunkerParams", "buzhash_subtables", "buzhash_table",
           "select_cuts", "CpuChunker", "chunk_bounds", "candidates",
           "VectorChunker", "ResilientVectorFactory"]
