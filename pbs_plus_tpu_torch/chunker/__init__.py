"""Chunking spec and counters of the port (copies of the JAX package's
jax-free ``chunker/spec.py`` and ``chunker/observe.py``)."""

from .spec import (CHUNK_FORMAT, DEFAULT_PARAMS, TEST_PARAMS, WINDOW,
                   ChunkerParams, buzhash_subtables, buzhash_table,
                   select_cuts)

__all__ = ["CHUNK_FORMAT", "DEFAULT_PARAMS", "TEST_PARAMS", "WINDOW",
           "ChunkerParams", "buzhash_subtables", "buzhash_table",
           "select_cuts"]
