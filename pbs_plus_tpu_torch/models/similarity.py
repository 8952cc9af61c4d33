"""SimilarityModel: cross-snapshot near-duplicate detection on the card.

Counterpart of the JAX package's ``models/similarity.py``: minhash and
simhash over historical chunk digests, for picking the best previous
snapshot for reference dedup, flagging snapshot pairs that should share
chunks but do not (chunker drift), and grouping similar snapshots.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.similarity import (minhash_signature, minhash_similarity,
                              pairwise_hamming, simhash_sketch)
from ..utils.device import resolve


class SimilarityModel:
    def __init__(self, *, simhash_bits: int = 64, minhash_k: int = 128,
                 device="cuda"):
        self.simhash_bits = simhash_bits
        self.minhash_k = minhash_k
        self.device = resolve(device)

    @staticmethod
    def _digest_array(digests: list[bytes]) -> np.ndarray:
        return np.frombuffer(b"".join(digests), dtype=np.uint8).reshape(-1, 32)

    def snapshot_signature(self, digests: list[bytes]) -> np.ndarray:
        """minhash signature of a snapshot's chunk-digest set."""
        return minhash_signature(self._digest_array(digests),
                                 k=self.minhash_k, device=self.device)

    def snapshot_similarity(self, sig_a: np.ndarray, sig_b: np.ndarray) -> float:
        return minhash_similarity(sig_a, sig_b)

    def best_previous(self, target_sig: np.ndarray,
                      candidates: dict[str, np.ndarray],
                      *, min_similarity: float = 0.05) -> tuple[str | None, float]:
        """Pick the historical snapshot most similar to the target set."""
        best, best_s = None, min_similarity
        for name, sig in candidates.items():
            s = minhash_similarity(target_sig, sig)
            if s > best_s:
                best, best_s = name, s
        return best, (best_s if best else 0.0)

    def chunk_sketches(self, digests: list[bytes]) -> np.ndarray:
        """Per-chunk simhash sketches (uint32[N, bits/32])."""
        return simhash_sketch(self._digest_array(digests), k=self.simhash_bits,
                              device=self.device).cpu().numpy().astype(np.uint32)

    def near_duplicates(self, sketches_a, sketches_b, *,
                        max_distance: int = 6) -> list[tuple[int, int, int]]:
        """All (i, j, dist) pairs with Hamming distance <= max_distance, in
        row-major order: one pairwise pass on the device, and only the
        pairs found come back to the host."""
        d = pairwise_hamming(sketches_a, sketches_b, device=self.device)
        ij = torch.nonzero(d <= max_distance)
        dist = d[ij[:, 0], ij[:, 1]].cpu().numpy()
        return [(int(i), int(j), int(x))
                for (i, j), x in zip(ij.cpu().numpy(), dist)]
