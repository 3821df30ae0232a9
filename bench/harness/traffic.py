"""Traffic from a mix's parameters and a seed.

One general generator reads every mix file under `bench/traffic/`.  A
serving mix gives one prompt length (a batch's prompts are stacked), the
new tokens a request asks for, a closed loop of `clients`, each sending its
next request when its reply arrives, and the front door's batching
(`max_batch`, `max_wait_ms`, `target_eff`, `per_request_s0`).  Prompt ids
are uniform over the vocabulary: every seed offers the same load, and
seeds differ in their data and not in their work."""
from __future__ import annotations

import numpy as np

SEED_MOD = 1 << 63


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for (seed, stream...): any whole seed, negative or
    past 64 bits, gives its own."""
    return np.random.default_rng([int(seed) % SEED_MOD, *stream])


class Prompts:
    """Each client's prompts, drawn in order from (seed, client)."""

    def __init__(self, seed: int, vocab: int, length: int):
        self.seed, self.vocab, self.length = seed, vocab, length
        self._gens: dict = {}

    def next(self, client: int) -> np.ndarray:
        gen = self._gens.get(client)
        if gen is None:
            gen = self._gens[client] = rng(self.seed, 1, client)
        return gen.integers(0, self.vocab, size=self.length, dtype=np.int64)
