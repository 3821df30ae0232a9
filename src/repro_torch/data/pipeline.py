"""Data pipeline: synthetic corpus -> tokenize -> pack -> global batches.

Built on mpi-list (`repro_torch.core.mpi_list`), as the JAX package's is:
documents are a DFM, tokenize is `flatMap`, and the flat token list is cut
into fixed-length sequences — the paper's §2.3 tool as the framework's
input pipeline.  Deterministic per (seed, epoch); each call of `batches()`
yields {tokens, labels} numpy arrays, labels = next token.  The batches
are the JAX pipeline's, array for array.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.mpi_list import Context


class SyntheticCorpus:
    """Zipf-ish token documents (no external data needed offline)."""

    def __init__(self, vocab_size: int, *, seed: int = 0,
                 mean_len: int = 512):
        self.vocab = vocab_size
        self.seed = seed
        self.mean_len = mean_len

    def docs(self, n: int, epoch: int = 0) -> list:
        rng = np.random.default_rng(self.seed + 1000 * epoch)
        out = []
        for _ in range(n):
            ln = int(rng.integers(self.mean_len // 2, self.mean_len * 2))
            # zipf-flavored ids clipped to vocab
            ids = rng.zipf(1.3, size=ln) % (self.vocab - 3)
            out.append(ids.astype(np.int32) + 2)      # 0=pad,1=bos reserved
        return out


def pack_documents(ctx: Context, docs: list, seq_len: int) -> np.ndarray:
    """mpi-list pipeline: scatter docs -> flatMap(tokens + EOS) ->
    collect, cut into (n_seq, seq_len) rows."""
    dfm = ctx.scatter(docs)
    tokens = dfm.flatMap(lambda d: list(d) + [1])       # EOS/BOS separator
    flat = np.asarray(tokens.collect(), dtype=np.int32)
    n_seq = len(flat) // seq_len
    return flat[: n_seq * seq_len].reshape(n_seq, seq_len)


class Pipeline:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int, *,
                 seed: int = 0, n_ranks: int = 4):
        self.corpus = SyntheticCorpus(vocab_size, seed=seed)
        self.ctx = Context(n_ranks)
        self.seq_len = seq_len
        self.global_batch = global_batch
        self._buf = np.zeros((0, seq_len + 1), np.int32)
        self._epoch = 0

    def _refill(self):
        need_tokens = self.global_batch * (self.seq_len + 1) * 2
        n_docs = max(8, need_tokens // self.corpus.mean_len)
        packed = pack_documents(self.ctx, self.corpus.docs(n_docs, self._epoch),
                                self.seq_len + 1)
        self._epoch += 1
        self._buf = np.concatenate([self._buf, packed], axis=0)

    def batches(self, n_steps: int):
        for _ in range(n_steps):
            while len(self._buf) < self.global_batch:
                self._refill()
            chunk, self._buf = (self._buf[: self.global_batch],
                                self._buf[self.global_batch:])
            yield {"tokens": chunk[:, :-1],
                   "labels": chunk[:, 1:].astype(np.int32)}
