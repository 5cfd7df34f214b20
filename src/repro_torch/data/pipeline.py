"""Deterministic, resumable data pipeline (numpy only): the port's own
copy of the JAX package's ``repro.data.pipeline`` without its
``shard_batch`` (the port has no mesh yet).  ``batch_at(step)`` gives the
same tokens as the JAX stream, so the tests feed both packages from one
stream.

Design for fault tolerance: streams are *stateless functions of the step
index* (synthetic) or of (epoch_seed, step) (binary corpus with
deterministic per-epoch shuffling). The iterator "state" is therefore a
single integer cursor — checkpointing data progress is exact and free,
and elastic restarts on a different host count replay no data.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DataState:
    """The full resume cursor for a stream (stored in checkpoints)."""
    step: int = 0

    def to_dict(self):
        return {"step": self.step}

    @staticmethod
    def from_dict(d):
        return DataState(step=int(d["step"]))


class SyntheticLMStream:
    """Deterministic synthetic token stream: batch(step) is a pure
    function of (seed, step) — resumable from just the step counter,
    identical across any number of hosts (each host slices its shard)."""

    def __init__(self, *, vocab: int, batch: int, seq_len: int,
                 seed: int = 0, structured: bool = True):
        self.vocab = vocab
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.structured = structured

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        if self.structured:
            # learnable structure: token t+1 = (a·t + b) mod vocab per row —
            # lets convergence benchmarks actually measure learning.
            a = rng.integers(1, 8, size=(self.batch, 1))
            b = rng.integers(0, self.vocab, size=(self.batch, 1))
            start = rng.integers(0, self.vocab, size=(self.batch, 1))
            idx = np.arange(self.seq_len + 1)[None, :]
            toks = (start + a * idx + b * (idx // 7)) % self.vocab
        else:
            toks = rng.integers(0, self.vocab,
                                size=(self.batch, self.seq_len + 1))
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PackedBinaryDataset:
    """Memory-mapped packed-token corpus (one flat int32/uint16 file).

    Windows of seq_len+1 tokens; per-epoch deterministic shuffle of
    window order keyed by (seed, epoch). batch(step) is pure in step.
    """

    def __init__(self, path: str, *, batch: int, seq_len: int,
                 seed: int = 0, dtype=np.int32):
        self.arr = np.memmap(path, dtype=dtype, mode="r")
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.n_windows = len(self.arr) // (seq_len + 1)
        if self.n_windows < batch:
            raise ValueError("corpus too small for one batch")
        self.steps_per_epoch = self.n_windows // batch

    def _perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(self.n_windows)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        epoch = step // self.steps_per_epoch
        within = step % self.steps_per_epoch
        perm = self._perm(epoch)
        idx = perm[within * self.batch:(within + 1) * self.batch]
        w = self.seq_len + 1
        toks = np.stack([self.arr[i * w:(i + 1) * w] for i in idx]
                        ).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_stream(kind: str, **kw):
    if kind == "synthetic":
        return SyntheticLMStream(**kw)
    if kind == "binary":
        return PackedBinaryDataset(**kw)
    raise ValueError(kind)


def write_synthetic_corpus(path: str, n_tokens: int, vocab: int,
                           seed: int = 0):
    """Test helper: materialize a synthetic corpus file."""
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, vocab, size=(n_tokens,)).astype(np.int32)
    arr.tofile(path)
    return path
