"""Synthetic LM data pipeline with background host prefetch.

Produces deterministic, seeded token batches (documents with Zipfian token
statistics and EOS-delimited segments — enough structure for the loss to be
learnable in smoke runs).  A background thread keeps a bounded queue of
ready batches so host data generation overlaps device compute (the standard
input-pipeline overlap trick; on TPU this also hides host→device transfer).

For stub-frontend architectures (vlm/audio), batches contain precomputed
embeddings instead of token ids (DESIGN.md §3).

Straggler-aware batching: `set_balance()` accepts the thermal scheduler's
work-rebalance weights; the pipeline then skews per-tile microbatch sizes
(integer apportionment) — the paper's Effect ① applied as straggler
avoidance (DESIGN.md §3).

The port's own copy of `repro.data.pipeline` (numpy only): for a given
seed its batches are the reference's, byte for byte.
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass
class DataConfig:
    batch: int = 8
    seq_len: int = 128
    seed: int = 0
    prefetch: int = 2
    vocab_size: int = 512
    zipf_a: float = 1.2
    mean_doc_len: int = 64


class SyntheticLMData:
    def __init__(self, cfg: ArchConfig, dcfg: DataConfig):
        self.cfg = cfg
        self.dcfg = dataclasses.replace(dcfg, vocab_size=cfg.vocab_size)
        self._rng = np.random.default_rng(dcfg.seed)
        self._q: queue.Queue = queue.Queue(maxsize=dcfg.prefetch)
        self._stop = threading.Event()
        self._balance: np.ndarray | None = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- worker --
    def _make_batch(self) -> dict:
        d = self.dcfg
        v = min(d.vocab_size, 32_768)
        # zipf-ish ranks, documents delimited by token 1 (EOS), token 0 = pad
        toks = self._rng.zipf(d.zipf_a, size=(d.batch, d.seq_len + 1))
        toks = np.clip(toks + 1, 2, v - 1).astype(np.int32)
        doc_ends = self._rng.random((d.batch, d.seq_len + 1)) \
            < 1.0 / d.mean_doc_len
        toks = np.where(doc_ends, 1, toks)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.frontend != "token":
            # stub modality frontend: precomputed frame/patch embeddings
            emb = self._rng.standard_normal(
                (d.batch, d.seq_len, self.cfg.d_model)).astype(np.float32)
            batch["tokens"] = emb * 0.02
        return batch

    def _worker(self):
        while not self._stop.is_set():
            b = self._make_batch()
            while not self._stop.is_set():
                try:
                    self._q.put(b, timeout=0.25)
                    break
                except queue.Full:
                    continue

    # ---------------------------------------------------------------- api --
    def next(self) -> dict:
        return self._q.get()

    def set_balance(self, weights) -> None:
        """Thermal straggler weights from SchedulerOutput.balance."""
        self._balance = np.asarray(weights)

    def microbatch_split(self, n_tiles: int) -> np.ndarray:
        """Integer apportionment of the batch across tiles ∝ balance."""
        w = (self._balance if self._balance is not None
             else np.ones(n_tiles) / n_tiles)
        raw = w / w.sum() * self.dcfg.batch
        out = np.floor(raw).astype(int)
        rem = self.dcfg.batch - out.sum()
        order = np.argsort(-(raw - out))
        out[order[:rem]] += 1
        return out

    def close(self):
        self._stop.set()
