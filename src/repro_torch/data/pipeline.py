"""Deterministic synthetic data pipeline.

Per-host sharded token streams with background prefetch. On a real multi-host
deployment each host draws only its slice of the global batch (``host_id`` /
``n_hosts``); determinism is by (seed, step) so restart-from-checkpoint
replays the exact stream — a fault-tolerance requirement, not a convenience.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from repro_torch.models.spec import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    vocab: int = 50_000


def _rng_for(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id]))


def synth_batch(cfg: DataConfig, step: int, model: Optional[ModelConfig] = None) -> dict:
    """Markov-ish synthetic LM batch — learnable (not iid-uniform) so loss
    curves actually descend in the examples/tests."""
    rng = _rng_for(cfg, step)
    b = cfg.global_batch // cfg.n_hosts
    vocab = model.vocab if model is not None else cfg.vocab
    s_text = cfg.seq_len
    out = {}
    if model is not None and model.frontend == "vlm_patch":
        s_text = cfg.seq_len - model.frontend_len
        out["embeds"] = rng.standard_normal(
            (b, model.frontend_len, model.d_model)).astype(np.float32) * 0.02
    if model is not None and model.frontend == "audio_frames":
        out["frames"] = rng.standard_normal(
            (b, model.encoder.seq_len, model.d_model)).astype(np.float32) * 0.02
    # order-2 pattern: x[t] = (x[t-1] + drift) % vocab with noise
    start = rng.integers(0, vocab, size=(b, 1))
    drift = rng.integers(1, 7, size=(b, 1))
    noise = (rng.random((b, s_text)) < 0.1) * rng.integers(
        0, vocab, size=(b, s_text))
    idx = np.arange(s_text)[None, :]
    toks = ((start + drift * idx + noise) % vocab).astype(np.int32)
    out["tokens"] = toks
    labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1).astype(np.int32)
    labels[:, -1] = -100
    out["labels"] = labels
    return out


class Prefetcher:
    """Background-thread prefetch of synthetic batches."""

    def __init__(self, cfg: DataConfig, model: Optional[ModelConfig] = None,
                 depth: int = 2, start_step: int = 0):
        self.cfg, self.model = cfg, model
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = synth_batch(self.cfg, step, self.model)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
