"""Deterministic synthetic data pipeline (port of
``repro/data/pipeline.py``): numpy only, so the port's batches equal the
reference's exactly for the same config and seed.

  * Zipfian unigram distribution (vocab-scaled) + short-range Markov
    structure, so losses are non-degenerate and compressible;
  * deterministic per-(host, step) seeding — restart-safe;
  * host sharding: host h of H serves global-batch rows [h·B/H, (h+1)·B/H);
  * background prefetch (thread + queue).

``reshard_for_shares`` lays a batch out for the trainer's uneven
per-rank micro-batch ``shares=``.  Frontend architectures get stub
embeddings (``frontend``, f32 [B, Tf, Df], unit-normalised rows) drawn
from the same generator after the tokens.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Sequence

import numpy as np

from repro_torch.configs.base import ArchConfig


def reshard_for_shares(batch: Dict[str, np.ndarray],
                       shares: Sequence[int]) -> Dict[str, np.ndarray]:
    """Re-shard a host batch for UNEVEN per-rank micro-batch shares.

    Input layout: ``sum(shares) × mb`` rows of true data — micro-batch j
    occupies rows ``[j*mb, (j+1)*mb)``.  Output layout: the padded
    per-rank grid the trainer's ``shares=`` path consumes — rank r owns
    rows ``[r*n_max*mb, (r+1)*n_max*mb)`` with its ``shares[r]`` assigned
    micro-batches first (contiguous from the global sequence, so every
    micro-batch is computed exactly once across ranks) and zero padding
    after (never touched: the trainer's loop over rank r's micro-batches
    stops at ``shares[r]``).  Even shares are the identity layout, so this
    transform composes freely with the straggler-rebalance actuator.
    """
    shares = [int(s) for s in shares]
    if not shares or any(s < 1 for s in shares):
        raise ValueError(f"shares must be >= 1 each, got {shares}")
    m_total, n_max = sum(shares), max(shares)
    rows = next(iter(batch.values())).shape[0]
    if rows % m_total:
        raise ValueError(f"batch rows {rows} not divisible by "
                         f"sum(shares) = {m_total}")
    mb = rows // m_total
    out = {}
    for k, v in batch.items():
        padded = np.zeros((len(shares) * n_max * mb,) + v.shape[1:], v.dtype)
        off = 0
        for r, s_r in enumerate(shares):
            padded[r * n_max * mb:(r * n_max + s_r) * mb] = \
                v[off * mb:(off + s_r) * mb]
            off += s_r
        out[k] = padded
    return out


@dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    markov_order: int = 1
    zipf_a: float = 1.2


class SyntheticLM:
    """Zipf + Markov synthetic token stream."""

    def __init__(self, cfg: ArchConfig, dcfg: DataConfig):
        if dcfg.global_batch % dcfg.num_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.cfg = cfg
        self.dcfg = dcfg
        self.local_batch = dcfg.global_batch // dcfg.num_hosts
        v = cfg.vocab_size
        base = np.random.default_rng(dcfg.seed)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        probs = ranks ** (-dcfg.zipf_a)
        self._probs = probs / probs.sum()
        # a fixed random "grammar": each token biases its successor window
        self._shift = base.integers(1, max(2, v // 7))

    def _rng(self, step: int) -> np.random.Generator:
        # independent of host count: seed by (step, global row block)
        return np.random.default_rng(
            (self.dcfg.seed, step, self.dcfg.host_id))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng(step)
        B, T, v = self.local_batch, self.dcfg.seq_len, self.cfg.vocab_size
        base = rng.choice(v, size=(B, T + 1), p=self._probs)
        # Markov-ify: half the tokens continue their predecessor's window
        cont = rng.random((B, T)) < 0.5
        nxt = (base[:, :-1] + self._shift) % v
        base[:, 1:][cont] = nxt[cont]
        out = {"tokens": base[:, :-1].astype(np.int32),
               "labels": base[:, 1:].astype(np.int32)}
        if self.cfg.frontend:
            emb = rng.standard_normal(
                (B, self.cfg.frontend_tokens, self.cfg.frontend_dim)
            ).astype(np.float32)
            emb /= np.linalg.norm(emb, axis=-1, keepdims=True) + 1e-6
            out["frontend"] = emb
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Thread-backed prefetch queue over any step-indexed source."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 depth: int = 2):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=1.0)
