"""Deterministic, shardable synthetic LM data pipeline.

Requirements it satisfies (the same contract a production loader must):

* **Determinism** — batch ``i`` is a pure function of (seed, i); a restarted
  job resumes from the step recorded in the checkpoint and sees the exact
  same remaining stream (exactly-once semantics without a data journal).
* **Shardability** — ``SyntheticLMStream(..., shard=(k, n))`` yields the
  k-th of n disjoint per-host slices of every global batch; hosts never
  materialize the global batch.
* **Prefetch** — a background thread keeps ``depth`` batches ready so host
  data generation overlaps device compute.

The synthetic distribution is a Zipf-like unigram mix with a Markov overlay
so losses are non-trivial (compressible structure for the training
examples) — tokens are not uniform noise.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    embedding_inputs: bool = False   # audio/vlm stubs: emit embeddings
    d_model: int = 0
    mrope: bool = False


class SyntheticLMStream:
    """Deterministic synthetic token stream."""

    def __init__(self, cfg: DataConfig,
                 shard: Tuple[int, int] = (0, 1)) -> None:
        self.cfg = cfg
        self.shard_index, self.shard_count = shard
        if cfg.global_batch % self.shard_count:
            raise ValueError("global_batch must divide across shards")
        self.local_batch = cfg.global_batch // self.shard_count
        # Zipf-ish unigram distribution (heavy head, long tail)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = 1.0 / ranks
        self._probs = probs / probs.sum()

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """The shard-local slice of global batch ``step``."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.shard_index]))
        B, S = self.local_batch, cfg.seq_len
        # unigram draw + first-order structure: with p=0.5, repeat t-1 offset
        base = rng.choice(cfg.vocab_size, size=(B, S + 1), p=self._probs)
        stay = rng.random((B, S + 1)) < 0.35
        tokens = base.copy()
        tokens[:, 1:] = np.where(stay[:, 1:],
                                 (tokens[:, :-1] + 1) % cfg.vocab_size,
                                 tokens[:, 1:])
        tokens = tokens.astype(np.int32)
        out: Dict[str, np.ndarray] = {
            "labels": tokens[:, 1:],
        }
        if cfg.embedding_inputs:
            # modality-frontend stub: deterministic embeddings per token
            emb_rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed + 7, step,
                                        self.shard_index]))
            out["inputs"] = emb_rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32) * 0.02
        else:
            out["inputs"] = tokens[:, :-1]
        if cfg.mrope:
            pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
            out["positions"] = np.broadcast_to(pos[:, None],
                                               (B, 3, S)).copy()
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of a deterministic stream."""

    def __init__(self, stream: SyntheticLMStream, start_step: int = 0,
                 depth: int = 2) -> None:
        self.stream = stream
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="data-prefetch")
        self._thread.start()

    def _loop(self) -> None:
        step = self._step
        while not self._stop.is_set():
            batch = self.stream.batch(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self, timeout: float = 30.0):
        return self._q.get(timeout=timeout)

    def stop(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


def make_stream(model_cfg, seq_len: int, global_batch: int, seed: int = 0,
                shard: Tuple[int, int] = (0, 1)) -> SyntheticLMStream:
    """Stream matching a ModelConfig's input contract."""
    return SyntheticLMStream(DataConfig(
        vocab_size=model_cfg.vocab_size,
        seq_len=seq_len,
        global_batch=global_batch,
        seed=seed,
        embedding_inputs=model_cfg.embedding_inputs,
        d_model=model_cfg.d_model,
        mrope=model_cfg.rope_variant == "mrope",
    ), shard=shard)
