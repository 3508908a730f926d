"""Deterministic, resumable, DP-sharded synthetic-text data pipeline (a
copy of ``repro.data.pipeline``: numpy only, batches byte-equal per seed).

No external datasets are available offline, so the corpus is a synthetic
language with learnable structure: a zipfian-vocabulary order-2 Markov
chain with embedded "phrase" templates. A trained model's perplexity on a
held-out stream is a real generalization measure (used by the paper-
protocol quality benchmarks, benchmarks/fig2_quality.py).

Properties a production pipeline needs and this one has:
  * determinism: stream(seed, dp_rank) is a pure function;
  * resumability: ``state()`` returns an O(1) cursor; ``restore()`` resumes
    bit-exactly (checkpointed with the model, see ft/checkpoint.py);
  * DP sharding: rank r of R sees disjoint documents (leapfrog);
  * packing: documents are packed into fixed (batch, seq+1) token blocks
    with -1 label masking across boundaries.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticCorpusConfig:
    vocab_size: int = 512
    order: int = 2
    branching: int = 24        # plausible successors per context
    zipf_a: float = 1.2
    doc_len_mean: int = 512
    seed: int = 1234


class SyntheticCorpus:
    """Order-2 Markov chain over a zipfian vocab; contexts hash to a small
    successor table so the transition structure is learnable."""

    def __init__(self, cfg: SyntheticCorpusConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v, b = cfg.vocab_size, cfg.branching
        # per-hash successor candidates + unnormalized zipf weights
        self.n_ctx = 4096
        # zipf-skewed successor candidates: global unigram distribution is
        # heavy-tailed (like text), not uniform
        u = rng.random((self.n_ctx, b))
        self.succ = np.minimum((v * u ** 3).astype(np.int32), v - 1)
        w = 1.0 / np.arange(1, b + 1) ** cfg.zipf_a
        self.cum = np.cumsum(w / w.sum())

    def _ctx_hash(self, a: int, b: int) -> int:
        return (a * 1000003 + b * 7919) % self.n_ctx

    def document(self, doc_id: int) -> np.ndarray:
        rng = np.random.default_rng((self.cfg.seed, doc_id))
        n = max(8, int(rng.exponential(self.cfg.doc_len_mean)))
        out = np.empty(n, np.int32)
        a, b = rng.integers(0, self.cfg.vocab_size, 2)
        for i in range(n):
            h = self._ctx_hash(int(a), int(b))
            j = int(np.searchsorted(self.cum, rng.random()))
            tok = self.succ[h, min(j, self.succ.shape[1] - 1)]
            out[i] = tok
            a, b = b, tok
        return out


@dataclasses.dataclass
class PipelineState:
    doc_cursor: int
    buf: np.ndarray            # leftover tokens from the current doc
    step: int

    def to_dict(self) -> Dict:
        return {"doc_cursor": int(self.doc_cursor),
                "buf": self.buf.tolist(), "step": int(self.step)}

    @classmethod
    def from_dict(cls, d: Dict) -> "PipelineState":
        return cls(doc_cursor=d["doc_cursor"],
                   buf=np.asarray(d["buf"], np.int32), step=d["step"])


class DataPipeline:
    """Packed LM batches for one data-parallel rank."""

    def __init__(self, corpus: SyntheticCorpus, *, batch: int, seq: int,
                 dp_rank: int = 0, dp_size: int = 1, eod: int = 0,
                 start_doc: int = 0):
        self.corpus = corpus
        self.batch, self.seq = batch, seq
        self.dp_rank, self.dp_size = dp_rank, dp_size
        self.eod = eod
        self._state = PipelineState(
            doc_cursor=start_doc, buf=np.empty(0, np.int32), step=0)

    # -- resumability -----------------------------------------------------
    def state(self) -> Dict:
        return self._state.to_dict()

    def restore(self, d: Dict):
        self._state = PipelineState.from_dict(d)

    # -- iteration --------------------------------------------------------
    def _next_tokens(self, n: int) -> np.ndarray:
        st = self._state
        chunks = [st.buf]
        have = len(st.buf)
        cursor = st.doc_cursor
        while have < n:
            doc_id = cursor * self.dp_size + self.dp_rank    # leapfrog
            doc = self.corpus.document(doc_id)
            chunks.append(np.append(doc, self.eod).astype(np.int32))
            have += len(doc) + 1
            cursor += 1
        flat = np.concatenate(chunks)
        st.buf = flat[n:]
        st.doc_cursor = cursor
        return flat[:n]

    def next_batch(self) -> Dict[str, np.ndarray]:
        n = self.batch * (self.seq + 1)
        flat = self._next_tokens(n).reshape(self.batch, self.seq + 1)
        self._state.step += 1
        labels = flat[:, 1:].astype(np.int32)
        # mask the token right after an EOD (cross-document boundary)
        labels = np.where(flat[:, :-1] == self.eod, -1, labels)
        return {"tokens": np.ascontiguousarray(flat[:, :-1]),
                "labels": np.ascontiguousarray(labels)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()


def make_eval_stream(corpus: SyntheticCorpus, *, batch: int, seq: int,
                     n_batches: int, offset: int = 10_000_000):
    """Held-out stream: documents from a disjoint id range."""
    pipe = DataPipeline(corpus, batch=batch, seq=seq, start_doc=offset)
    return [pipe.next_batch() for _ in range(n_batches)]
