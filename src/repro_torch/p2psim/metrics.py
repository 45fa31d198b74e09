"""Message / byte / time / accuracy accounting (paper §3.2, §5).

A copy of the reference package's accounting, field for field.
"""
from __future__ import annotations

import dataclasses

import numpy as np


# paper §3.2: L = 10 B per couple (4 B score + 6 B address)
ENTRY_BYTES_PAPER = 10
QUERY_BYTES = 100            # forward message payload (Q + QID + TTL + addr)


@dataclasses.dataclass
class QueryMetrics:
    algorithm: str = "fd"
    n_reached: int = 0
    n_edges_pq: int = 0
    avg_degree: float = 0.0

    m_fw: int = 0            # forward messages
    m_bw: int = 0            # backward messages
    m_rt: int = 0            # retrieve messages (requests + returns)
    b_fw: int = 0            # forward bytes
    b_bw: int = 0            # backward bytes
    b_rt: int = 0            # retrieve bytes (incl. data items)

    response_time_s: float = 0.0
    accuracy: float = 1.0    # ac_Q = |T_Q ∩ T_r| / |T_Q|

    @property
    def total_messages(self) -> int:
        return self.m_fw + self.m_bw + self.m_rt

    @property
    def total_bytes(self) -> int:
        return self.b_fw + self.b_bw + self.b_rt

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["total_messages"] = self.total_messages
        d["total_bytes"] = self.total_bytes
        return d


_INT_FIELDS = ("n_reached", "n_edges_pq", "m_fw", "m_bw", "m_rt",
               "b_fw", "b_bw", "b_rt")
_FLOAT_FIELDS = ("avg_degree", "response_time_s", "accuracy")


@dataclasses.dataclass
class BatchMetrics:
    """Per-entry metrics of a ``run_queries`` batch.

    Every array is shaped (n_queries, n_trials); entry (q, t) holds
    exactly what ``run_query`` would report for origin q's t-th trial
    seed — ``query_metrics(q, t)`` reconstructs the scalar dataclass
    bit-for-bit.
    """
    algorithm: str
    n_queries: int
    n_trials: int
    n_reached: np.ndarray
    n_edges_pq: np.ndarray
    avg_degree: np.ndarray
    m_fw: np.ndarray
    m_bw: np.ndarray
    m_rt: np.ndarray
    b_fw: np.ndarray
    b_bw: np.ndarray
    b_rt: np.ndarray
    response_time_s: np.ndarray
    accuracy: np.ndarray

    @classmethod
    def empty(cls, algorithm: str, n_queries: int,
              n_trials: int) -> "BatchMetrics":
        shape = (n_queries, n_trials)
        kw = {f: np.zeros(shape, np.int64) for f in _INT_FIELDS}
        kw.update({f: np.zeros(shape, np.float64) for f in _FLOAT_FIELDS})
        return cls(algorithm=algorithm, n_queries=n_queries,
                   n_trials=n_trials, **kw)

    @property
    def total_messages(self) -> np.ndarray:
        return self.m_fw + self.m_bw + self.m_rt

    @property
    def total_bytes(self) -> np.ndarray:
        return self.b_fw + self.b_bw + self.b_rt

    def query_metrics(self, q: int, t: int = 0) -> QueryMetrics:
        return QueryMetrics(
            algorithm=self.algorithm,
            n_reached=int(self.n_reached[q, t]),
            n_edges_pq=int(self.n_edges_pq[q, t]),
            avg_degree=float(self.avg_degree[q, t]),
            m_fw=int(self.m_fw[q, t]), m_bw=int(self.m_bw[q, t]),
            m_rt=int(self.m_rt[q, t]),
            b_fw=int(self.b_fw[q, t]), b_bw=int(self.b_bw[q, t]),
            b_rt=int(self.b_rt[q, t]),
            response_time_s=float(self.response_time_s[q, t]),
            accuracy=float(self.accuracy[q, t]))

    def summary(self) -> dict:
        """Workload-level aggregates (means over the whole batch)."""
        out = {"algorithm": self.algorithm, "n_queries": self.n_queries,
               "n_trials": self.n_trials}
        for f in _INT_FIELDS + _FLOAT_FIELDS:
            out[f"mean_{f}"] = float(getattr(self, f).mean())
        out["mean_total_bytes"] = float(self.total_bytes.mean())
        out["mean_total_messages"] = float(self.total_messages.mean())
        return out
