"""Communication accounting — the x-axis of every figure in the paper.

A copy of ``repro.core.compression`` (pure Python).

Compression is reported relative to uncompressed SGD in total bytes
transferred over all of training (paper Sec. 5): each participating client
uploads its update and downloads the new model state it is missing.  As in
the paper, only non-zero weight updates are counted and a zero-overhead
sparse encoding is assumed.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RoundTraffic:
    """Bytes moved in one round, per participating client."""

    upload: int
    download: int


@dataclasses.dataclass
class TrafficMeter:
    """Accumulates traffic over training and reports compression ratios."""

    d: int                      # model dimension
    upload_total: int = 0
    download_total: int = 0
    rounds: int = 0

    def record(self, traffic: RoundTraffic, clients: int) -> None:
        self.upload_total += traffic.upload * clients
        self.download_total += traffic.download * clients
        self.rounds += 1

    # -- ratios vs uncompressed (same number of rounds, same clients) -------
    def _uncompressed(self, clients_per_round: int) -> tuple[int, int]:
        per = self.d * 4 * clients_per_round * self.rounds
        return per, per

    def compression(self, clients_per_round: int) -> dict:
        up_ref, down_ref = self._uncompressed(clients_per_round)
        up = up_ref / max(self.upload_total, 1)
        down = down_ref / max(self.download_total, 1)
        total = (up_ref + down_ref) / max(self.upload_total + self.download_total, 1)
        return {"upload_x": up, "download_x": down, "total_x": total,
                "upload_bytes": self.upload_total,
                "download_bytes": self.download_total}


def fetchsgd_round(rows: int, cols: int, k: int, *, d: int | None = None,
                   staleness: int = 1) -> RoundTraffic:
    """Upload = the sketch; download = the k-sparse updates missed.

    Paper accounting (Sec. 5 footnote): only non-zero weight updates count,
    at 4 bytes each with a zero-overhead sparse encoding.  A client that
    last participated ``staleness`` rounds ago downloads the union of the
    k-sparse updates since then (capped at d — the updates overlap and can
    never exceed one full model).
    """
    down = k * staleness if d is None else min(d, k * staleness)
    return RoundTraffic(upload=rows * cols * 4, download=down * 4)


def local_topk_round(k: int, nnz_union: int, *, d: int | None = None,
                     staleness: int = 1) -> RoundTraffic:
    """Upload = local top-k values; download = union of cohort supports,
    accumulated over ``staleness`` rounds (this is why the paper observes
    download compression collapsing toward 1x on non-i.i.d. data)."""
    down = nnz_union * staleness if d is None else min(d, nnz_union * staleness)
    return RoundTraffic(upload=k * 4, download=down * 4)


def fedavg_round(d: int) -> RoundTraffic:
    return RoundTraffic(upload=d * 4, download=d * 4)


def uncompressed_round(d: int) -> RoundTraffic:
    return RoundTraffic(upload=d * 4, download=d * 4)
