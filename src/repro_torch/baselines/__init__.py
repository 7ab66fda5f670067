"""Baselines the paper compares against: FedAvg, local top-k, uncompressed."""

from . import fedavg, local_topk, uncompressed  # noqa: F401
