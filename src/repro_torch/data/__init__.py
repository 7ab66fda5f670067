"""Federated data: synthetic non-i.i.d. datasets and client sampling."""
