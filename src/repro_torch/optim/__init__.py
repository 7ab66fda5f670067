"""Learning-rate schedules used by the paper's experiments."""

from .schedules import linear_decay, triangular  # noqa: F401
