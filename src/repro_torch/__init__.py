"""repro_torch — FetchSGD (ICML 2020) in PyTorch, with hand-written CUDA
kernels for the Count Sketch hot path on Hopper (sm_90a).

A port of the ``repro`` JAX package, which stays the reference.  This
package imports neither JAX nor ``repro``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    A CUDA device that is not available raises; there is no silent move to
    the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
