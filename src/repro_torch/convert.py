"""Conversion of parameter trees from the JAX package's format."""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device=None):
    """A nested dict of numpy arrays (``repro``'s parameters after
    ``np.asarray``) -> the same nested dict of tensors on ``device``.

    Shapes and layouts are the reference's, so the flat layout and every
    sketch hash agree between the packages.
    """
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)
