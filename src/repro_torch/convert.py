"""Conversion of parameter and cache trees from and to the JAX package's
format (nested dicts of numpy arrays)."""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device=None):
    """A nested dict of numpy arrays (``repro``'s parameters or decode
    cache after ``np.asarray``) -> the same nested dict of tensors on
    ``device``.

    Shapes and layouts are the reference's, so the flat layout and every
    sketch hash agree between the packages.  A 0-d array (the cache's
    ``pos``) becomes a 0-d tensor; a bfloat16 array (``ml_dtypes``, as
    JAX hands it out) becomes a bfloat16 tensor with the same bits.
    """
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    arr = np.array(tree, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def numpy_from_tensors(tree):
    """The inverse of :func:`params_from_numpy`: a nested dict of tensors
    -> the same nested dict of numpy arrays on the host, bfloat16 as
    ``ml_dtypes.bfloat16`` with the same bits."""
    if isinstance(tree, dict):
        return {k: numpy_from_tensors(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()
