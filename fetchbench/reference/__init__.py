"""The plain reference the benchmark holds the program to: plain PyTorch,
one module per architecture family (the dense decoder's, ``dense_lm``)
and one each for FetchSGD's sketch and server step (``sketch``) and its
round (``federated``).  It imports
nothing of the program.

A configuration file names its family in ``family``; ``family(cfg)``
returns the module ``reference/<family>.py`` of the benchmark at the
run's root.  A family module provides:

* ``param_spec(cfg)``: ``(path, shape)`` of every leaf, in the order that
  defines FetchSGD's flat ids (the program's layout);
  ``n_params(spec)``; ``init_flat(spec, cfg, seed, device)``: the flat
  float32 weights drawn from the seed, on the device;
  ``leaves(flat, spec)``: ``path -> view``; ``leaf_spans(spec)``:
  ``(path, offset, size)``;
* ``loss_and_grad(flat, spec, tokens, labels, cfg, lowp=False)``: the
  mean loss as a float and the flat gradient; ``lowp`` the control, one
  precision below the configuration's;
* for serving, ``cache_dtype(cfg)`` and ``serve_logits(P, tokens, start,
  cfg, **lowp)``: the logits at positions ``start`` on, with the KV cache
  in its type; ``lowp`` the controls (``lowp=True``, ``kv_dtype=...``);
* ``READS``: the keys of a configuration file it reads beyond the fields
  of the program's ``ArchConfig`` (which the harness hands the program);
* ``MICRO``: the family's micro widths, for the CPU tests.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
NOT_FAMILIES = ("sketch", "federated")


def family(cfg: dict, root: Path = ROOT):
    """The module of ``cfg["family"]``, loaded from the benchmark at
    ``root``."""
    name = cfg.get("family")
    path = Path(root) / "fetchbench" / "reference" / f"{name}.py"
    if not isinstance(name, str) or not name.isidentifier() \
            or name.startswith("_") or name in NOT_FAMILIES \
            or not path.is_file():
        raise ValueError(f"no reference family {name!r} in "
                         f"{path.parent}")
    spec = importlib.util.spec_from_file_location(
        "fetchbench_family_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
