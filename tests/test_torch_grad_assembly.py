"""How the train path assembles the gradient of a stacked leaf.

The parameters of the units are stacked on a leading ``(n_units,)`` dim.
The train path (``transformer._backbone_train`` and the whisper
``_encoder``) splits each stacked leaf once per forward with
``torch.unbind`` and hands unit ``u`` its views, so the backward has one
``UnbindBackward0`` a stacked leaf, which stacks the units' gradients in
a single write.  A ``leaf[u]`` select a unit would instead run one
``select_backward`` a unit, each filling a zero tensor the size of the
whole leaf, and the autograd engine would add the ``n_units`` of them.

On the smoke archs of every unit kind (dense GQA, MoE with a shared
expert, jamba's mamba and MoE units, whisper's encoder-decoder, pixtral's
patch prefix, xlstm), cut to three units, with and without ``remat``:

* the loss's autograd graph holds exactly one ``UnbindBackward0`` for
  each stacked leaf under ``units`` and ``enc/units``, and no
  ``SelectBackward0`` takes a stacked leaf;
* under ``torch.profiler`` the backward of ``value_and_grad`` runs no
  ``aten::select_backward`` of a stacked leaf's size, where the select
  assembly (``_index`` a unit, what the serve path keeps) runs one a
  unit;
* the returned gradients equal the select assembly's: the sum of each
  unit's gradient zero-padded into the stacked shape.  Each element of
  that sum is one unit's value plus exact zeros, so the two are equal
  value for value (the sum turns a unit's ``-0.0`` into ``+0.0``, which
  ``torch.equal`` counts as equal).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs as tconfigs
from repro_torch.core import layout as TL
from repro_torch.models import transformer as tt

ARCHS = ("qwen3-0.6b", "qwen2-moe-a2.7b", "jamba-v0.1-52b",
         "whisper-small", "pixtral-12b", "xlstm-350m")
N_UNITS = 3
STACKED = ("units/", "enc/units/")


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    cfg = tconfigs.get_smoke(arch)
    return dataclasses.replace(
        cfg, n_layers=N_UNITS * len(cfg.unit_pattern),
        enc_layers=N_UNITS if cfg.is_encdec else 0,
        attn_chunk=16, loss_chunk=16)


def _batch(cfg, B: int = 2, S: int = 24) -> dict:
    rng = np.random.default_rng(5)
    b = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))),
         "labels": torch.from_numpy(rng.integers(-1, cfg.vocab, (B, S)))}
    if cfg.frontend == "vision":
        b["patches"] = torch.from_numpy(rng.normal(
            size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32))
    if cfg.is_encdec:
        b["frames"] = torch.from_numpy(rng.normal(
            size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    return b


def _setup(arch):
    cfg = _cfg(arch)
    return cfg, tt.init_params(cfg, seed=2), _batch(cfg)


def _stacked(path: str) -> bool:
    return path.startswith(STACKED)


def _select(tree, u: int):
    if isinstance(tree, dict):
        return {k: _select(v, u) for k, v in tree.items()}
    return tree[u]


def _select_assembly(tree, n):
    """The per-unit trees as ``leaf[u]`` selects: the select assembly."""
    return [_select(tree, u) for u in range(n)]


def _leaves(params):
    flat = TL.flatten(params)
    paths = [p for p, _ in flat]
    leaves = [t.detach().requires_grad_(True) for _, t in flat]
    return paths, leaves, TL.unflatten(paths, leaves)


def _graph_nodes(root):
    seen, stack = set(), [root]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        stack.extend(f for f, _ in node.next_functions)
    return seen


def _stacked_select_backwards(params, batch, cfg, remat):
    """The sizes of the ``aten::select_backward`` calls of
    ``value_and_grad``'s backward that build a stacked leaf's shape."""
    shapes = {tuple(t.shape) for p, t in TL.flatten(params) if _stacked(p)}
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        tt.value_and_grad(params, batch, cfg, remat=remat)
    out = []
    for e in prof.events():
        if e.name == "aten::select_backward":
            size = tuple(e.concrete_inputs[1])
            if size in shapes:
                out.append(size)
    return out


@pytest.mark.parametrize("remat", (False, True))
@pytest.mark.parametrize("arch", ARCHS)
def test_each_stacked_leaf_has_one_unbind_and_no_select(arch, remat):
    cfg, params, batch = _setup(arch)
    paths, leaves, tree = _leaves(params)
    loss, _ = tt.loss_fn(tree, batch, cfg, remat=remat)
    unbinds = {id(t): 0 for t in leaves}
    selects = {id(t): 0 for t in leaves}
    for node in _graph_nodes(loss.grad_fn):
        name = type(node).__name__
        for f, _ in node.next_functions:
            if f is None or id(getattr(f, "variable", None)) not in unbinds:
                continue
            if name == "UnbindBackward0":
                unbinds[id(f.variable)] += 1
            elif name == "SelectBackward0":
                selects[id(f.variable)] += 1
    n_stacked = 0
    for p, t in zip(paths, leaves):
        if _stacked(p):
            n_stacked += 1
            assert unbinds[id(t)] == 1, p
            assert selects[id(t)] == 0, p
        else:
            assert unbinds[id(t)] == 0, p
    assert n_stacked > 0


@pytest.mark.parametrize("remat", (False, True))
@pytest.mark.parametrize("arch", ARCHS)
def test_backward_runs_no_select_backward_of_a_stacked_leaf(
        arch, remat, monkeypatch):
    cfg, params, batch = _setup(arch)
    assert _stacked_select_backwards(params, batch, cfg, remat) == []
    # the probe sees the select assembly: one a unit for each stacked leaf
    monkeypatch.setattr(tt, "_unbind", _select_assembly)
    n_stacked = sum(_stacked(p) for p, _ in TL.flatten(params))
    assert len(_stacked_select_backwards(params, batch, cfg, remat)) \
        == N_UNITS * n_stacked


@pytest.mark.parametrize("remat", (False, True))
@pytest.mark.parametrize("arch", ARCHS)
def test_grads_equal_the_zero_padded_sum_of_the_units(
        arch, remat, monkeypatch):
    cfg, params, batch = _setup(arch)
    loss, grads = tt.value_and_grad(params, batch, cfg, remat=remat)

    # each unit's gradient, taken at the views that unit ``u`` is handed
    paths, leaves, tree = _leaves(params)
    prefixes = {id(tree["units"]): "units/"}
    if cfg.is_encdec:
        prefixes[id(tree["enc"]["units"]["m0"])] = "enc/units/m0/"
    views: dict[str, list] = {}
    unbind = tt._unbind

    def recording(sub, n):
        per_unit = unbind(sub, n)
        if id(sub) not in prefixes:       # a nested call of the helper
            return per_unit
        for unit_p in per_unit:
            for p, v in TL.flatten(unit_p):
                views.setdefault(prefixes[id(sub)] + p, []).append(v)
        return per_unit

    monkeypatch.setattr(tt, "_unbind", recording)
    loss1, _ = tt.loss_fn(tree, batch, cfg, remat=remat)
    assert torch.equal(loss, loss1.detach())
    names = sorted(views)
    assert names == sorted(p for p in paths if _stacked(p))
    flat_views = [v for p in names for v in views[p]]
    unit_grads = iter(torch.autograd.grad(loss1, flat_views))

    got = dict(TL.flatten(grads))
    for p in names:
        per_unit = [next(unit_grads) for _ in range(N_UNITS)]
        acc = None
        for u in reversed(range(N_UNITS)):   # the backward's order
            z = torch.zeros_like(got[p])
            z[u] = per_unit[u]
            acc = z if acc is None else acc + z
        assert torch.equal(got[p], acc), p
