"""Sharding rules: where each parameter, batch and cache dim lives on the
mesh.

Port of ``repro.models.sharding``'s rules.  A spec is a tuple with one
entry per dim: an axis name, a tuple of axis names, or ``None``
(replicated).  The rules are pure functions of the leaf's path and shape,
``cfg`` and the mesh's axis sizes (``mesh.shape``, a dict of axis name ->
size, or that dict itself):

* tensor-parallel over ``model``: attention heads, FFN width, expert FFN
  width, SSM inner width, vocab;
* data-parallel over ``(pod, data)``: the batch;
* expert stacks over ``data`` (``cfg.shard_experts_data``), when the
  expert count divides it;
* every rule is divisibility-guarded: if a dim does not divide the mesh
  axis, the next candidate dim is tried, else the leaf replicates.

Unit-stacked leaves carry a leading ``(n_units,)`` dim, which the rules
skip.  The port's mesh step (``launch.steps``) places both kinds of
entry: a rank stores the ``data`` slice of an expert-parallel leaf
(:func:`data_shard_axes`) and the ``model`` slice of a tensor-parallel
one (:func:`model_shard_axes`), and its forward and backward run
tensor-parallel over the model group (``models/tp.py``).  The ``model``
entries also give the view permutations and the model-local sketch.  A
serving rank stores its ``cache_spec`` slice of the decode cache
(:func:`cache_shard_axes`, the counterpart of the reference's
``cache_sharding``).  The reference's other ``NamedSharding`` trees only
serve its compiler and have no counterpart; its activation constraint
has one in the train path's checkpointed units
(``models/transformer.py``), which keep their saved input as the rank's
slice of ``d``.
"""

from __future__ import annotations

from repro_torch.core import layout as layout_lib

from .config import ArchConfig


def mesh_shape(mesh) -> dict:
    """Axis name -> size of a mesh (``mesh.shape``), or the dict itself."""
    return dict(getattr(mesh, "shape", mesh))


def _axsize(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def _div(n: int, mesh, ax: str) -> bool:
    return n % _axsize(mesh, ax) == 0 and _axsize(mesh, ax) > 1


def batch_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)


def _batch_entry(mesh):
    """The spec entry of a batch dim: the client axes, one axis as its
    name (as ``PartitionSpec`` writes it)."""
    axes = batch_axes(mesh)
    return axes if len(axes) > 1 else axes[0]


def _batch_size(mesh) -> int:
    n = 1
    for ax in batch_axes(mesh):
        n *= _axsize(mesh, ax)
    return n


def param_spec(path: str, shape: tuple[int, ...], cfg: ArchConfig,
               mesh) -> tuple:
    """The spec of one parameter leaf, keyed by its path.  A model with
    latent attention (MLA) has no mesh layout and is refused."""
    if cfg.kv_lora_rank or cfg.first_dense_layers:
        raise NotImplementedError(f"{cfg.name}: no mesh layout for latent "
                                  f"attention (MLA) or leading dense layers")
    name = path.split("/")[-1]
    stacked = path.startswith("units/") or path.startswith("enc/units/")
    lead = (None,) if stacked else ()
    nd = len(shape) - len(lead)

    def spec(*axes):
        axes = axes[:nd] + (None,) * (nd - len(axes))
        return lead + axes

    def model_if(n: int):
        return "model" if _div(n, mesh, "model") else None

    moe_e = ("data" if cfg.shard_experts_data
             and _div(cfg.n_experts, mesh, "data") else None)

    if name == "table":                                   # embed (V, d)
        return spec(model_if(shape[-2]), None)
    if path.endswith("unembed/w"):                        # (d, V)
        return spec(None, model_if(shape[-1]))
    if name == "frontend_proj":
        return spec(None, model_if(shape[-1]))
    if name in ("wq", "wk", "wv") and nd == 3:            # (d, H, hd)
        if _div(shape[-2], mesh, "model"):
            return spec(None, "model", None)
        if name in ("wk", "wv") and cfg.qk_norm:
            return spec()
        if _div(shape[-1], mesh, "model"):
            return spec(None, None, "model")
        return spec()
    if name == "wo" and nd == 3:                          # (H, hd, d)
        if _div(shape[-3], mesh, "model"):
            return spec("model", None, None)
        if _div(shape[-2], mesh, "model"):
            return spec(None, "model", None)
        return spec()
    if "/moe/" in path and "/shared/" not in path:
        if name == "router":
            return spec()
        if name in ("w_gate", "w_up"):                    # (E, d, ffe)
            return spec(moe_e, None, model_if(shape[-1]))
        if name == "w_down":                              # (E, ffe, d)
            return spec(moe_e, model_if(shape[-2]), None)
    if name in ("w_gate", "w_up"):                        # dense mlp (d, ff)
        return spec(None, model_if(shape[-1]))
    if name == "w_down":                                  # (ff, d)
        return spec(model_if(shape[-2]), None)
    if "/mamba/" in path:
        di = cfg.d_inner
        if name in ("in_proj", "conv_w", "dt_proj"):      # (*, di-based)
            return spec(None, model_if(di))
        if name in ("conv_b", "dt_bias", "D"):            # (di,)
            return spec(model_if(di))
        if name in ("x_proj", "A_log", "out_proj"):       # (di, *)
            return spec(model_if(di), None)
    if "/mlstm/" in path:
        if name in ("up", "wq", "wk", "wv"):              # (*, k*di)
            return spec(None, model_if(shape[-1]))
        if name in ("down", "w_if"):                      # (di, *)
            return spec(model_if(shape[-2]), None)
        return spec()
    return spec()  # norms, biases, scalars, the sLSTM


def layout_view_plan(params: dict, cfg: ArchConfig, mesh):
    """(view_perms, modes, model_specs) for FetchSGD's 2-D leaf views.

    A leaf sharded over ``model`` on its trailing dim maps onto its 2-D
    view's columns (mode ``cols``), a 2-D leaf sharded on its leading dim
    onto its rows (``rows``); for a mid-tensor model dim (``w_down``'s
    ffe, ``wo``'s heads) the view is permuted so that dim lands last
    (``cols``), and the flat id space is defined over the permuted order.
    ``modes`` and ``model_specs`` (the spec with every axis but ``model``
    dropped) come one per leaf in flatten order.
    """
    perms: dict[str, tuple[int, ...]] = {}
    modes: list = []
    model_specs: list = []
    for path, leaf in layout_lib.flatten(params):
        nd = len(leaf.shape)
        entries = list(param_spec(path, tuple(leaf.shape), cfg, mesh))
        entries += [None] * (nd - len(entries))
        model_dims = [i for i, e in enumerate(entries) if e == "model"]
        model_specs.append(tuple("model" if e == "model" else None
                                 for e in entries))
        if not model_dims:
            modes.append(None)
        elif model_dims[0] == nd - 1:
            modes.append("cols")
        elif nd == 2 and model_dims[0] == 0:
            modes.append("rows")
        else:
            m = model_dims[0]
            perms[path] = tuple(i for i in range(nd) if i != m) + (m,)
            modes.append("cols")
    return perms, modes, model_specs


def data_shard_axes(params: dict, cfg: ArchConfig, mesh) -> dict[str, int]:
    """Leaf path -> the dim sharded over ``data`` (the expert-parallel
    leaves); empty unless ``cfg.shard_experts_data`` and the expert count
    divides the data axis."""
    if not cfg.shard_experts_data or "data" not in mesh_shape(mesh):
        return {}
    axes = {}
    for path, leaf in layout_lib.flatten(params):
        for i, entry in enumerate(param_spec(path, tuple(leaf.shape), cfg,
                                             mesh)):
            names = entry if isinstance(entry, tuple) else (entry,)
            if "data" in names:
                axes[path] = i
    return axes


def model_shard_axes(params: dict, cfg: ArchConfig, mesh) -> dict[str, int]:
    """Leaf path -> the dim ``param_spec`` splits over ``model`` (the
    tensor-parallel leaves); empty on a mesh whose model axis has one
    rank.  The counterpart of :func:`data_shard_axes`."""
    axes = {}
    for path, leaf in layout_lib.flatten(params):
        for i, entry in enumerate(param_spec(path, tuple(leaf.shape), cfg,
                                             mesh)):
            if entry == "model":
                axes[path] = i
    return axes


# -- batch / cache ---------------------------------------------------------------

def batch_spec(shape: tuple[int, ...], mesh) -> tuple:
    """Batch-leading arrays: shard batch over (pod, data) when divisible."""
    if shape and shape[0] % _batch_size(mesh) == 0 and shape[0] > 1:
        return (_batch_entry(mesh),) + (None,) * (len(shape) - 1)
    return (None,) * len(shape)


def cache_spec(path: str, shape: tuple[int, ...], cfg: ArchConfig,
               mesh) -> tuple:
    """KV/state caches: (U, M, B, ...) stacked arrays.

    Per array kind, every choice divisibility-guarded:
      attn k/v:    batch over (pod,data) -> kv-heads over model,
                   else head_dim over model;
      mamba/xlstm: batch over (pod,data), inner width over model.
    """
    name = path.split("/")[-1]
    daxes = _batch_entry(mesh)
    nb = _batch_size(mesh)
    if name in ("pos", "pos_arr"):
        return ()
    dims: list = [None] * len(shape)
    if len(shape) >= 3 and shape[2] % nb == 0 and shape[2] > 1:
        dims[2] = daxes
    if ("attn/" in path and name in ("k", "v")) or "xattn/" in path:
        # (U, M, B, cap or enc_seq, KV, hd)
        if _div(shape[4], mesh, "model"):
            dims[4] = "model"
        elif _div(shape[5], mesh, "model"):
            dims[5] = "model"
    elif "mamba/" in path:
        # conv (U,M,B,K-1,di) | ssm (U,M,B,di,ds)
        ax = 4 if name == "conv" else 3
        if _div(shape[ax], mesh, "model"):
            dims[ax] = "model"
    elif "mlstm/" in path:
        # C (U,M,B,H,dh,dh) | n (U,M,B,H,dh)
        if _div(shape[3], mesh, "model"):
            dims[3] = "model"
        elif _div(shape[4], mesh, "model"):
            dims[4] = "model"
    elif "slstm/" in path:
        if _div(shape[-1], mesh, "model"):
            dims[-1] = "model"
    return tuple(dims)


def cache_shard_axes(cache: dict, cfg: ArchConfig,
                     mesh) -> dict[str, dict[str, int]]:
    """Leaf path -> ``{"model": dim, "client": dim}``, the dims of a
    cache leaf that :func:`cache_spec` splits over ``model`` and over the
    client axes (a kind absent when it splits none), read from the
    spec alone.  ``cache``: the global tree (shapes only; ``meta`` will
    do)."""
    axes = {}
    for path, leaf in layout_lib.flatten(cache):
        dims = {}
        for i, entry in enumerate(cache_spec(path, tuple(leaf.shape), cfg,
                                             mesh)):
            names = entry if isinstance(entry, tuple) else (entry,)
            if "model" in names:
                dims["model"] = i
            elif any(n in ("pod", "data") for n in names):
                dims["client"] = i
        if dims:
            axes[path] = dims
    return axes
