"""Port parity for the train path's rematerialization (``remat``).

The reference's ``loss_fn`` defaults to ``remat=True``: each unit of its
scan under ``jax.checkpoint``, and every attention query block and
cross-entropy chunk checkpointed always.  The port checkpoints the same
three (``torch.utils.checkpoint``, non-reentrant) when ``remat`` is on,
and its default is the reference's.

* ``remat`` changes no number: on the CPU the loss and every gradient
  leaf with and without it are equal bit for bit (a dense arch, a MoE
  with a shared expert, jamba's mamba and MoE units, whisper's
  encoder-decoder, pixtral's patch prefix, xlstm), and so are the
  checkpointed loss chunks and attention blocks alone.
* The port's ``remat=True`` loss and gradients against
  ``jax.value_and_grad`` of the reference's ``loss_fn(remat=True)`` on
  the dense zoo, at ``test_torch_zoo.py``'s tolerances (the residual's
  bfloat16 roundings: loss rtol 5e-5, each leaf within 1e-2 of its
  largest gradient).
* The dry-run's live-bytes count holds under the checkpoint: on the CPU
  ``analysis.peak_live_bytes`` of ``value_and_grad(remat=True)`` equals
  ``MemTracker``'s peak less the parameters and the batch within 1 KiB,
  as it does without ``remat``, and the checkpointed pass peaks lower.
* The callers that the reference runs with ``remat=False`` pass it (the
  orchestrator's clients).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jt
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import layout as TL
from repro_torch.fed import orchestrator as torch_orch
from repro_torch.launch import analysis as tanalysis
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tly
from repro_torch.models import transformer as tt

import test_torch_zoo as zoo

BITWISE = ("qwen3-0.6b", "qwen2-moe-a2.7b", "jamba-v0.1-52b",
           "whisper-small", "pixtral-12b", "xlstm-350m")


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed: int = 0, B: int = 2, S: int = 40) -> dict:
    """Tokens, labels (some masked) and the frontend's inputs, from numpy;
    S spans several query blocks and loss chunks of 16."""
    rng = np.random.default_rng(seed)
    b = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))),
         "labels": torch.from_numpy(rng.integers(-1, cfg.vocab, (B, S)))}
    if cfg.frontend == "vision":
        b["patches"] = torch.from_numpy(rng.normal(
            size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32))
    if cfg.is_encdec:
        b["frames"] = torch.from_numpy(rng.normal(
            size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    return b


@pytest.mark.parametrize("arch", BITWISE)
def test_remat_grads_equal_the_plain_pass_bitwise(arch):
    cfg = dataclasses.replace(tconfigs.get_smoke(arch), attn_chunk=16,
                              loss_chunk=16)
    params = tt.init_params(cfg, seed=1)
    b = _batch(cfg)
    loss0, g0 = tt.value_and_grad(params, b, cfg, remat=False)
    loss1, g1 = tt.value_and_grad(params, b, cfg, remat=True)
    assert torch.equal(loss0, loss1)
    for (p, a), (_, c) in zip(TL.flatten(g0), TL.flatten(g1)):
        assert torch.equal(a, c), p


def test_checkpointed_loss_chunks_and_attention_blocks_equal_the_plain():
    gen = torch.Generator().manual_seed(3)
    h = torch.randn(2, 40, 32, generator=gen, requires_grad=True)
    w = torch.randn(32, 50, generator=gen, requires_grad=True)
    labels = torch.randint(-1, 50, (2, 40), generator=gen)
    outs = []
    for remat in (False, True):
        loss = tly.xent_loss({"w": w}, h, labels, 16, remat=remat)
        outs.append((loss, *torch.autograd.grad(loss, (h, w))))
    for a, c in zip(*outs):
        assert torch.equal(a, c)
    q = torch.randn(2, 40, 4, 8, generator=gen, requires_grad=True)
    k = torch.randn(2, 40, 2, 8, generator=gen, requires_grad=True)
    pos = torch.arange(40)[None].expand(2, 40)
    outs = []
    for remat in (False, True):
        o = tattn._attend(q, k, k, pos, pos, causal=True, window=0,
                          chunk=16, remat=remat)
        outs.append((o, *torch.autograd.grad((o * o).sum(), (q, k))))
    for a, c in zip(*outs):
        assert torch.equal(a, c)


@pytest.mark.parametrize("arch", zoo.DENSE)
def test_remat_loss_and_grads_match_the_reference_remat(arch):
    jcfg, tcfg = zoo.cfg_pair(arch)
    jp = zoo.reference_params(jcfg)
    b = zoo.batch(jcfg.vocab, seed=3)
    (jloss, _), jg = jax.value_and_grad(
        lambda p: jt.loss_fn(p, {k: jnp.asarray(v) for k, v in b.items()},
                             jcfg, remat=True), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, jp))
    tloss, tg = tt.value_and_grad(
        params_from_numpy(jp),
        {k: torch.from_numpy(v).long() for k, v in b.items()}, tcfg,
        remat=True)
    np.testing.assert_allclose(float(tloss), float(jloss),
                               rtol=zoo.LOSS_RTOL)
    want = dict(TL.flatten(jax.tree_util.tree_map(
        lambda g: np.asarray(g, np.float32), jg)))
    for path, g in TL.flatten(tg):
        w = want[path]
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=1e-2 * np.abs(w).max(),
                                   err_msg=path)


@pytest.mark.parametrize("remat", [False, True])
def test_live_bytes_under_checkpoint_equal_mem_tracker(remat):
    """On the CPU, with real tensors: ``MemTracker`` counts the
    parameters and the batch where it first meets them, inside the pass;
    the port's counter holds its inputs as given."""
    from torch.distributed._tools.mem_tracker import MemTracker
    cfg = tconfigs.get_smoke("qwen3-0.6b")
    params = tt.init_params(cfg, seed=0)
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (4, 128)))
    # one tensor as tokens and labels: MemTracker meets a batch tensor
    # only where an op reads its storage whole
    batch = {"tokens": tok, "labels": tok}

    def fn(p, b):
        return tt.value_and_grad(p, b, cfg, remat=remat)

    mine = tanalysis.peak_live_bytes(fn, params, batch)
    mt = MemTracker()
    with mt:
        fn(params, batch)
    peak = mt.get_tracker_snapshot("peak")[torch.device("cpu")]["Total"]
    held = sum(t.numel() * t.element_size()
               for t in [v for _, v in TL.flatten(params)] + [tok])
    assert abs(peak - held - mine) <= 1024, (peak, held, mine)
    if remat:
        plain = tanalysis.peak_live_bytes(
            lambda p, b: tt.value_and_grad(p, b, cfg, remat=False),
            params, batch)
        assert mine < 0.8 * plain, (mine, plain)


def test_the_orchestrators_clients_run_without_remat(monkeypatch):
    seen = []
    real = tt.value_and_grad

    def spy(params, batch, cfg, remat=True):
        seen.append(remat)
        return real(params, batch, cfg, remat=remat)

    monkeypatch.setattr(tt, "value_and_grad", spy)
    cfg = tconfigs.get_smoke("qwen3-0.6b")
    params = tt.init_params(cfg, seed=0)
    tok = torch.zeros(1, 8, dtype=torch.int64)
    torch_orch.make_grad_fn(cfg)(params, {"tokens": tok, "labels": tok})
    assert seen == [False]
