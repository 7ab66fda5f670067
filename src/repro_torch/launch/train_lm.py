"""End-to-end driver: federated FetchSGD training of a GPT2-family LM.

Port of ``examples/train_federated_lm.py``, with its flags and defaults:
persona-style power-law clients -> per-client gradients -> client sketches
(encode kernel) -> mean -> server step (momentum/error, estimate and
top-k, hit-cell kernels) -> sparse update -> communication ledger.
``--full`` trains the real 162M-element gpt2s-federated config; the
default is the reduced config.  Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train_lm --rounds 100
    PYTHONPATH=src python -m repro_torch.launch.train_lm --full --rounds 300
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import configs, resolve_device
from repro_torch.core import compression, fetchsgd as F
from repro_torch.core import layout as layout_lib
from repro_torch.core import topk as topk_lib
from repro_torch.data import federated, synthetic
from repro_torch.models import transformer
from repro_torch.optim import linear_decay


@dataclasses.dataclass
class RoundRecord:
    round: int
    loss: float          # mean client loss before the update
    lr: float
    seconds: float       # wall time of the round, ended by a device sync
    delta_size: int      # entries of Delta
    delta_unique: int    # distinct global ids in Delta


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg, fs_cfg: F.FetchSGDConfig, params: dict, dataset, *,
          rounds: int, clients_per_round: int, peak_lr: float, device,
          log=print):
    """Run ``rounds`` FetchSGD rounds; updates ``params`` in place.

    Returns (per-round records, traffic meter).
    """
    device = torch.device(device)
    lay = layout_lib.build_layout(params)
    lr_fn = linear_decay(peak_lr, rounds)
    meter = compression.TrafficMeter(d=lay.total)
    opt = F.init_state(fs_cfg, device)
    records = []
    t0 = time.time()
    for r in range(rounds):
        t_round = time.time()
        clients = federated.sample_clients(dataset.n_clients,
                                           clients_per_round, r)
        # each client participates once (the paper's single-epoch regime)
        tables, loss_sum = [], 0.0
        for c in clients:
            batch = federated.to_batch(dataset.client_batch(int(c)), device)
            loss, g = transformer.value_and_grad(params, batch, cfg,
                                                 remat=False)
            tables.append(F.sketch_grads(g, lay, fs_cfg))
            del g
            loss_sum += float(loss)
        agg = sum(tables) / len(tables)
        lr = lr_fn(r)
        delta, opt = F.server_step(
            agg, opt, torch.full((), lr, dtype=torch.float32, device=device),
            lay, fs_cfg)
        F.apply_delta(params, lay, delta)
        meter.record(compression.fetchsgd_round(
            fs_cfg.rows, fs_cfg.cols, fs_cfg.k, d=lay.total,
            staleness=max(r, 1)), clients_per_round)
        unique = int(torch.unique(topk_lib.global_ids(delta, lay)).numel())
        sync(device)
        rec = RoundRecord(round=r, loss=loss_sum / len(clients),
                          lr=float(lr), seconds=time.time() - t_round,
                          delta_size=int(delta.values.numel()),
                          delta_unique=unique)
        records.append(rec)
        if r % max(1, rounds // 20) == 0 or r == rounds - 1:
            log(f"round {r:4d}  loss {rec.loss:7.4f}  lr {rec.lr:.4f}  "
                f"({(time.time() - t0) / (r + 1):.1f}s/round)")
    return records, meter


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="train the full gpt2s-federated config")
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--clients-per-round", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=0)
    ap.add_argument("--lr", type=float, default=0.16)  # paper Sec. A.3
    ap.add_argument("--k", type=int, default=0)
    ap.add_argument("--cols", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap.parse_args(argv)


def main(argv=None, log=print):
    """Run the driver; returns (records, traffic meter)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = (configs.get_config("gpt2s-federated") if args.full
           else configs.get_smoke("gpt2s-federated"))
    seq = args.seq_len or (256 if args.full else 32)
    fs_cfg = F.FetchSGDConfig(
        rows=5,
        cols=args.cols or ((1 << 20) if args.full else (1 << 14)),
        k=args.k or (25_000 if args.full else 512),
        momentum=0.9)
    log(f"model {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
        f"vocab={cfg.vocab}; sketch {fs_cfg.rows}x{fs_cfg.cols} "
        f"k={fs_cfg.k}; device {device}")
    params = transformer.init_params(cfg, seed=0, device=device)
    d = transformer.param_count(params)
    log(f"d = {d / 1e6:.1f}M params; upload/round = "
        f"{F.upload_bytes(fs_cfg) / 1e6:.1f}MB "
        f"({d * 4 / F.upload_bytes(fs_cfg):.0f}x compression)")
    dataset = synthetic.PersonaLM(vocab=cfg.vocab, seq_len=seq,
                                  n_clients=args.rounds
                                  * args.clients_per_round)
    records, meter = train(cfg, fs_cfg, params, dataset, rounds=args.rounds,
                           clients_per_round=args.clients_per_round,
                           peak_lr=args.lr, device=device, log=log)
    t = meter.compression(args.clients_per_round)
    log(f"\ntotal traffic: up={t['upload_bytes'] / 1e6:.1f}MB "
        f"down={t['download_bytes'] / 1e6:.1f}MB -> "
        f"total compression {t['total_x']:.1f}x vs uncompressed")
    return records, meter


if __name__ == "__main__":
    main()
