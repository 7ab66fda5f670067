"""The mesh on ``torch.distributed``: one process a rank.

Port of ``repro.launch.mesh``.  A mesh ``(pod, data, model)`` (or
``(data, model)``) is a ``torch.distributed`` world whose ranks are laid
out row-major over the axes, as ``jax.make_mesh`` orders its devices.
:class:`Mesh` gives a rank its coordinates and a process group for each
axis and for the client axes ``(pod, data)``; a group of one rank needs
no collective and has none.

Backends: a CPU world uses ``gloo``; a card world uses ``nccl`` when each
rank has a card of its own.  NCCL refuses two ranks of one communicator
on one device, so ranks that share a card use ``gloo`` over CUDA
tensors.  Nothing falls back to the CPU.

:func:`spawn` starts a local world of processes on 127.0.0.1 (the CPU
tests, and ``launch.train --debug-mesh`` without ``torchrun``).
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
import queue as queue_lib
import socket
import traceback

import torch
import torch.distributed as dist

# NVIDIA H100 SXM 80GB per-card constants (NVIDIA's data sheet, dense
# rates, at the full 700 W power limit)
CHIP = "NVIDIA H100 SXM 80GB"
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, tensor cores
HBM_BW = 3.35e12                # bytes/s
NVLINK_BW = 450e9               # bytes/s each way to the host's other cards

TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass
class Mesh:
    """A rank's view of the mesh: axis names and sizes, its coordinates,
    the process groups of the axes it reduces over, and its device."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    rank: int
    device: torch.device
    backend: str
    groups: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def coords(self) -> dict[str, int]:
        return dict(zip(self.axis_names, _coords(self.rank, self.sizes)))

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    @property
    def client_axes(self) -> tuple[str, ...]:
        """The manual (client) axes: ``pod`` and ``data``, as present."""
        return tuple(a for a in ("pod", "data") if a in self.axis_names)

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in axes)

    @property
    def n_clients(self) -> int:
        return self.size(self.client_axes)

    @property
    def client_index(self) -> int:
        """Row-major index of this rank over the client axes."""
        idx = 0
        for a in self.client_axes:
            idx = idx * self.shape[a] + self.index(a)
        return idx

    def group(self, axes):
        """The process group over ``axes`` holding this rank (None when it
        holds this rank alone)."""
        return self.groups.get(tuple(axes))

    def all_sum(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Sum ``t`` over ``axes`` in place; returns ``t``."""
        if self.size(axes) > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group(axes))
        return t

    def all_mean(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Mean of ``t`` over ``axes`` in place (the sum, divided by the
        axes' size, as ``lax.pmean``); returns ``t``."""
        n = self.size(axes)
        if n > 1:
            self.all_sum(t, axes)
            t /= n
        return t

    def all_gather(self, t: torch.Tensor, axes) -> list[torch.Tensor]:
        """``t`` of every rank over ``axes``, in row-major order."""
        if self.size(axes) == 1:
            return [t]
        out = [torch.empty_like(t) for _ in range(self.size(axes))]
        dist.all_gather(out, t.contiguous(), group=self.group(axes))
        return out


def _axis_sets(axis_names) -> list[tuple[str, ...]]:
    sets = [(a,) for a in axis_names]
    clients = tuple(a for a in ("pod", "data") if a in axis_names)
    if len(clients) > 1:
        sets.append(clients)
    return sets


def _card(local_rank: int, device) -> torch.device:
    """The device of a rank: the CPU, or the card ``local_rank`` modulo
    the cards there are, which becomes the current card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def backend_for(local_ranks: int, device) -> str:
    """``gloo`` on the CPU and for ranks that share a card; ``nccl`` when
    each of the host's ``local_ranks`` ranks has a card of its own."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if local_ranks <= torch.cuda.device_count() else "gloo"


def init_world(rank: int, world: int, init_method: str, device) -> None:
    """Join a local world of ``world`` ranks at ``init_method``
    (``tcp://127.0.0.1:<port>``) with the backend :func:`backend_for`
    picks."""
    dev = _card(rank, device)
    dist.init_process_group(backend_for(world, dev), init_method=init_method,
                            rank=rank, world_size=world, timeout=TIMEOUT)


def init_from_env(device) -> None:
    """Join the world that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``), or else a world of one on a free local port."""
    if dist.is_initialized():
        return
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        init_world(0, 1, f"tcp://127.0.0.1:{free_port()}", device)
        return
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = _card(local, device)
    dist.init_process_group(
        backend_for(int(os.environ.get("LOCAL_WORLD_SIZE", world)), dev),
        init_method="env://", rank=rank, world_size=world, timeout=TIMEOUT)


def make_mesh(sizes: tuple[int, ...], axis_names: tuple[str, ...],
              device=None) -> Mesh:
    """The mesh over the initialised world, whose size must equal the
    product of ``sizes``.  Every rank calls this, in the same order: each
    axis's (and the client axes') groups are created collectively.
    ``device``: where the rank's tensors live (default: its card under
    ``nccl``, else the CPU; ``cuda`` for ranks sharing a card)."""
    world = dist.get_world_size()
    if math.prod(sizes) != world:
        raise ValueError(f"mesh {dict(zip(axis_names, sizes))} needs "
                         f"{math.prod(sizes)} ranks, the world has {world}")
    rank = dist.get_rank()
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = Mesh(tuple(axis_names), tuple(sizes), rank, dev,
                dist.get_backend())
    for axes in _axis_sets(axis_names):
        if mesh.size(axes) == 1:
            continue
        others = [i for i, a in enumerate(axis_names) if a not in axes]
        for fixed in itertools.product(*(range(sizes[i]) for i in others)):
            ranks = [r for r in range(world)
                     if tuple(_coords(r, sizes)[i] for i in others) == fixed]
            g = dist.group.WORLD if len(ranks) == world else \
                dist.new_group(ranks)
            if rank in ranks:
                mesh.groups[axes] = g
    return mesh


def _coords(rank: int, sizes) -> tuple[int, ...]:
    out = []
    for size in reversed(sizes):
        out.append(rank % size)
        rank //= size
    return tuple(reversed(out))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """16 x 16 (``data``, ``model``), or 2 x 16 x 16 with a leading
    ``pod`` axis: the world must have 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_debug_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A (data, model) mesh over the initialised world of data * model
    ranks."""
    return make_mesh((data, model), ("data", "model"), device)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, world, init_method, device, threads, fn, args, out_q):
    try:
        if torch.device(device).type == "cpu":
            # the ranks share the host's cores: without this their
            # intra-op thread pools oversubscribe it many times over
            torch.set_num_threads(threads or max(1, min(
                torch.get_num_threads(), (os.cpu_count() or 1) // world)))
        init_world(rank, world, init_method, device)
        result = fn(rank, *args)
        out_q.put((rank, True, result))
    except BaseException:                      # reported to the parent
        out_q.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, args=(), device="cpu", timeout: float = 600.0,
          threads: int | None = None) -> list:
    """Run ``fn(rank, *args)`` in ``world`` fresh processes that form a
    local world (``spawn`` start method, 127.0.0.1); returns each rank's
    result, in rank order.  A CPU rank runs ``threads`` intra-op threads
    (default: its share of the host's cores, at most what
    ``OMP_NUM_THREADS`` allows).

    ``fn`` and ``args`` are pickled, so ``fn`` must be importable by its
    module path and a result should hold numpy arrays and Python values.
    A rank that raises, or dies, fails the whole world: the others are
    terminated and the rank's traceback raised here.
    """
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    init_method = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(r, world, init_method, device, threads, fn,
                               args, out_q))
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict[int, object] = {}
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    try:
        while len(results) < world:
            try:
                rank, ok, value = out_q.get(timeout=1.0)
            except queue_lib.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank process died with exit code "
                                       f"{dead[0].exitcode}")
                if datetime.datetime.now() > deadline:
                    raise TimeoutError(f"world of {world} did not finish "
                                       f"in {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return [results[r] for r in range(world)]
