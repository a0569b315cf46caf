"""Starting the ranks of a (data × model) group (twin of
``repro.launch.mesh``).

Two ways in, both ending in :func:`init_rank` and a
:class:`~repro_torch.sharding.MeshInfo`:

  * one host: :func:`spawn_group` (or :func:`start_group`, which does
    not wait) starts D × M processes itself
    (``torch.multiprocessing``, a ``file://`` rendezvous in a fresh
    temporary directory), runs ``fn(mesh_info, device, *args)`` on each and
    returns what each rank returned, in rank order; a rank that raises
    fails the call and ends the others;
  * several hosts: every process calls :func:`init_rank` with the
    coordinator's ``HOST:PORT`` (``tcp://``), the number of processes and
    its own index (``--coordinator``, ``--num-hosts``, ``--host-id``: one
    rank a process).

The backend is chosen, never guessed: ``nccl`` needs a CUDA device for
every rank of a host and raises otherwise; ``gloo`` runs CPU tensors and
CUDA tensors, and only under ``gloo`` may ranks share a card (rank r of a
host on ``cuda:(r mod cards)``).
"""
from __future__ import annotations

import argparse
import datetime
import os
import pathlib
import tempfile
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..sharding import MeshInfo

__all__ = ["BACKENDS", "GroupRun", "add_distributed_cli_args",
           "check_distributed_args", "default_backend", "engine_flags_set",
           "rank_device", "init_rank", "start_group", "spawn_group"]

BACKENDS = ("nccl", "gloo")
TIMEOUT_S = 900


def add_distributed_cli_args(ap) -> None:
    """Group and multi-host flags, shared by the launchers."""
    g = ap.add_argument_group("group of ranks")
    g.add_argument("--data-axis", type=int, default=0,
                   help="rows of the group (0: one device, no group)")
    g.add_argument("--model-axis", type=int, default=1,
                   help="columns of the group")
    g.add_argument("--backend", choices=BACKENDS, default=None,
                   help="torch.distributed backend (default: nccl on CUDA, "
                        "gloo on the CPU); ranks share a card only under "
                        "gloo")
    g.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="rendezvous address of a multi-host group (required "
                        "when --num-hosts > 1)")
    g.add_argument("--num-hosts", type=int, default=1,
                   help="processes of a multi-host group, one rank each "
                        "(default 1: this host spawns the group's ranks)")
    g.add_argument("--host-id", type=int, default=0,
                   help="this process's rank in [0, --num-hosts)")


def check_distributed_args(args) -> Optional[str]:
    """The flags' error, or None: a multi-host group needs a coordinator,
    a host id inside it, and one process for every rank."""
    if args.num_hosts < 1:
        return f"--num-hosts must be >= 1, got {args.num_hosts}"
    if not 0 <= args.host_id < args.num_hosts:
        return (f"--host-id {args.host_id} outside [0, --num-hosts "
                f"{args.num_hosts})")
    if args.data_axis < 0 or args.model_axis < 1:
        return (f"--data-axis {args.data_axis} / --model-axis "
                f"{args.model_axis}: a group has at least one row and one "
                f"column")
    if args.num_hosts == 1:
        if args.coordinator is not None:
            return "--coordinator is only meaningful with --num-hosts > 1"
        return None
    if not args.coordinator:
        return "--num-hosts > 1 needs --coordinator HOST:PORT"
    if args.data_axis * args.model_axis != args.num_hosts:
        return (f"a {args.data_axis} x {args.model_axis} group over "
                f"{args.num_hosts} hosts: one rank a process, so --num-hosts "
                f"must be {max(args.data_axis, 1) * args.model_axis}")
    return None


def engine_flags_set(args, keep=()) -> list:
    """The ``RuntimeConfig`` flags given other than their defaults, apart
    from ``keep`` (names like "remat"), as "--flag" strings: what one
    device refuses, having no group's MoE layers to steer."""
    from ..engine import RuntimeConfig
    ap = argparse.ArgumentParser()
    RuntimeConfig.add_cli_args(ap)
    default = vars(ap.parse_args([]))
    return sorted("--" + k.replace("_", "-") for k, v in default.items()
                  if k not in keep and getattr(args, k) != v)


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(backend: str, device, local_rank: int,
                local_ranks: int) -> torch.device:
    """The device of a host's ``local_rank``-th of ``local_ranks`` ranks:
    the CPU, or a card; raises where ``backend`` cannot run them."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}; choose one of "
                         f"{', '.join(BACKENDS)}")
    device = torch.device(device)
    if device.type == "cpu":
        if backend == "nccl":
            raise ValueError("backend nccl runs CUDA tensors only; use "
                             "--backend gloo for a group on the CPU")
        return device
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards == 0 or (backend == "nccl" and cards < local_ranks):
        hint = ("nccl needs a card for each rank; --backend gloo lets ranks "
                "share cards" if cards else
                "pass device 'cpu' with --backend gloo to run on the CPU")
        raise RuntimeError(
            f"backend {backend} on CUDA: {local_ranks} rank(s) on this host, "
            f"{cards} CUDA device(s) ({hint})")
    return torch.device("cuda", local_rank % cards)


def init_rank(rank: int, world: int, init_method: str, backend: str,
              device, data: int, model: int, local_rank: Optional[int] = None,
              local_ranks: Optional[int] = None):
    """Join the group as ``rank`` of ``world`` -> (MeshInfo, device).  The
    rank's device becomes CUDA's current device."""
    local_rank = rank if local_rank is None else local_rank
    local_ranks = world if local_ranks is None else local_ranks
    dev = rank_device(backend, device, local_rank, local_ranks)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return MeshInfo.build(data, model), dev


def _rank_main(rank: int, fn: Callable, args: Sequence[Any], world: int,
               store: str, out_dir: str, backend: str, device, data: int,
               model: int) -> None:
    mi, dev = init_rank(rank, world, f"file://{store}", backend, device,
                        data, model)
    try:
        result = fn(mi, dev, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


class GroupRun:
    """D × M ranks started by :func:`start_group`; :meth:`results` waits
    for them."""

    def __init__(self, ctx, tmp: tempfile.TemporaryDirectory, world: int):
        self._ctx, self._tmp, self._world = ctx, tmp, world

    def results(self) -> List[Any]:
        """The ranks' return values in rank order; raises when a rank
        raised (the others are then ended)."""
        try:
            while not self._ctx.join():
                pass
            return [torch.load(pathlib.Path(self._tmp.name) / f"rank{r}.pt",
                               weights_only=False)
                    for r in range(self._world)]
        finally:
            self._tmp.cleanup()


def start_group(fn: Callable, args: Sequence[Any] = (), data: int = 1,
                model: int = 1, backend: str = "gloo",
                device="cpu") -> GroupRun:
    """Start ``fn(mesh_info, device, *args)`` on each of D × M new
    processes of this host and return at once.  ``fn`` must be importable
    by name (a module's top-level function); each rank's return value is
    saved with ``torch.save``."""
    world = data * model
    rank_device(backend, device, world - 1, world)      # refuse early
    tmp = tempfile.TemporaryDirectory(prefix="repro_group_")
    store = os.path.join(tmp.name, "store")
    ctx = mp.start_processes(
        _rank_main, args=(fn, tuple(args), world, store, tmp.name, backend,
                          str(device), data, model),
        nprocs=world, join=False, start_method="spawn")
    return GroupRun(ctx, tmp, world)


def spawn_group(fn: Callable, args: Sequence[Any] = (), data: int = 1,
                model: int = 1, backend: str = "gloo",
                device="cpu") -> List[Any]:
    """:func:`start_group` and wait: the ranks' return values, in rank
    order.  Raises when a rank raises."""
    return start_group(fn, args, data, model, backend, device).results()
