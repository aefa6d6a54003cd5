"""Joining and starting the ranks of a multi-process render.

Port of `yart_tpu/parallel/distributed.py`. The JAX package wires hosts
into one device mesh; here every rank is a process with one device of its
own, and the ranks share nothing but torch.distributed collectives: NCCL
between CUDA ranks, gloo between CPU ranks. A caller may ask for gloo on
CUDA ranks; its collectives then run on host copies (`sharding.py`), and
ranks beyond the host's cards share them round-robin. NCCL refuses two
ranks on one card, so a NCCL group with more ranks on a host than the host
has cards raises before it joins, naming the count and `backend="gloo"`.
No rank falls back to the CPU: a CUDA rank without a card raises.

    init_distributed()            # a no-op in one process; torchrun's env
    dev = rank_device("cuda")     # cuda:LOCAL_RANK (the current device)

    spawn(fn, 2, args, device="cpu")   # two local ranks, each running
                                       # fn(rank, *args) in its group
"""

from __future__ import annotations

import datetime
import os
import socket
import time

import torch
import torch.distributed as dist

# How long a collective waits for the other ranks before it fails.
TIMEOUT = datetime.timedelta(minutes=10)

# This process's rank on its host, and whether init_distributed made its group.
_LOCAL = {"rank": 0, "owned": False}


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks in the group; 1 when no group was joined."""
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def default_backend(device) -> str:
    """NCCL for CUDA ranks, gloo for CPU ranks."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(backend: str, device, local_world: int) -> None:
    """Raise for a group that cannot run: CUDA ranks without a card, NCCL on
    CPU ranks, or more NCCL ranks on this host than it has cards."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA ranks requested but no CUDA device is available "
                           "(torch.cuda.is_available() is False); pass device='cpu' for CPU ranks on gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"backend='nccl' needs CUDA ranks, not {dev.type!r} ones; CPU ranks use gloo")
    if backend == "nccl" and local_world > torch.cuda.device_count():
        raise RuntimeError(
            f"{local_world} NCCL ranks on a host with {torch.cuda.device_count()} CUDA device(s): NCCL "
            "refuses two ranks on one card; start at most one rank a card, or pass backend='gloo' to "
            "let ranks share a card")


def rank_device(device="cuda") -> torch.device:
    """This rank's device: the CPU for CPU ranks; for CUDA ranks card
    LOCAL_RANK (round-robin over the cards when gloo lets ranks share
    them)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("CUDA ranks requested but no CUDA device is available")
    return torch.device("cuda", _LOCAL["rank"] % n)


def init_distributed(init_method=None, world_size=None, rank=None, backend=None, device="cuda") -> bool:
    """Join a process group; True when it holds more than one rank.

    In one process (no arguments and no torchrun environment) this is a
    no-op that returns False. With torchrun's RANK / WORLD_SIZE /
    LOCAL_RANK / LOCAL_WORLD_SIZE / MASTER_ADDR / MASTER_PORT set, it joins
    their group. An explicit spec (`init_method`, e.g.
    "tcp://127.0.0.1:29500", with `world_size` and `rank`, the ranks on
    one host) that fails raises, as does a group that cannot run
    (`check_backend`). `backend` defaults to NCCL for CUDA ranks and gloo
    for CPU ranks; a CUDA rank's card becomes the current device."""
    if is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if init_method is None and world_size is None:
        if not all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
            return False
        init_method, world_size, rank = "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
        local_rank = int(env.get("LOCAL_RANK", rank))
        local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    else:
        if init_method is None or world_size is None or rank is None:
            raise ValueError("an explicit group needs init_method, world_size and rank")
        local_rank, local_world = int(rank), int(world_size)
    backend = backend or default_backend(device)
    check_backend(backend, device, local_world)
    _LOCAL["rank"] = local_rank
    kw = {}
    if torch.device(device).type == "cuda":
        dev = rank_device(device)
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev  # the communicator comes up here: a failed init raises here
    dist.init_process_group(backend, init_method=init_method, world_size=int(world_size), rank=int(rank),
                            timeout=TIMEOUT, **kw)
    _LOCAL["owned"] = True
    return dist.get_world_size() > 1


def shutdown() -> None:
    """Leave the group that init_distributed joined (a no-op otherwise)."""
    if _LOCAL["owned"] and is_initialized():
        dist.destroy_process_group()
    _LOCAL.update(rank=0, owned=False)


def local_lane_slice(n_lanes: int) -> slice:
    """The contiguous lane range this rank owns under an even split."""
    p, i = world_size(), rank()
    per = -(-n_lanes // p)
    return slice(min(i * per, n_lanes), min((i + 1) * per, n_lanes))


def free_port() -> int:
    """A free TCP port on the loopback interface, for a local rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank, world, init_method, backend, device, fn, args):
    init_distributed(init_method, world, rank, backend, device)
    try:
        fn(rank, *args)
    finally:
        shutdown()


def start_ranks(fn, world: int, ranks, init_method: str, device="cuda", backend=None, args=()):
    """Start `ranks` of a `world`-rank group on this host, each a spawned
    process that joins the group at `init_method` and runs fn(rank,
    *args) (fn and args must pickle). Returns the started processes."""
    backend = backend or default_backend(device)
    check_backend(backend, device, world)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = []
    try:
        for r in ranks:
            p = ctx.Process(target=_rank_entry, args=(r, world, init_method, backend, device, fn, args),
                            name=f"rank{r}")
            p.start()
            procs.append((r, p))
    except BaseException:
        stop_ranks(procs)
        raise
    return procs


def stop_ranks(procs) -> None:
    """Terminate the processes of `start_ranks` that still run, and reap them."""
    for _, p in procs:
        if p.is_alive():
            p.terminate()
    for _, p in procs:
        p.join(timeout=30)
        if p.is_alive():
            p.kill()
            p.join()


def join_ranks(procs) -> None:
    """Wait for the processes of `start_ranks`; the first that fails stops
    the others and raises, naming its rank and exit code."""
    try:
        while True:
            for r, p in procs:
                if p.exitcode not in (None, 0):
                    raise RuntimeError(f"rank {r} exited with code {p.exitcode}")
            if all(p.exitcode == 0 for _, p in procs):
                return
            time.sleep(0.05)
    finally:
        stop_ranks(procs)


def spawn(fn, world: int, args=(), device="cuda", backend=None) -> None:
    """Run fn(rank, *args) in `world` new local processes joined in one
    group over a loopback rendezvous; raises if any of them fails."""
    join_ranks(start_ranks(fn, world, range(world), f"tcp://127.0.0.1:{free_port()}", device, backend, args))
