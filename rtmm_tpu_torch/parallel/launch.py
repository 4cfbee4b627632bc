"""Start a world of ranks on this host, with a time limit.

    results = spawn(fn, world_size, device_type="cuda", args=(...,))

runs fn(*args) in world_size fresh processes (the spawn start method:
each child imports torch and this package, nothing of its parent's
__main__ beyond what multiprocessing re-runs), each after
torch.distributed.init_process_group over tcp://127.0.0.1:<free port>,
and returns the list of the ranks' return values, rank 0 first. fn must
be importable by module path (a function of this package), and its
arguments and return value picklable; pass NumPy arrays rather than
tensors, so that nothing rides on shared memory.

The backend is chosen from what the ranks own, never after a failure
(choose_backend): NCCL when every rank has a card of its own, gloo when
ranks share a card or run on the CPU; NCCL with more ranks than cards
raises. A rank that raises makes spawn raise with its traceback (the
other ranks are terminated); a world that is still running after
timeout_s seconds is killed and spawn raises TimeoutError. Every rank
passes the same limit to init_process_group, so a collective whose peer
died fails instead of hanging.
"""
from __future__ import annotations

import datetime
import socket
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEFAULT_TIMEOUT_S = 120.0


def choose_backend(world_size: int, device_type: str,
                   backend: str | None = None) -> str:
    """The process-group backend for world_size ranks on device_type.

    "nccl" when device_type is "cuda" and every rank owns a card of its
    own; "gloo" when ranks share a card or run on the CPU. An explicit
    backend is checked against the same rule: NCCL refuses two ranks on
    one card, and does not run on the CPU."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type is 'cuda' or 'cpu', not "
                         f"{device_type!r}")
    if backend is None:
        if device_type == "cuda" and world_size <= torch.cuda.device_count():
            return "nccl"
        return "gloo"
    if backend == "nccl":
        if device_type != "cuda":
            raise ValueError("NCCL runs on CUDA devices only")
        if world_size > torch.cuda.device_count():
            raise ValueError(
                f"NCCL needs a card per rank: {world_size} ranks, "
                f"{torch.cuda.device_count()} cards")
    elif backend != "gloo":
        raise ValueError(f"backend is 'nccl' or 'gloo', not {backend!r}")
    return backend


def rank_device(rank: int, device_type: str) -> torch.device:
    """The device of a rank: card rank % cards (ranks share cards when
    there are fewer cards than ranks), or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world_size, port, backend, device_type, timeout_s, fn,
               args, results):
    torch.set_num_threads(1)
    device = rank_device(rank, device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}",
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
        device_id=device if backend == "nccl" else None)
    try:
        out = fn(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    results.put((rank, out))


def spawn(fn, world_size: int, device_type: str = "cuda", args=(),
          timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run fn(*args) on world_size ranks, over choose_backend's backend;
    returns their results by rank.

    Raises what a rank raised (torch.multiprocessing's
    ProcessRaisedException, with the rank's traceback), or TimeoutError
    when the world has not ended after timeout_s seconds."""
    backend = choose_backend(world_size, device_type)
    results = mp.get_context("spawn").SimpleQueue()
    ctx = mp.spawn(_rank_main, nprocs=world_size, join=False,
                   args=(world_size, _free_port(), backend, device_type,
                         timeout_s, fn, args, results))
    got = {}
    deadline = time.monotonic() + timeout_s
    try:
        while True:
            # Drain before joining: a rank blocks in put() until its
            # result is read.
            while not results.empty():
                rank, out = results.get()
                got[rank] = out
            if ctx.join(timeout=0.2):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{world_size} ranks still running after {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    while not results.empty():
        rank, out = results.get()
        got[rank] = out
    missing = sorted(set(range(world_size)) - set(got))
    if missing:
        raise RuntimeError(f"ranks {missing} ended without a result")
    return [got[r] for r in range(world_size)]

