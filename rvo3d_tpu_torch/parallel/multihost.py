"""Multi-process start-up (counterpart of rvo3d_tpu/parallel/multihost.py).

Every process runs the same program; `torch.distributed` joins them into
one process group. The coordinator comes from the environment:

  RVO3D_COORDINATOR       host:port of process 0
  RVO3D_NUM_PROCESSES     total process count
  RVO3D_PROCESS_ID        this process's rank
  RVO3D_LOCAL_PROCESSES   ranks on each host (optional; default: all of
                          them on one host). Ranks are numbered host by
                          host, so a rank's index on its host is
                          rank % RVO3D_LOCAL_PROCESSES.

The backend follows the run's device. A CPU run is gloo. A CUDA run is
NCCL when this host has a card for each of its ranks (local rank r then
runs on cuda:r), and gloo when ranks share cards, which NCCL refuses. Every
host must have the same card count and ranks per host, so that all ranks
pick the same backend. A failed start raises.

`start_ranks` starts such a group of processes on this host, each with
its RVO3D_* variables, for a program that needs several ranks in one
call (the entry's sharded dry run, the card checks' parallel phases).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import List, Sequence

import torch
import torch.distributed as dist

# the directory that holds this package: the ranks import it from there
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def local_processes() -> int:
    """The ranks on each host."""
    return int(os.environ.get("RVO3D_LOCAL_PROCESSES", os.environ["RVO3D_NUM_PROCESSES"]))


def local_rank() -> int:
    """This rank's index among the ranks on its host."""
    return int(os.environ["RVO3D_PROCESS_ID"]) % local_processes()


def choose_backend(device, ranks_on_host: int, cards_on_host: int) -> str:
    """nccl for a CUDA run whose host has a card for each of its ranks,
    gloo otherwise."""
    own = torch.device(device).type == "cuda" and cards_on_host >= ranks_on_host
    return "nccl" if own else "gloo"


def distributed_init_from_env(device="cuda") -> bool:
    """Join the process group named by the RVO3D_* variables, with the
    backend for a run on `device`; True when running multi-process
    (already joined counts), False without the variables."""
    addr = os.environ.get("RVO3D_COORDINATOR")
    if not addr:
        return False
    if not dist.is_initialized():
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        dist.init_process_group(choose_backend(device, local_processes(), cards),
                                init_method=f"tcp://{addr}",
                                world_size=int(os.environ["RVO3D_NUM_PROCESSES"]),
                                rank=int(os.environ["RVO3D_PROCESS_ID"]))
    return True


def rank_device(device) -> torch.device:
    """The device this rank runs on: cuda:<local rank> under NCCL, the
    given device otherwise (gloo ranks on one card share it)."""
    dev = torch.device(device)
    if (dev.type == "cuda" and dist.is_initialized()
            and dist.get_backend() == "nccl"):
        return torch.device("cuda", local_rank())
    return dev


def is_coordinator() -> bool:
    """True on the process that writes logs, checkpoints and results."""
    return not dist.is_initialized() or dist.get_rank() == 0


def start_ranks(argv: Sequence[str], n: int, timeout: float) -> List[str]:
    """Run `python argv...` as ranks 0..n-1 of one process group on this
    host (the RVO3D_* variables, the coordinator on a free local port) and
    wait for all of them; returns their logs (stdout and stderr), and
    raises if any rank exits non-zero or outlives `timeout` seconds. Every
    rank that is still running when this returns or raises is killed."""
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    path = os.pathsep.join(p for p in (_PACKAGE_ROOT, os.environ.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen(
        [sys.executable, *argv],
        env=dict(os.environ, PYTHONPATH=path, RVO3D_COORDINATOR=f"127.0.0.1:{port}",
                 RVO3D_NUM_PROCESSES=str(n), RVO3D_PROCESS_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r, (proc, log) in enumerate(zip(procs, logs)):
        if proc.returncode != 0:
            raise RuntimeError(f"rank {r} exited {proc.returncode}:\n{log[-3000:]}")
    return logs
