"""Multi-process set-up (counterpart of tracs_tpu/parallel/multihost.py, on
torch.distributed).

One process drives one card.  Every process runs the same program; the
process group wires them together and ``global_mesh`` lays a dp x sp mesh
over all of them.  Launch, once per process (the ``distance`` and ``pipe``
subcommands take the same three flags):

    python -m tracs_tpu_torch distance --coordinator host0:29500 \\
        --num-processes 4 --process-id $RANK --mesh global ...

or from Python::

    from tracs_tpu_torch.parallel.multihost import initialize, global_mesh
    initialize("host0:29500", 4, rank, device="cuda")
    mesh = global_mesh(sp=2)

Everything comes in as arguments, the launch flags included.
"""

from __future__ import annotations

import argparse
import logging
from datetime import timedelta

import torch
import torch.distributed as dist

from tracs_tpu_torch.parallel.mesh import make_mesh, world
from tracs_tpu_torch.runtime.device import resolve_device

#: how long a collective waits for the other ranks before it fails the run
#: (gloo's own default is 30 minutes): a lost rank ends the run, it does not
#: hang it
DEFAULT_TIMEOUT = timedelta(minutes=10)


def init_group(coordinator: str, num_processes: int, process_id: int, *, device,
               backend: str | None = None, timeout: timedelta = DEFAULT_TIMEOUT) -> None:
    """Set up the default process group of ``num_processes`` ranks, this one
    ``process_id``, whatever the world's size.  ``coordinator`` is rank 0's
    ``HOST:PORT`` (a TCP rendezvous) or an ``init_method`` URL such as
    ``file:///shared/path``.  ``backend`` None is ``nccl`` for a CUDA device
    and ``gloo`` for the CPU; ``gloo`` on CUDA lets several ranks share one
    card.  On CUDA, rank r drives ``cuda:{r % device_count}``."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id, timeout=timeout)
    logging.info("process group up: rank %d of %d, %s", process_id, num_processes, backend)


def initialize(coordinator: str | None, num_processes: int | None, process_id: int | None,
               *, device, backend: str | None = None,
               timeout: timedelta = DEFAULT_TIMEOUT) -> bool:
    """Set up the process group (``init_group``) and return True; False, with
    nothing done, when a group is up already (it is used as it is) or when
    there is one process or no coordinator."""
    if dist.is_initialized():
        return False
    if not coordinator or num_processes is None or num_processes <= 1:
        return False
    if process_id is None:
        raise ValueError("a multi-process launch needs the process id of this process")
    init_group(coordinator, num_processes, process_id, device=device, backend=backend,
               timeout=timeout)
    return True


def global_mesh(sp: int = 1):
    """A dp x sp mesh over every rank of the world."""
    n = world()[1]
    if n % sp:
        raise ValueError(f"{n} processes not divisible by sp={sp}")
    return make_mesh(n // sp, sp)


def add_launch_args(parser) -> None:
    """``--coordinator``, ``--num-processes`` and ``--process-id`` on a stage."""
    launch = parser.add_argument_group("Multi-process launch (one process per card)")
    launch.add_argument(
        "--coordinator", dest="coordinator", default=None,
        help="HOST:PORT of rank 0's rendezvous (or an init_method URL such as "
             "file:///shared/path); every process of the run gets the same value",
    )
    launch.add_argument(
        "--num-processes", dest="num_processes", type=int, default=None,
        help="number of processes of the run (default: one, no process group)",
    )
    launch.add_argument(
        "--process-id", dest="process_id", type=int, default=None,
        help="rank of this process, 0 .. num-processes - 1",
    )


def launch(args: argparse.Namespace) -> bool:
    """``initialize`` from a stage's launch flags and ``--device``."""
    return initialize(getattr(args, "coordinator", None), getattr(args, "num_processes", None),
                      getattr(args, "process_id", None), device=args.device)
