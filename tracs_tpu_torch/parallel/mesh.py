"""The dp x sp process mesh and its collectives (counterpart of
tracs_tpu/parallel/mesh.py, on torch.distributed).

* ``dp`` — sample blocks: each rank owns a block of samples; in the triangle
  ring the blocks travel around the dp ring (``ppermute``) so that every pair
  of blocks meets once, and in the block sweep each dp rank owns a slab of
  the columns.
* ``sp`` — genome positions: the packed word axis is split over the sp
  ranks; per-pair counts are sums over positions, so the partial grams of
  the sp ranks add up with one ``psum``.

The ranks of a mesh are processes, one card each (PyTorch's idiom), wired by
``torch.distributed.init_process_group`` (parallel/multihost.py), and the
mesh is a ``DeviceMesh`` with dims ``("dp", "sp")`` over the ranks of the
world in dp-major order: rank ``d * sp + s`` holds sample block d and
position shard s.  The mesh must span the whole world.

Transport.  On ``nccl`` a collective's tensors stay on the card.  ``gloo``
moves host memory only (its send and receive take CPU tensors), so on gloo
each collective stages its tensors through the host: one ``.cpu()`` before
and one ``.to(device)`` after.  That is the backend's transport, not a
fallback: it is what lets several ranks share one card (``backend="gloo"``
in ``multihost.initialize``) and what the CPU tests run.

Every setting comes in as an argument, and the planner's constants are the
JAX package's defaults, so its decisions equal tracs_tpu's on every input.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

#: per-rank byte budget of the triangle ring's stripe tensors (m and n gram
#: rows plus the assembled D and NN, each [B, n_pad] int32); tracs_tpu's
#: default.  Shared by the planner and ``allpairs.RingCoo.fits``.
RING_STRIPE_BYTES = 4 << 30

#: thinnest dp stripe, in rows, that the planner takes before it gives ranks
#: to sp instead (tracs_tpu's default): a ring step's work per rotated byte
#: grows with the stripe's rows, so thin stripes cannot hide the rotation
_MIN_STRIPE_ROWS = 512

#: bytes handed to collectives by this process (every psum, ppermute and
#: gather, whatever the backend); ``chip_smoke.py`` reads it to report the
#: traffic of a mesh run
COLLECTIVE_BYTES = 0


def _divisors(n: int) -> list[int]:
    out = set()
    for d in range(1, int(math.isqrt(n)) + 1):
        if n % d == 0:
            out.update((d, n // d))
    return sorted(out)


def best_mesh_shape(n_devices: int, n_samples: int | None = None, n_words: int | None = None):
    """(dp, sp) for ``n_devices`` ranks, by tracs_tpu's rule.

    dp wins by default: the ring's per-rank stripe output scales as n²/dp.
    Ranks go to sp when the stripes would drop below ``_MIN_STRIPE_ROWS``
    rows.  ``n_words`` (ceil(L/32)) caps sp at n_words // 8 (a position shard
    below 8 words is only padding), and shapes whose ring stripes would pass
    ``RING_STRIPE_BYTES`` are avoided when a shape that fits exists."""
    if n_devices <= 1:
        return 1, 1
    if n_samples is None:
        return n_devices, 1
    sp_cap = n_devices
    if n_words is not None:
        sp_cap = max(1, min(sp_cap, n_words // 8))

    def n_pad(dp):
        return -(-max(n_samples, 1) // dp) * dp

    cands = [d for d in _divisors(n_devices) if n_devices // d <= sp_cap]
    feasible = [d for d in cands if 16 * n_pad(d) * (n_pad(d) // d) <= RING_STRIPE_BYTES]
    pool = feasible or cands
    fat = [d for d in pool if -(-n_samples // d) >= _MIN_STRIPE_ROWS]
    dp = max(fat) if fat else min(pool)
    return dp, n_devices // dp


def pad_to(x: int, mult: int) -> int:
    return int(math.ceil(x / mult) * mult)


def world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def check_world(dp: int, sp: int) -> None:
    """Raises unless the world has exactly ``dp * sp`` ranks."""
    n = world()[1]
    if dp * sp != n:
        raise ValueError(f"mesh {dp}x{sp} needs {dp * sp} processes, the world has {n}")


def make_mesh(dp: int, sp: int = 1):
    """A ``DeviceMesh`` of dims ("dp", "sp") over every rank of the world, in
    dp-major order.  Its device type follows the backend: ``cuda`` on nccl,
    ``cpu`` on gloo (where collectives move host memory).  The world must
    hold exactly ``dp * sp`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    check_world(dp, sp)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dp, sp), mesh_dim_names=("dp", "sp"))


def parse_mesh_spec(spec: str | None):
    """``off``, ``auto``, ``global`` or (dp, sp) from a ``--mesh`` value
    (None is ``auto``); raises ValueError for anything else."""
    spec = "auto" if spec is None else spec.strip().lower()
    if spec in ("off", "auto", "global"):
        return spec
    try:
        dp, sp = (int(t) for t in spec.split("x"))
    except ValueError:
        raise ValueError(
            f"invalid mesh spec {spec!r}: expected 'auto', 'off', 'global' or 'DPxSP'"
        ) from None
    return dp, sp


def resolve_mesh(spec: str | None = "auto", *, n_samples: int | None = None,
                 n_words: int | None = None):
    """The mesh of a ``--mesh`` value, or None for one device.

    * ``off``: one device.
    * ``auto`` (the default): this process's own devices, as tracs_tpu does
      under several processes.  A process drives one card, so this is one
      device.
    * ``global``: every rank of the world, shaped by ``best_mesh_shape``
      (pass ``n_samples`` and ``n_words`` of the workload); one device in a
      world of one.
    * ``DPxSP``: that shape over the world, whose size must be dp * sp
      (ValueError otherwise); one device when dp * sp is 1."""
    parsed = parse_mesh_spec(spec)
    if parsed in ("off", "auto"):
        return None
    if parsed == "global":
        n = world()[1]
        return None if n <= 1 else make_mesh(*best_mesh_shape(n, n_samples, n_words))
    dp, sp = parsed
    if dp * sp <= 1:
        return None
    return make_mesh(dp, sp)


# ---------------------------------------------------------------------------
# collectives of the sweep engines
# ---------------------------------------------------------------------------


def _on_host(group) -> bool:
    """Whether the group's backend moves host memory (gloo)."""
    return dist.get_backend(group) == "gloo"


def _count(*tensors) -> None:
    global COLLECTIVE_BYTES
    COLLECTIVE_BYTES += sum(t.numel() * t.element_size() for t in tensors)


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group``, on ``t``'s device."""
    _count(t)
    if _on_host(group):
        h = t.cpu()
        dist.all_reduce(h, group=group)
        return h.to(t.device)
    t = t.contiguous()
    dist.all_reduce(t, group=group)
    return t


def ppermute(tensors, group, shift: int) -> list[torch.Tensor]:
    """Each rank of ``group`` sends ``tensors`` to the rank ``shift`` places
    after it (group order, modulo the group's size) and receives the same
    shapes from the rank ``shift`` places before it; one
    ``batch_isend_irecv``, so no pairing of sends and receives can block."""
    ranks = dist.get_process_group_ranks(group)
    n, me = len(ranks), dist.get_rank(group)
    to, frm = ranks[(me + shift) % n], ranks[(me - shift) % n]
    host = _on_host(group)
    send = [(t.cpu() if host else t).contiguous() for t in tensors]
    recv = [torch.empty_like(t) for t in send]
    _count(*send)
    ops = [dist.P2POp(dist.isend, t, to, group=group) for t in send]
    ops += [dist.P2POp(dist.irecv, t, frm, group=group) for t in recv]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [r.to(t.device) for r, t in zip(recv, tensors)] if host else recv


def all_gather_rows(x: np.ndarray, group, device: torch.device) -> list[np.ndarray]:
    """Every rank's ``x`` ([k, ...], k free to differ between ranks), in
    group order, on every rank: the row counts first, then the arrays padded
    to the largest count."""
    host = _on_host(group)
    dev = torch.device("cpu") if host else device
    n = dist.get_world_size(group)
    size = torch.tensor([x.shape[0]], dtype=torch.int64, device=dev)
    sizes = [torch.empty_like(size) for _ in range(n)]
    _count(size)
    dist.all_gather(sizes, size, group=group)
    sizes = [int(s) for s in sizes]
    padded = np.zeros((max(sizes), *x.shape[1:]), dtype=x.dtype)
    padded[: x.shape[0]] = x
    mine = torch.from_numpy(padded).to(dev)
    parts = [torch.empty_like(mine) for _ in range(n)]
    _count(mine)
    dist.all_gather(parts, mine, group=group)
    return [p.cpu().numpy()[:k] for p, k in zip(parts, sizes)]
