"""One tile block per process: the tile mesh over ``torch.distributed``.

The reference runs the per-device program of ``shard_map`` on every device
of an (n, m) mesh, one tile each, and crosses devices with ``lax.ppermute``
(the halo strips) and ``lax.psum`` (BN statistics, the batch-end gradient
sum).  This is PyTorch's multi-controller counterpart: W processes (ranks),
each running the same program on a *block* of the n x m tile grid.  The
rank grid is (Rr, Rc) with n % Rr == m % Rc == 0 and W = Rr * Rc
(``rank_grid``); rank r = pr * Rc + pc holds tiles ``[pr*n/Rr, (pr+1)*n/Rr)
x [pc*m/Rc, (pc+1)*m/Rc)``.  W = n*m is the reference's one tile per
device; W = 1 is the virtual mesh of ``launch/mesh.py``, bit for bit.

- ``permute`` is ``ppermute`` by a shift along tile dimension 0 or 1: the
  block's own tiles shift locally, the edge tiles that leave it go to the
  neighbour rank and the neighbour's arrive, in one
  ``dist.batch_isend_irecv``.  A rank with no neighbour on that side
  receives zeros (SAME padding, as ``ppermute`` delivers).  Its backward is
  the reverse permute of the cotangent: ``ppermute``'s transpose.
- ``all_reduce_sum`` is ``psum``; its backward all-reduces the cotangent.
- ``replicated`` is the identity on a value every rank holds alike (the
  params); its backward all-reduces the gradient, so a loss that each rank
  evaluates on its own block differentiates to the global gradient.

Backends: ``nccl`` by default on CUDA, ``gloo`` on the CPU.  ``gloo`` on
CUDA runs only when named, and stages every strip and sum through pinned
host memory (gloo moves CPU tensors only); it lets several ranks share one
card.  ``nccl`` with more ranks on a host than cards raises.  Nothing
switches backend or device by itself (``resolve_backend``).

Every collective a rank issues is counted in ``TileGroup.record`` by its
``Collective`` (the reference's HLO names: ``collective-permute``,
``all-reduce``, ``all-gather``), which ``analysis/collectives.py`` turns
into the reference's ``CollectiveStats``; a count per distinct collective
keeps a long run's record the size of one step's.

``init_tile_group`` joins the group torchrun describes (``env://``);
``run_ranks`` spawns the ranks itself on one host with a ``file://`` store
(no port to race for), for the tests and ``chip_smoke.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import multiprocessing
import os
import pickle
import queue
import tempfile
import threading
import time
import traceback
from collections import Counter
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


class Collective(NamedTuple):
    """One collective a rank issued: its kind (the reference's HLO name),
    the payload bytes as the reference's ``collective_stats`` counts them
    (a permute's strip, a sum's result, a gather's result) and the group
    size."""

    kind: str
    nbytes: int
    group: int


@dataclasses.dataclass(eq=False)
class TileGroup:
    """A rank's membership of the process group: its rank, the world size,
    the backend, the device its tensors live on, and the record of every
    collective it issued since the last ``take_record`` (how many times
    each distinct one ran)."""

    rank: int
    world: int
    backend: str
    device: torch.device
    record: Counter = dataclasses.field(default_factory=Counter)

    @property
    def staged(self) -> bool:
        """gloo on a card: strips and sums go through pinned host memory."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def take_record(self) -> Counter:
        """The collectives recorded so far, and an empty record after."""
        out, self.record = self.record, Counter()
        return out


def resolve_backend(device, backend: str | None = None, local_world: int = 1,
                    cards: int | None = None) -> str:
    """The backend rule: ``nccl`` on CUDA and ``gloo`` on the CPU unless
    one is named; ``nccl`` only on CUDA and with no more ranks on the host
    (``local_world``) than cards; ``gloo`` on CUDA only when named."""
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("nccl moves CUDA tensors only; the CPU takes backend='gloo'")
        cards = torch.cuda.device_count() if cards is None else cards
        if local_world > cards:
            raise ValueError(
                f"nccl runs one rank a card: {local_world} ranks on this host, {cards} "
                "card(s); name backend='gloo' to share the cards through host memory")
    return backend


def rank_grid(n: int, m: int, world: int) -> tuple[int, int]:
    """The (Rr, Rc) rank grid of ``world`` ranks over an n x m tile grid:
    equal blocks (n % Rr == m % Rc == 0), the squarest one, rows first on a
    tie."""
    best = None
    for rr in range(1, n + 1):
        if n % rr or world % rr or m % (world // rr):
            continue
        key = (abs(rr - world // rr), -rr)
        if best is None or key < best[0]:
            best = (key, (rr, world // rr))
    if best is None:
        raise ValueError(f"{world} ranks do not split the {n}x{m} tile grid into equal blocks")
    return best[1]


def _init(rank: int, world: int, local_rank: int, local_world: int, device, backend,
          init_method: str, timeout: float) -> TileGroup:
    from repro_torch.launch.mesh import resolve_device

    dev = resolve_device(device)
    backend = resolve_backend(dev, backend, local_world)
    if dev.type == "cuda":
        # nccl: one card a rank; gloo (named): ranks share the cards in turn
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout),
                            device_id=dev if backend == "nccl" else None)
    group = TileGroup(rank, world, backend, dev)
    # every rank takes part in the group's first collective (a later
    # permute may leave edge ranks out)
    _all_reduce_(group, torch.zeros(1, device=dev))
    group.record.clear()
    return group


def init_tile_group(device="cuda", backend: str | None = None,
                    timeout: float = 1800.0) -> TileGroup:
    """Join the process group torchrun describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``; ``env://``).  Raises when they are
    missing: a run on ranks is started by torchrun."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"no torchrun environment ({', '.join(missing)} unset): start a run on ranks as "
            "torchrun --nproc-per-node <W> -m repro_torch.launch.train --dist ...")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return _init(rank, world, local, local_world, device, backend, "env://", timeout)


# ---------------------------------------------------------------------------
# Spawning ranks on one host (tests, chip_smoke.py)
# ---------------------------------------------------------------------------


def _rank_main(rank, world, store, device, backend, timeout, fn, args, results):
    try:
        # one host: the group's sockets stay on the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        group = _init(rank, world, rank, world, device, backend, store, timeout)
        try:
            out = fn(group, *args)
        finally:
            dist.destroy_process_group()
        # pickled here: the queue's own pickler would share a tensor's
        # storage through a file descriptor that dies with this process
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, device="cuda", backend: str | None = None, *,
              args: tuple = (), timeout: float = 600.0) -> list:
    """Run ``fn(group, *args)`` on ``world`` spawned ranks of one host and
    return their results in rank order.  The ranks run on the card unless
    ``device`` asks for the CPU (``launch.mesh.resolve_device``: no card
    raises in every rank).  The ranks meet through a
    ``file://`` store in a fresh temporary directory.  ``fn`` and
    ``args`` are pickled (a module-level function); so is each result
    (return CPU tensors, arrays or plain values).  A rank that raises or
    dies, or a run past ``timeout`` seconds, raises here with the rank's
    traceback; every rank is ended before this returns."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    got: dict[int, tuple[bool, Any]] = {}
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        store = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, store, device, backend, timeout, fn, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline, dead_since = time.monotonic() + timeout, None
        try:
            while len(got) < world:
                try:
                    rank, ok, out = results.get(timeout=0.5)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if r not in got
                            and p.exitcode is not None]
                    # a rank's result may still be on its way as it exits
                    dead_since = (dead_since or time.monotonic()) if dead else None
                    if dead and time.monotonic() - dead_since > 5.0:
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} and no result") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"ranks {sorted(set(range(world)) - set(got))} gave "
                                           f"no result in {timeout} s") from None
                    continue
                got[rank] = (ok, pickle.loads(out) if ok else out)
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{out}")
        finally:
            for p in procs:
                p.join(timeout=30 if len(got) == world else 0.1)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r][1] for r in range(world)]


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a card's tensor (gloo moves CPU tensors)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return h.copy_(t)


def _all_reduce_(group: TileGroup, t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place."""
    group.record[Collective("all-reduce", _nbytes(t), group.world)] += 1
    if group.staged:
        h = _host(t)
        dist.all_reduce(h)
        return t.copy_(h)
    dist.all_reduce(t)
    return t


def all_reduce_(group: TileGroup, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """Sum every tensor of the list over the ranks with one collective per
    dtype (the tensors flattened into one buffer and back); returns new
    tensors of the same shapes.  Not differentiated: the batch-end
    reduction of accumulated gradients, a loss sum, a count."""
    out: list = [None] * len(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = _all_reduce_(group, torch.cat([tensors[i].reshape(-1) for i in idx]))
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out


class _AllReduceSum(torch.autograd.Function):
    """``psum``: the sum over the ranks; the backward sums the cotangent."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce_(group, t.clone())

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(ctx.group, g.clone()), None


def all_reduce_sum(t: torch.Tensor, group: TileGroup) -> torch.Tensor:
    return _AllReduceSum.apply(t, group)


class _Replicated(torch.autograd.Function):
    """Identity on a value every rank holds alike; the backward sums the
    gradient over the ranks."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(ctx.group, g.clone()), None


def replicated(t: torch.Tensor, group: TileGroup) -> torch.Tensor:
    return _Replicated.apply(t, group)


def broadcast_(group: TileGroup, tensors) -> None:
    """Make every rank's tensors equal rank 0's, in place."""
    for t in tensors:
        if group.staged:
            h = _host(t)
            dist.broadcast(h, 0)
            t.copy_(h)
        else:
            dist.broadcast(t, 0)


def all_gather_blocks(group: TileGroup, block: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's ``block`` (equal shapes), in rank order.  Not
    differentiated (outputs)."""
    group.record[Collective("all-gather", _nbytes(block) * group.world, group.world)] += 1
    src = _host(block) if group.staged else block.contiguous()
    parts = [torch.empty_like(src) for _ in range(group.world)]
    dist.all_gather(parts, src)
    return [p.to(group.device) for p in parts] if group.staged else parts


def _sendrecv(group: TileGroup, send: torch.Tensor, dst: int | None,
              src: int | None) -> torch.Tensor | None:
    """Send ``send`` to rank ``dst`` and receive a tensor of its shape from
    rank ``src`` (either may be None), in one batch."""
    s = _host(send) if group.staged else send.contiguous()
    ops, recv = [], None
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, s, dst))
    if src is not None:
        recv = torch.empty(s.shape, dtype=s.dtype, device=s.device, pin_memory=group.staged)
        ops.append(dist.P2POp(dist.irecv, recv, src))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if recv is not None and group.staged:
        recv = recv.to(group.device)
    return recv


def _permute(x: torch.Tensor, dim: int, shift: int, mesh) -> torch.Tensor:
    size, k = x.shape[dim], abs(shift)
    if k == 0 or k > size:
        raise ValueError(
            f"a permute by {shift} tiles along a block of {size}: a rank's block exchanges "
            "with its neighbour ranks only (pipeline hand-offs on ranks are ROADMAP A.20.2)")
    step = 1 if shift > 0 else -1
    send = x.narrow(dim, size - k, k) if shift > 0 else x.narrow(dim, 0, k)
    dst, src = mesh.neighbour(dim, step), mesh.neighbour(dim, -step)
    group = mesh.group
    group.record[Collective("collective-permute", _nbytes(send), 2)] += 1
    recv = _sendrecv(group, send, dst, src)
    land = recv if recv is not None else torch.zeros_like(send)
    if shift > 0:
        return torch.cat([land, x.narrow(dim, 0, size - k)], dim=dim)
    return torch.cat([x.narrow(dim, k, size - k), land], dim=dim)


class _Permute(torch.autograd.Function):
    """``ppermute`` by ``shift`` tiles along tile dimension ``dim`` of a
    rank's block; the backward permutes the cotangent back."""

    @staticmethod
    def forward(ctx, x, dim, shift, mesh):
        ctx.meta = (dim, shift, mesh)
        return _permute(x, dim, shift, mesh)

    @staticmethod
    def backward(ctx, g):
        dim, shift, mesh = ctx.meta
        return _permute(g, dim, -shift, mesh), None, None, None


def permute(x: torch.Tensor, dim: int, shift, mesh) -> torch.Tensor:
    """``ppermute`` of the blocks ``x`` = (bn, bm, ...) of ``mesh`` (a
    ``launch.mesh.DistTileMesh``) by ``shift`` tiles along tile dimension
    ``dim`` (0 rows, 1 columns): tile j receives tile j - shift's data,
    zeros where the grid has no such tile."""
    if shift == "swap" or dim not in (0, 1):
        raise ValueError(
            f"permute {shift!r} along dimension {dim}: ranks run the sync exchange's neighbour "
            "shifts along the tile grid (the overlap schedule's packed swap is ROADMAP A.20.2)")
    return _Permute.apply(x, dim, shift, mesh)


# ---------------------------------------------------------------------------
# The active mesh (read by the exchange, BN and the off-map mask)
# ---------------------------------------------------------------------------


class _Active(threading.local):
    def __init__(self):
        self.mesh = None


_ACTIVE = _Active()


@contextlib.contextmanager
def tile_mesh_ctx(mesh):
    """Install ``mesh`` (a ``DistTileMesh``, or None for the virtual mesh)
    for the executor code this thread runs, and restore the previous one
    on exit.  The autograd functions above keep their mesh or group, so a
    backward on another thread needs no context."""
    prev, _ACTIVE.mesh = _ACTIVE.mesh, mesh
    try:
        yield
    finally:
        _ACTIVE.mesh = prev


def active_tile_mesh():
    return _ACTIVE.mesh
