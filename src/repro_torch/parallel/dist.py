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

- ``permute_start`` is ``ppermute`` by a shift along tile dimension 0 or 1: the
  block's own tiles shift locally, the edge tiles that leave it go to the
  neighbour rank and the neighbour's arrive, in one
  ``dist.batch_isend_irecv``.  A rank with no neighbour on that side
  receives zeros (SAME padding, as ``ppermute`` delivers).  A shift past
  the neighbour block (a pipeline hand-off) sends the block's tiles to the
  two ranks their destinations lie on, and may be limited to the senders
  of one stage (``span``), so that a rank only sends or only receives.
  Its backward is the reverse permute of the cotangent: ``ppermute``'s
  transpose.  The
  ``"swap"`` of a 2-tile axis (the overlap schedule's packed exchange,
  ``[(0, 1), (1, 0)]``) is the local flip where one rank holds both tiles,
  and one paired send/receive where two ranks hold one each; it is its own
  transpose.  It posts the exchange and returns a ``Pending`` whose
  ``wait`` lands it, so that work queued in between (the overlap lead's
  interior conv) does not wait for the wire.
- ``all_gather_axis`` is the tiled ``all_gather`` along one rank axis (the
  hybrid plans' reshard), built on that axis's subgroup; its backward is
  the reduce-scatter, which both backends run as batched P2P (gloo has no
  ``reduce_scatter``).  ``gather_axis`` and ``all_to_all_axis`` are the
  undifferentiated pieces the wire codecs' reshard moves its payloads with.
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
``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``), which ``analysis/collectives.py`` turns
into the reference's ``CollectiveStats``; a count per distinct collective
keeps a long run's record the size of one step's.

``init_tile_group`` joins the group torchrun describes (``env://``);
``run_ranks`` spawns the ranks itself on one host with a ``file://`` store
(no port to race for), for the tests and ``chip_smoke.py``.

A step captured as a CUDA graph runs its collectives inside the graph
(``capturable``: nccl alone; gloo runs on the host, so its steps stay
eager).  The record is written by Python, so it counts a graph's
collectives once, at the capture: ``replay_record`` adds them once more at
every replay, so that a captured run's record equals the eager run's.

Elastic runs (``runtime/driver.py``): the collectives run over the *active*
ranks, ranks 0 .. W'-1 of the launched world (``TileGroup.active``, its
process group ``TileGroup.pg``).  A replan calls ``regroup`` on every
launched rank with the survivors' count (``survivors``: the most ranks that
split the new grid into equal blocks, the counterpart of the reference
taking the first n'·m' devices); the other ranks idle at ``meet``, the
meeting of the whole world that rank 0 (or the rank that saw the cluster
change) calls at every replan and at the run's end.  Before each step the
active ranks ``agree`` on what their faults raised.  Each is recorded
under the reference's HLO name (``all-reduce``), with its ``role``
(``Collective``).
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
    (a permute's strip, a sum's result, a gather's result), the group
    size, and its role: "" within a step; the elastic driver's "agree"
    (before a step), "meeting" (of the world), and the state broadcasts'
    "init" (the params, a serve engine's frozen BN statistics), "restore"
    and "return" (a rank back from idle); the serve engine's "dispatch"
    (rank 0's header and batch, ``serve/cnn_engine.py``)."""

    kind: str
    nbytes: int
    group: int
    role: str = ""


MEET_WORDS = 64                 # int32 words of a meeting's message
AGREE_BYTES = 4                 # the agreement's one int32
DISPATCH_WORDS = 3              # int32 words of a serve dispatch's header


@dataclasses.dataclass(eq=False)
class TileGroup:
    """A rank's membership of the process group: its rank, the size of the
    launched world, the backend, the device its tensors live on, and the
    record of every collective it issued since the last ``take_record``
    (how many times each distinct one ran).  The collectives run over the
    ``active`` ranks 0 .. active-1 (the whole world unless a replan left
    some idle: ``regroup``) on their process group ``pg`` (None: the
    world's)."""

    rank: int
    world: int
    backend: str
    device: torch.device
    record: Counter = dataclasses.field(default_factory=Counter)
    # the active ranks' process groups and the row and column subgroups of
    # each rank grid: made on first use while the whole world is active,
    # at ``regroup`` after a replan
    subgroups: dict = dataclasses.field(default_factory=dict)
    active: int | None = None
    pg: Any = None

    def __post_init__(self):
        if self.active is None:
            self.active = self.world

    @property
    def is_active(self) -> bool:
        return self.rank < self.active

    @property
    def staged(self) -> bool:
        """gloo on a card: strips and sums go through pinned host memory."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def take_record(self) -> Counter:
        """The collectives recorded so far, and an empty record after."""
        out = Counter(self.record)
        self.record.clear()
        return out


def capturable(group: TileGroup | None, device) -> bool:
    """Whether a step on ``device`` (over ``group``'s ranks, or on one
    process where None) can be captured as a CUDA graph: on a card, alone
    or under nccl.  Gloo moves CPU tensors through the host, which a graph
    cannot replay, so its steps run eagerly; so does the CPU."""
    if torch.device(device).type != "cuda":
        return False
    return group is None or group.backend == "nccl"


def check_capture(group: TileGroup) -> None:
    """Raise unless ``group``'s collectives can run inside a CUDA graph:
    nccl, with ``TORCH_NCCL_BLOCKING_WAIT`` unset (a blocking wait spins on
    the host, which a capture forbids; unset, a work's ``wait`` makes the
    capturing stream wait on it)."""
    if group.backend != "nccl":
        raise ValueError(f"a CUDA graph captures nccl collectives; {group.backend} runs on the "
                         "host, so its steps run eagerly")
    if os.environ.get("TORCH_NCCL_BLOCKING_WAIT", "0") not in ("", "0"):
        raise ValueError("TORCH_NCCL_BLOCKING_WAIT makes a collective's wait block the host, "
                         "which a CUDA graph's capture forbids: unset it")


@contextlib.contextmanager
def capture_pass(group: TileGroup | None):
    """Around a CUDA graph's capture: yields an empty Counter that, on exit,
    holds the collectives the capture's one pass recorded on ``group``
    (none without a group), and takes them back out of the group's record:
    that pass ran nothing, and ``replay_record`` adds them at each replay."""
    taken: Counter = Counter()
    issued = Counter(group.record) if group is not None else None
    try:
        yield taken
    finally:
        if group is not None:
            taken.update(group.record - issued)
            group.record.clear()
            group.record.update(issued)


def replay_record(record: Counter, captured: Counter, replays: int = 1) -> Counter:
    """``record`` with ``replays`` replays of a captured graph's collectives
    added, in place: ``captured`` is what the capture's one pass recorded.
    A replay issues its collectives with no Python, so this is where the
    record counts them."""
    for c, times in captured.items():
        record[c] += times * replays
    return record


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


def _all_reduce_(group: TileGroup, t: torch.Tensor, op=dist.ReduceOp.SUM, role: str = "",
                 world: bool = False) -> torch.Tensor:
    """Sum (or ``op``) ``t`` over the active ranks, in place; over the whole
    launched world with ``world``."""
    size, pg = (group.world, None) if world else (group.active, group.pg)
    group.record[Collective("all-reduce", _nbytes(t), size, role)] += 1
    if group.staged:
        h = _host(t)
        dist.all_reduce(h, op, group=pg)
        return t.copy_(h)
    dist.all_reduce(t, op, group=pg)
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
        return _all_reduce_(ctx.group, g.clone(memory_format=torch.contiguous_format)), None


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
        # contiguous: ranks whose gradients come from different graphs (a
        # pipeline's stages) may hold them in different layouts, and the
        # sum runs over memory order
        return _all_reduce_(ctx.group, g.clone(memory_format=torch.contiguous_format)), None


def replicated(t: torch.Tensor, group: TileGroup) -> torch.Tensor:
    return _Replicated.apply(t, group)


def broadcast_(group: TileGroup, tensors, role: str = "init") -> None:
    """Make every active rank's tensors equal rank 0's, in place; each is
    recorded as a ``collective-broadcast`` (XLA's name) of ``role``."""
    for t in tensors:
        group.record[Collective("collective-broadcast", _nbytes(t), group.active, role)] += 1
        if group.staged:
            h = _host(t)
            dist.broadcast(h, 0, group=group.pg)
            t.copy_(h)
        else:
            dist.broadcast(t, 0, group=group.pg)


def all_gather_blocks(group: TileGroup, block: torch.Tensor) -> list[torch.Tensor]:
    """Every active rank's ``block`` (equal shapes), in rank order.  Not
    differentiated (outputs)."""
    group.record[Collective("all-gather", _nbytes(block) * group.active, group.active)] += 1
    src = _host(block) if group.staged else block.contiguous()
    parts = [torch.empty_like(src) for _ in range(group.active)]
    dist.all_gather(parts, src, group=group.pg)
    return [p.to(group.device) for p in parts] if group.staged else parts


def _post(group: TileGroup, sends: list, recvs: list, tag: int = 0) -> tuple[list, list]:
    """Post ``sends`` ((tensor, rank)) and receives of ``recvs`` ((shape,
    dtype, rank)) in one batch, at most one each way between two ranks;
    -> (the works, the receive buffers).  A staged group sends host copies
    and receives into pinned host memory.  Exchanges posted together
    between the same ranks pass distinct ``tag``s."""
    ops, bufs = [], []
    # the active ranks are a prefix of the world, so a peer's rank in their
    # group is its global rank
    for t, peer in sends:
        assert peer < group.active, f"peer {peer} is not an active rank (of {group.active})"
        s = _host(t) if group.staged else t.contiguous()
        ops.append(dist.P2POp(dist.isend, s, peer, group=group.pg, tag=tag))
    dev = torch.device("cpu") if group.staged else group.device
    for shape, dtype, peer in recvs:
        assert peer < group.active, f"peer {peer} is not an active rank (of {group.active})"
        buf = torch.empty(shape, dtype=dtype, device=dev, pin_memory=group.staged)
        ops.append(dist.P2POp(dist.irecv, buf, peer, group=group.pg, tag=tag))
        bufs.append(buf)
    return (dist.batch_isend_irecv(ops) if ops else []), bufs


def _land(group: TileGroup, works: list, bufs: list) -> list:
    """Wait for posted messages; -> the receive buffers on the group's
    device."""
    for work in works:
        work.wait()
    return [b.to(group.device) for b in bufs] if group.staged else bufs


class Pending:
    """A value whose exchange may still be on the wire: ``wait()`` lands it
    (once) and returns it.  ``landed(v)`` is one that needs no wire."""

    def __init__(self, land: Callable[[], Any]):
        self._land, self._value = land, None

    def wait(self):
        if self._land is not None:
            self._value, self._land = self._land(), None
        return self._value


def landed(value) -> Pending:
    return Pending(lambda: value)


def _check_shift(dim: int, shift, mesh) -> None:
    if dim not in (0, 1):
        raise ValueError(f"permute along dimension {dim}: ranks shift along the tile grid")
    if shift == "swap":
        tiles = (mesh.n, mesh.m)[dim]
        if tiles != 2:
            raise ValueError(f"the swap exchanges the two tiles of a 2-tile axis; axis {dim} "
                             f"has {tiles}")
        return
    if shift == 0:
        raise ValueError("a permute by 0 tiles moves nothing")


def _runs(positions, key) -> list[tuple[int, int, Any]]:
    """Consecutive grid positions grouped by ``key(position)``: [(first,
    count, key), ...] in order."""
    out: list = []
    for p in positions:
        k = key(p)
        if out and out[-1][2] == k and out[-1][0] + out[-1][1] == p:
            out[-1] = (out[-1][0], out[-1][1] + 1, k)
        else:
            out.append((p, 1, k))
    return out


def _hop_start(x: torch.Tensor, dim: int, shift: int, mesh, span, tag: int):
    """Post a shift of the block ``x`` by ``shift`` tiles along ``dim``:
    grid position q sends to q + shift when ``span`` = (lo, hi) holds it;
    -> a function that lands the shifted block (zeros where no sender).
    With equal blocks of b tiles the block's senders reach at most two
    ranks, ``shift // b`` and ``shift // b + 1`` blocks away, and it
    receives from the mirror two; a piece that stays in the block moves
    locally.  Every message between two ranks is one batched P2P op."""
    size, n_axis = x.shape[dim], (mesh.n, mesh.m)[dim]
    o = mesh.origin[dim]
    lo, hi = (0, n_axis) if span is None else (max(span[0], 0), min(span[1], n_axis))
    me = o // size

    def block_of(p):
        return p // size

    senders = range(max(o, lo), min(o + size, hi))
    sends = [(q0, cnt, mesh.neighbour(dim, b - me))
             for q0, cnt, b in _runs([q for q in senders if 0 <= q + shift < n_axis],
                                     lambda q: block_of(q + shift)) if b != me]
    pieces = _runs(range(o, o + size), lambda p: (block_of(p - shift)
                                                  if lo <= p - shift < hi else None))
    recvs = [(cnt, mesh.neighbour(dim, b - me)) for _, cnt, b in pieces
             if b is not None and b != me]
    leaving = sum(1 for q in senders if not o <= q + shift < o + size)
    group = mesh.group
    if leaving:
        per_tile = _nbytes(x) // size
        group.record[Collective("collective-permute", per_tile * leaving, 2)] += 1

    def piece_shape(cnt):
        shape = list(x.shape)
        shape[dim] = cnt
        return shape

    works, bufs = _post(group, [(x.narrow(dim, q0 - o, cnt), r) for q0, cnt, r in sends],
                        [(piece_shape(cnt), x.dtype, r) for cnt, r in recvs], tag)

    def land():
        got = iter(_land(group, works, bufs))
        parts = []
        for p0, cnt, b in pieces:
            if b is None:
                parts.append(x.new_zeros(piece_shape(cnt)))
            elif b == me:
                parts.append(x.narrow(dim, p0 - shift - o, cnt))
            else:
                parts.append(next(got))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)

    return land


def _exchange_start(x: torch.Tensor, dim: int, shift, mesh, tag: int = 0, span=None):
    """Post the part of ``permute`` that crosses ranks; -> a function that
    lands it and returns the permuted block (not differentiated)."""
    _check_shift(dim, shift, mesh)
    if shift != "swap":
        return _hop_start(x, dim, shift, mesh, span, tag)
    size = x.shape[dim]
    if size == 2:                                   # both tiles here: the local flip
        out = torch.flip(x, [dim])
        return lambda: out
    group = mesh.group
    peer = mesh.neighbour(dim, 1 if mesh.coord[dim] == 0 else -1)
    group.record[Collective("collective-permute", _nbytes(x), 2)] += 1
    works, bufs = _post(group, [(x, peer)], [(x.shape, x.dtype, peer)], tag)
    return lambda: _land(group, works, bufs)[0]


def _exchange(x: torch.Tensor, dim: int, shift, mesh, span=None) -> torch.Tensor:
    return _exchange_start(x, dim, shift, mesh, span=span)()


def _reverse(shift, span):
    """The hop that carries a permute's cotangent back: the reverse shift
    from the positions the senders reached (the swap is its own)."""
    if shift == "swap":
        return "swap", None
    return -shift, None if span is None else (span[0] + shift, span[1] + shift)


class _Landed(torch.autograd.Function):
    """The permuted block, landed: the output of ``permute`` as a function
    of the sender's block ``x``; the backward permutes the cotangent back
    (the reverse hop; the swap is its own reverse)."""

    @staticmethod
    def forward(ctx, x, out, dim, shift, mesh, span):
        ctx.meta = (dim, shift, mesh, span)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        dim, shift, mesh, span = ctx.meta
        back, back_span = _reverse(shift, span)
        return _exchange(g.contiguous(), dim, back, mesh, back_span), None, None, None, None, None


def permute_start(x: torch.Tensor, dim: int, shift, mesh, tag: int = 0, span=None) -> Pending:
    """``ppermute`` of the blocks ``x`` = (bn, bm, ...) of ``mesh`` (a
    ``launch.mesh.DistTileMesh``) along tile dimension ``dim`` (0 rows, 1
    columns): by ``shift`` tiles (tile j receives tile j - shift's data,
    zeros where the grid has no such tile), or ``"swap"``, the two tiles of
    a 2-tile axis exchanged.  A shift may pass the neighbour block (a
    pipeline hand-off): the block's tiles then go to the two ranks their
    destinations lie on.  ``span`` = (lo, hi) limits the senders to the
    grid's tiles [lo, hi) along ``dim`` (one pipeline stage's): a rank
    holding none sends nothing, and a tile whose source lies outside it
    receives zeros, so a rank may only send or only receive.  The strips
    leave now; ``wait()`` lands them and returns the permuted block
    (differentiable in ``x``: the backward is the reverse hop).  Work
    queued between the two does not wait for the wire (under nccl the
    compute stream waits on the exchange only at ``wait``).  Exchanges
    posted together between the same ranks take distinct ``tag``s.  The
    record counts one ``collective-permute`` of the tiles whose
    destination lies outside the block (past the grid's edge included, as
    every device of the reference runs its ``ppermute``), and none where
    every destination is local."""
    land = _exchange_start(x, dim, shift, mesh, tag, span)

    def finish():
        out = land()
        if not (torch.is_grad_enabled() and x.requires_grad):
            return out
        return _Landed.apply(x, out.detach(), dim, shift, mesh, span)

    return Pending(finish)


# ---------------------------------------------------------------------------
# Collectives along one rank axis (the hybrid plans' reshard)
# ---------------------------------------------------------------------------


def axis_ranks(mesh, dim: int) -> list[int]:
    """The ranks of this rank's line along rank axis ``dim`` (0: the ranks
    of its rank column, holding the other tile rows; 1: of its rank row),
    in grid order."""
    rr, rc = mesh.ranks
    pr, pc = mesh.coord
    if dim == 0:
        return [r * rc + pc for r in range(rr)]
    return [pr * rc + c for c in range(rc)]


def _make_lines(group: TileGroup, ranks: tuple[int, int]) -> None:
    """Every line of every axis of the rank grid ``ranks``, in one order
    (``new_group`` numbers its groups by the order the world makes them,
    so every launched rank makes each, members or not)."""
    if ranks in group.subgroups:
        return
    rr, rc = ranks
    lines = {0: {c: [r * rc + c for r in range(rr)] for c in range(rc)},
             1: {r: [r * rc + c for c in range(rc)] for r in range(rr)}}
    made = {}
    for d in (0, 1):
        for key, members in lines[d].items():
            if len(members) > 1:
                made[(d, key)] = dist.new_group(members)
    group.subgroups[ranks] = made


def _axis_group(mesh, dim: int):
    """This rank's subgroup along rank axis ``dim``.  While the whole world
    is active, every line of every axis of the rank grid is made the first
    time any is asked for, in one order on every rank (``new_group`` is
    collective over the world).  After a replan idle ranks run no step, so
    such a line would hang: ``regroup`` makes the new grid's lines on every
    launched rank instead, and one missing here raises."""
    group = mesh.group
    if mesh.ranks not in group.subgroups:
        if group.active < group.world:
            raise RuntimeError(f"the lines of rank grid {mesh.ranks} were not made at the regroup "
                               f"to {group.active} of {group.world} ranks")
        _make_lines(group, mesh.ranks)
    return group.subgroups[mesh.ranks][(dim, mesh.coord[1 - dim])]


def gather_axis(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The blocks ``t`` of this rank's line along rank axis ``dim``,
    concatenated along tensor dimension ``dim`` in grid order (the tiled
    ``all_gather``); not differentiated."""
    ranks = axis_ranks(mesh, dim)
    if len(ranks) == 1:
        return t
    group = mesh.group
    group.record[Collective("all-gather", _nbytes(t) * len(ranks), len(ranks))] += 1
    src = _host(t) if group.staged else t.contiguous()
    parts = [torch.empty_like(src) for _ in ranks]
    dist.all_gather(parts, src, group=_axis_group(mesh, dim))
    if group.staged:
        parts = [p.to(group.device) for p in parts]
    return torch.cat(parts, dim=dim)


def _line_exchange(t: torch.Tensor, axis: int, mesh, dim: int) -> list[torch.Tensor]:
    """Chunk q of ``t`` (split along ``dim``, one chunk per rank of this
    rank's line along rank axis ``axis``) to the line's rank q; -> the
    chunks every rank of the line sent this one, in grid order (its own
    included).  Batched P2P, unrecorded."""
    ranks = axis_ranks(mesh, axis)
    chunks = list(t.chunk(len(ranks), dim))
    me = mesh.coord[axis]
    others = [(q, r) for q, r in enumerate(ranks) if q != me]
    works, bufs = _post(mesh.group, [(chunks[q], r) for q, r in others],
                        [(chunks[me].shape, t.dtype, r) for _, r in others])
    got = iter(_land(mesh.group, works, bufs))
    return [chunks[q] if q == me else next(got) for q in range(len(ranks))]


def all_to_all_axis(t: torch.Tensor, axis: int, mesh, dim: int) -> list[torch.Tensor]:
    """``t`` split along tensor dimension ``dim`` into
    one equal chunk per rank of this rank's line along rank axis ``axis``;
    chunk q goes to the line's rank q.  -> the chunks every rank of the
    line sent this one, in grid order (its own included).  Not
    differentiated."""
    g = len(axis_ranks(mesh, axis))
    if g == 1:
        return [t]
    mesh.group.record[Collective("all-to-all", _nbytes(t), g)] += 1
    return _line_exchange(t, axis, mesh, dim)


def sum_in_order(parts) -> torch.Tensor:
    """The sum of ``parts``, one after another, in their order."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


class _AxisGather(torch.autograd.Function):
    """``gather_axis``, differentiated: the backward is the reduce-scatter
    (each rank of the line gets the sum of the line's cotangent chunks for
    its block, summed in grid order), batched P2P on both backends."""

    @staticmethod
    def forward(ctx, t, dim, mesh):
        ctx.meta = (dim, mesh)
        return gather_axis(t, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        dim, mesh = ctx.meta
        n = len(axis_ranks(mesh, dim))
        if n == 1:
            return g, None, None
        mesh.group.record[Collective("reduce-scatter", _nbytes(g) // n, n)] += 1
        return sum_in_order(_line_exchange(g.contiguous(), dim, mesh, dim)), None, None


def all_gather_axis(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The tiled ``all_gather`` of the blocks ``t`` along rank axis ``dim``
    (``gather_axis``), differentiable: its backward is the reduce-scatter."""
    return _AxisGather.apply(t, dim, mesh)


# ---------------------------------------------------------------------------
# Elastic membership: the survivors, the regroup, the agreement, the meeting
# ---------------------------------------------------------------------------


def survivors(n: int, m: int, world: int) -> int:
    """The ranks a replan onto an n x m grid runs on: the most, at most
    ``world``, for which ``rank_grid`` splits the grid into equal blocks.
    They are ranks 0 .. W'-1, as the reference runs the new plan on the
    first n'·m' devices; the others idle."""
    for w in range(world, 0, -1):
        try:
            rank_grid(n, m, w)
        except ValueError:
            continue
        return w
    raise AssertionError("one rank splits every grid")


def regroup(group: TileGroup, active: int, ranks: tuple[int, int] | None = None) -> None:
    """Make ranks 0 .. ``active``-1 the ranks the collectives run over, laid
    out as the rank grid ``ranks``.  Every launched rank calls it with the
    same arguments, idle ones included: it makes their process group and
    every line of the grid now, in one order on every rank, and keeps what
    it made for a later regroup to the same count or grid (``new_group``
    numbers its groups by the order the world makes them, and an idle rank
    runs no step that could make one later).  A subgroup takes the device
    ``_init`` bound the world's nccl group to."""
    if not 1 <= active <= group.world:
        raise ValueError(f"{active} active ranks of a world of {group.world}")
    if ranks is not None and ranks[0] * ranks[1] != active:
        raise ValueError(f"rank grid {ranks} is not {active} ranks")
    pg = None
    if active < group.world:
        key = ("active", active)
        if key not in group.subgroups:
            group.subgroups[key] = dist.new_group(list(range(active)))
        pg = group.subgroups[key]
    group.active, group.pg = active, pg
    if ranks is not None:
        _make_lines(group, ranks)


def agree(group: TileGroup, code: int) -> int:
    """The largest ``code`` (a non-negative int32) any active rank passed:
    one 4-byte all-reduce (MAX) over the active ranks, recorded as
    ``all-reduce`` of role ``agree``."""
    t = torch.tensor([code], dtype=torch.int32, device=group.device)
    return int(_all_reduce_(group, t, dist.ReduceOp.MAX, role="agree").item())


def meet(group: TileGroup, message: list[int] | None) -> list[int]:
    """The meeting of the whole launched world, idle ranks included: one
    all-reduce (MAX) of ``MEET_WORDS`` int32 words over the world's group,
    recorded as ``all-reduce`` of role ``meeting``.  The one rank that
    speaks passes its ``message`` (non-negative words), every other None;
    -> the message, on every rank.  An idle rank waits here within the
    group's timeout."""
    t = torch.zeros(MEET_WORDS, dtype=torch.int32, device=group.device)
    if message is not None:
        if len(message) > MEET_WORDS or min(message, default=0) < 0:
            raise ValueError(f"a meeting's message is at most {MEET_WORDS} non-negative words")
        t[:len(message)] = torch.tensor(message, dtype=torch.int32)
    return _all_reduce_(group, t, dist.ReduceOp.MAX, role="meeting", world=True).tolist()


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
