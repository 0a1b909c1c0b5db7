"""Training step factory: grad accumulation, clipping, LR schedule,
optimizer update, optional int8-EF gradient compression - the tiled-CNN and
LM paths of ``repro/train/trainer.py``.

``make_train_step(arch, pcfg, tcfg)`` returns ``(init_state, train_step)``;
``on_grads(step, loss, grads)``, if given, sees each step's batch-end
gradients before the trainer tail, so a run's own gradients can be held
against a reference.
For a tiled-CNN bundle (``arch.kind == "tiled_cnn"``) the grads come from
``core.fusion.make_deferred_grad_step``: ``pcfg.grad_accum`` microbatches
accumulate per-tile weight-gradient partial sums, and one division by the
global count at batch end gives the final gradients - the paper's schedule.
Over a pipeline plan the same microbatches stream through the stages in one
autograd pass (``pcfg.grad_accum`` is the pipeline depth M).
For an LM bundle (``models.registry.ArchBundle``: a decoder-only LM or
Whisper's encoder-decoder) the grads come from autograd over
``arch.loss_fn``; with ``pcfg.grad_accum`` > 1 the
microbatches' grads are summed into fp32 zeros and divided once, and the
loss is the microbatches' mean, as the reference's scan does.  The LM step
updates the state in place (``inplace`` of ``optim.optimizers``): the state
it is given is consumed, as the reference's launcher donates it to ``jit``,
and the fp32 gradients ``on_grads`` sees are clipped where they lie after it
returns - an observer copies what it keeps.
The trainer tail then runs optional int8 error-feedback compression,
global-norm clipping, the cosine/warmup schedule and the optimizer update.

``TrainState.step`` and the optimizers' update counts are 0-d int32 tensors
on the params' device, as the reference's ``jnp.int32`` leaves, and the
tail computes the LR and AdamW's bias corrections from them on the device.
``capture_train_step`` (the counterpart of the reference's
``jax.jit(train_step, donate_argnums=(0,))``) records that one eager body
as a CUDA graph and replays it every step, so a replay is the eager step
bit for bit; ``make_train_step`` itself stays eager, as the reference's is
un-jitted, and ``on_grads`` (which reads the host) is for eager steps only.

Elastic support (DESIGN.md §10): ``abstract_state`` (the state's shapes and
dtypes on the ``meta`` device, allocating nothing - the structure a restore
fills), ``globalize_state`` and ``check_state_matches``.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, NamedTuple, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.optim.compression import CompressionState, compress_with_feedback, init_error
from repro_torch.optim.optimizers import (
    clip_by_global_norm,
    as_count,
    init_count,
    make_optimizer,
    tree_leaves,
    tree_map,
)
from repro_torch.optim.schedules import cosine_schedule
from repro_torch.parallel.dist import capture_pass, replay_record


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: Any                     # 0-d int32 tensor on the params' device (a host int is taken)
    ef: Optional[Any] = None      # error-feedback buffers (compression)


def _make_init_state(arch, opt, tcfg: TrainConfig):
    def init_state(seed: int | torch.Generator = 0) -> TrainState:
        params = arch.init(seed)
        ef = init_error(params).error if tcfg.grad_compression == "int8" else None
        return TrainState(params, opt.init(params), init_count(params), ef)

    return init_state


def _apply_updates(state: TrainState, loss, grads, opt, tcfg: TrainConfig,
                   inplace: bool = False):
    """Shared trainer tail: EF compression -> clip -> schedule -> update.
    The LR comes from the step where it lies (a 0-d tensor on the card), so
    the captured step computes each replay's own."""
    ef = state.ef
    if ef is not None:
        grads, st = compress_with_feedback(grads, CompressionState(ef))
        ef = st.error
    grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip, inplace=inplace)
    step = as_count(state.step, state.params)
    lr = cosine_schedule(step, tcfg.warmup, tcfg.steps, tcfg.lr)
    params, opt_state = opt.update(grads, state.opt, state.params, lr)
    new_state = TrainState(params, opt_state, step + 1, ef)
    return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}


def make_train_step(arch, pcfg: ParallelConfig, tcfg: TrainConfig, *, on_grads=None):
    from repro_torch.models.registry import ArchBundle

    if tcfg.grad_compression not in (None, "int8"):
        raise ValueError(f"grad_compression must be None or 'int8'; got {tcfg.grad_compression!r}")
    if getattr(arch, "kind", None) == "tiled_cnn":
        return _make_tiled_cnn_train_step(arch, pcfg, tcfg, on_grads)
    if isinstance(arch, ArchBundle):
        return _make_lm_train_step(arch, pcfg, tcfg, on_grads)
    raise TypeError(
        f"no training path for {type(arch).__name__}: the port trains tiled-CNN arches and "
        "the registry's bundles (decoder-only LMs and Whisper's encoder-decoder)")


def _unflatten(like, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def lm_value_and_grad(loss_fn, params, batch: dict):
    """(loss, grads) of ``loss_fn(params, batch)`` by autograd: the loss
    detached, the grads in each param's dtype, in the params' tree, each
    contiguous (the in-place optimizers update flat views: an unstacked
    leaf's einsum gradient, as the MTP layer's ``w_o``, comes back
    strided)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = loss_fn(live, batch)
    grads = [g.contiguous() for g in torch.autograd.grad(loss, tree_leaves(live))]
    return loss.detach(), _unflatten(params, grads)


def _make_lm_train_step(arch, pcfg: ParallelConfig, tcfg: TrainConfig, on_grads):
    opt = make_optimizer(tcfg.optimizer, weight_decay=tcfg.weight_decay, inplace=True)
    init_state = _make_init_state(arch, opt, tcfg)
    accum = pcfg.grad_accum

    def loss_fn(params, batch):
        return arch.loss_fn(params, batch, remat=pcfg.remat, unroll=pcfg.unroll,
                            ce_chunk=pcfg.ce_chunk)

    def split_batch(batch: dict) -> list[dict]:
        out = {}
        for k, v in batch.items():
            v = torch.as_tensor(v, device=arch.device)
            dim = 1 if (k == "positions" and v.dim() == 3) else 0   # (3, B, T) splits on B
            if v.shape[dim] % accum:
                raise ValueError(f"batch entry {k!r} of {v.shape[dim]} rows not divisible by "
                                 f"grad_accum={accum}")
            out[k] = v.chunk(accum, dim=dim)
        return [{k: v[i] for k, v in out.items()} for i in range(accum)]

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        if accum > 1:
            gsum = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.promote_types(p.dtype, torch.float32), device=p.device),
                state.params)
            lsum = torch.zeros((), dtype=torch.float32, device=arch.device)
            for mb in split_batch(batch):
                l, g = lm_value_and_grad(loss_fn, state.params, mb)
                tree_map(lambda a, b: a.add_(b), gsum, g)
                del g
                lsum = lsum + l
            grads = tree_map(lambda g: g.div_(accum), gsum)
            loss = lsum / accum
        else:
            batch = {k: torch.as_tensor(v, device=arch.device) for k, v in batch.items()}
            loss, grads = lm_value_and_grad(loss_fn, state.params, batch)
        if on_grads is not None:
            on_grads(state.step, loss, grads)
        return _apply_updates(state, loss, grads, opt, tcfg, inplace=True)

    train_step.observed = on_grads is not None
    return init_state, train_step


def _make_tiled_cnn_train_step(arch, pcfg: ParallelConfig, tcfg: TrainConfig, on_grads):
    from repro_torch.core.fusion import make_deferred_grad_step

    opt = make_optimizer(tcfg.optimizer, weight_decay=tcfg.weight_decay)
    init_state = _make_init_state(arch, opt, tcfg)
    accum = max(pcfg.grad_accum, 1)
    grad_step = make_deferred_grad_step(arch.plan, arch.mesh, arch.loss_local,
                                        microbatches=accum)

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        def split(v):
            v = torch.as_tensor(v, device=arch.mesh.device)
            if v.shape[0] % accum:
                raise ValueError(
                    f"global batch {v.shape[0]} not divisible by "
                    f"grad_accum={accum} (tiled-CNN microbatch split)"
                )
            return v.reshape((accum, v.shape[0] // accum) + tuple(v.shape[1:]))

        plan = arch.plan
        if plan.stages:
            # the trainer's words for the pipeline batch rule: each of the
            # grad_accum microbatches streamed through the stages must split
            # over one stage's tiles
            per = (plan.n * plan.m) // len(plan.stages)
            b = batch["x"].shape[0]
            if b % accum or (b // accum) % per:
                raise ValueError(
                    f"pipeline plan with {len(plan.stages)} stages needs "
                    f"the global batch ({b}) divisible by grad_accum "
                    f"({accum}) and the per-microbatch batch by the "
                    f"devices per stage ({per}); adjust --batch/--grad-accum"
                )
        loss, grads = grad_step(state.params, split(batch["x"]), split(batch["t"]))
        if on_grads is not None:
            on_grads(state.step, loss, grads)
        return _apply_updates(state, loss, grads, opt, tcfg)

    train_step.grad_step = grad_step     # its ``census`` after a pipeline plan's step
    train_step.observed = on_grads is not None
    return init_state, train_step


# ---------------------------------------------------------------------------
# The captured step: the counterpart of the reference's jax.jit(train_step,
# donate_argnums=(0,))
# ---------------------------------------------------------------------------


def _leaf_meta(x) -> tuple[tuple, torch.dtype]:
    """A state leaf's (shape, dtype); a host int is a 0-d int32, as a
    checkpoint stores it."""
    return (tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor) else ((), torch.int32)


def _indexed(device) -> torch.device:
    """``device`` with its index: "cuda" is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class StateBinder:
    """The static state of a captured step.  Construction adopts
    ``state``'s tensors as they are, not copies (a host int leaf becomes a
    0-d int32 tensor on ``device``); ``bind(state)`` makes the static state
    equal ``state``: nothing happens when its leaves are the adopted
    tensors, and any other leaves (a restored state) are copied into them
    with one ``torch._foreach_copy_``.  A state of another structure, or a
    leaf of another shape or dtype, raises ``ValueError``."""

    def __init__(self, state, device):
        device = _indexed(device)
        leaves, self.spec = tree_flatten(state)
        self.leaves = [x if x is None or isinstance(x, torch.Tensor)
                       else torch.full((), int(x), dtype=torch.int32, device=device)
                       for x in leaves]
        off = [i for i, x in enumerate(self.leaves) if x is not None and x.device != device]
        if off:
            raise ValueError(f"state leaf {off[0]} lies on {self.leaves[off[0]].device}, "
                             f"not {device}")
        self.state = tree_unflatten(self.leaves, self.spec)
        self.copies = 0             # bind calls that copied a state in

    def bind(self, state) -> bool:
        """Bring the static state up to ``state``; True when it copied."""
        leaves, spec = tree_flatten(state)
        if spec != self.spec:
            raise ValueError("state does not have the structure the step was captured with")
        stale = [i for i, x in enumerate(leaves) if x is not self.leaves[i]]
        if not stale:
            return False
        for i in stale:
            got, want = _leaf_meta(leaves[i]), _leaf_meta(self.leaves[i])
            if got != want:
                raise ValueError(f"state leaf {i}: {got[1]} {got[0]}, captured with "
                                 f"{want[1]} {want[0]}")
        src = [leaves[i] if isinstance(leaves[i], torch.Tensor)
               else torch.tensor(int(leaves[i]), dtype=torch.int32) for i in stale]
        with torch.no_grad():
            torch._foreach_copy_([self.leaves[i] for i in stale], src)
        self.copies += 1
        return True


class CapturedTrainStep:
    """``train_step`` captured as one CUDA graph and replayed every step,
    with the reference's jitted contract ``step(state, batch) -> (state,
    metrics)`` and its donation of the state.

    The first ``WARM_RUNS`` calls are the run's own steps, eager: they build
    the kernels and make the plan constants, and their updates are the
    run's.  They run on the current stream, not a side stream, so that they
    reuse the memory the allocator holds for it (a full-width LM state
    leaves no room for a second stream's copy of the step's activations).
    The next call adopts the state it is given as
    the graph's static state (its tensors, not copies: an int leaf becomes
    a 0-d int32 tensor on the card), captures the step once into a private
    pool - which runs nothing - with a copy of every new leaf the step
    returns (the CNN's out-of-place update, the counters) back into the
    adopted one, then replays.  From then on a call copies the batch into
    static buffers and replays; a state whose leaves are not the adopted
    tensors (a restore) is first copied into them with one
    ``torch._foreach_copy_``, and a leaf of another shape or dtype raises.
    The returned state is the static state; the metrics are copies, which
    the next replay leaves alone.  Nothing falls back to an eager step: a
    capture or replay that fails raises.

    ``launches`` holds the kernel launches counted during the capture (what
    each replay runs again without Python; ``serve/exec_cache.py:
    kernel_launch_counts``), ``replays`` the replays, ``pool_bytes`` the
    device memory the graph's pool reserved, ``captured`` whether a graph
    was captured (``release`` drops it: a replan's old step).

    On ranks (``group``, a ``parallel/dist.py:TileGroup`` under nccl) the
    graph holds the step's collectives: its all-reduces, gathers and
    batched P2P run inside it, and ``work.wait()`` makes the capturing
    stream wait on them.  Every communicator they use exists by then: the
    warm steps made the subgroups and ran every collective once, and every
    rank captures at the same call.  The capture runs in thread-local mode,
    so that the backend's watchdog thread may query its events meanwhile.
    The group's record counts what Python issued, so the capture's one pass
    is taken out of it (``collectives``) and every replay adds it back
    (``dist.replay_record``).  Gloo moves its tensors through the host and
    is refused (its steps run eagerly: ``launch/train.py:jit_step``)."""

    def __init__(self, train_step, device, group=None):
        from repro_torch.parallel.dist import check_capture

        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(
                f"capture_train_step needs a CUDA device: a CUDA graph has no CPU counterpart "
                f"(the CPU runs the eager step); got {device}")
        if getattr(train_step, "observed", False):
            raise ValueError("a step with an on_grads observer runs eagerly: a graph would run "
                             "the observer once, at its capture")
        if group is not None:
            check_capture(group)
        self._step = train_step
        self.device = _indexed(device)
        self.group = group
        self._graph = None
        self.captured = False
        self.warm_steps = self.replays = self.pool_bytes = 0
        self.launches: dict = {}
        self.collectives: Counter = Counter()

    def __call__(self, state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        from repro_torch.serve.exec_cache import WARM_RUNS

        if self.captured and self._graph is None:
            raise RuntimeError("this captured step was released (a replan replaced it)")
        if self._graph is None and self.warm_steps < WARM_RUNS:
            self.warm_steps += 1
            return self._step(state, batch)
        if self._graph is None:
            self._capture(state, batch)
        else:
            self._binder.bind(state)
        self._load(batch)
        self._graph.replay()
        self.replays += 1
        if self.group is not None:
            replay_record(self.group.record, self.collectives)
        return self._state, {k: v.clone() for k, v in self._metrics.items()}

    def _capture(self, state, batch) -> None:
        from repro_torch.serve.exec_cache import kernel_launch_counts

        self._binder = StateBinder(state, self.device)
        self._state = self._binder.state
        self._batch = {k: torch.empty(tuple(v.shape), dtype=v.dtype, device=self.device)
                       for k, v in batch.items()}
        graph = torch.cuda.CUDAGraph()
        with capture_pass(self.group) as self.collectives, torch.cuda.graph(
                graph, capture_error_mode="global" if self.group is None else "thread_local"):
            # read on entry, after the context has synchronized, collected
            # garbage and emptied the allocator's cache
            reserved = torch.cuda.memory_reserved(self.device)
            before = kernel_launch_counts()
            new_state, self._metrics = self._step(self._state, self._batch)
            new_leaves, spec = tree_flatten(new_state)
            if spec != self._binder.spec:
                raise ValueError("the step returned a state of another structure than it took")
            moved = [(d, x) for d, x in zip(self._binder.leaves, new_leaves) if x is not d]
            if moved:
                torch._foreach_copy_([d for d, _ in moved], [x for _, x in moved])
            after = kernel_launch_counts()
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.launches = {k: v - before.get(k, 0) for k, v in after.items()
                         if v != before.get(k, 0)}
        self._graph, self.captured = graph, True

    def release(self) -> None:
        """Drop the graph, its pool and the static batch (a replan's old
        step, never called again); the adopted state stays the caller's."""
        self._graph = self._binder = self._state = self._batch = self._metrics = None

    def _load(self, batch: dict) -> None:
        if set(batch) != set(self._batch):
            raise ValueError(f"batch keys {sorted(batch)}, captured with {sorted(self._batch)}")
        for k, v in batch.items():
            want = self._batch[k]
            if tuple(v.shape) != tuple(want.shape) or v.dtype != want.dtype:
                raise ValueError(f"batch entry {k!r}: {v.dtype} {tuple(v.shape)}, captured "
                                 f"with {want.dtype} {tuple(want.shape)}")
            want.copy_(torch.as_tensor(v), non_blocking=True)


def capture_train_step(train_step, device, group=None) -> CapturedTrainStep:
    """``train_step`` (``make_train_step``'s, without an observer) as a
    ``CapturedTrainStep`` on the CUDA ``device``, its collectives over
    ``group``'s nccl ranks where given; any other device raises
    ``ValueError`` (a CUDA graph has no CPU counterpart: the CPU runs the
    eager step), and so does a gloo group."""
    return CapturedTrainStep(train_step, device, group)


# ---------------------------------------------------------------------------
# Elastic replan support (DESIGN.md §10)
# ---------------------------------------------------------------------------


def abstract_of(init_state, seed: int = 0) -> tuple[Any, Optional[torch.device]]:
    """``init_state(seed)`` traced for its structure alone: the state with
    each tensor leaf replaced by an empty ``meta`` tensor of its shape and
    dtype (ints stay ints), and the device the real state would live on.
    It runs under ``FakeTensorMode``, so nothing is drawn or allocated: a
    restore's "like" structure for a full-width LM costs no device memory."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.ckpt.manager import map_with_path

    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = init_state(seed)
    devices = []

    def to_meta(_, x):
        if isinstance(x, torch.Tensor):
            devices.append(x.device)
            return torch.empty(x.shape, dtype=x.dtype, device="meta")
        return x

    return map_with_path(to_meta, fake), (devices[0] if devices else None)


def abstract_state(arch, pcfg: ParallelConfig, tcfg: TrainConfig) -> TrainState:
    """The TrainState's shapes and dtypes as ``meta`` tensors (a dry run:
    no allocation) - the reference's ``jax.eval_shape`` of ``init_state``."""
    init_state, _ = make_train_step(arch, pcfg, tcfg)
    return abstract_of(init_state)[0]


def globalize_state(state: TrainState) -> TrainState:
    """A host copy of a live TrainState - the partition-independent form.
    On the virtual tile mesh every param and optimizer statistic is
    already a whole (global) tensor, so a replan keeps the live state as it
    is; this copy is what a checkpoint holds, detached from the device."""
    from repro_torch.ckpt.manager import map_with_path

    return map_with_path(
        lambda _, x: x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x, state)


def check_state_matches(state: Any, like: Any) -> None:
    """Validate that ``state`` is structurally interchangeable with ``like``
    (the same leaf paths, shapes and dtypes; an int leaf is a 0-d int32) -
    the guard before handing a restored or carried-over state to a step
    built for another plan.  Raises ValueError naming the first offending
    leaf path."""
    from repro_torch.ckpt.manager import leaf_meta, map_with_path

    def collect(tree):
        out = {}
        map_with_path(lambda p, x: out.__setitem__(p, leaf_meta(x)), tree)
        return out

    paths_a, paths_b = collect(state), collect(like)
    for path in sorted(set(paths_a) | set(paths_b)):
        if path not in paths_a:
            raise ValueError(f"state missing leaf {path!r} expected by plan")
        if path not in paths_b:
            raise ValueError(f"state has extra leaf {path!r} not in plan")
        (sa, da), (sb, db) = paths_a[path], paths_b[path]
        if sa != sb:
            raise ValueError(f"state leaf {path!r} shape {sa} != plan {sb}")
        if da != db:
            raise ValueError(f"state leaf {path!r} dtype {da} != plan {db}")
