"""Serving engine for the LM: slot-based continuous batching
(``repro/serve/engine.py``).

``ServeEngine`` keeps a fixed pool of ``batch`` slots; a request occupies a
slot through prefill, then decodes one token per engine tick until EOS or
its ``max_new_tokens``, after which the slot is recycled for a queued
request.  The caches are allocated once (``arch.make_caches``) and every
tick decodes all slots, so the shapes never change.

The reference lets one slot's request see the others' (ROADMAP C.8: every
decode writes and advances every slot, the bulk prefill feeds token 0 into
the other slots, and a recycled slot keeps its old state) and feeds a
prompt's last token twice (C.9).  Here a slot's request is independent of
the others:

- admission zeroes the slot's cache rows and state (``slot(i)`` views of a
  ``KVCache``, an MLA layer's compressed ``MLACache``, a ``MambaState`` or
  a Whisper decoder layer's ``WhisperCache``, lengths included);
- the prefill replays ``prompt[:-1]`` through ``decode_fn`` on batch-1
  views of the slot's cache tensors, so it writes that slot alone (one
  prefill call per admission);
- a tick feeds each busy slot its last token (``prompt[-1]`` on the first
  tick).  It decodes every slot, so the shapes never change; a free slot
  decodes token 0 into its own rows, which no other slot reads (every
  batch row is computed on its own) and the next admission there zeroes.

Under Mixture-of-Experts the rows of a decode call are not computed on
their own by construction: the slots share one dispatch (``models/mlp.py:
moe``), and an expert's capacity could drop one slot's assignment for
another's.  Every row is still computed on its own because a decode call
dispatches at most ``DROPLESS_ASSIGNMENTS`` (token, k) assignments (a
batch of slots times top-k), where the capacity is raised to the token
count and nothing drops; each expert's rows then meet the other slots'
only as other rows of the same batched matmul, and the combine adds a
row's top-k outputs in a fixed order (no atomics).  So the engine refuses a
pool of slots large enough to pass that floor.

So a greedy answer is the greedy continuation of its prompt alone, whatever
else the engine serves.  A tick reads the sampled tokens back to the host
once, after its decode.  ``temperature > 0`` samples from
``softmax(logits / temperature)`` with a ``torch.Generator`` on the
engine's device, seeded from ``seed`` (JAX's key stream has no torch
counterpart, so only greedy answers are held against the reference).

On the card the engine decodes through CUDA graphs, the counterpart of the
reference's ``jax.jit(arch.decode_fn)``: at construction (``capture=None``
captures exactly when the device is CUDA; ``capture=True`` on the CPU
raises) it warms and captures one graph of the tick's decode of all
``batch`` slots, over a static (batch, 1) token buffer and static logits,
and one batch-1 graph per slot over ``slot(i)``'s views, which the prefill
replays once per prompt token; then it zeroes every cache tensor, so the
warm decodes leave no trace (admission zeroes a slot's rows anyway, and no
row reads another's).  The graphs read the params and caches where they
lay at the capture.  The sampler runs after the replay, outside the graph,
and the tick still reads back once.  The CPU engine decodes eagerly, the
same calls on the same tensors.

An encoder-decoder (Whisper) is served as the reference's ``_lm_main``
serves it: token prompts alone, against zeroed cross K/V that nothing
writes (ROADMAP C.15: the reference's requests carry no audio).  Its
decoder's learned position table has ``DEC_POS_ROWS`` rows, and ``submit``
refuses a request that would feed a position past them (C.16).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.lm import layer_kind
from repro_torch.models.mlp import DROPLESS_ASSIGNMENTS
from repro_torch.models.whisper import DEC_POS_ROWS


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (T,) int32
    max_new_tokens: int = 16
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                  temperature: float = 0.0) -> torch.Tensor:
    """(B, T, V) logits -> (B,) tokens for the last position: the argmax at
    temperature 0, else one draw from ``softmax(logits / temperature)``."""
    last = logits[:, -1, :]
    if temperature <= 0.0:
        return torch.argmax(last, dim=-1)
    probs = torch.softmax(last.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _kv_cache_bounds_positions(cfg, max_seq: int) -> bool:
    """Whether some layer's KV cache cannot hold every position a request
    may feed past ``max_seq``: a full (not sliding-window) cache, whose rows
    end at ``max_seq`` (an MLA layer's compressed cache is one), or a window cache of ``min(max_seq, swa_window)``
    rows that is shorter than its window, whose ring then drops context the
    window should see (ROADMAP C.11).  An encoder-decoder's decoder layers
    each hold a full self-attention cache."""
    if cfg.encoder_decoder:
        return True
    kinds = [layer_kind(cfg, i) for i in range(cfg.n_layers)]
    return any(k.mixer == "attn" and (not k.swa or max_seq < cfg.swa_window) for k in kinds)


def _tensors(cache) -> list:
    """Every tensor of one layer's cache (or its slot view)."""
    return cache.tensors() if hasattr(cache, "tensors") else list(cache)


class ServeEngine:
    def __init__(
        self,
        arch,
        params: Any,
        batch: int,
        max_seq: int,
        temperature: float = 0.0,
        eos_id: Optional[int] = None,
        seed: int = 0,
        capture: Optional[bool] = None,
    ):
        moe = arch.cfg.moe
        if moe is not None and batch * moe.top_k > DROPLESS_ASSIGNMENTS:
            raise ValueError(f"{batch} slots x top-{moe.top_k} = {batch * moe.top_k} "
                             f"assignments a decode call, past the dropless "
                             f"{DROPLESS_ASSIGNMENTS}: the slots' expert capacity would be "
                             "shared")
        self.arch = arch
        self.params = params
        self.batch = batch
        self.max_seq = max_seq
        self.temperature = temperature
        self.eos_id = eos_id
        self.device = arch.device
        self.caches = arch.make_caches(batch, max_seq)
        self.slots: list[Optional[Request]] = [None] * batch
        self.queue: list[Request] = []
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.prefill_calls = 0          # admissions: one prefill each
        self.prefill_tokens = 0         # prompt tokens replayed (batch-1 decode_fn calls)
        self.decode_calls = 0           # ticks that decoded the slots
        self._bounded = _kv_cache_bounds_positions(arch.cfg, max_seq)
        self._finished: list[Request] = []
        on_cuda = torch.device(self.device).type == "cuda"
        if capture and not on_cuda:
            raise ValueError(
                "capture=True needs a CUDA device: a CUDA graph has no CPU counterpart "
                "(the CPU engine decodes eagerly)"
            )
        self.capture = on_cuda if capture is None else bool(capture)
        self.graphs: dict = {}            # "tick" / "prefill/<slot>" -> CUDAGraph
        self.graph_launches: dict = {}    # the same keys -> kernel launches at the capture
        self.graph_pool_bytes: dict = {}
        self.replays = {"tick": 0, "prefill": 0}
        if self.capture:
            self._capture_graphs()

    # -- CUDA graphs ----------------------------------------------------------

    def _decode_calls(self) -> dict:
        """The decodes the graphs hold, by key: the tick over every slot
        and a batch-1 prefill decode per slot, each with its static token
        buffer and its caches (the slot views for a prefill)."""
        dev = torch.device(self.device)
        self._tok = torch.zeros((self.batch, 1), dtype=torch.int64, device=dev)
        self._ptok = torch.zeros((1, 1), dtype=torch.int64, device=dev)
        views = [[c.slot(i) for c in self.caches] for i in range(self.batch)]
        return {"tick": (self._tok, self.caches),
                **{f"prefill/{i}": (self._ptok, v) for i, v in enumerate(views)}}

    @torch.no_grad()
    def _warm(self, calls: dict) -> None:
        """``WARM_RUNS`` runs of every decode in ``calls``: they build the
        kernels, and write the caches, which ``_zero_caches`` then clears."""
        from repro_torch.serve.exec_cache import WARM_RUNS

        for _ in range(WARM_RUNS):
            for tok, caches in calls.values():
                self.arch.decode_fn(self.params, tok, caches)

    @torch.no_grad()
    def _zero_caches(self) -> None:
        for c in self.caches:
            for t in _tensors(c):
                t.zero_()

    @torch.no_grad()
    def _capture_graphs(self) -> None:
        """Warm and capture the tick's decode and one prefill decode per
        slot, then zero every cache tensor."""
        from repro_torch.serve.exec_cache import kernel_launch_counts

        dev = torch.device(self.device)
        calls = self._decode_calls()
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._warm(calls)
        cur.wait_stream(side)
        for key, (tok, caches) in calls.items():
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                reserved = torch.cuda.memory_reserved(dev)
                before = kernel_launch_counts()
                logits, _ = self.arch.decode_fn(self.params, tok, caches)
                after = kernel_launch_counts()
            self.graph_pool_bytes[key] = torch.cuda.memory_reserved(dev) - reserved
            self.graph_launches[key] = {k: v - before[k] for k, v in after.items()
                                        if v != before[k]}
            self.graphs[key] = graph
            if key == "tick":
                self._logits = logits
        self._zero_caches()

    # -- request lifecycle ----------------------------------------------------

    def submit(self, req: Request) -> None:
        """Queue ``req``.  A model whose KV cache bounds the positions must
        hold every position the request feeds: the prompt and all but the
        last answer token.  The reference serves such a request: a full cache
        writes each position past ``max_seq`` into the last row (ROADMAP
        C.10), and a window cache shorter than its window wraps its ring
        early (C.11), so the answer no longer sees its own context.  Here it
        is refused up front.  An encoder-decoder must also hold every
        position in its decoder's position table: the reference reads NaN
        rows past it (C.16), and a gather past it on the card is a
        device-side assert."""
        if len(req.prompt) < 1:
            raise ValueError(f"request {req.rid}: empty prompt")
        fed = len(req.prompt) + req.max_new_tokens - 1
        if self.arch.cfg.encoder_decoder and fed > DEC_POS_ROWS:
            raise ValueError(f"request {req.rid}: {len(req.prompt)} prompt + "
                             f"{req.max_new_tokens} new tokens feed positions up to {fed - 1}; "
                             f"the decoder's position table (dec_pos) has {DEC_POS_ROWS} rows")
        if self._bounded and fed > self.max_seq:
            window = self.arch.cfg.swa_window
            raise ValueError(f"request {req.rid}: {len(req.prompt)} prompt + "
                             f"{req.max_new_tokens} new tokens need {fed} cache rows; "
                             f"max_seq is {self.max_seq}"
                             + (f" (below the sliding window of {window})"
                                if window is not None and self.max_seq < window else ""))
        self.queue.append(req)

    def _prefill(self, i: int, prompt: np.ndarray) -> None:
        """Reset slot ``i`` and replay ``prompt[:-1]`` into it alone."""
        views = [c.slot(i) for c in self.caches]
        for view in views:
            for t in _tensors(view):
                t.zero_()
        toks = torch.as_tensor(np.asarray(prompt[:-1], np.int64)).to(self.device)
        for j in range(toks.shape[0]):
            if self.capture:
                self._ptok.copy_(toks[j:j + 1].view(1, 1))
                self.graphs[f"prefill/{i}"].replay()
                self.replays["prefill"] += 1
            else:
                self.arch.decode_fn(self.params, toks[j:j + 1].view(1, 1), views)
        self.prefill_tokens += toks.shape[0]

    @torch.no_grad()
    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot is None and self.queue:
                req = self.queue.pop(0)
                self.slots[i] = req
                self._prefill(i, req.prompt)
                self.prefill_calls += 1

    @torch.no_grad()
    def tick(self) -> int:
        """One engine iteration: admit + one decode of every slot.  Returns
        the number of busy slots."""
        self._admit()
        busy = [i for i, s in enumerate(self.slots) if s is not None]
        if not busy:
            return 0
        tok = np.zeros((self.batch, 1), np.int64)
        for i in busy:
            req = self.slots[i]
            tok[i, 0] = req.out_tokens[-1] if req.out_tokens else int(req.prompt[-1])
        if self.capture:
            self._tok.copy_(torch.from_numpy(tok))
            self.graphs["tick"].replay()
            self.replays["tick"] += 1
            logits = self._logits
        else:
            logits, _ = self.arch.decode_fn(self.params, torch.from_numpy(tok).to(self.device),
                                            self.caches)
        self.decode_calls += 1
        nxt = sample_logits(logits, self.generator, self.temperature).cpu().numpy()
        for i in busy:
            req = self.slots[i]
            t = int(nxt[i])
            req.out_tokens.append(t)
            if (self.eos_id is not None and t == self.eos_id) or len(
                req.out_tokens
            ) >= req.max_new_tokens:
                req.done = True
                self._finished.append(req)
                self.slots[i] = None
        return len(busy)

    def run(self, max_ticks: int = 1000) -> list[Request]:
        while (self.queue or any(s is not None for s in self.slots)) and max_ticks:
            self.tick()
            max_ticks -= 1
        return self._finished
