"""What the captured LM decode (ROADMAP A item 1b) depends on, on the CPU.

On the card ``ServeEngine`` warms its decodes (the tick over every slot and
a batch-1 prefill decode per slot), captures each as a CUDA graph, then
zeroes every cache tensor.  A graph runs only on the card; these tests hold
the rest:

- ``capture=True`` refuses the CPU, ``capture=None`` decodes eagerly there,
  and the serve launcher says so;
- an engine whose caches the warm decodes dirtied, then zeroed, answers
  greedily bit for bit as a fresh engine does - logits and tokens - with a
  request admitted into a freed slot while the others decode, for a KV
  cache (Qwen2), an SSM state (Mamba2), MLA's compressed cache
  (DeepSeek-V3) and Whisper's caches.
"""
import numpy as np
import pytest
import torch

import repro_torch.serve.engine as engine_mod
from repro_torch.models import registry as treg
from repro_torch.serve.engine import Request, ServeEngine


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_capture_refuses_the_cpu_and_none_decodes_eagerly():
    arch = treg.get_arch("qwen2-7b", reduced=True, device="cpu")
    with pytest.raises(ValueError, match="capture=True needs a CUDA device"):
        ServeEngine(arch, None, batch=2, max_seq=16, capture=True)
    eng = ServeEngine(arch, None, batch=2, max_seq=16)
    assert eng.capture is False and eng.graphs == {}
    assert ServeEngine(arch, None, batch=2, max_seq=16, capture=False).capture is False


def test_serve_launcher_decodes_eagerly_on_the_cpu(capsys):
    from repro_torch.launch.serve import main

    assert main(["--device", "cpu", "--arch", "qwen2-7b", "--requests", "3", "--slots", "2",
                 "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests, 9 tokens" in out and "decode: eager on cpu" in out


def _serve(eng, prompts, news):
    """Each request's answer and its logits at each of its ticks."""
    seen = {}
    real = engine_mod.sample_logits

    def record(logits, generator, temperature):
        for i, r in enumerate(eng.slots):
            if r is not None:
                seen.setdefault(r.rid, []).append(logits[i, -1].clone())
        return real(logits, generator, temperature)

    engine_mod.sample_logits = record
    try:
        for rid, (p, n) in enumerate(zip(prompts, news)):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=n))
        done = eng.run(max_ticks=200)
    finally:
        engine_mod.sample_logits = real
    return {r.rid: r.out_tokens for r in done}, {k: torch.stack(v) for k, v in seen.items()}


@pytest.mark.parametrize("name", ["qwen2-7b", "mamba2-780m", "deepseek-v3-671b",
                                  "whisper-medium"])
def test_warm_decodes_then_zeroed_caches_leave_no_trace(name):
    arch = treg.get_arch(name, reduced=True, device="cpu")
    params = arch.init(0)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, arch.cfg.vocab, size=int(n)).astype(np.int32) for n in (4, 7, 5)]
    news = [3, 8, 6]          # request 2 waits for request 0's slot, then decodes beside 1

    fresh = ServeEngine(arch, params, batch=2, max_seq=32)
    want_tokens, want_logits = _serve(fresh, prompts, news)

    warmed = ServeEngine(arch, params, batch=2, max_seq=32)
    calls = warmed._decode_calls()
    for tok, _ in calls.values():
        tok.copy_(torch.from_numpy(rng.integers(0, arch.cfg.vocab, tok.shape)))
    warmed._warm(calls)
    dirty = [t.clone() for c in warmed.caches for t in engine_mod._tensors(c)]
    assert any(bool(t.ne(0).any()) for t in dirty)             # the warm decodes wrote
    warmed._zero_caches()
    assert all(bool(t.eq(0).all()) for c in warmed.caches for t in engine_mod._tensors(c))
    got_tokens, got_logits = _serve(warmed, prompts, news)

    assert got_tokens == want_tokens and sorted(got_tokens) == [0, 1, 2]
    assert [len(got_tokens[i]) for i in range(3)] == news
    assert set(got_logits) == set(want_logits)
    assert all(torch.equal(got_logits[k], want_logits[k]) for k in want_logits)
