"""ROADMAP C.18: an idle Whisper slot's position passes the decoder's
position table while another slot serves.

The engine decodes every slot at every tick, idle ones too, and each call
advances every slot's ``lengths``; a client that sends one request at a
time leaves a higher slot idle for good, so after ~8191 ticks its position
passes ``dec_pos``'s ``DEC_POS_ROWS`` rows.  The reference's ``jnp.take``
gives that row NaN and leaves the busy rows alone; the port's gather raised
``IndexError`` on the CPU (a device-side assert on the card).  Here slot 1's
``lengths`` are written to ``DEC_POS_ROWS - 2`` in every layer (standing in
for the idle ticks), and the engine ticks past the table's end while slot 0
serves: slot 0's logits stay within the decode bar of the reference's
``whisper_decode_step`` on the same state at every tick, and slot 1 stays
finite (the reference's reads NaN there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.serve.engine as engine_mod
from repro.configs import whisper_medium as jwm
from repro.models import attention as jattn
from repro.models import whisper as jw
from repro_torch.models import registry as treg
from repro_torch.models.whisper import DEC_POS_ROWS
from repro_torch.serve.engine import Request, ServeEngine

DECODE_BAR = dict(atol=2e-2, rtol=2e-2)      # tests/test_attention.py:94-96
JCFG = jwm.reduced()
TICKS = 4                                    # slot 1 at positions 8190 .. 8193


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_jax(v) for v in tree)
    return jnp.asarray(tree.numpy())


def _jax_caches(caches):
    """Copies of the port's Whisper caches, as they stand, in the reference's
    form (copies: JAX may read a numpy buffer after the port has written
    the tensor under it)."""
    def arr(t):
        return jnp.asarray(t.numpy().copy())

    return [{"self": jattn.KVCache(*(arr(t) for t in c.attn)), "cross_k": arr(c.cross_k),
             "cross_v": arr(c.cross_v)} for c in caches]


def test_c18_idle_slot_past_dec_pos_keeps_the_busy_slot_and_stays_finite():
    arch = treg.get_arch("whisper-medium", reduced=True, device="cpu")
    params = arch.init(0)
    jp = _to_jax(params)
    eng = ServeEngine(arch, params, batch=2, max_seq=64)
    prompt = np.array([5, 17, 3], np.int32)
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=TICKS + 2))
    eng._admit()                                          # slot 0 prefilled, slot 1 idle
    for c in eng.caches:
        c.attn.lengths[1] = DEC_POS_ROWS - 2
    seen = []
    real = engine_mod.sample_logits

    def record(logits, generator, temperature):
        seen.append(logits[:, -1].clone())
        return real(logits, generator, temperature)

    dec = jax.jit(lambda c, t: jw.whisper_decode_step(jp, t, c, JCFG))
    engine_mod.sample_logits = record
    try:
        for i in range(TICKS):
            req = eng.slots[0]
            fed = req.out_tokens[-1] if req.out_tokens else int(prompt[-1])
            jl, _ = dec(_jax_caches(eng.caches), jnp.asarray([[fed], [0]], jnp.int32))
            want = np.asarray(jl)[:, -1]
            eng.tick()
            got = seen[-1].numpy()
            np.testing.assert_allclose(got[0], want[0], **DECODE_BAR, err_msg=f"tick {i}")
            assert np.isfinite(got[1]).all(), i
            if int(eng.caches[0].attn.lengths[1]) > DEC_POS_ROWS:
                assert np.isnan(want[1]).all(), i             # the reference's row past the table
    finally:
        engine_mod.sample_logits = real
    assert [int(x) for x in eng.caches[0].attn.lengths] == [len(prompt) - 1 + TICKS,
                                                            DEC_POS_ROWS - 2 + TICKS]
    assert eng.slots[0] is not None and len(eng.slots[0].out_tokens) == TICKS
