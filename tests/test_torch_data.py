"""The port's ``SyntheticStream`` against ``synth_batch`` and the reference's
stream (``tests/test_data.py``'s cases): streams started at steps 0 and 3
give the same batches bit for bit, placed on the stream's device, and
``close()`` ends the prefetching thread."""
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape
from repro.data import synthetic as jsyn
from repro.models import registry as jreg
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import synthetic as tsyn
from repro_torch.models import registry as treg


def _specs():
    cfg = treg.load_config("stablelm-1.6b", reduced=True)
    return treg.bundle_from_cfg(cfg, "cpu").input_specs(ShapeConfig("t", 16, 2, "train")), cfg


def _take(stream, n):
    try:
        return [next(stream) for _ in range(n)]
    finally:
        stream.close()


@pytest.mark.parametrize("start", [0, 3])
def test_stream_is_synth_batch_from_its_start_step(start):
    specs, cfg = _specs()
    got = _take(tsyn.SyntheticStream(specs, cfg, seed=0, start_step=start, prefetch=1,
                                     device="cpu"), 4)
    assert [s for s, _ in got] == list(range(start, start + 4))
    for step, batch in got:
        want = tsyn.synth_batch(specs, cfg, 0, step)
        assert set(batch) == set(want) == {"tokens", "labels"}
        for k, v in batch.items():
            assert v.device.type == "cpu" and torch.equal(v, torch.from_numpy(want[k])), (step, k)


def test_stream_is_the_reference_stream_and_resumes_exactly():
    """tests/test_data.py::test_stream_resume_replays_exactly on the port,
    and each batch equal to the reference stream's."""
    specs, cfg = _specs()
    jcfg = jreg.load_config("stablelm-1.6b", reduced=True)
    jspecs = jreg.bundle_from_cfg(jcfg).input_specs(JShape("t", 16, 2, "train"))
    first = _take(tsyn.SyntheticStream(specs, cfg, seed=0, start_step=0, prefetch=1,
                                       device="cpu"), 5)
    resumed = _take(tsyn.SyntheticStream(specs, cfg, seed=0, start_step=3, prefetch=1,
                                         device="cpu"), 2)
    ref = jsyn.SyntheticStream(jspecs, jcfg, seed=0, start_step=0, prefetch=1)
    try:
        want = [next(ref) for _ in range(5)]
    finally:
        ref.close()
    for (s1, b1), (s2, b2) in zip(first[3:], resumed):
        assert s1 == s2 and all(torch.equal(b1[k], b2[k]) for k in b1)
    for (s1, b1), (sj, bj) in zip(first, want):
        assert s1 == sj
        for k in bj:
            np.testing.assert_array_equal(b1[k].numpy(), np.asarray(bj[k]))


def test_close_ends_the_worker():
    specs, cfg = _specs()
    stream = tsyn.SyntheticStream(specs, cfg, prefetch=2, device="cpu")
    assert stream._thread.is_alive()
    next(stream)
    stream.close()
    assert not stream._thread.is_alive()


def test_stream_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    specs, cfg = _specs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsyn.SyntheticStream(specs, cfg)
