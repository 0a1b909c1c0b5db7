"""Optimizers, learning-rate schedules and the trainer's int8 error feedback.

Re-exports the names of ``repro/optim/__init__.py`` that the port defines;
the codec executor (``WireCodec``'s encode/decode, ``ef_encode``) arrives
with ROADMAP A.14 (``tests/test_torch_api.py`` keeps the list).
"""
from repro_torch.optim.optimizers import (
    Optimizer,
    adamw,
    adafactor,
    sgd,
    make_optimizer,
    global_norm,
    clip_by_global_norm,
)
from repro_torch.optim.schedules import cosine_schedule, linear_warmup
from repro_torch.optim.compression import (
    CompressionState,
    get_codec,
    int8_compress,
    int8_decompress,
    modeled_wire_bytes,
)
