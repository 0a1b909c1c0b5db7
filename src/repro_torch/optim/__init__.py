"""Optimizers, learning-rate schedules, the trainer's int8 error feedback and
the wire codecs.

Re-exports the names of ``repro/optim/__init__.py``.
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
    WireCodec,
    ef_encode,
    get_codec,
    int8_compress,
    int8_decompress,
    modeled_wire_bytes,
)
