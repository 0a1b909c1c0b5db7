"""Tile geometry, conv backends, halo exchange and the tiled executor.

Re-exports the names of ``repro/core/__init__.py`` that the port defines;
the rest arrive with the ROADMAP item that ports them
(``tests/test_torch_api.py`` keeps the list).
"""
from repro_torch.core.tiling import (
    ConvSpec,
    Span,
    TileBox,
    TilePartition,
    Group,
    MODES,
    apply_crossover,
    crossover_of,
    dependent_region_1d,
    even_bounds_1d,
    forward_region_1d,
    partition_1d,
    partition_grid,
    no_grouping,
    pipeline_first_of,
    single_group,
    uniform_grouping,
    build_tiling_plan,
    group_halo_width,
    pull_bounds_1d,
    push_bounds_1d,
    validate_profile,
)
from repro_torch.core.spatial import (
    LayerDef,
    freeze_bn_stats,
    init_stack_params,
    stack_reference,
)
from repro_torch.core.halo import (
    halo_exchange_1d,
    halo_exchange_2d,
)
from repro_torch.core.backend import (
    ConvBackend,
    conv_backend_names,
    get_conv_backend,
    register_conv_backend,
)
from repro_torch.core.fusion import (
    StackPlan,
    build_stack_plan,
    apply_stack_local,
    make_tiled_forward,
    make_tiled_infer,
    make_tiled_loss,
    make_deferred_grad_step,
    plan_manifest,
)
