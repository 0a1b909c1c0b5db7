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
    apply_layer_data,
    freeze_bn_stats,
    init_stack_params,
    reshard_spatial_to_data,
    split_1d,
    stack_reference,
)
from repro_torch.core.halo import (
    halo_exchange_1d,
    halo_exchange_1d_packed,
    halo_exchange_2d,
    halo_exchange_2d_packed,
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
    resolve_hw_profile,
)
from repro_torch.core.grouping import (
    ClusterSpec,
    HardwareProfile,
    PIPELINE_MICROBATCHES,
    PI3_PROFILE,
    JETSON_PROFILE,
    JETSON_EDGE_PROFILE,
    TPU_V5E_PROFILE,
    PROFILES,
    add_device,
    balance_bounds,
    balance_stages,
    bubble_fraction,
    check_pipeline_arg,
    cluster_from_manifest,
    cluster_manifest,
    cluster_partition,
    drop_device,
    feasible_stage_counts,
    modeled_step_wire_bytes,
    pack_devices,
    parse_cluster_spec,
    peak_device_memory,
    profile_cost,
    score_profile,
    optimize_grouping,
)
