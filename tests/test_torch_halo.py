"""Virtual-mesh halo exchange (``repro_torch.core.halo``): every tile's
halo-extended block equals the corresponding window of the zero-padded
global map - the semantics scripts/check_halo.py asserts for the JAX
``shard_map`` exchange, corners included."""
import numpy as np
import pytest
import torch

from repro.core.halo import _shift_perm as jax_shift_perm
from repro_torch.core.halo import _shift, _shift_perm, halo_exchange_1d, halo_exchange_2d
from repro_torch.launch.mesh import make_tile_mesh


@pytest.mark.parametrize("n", [1, 2, 5])
@pytest.mark.parametrize("direction", [1, -1])
def test_shift_is_the_reference_permutation(n, direction):
    assert _shift_perm(n, direction) == jax_shift_perm(n, direction)
    x = torch.arange(n * 3, dtype=torch.float32).reshape(n, 3) + 1
    y = _shift(x, 0, direction)
    want = torch.zeros_like(x)
    for s, d in _shift_perm(n, direction):
        want[d] = x[s]
    assert torch.equal(y, want)


@pytest.mark.parametrize(
    "grid,halo",
    [((2, 2), (1, 1, 1, 1)), ((2, 2), (3, 2, 2, 3)), ((1, 3), (2, 1, 1, 2)),
     ((1, 3), (0, 0, 2, 0)), ((3, 2), (1, 0, 0, 1))],
)
def test_halo_exchange_2d_equals_padded_global_windows(grid, halo):
    n, m = grid
    th, tw, b, c = 4, 5, 2, 3
    top, bottom, left, right = halo
    mesh = make_tile_mesh(n, m, "cpu")
    rng = np.random.default_rng(0)
    g = rng.standard_normal((b, n * th, m * tw, c)).astype(np.float32)
    tiles = mesh.split(torch.from_numpy(g))
    y = halo_exchange_2d(tiles, halo).numpy()
    assert y.shape == (n, m, b, th + top + bottom, tw + left + right, c)
    gp = np.pad(g, ((0, 0), (top, bottom), (left, right), (0, 0)))
    for i in range(n):
        for j in range(m):
            want = gp[:, i * th:i * th + th + top + bottom, j * tw:j * tw + tw + left + right]
            np.testing.assert_array_equal(y[i, j], want)


def test_mesh_split_merge_roundtrip_row_major():
    mesh = make_tile_mesh(2, 3, "cpu")
    g = torch.arange(1 * 4 * 6 * 1, dtype=torch.float32).reshape(1, 4, 6, 1)
    t = mesh.split(g)
    assert t.shape == (2, 3, 1, 2, 2, 1)
    assert torch.equal(t[1, 2, 0, :, :, 0], g[0, 2:4, 4:6, 0])
    assert torch.equal(mesh.merge(t), g)
    with pytest.raises(ValueError, match="split evenly"):
        mesh.split(torch.zeros(1, 5, 6, 1))


def test_halo_wider_than_tile_rejected():
    x = torch.zeros(2, 1, 1, 3, 3, 1)
    with pytest.raises(ValueError, match="exceeds the tile extent"):
        halo_exchange_1d(x, 4, 0, tile_dim=0, dim=3)


def test_cuda_mesh_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_tile_mesh(2, 2)
