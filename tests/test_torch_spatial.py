"""The port's untiled reference layers (``repro_torch.core.spatial``) against
the JAX reference on the same params: JAX initialises them, numpy carries
them over (``repro_torch.interop.params_from_jax``).  Tolerance atol=1e-5,
the serve tests' bar (tests/test_serve_cnn.py)."""
import jax
import numpy as np
import pytest
import torch

from repro.core import spatial as jsp
from repro_torch.core import spatial as tsp
from repro_torch.interop import params_from_jax

ATOL = 1e-5

JLAYERS = [
    jsp.LayerDef(3, 1, 3, 8, act="leaky", batch_norm=True, use_bias=False),
    jsp.LayerDef(2, 2, 8, 8, pool=True, act="linear"),
    jsp.LayerDef(3, 1, 8, 8, act="relu"),
    jsp.LayerDef(1, 1, 8, 4, act="linear", batch_norm=True),
    jsp.LayerDef(3, 2, 4, 6, act="leaky"),
    jsp.LayerDef(3, 1, 6, 5, act="gelu"),
]


def _port_layers():
    import dataclasses

    return [tsp.LayerDef(**dataclasses.asdict(l)) for l in JLAYERS]


def _np_params(params):
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _setup(seed=0, batch=3, hw=(12, 12)):
    jparams = jsp.init_stack_params(jax.random.PRNGKey(seed), JLAYERS)
    # non-trivial biases / BN affine so every term is exercised
    rng = np.random.default_rng(seed)
    jparams = [
        {k: (np.asarray(v) if k == "w" else rng.standard_normal(np.shape(v)).astype(np.float32)
             if k in ("b", "bn_bias") else np.asarray(v) + 0.5 * rng.random(np.shape(v)).astype(np.float32))
         for k, v in p.items()}
        for p in jparams
    ]
    x = rng.standard_normal((batch, *hw, 3)).astype(np.float32)
    return jparams, x


def test_layerdef_geometry_matches():
    for jl, tl in zip(JLAYERS, _port_layers()):
        assert (jl.padding, jl.halo, jl.out_extent(13)) == (tl.padding, tl.halo, tl.out_extent(13))
        assert jl.spec().__dict__ == tl.spec().__dict__


@pytest.mark.parametrize("li", range(len(JLAYERS)))
@pytest.mark.parametrize("inference", [False, True])
def test_apply_layer_reference_matches_jax(li, inference):
    jparams, x = _setup()
    if inference:
        jparams = _np_params(jsp.freeze_bn_stats(jparams, JLAYERS, x))
    # run the prefix in JAX to get this layer's input
    xin = np.asarray(jsp.stack_reference(x, jparams[:li], JLAYERS[:li]))
    want = np.asarray(jsp.apply_layer_reference(xin, jparams[li], JLAYERS[li], inference=inference))
    tp = params_from_jax(jparams, "cpu")
    got = tsp.apply_layer_reference(torch.from_numpy(xin), tp[li], _port_layers()[li],
                                    inference=inference).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_freeze_bn_stats_and_inference_stack_match_jax():
    jparams, x = _setup(seed=1)
    jfrozen = _np_params(jsp.freeze_bn_stats(jparams, JLAYERS, x))
    tfrozen = tsp.freeze_bn_stats(params_from_jax(jparams, "cpu"), _port_layers(),
                                  torch.from_numpy(x))
    for jp, tp in zip(jfrozen, tfrozen):
        assert set(jp) == set(tp)
        for k in jp:
            np.testing.assert_allclose(tp[k].numpy(), jp[k], atol=ATOL, rtol=1e-5)
    want = np.asarray(jsp.stack_reference(x, jfrozen, JLAYERS, inference=True))
    got = tsp.stack_reference(torch.from_numpy(x), tfrozen, _port_layers(),
                              inference=True).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # frozen-stats inference on the calibration batch == the training forward
    train = tsp.stack_reference(torch.from_numpy(x), tfrozen, _port_layers()).numpy()
    np.testing.assert_allclose(got, train, atol=ATOL)


def test_inference_needs_frozen_stats():
    jparams, x = _setup()
    with pytest.raises(ValueError, match="freeze_bn_stats"):
        tsp.apply_layer_reference(torch.from_numpy(x), params_from_jax(jparams, "cpu")[0],
                                  _port_layers()[0], inference=True)


def test_init_params_shapes_and_seeded():
    layers = _port_layers()
    a = tsp.init_stack_params(torch.Generator().manual_seed(3), layers)
    b = tsp.init_stack_params(torch.Generator().manual_seed(3), layers)
    j = jsp.init_stack_params(jax.random.PRNGKey(3), JLAYERS)
    for pa, pb, pj in zip(a, b, j):
        assert set(pa) == set(pj)
        for k in pa:
            assert tuple(pa[k].shape) == tuple(np.shape(pj[k]))
            assert torch.equal(pa[k], pb[k])
    w = a[2]["w"]                      # He init: std sqrt(2 / fan_in)
    assert abs(float(w.std()) - np.sqrt(2.0 / (9 * 8))) < 0.1


def test_offmap_and_core_masks_match_jax_per_tile():
    """The virtual mesh's per-tile (n, m, ext_h, ext_w) off-map mask equals
    the reference's per-device mask (spatial.py:_offmap_mask, whose tile
    index comes from lax.axis_index) at every tile index."""
    n, m, eh, ew = 2, 3, 9, 7
    halo, shard, mp = (2, 1, 1, 2), (6, 4), (12, 11)
    got = tsp._offmap_mask(n, m, eh, ew, halo, shard, mp).numpy()
    assert got.shape == (n, m, eh, ew)
    for i in range(n):
        for j in range(m):
            row0 = i * shard[0] - halo[0]
            col0 = j * shard[1] - halo[2]
            rows = row0 + np.arange(eh)
            cols = col0 + np.arange(ew)
            want = ((rows >= 0) & (rows < mp[0]))[:, None] & ((cols >= 0) & (cols < mp[1]))[None, :]
            np.testing.assert_array_equal(got[i, j], want.astype(np.float32))
    np.testing.assert_array_equal(
        tsp._core_mask(eh, ew, halo).numpy(), np.asarray(jsp._core_mask(eh, ew, halo))
    )
