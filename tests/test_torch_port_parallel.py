"""pose3d_tpu_torch's parallel layouts and mesh arithmetic against the JAX
package's, without processes: ``fsdp_param_spec`` (alone and over a TP
base), ``tp_param_spec`` and ``pp_param_spec`` pick, leaf for leaf through
the weight bridge, the same elements for each shard as the JAX specs on
the tiny CNN and transformer at axis sizes 2, 4 and 8 (exact: a marker of
each element's shard is carried across by ``compat_export``); the fusion
blocks stay whole under TP; ``stack_vit_blocks`` / ``unstack_vit_blocks``
round-trip as JAX's and a stacked JAX tree bridges to the looped state
dict; ``make_mesh``, ``make_data_mesh_for_batch``, ``make_hybrid_mesh``
(unequal groups raise), ``batch_axes`` and ``local_batch_size`` give
JAX's device arrays and sizes over ranks."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from torch_port_helpers import TINY_KW

from pose3d_tpu import parallel as jpar
from pose3d_tpu.core import mesh as jmesh
from pose3d_tpu.core.config import CNNModelConfig as JCNN
from pose3d_tpu.core.config import TransformerModelConfig as JTR
from pose3d_tpu.models import init_model

from pose3d_tpu_torch import parallel as tpar
from pose3d_tpu_torch.compat import state_dict_from_jax
from pose3d_tpu_torch.compat_export import (
    export_reference_cnn,
    export_reference_transformer,
)
from pose3d_tpu_torch.core import mesh as tmesh
from pose3d_tpu_torch.core.config import CNNModelConfig, \
    TransformerModelConfig
from pose3d_tpu_torch.models import build_model

TINY_CNN = dict(
    image_size=(50, 50), heatmap_size=50, initial_channels=8,
    stage_channels=(16, 32, 64), stage_depths=(1, 3, 3),
    global_pool_size=2, global_feature_dim=32, regression_dims=(32, 16),
)
# eight ViT blocks and eight heads: counts that 2, 4 and 8 ranks divide
DEEP_KW = dict(TINY_KW, vit_depth=8, vit_heads=8, transformer_heads=8)
WEIGHT = {"data": 1, "model": 100, "stage": 10000}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """{kind: (JAX config, JAX variables, port model)} for the tiny CNN
    and the 8-block tiny transformer."""
    out = {}
    for kind, jcfg, tcfg in (
            ("cnn", JCNN(**TINY_CNN), CNNModelConfig(**TINY_CNN)),
            ("transformer", JTR(**DEEP_KW), TransformerModelConfig(
                **DEEP_KW))):
        _, variables = init_model(jcfg, rng=jax.random.PRNGKey(0))
        out[kind] = (jcfg, _np(variables),
                     build_model(tcfg, device="cpu", dtype=torch.float32))
    return out


def _jax_marker(leaf, spec, n):
    """1 + Σ over sharded dims of (the element's shard index) · weight."""
    shape = np.shape(leaf)
    m = np.ones(shape, np.int64)
    for d, axis in enumerate(tuple(spec) + (None,) * (len(shape)
                                                      - len(spec))):
        if axis is None:
            continue
        idx = np.arange(shape[d]) // (shape[d] // n)
        m = m + WEIGHT[axis] * idx.reshape([-1 if i == d else 1
                                            for i in range(len(shape))])
    return m


def _port_marker(shape, spec, n):
    """The same marker from a port ``ParamSpec`` on the full parameter."""
    view = spec.view or shape
    m = np.ones(view, np.int64)
    for d, axis in enumerate(spec.dims):
        if axis is None:
            continue
        idx = np.arange(view[d]) // (view[d] // n)
        m = m + WEIGHT[axis] * idx.reshape([-1 if i == d else 1
                                            for i in range(len(view))])
    if spec.stage is not None:
        m = m + WEIGHT["stage"] * spec.stage
    return m.reshape(shape)


def _bridge(kind, cfg, variables, params_markers):
    tree = {"params": params_markers,
            "batch_stats": variables.get("batch_stats", {})}
    export = export_reference_cnn if kind == "cnn" else \
        export_reference_transformer
    w = export(tree, cfg)
    return {k: w.sd[k] for k in w.param_keys}


def _check(kind, models, jax_specs, port_specs, n, params=None):
    cfg, variables, model = models[kind]
    params = variables["params"] if params is None else params
    markers = jax.tree_util.tree_map(
        lambda leaf, spec: _jax_marker(leaf, spec, n), params, jax_specs,
        is_leaf=lambda x: isinstance(x, P))
    bridged = _bridge(kind, cfg, variables, markers)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert set(bridged) == set(shapes) == set(port_specs)
    sharded = 0
    for name, want in bridged.items():
        got = _port_marker(shapes[name], port_specs[name], n)
        np.testing.assert_array_equal(got, want, err_msg=name)
        sharded += port_specs[name].sharded
    return sharded


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("kind", ["cnn", "transformer"])
def test_fsdp_spec_matches_jax(models, kind, n):
    params = models[kind][1]["params"]
    jspec = jpar.fsdp_param_spec(params, n)
    assert _check(kind, models, jspec,
                  tpar.fsdp_param_spec(models[kind][2], n), n) > 5


@pytest.mark.parametrize("n", [2, 4, 8])
def test_tp_spec_matches_jax_and_keeps_fusion_whole(models, n):
    """TP alone, and FSDP over the TP base (the 2-D layout); only the
    encoder blocks' attention and MLP are sharded, the fusion blocks'
    stay whole in both packages."""
    _, variables, model = models["transformer"]
    jspec = jpar.tp_param_spec(variables["params"])
    tspec = tpar.tp_param_spec(model)
    sharded = {k for k, s in tspec.items() if s.sharded}
    assert sharded and not any("cross_modal_fusion" in k for k in sharded)
    for name, leaf in jax.tree_util.tree_leaves_with_path(
            jspec["fusion_0"], is_leaf=lambda x: isinstance(x, P)):
        assert leaf == P(), name
    assert all(k.startswith(("vit_backbone.blocks.", "final_encoder."))
               for k in sharded)
    _check("transformer", models, jspec, tspec, n)
    both_j = jpar.fsdp_param_spec(variables["params"], n, base_specs=jspec)
    both_t = tpar.fsdp_param_spec(model, n, base_specs=tspec)
    # FSDP takes the data axis beside TP's model axis
    assert any(set(s.dims) >= {"data", "model"} for s in both_t.values())
    _check("transformer", models, both_j, both_t, n)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_pp_spec_matches_jax(models, n):
    _, variables, model = models["transformer"]
    params = dict(variables["params"])
    params["vit_backbone"] = jpar.stack_vit_blocks(params["vit_backbone"])
    jspec = jpar.pp_param_spec(params)
    tspec = tpar.pp_param_spec(model, n)
    assert sum(s.stage is not None for s in tspec.values()) == \
        sum(1 for k in tspec if k.startswith("vit_backbone.blocks."))
    _check("transformer", models, jspec, tspec, n, params=params)
    with pytest.raises(ValueError, match="not divisible"):
        tpar.pp_param_spec(model, 3)


def test_stack_unstack_and_the_stacked_bridge(models):
    cfg, variables, _ = models["transformer"]
    vit = variables["params"]["vit_backbone"]
    stacked = tpar.stack_vit_blocks(vit)
    want = _np(jpar.stack_vit_blocks(vit))
    jax.tree_util.tree_map(np.testing.assert_array_equal, stacked, want)
    back = tpar.unstack_vit_blocks(stacked)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, vit)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           _np(jpar.unstack_vit_blocks(want)))
    with pytest.raises(ValueError, match="no block_"):
        tpar.stack_vit_blocks({"norm": vit["norm"]})
    looped = state_dict_from_jax(variables, cfg)
    svars = {"params": {**variables["params"], "vit_backbone": stacked}}
    got = state_dict_from_jax(svars, cfg)
    assert list(got) == list(looped)
    for k in looped:
        assert torch.equal(got[k], looped[k]), k


def _ids(mesh):
    return np.vectorize(lambda d: d.id)(mesh.devices)


@pytest.mark.parametrize("shape,axes", [
    ((-1,), ("data",)), ((2, 4), ("data", "model")),
    ((4, -1), ("data", "stage")), ((2, 2), ("data", "model")),
])
def test_make_mesh_matches_jax(shape, axes):
    devs = jax.devices()[:8]
    j = jmesh.make_mesh(shape, axes, devices=devs)
    t = tmesh.make_mesh(shape, axes, devices=[d.id for d in devs])
    np.testing.assert_array_equal(t.devices, _ids(j))
    assert t.axis_names == j.axis_names and dict(t.shape) == dict(j.shape)
    assert tmesh.batch_axes(t) == jmesh.batch_axes(j)
    with pytest.raises(ValueError, match="needs"):
        tmesh.make_mesh((16,), ("data",), devices=range(8))


@pytest.mark.parametrize("batch", [1, 2, 6, 8, 12])
def test_data_mesh_for_batch_matches_jax(batch):
    devs = jax.devices()[:8]
    j = jmesh.make_data_mesh_for_batch(batch, devices=devs)
    t = tmesh.make_data_mesh_for_batch(batch, devices=range(8))
    np.testing.assert_array_equal(t.devices, _ids(j))
    for g in (batch * 8, 24):
        try:
            want = jmesh.local_batch_size(g, j)
        except ValueError:
            with pytest.raises(ValueError, match="not divisible"):
                tmesh.local_batch_size(g, t)
            continue
        assert tmesh.local_batch_size(g, t) == want


def test_hybrid_mesh_matches_jax_and_refuses_unequal_groups():
    devs = jax.devices()[:8]
    for groups in (2, 4):
        per = 8 // groups

        def key(d, per=per):
            return (d if isinstance(d, int) else d.id) // per

        j = jmesh.make_hybrid_mesh(devices=devs, slice_key=key)
        t = tmesh.make_hybrid_mesh(devices=range(8), slice_key=key)
        np.testing.assert_array_equal(t.devices, _ids(j))
        assert t.axis_names == j.axis_names == ("replica", "data")
        assert tmesh.batch_axes(t) == jmesh.batch_axes(j)
        assert tmesh.local_batch_size(16, t) == jmesh.local_batch_size(16, j)
        j2 = jmesh.make_hybrid_mesh((2, -1), ("data", "model"), devices=devs,
                                    slice_key=key)
        t2 = tmesh.make_hybrid_mesh((2, -1), ("data", "model"),
                                    devices=range(8), slice_key=key)
        np.testing.assert_array_equal(t2.devices, _ids(j2))
    # one group on an unsplit job: a (1, n) mesh
    t = tmesh.make_hybrid_mesh(devices=range(4))
    assert t.devices.shape == (1, 4)

    def uneven(d):
        return int((d if isinstance(d, int) else d.id) < 3)

    for make, ds in ((jmesh.make_hybrid_mesh, devs),
                     (tmesh.make_hybrid_mesh, range(8))):
        with pytest.raises(ValueError, match="unequal"):
            make(devices=ds, slice_key=uneven)


def test_shard_batch_takes_this_ranks_rows():
    """One process is rank 0 of a mesh of one: it keeps every row; a
    tensor_split of a ragged batch over the batch axes, by rank."""
    t = tmesh.make_mesh((1,), ("data",), devices=[0])
    b = {"x": np.arange(12).reshape(2, 6), "_pos": (1, 2)}
    assert tmesh.shard_batch(t, b, batch_axis=1)["x"].shape == (2, 6)
    m = tmesh.Mesh(np.arange(4).reshape(2, 2), ("replica", "data"))
    rows = [m.coords(r) for r in range(4)]
    assert rows[3] == {"replica": 1, "data": 1}
    from pose3d_tpu_torch.core.comm import chunk_sizes

    assert chunk_sizes(1025, 2) == [513, 512] and chunk_sizes(5, 4) == \
        [2, 1, 1, 1]
