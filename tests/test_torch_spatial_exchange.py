"""The spatial axis's exchanges and band layers on gloo ranks, and its
refusals.

(a) Every geometry the flagship runs on a band (`tests/_spatial_runs.py::
LAYERS`: 1x1 and 3x3 convs at stride 1 and 2, the ASPP's depthwise convs at
dilations 6, 12 and 18, the S2D stem, a DWBlock through the fused kernel's
path, the align-corners resizes of the neck and of the context stream, and
`gather_rows`) on each rank's band against the same layer on the whole map,
in f64: the band of the output, and the band of the input's gradient of
sum(out * G) (each rank's loss its band's share), which the backward of
`parallel.spatial.rows` sends back to the rows' owners. Ranks: a spatial
axis of 4 (maps of 2, 9 and 16 rows: empty and short bands, and the
ASPP's halo beyond the neighbours, where every band is gathered), of 3 (5
rows, the fourth rank idle) and of 2 inside a 2x2 mesh (16 rows, two such
axes at once over their own groups). Held within 1e-12 of the largest
entry of the whole map's output and gradient: the band conv sums the same
products as the whole conv, and this host reads at most 4e-16 (the fused
kernel's path, which takes f32 only, reads 3e-7 and is held within 1e-5:
its plain version's matmuls sum in other orders on other row counts).

(f) The refusals, in this process (none reaches a collective): a mesh with
too few ranks, the `seq` and `model` axes, rows that do not divide at the
step's boundary, models other than UAVSal on MobileNetV2, the baked and
graphed steps on a spatial mesh.

All the ranks' work is one spawn of 4 ranks (about 6 s here).
"""

import numpy as np
import pytest
import torch

from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal, UAVSalLSTM
from iip_uavsal_saliency_tpu_torch.models.adapters import build_adapted_model
from iip_uavsal_saliency_tpu_torch.parallel import RankGroup, spatial, spawn
from iip_uavsal_saliency_tpu_torch.parallel.mesh import Axis, Mesh, make_mesh
from iip_uavsal_saliency_tpu_torch.serving.steps import (graph_step, make_baked_infer_step,
                                                         make_infer_step)
from iip_uavsal_saliency_tpu_torch.training.optim import make_optimizer
from iip_uavsal_saliency_tpu_torch.training.steps import (create_train_state, make_eval_step,
                                                          make_train_step)
from _spatial_runs import LAYERS, run_jobs
from test_torch_train_step import few_threads  # noqa: F401

TOL = 1e-12          # f64, relative to the whole map's largest entry
TOL_KERNEL_PATH = 1e-5  # the fused kernel's path in f32
TIMEOUT_S = 300
# (mesh, input rows): the spatial axes and the maps their bands split
GEOMETRIES = {"4 ranks, 2 rows": ((1, 4), 2), "4 ranks, 9 rows": ((1, 4), 9),
              "4 ranks, 16 rows": ((1, 4), 16), "3 ranks, 5 rows": ((1, 3), 5),
              "2x2, 16 rows": ((2, 2), 16)}


def _cases():
    return [{"mesh": mesh, "layer": layer, "height": h, "seed": 10 * i + j, "id": gid}
            for i, (gid, (mesh, h)) in enumerate(GEOMETRIES.items())
            for j, layer in enumerate(LAYERS) if not (layer == "s2d_stem" and h % 2)]


@pytest.fixture(scope="module")
def exchanged():
    ranks = spawn(run_jobs, 4, "gloo", ([("exchanges", _cases())],), timeout_s=TIMEOUT_S,
                  deadline_s=TIMEOUT_S, threads=1)
    out = {}
    for rank in ranks:
        for got in rank[0]:
            if got["coords"] is not None:
                out.setdefault((got["case"]["layer"], got["case"]["id"]), []).append(got)
    return out


@pytest.mark.parametrize("geometry,layer", [(g, layer) for g, (_, h) in GEOMETRIES.items()
                                            for layer in LAYERS
                                            if not (layer == "s2d_stem" and h % 2)])
def test_band_layer_equals_the_whole_map(exchanged, layer, geometry):
    # (the S2D stem takes an even number of rows, so not 9 or 5)
    got = exchanged[(layer, geometry)]
    mesh, height = GEOMETRIES[geometry]
    assert len(got) == mesh[0] * mesh[1]
    tol = TOL_KERNEL_PATH if layer == "dwblock_kernel_path" else TOL
    worst = max(max(g["forward"], g["backward"]) / g["scale"] for g in got)
    assert worst <= tol, (layer, geometry, worst)
    # every rank gave its band of the output, empty ones included
    assert sorted(g["rows"] for g in got) == sorted(
        [spatial.owned(height, mesh[1], r)[1] - spatial.owned(height, mesh[1], r)[0]
         for r in range(mesh[1])] * mesh[0])


def test_window_needs_beyond_the_neighbours_gather_every_band():
    """Which exchanges go point to point: the rows of a 3x3 conv come from
    the neighbours, the ASPP's (dilation 18 at c5) and a resize's from a
    map of a few rows do not."""
    halo = spatial.window_needs(16, 4, 1, -1, 3)
    assert spatial._adjacent(spatial._pieces(16, 4, halo))
    aspp = spatial.window_needs(23, 2, 1, -18, 37)
    assert spatial._adjacent(spatial._pieces(23, 2, aspp))  # two ranks: every rank is adjacent
    aspp4 = spatial.window_needs(9, 4, 1, -18, 37)
    assert not spatial._adjacent(spatial._pieces(9, 4, aspp4))
    assert spatial.owned(2, 4, 2) == (2, 2) and spatial.owned(23, 2, 1) == (12, 23)


# (f) the refusals

CPU = torch.device("cpu")


def _mesh(n_data=1, n_spatial=2):
    """A rank's mesh made by hand: the refusals below raise before any
    collective, so no process group is needed."""
    ranks = tuple(range(n_data * n_spatial))
    group = RankGroup(0, len(ranks), "gloo", CPU)
    axis = Axis(0, n_spatial, ranks[:n_spatial], "gloo", CPU)
    return Mesh({"data": n_data, "spatial": n_spatial, "seq": 1, "model": 1}, group,
                Axis(0, n_data, ranks[::n_spatial], "gloo", CPU), axis,
                Axis(0, 1, (0,), "gloo", CPU), Axis(0, len(ranks), ranks, "gloo", CPU))


@pytest.mark.parametrize("shape,error", [((1, 4), ValueError), ((3, 1), ValueError),
                                         ((1, 2, 2), NotImplementedError),
                                         ((1, 1, 1, 2), NotImplementedError)],
                         ids=["spatial_4_of_2", "data_3_of_2", "seq", "model"])
def test_make_mesh_refuses(shape, error):
    with pytest.raises(error, match="ranks|A.13"):
        make_mesh(RankGroup(0, 2, "gloo", CPU), *shape)


def test_rows_that_do_not_divide_are_refused():
    """H = 72: its 36-row bands split, the state's 9 rows do not (the JAX
    jit raises the same), and a state band that is not an eighth of x's
    band is refused before any exchange."""
    mesh = _mesh()
    assert mesh.band(np.zeros((1, 5, 72, 128, 3)), 2).shape[2] == 36
    with pytest.raises(ValueError, match="do not split"):
        mesh.band(np.zeros((1, 9, 16, 256)), 1)
    model = UAVSal(time_dims=5).eval()
    step = make_infer_step(model, np.zeros((9, 16, 8), np.float32),
                           np.zeros((9, 16, 20), np.float32), mesh=mesh)
    with pytest.raises(ValueError, match="H and H/8 must divide"):
        step(torch.zeros((1, 5, 36, 128, 3), dtype=torch.uint8), torch.zeros((1, 4, 16, 256)))


@pytest.mark.parametrize("make", [
    lambda: UAVSal(time_dims=5, cnn_type="resnet18"),
    lambda: UAVSal(time_dims=5, cnn_type="vgg16"),
    lambda: UAVSalLSTM(time_dims=5),
    lambda: build_adapted_model("uavsal_spconv", filter_kwargs=True, time_dims=5)],
    ids=["resnet18", "vgg16", "uavsal_lstm", "zoo_adapter"])
def test_only_the_mobilenet_uavsal_takes_a_spatial_mesh(make):
    mesh = _mesh()
    with pytest.raises(NotImplementedError, match="A.13.1b"):
        make_infer_step(make(), mesh=mesh)
    model = make()
    with pytest.raises(NotImplementedError, match="A.13.1b"):
        make_train_step(create_train_state(model, make_optimizer(model, 1e-4, 5e-5)), mesh=mesh)
    with pytest.raises(NotImplementedError, match="A.13.1b"):
        make_eval_step(make(), mesh=mesh)


def test_backbones_without_bands_raise_inside_the_axis():
    from iip_uavsal_saliency_tpu_torch.models.backbone import build_backbone

    with spatial.over(_mesh().spatial):
        for name in ("resnet18", "vgg16"):
            with pytest.raises(NotImplementedError, match="A.13.1b"):
                build_backbone(name)(torch.zeros((1, 3, 32, 32)), height=64)


def test_baked_and_graphed_steps_refuse_a_spatial_mesh():
    mesh = _mesh()
    with pytest.raises(ValueError, match="pure-'data'"):
        make_baked_infer_step(UAVSal(time_dims=5), mesh=mesh)
    with pytest.raises(ValueError, match="cannot be graphed"):
        graph_step(make_infer_step(UAVSal(time_dims=5), mesh=mesh))
    # a data axis alone bakes and graphs as before: each rank serves its videos
    data_only = _mesh(n_data=2, n_spatial=1)
    graph_step(make_baked_infer_step(UAVSal(time_dims=5), mesh=data_only))


def test_a_step_takes_a_group_or_a_mesh():
    model = UAVSal(time_dims=5)
    with pytest.raises(ValueError, match="a group or a mesh"):
        make_eval_step(model, group=RankGroup(0, 2, "gloo", CPU), mesh=_mesh())
