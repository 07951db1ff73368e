"""The seq axis's refusals: a mesh with both a spatial and a seq axis,
frames that do not split, UAVSalLSTM and the zoo's adapters on a seq mesh
(ROADMAP A.13.2b), the baked and the graphed serving steps on one. The
exchanges themselves run in the spawn of `tests/test_torch_seq_serve.py`.
"""

import numpy as np
import pytest
import torch

from iip_uavsal_saliency_tpu_torch.models.adapters import build_adapted_model
from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal, UAVSalLSTM
from iip_uavsal_saliency_tpu_torch.parallel import Axis, Mesh, RankGroup, make_mesh
from iip_uavsal_saliency_tpu_torch.serving.steps import (graph_step, make_baked_infer_step,
                                                         make_infer_step)
from iip_uavsal_saliency_tpu_torch.training.optim import make_optimizer
from iip_uavsal_saliency_tpu_torch.training.steps import (create_train_state, make_eval_step,
                                                          make_train_step)
from test_torch_train_step import few_threads  # noqa: F401

CPU = torch.device("cpu")


def _mesh(n_data=1, n_seq=2):
    """A rank's mesh made by hand: the refusals below raise before any
    collective, so no process group is needed."""
    ranks = tuple(range(n_data * n_seq))
    group = RankGroup(0, len(ranks), "gloo", CPU)
    return Mesh({"data": n_data, "spatial": 1, "seq": n_seq, "model": 1}, group,
                Axis(0, n_data, ranks[::n_seq], "gloo", CPU), Axis(0, 1, (0,), "gloo", CPU),
                Axis(0, n_seq, ranks[:n_seq], "gloo", CPU),
                Axis(0, len(ranks), ranks, "gloo", CPU))


def test_make_mesh_refuses_a_spatial_and_a_seq_axis_together():
    with pytest.raises(NotImplementedError, match="A.13.2b"):
        make_mesh(RankGroup(0, 4, "gloo", CPU), 1, 2, 2)


def test_frames_that_do_not_split_are_refused():
    mesh = _mesh(n_seq=4)
    assert mesh.frames(np.zeros((1, 12, 8, 16, 3)), 1).shape[1] == 3
    with pytest.raises(ValueError, match="do not split"):
        mesh.frames(np.zeros((1, 10, 8, 16, 3)), 1)


@pytest.mark.parametrize("make", [
    lambda: UAVSalLSTM(time_dims=4),
    lambda: build_adapted_model("uavsal_spconv", filter_kwargs=True, time_dims=4),
    lambda: build_adapted_model("uavsal_stc3d", filter_kwargs=True, time_dims=4)],
    ids=["uavsal_lstm", "zoo_adapter", "zoo_3d"])
def test_only_uavsal_takes_a_seq_mesh(make):
    mesh = _mesh()
    with pytest.raises(NotImplementedError, match="A.13.2b"):
        make_infer_step(make(), mesh=mesh)
    model = make()
    with pytest.raises(NotImplementedError, match="A.13.2b"):
        make_train_step(create_train_state(model, make_optimizer(model, 1e-4, 5e-5)), mesh=mesh)
    with pytest.raises(NotImplementedError, match="A.13.2b"):
        make_eval_step(make(), mesh=mesh)


def test_other_backbones_take_a_seq_mesh():
    """The per-frame layers do not change with the backbone: a ResNet
    UAVSal makes its steps on a seq mesh (the spatial axis refuses it)."""
    mesh = _mesh()
    model = UAVSal(time_dims=4, cnn_type="resnet18", bias_type=(1, 0, 1))
    assert callable(make_infer_step(model, mesh=mesh))
    assert callable(make_eval_step(model, mesh=mesh))


def test_baked_and_graphed_steps_refuse_a_seq_mesh():
    mesh = _mesh()
    with pytest.raises(ValueError, match="pure-'data'"):
        make_baked_infer_step(UAVSal(time_dims=4), mesh=mesh)
    with pytest.raises(ValueError, match="cannot be graphed"):
        graph_step(make_infer_step(UAVSal(time_dims=4), mesh=mesh))
