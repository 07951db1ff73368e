"""`remat` in the port's train step (`make_train_step(remat=True)`: one
non-reentrant `torch.utils.checkpoint` around the forward, the bf16 casts
included) on the CPU at 64x128, T=5, batch_size=2.

On the CPU the recompute gives the forward's own bits, so the rematerialized
step equals the plain one bit for bit: loss, carried state, BatchNorm
stats and every gradient, in f32 and in bf16 mixed precision. The stats
move once: the recompute runs inside `ops/layers.py::running_stats_held`,
and without it they would take the EMA twice (the JAX package's forward
returns the stats it moved, and `jax.checkpoint` recomputes without
writing them). Against the JAX package's `remat=True` step the port is held
as its plain step is (`tests/test_torch_train_step.py`: both f32 runs to
the port's f64 run, at that file's bounds)."""

import contextlib

import pytest
import torch

from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal, init_model
from iip_uavsal_saliency_tpu_torch.training import steps
from iip_uavsal_saliency_tpu_torch.training.losses import loss_fu
from iip_uavsal_saliency_tpu_torch.training.optim import make_optimizer
from iip_uavsal_saliency_tpu_torch.training.trainer import _masked_loss
from test_torch_train_multivideo import lockstep_clip
from test_torch_train_step import (T, check_against_jax, clip_data, few_threads,  # noqa: F401
                                   priors, run_jax, variables)


def _step(dtype, remat):
    """One Adam step of the flagship from seed 0 on two videos in
    lock-step (video 1 a padded ragged clip, the masked loss): (loss, new
    state, {name: gradient}, {name: buffer after})."""
    model = init_model(UAVSal(time_dims=T), torch.Generator().manual_seed(0))
    state = steps.create_train_state(model, make_optimizer(model, 1e-4, 5e-5))
    step = steps.make_train_step(state, _masked_loss(loss_fu), dtype, remat=remat)
    x, y = (torch.from_numpy(a) for a in lockstep_clip(0))
    g, o = (torch.from_numpy(a) for a in priors())
    loss, rnn = step(x, g, o, model.init_state(64, 128, 2), y)
    return (loss, rnn, {n: p.grad.clone() for n, p in model.named_parameters()},
            {n: b.clone() for n, b in model.named_buffers()})


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_remat_step_equals_plain_step(dtype):
    plain, remat = _step(dtype, False), _step(dtype, True)
    assert torch.equal(remat[0], plain[0]) and torch.equal(remat[1], plain[1])
    assert remat[1].dtype == torch.float32 and remat[1].grad_fn is None
    for which in (2, 3):
        assert remat[which].keys() == plain[which].keys()
        for n, t in plain[which].items():
            assert torch.equal(remat[which][n], t), n


def test_a_recompute_that_moves_the_stats_is_caught(monkeypatch):
    """The stats are what tells the two apart: with the recompute's
    context switched off, every loss and gradient still equals the plain
    step's, and the running stats have taken the EMA twice."""
    plain = _step(None, False)
    monkeypatch.setattr(steps, "_recompute_contexts",
                        lambda: (contextlib.nullcontext(), contextlib.nullcontext()))
    twice = _step(None, True)
    assert torch.equal(twice[0], plain[0])
    assert all(torch.equal(twice[2][n], g) for n, g in plain[2].items())
    moved = [n for n, b in plain[3].items() if not torch.equal(twice[3][n], b)]
    assert len(moved) == len(plain[3]), sorted(set(plain[3]) - set(moved))[:4]


def test_remat_step_matches_jax(variables):  # noqa: F811
    """The port's remat step against the JAX package's `remat=True` step:
    one clip, loss, gradients, BN stats, parameters after Adam and state."""
    runs = run_jax(variables, (), remat=True, clips=1)
    trainable = {n: True for n, _ in UAVSal(time_dims=T).named_parameters()}
    worst = check_against_jax(runs, (), trainable, remat=True)
    print(f"remat: largest error as a share of its bound {worst}")
    assert clip_data(0)[0].shape[0] == runs[0][4].shape[0] == 1
