"""The port's train and eval steps at V=2 (two videos in lock-step, as
`Trainer` with `videos_per_step=2` stacks them) against the JAX package's
`make_train_step`/`make_eval_step` without a mesh, at 64x128, T=5,
batch_size=2 (S=10 frames per video), every parameter trained.

At V=2 the train form differs from V=1 in three places, which the V=1
tests do not reach: MultiPriors tiles the context frame-aligned per video
(not t-major across the batch), TeConv's temporal differences are bounded
per video (`diff_group=S`), and train-mode BatchNorm reduces over all V*S
frames. The loss is the plain `loss_fu` and the trainer's masked form, on
clips where video 1's last 5 frames are padding (mask 0) and, in the next
clip, video 0 has run out of clips (its clip repeated, mask 0 on all of
it): the padded frames still feed BatchNorm's statistics and move the
carried state, and only the loss ignores them.

Both f32 runs are held to the port's f64 run from the same JAX starting
point at the bounds of `tests/test_torch_train_step.py` (whose module
docstring says why two f32 runs are not held to each other directly)."""

import numpy as np
import torch

from iip_uavsal_saliency_tpu.models import UAVSal as JUAVSal
from iip_uavsal_saliency_tpu.parallel.steps import make_eval_step as j_make_eval_step
from iip_uavsal_saliency_tpu.training.losses import loss_fu as j_loss_fu
from iip_uavsal_saliency_tpu.training.trainer import _masked_loss as j_masked_loss
from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal
from iip_uavsal_saliency_tpu_torch.training.losses import loss_fu
from iip_uavsal_saliency_tpu_torch.training.steps import make_eval_step
from iip_uavsal_saliency_tpu_torch.training.trainer import _masked_loss
from test_torch_train_step import (HO, S, T, WO, _err, check_against_jax, clip_data,  # noqa: F401
                                   few_threads, port_model, priors, run_jax, variables)

V = 2
# the eval step runs no batch statistics: the two packages' f32 sums part
# by rounding only (measured: loss 1.3e-6 relative, state 2.6e-6 of 1.0)
TOL_EVAL_LOSS = 1e-5   # relative
TOL_EVAL_STATE = 1e-4  # absolute, values of order 1


def lockstep_clip(k, masked=True):
    """Clip k of two videos in lock-step: uint8 frames (2, S, 64, 128, 3)
    and ground truth (2, S, 8, 16, 2), with the mask as channel 2 when
    `masked`. Clip 0: video 1 is a ragged clip of T frames right-padded
    with its last frame (mask 0 on the padding). Clip 1: video 0 has run
    out and repeats its clip 0 (mask 0 throughout)."""
    (x0, y0), (x1, y1) = clip_data(10 * k), clip_data(10 * k + 1)
    x, y = np.concatenate([x0, x1]), np.concatenate([y0, y1])
    mask = np.ones((V, S, HO, WO, 1), np.float32)
    if masked and k == 0:
        x[1, T:], y[1, T:], mask[1, T:] = x[1, T - 1], y[1, T - 1], 0.0
    if masked and k == 1:
        x[0], y[0] = clip_data(0)[0][0], clip_data(0)[1][0]
        mask[0] = 0.0
    return x, np.concatenate([y, mask], -1) if masked else y


def two_video_train_step_matches_jax(variables, masked):
    """Loss, gradients, BatchNorm stats, the parameters after Adam and the
    carried state of V=2 steps, the JAX package's f32 and the port's f32
    each held to the port's f64: one clip with the plain loss, or two
    carried clips with masked frames and the trainer's masked loss."""
    clips = 2 if masked else 1

    def clip(k):
        return lockstep_clip(k, masked)

    jloss = j_masked_loss(j_loss_fu) if masked else None
    runs = run_jax(variables, (), clip=clip, loss_fn=jloss, clips=clips)
    trainable = {n: True for n, _ in UAVSal(time_dims=T).named_parameters()}
    worst = check_against_jax(runs, (), trainable, clip=clip,
                              loss_fn=_masked_loss(loss_fu) if masked else loss_fu)
    print(f"V=2, masked={masked}: largest error as a share of its bound {worst}")
    assert runs[-1][4].shape == (V, HO, WO, 256)


def test_two_video_train_step_matches_jax(variables):
    """The plain loss; the masked one is in
    `test_torch_train_multivideo_masked.py`, so that the two compile in two
    workers."""
    two_video_train_step_matches_jax(variables, masked=False)


def test_two_video_eval_step_matches_jax(variables):
    """The val step at V=2 (eval-mode BatchNorm, the masked loss), over the
    two carried clips, against the JAX package's eval step."""
    model = JUAVSal(time_dims=T)
    jstep = j_make_eval_step(model, loss_fn=j_masked_loss(j_loss_fu))
    port = port_model(variables["params"], variables["batch_stats"], torch.float32)
    pstep = make_eval_step(port, _masked_loss(loss_fu))
    g, o = priors()
    jrnn = np.asarray(model.init_state(64, 128, V))
    prnn = port.init_state(64, 128, V)
    for k in range(2):
        x, y = lockstep_clip(k)
        jl, jrnn = jstep(variables["params"], variables["batch_stats"], x, g, o, jrnn, y)
        pl, prnn = pstep(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(o), prnn,
                         torch.from_numpy(y))
        jrnn = np.asarray(jrnn)
        loss_err = abs(float(pl) - float(jl)) / abs(float(jl))
        state_err = _err(prnn.numpy(), jrnn, 1.0)
        print(f"eval clip {k}: loss {loss_err:.3g} relative, state {state_err:.3g}")
        assert loss_err <= TOL_EVAL_LOSS and state_err <= TOL_EVAL_STATE, k
    # the state is carried per video: each video's own clips, no mixing
    assert not np.allclose(jrnn[0], jrnn[1])
