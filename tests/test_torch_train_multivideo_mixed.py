"""bf16 mixed-precision training at V=2 (two videos in lock-step, the
masked clip of `tests/test_torch_train_multivideo.py`), held as
`tests/test_torch_train_mixed.py` holds it at V=1: 4 steps on one batch
from the weights `init_model` draws from seed 0, Adam at lr 1e-3; the f32
masters, moments, BatchNorm stats and carried state stay f32; the loss
falls and tracks the f32 trajectory within 12% of the first loss (the
masked loss crosses 0 by the fourth step, where a relative bound says
nothing), the updates are of the
f32 step's size (within a factor of 2), a running variance moved and lies
within 10% (and 0.05) of the f32 one's. The JAX package's bf16 steps
(`compute_dtype=jnp.bfloat16`, no mesh) on the same batch from the same
start are held to the port's bf16 losses within the same bound.

The two packages' bf16 steps are not held closer: on this random network
bf16 rounding through ~100 train-mode BatchNorms moves each package's
result far from its own f32 run (measured at V=1, one step: the carried
state up to 3.27 (JAX) and 2.95 (port) from f32, values up to 3.6; here
the losses read f32 2.993, 1.587, 0.685, -0.143, the port's bf16 3.047,
1.457, 0.687, -0.143, the JAX package's bf16 2.816, 1.466, 0.540, -0.183),
and
the two packages round at other points (the JAX package writes bf16
running stats and recovers the f32 EMA from them)."""

import jax.numpy as jnp
import numpy as np
import torch

from iip_uavsal_saliency_tpu.models import UAVSal as JUAVSal
from iip_uavsal_saliency_tpu.parallel.steps import create_train_state as j_create
from iip_uavsal_saliency_tpu.parallel.steps import make_train_step as j_make_train_step
from iip_uavsal_saliency_tpu.training.losses import loss_fu as j_loss_fu
from iip_uavsal_saliency_tpu.training.optim import make_optimizer as j_make_optimizer
from iip_uavsal_saliency_tpu.training.trainer import _masked_loss as j_masked_loss
from iip_uavsal_saliency_tpu_torch.models.convert import to_jax_variables
from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal, init_model
from iip_uavsal_saliency_tpu_torch.training.losses import loss_fu
from iip_uavsal_saliency_tpu_torch.training.optim import make_optimizer
from iip_uavsal_saliency_tpu_torch.training.steps import create_train_state, make_train_step
from iip_uavsal_saliency_tpu_torch.training.trainer import _masked_loss
from test_torch_train_multivideo import V, lockstep_clip
from test_torch_train_step import T, few_threads, priors  # noqa: F401

STEPS, LR, WD = 4, 1e-3, 5e-5
BN = "fucbst_layer.0.conv.3.running_var"


def _seeded():
    return init_model(UAVSal(time_dims=T), torch.Generator().manual_seed(0))


def _run_port(compute_dtype):
    model = _seeded()
    state = create_train_state(model, make_optimizer(model, LR, WD))
    step = make_train_step(state, _masked_loss(loss_fu), compute_dtype)
    x, y = (torch.from_numpy(a) for a in lockstep_clip(0))
    g, o = (torch.from_numpy(a) for a in priors())
    losses = []
    for _ in range(STEPS):
        loss, rnn = step(x, g, o, model.init_state(64, 128, V), y)
        losses.append(float(loss))
    return state, rnn, np.array(losses)


def _run_jax():
    model = JUAVSal(time_dims=T)
    tx = j_make_optimizer(LR, WD)
    step = j_make_train_step(model, tx, loss_fn=j_masked_loss(j_loss_fu), donate=False,
                             compute_dtype=jnp.bfloat16)
    state = j_create(to_jax_variables(_seeded().state_dict()), tx)
    x, y = lockstep_clip(0)
    g, o = priors()
    losses = []
    for _ in range(STEPS):
        state, loss, _ = step(state, x, g, o, np.asarray(model.init_state(64, 128, V)), y)
        losses.append(float(loss))
    return np.array(losses)


def test_two_video_mixed_precision_tracks_f32_and_the_jax_package(few_threads):  # noqa: F811
    state32, _, losses32 = _run_port(None)
    state16, rnn16, losses16 = _run_port(torch.bfloat16)
    model16 = state16.model
    for name, t in list(model16.named_parameters()) + list(model16.named_buffers()):
        assert t.dtype == torch.float32, f"bf16 leaked into {name}"
    moments = [v for st in state16.optimizer.state.values() for v in st.values()]
    assert moments and all(v.dtype == torch.float32 for v in moments)
    assert rnn16.dtype == torch.float32 and rnn16.grad_fn is None and rnn16.shape[0] == V

    assert losses32[-1] < losses32[0] and losses16[-1] < losses16[0]
    bound = 0.12 * abs(losses32[0])
    assert np.abs(losses16 - losses32).max() <= bound, (losses16, losses32)
    start = dict(_seeded().named_parameters())
    d32 = np.mean([(p - start[n]).abs().mean().item()
                   for n, p in state32.model.named_parameters()])
    d16 = np.mean([(p - start[n]).abs().mean().item() for n, p in model16.named_parameters()])
    assert 0.5 < d16 / d32 < 2.0, (d16, d32)
    moved = [dict(m.named_buffers())[BN] for m in (state32.model, model16)]
    assert not torch.equal(moved[0], torch.ones_like(moved[0]))
    torch.testing.assert_close(moved[1], moved[0], rtol=0.1, atol=0.05)

    jax16 = _run_jax()
    print(f"V=2 losses: port f32 {losses32}, port bf16 {losses16}, JAX package bf16 {jax16}")
    assert jax16[-1] < jax16[0]
    assert np.abs(losses16 - jax16).max() <= bound, (losses16, jax16)
