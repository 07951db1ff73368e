"""bf16 mixed-precision training in the port against its own f32 training
(the shape of `tests/test_mixed_precision.py`): the f32 masters, Adam's
moments and the BatchNorm running stats stay f32, the state comes back in
f32, the loss falls and tracks the f32 trajectory, and the updates are of
the same size. On the CPU at 64x128, T=5, batch_size=2 (S=10)."""

import numpy as np
import torch

from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal, init_uavsal
from iip_uavsal_saliency_tpu_torch.training.optim import make_optimizer
from iip_uavsal_saliency_tpu_torch.training.steps import create_train_state, make_train_step
from test_torch_train_step import H, HO, S, T, W, WO, few_threads, priors  # noqa: F401

STEPS = 4


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randint(0, 256, (1, S, H, W, 3)).astype(np.uint8))
    y = torch.from_numpy((rng.rand(1, S, HO, WO, 2) > 0.7).astype(np.float32))
    return x, y


def _run(compute_dtype):
    model = init_uavsal(UAVSal(time_dims=T), torch.Generator().manual_seed(0))
    state = create_train_state(model, make_optimizer(model, 1e-3, 5e-5))
    step = make_train_step(state, compute_dtype=compute_dtype)
    g, o = (torch.from_numpy(a) for a in priors())
    x, y = _batch()  # one fixed batch: repeated steps must lower the loss
    rnn, losses = model.init_state(H, W), []
    for _ in range(STEPS):
        loss, rnn = step(x, g, o, rnn, y)
        losses.append(float(loss))
    return state, rnn, np.array(losses)


def test_mixed_precision_tracks_f32(few_threads):  # noqa: F811
    state32, rnn32, losses32 = _run(None)
    state16, rnn16, losses16 = _run(torch.bfloat16)

    model16 = state16.model
    for name, t in list(model16.named_parameters()) + list(model16.named_buffers()):
        assert t.dtype == torch.float32, f"bf16 leaked into {name}"
    moments = [v for st in state16.optimizer.state.values() for v in st.values()]
    assert moments and all(v.dtype == torch.float32 for v in moments)
    assert rnn16.dtype == torch.float32 and rnn16.grad_fn is None

    assert losses32[-1] < losses32[0] and losses16[-1] < losses16[0]
    np.testing.assert_allclose(losses16, losses32, rtol=0.12)

    # update magnitudes match (per-weight values do not: Adam normalizes each
    # coordinate, so bf16 gradient noise flips single steps)
    init = init_uavsal(UAVSal(time_dims=T), torch.Generator().manual_seed(0))
    start = dict(init.named_parameters())
    d32 = np.mean([(p - start[n]).abs().mean().item()
                   for n, p in state32.model.named_parameters()])
    d16 = np.mean([(p - start[n]).abs().mean().item() for n, p in model16.named_parameters()])
    assert 0.5 < d16 / d32 < 2.0, (d16, d32)
    # the running stats moved in both, from the same start
    bn = "fucbst_layer.0.conv.3.running_var"
    moved = [dict(m.named_buffers())[bn] for m in (state32.model, model16)]
    assert not torch.equal(moved[0], torch.ones_like(moved[0]))
    torch.testing.assert_close(moved[1], moved[0], rtol=0.1, atol=0.05)
