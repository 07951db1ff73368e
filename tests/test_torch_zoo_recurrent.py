"""The ablations' recurrences against the JAX package on the CPU, f32:
`ConvLSTM` (the recurrence of `uavsal_lstm`), `ConvSimGRU` and
`ConvTWADW` (exported by the JAX package, reached by no `MODEL_ZOO` name):
the outputs of all 10 frames and the carried state, for two videos at once
(the port's V axis) against the JAX cell run on each video; and
ConvTWADW's gate BatchNorms, which stay in eval form while the model
trains, as the JAX cell calls its gate block with `train=False`.

Within 2e-5, the port's f32 parity target against the JAX package
(ROADMAP): the two frameworks sum each gate conv's 9 * 2C products in
different orders, and the recurrence carries that over the frames."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iip_uavsal_saliency_tpu.models import recurrent as jrec
from iip_uavsal_saliency_tpu_torch.models import convert
from iip_uavsal_saliency_tpu_torch.models import recurrent as trec
from iip_uavsal_saliency_tpu_torch.ops.layers import BatchNorm
from test_torch_layers import randomize
from test_torch_train_step import few_threads  # noqa: F401

ATOL = 2e-5
C, S, H, W, V = 16, 10, 6, 7, 2

CELLS = {
    "ConvLSTM": (jrec.ConvLSTM, trec.ConvLSTM),
    "ConvSimGRU": (jrec.ConvSimGRU, trec.ConvSimGRU),
    "ConvTWADW": (jrec.ConvTWADW, trec.ConvTWADW),
}


def rows(name):
    """The cell's weights: the gate conv's one kernel (HWIO over concat([x,
    h]) in JAX), or ConvTWADW's gate DWBlock."""
    if name == "ConvTWADW":
        return convert._dwblock(("cell", "rnn_conv"), "cell_list.0.rnn_conv")
    return [(("params", "kernel"), "cell_list.0.rnn_conv.weight", True)]


def cells(name, seed):
    """(JAX cell, its seeded variables, the port's cell loaded with them)."""
    jcls, tcls = CELLS[name]
    jm = jcls(hidden_dim=C)
    rng = np.random.RandomState(seed)
    x = jnp.zeros((S, H, W, C))
    variables = jax.tree_util.tree_map(
        np.asarray, dict(jm.init(jax.random.PRNGKey(0), x, jm.init_state(H, W))))
    variables = randomize(variables, rng)
    tm = tcls(C)
    tm.load_state_dict(convert.from_jax_variables(variables, rows(name)), strict=True)
    return jm, variables, tm.eval()


def inputs(name, seed):
    """Frames (V, S, H, W, C) and a carried state of the cell's shape per
    video ((2, H, W, C) for ConvLSTM's h and c)."""
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1.0, (V, S, H, W, C)).astype(np.float32)
    state = (V, 2, H, W, C) if name == "ConvLSTM" else (V, H, W, C)
    return x, rng.normal(0, 0.5, state).astype(np.float32)


@pytest.mark.parametrize("name", list(CELLS))
def test_recurrence_matches_jax(name):
    """ys over 10 frames and the last state: the port's cell on both
    videos at once against the JAX cell on each; and from a zero state
    (`init_state`) the port's shapes and zeros."""
    jm, variables, tm = cells(name, 1)
    x, state = inputs(name, 2)
    with torch.no_grad():
        ys, last = tm(torch.from_numpy(x), torch.from_numpy(state))
    assert ys.shape == (V, S, H, W, C) and last.shape == state.shape
    for v in range(V):
        wys, wlast = jm.apply(variables, jnp.asarray(x[v]), jnp.asarray(state[v]))
        assert float(np.std(np.asarray(wys))) > 0.05
        np.testing.assert_allclose(ys[v].numpy(), np.asarray(wys), atol=ATOL, rtol=0)
        np.testing.assert_allclose(last[v].numpy(), np.asarray(wlast), atol=ATOL, rtol=0)
    zero = tm.init_state(H, W, V)
    assert zero.shape == state.shape and not zero.any()
    np.testing.assert_array_equal(np.asarray(jm.init_state(H, W)), zero[0].numpy())


def test_convtwadw_gate_batchnorm_stays_in_eval_form():
    """In train mode ConvTWADW's gate block still normalizes with its
    running stats and moves none of them: the output is the eval form's,
    and the stats are as loaded, after a forward and a backward."""
    _, _, tm = cells("ConvTWADW", 3)
    x, state = (torch.from_numpy(a) for a in inputs("ConvTWADW", 4))
    with torch.no_grad():
        want, _ = tm(x, state)
    before = {k: v.clone() for k, v in tm.state_dict().items() if "running" in k}
    assert before
    tm.train()
    assert tm.training
    assert not any(m.training for m in tm.modules() if isinstance(m, BatchNorm))
    ys, last = tm(x, state)
    (ys.square().mean() + last.mean()).backward()
    assert tm.cell_list[0].rnn_conv.conv[0][1].weight.grad is not None
    np.testing.assert_array_equal(ys.detach().numpy(), want.numpy())
    for k, v in tm.state_dict().items():
        if "running" in k:
            assert torch.equal(v, before[k]), k
