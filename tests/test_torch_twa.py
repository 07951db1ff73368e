"""The port's TWA scan and ConvTWA against the JAX package on the CPU.
The kernel itself is held against its plain version on the card by
tests/test_torch_kernels_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iip_uavsal_saliency_tpu.models.recurrent import ConvTWA as JConvTWA
from iip_uavsal_saliency_tpu.ops.pallas_twa import twa_scan_pallas, twa_scan_xla
from iip_uavsal_saliency_tpu_torch import kernels
from iip_uavsal_saliency_tpu_torch.models.recurrent import ConvTWA
from iip_uavsal_saliency_tpu_torch.ops.twa import twa_scan, twa_scan_ref

# f32 on the CPU: XLA and torch sum the 9*C conv products in other orders
ATOL = 1e-5


def _case(v=2, s=4, h=12, w=8, c=8, seed=0):
    """The inputs of tests/test_pallas_twa.py::_case, as numpy."""
    def r(shape, sd):
        return (np.random.RandomState(sd).randn(*shape).astype(np.float32) * 0.5)
    return (r((v, s, h, w, c), seed), r((v, s, h, w, c), seed + 1),
            r((3, 3, c, c), seed + 2) * 0.2, r((v, h, w, c), seed + 3))


CASES = {
    "single_chunk": dict(h=6),
    "multi_chunk": dict(h=20, seed=7),     # row block 10 -> 2 chunks per step
    "three_videos": dict(v=3, seed=11),    # independent videos
}


@pytest.mark.parametrize("oracle", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_twa_scan_ref_matches_jax(case, oracle):
    arrays = _case(**CASES[case])
    jargs = [jnp.asarray(a) for a in arrays]
    if oracle == "xla":
        want_ys, want_last = twa_scan_xla(*jargs)
    else:
        want_ys, want_last = twa_scan_pallas(*jargs, interpret=True)
    targs = [torch.from_numpy(a) for a in arrays]
    ys, last = twa_scan_ref(*targs)
    for got, ref in zip(twa_scan(*targs), (ys, last)):  # CPU tensors take the plain version
        torch.testing.assert_close(got, ref, atol=0, rtol=0)
    np.testing.assert_allclose(ys.numpy(), np.asarray(want_ys), atol=ATOL, rtol=0)
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last), atol=ATOL, rtol=0)


@pytest.mark.parametrize("v,s", [(1, 5), (2, 3)])
def test_conv_twa_matches_jax(v, s):
    rng = np.random.RandomState(v * 10 + s)
    c, h, w = 8, 6, 7
    x = rng.randn(v, s, h, w, c).astype(np.float32)
    h0 = rng.randn(v, h, w, c).astype(np.float32)
    jm = JConvTWA(hidden_dim=c)
    kernel = (rng.randn(3, 3, 2 * c, c) * 0.15).astype(np.float32)
    want_ys, want_last = jm.apply({"params": {"kernel": jnp.asarray(kernel)}},
                                  jnp.asarray(x), jnp.asarray(h0))
    tm = ConvTWA(c)
    tm.load_state_dict({"cell_list.0.rnn_conv.weight":
                        torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())}, strict=True)
    with torch.no_grad():
        ys, last = tm(torch.from_numpy(x), torch.from_numpy(h0))
    np.testing.assert_allclose(ys.numpy(), np.asarray(want_ys), atol=ATOL, rtol=0)
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last), atol=ATOL, rtol=0)


def test_conv_twa_resplits_weight_after_load():
    tm = ConvTWA(8)
    first = tm.split_weight()[1]
    assert tm.split_weight()[1] is first  # cached while the weight is unchanged
    with torch.no_grad():
        tm.cell_list[0].rnn_conv.weight.mul_(2.0)
    torch.testing.assert_close(tm.split_weight()[1], 2.0 * first)


def test_cpu_scan_does_not_count_launches():
    kernels.reset_launches()
    arrays = [torch.from_numpy(a) for a in _case(v=1, s=3, h=5, w=4, c=8)]
    twa_scan(*arrays)
    assert kernels.launches["twa_scan"] == 0


def test_twa_scan_rejects_other_devices():
    x = torch.empty(1, 2, 3, 4, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        twa_scan(x, x, torch.empty(3, 3, 8, 8, device="meta"),
                 torch.empty(1, 3, 4, 8, device="meta"))

