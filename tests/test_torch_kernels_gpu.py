"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card. A CUDA kernel has no CPU mode, so every test here is marked
`gpu` and skips without a card.

This file imports torch and the port only, so it also runs on a machine
without JAX; the repository's conftest imports JAX, so run it there as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py -q
"""

import numpy as np
import pytest
import torch

from iip_uavsal_saliency_tpu_torch import kernels
from iip_uavsal_saliency_tpu_torch.ops.twa import twa_scan, twa_scan_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(v, s, h, w, c, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(v, s, h, w, c) * 0.5, rng.randn(v, s, h, w, c) * 0.5,
            rng.randn(3, 3, c, c) * np.sqrt(2.0 / (9 * c)), rng.randn(v, h, w, c) * 0.5)


# f32: the kernel and cuDNN (TF32 off) sum the 9*C products in other orders.
# bf16: the plain version rounds the conv and the gate to bf16 every frame,
# the kernel keeps them in f32 until it stores h_s.
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(2, 5, 13, 7, 24), (3, 4, 20, 8, 8), (1, 2, 1, 1, 8)],
                         ids=["ragged", "three_videos", "one_pixel"])
def test_twa_kernel_matches_ref(card, shape, dtype, atol):
    args = [torch.tensor(a, dtype=torch.float32).to(card, dtype) for a in _case(*shape)]
    kernels.reset_launches()
    ys, last = twa_scan(*args)
    torch.cuda.synchronize()
    assert kernels.launches["twa_scan"] == shape[1]  # one launch per frame
    ref, ref_last = twa_scan_ref(*args)
    torch.testing.assert_close(ys.float(), ref.float(), atol=atol, rtol=0)
    torch.testing.assert_close(last.float(), ref_last.float(), atol=atol, rtol=0)


def test_twa_kernel_raises_on_what_it_does_not_take(card):
    """A CUDA tensor launches the kernel or raises; nothing falls back."""
    x, gx, w_h, h0 = [torch.zeros(s, device=card) for s in
                      ((1, 2, 3, 4, 12), (1, 2, 3, 4, 12), (3, 3, 12, 12), (1, 3, 4, 12))]
    kernels.reset_launches()
    with pytest.raises(ValueError, match="C % 8"):
        twa_scan(x, gx, w_h, h0)
    with pytest.raises(TypeError, match="bf16 or f32"):
        twa_scan(*(t[..., :8].half().contiguous() for t in (x, gx)),
                 w_h[:, :, :8, :8].half().contiguous(), h0[..., :8].half().contiguous())
    assert kernels.launches["twa_scan"] == 0
