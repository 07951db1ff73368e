"""The f32 per-frame K1 kernel's CPU-side parts: the packed W_h it reads,
its 3xTF32 arithmetic emulated in f64, and ConvTWA's cache of the pack.
The kernel itself is held against its plain version on the card by
tests/test_torch_kernels_gpu.py."""

import re

import numpy as np
import pytest
import torch

from iip_uavsal_saliency_tpu_torch import kernels
from iip_uavsal_saliency_tpu_torch.models import recurrent
from iip_uavsal_saliency_tpu_torch.models.recurrent import ConvTWA
from iip_uavsal_saliency_tpu_torch.ops import twa
from iip_uavsal_saliency_tpu_torch.ops.dwblock import tf32_split
from test_torch_train_step import few_threads  # noqa: F401

TOL_F32 = 1e-5  # chip_smoke.py's tolerance of K1 in f32 against twa_scan_ref


def _source_constant(name: str) -> int:
    """A `static constexpr int` of the kernel source's F32Step."""
    found = re.search(rf"static constexpr int {name} = (\d+);",
                      (kernels.CSRC / "twa_scan.cu").read_text())
    return int(found.group(1))


@pytest.mark.parametrize("c", [8, 24, 64, 256])
def test_pack_twa_weights_unpacks_exactly(c):
    """Element by element from the layout's formula: flat index -> (column
    block, chunk, tap, k8 step, half, plane, column, k) -> half of
    W_h[ky, kx, 32q + 8j + 2k + p, 64nb + n], zero in the padding."""
    w = torch.from_numpy(np.random.RandomState(c).randn(3, 3, c, c).astype(np.float32))
    blob = twa.pack_twa_weights(w).numpy()
    assert blob.shape == (twa.packed_twa_size(c),)
    halves = np.stack([t.numpy() for t in tf32_split(w)])  # (2, 3, 3, C, C)
    idx = np.arange(blob.size)
    idx, k = np.divmod(idx, twa.F32_PLANE)
    idx, n = np.divmod(idx, twa.F32_COLUMN_BLOCK)
    idx, p = np.divmod(idx, 2)
    idx, h = np.divmod(idx, 2)
    idx, j = np.divmod(idx, twa.F32_CHUNK // twa.F32_K_STEP)
    idx, tap = np.divmod(idx, 9)
    nb, q = np.divmod(idx, -(-c // twa.F32_CHUNK))
    ci = twa.F32_CHUNK * q + twa.F32_K_STEP * j + 2 * k + p
    co = twa.F32_COLUMN_BLOCK * nb + n
    inside = (ci < c) & (co < c)
    assert nb.max() == -(-c // twa.F32_COLUMN_BLOCK) - 1
    want = halves[h[inside], tap[inside] // 3, tap[inside] % 3, ci[inside], co[inside]]
    np.testing.assert_array_equal(blob[inside], want)
    assert not blob[~inside].any()  # the padding is zero
    assert (~inside).any() == (c % twa.F32_COLUMN_BLOCK != 0)


def test_pack_twa_weights_rejects_what_the_kernel_does_not_read():
    with pytest.raises(ValueError, match="f32 W_h"):
        twa.pack_twa_weights(torch.zeros(3, 3, 8, 8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="f32 W_h"):
        twa.pack_twa_weights(torch.zeros(3, 3, 8, 16))


def _round_toward_zero_f32(v):
    """f64 -> f32 by truncation: a pessimistic model of the tensor cores'
    f32 accumulation, which is not IEEE round-to-nearest."""
    r = v.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(v)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _kernel_sum(a, w, fold_steps):
    """The kernel's arithmetic for A (M, K) . W (K, N): per k8 step the
    three products small.big, big.small, big.big added to the tensor cores'
    f32 sum (truncated), and every `fold_steps` k8 steps that sum added to
    an f32 total by IEEE round-to-nearest."""
    ab, as_ = (t.numpy().astype(np.float64) for t in tf32_split(torch.from_numpy(a)))
    wb, ws = (t.numpy().astype(np.float64) for t in tf32_split(torch.from_numpy(w)))
    total = np.zeros((a.shape[0], w.shape[1]), np.float32)
    part = np.zeros_like(total)
    steps = a.shape[1] // 8
    for s in range(steps):
        k = slice(8 * s, 8 * s + 8)
        for x_, w_ in ((as_, wb), (ab, ws), (ab, wb)):
            part = _round_toward_zero_f32(part.astype(np.float64) + x_[:, k] @ w_[k])
        if (s + 1) % fold_steps == 0 or s + 1 == steps:
            total = (total.astype(np.float64) + part).astype(np.float32)
            part[:] = 0
    return total


def test_three_tf32_with_the_kernels_fold_holds_a_flagship_frames_conv():
    """One flagship frame's conv (K = 9 x 256 = 2304, h_{s-1} and W_h as
    chip_smoke.py draws them) on 256 of its pixels, in the kernel's order of
    k8 steps (chunk, tap, step), its products and fold length (the
    source's FOLD_TAPS taps of a 32-channel chunk) emulated in f64 with the
    tensor cores' sums truncated to f32: within TOL_F32 of the exact conv.
    With all of K in one tensor-core sum it is not, and plain TF32 is far
    from it."""
    c, m = 256, 256
    rng = np.random.RandomState(5)
    a = (rng.randn(m, 9 * c) * 0.5).astype(np.float32)  # the 9 shifted taps of h_{s-1}
    w = (rng.randn(9 * c, c) * np.sqrt(2.0 / (9 * c))).astype(np.float32)
    exact = a.astype(np.float64) @ w.astype(np.float64)
    fold_taps = _source_constant("FOLD_TAPS")
    steps_per_tap = _source_constant("KC") // _source_constant("KSTEP")
    folded = np.abs(_kernel_sum(a, w, fold_taps * steps_per_tap) - exact).max()
    whole = np.abs(_kernel_sum(a, w, 9 * c // 8) - exact).max()
    assert folded <= TOL_F32 / 2, folded
    assert whole > TOL_F32, whole
    big = tf32_split(torch.from_numpy(a))[0].double() @ tf32_split(torch.from_numpy(w))[0].double()
    assert np.abs(big.numpy() - exact).max() > 10 * TOL_F32


@pytest.fixture
def packs_on_the_cpu(monkeypatch):
    """ConvTWA as it is on the card, where f32 weights are packed: the
    device test alone is replaced."""
    monkeypatch.setattr(recurrent, "_packs", lambda w: w.dtype == torch.float32)


def test_conv_twa_caches_the_pack_until_the_weight_changes(packs_on_the_cpu):
    """The pack is made once beside the cached split, from exactly its W_h,
    and dropped when the weight changes: in place, by a load, by a cast."""
    tm = ConvTWA(8)
    with torch.no_grad():
        first = tm.packed_weight()
        assert torch.equal(first, twa.pack_twa_weights(tm.split_weight()[1]))
        assert tm.packed_weight() is first
        tm.cell_list[0].rnn_conv.weight.mul_(2.0)
        second = tm.packed_weight()
        assert second is not first and torch.equal(second, 2.0 * first)
        tm.load_state_dict(tm.state_dict())
        assert tm._packed is None and tm.packed_weight() is not second
        tm.double()
        assert tm._packed is None and tm.packed_weight() is None  # f64 reads W_h as it is
        tm.float()
        assert tm.packed_weight() is not None


def test_conv_twa_leaves_the_pack_to_the_scan_when_a_gradient_is_wanted(packs_on_the_cpu,
                                                                         monkeypatch):
    """Serving hands the scan the cached pack; a train step (a gradient
    wanted) hands it none, so the scan packs once per call from the W_h the
    gradient flows through."""
    seen = []

    def spy(x, gx, w_h, h0, packed=None):
        seen.append(packed)
        return twa.twa_scan_ref(x, gx, w_h, h0)

    monkeypatch.setattr(recurrent, "twa_scan", spy)
    tm = ConvTWA(8)
    x = torch.from_numpy(np.random.RandomState(3).randn(1, 3, 5, 4, 8).astype(np.float32))
    with torch.no_grad():
        tm(x, tm.init_state(5, 4))
        tm(x, tm.init_state(5, 4))
    assert seen[0] is not None and seen[1] is seen[0]
    ys, _ = tm(x, tm.init_state(5, 4))
    assert seen[2] is None and ys.requires_grad


def test_conv_twa_on_the_cpu_makes_no_pack(monkeypatch):
    def refuse(w_h):
        raise AssertionError("packed on the CPU")

    monkeypatch.setattr(recurrent, "pack_twa_weights", refuse)
    tm = ConvTWA(8)
    x = torch.from_numpy(np.random.RandomState(4).randn(1, 2, 5, 4, 8).astype(np.float32))
    with torch.no_grad():
        assert tm.packed_weight() is None
        ys, _ = tm(x, tm.init_state(5, 4))
    assert torch.isfinite(ys).all()
