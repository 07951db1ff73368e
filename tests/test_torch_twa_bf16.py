"""The bf16 per-frame K1 kernel's CPU-side parts: the packed W_h it reads,
a model of its sum in the kernel's order on the CPU, ConvTWA's cache of the
pack, and `cli test` at a width whose state the persistent kernel refuses
on the card. The kernel itself is held against its plain version on the
card by tests/test_torch_kernels_gpu.py and chip_smoke.py."""

import json
import os
import re

import numpy as np
import pytest
import torch

from iip_uavsal_saliency_tpu_torch import kernels
from iip_uavsal_saliency_tpu_torch.models import recurrent
from iip_uavsal_saliency_tpu_torch.models.recurrent import ConvTWA
from iip_uavsal_saliency_tpu_torch.ops import twa
from test_torch_train_step import few_threads  # noqa: F401

TOL_BF16 = 2e-2  # chip_smoke.py's tolerance of K1 in bf16 against twa_scan_ref


def _bf16_step_constant(name: str) -> int:
    """A `static constexpr int` of the kernel source's Bf16Step."""
    source = (kernels.CSRC / "twa_scan.cu").read_text()
    struct = source[source.index("struct Bf16Step {"):]
    struct = struct[:struct.index("};")]
    return int(re.search(rf"static constexpr int {name} = (\d+);", struct).group(1))


def test_bf16_layout_constants_are_the_sources():
    """The pack's constants are the kernel source's (the card also holds
    them against what the built library exports, `twa_bf16_layout`)."""
    assert [twa.BF16_CHUNK, twa.BF16_COLUMNS, twa.BF16_PLANE] == [
        _bf16_step_constant(n) for n in ("KC", "BN", "PLANE")]


@pytest.mark.parametrize("c", [8, 24, 64, 256])
def test_pack_twa_weights_bf16_unpacks_exactly(c):
    """Element by element from the layout's formula: flat index -> (chunk,
    tap, plane, column, k) -> W_h[ky, kx, 64q + 8j + k, n], the bits of W_h
    in bf16, zero in the padding."""
    w = torch.from_numpy(np.random.RandomState(c).randn(3, 3, c, c).astype(np.float32))
    w = w.bfloat16()
    blob = twa.pack_twa_weights_bf16(w)
    assert blob.dtype == torch.bfloat16 and blob.shape == (twa.packed_twa_bf16_size(c),)
    blob = blob.float().numpy()
    ncol = -(-c // twa.BF16_COLUMNS) * twa.BF16_COLUMNS
    idx = np.arange(blob.size)
    idx, k = np.divmod(idx, twa.BF16_PLANE)
    idx, n = np.divmod(idx, ncol)
    idx, j = np.divmod(idx, twa.BF16_CHUNK // twa.BF16_PLANE)
    q, tap = np.divmod(idx, 9)
    assert q.max() == -(-c // twa.BF16_CHUNK) - 1
    ci = twa.BF16_CHUNK * q + twa.BF16_PLANE * j + k
    inside = (ci < c) & (n < c)
    want = w.float().numpy()[tap[inside] // 3, tap[inside] % 3, ci[inside], n[inside]]
    np.testing.assert_array_equal(blob[inside], want)
    assert not blob[~inside].any()  # the padding is zero
    assert (~inside).any() == (c % twa.BF16_COLUMNS != 0)


def test_pack_twa_weights_bf16_rejects_what_the_kernel_does_not_read():
    with pytest.raises(ValueError, match="bf16 W_h"):
        twa.pack_twa_weights_bf16(torch.zeros(3, 3, 8, 8))
    with pytest.raises(ValueError, match="bf16 W_h"):
        twa.pack_twa_weights_bf16(torch.zeros(3, 3, 8, 16, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="bf16 W_h"):
        twa.pack_twa_weights_bf16(torch.zeros(1, 3, 8, 8, dtype=torch.bfloat16))


def _kernel_frame(x, gx, hprev, blob, c):
    """One frame of one video as the bf16 per-frame kernel computes it, on
    arrays (H, W, C) of bf16 values held in f32: the GEMM's rows are the
    positions of the image padded by a zero column each side; a tile of BM
    positions stages, per tap row, its positions from one before to one
    past (zeros outside the image) in chunks of KC channels; tap (dy, dx)
    reads that row shifted by dx; B is the blob read back slot by slot
    (chunk, tap; planes of a block's BN columns); the bf16 products are
    summed in f32 over all of K, gx is added in f32, then gate and lerp in
    f32 and one rounding to bf16. Rows on a pad column are dropped."""
    bm, bn, kc, plane = (_bf16_step_constant(n) for n in ("BM", "BN", "KC", "PLANE"))
    h, w, _ = x.shape
    wp, mp = w + 2, h * (w + 2)
    nchunk = -(-c // kc)
    ncol = -(-c // twa.BF16_COLUMNS) * twa.BF16_COLUMNS
    padded = np.zeros((h, wp, nchunk * kc), np.float32)
    padded[:, 1:w + 1, :c] = hprev
    flat = padded.reshape(mp, -1)
    slots = blob.reshape(nchunk, 9, kc // plane, ncol, plane)
    out = np.full((h * w, c), np.nan, np.float32)
    for m0 in range(0, mp, bm):
        pos = m0 + (np.arange(3)[:, None] - 1) * wp - 1 + np.arange(bm + 2)[None]
        staged = np.where(((pos >= 0) & (pos < mp))[..., None], flat[np.clip(pos, 0, mp - 1)], 0)
        p = m0 + np.arange(bm)
        y, xp = np.divmod(p, wp)
        keep = (p < mp) & (xp >= 1) & (xp <= w)
        pix = (y * w + xp - 1)[keep]
        for n0 in range(0, c, bn):
            cols = np.arange(n0, min(n0 + bn, c))
            acc = np.zeros((bm, bn), np.float32)
            for ch in range(nchunk):
                for tap in range(9):
                    dy, dx = divmod(tap, 3)
                    a = staged[dy, dx:dx + bm, ch * kc:(ch + 1) * kc]
                    b = slots[ch, tap, :, n0:n0 + bn, :].transpose(0, 2, 1).reshape(kc, bn)
                    acc += a @ b
            z = acc[keep][:, :len(cols)] + gx.reshape(-1, c)[pix][:, cols]
            g = 1.0 / (1.0 + np.exp(-z))
            xv, hv = x.reshape(-1, c)[pix][:, cols], hprev.reshape(-1, c)[pix][:, cols]
            out[pix[:, None], cols[None]] = g * xv + (1.0 - g) * hv
    assert not np.isnan(out).any()  # every pixel and channel written once
    return torch.from_numpy(out.reshape(h, w, c)).bfloat16()


@pytest.mark.parametrize("hwc", [(45, 80, 256), (13, 7, 24), (5, 148, 64)],
                         ids=["flagship", "ragged", "wide"])
def test_kernel_sum_holds_twa_scan_ref(hwc):
    """The kernel's arithmetic in its own order (`_kernel_frame`) on one
    frame drawn as chip_smoke.py draws K1's inputs,
    rounded to bf16: within TOL_BF16 of `twa_scan_ref` computed in f32 on
    the same bf16 inputs, and within one bf16 rounding (half an ulp of |h| <
    4, 2^-7) plus the f32 sums' order."""
    h, w, c = hwc
    rng = np.random.default_rng(3)
    x, gx, hprev = (torch.from_numpy(rng.normal(0, 0.5, (1, 1, h, w, c)).astype(np.float32))
                    .bfloat16() for _ in range(3))
    w_h = torch.from_numpy(rng.normal(0, np.sqrt(2.0 / (9 * c)), (3, 3, c, c))
                           .astype(np.float32)).bfloat16()
    blob = twa.pack_twa_weights_bf16(w_h).float().numpy()
    got = _kernel_frame(*(t[0, 0].float().numpy() for t in (x, gx, hprev)), blob, c)
    ref, _ = twa.twa_scan_ref(x.float(), gx.float(), w_h.float(), hprev[:, 0].float())
    err = (got.float() - ref[0, 0]).abs().max().item()
    assert err <= 2.0 ** -7 + 1e-5, err
    assert err <= TOL_BF16


@pytest.fixture
def packs_on_the_cpu(monkeypatch):
    """ConvTWA as it is on the card, where f32 and bf16 weights may be
    packed (the device test alone is replaced), with the bf16 packs counted
    and the scan replaced by a spy of what it is handed."""
    made, handed = [], []
    monkeypatch.setattr(recurrent, "_packs",
                        lambda w: w.dtype in (torch.float32, torch.bfloat16))

    def counting(w_h):
        made.append(w_h.shape)
        return twa.pack_twa_weights_bf16(w_h)

    def spy(x, gx, w_h, h0, packed=None):
        handed.append(packed)
        ys, last = twa.twa_scan_ref(x.float(), gx.float(), w_h.float(), h0.float())
        return ys.to(x.dtype), last.to(x.dtype)

    monkeypatch.setattr(recurrent, "pack_twa_weights_bf16", counting)
    monkeypatch.setattr(recurrent, "twa_scan", spy)
    return made, handed


def _frames(c, v=1, s=2, h=5, w=4):
    return torch.from_numpy(np.random.RandomState(c).randn(v, s, h, w, c)
                            .astype(np.float32)).bfloat16()


def test_conv_twa_packs_bf16_once_for_serving_on_the_per_frame_route(packs_on_the_cpu):
    """C = 24 goes to the per-frame kernel: the pack is made once, from
    exactly the cached split's W_h, handed to every scan, and made again
    when the weight changes: in place, by a load, by a cast."""
    made, handed = packs_on_the_cpu
    tm = ConvTWA(24).bfloat16()
    x = _frames(24)
    assert twa.kernel_route(x.shape, x.dtype) == "twa_step"
    with torch.no_grad():
        tm(x, tm.init_state(5, 4, dtype=torch.bfloat16))
        tm(x, tm.init_state(5, 4, dtype=torch.bfloat16))
        assert len(made) == 1 and handed[0] is not None and handed[1] is handed[0]
        assert torch.equal(handed[0], twa.pack_twa_weights_bf16(tm.split_weight()[1]))
        tm.cell_list[0].rnn_conv.weight.mul_(2.0)
        tm(x, tm.init_state(5, 4, dtype=torch.bfloat16))
        assert len(made) == 2 and torch.equal(handed[2], 2.0 * handed[0])
        tm.load_state_dict(tm.state_dict())
        assert tm._packed is None
        tm(x, tm.init_state(5, 4, dtype=torch.bfloat16))
        assert len(made) == 3
        tm.float()
        assert tm._packed is None and tm.packed_weight().dtype == torch.float32
        tm.bfloat16()
        tm(x, tm.init_state(5, 4, dtype=torch.bfloat16))
        assert len(made) == 4 and handed[-1].dtype == torch.bfloat16


def test_conv_twa_makes_no_bf16_pack_on_the_persistent_route(packs_on_the_cpu):
    """C = 32 at width 4 goes to the persistent kernel, which reads W_h as
    it is: no pack is made or handed."""
    made, handed = packs_on_the_cpu
    tm = ConvTWA(32).bfloat16()
    x = _frames(32)
    assert twa.kernel_route(x.shape, x.dtype) == "twa_scan"
    with torch.no_grad():
        tm(x, tm.init_state(5, 4, dtype=torch.bfloat16))
    assert not made and handed == [None]


def test_conv_twa_leaves_the_bf16_pack_to_the_scan_when_a_gradient_is_wanted(packs_on_the_cpu):
    """A train step hands the scan no pack (the scan packs once per call,
    from the W_h the gradient flows through) and ConvTWA makes none."""
    made, handed = packs_on_the_cpu
    tm = ConvTWA(24).bfloat16()
    ys, _ = tm(_frames(24), tm.init_state(5, 4, dtype=torch.bfloat16))
    assert ys.requires_grad and handed == [None] and not made


def test_conv_twa_on_the_cpu_makes_no_bf16_pack(monkeypatch):
    def refuse(w_h):
        raise AssertionError("packed on the CPU")

    monkeypatch.setattr(recurrent, "pack_twa_weights_bf16", refuse)
    tm = ConvTWA(24).bfloat16()
    with torch.no_grad():
        assert tm.packed_weight() is None
        ys, _ = tm(_frames(24), tm.init_state(5, 4, dtype=torch.bfloat16))
    assert ys.dtype == torch.bfloat16 and torch.isfinite(ys.float()).all()


# `cli test` at 64x1184 -> a state of 8x148x256: on the card the persistent
# kernel refuses that width (one row with its halo does not fit beside its
# W_h slice), so bf16 serving there runs the per-frame kernel; here the CPU
# serves it through the plain scan, against the JAX runner at that iosize.
WIDE_IOSIZE = (64, 1184, 8, 148)
WIDE_VIDEOS = {"a": (10, 32, 592), "b": (5, 48, 400)}  # frames, native height and width


def _write_wide_dataset(root, rng):
    """The reference layout (Videos/, maps/<v>_fixMaps.mat, txt/train.txt)
    with two short videos at native sizes that letterbox into 64x1184."""
    import cv2

    from iip_uavsal_saliency_tpu.data import matio as jmatio

    for d in ("Videos", "maps", "txt"):
        os.makedirs(os.path.join(root, d))
    for name, (n, h, w) in WIDE_VIDEOS.items():
        wr = cv2.VideoWriter(os.path.join(root, "Videos", name + ".avi"),
                             cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (w, h))
        fmap = np.zeros((h, w, 1, n), np.uint8)
        for t in range(n):
            wr.write(rng.randint(0, 255, (h, w, 3), np.uint8))
            blur = np.zeros((h, w), np.float32)
            blur[rng.randint(4, h - 4), rng.randint(8, w - 8)] = 255
            fmap[:, :, 0, t] = cv2.GaussianBlur(blur, (21, 21), 6).astype(np.uint8)
        wr.release()
        jmatio.savemat(os.path.join(root, "maps", name + "_fixMaps.mat"), {"fixMap": fmap})
    with open(os.path.join(root, "txt", "train.txt"), "w") as f:
        f.write("\n".join(WIDE_VIDEOS) + "\n")


def test_cli_test_at_a_wide_iosize_matches_the_jax_runner(tmp_path):
    """The slice whole on the CPU: the flagship from a `.ckpt` the JAX
    package wrote, served by the port's `cli test` at 64x1184 (state
    8x148x256), f32, to the `.mat` files the JAX runner writes at that
    iosize, within one uint8 level (as tests/test_torch_cli_configs.py);
    each run takes an empty temporary `priors_cache_dir`."""
    pytest.importorskip("cv2")
    from iip_uavsal_saliency_tpu.parallel.steps import _build_infer_fn
    from iip_uavsal_saliency_tpu.runners import infer as jinfer
    from iip_uavsal_saliency_tpu.training import checkpoint as jckpt
    from iip_uavsal_saliency_tpu_torch import cli
    from test_torch_runner import _read_dir
    from test_torch_uavsal_configs import jax_config

    jmodel, variables = jax_config()
    ckpt = str(tmp_path / "flagship.ckpt")
    jckpt.save_checkpoint(ckpt, variables)
    root = str(tmp_path / "data" / "UAV2")
    _write_wide_dataset(root, np.random.RandomState(21))
    jmodel, jvars = jinfer.load_model_for_inference(ckpt, time_dims=5)
    fn = _build_infer_fn(jmodel)
    params, stats = jvars["params"], jvars["batch_stats"]
    jax_cache, port_cache = tmp_path / "jax_priors", tmp_path / "port_priors"
    os.makedirs(jax_cache)
    os.makedirs(port_cache)
    jinfer.test_videos(os.path.join(root, "Videos"), str(tmp_path / "jax_out"), jmodel, jvars,
                       iosize=WIDE_IOSIZE, batch_size=1, time_dims=5, train_data_dir=root,
                       dataset="UAV2", priors_cache_dir=str(jax_cache), method_name="JAX",
                       infer_step=lambda p, b, x, g, o, st: fn(params, stats, x, g, o, st))
    want = _read_dir(str(tmp_path / "jax_out" / "JAX"))
    cfg = {"data_dir": str(tmp_path / "data"), "train_dataset": "UAV2",
           "test_dataset": "UAV2", "iosize": list(WIDE_IOSIZE), "time_dims": 5,
           "test_batch_size": 1, "serve_bf16": False, "priors_cache_dir": str(port_cache),
           "method_name": "CLI"}
    with open(tmp_path / "cfg.json", "w") as f:
        json.dump(cfg, f)
    assert cli.main(["test", "--config", str(tmp_path / "cfg.json"), "--model-path", ckpt,
                     "--device", "cpu"]) == 0
    got = _read_dir(os.path.join(root, "Results", "Results_CLI", "Saliency", "CLI"))
    assert sorted(got) == sorted(want) == ["a", "b"]
    for name, (n, h, w) in WIDE_VIDEOS.items():
        assert want[name].shape == (h, w, 1, n) and got[name].dtype == np.uint8
        assert got[name].shape == want[name].shape
        diff = np.abs(got[name].astype(np.int16) - want[name].astype(np.int16))
        assert diff.max() <= 1, name  # one uint8 level
        assert got[name].std() > 1, name  # maps with structure
    assert os.listdir(port_cache)  # the observed priors were built at 8x148
