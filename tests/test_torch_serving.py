"""The port's serving path against the JAX package on the CPU at 64x128.

- the serving step on uint8 clips (live and baked) against JAX
  `_build_infer_fn`, f32, state carried over 2 clips;
- the clip loop of `predict_videos` against JAX `test_videos` on the same
  decoded videos, uint8 maps at native size;
- the port's bf16 step against its f32 step at the metric level;
- the postprocess, the `.ckpt` reader and the no-card guard.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iip_uavsal_saliency_tpu.data import letterbox as jletterbox
from iip_uavsal_saliency_tpu.data.matio import loadmat
from iip_uavsal_saliency_tpu.data.video import preprocess_videos
from iip_uavsal_saliency_tpu.evaluation.metrics_np import cc_np, nss_np
from iip_uavsal_saliency_tpu.parallel.steps import _build_infer_fn
from iip_uavsal_saliency_tpu.runners import infer as jinfer
from iip_uavsal_saliency_tpu.training.checkpoint import save_checkpoint
from iip_uavsal_saliency_tpu_torch import device as tdevice
from iip_uavsal_saliency_tpu_torch.data import letterbox as tletterbox
from iip_uavsal_saliency_tpu_torch.runners.infer import load_model_for_inference, predict_videos
from iip_uavsal_saliency_tpu_torch.serving.steps import build_infer_fn, make_baked_infer_step
from iip_uavsal_saliency_tpu_torch.training.checkpoint import load_checkpoint

H, W, T = 64, 128, 5
IOSIZE = (H, W, H // 8, W // 8)
# f32: XLA and torch order the conv sums differently, and the baked step
# folds BatchNorm into the convs in torch. Observed <= 1.8e-7 on the
# saliency (std ~0.01) and <= 2.6e-6 on the state (values up to ~2).
ATOL_SALIENCY = 1e-6
ATOL_STATE = 1e-5


def _randomize(tree, rng):
    """Seeded values for every leaf: kernels with std 1/sqrt(fan_in) and
    random BatchNorm statistics, so the maps have structure to compare."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k in ("var", "scale"):
            out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
        elif k in ("mean", "bias"):
            out[k] = rng.normal(0.0, 0.1, np.shape(v)).astype(np.float32)
        else:
            fan_in = np.prod(np.shape(v)[:-1])
            out[k] = rng.normal(0.0, 1.0 / np.sqrt(fan_in), np.shape(v)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def served(uavsal_small):
    """(jax model, seeded numpy variables, priors (g, o), jitted JAX step)."""
    model, variables, _ = uavsal_small
    variables = _randomize(jax.tree_util.tree_map(np.asarray, dict(variables)),
                           np.random.RandomState(1))
    rng = np.random.RandomState(2)
    g = rng.rand(H // 8, W // 8, 8).astype(np.float32)
    o = rng.rand(H // 8, W // 8, 20).astype(np.float32)
    return model, variables, (g, o), jax.jit(_build_infer_fn(model))


def _clip(v, s, seed):
    return np.random.RandomState(seed).randint(0, 256, (v, s, H, W, 3)).astype(np.uint8)


@pytest.mark.parametrize("form", ["live", "baked"])
def test_serving_step_matches_jax_on_uint8(served, form):
    jmodel, variables, (g, o), jstep = served
    model = load_model_for_inference(variables, fold_bn=form == "baked", device="cpu")
    if form == "baked":
        step = make_baked_infer_step(model, g, o)
    else:
        live = build_infer_fn(model)
        step = lambda x, st: live(x, torch.from_numpy(g), torch.from_numpy(o), st)  # noqa: E731
    jstate = jmodel.init_state(H, W, 1)
    tstate = model.init_state(H, W, 1)
    for k in range(2):
        x = _clip(1, 2 * T, 30 + k)  # two time_dims groups: the t-major context tile
        want, jstate = jstep(variables["params"], variables["batch_stats"],
                             jnp.asarray(x), jnp.asarray(g), jnp.asarray(o), jstate)
        got, tstate = step(torch.from_numpy(x), tstate)
        assert got.dtype == torch.float32 and float(np.std(np.asarray(want))) > 1e-3
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_SALIENCY, rtol=0)
        np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate), atol=ATOL_STATE, rtol=0)


def _write_video(path, n, rng):
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (96, 72))
    for _ in range(n):
        wr.write(rng.randint(0, 255, (72, 96, 3), np.uint8))
    wr.release()


def test_clip_loop_matches_jax_test_videos(served, tmp_path):
    """Two videos in lock-step (V=2) over clips of S=10: the short one is
    padded within its first clip and exhausted in the second. The port's
    uint8 maps at native size match the JAX runner's .mat within one level."""
    jmodel, variables, (g, o), jstep = served
    vid_dir = tmp_path / "Videos"
    os.makedirs(vid_dir)
    rng = np.random.RandomState(4)
    _write_video(vid_dir / "a.avi", 23, rng)
    _write_video(vid_dir / "b.avi", 7, rng)
    params, stats = variables["params"], variables["batch_stats"]
    out = str(tmp_path / "out")
    # bias_type only picks the runner's prior loaders; the step carries g, o
    jinfer.test_videos(str(vid_dir), out, jmodel, variables, iosize=IOSIZE, batch_size=2,
                       time_dims=T, bias_type=(0, 0, 0), method_name="JAX",
                       videos_per_batch=2,
                       infer_step=lambda p, b, x, gg, oo, st: jstep(params, stats, x, g, o, st))

    videos, sizes = [], []
    for name in ("a.avi", "b.avi"):
        imgs, _, height, width = preprocess_videos(str(vid_dir / name), H, W, mode="RGB",
                                                   normalize=False)
        videos.append(imgs)
        sizes.append((height, width))
    model = load_model_for_inference(variables, device="cpu")
    step = make_baked_infer_step(model, g, o)
    maps = predict_videos(step, model, videos, sizes, batch_size=2, time_dims=T,
                          videos_per_batch=2)
    for name, got, frames in zip(("a", "b"), maps, (20, 5)):
        want = loadmat(os.path.join(out, "JAX", name + ".mat"), "salmap")
        assert got.shape == want.shape == (72, 96, 1, frames) and got.dtype == np.uint8
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1, f"{name}: max uint8 diff {diff.max()}"


def test_bf16_step_metric_parity(served):
    """The bf16 serving step on the CPU holds CC and NSS against a synthetic
    ground truth within 1% of the f32 step (floors as in
    tests/test_pipeline.py::test_bf16_serving_metric_parity)."""
    _, variables, (g, o), _ = served
    rng = np.random.RandomState(5)
    clips = [_clip(1, 2 * T, 50 + k) for k in range(2)]
    maps = {}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        model = load_model_for_inference(variables, device="cpu")
        step = make_baked_infer_step(model, g, o, compute_dtype=dtype)
        state = model.init_state(H, W, 1, dtype=dtype or torch.float32)
        outs = []
        for x in clips:
            sal, state = step(torch.from_numpy(x), state)
            assert sal.dtype == torch.float32 and state.dtype == (dtype or torch.float32)
            outs.append(sal[0, :, :, :, 0].numpy())
        maps[name] = np.concatenate(outs)
    yy, xx = np.mgrid[0:H // 8, 0:W // 8]
    gt = np.exp(-((yy - 3.5) ** 2 + (xx - 9.0) ** 2) / 8.0)
    fix = (rng.rand(H // 8, W // 8) < gt * 0.5).astype(np.float64)
    scores = {name: {"CC": np.mean([cc_np(m, gt) for m in ms]),
                     "NSS": np.mean([nss_np(m, fix) for m in ms])}
              for name, ms in maps.items()}
    for key, floor in (("CC", 0.01), ("NSS", 0.05)):
        a, b = scores["f32"][key], scores["bf16"][key]
        assert abs(a - b) <= max(0.01 * abs(a), floor), (key, a, b)
    # the maps themselves: observed >= 0.982 per 8x16 frame with these weights
    frame_cc = [cc_np(a, b) for a, b in zip(maps["bf16"], maps["f32"])]
    assert min(frame_cc) >= 0.97, frame_cc


@pytest.mark.parametrize("native", [(72, 96), (100, 300), (540, 960)])
def test_postprocess_matches_jax(native):
    rng = np.random.RandomState(native[0])
    pred = rng.rand(3, H // 8, W // 8).astype(np.float32)
    got = tletterbox.im2uint8(tletterbox.postprocess_prediction(torch.from_numpy(pred), *native))
    assert got.shape == (3,) + native and got.dtype == torch.uint8
    for t in range(3):
        want = jletterbox.im2uint8(jletterbox.postprocess_prediction(pred[t], *native))
        diff = np.abs(got[t].numpy().astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1, f"frame {t}: max uint8 diff {diff.max()}"


def test_load_checkpoint_reads_jax_ckpt(served, tmp_path):
    _, variables, _, _ = served
    rng = np.random.RandomState(6)
    extra = {"half": jnp.asarray(rng.randn(3, 4), jnp.bfloat16),
             "epoch": np.int32(7), "step": 12}
    path = str(tmp_path / "m.ckpt")
    save_checkpoint(path, {"params": variables["params"],
                           "batch_stats": variables["batch_stats"], "extra": extra})
    tree = load_checkpoint(path)
    flat_want = jax.tree_util.tree_flatten_with_path(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]})[0]
    flat_got = jax.tree_util.tree_flatten_with_path(
        {"params": tree["params"], "batch_stats": tree["batch_stats"]})[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path_, a), (_, b) in zip(flat_want, flat_got):
        np.testing.assert_array_equal(b, a, err_msg=str(path_))
    np.testing.assert_array_equal(tree["extra"]["half"],
                                  np.asarray(extra["half"], np.float32))
    assert tree["extra"]["epoch"] == 7 and tree["extra"]["step"] == 12

    from_file = load_model_for_inference(path, device="cpu").state_dict()
    from_tree = load_model_for_inference(variables, device="cpu").state_dict()
    for key, value in from_tree.items():
        torch.testing.assert_close(from_file[key], value, atol=0, rtol=0)


def test_entry_points_raise_without_a_card(served, monkeypatch):
    """With no card and no device asked for, the port raises; it never
    falls back to the CPU by itself."""
    _, variables, _, _ = served
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model_for_inference(variables)
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
