"""The port's overlays (`vis/overlay.py`) against the JAX package's on the
same uint8 maps, on the CPU: `heatmap_overlay` equal, and the files of
`visual_img` (PNGs), `visual_vid` (DIVX videos, decoded back) and
`visual_vid_frames` (PNGs), with and without fixations, for a method's
maps and for the ground truth ("GT"), equal bit for bit."""

import os

import cv2
import numpy as np
import pytest

from iip_uavsal_saliency_tpu.data.matio import savemat
from iip_uavsal_saliency_tpu.vis import overlay as joverlay
from iip_uavsal_saliency_tpu_torch.vis import overlay as toverlay
from test_torch_images import write_salicon
from test_torch_train_step import few_threads  # noqa: F401

H, W, T = 40, 72, 6  # native video size and frames


@pytest.fixture(scope="module")
def video_world(tmp_path_factory):
    """A UAV2-layout test set (Videos/, maps/<v>_fixMaps.mat,
    fixations/maps/<v>_fixPts.mat) and a method's uint8 saliency .mat files
    under <results>/Saliency/M."""
    root = str(tmp_path_factory.mktemp("UAV2-TE"))
    res = str(tmp_path_factory.mktemp("results"))
    rng = np.random.RandomState(0)
    for d in ("Videos", "maps", os.path.join("fixations", "maps")):
        os.makedirs(os.path.join(root, d))
    os.makedirs(os.path.join(res, "Saliency", "M"))
    for name in ("vid_a", "vid_b"):
        wr = cv2.VideoWriter(os.path.join(root, "Videos", name + ".avi"),
                             cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (W, H))
        for _ in range(T):
            wr.write(rng.randint(0, 255, (H, W, 3), np.uint8))
        wr.release()
        floc = np.zeros((H, W, 1, T), np.uint8)
        fmap = np.zeros((H, W, 1, T), np.uint8)
        for t in range(T):
            yy, xx = rng.randint(4, H - 4), rng.randint(4, W - 4)
            floc[yy, xx, 0, t] = 1
            blur = cv2.GaussianBlur(floc[:, :, 0, t].astype(np.float32) * 255, (0, 0), 5)
            fmap[:, :, 0, t] = np.rint(blur / blur.max() * 255)
        savemat(os.path.join(root, "maps", name + "_fixMaps.mat"), {"fixMap": fmap})
        savemat(os.path.join(root, "fixations", "maps", name + "_fixPts.mat"), {"fixLoc": floc})
        savemat(os.path.join(res, "Saliency", "M", name + ".mat"),
                {"salmap": rng.randint(0, 256, (H, W, 1, T)).astype(np.uint8)})
    return root, res


def _copy_results(res, dst):
    import shutil

    shutil.copytree(res, dst)
    return str(dst)


def _files(path):
    return sorted(f for f in os.listdir(path) if os.path.isfile(os.path.join(path, f)))


@pytest.mark.parametrize("case", ["same_size", "resized", "float_map", "rgb_map"])
def test_heatmap_overlay_equals_jax(case):
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    hmap = {"same_size": rng.randint(0, 256, (H, W)).astype(np.uint8),
            "resized": rng.randint(0, 256, (20, 36)).astype(np.uint8),
            "float_map": rng.rand(H, W).astype(np.float32) * 3,
            "rgb_map": rng.randint(0, 256, (H, W, 3)).astype(np.uint8)}[case]
    got, want = toverlay.heatmap_overlay(img, hmap), joverlay.heatmap_overlay(img, hmap)
    assert got.dtype == want.dtype and got.shape == want.shape == (H, W, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("with_fix", [0, 1])
def test_visual_img_equals_jax(tmp_path, with_fix):
    root = write_salicon(tmp_path / "salicon", (("val", 3),))
    val = os.path.join(root, "val")
    outs = {}
    for who, fn in (("port", toverlay.visual_img), ("jax", joverlay.visual_img)):
        sals = str(tmp_path / who)
        os.makedirs(os.path.join(sals, "M"))
        for f in sorted(os.listdir(os.path.join(val, "maps"))):
            cv2.imwrite(os.path.join(sals, "M", f), np.random.RandomState(
                int(f[4:7])).randint(0, 255, (32, 48), np.uint8))
        fn(val, sals, ["M"], with_fix=with_fix)
        outs[who] = os.path.join(sals, "M", "Visual_color")
    names = _files(outs["port"])
    assert names == _files(outs["jax"]) and len(names) == 3
    for n in names:
        a = cv2.imread(os.path.join(outs["port"], n), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(a, cv2.imread(os.path.join(outs["jax"], n),
                                                    cv2.IMREAD_UNCHANGED))
    # a second call writes nothing new
    stamp = os.stat(os.path.join(outs["port"], names[0])).st_mtime_ns
    toverlay.visual_img(val, str(tmp_path / "port"), ["M"], with_fix=with_fix)
    assert os.stat(os.path.join(outs["port"], names[0])).st_mtime_ns == stamp


def _frames(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return np.stack(frames)


@pytest.mark.parametrize("method,with_color,with_fix,small_out", [
    ("M", 1, 0, True), ("M", 1, 1, True), ("M", 0, 1, False), ("GT", 1, 1, True)])
def test_visual_vid_equals_jax(video_world, tmp_path, method, with_color, with_fix, small_out):
    """The videos decoded back: the same frames (the same encoder on the
    same pixels); for GT under a copy of the dataset, where they land."""
    root, res = video_world
    sub = ("Visual_color_fix" if with_fix else "Visual_color_map") if with_color \
        else "Visual_gray"
    outs = {}
    for who, fn in (("port", toverlay.visual_vid), ("jax", joverlay.visual_vid)):
        data = _copy_results(root, tmp_path / who / "data")
        results = _copy_results(res, tmp_path / who / "results")
        fn(data, results, "UAV2-TE", [method], with_color=with_color, with_fix=with_fix,
           small_out=small_out)
        base = os.path.join(data, "maps") if method == "GT" else os.path.join(
            results, "Saliency", method)
        outs[who] = os.path.join(base, sub)
    names = _files(outs["port"])
    assert names == _files(outs["jax"]) == ["vid_a.mp4", "vid_b.mp4"]
    for n in names:
        got, want = _frames(os.path.join(outs["port"], n)), _frames(os.path.join(outs["jax"], n))
        assert got.shape == want.shape and got.shape[0] == T
        assert got.shape[2] == (1280 if small_out else W), got.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method,with_color,with_fix", [
    ("M", 1, 0), ("M", 1, 1), ("M", 0, 0), ("GT", 1, 0), ("GT", 1, 1)])
def test_visual_vid_frames_equals_jax(video_world, tmp_path, method, with_color, with_fix):
    root, res = video_world
    outs = {}
    for who, fn in (("port", toverlay.visual_vid_frames), ("jax", joverlay.visual_vid_frames)):
        results = _copy_results(res, tmp_path / who)
        fn(root, results, "UAV2-TE", [method], frame_indices=(0, 3, 5, 9),
           with_color=with_color, with_fix=with_fix)
        outs[who] = os.path.join(results, "Saliency", method, "Visual_frames")
    names = _files(outs["port"])
    assert names == _files(outs["jax"])
    assert len(names) == 2 * 3 * (2 if with_color else 1)  # frame 9 is past the end
    for n in names:
        a = cv2.imread(os.path.join(outs["port"], n), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(a, cv2.imread(os.path.join(outs["jax"], n),
                                                    cv2.IMREAD_UNCHANGED))
