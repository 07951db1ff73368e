"""The reference's three-stage recipe and the end of its flow through the
port's CLI on the CPU, at 64x64 (as the JAX package's
`tests/test_pipeline.py::test_cli_three_stage_recipe`): `train-img` on a
SALICON layout, `train --model-path <image ckpt>` (the neck transplanted
and kept bit for bit by the default freeze), `test` to `.mat` files,
`test_images` PNGs scored by `eval-img`, `vis` overlays, and `pipeline`
(train -> test -> eval -> vis) with `--frames` and `--with-fix`; the vis
flags refused elsewhere, and the commands still refused."""

import json
import os

import cv2
import numpy as np
import pytest

from iip_uavsal_saliency_tpu.data.matio import savemat
from iip_uavsal_saliency_tpu_torch import cli
from iip_uavsal_saliency_tpu_torch.data.matio import loadmat
from iip_uavsal_saliency_tpu_torch.runners import infer_images as tinfer_images
from iip_uavsal_saliency_tpu_torch.training.checkpoint import load_checkpoint
from test_torch_images import write_salicon
from test_torch_train_step import few_threads  # noqa: F401

NATIVE_H, NATIVE_W, NFRAMES = 48, 80, 4
VIDEOS = ("vid_a", "vid_b")


def write_videos(root, rng):
    """The UAV2 layout: Videos/*.avi, maps/<v>_fixMaps.mat,
    fixations/maps/<v>_fixPts.mat, txt/{train,val}.txt."""
    for d in ("Videos", "maps", os.path.join("fixations", "maps"), "txt"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for name in VIDEOS:
        wr = cv2.VideoWriter(os.path.join(root, "Videos", name + ".avi"),
                             cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (NATIVE_W, NATIVE_H))
        for _ in range(NFRAMES):
            wr.write(rng.randint(0, 255, (NATIVE_H, NATIVE_W, 3), np.uint8))
        wr.release()
        fmap = np.zeros((NATIVE_H, NATIVE_W, 1, NFRAMES), np.uint8)
        floc = np.zeros((NATIVE_H, NATIVE_W, 1, NFRAMES), np.uint8)
        for t in range(NFRAMES):
            yy, xx = rng.randint(8, NATIVE_H - 8), rng.randint(8, NATIVE_W - 8)
            floc[yy, xx, 0, t] = 1
            blur = cv2.GaussianBlur(floc[:, :, 0, t].astype(np.float32) * 255, (21, 21), 6)
            fmap[:, :, 0, t] = np.rint(blur / blur.max() * 255)
        savemat(os.path.join(root, "maps", name + "_fixMaps.mat"), {"fixMap": fmap})
        savemat(os.path.join(root, "fixations", "maps", name + "_fixPts.mat"), {"fixLoc": floc})
    for split, name in (("train", "vid_a"), ("val", "vid_b")):
        with open(os.path.join(root, "txt", split + ".txt"), "w") as f:
            f.write(name + "\n")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("data"))
    write_salicon(os.path.join(data, "salicon-15"), (("train", 4), ("val", 2)))
    write_videos(os.path.join(data, "UAV2"), np.random.RandomState(1))
    write_videos(os.path.join(data, "UAV2-TE"), np.random.RandomState(2))
    save = str(tmp_path_factory.mktemp("weights"))
    common = ["--data_dir", data, "--save_model_dir", save,
              "--priors_cache_dir", str(tmp_path_factory.mktemp("priors")),
              "--epochs", "1", "--is_early_stop", "false", "--device", "cpu"]
    video = ["--iosize", "64,64,8,8", "--time_dims", "2", "--bias_type", "1,0,1"]
    return data, save, common, video


@pytest.fixture(scope="module")
def recipe(world):
    """Stages 1-3 as the reference's README runs them."""
    data, save, common, video = world
    assert cli.main(["train-img", "--img_iosize", "64,64,8,8", "--batch_size", "2",
                     "--method_name", "E2E"] + common) == 0
    img_ckpt = os.path.join(save, "E2E_srfnet", "E2E_srfnet_final.ckpt")
    assert cli.main(["train", "--model-path", img_ckpt, "--batch_size", "1",
                     "--method_name", "E2E"] + video + common) == 0
    assert cli.main(["test", "--test_batch_size", "2", "--serve_bf16", "false",
                     "--method_name", "E2E"] + video + common) == 0
    return img_ckpt, os.path.join(save, "E2E", "E2E_final.ckpt")


def test_train_img_then_train_keeps_the_transplanted_neck(recipe):
    """The video checkpoint's trunk/sfnet parameters are the image stage's
    bit for bit (frozen by default); its BatchNorm stats moved in train
    mode, and the parts after the neck trained."""
    img_ckpt, vid_ckpt = recipe
    img, vid = load_checkpoint(img_ckpt), load_checkpoint(vid_ckpt)
    assert set(img["params"]) == {"sfnet", "conv_out"}
    np.testing.assert_array_equal(vid["params"]["trunk"]["sfnet"]["conv_last"]["conv"]["kernel"],
                                  img["params"]["sfnet"]["conv_last"]["conv"]["kernel"])

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            yield from leaves(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)]

    got = dict(leaves(vid["params"]["trunk"]["sfnet"]))
    want = dict(leaves(img["params"]["sfnet"]))
    assert got.keys() == want.keys() and len(want) > 150
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    assert not np.array_equal(vid["batch_stats"]["trunk"]["sfnet"]["conv_last"]["bn"]["mean"],
                              img["batch_stats"]["sfnet"]["conv_last"]["bn"]["mean"])


def test_test_writes_the_video_maps(world, recipe):
    data = world[0]
    out = os.path.join(data, "UAV2-TE", "Results", "Results_E2E", "Saliency", "E2E")
    assert sorted(os.listdir(out)) == ["vid_a.mat", "vid_b.mat"]
    sal = loadmat(os.path.join(out, "vid_a.mat"), "salmap")
    assert sal.shape == (NATIVE_H, NATIVE_W, 1, NFRAMES) and sal.dtype == np.uint8


def test_test_images_pngs_scored_by_eval_img(world, recipe):
    """The image stage served by `test_images` into the layout `eval-img`
    reads, then scored by it."""
    data, _, common, _ = world
    val = os.path.join(data, "salicon-15", "val")
    res = os.path.join(val, "Results", "Results_E2E")
    model = tinfer_images.load_image_model(recipe[0], device="cpu")
    tinfer_images.test_images(os.path.join(data, "salicon-15"), os.path.join(res, "Saliency"),
                              model, iosize=(64, 64, 8, 8), batch_size=2, method_name="E2E")
    assert sorted(os.listdir(os.path.join(res, "Saliency", "E2E"))) == ["img_000.png",
                                                                        "img_001.png"]
    assert cli.main(["eval-img", "--method_name", "E2E"] + common) == 0
    scores = loadmat(os.path.join(res, "Scores", "Score_E2E.mat"), "scores")
    assert scores.shape == (2, 7) and np.isfinite(scores).all()


def test_vis_overlays_the_served_maps(world, recipe):
    data, _, common, _ = world
    assert cli.main(["vis", "--method_name", "E2E", "--methods", "E2E,GT"] + common) == 0
    sal = os.path.join(data, "UAV2-TE", "Results", "Results_E2E", "Saliency", "E2E")
    assert sorted(os.listdir(os.path.join(sal, "Visual_color_map"))) == ["vid_a.mp4",
                                                                         "vid_b.mp4"]
    assert sorted(os.listdir(os.path.join(data, "UAV2-TE", "maps", "Visual_color_map"))) == [
        "vid_a.mp4", "vid_b.mp4"]


def test_pipeline_trains_serves_scores_and_overlays(world, recipe):
    """From the image checkpoint: `.mat` maps of the checkpoint it trained
    (not the one it started from), scores and per-frame overlays with the
    fixations burned in."""
    data, save, common, video = world
    assert cli.main(["pipeline", "--model-path", recipe[0], "--batch_size", "1",
                     "--test_batch_size", "2", "--serve_bf16", "false", "--method_name", "P",
                     "--frames", "0,3", "--with-fix"] + video + common) == 0
    assert os.path.exists(os.path.join(save, "P", "P_final.ckpt"))
    res = os.path.join(data, "UAV2-TE", "Results", "Results_P")
    assert sorted(os.listdir(os.path.join(res, "Saliency", "P"))) == [
        "Visual_frames", "vid_a.mat", "vid_b.mat"]
    with open(os.path.join(res, "Scores", "MeanScores.json")) as f:
        means = json.load(f)
    assert np.isfinite(list(means["methods"]["P"].values())).all()
    frames = sorted(os.listdir(os.path.join(res, "Saliency", "P", "Visual_frames")))
    assert frames == [f"{v}_f{i:05d}{s}.png" for v in VIDEOS for i in (0, 3)
                      for s in ("", "_frame")]


@pytest.mark.parametrize("cmd", ["train", "train-img", "test", "eval", "eval-img"])
@pytest.mark.parametrize("flag", [["--with-fix"], ["--frames", "0,5"]])
def test_vis_flags_refused_outside_vis_and_pipeline(cmd, flag):
    with pytest.raises(SystemExit, match="only valid for the vis and pipeline commands"):
        cli.main([cmd] + flag + ["--device", "cpu"])


def test_split_cli_takes_vis_flags_and_device():
    cfg, device, methods, vis, rest = cli._split_cli(
        ["--frames", "0,5,10", "--with-fix", "--device", "cpu", "--methods", "A,GT",
         "--model-path", "m.ckpt", "--epochs", "1"], "pipeline")
    assert (cfg, device, methods) == (None, "cpu", ["A", "GT"])
    assert vis == {"frames": [0, 5, 10], "with_fix": 1}
    assert rest == ["--pre_model_path", "m.ckpt", "--epochs", "1"]
    with pytest.raises(SystemExit, match="comma-separated ints"):
        cli._split_cli(["--frames", "a"], "vis")
    with pytest.raises(SystemExit, match="needs a value"):
        cli._split_cli(["--frames"], "vis")
    with pytest.raises(SystemExit, match="--methods is only valid"):
        cli.main(["train", "--methods", "A", "--device", "cpu"])
