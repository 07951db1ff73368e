"""The port's video serving end to end against the JAX package on the CPU:
a directory of videos to `.mat` files at 64x128, T=5, f32.

One module-scoped JAX `test_videos` run (bias_type (1, 1, 1), its own
Gaussian and observed priors from the dataset, an empty priors cache)
writes the reference `.mat` files; the port's `test_videos` and `cli test`
are held to them within one uint8 level. Also: the observed priors, the
`.mat` files both ways, resumability, `save_frames`, short videos,
`videos_per_batch`, per-clip against whole-video postprocess, decode and
the host letterbox, the configuration and the lazy imports.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

from iip_uavsal_saliency_tpu.data import letterbox as jletterbox
from iip_uavsal_saliency_tpu.data import matio as jmatio
from iip_uavsal_saliency_tpu.data import priors as jpriors
from iip_uavsal_saliency_tpu.data import video as jvideo
from iip_uavsal_saliency_tpu.parallel.steps import _build_infer_fn
from iip_uavsal_saliency_tpu.runners import infer as jinfer
from iip_uavsal_saliency_tpu.training.checkpoint import save_checkpoint
from iip_uavsal_saliency_tpu.utils.config import Config as JConfig
from iip_uavsal_saliency_tpu_torch import cli
from iip_uavsal_saliency_tpu_torch.data import letterbox as tletterbox
from iip_uavsal_saliency_tpu_torch.data import matio as tmatio
from iip_uavsal_saliency_tpu_torch.data import priors as tpriors
from iip_uavsal_saliency_tpu_torch.data import video as tvideo
from iip_uavsal_saliency_tpu_torch.runners import infer as tinfer
from iip_uavsal_saliency_tpu_torch.serving.steps import GraphedStep, graph_step
from iip_uavsal_saliency_tpu_torch.utils.config import load_config
from test_torch_serving import _randomize
from test_torch_train_step import few_threads  # noqa: F401

H, W, T = 64, 128, 5
IOSIZE = (H, W, H // 8, W // 8)
BATCH = 2  # clips of S = 10 frames
DATASET = "UAV2"
# name -> (frames, native height, width): a long video, one padded within
# its first clip, one shorter than time_dims, and a portrait one (the other
# letterbox branch)
VIDEOS = {"a": (23, 72, 96), "b": (7, 72, 96), "c": (3, 72, 96), "d": (12, 100, 60)}
TRAIN = ["a", "b", "d"]


def _write_dataset(root, rng):
    """The reference layout: Videos/, maps/<v>_fixMaps.mat, txt/train.txt."""
    for d in ("Videos", "maps", "txt"):
        os.makedirs(os.path.join(root, d))
    for name, (n, h, w) in VIDEOS.items():
        wr = cv2.VideoWriter(os.path.join(root, "Videos", name + ".avi"),
                             cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (w, h))
        for _ in range(n):
            wr.write(rng.randint(0, 255, (h, w, 3), np.uint8))
        wr.release()
        fmap = np.zeros((h, w, 1, n), np.uint8)
        for t in range(n):
            blur = np.zeros((h, w), np.float32)
            blur[rng.randint(8, h - 8), rng.randint(8, w - 8)] = 255
            fmap[:, :, 0, t] = cv2.GaussianBlur(blur, (21, 21), 6).astype(np.uint8)
        jmatio.savemat(os.path.join(root, "maps", name + "_fixMaps.mat"), {"fixMap": fmap})
    with open(os.path.join(root, "txt", "train.txt"), "w") as f:
        f.write("\n".join(TRAIN) + "\n")


@pytest.fixture(scope="module")
def world(uavsal_small, tmp_path_factory):
    """Seeded variables, a JAX and a port copy of one dataset (the observed
    priors write PNGs into it), and the JAX `test_videos` .mat files."""
    jmodel, variables, _ = uavsal_small
    variables = _randomize(jax.tree_util.tree_map(np.asarray, dict(variables)),
                           np.random.RandomState(1))
    base = tmp_path_factory.mktemp("runner")
    jax_root, port_root = str(base / "jax" / DATASET), str(base / "port" / DATASET)
    _write_dataset(jax_root, np.random.RandomState(3))
    shutil.copytree(jax_root, port_root)
    jstep = jax.jit(_build_infer_fn(jmodel))
    params, stats = variables["params"], variables["batch_stats"]
    out = str(base / "jax_out")
    cache = str(base / "jax_priors")
    os.makedirs(cache)
    jinfer.test_videos(os.path.join(jax_root, "Videos"), out, jmodel, variables, iosize=IOSIZE,
                       batch_size=BATCH, time_dims=T, bias_type=(1, 1, 1),
                       train_data_dir=jax_root, dataset=DATASET, priors_cache_dir=cache,
                       method_name="JAX",
                       infer_step=lambda p, b, x, gg, oo, st: jstep(params, stats, x, gg, oo, st))
    return {"variables": variables, "jax_root": jax_root, "port_root": port_root,
            "jax_out": os.path.join(out, "JAX"), "jax_cache": cache, "base": base}


def _port_run(world, out, **kw):
    """The port's test_videos, f32 on the CPU, over the port's copy of the
    dataset, with an empty priors cache of its own. Returns {name: salmap}."""
    cache = out + "_priors"
    os.makedirs(cache)
    model = tinfer.load_model_for_inference(world["variables"], time_dims=T, device="cpu")
    kw.setdefault("method_name", "Port")
    tinfer.test_videos(os.path.join(world["port_root"], "Videos"), out, model, iosize=IOSIZE,
                       batch_size=BATCH, time_dims=T, train_data_dir=world["port_root"],
                       dataset=DATASET, priors_cache_dir=cache, **kw)
    return _read_dir(os.path.join(out, kw["method_name"]))


def _read_dir(path):
    return {f[:-4]: tmatio.loadmat(os.path.join(path, f), "salmap")
            for f in sorted(os.listdir(path)) if f.endswith(".mat")}


@pytest.fixture(scope="module")
def port_maps(world):
    return _port_run(world, str(world["base"] / "port_out"))


def _expected_frames(name):
    return (VIDEOS[name][0] // T) * T


def test_test_videos_matches_jax(world, port_maps):
    """Port and JAX `test_videos`, each with its own priors: the same files,
    the same shapes, every map within one uint8 level."""
    want = _read_dir(world["jax_out"])
    assert sorted(port_maps) == sorted(want) == sorted(VIDEOS)
    for name, got in port_maps.items():
        _, h, w = VIDEOS[name]
        assert got.shape == want[name].shape == (h, w, 1, _expected_frames(name))
        assert got.dtype == want[name].dtype == np.uint8
        if got.size:
            diff = np.abs(got.astype(np.int16) - want[name].astype(np.int16))
            assert diff.max() <= 1, f"{name}: max uint8 diff {diff.max()}"
            assert got.std() > 1, f"{name}: the maps have no structure to compare"


@pytest.mark.parametrize("phase_gen", ["train", "train_val"])
def test_get_ob_priors_matches_jax(world, tmp_path, phase_gen):
    """Built from separate copies of the dataset into separate caches; each
    package then serves the other's cache file."""
    roots = {}
    for who in ("jax", "port"):
        roots[who] = str(tmp_path / who / DATASET)
        shutil.copytree(world["port_root"], roots[who], ignore=shutil.ignore_patterns("priors"))
        with open(os.path.join(roots[who], "txt", "val.txt"), "w") as f:
            f.write("d\n")
        os.makedirs(tmp_path / f"{who}_cache")
    want = jpriors.get_ob_priors(roots["jax"], DATASET, phase_gen, H // 8, W // 8, 20,
                                 str(tmp_path / "jax_cache"))
    got = tpriors.get_ob_priors(roots["port"], DATASET, phase_gen, H // 8, W // 8, 20,
                                str(tmp_path / "port_cache"))
    assert got.shape == want.shape == (H // 8, W // 8, 20) and got.dtype == np.float32
    assert want.max() > 0.5
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # each package on the other's cache, and at another size (letterboxed)
    np.testing.assert_allclose(
        tpriors.get_ob_priors("", DATASET, phase_gen, H // 8, W // 8, 20,
                              str(tmp_path / "jax_cache")), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        jpriors.get_ob_priors("", DATASET, phase_gen, H // 8, W // 8, 20,
                              str(tmp_path / "port_cache")), got, atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        tpriors.get_ob_priors("", DATASET, phase_gen, 12, 12, 20, str(tmp_path / "port_cache")),
        jpriors.get_ob_priors("", DATASET, phase_gen, 12, 12, 20, str(tmp_path / "jax_cache")),
        atol=1e-6, rtol=0)


@pytest.mark.parametrize("trained", [TRAIN[:1], TRAIN * 9])  # fewer and more videos than channels
def test_get_ob_priors_channel_folding_matches_jax(world, tmp_path, trained):
    roots = {}
    for who in ("jax", "port"):
        roots[who] = str(tmp_path / who)
        shutil.copytree(world["port_root"], roots[who], ignore=shutil.ignore_patterns("priors"))
        with open(os.path.join(roots[who], "txt", "train.txt"), "w") as f:
            f.write("\n".join(trained) + "\n")
    want = jpriors.get_ob_priors(roots["jax"], DATASET, "train", H // 8, W // 8, 20, roots["jax"])
    got = tpriors.get_ob_priors(roots["port"], DATASET, "train", H // 8, W // 8, 20,
                                roots["port"])
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_get_ob_priors_raises_like_jax(tmp_path):
    os.makedirs(tmp_path / "txt")
    with pytest.raises(FileNotFoundError):  # no training split
        tpriors.get_ob_priors(str(tmp_path), DATASET, cache_dir=str(tmp_path))
    (tmp_path / "txt" / "train.txt").write_text("\n")
    with pytest.raises(ValueError, match="empty train split"):
        tpriors.get_ob_priors(str(tmp_path), DATASET, cache_dir=str(tmp_path))
    with pytest.raises(NotImplementedError):
        tpriors.get_ob_priors(str(tmp_path), DATASET, "test", cache_dir=str(tmp_path))


def _mat_contents(rng):
    return {"salmap": rng.randint(0, 256, (30, 40, 1, 7)).astype(np.uint8),  # gzip: >= 16 KiB
            "small": rng.rand(3, 4).astype(np.float32),
            "vec": np.arange(5, dtype=np.int32),
            "mask": rng.rand(2, 3) > 0.5,
            "scores": {"v1": rng.rand(4, 7), "v2": rng.rand(2, 7)}}


@pytest.mark.parametrize("writer,reader", [(tmatio, jmatio), (jmatio, tmatio), (tmatio, tmatio)],
                         ids=["port_to_jax", "jax_to_port", "port_to_port"])
def test_mat_round_trips_between_packages(tmp_path, writer, reader):
    data = _mat_contents(np.random.RandomState(7))
    path = str(tmp_path / "x.mat")
    writer.savemat(path, data)
    with open(path, "rb") as f:
        assert f.read(10) == b"MATLAB 7.3"
    got = reader.loadmat(path)
    assert sorted(got) == sorted(data)
    for key in ("salmap", "small", "vec"):
        np.testing.assert_array_equal(got[key], data[key])
        assert got[key].dtype == data[key].dtype
    np.testing.assert_array_equal(got["mask"].astype(bool), data["mask"])
    for k, v in data["scores"].items():
        np.testing.assert_array_equal(got["scores"][k], v)
    np.testing.assert_array_equal(reader.loadmat(path, "salmap"), data["salmap"])


def test_loadmat_reads_v5_files(tmp_path):
    import scipy.io

    arr = np.random.RandomState(8).rand(5, 6)
    scipy.io.savemat(str(tmp_path / "v5.mat"), {"I": arr})
    np.testing.assert_array_equal(tmatio.loadmat(str(tmp_path / "v5.mat"), "I"), arr)
    assert list(tmatio.loadmat(str(tmp_path / "v5.mat"))) == ["I"]


def test_resume_save_frames_and_short_videos(world, port_maps, tmp_path):
    """A video whose .mat exists is skipped; `save_frames` keeps the first
    frames of the full run; a video shorter than time_dims gets (H, W, 1, 0)."""
    out = str(tmp_path / "out")
    os.makedirs(os.path.join(out, "Port"))
    sentinel = {"salmap": np.full((2, 2, 1, 1), 7, np.uint8)}
    tmatio.savemat(os.path.join(out, "Port", "a.mat"), sentinel)
    got = _port_run(world, out, save_frames=10)
    np.testing.assert_array_equal(got["a"], sentinel["salmap"])  # not served again
    assert got["c"].shape == (72, 96, 1, 0)
    for name in ("b", "d"):
        keep = min(10, _expected_frames(name))
        assert got[name].shape[3] == keep
        np.testing.assert_array_equal(got[name], port_maps[name][:, :, :, :keep])


@pytest.fixture(scope="module")
def port_maps_v2(world):
    """V=2 in lock-step, 4 videos in 2 groups: a ragged pair (23 and 7
    frames) and a pair whose first video has no clip at all."""
    return _port_run(world, str(world["base"] / "port_out_v2"), videos_per_batch=2)


def test_videos_per_batch_gives_the_same_files(world, port_maps, port_maps_v2):
    """Within one uint8 level of V=1: the model is not quite the same
    function at V=1, where MultiPriors tiles the context t-major as the
    reference does (`compat_cxt_tile`), and the convolutions batch V*S
    frames (observed: 3% of the values one level apart, none more)."""
    assert sorted(port_maps_v2) == sorted(port_maps)
    for name, maps in port_maps_v2.items():
        assert maps.shape == port_maps[name].shape
        diff = np.abs(maps.astype(np.int16) - port_maps[name].astype(np.int16))
        assert diff.max(initial=0) <= 1, f"{name}: max uint8 diff {diff.max()}"


def test_videos_per_batch_pads_the_final_group(world, port_maps_v2, tmp_path, monkeypatch):
    """Three videos at V=2: the last group has one video and an empty slot.
    Each video's maps do not depend on the other slot: the bits of the
    4-video run."""
    shutil.copytree(os.path.join(world["port_root"], "Videos"), tmp_path / "Videos",
                    ignore=shutil.ignore_patterns("c.avi"))
    model = tinfer.load_model_for_inference(world["variables"], time_dims=T, device="cpu")
    seen = []
    make = tinfer.make_baked_infer_step

    def spying_step(*args, **kw):
        step = make(*args, **kw)

        def spy(x, state):
            seen.append(tuple(x.shape))
            return step(x, state)
        return spy

    os.makedirs(tmp_path / "cache")
    monkeypatch.setattr(tinfer, "make_baked_infer_step", spying_step)
    tinfer.test_videos(str(tmp_path / "Videos"), str(tmp_path / "out"), model, iosize=IOSIZE,
                       batch_size=BATCH, time_dims=T, train_data_dir=world["port_root"],
                       dataset=DATASET, priors_cache_dir=str(tmp_path / "cache"),
                       videos_per_batch=2)
    assert set(seen) == {(2, BATCH * T, H, W, 3)}
    got = _read_dir(str(tmp_path / "out"))
    assert sorted(got) == ["a", "b", "d"]
    for name, maps in got.items():
        np.testing.assert_array_equal(maps, port_maps_v2[name])


@pytest.mark.parametrize("native", [(72, 96), (100, 60), (540, 960)])
def test_postprocess_per_clip_equals_whole_video(native):
    sal = torch.from_numpy(np.random.RandomState(native[0]).rand(23, H // 8, W // 8)
                           .astype(np.float32))
    whole = tletterbox.im2uint8(tletterbox.postprocess_prediction(sal, *native))
    clips = torch.cat([tletterbox.im2uint8(tletterbox.postprocess_prediction(sal[s:s + 10],
                                                                           *native))
                       for s in range(0, 23, 10)])
    assert torch.equal(clips, whole)


def test_cli_test_matches_test_videos(world, port_maps, tmp_path):
    """`cli.main(["test", ...])` on a checkpoint the JAX package wrote gives
    the files of a direct `test_videos` call."""
    ckpt = str(tmp_path / "m.ckpt")
    save_checkpoint(ckpt, {"params": world["variables"]["params"],
                           "batch_stats": world["variables"]["batch_stats"]})
    data_dir = str(tmp_path / "data")
    shutil.copytree(world["port_root"], os.path.join(data_dir, DATASET),
                    ignore=shutil.ignore_patterns("priors"))
    cfg = {"data_dir": data_dir, "train_dataset": DATASET, "test_dataset": DATASET,
           "iosize": list(IOSIZE), "time_dims": T, "test_batch_size": BATCH,
           "serve_bf16": False, "priors_cache_dir": str(tmp_path), "method_name": "CLI"}
    with open(tmp_path / "cfg.json", "w") as f:
        json.dump(cfg, f)
    assert cli.main(["test", "--config", str(tmp_path / "cfg.json"), "--model-path", ckpt,
                     "--device", "cpu"]) == 0
    got = _read_dir(os.path.join(data_dir, DATASET, "Results", "Results_CLI", "Saliency", "CLI"))
    assert sorted(got) == sorted(port_maps)
    for name, maps in got.items():
        np.testing.assert_array_equal(maps, port_maps[name])


@pytest.mark.parametrize("flag,value", [("model_name", "uavsal_srf"), ("st_type", "s2t"),
                                        ("dp_devices", "2")])
def test_cli_refuses_what_the_port_does_not_have(flag, value, world, port_maps, tmp_path):
    """What the JAX CLI does with each: a `model_name` outside `MODEL_ZOO`
    raises KeyError before any file is read; `st_type` on `uavsal` is
    accepted and ignored (the files of the run without it, bit for bit);
    `dp_devices` above 1 runs its ranks on the cards unless `--device cpu`
    is given (`test_torch_dp_serve.py` serves that way), so without as
    many cards the run ends before any rank starts, as the JAX CLI's
    check of the devices it sees ends it."""
    if flag == "model_name":
        with pytest.raises(KeyError, match=value):
            cli.main(["test", f"--{flag}", value, "--device", "cpu"])
    elif flag == "st_type":
        ckpt = str(tmp_path / "m.ckpt")
        save_checkpoint(ckpt, {"params": world["variables"]["params"],
                               "batch_stats": world["variables"]["batch_stats"]})
        data_dir = str(tmp_path / "data")
        shutil.copytree(world["port_root"], os.path.join(data_dir, DATASET),
                        ignore=shutil.ignore_patterns("priors"))
        assert cli.main(["test", "--data_dir", data_dir, "--train_dataset", DATASET,
                         "--test_dataset", DATASET, "--iosize", ",".join(map(str, IOSIZE)),
                         "--time_dims", str(T), "--test_batch_size", str(BATCH),
                         "--serve_bf16", "false", "--priors_cache_dir", str(tmp_path),
                         "--method_name", "ST", "--model-path", ckpt, f"--{flag}", value,
                         "--device", "cpu"]) == 0
        got = _read_dir(os.path.join(data_dir, DATASET, "Results", "Results_ST", "Saliency",
                                     "ST"))
        assert sorted(got) == sorted(port_maps)
        for name, maps in got.items():
            np.testing.assert_array_equal(maps, port_maps[name])
    else:
        if torch.cuda.is_available() and torch.cuda.device_count() >= int(value):
            pytest.skip("enough cards are present")
        with pytest.raises(SystemExit, match="CUDA cards"):
            cli.main(["test", f"--{flag}", value])


def test_cli_only_registers_test():
    """`test`, `train` (the training slice), `eval`, `eval-img` (the
    evaluation slice), `modelsize`, `train-img`, `vis` and `pipeline` (the
    recipe slice), and `convert`, `export` and `test-aot` (the deployment
    slice): every command of the JAX CLI, none refused. A path command
    without its paths ends with its usage, as in the JAX CLI."""
    assert set(cli.COMMANDS) == {"train", "train-img", "test", "eval", "eval-img", "vis",
                                 "pipeline", "modelsize", "convert", "export", "test-aot"}
    assert cli.NOT_PORTED == {}
    with pytest.raises(SystemExit, match="usage: convert <reference.pth> <out.ckpt>"):
        cli.main(["convert"])
    assert cli.main(["--help"]) == 0


def test_jax_config_json_loads_unchanged(tmp_path):
    data = dataclasses.asdict(JConfig())
    data.update(iosize=[64, 128, 8, 16], method_name="X", serve_bf16=False)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(data))
    cfg = load_config(str(path), ["--time_dims", "4", "--device_auc", "auto"])
    for key, value in data.items():
        want = {"time_dims": 4, "device_auc": None}.get(key, value)
        assert getattr(cfg, key) == (tuple(want) if isinstance(want, list) else want), key
    assert cfg.test_output_path == os.path.join(cfg.data_dir, "UAV2-TE", "Results",
                                                "Results_X", "Saliency")
    with pytest.raises(SystemExit, match="unknown flag"):
        load_config(None, ["--nope", "1"])


@pytest.mark.parametrize("mode", ["RGB", "BGR"])
@pytest.mark.parametrize("normalize", [False, True])
def test_preprocess_videos_matches_jax(world, mode, normalize):
    path = os.path.join(world["port_root"], "Videos", "d.avi")
    got = tvideo.preprocess_videos(path, H, W, mode=mode, normalize=normalize)
    want = jvideo.preprocess_videos(path, H, W, mode=mode, normalize=normalize)
    assert got[1:] == want[1:] == (12, 100, 60)
    assert got[0].dtype == want[0].dtype
    np.testing.assert_array_equal(got[0], want[0])
    frames, n, h, w = tvideo.decode_video(path, max_frames=5)
    np.testing.assert_array_equal(frames, jvideo.decode_video(path, max_frames=5)[0])
    assert (n, h, w) == (5, 100, 60)


class _FakeCapture:
    """`cv2.VideoCapture` with a header count that may lie."""

    def __init__(self, n, header):
        self.n, self.header, self.i = n, header, 0

    def get(self, prop):
        return self.header

    def read(self):
        if self.i >= self.n:
            return False, None
        self.i += 1
        return True, np.full((2, 3, 3), self.i, np.uint8)


@pytest.mark.parametrize("n,header,cap", [(10, 10, float("inf")), (40, 3, float("inf")),
                                          (5, 50, float("inf")), (0, 4, float("inf")),
                                          (30, 0, 7)])
def test_read_frames_matches_jax(n, header, cap):
    got, got_n = tvideo._read_frames(_FakeCapture(n, header), cap, lambda f: f)
    want, want_n = jvideo._read_frames(_FakeCapture(n, header), cap, lambda f: f)
    assert got_n == want_n
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,dtype,channels", [((72, 96, 3), np.uint8, 3),
                                                  ((100, 60, 3), np.uint8, 3),
                                                  ((45, 80), np.uint8, 1),
                                                  ((30, 30), np.float32, 1)])
def test_padding_matches_jax(shape, dtype, channels):
    img = (np.random.RandomState(9).rand(*shape) * 255).astype(dtype)
    got = tletterbox.padding(img, H // 2, W // 2, channels)
    want = jletterbox.padding(img, H // 2, W // 2, channels)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_graph_step_is_the_eager_step_on_the_cpu():
    calls = []

    def step(x, state):
        calls.append(x.device)
        return x.float() * 2, state + 1

    graphed = graph_step(step)
    assert isinstance(graphed, GraphedStep) and graph_step(graphed) is graphed
    x, state = torch.ones(2, 3, dtype=torch.uint8), torch.zeros(2)
    out, new_state = graphed(x, state)
    assert calls == [torch.device("cpu")]
    assert torch.equal(out, torch.full((2, 3), 2.0)) and torch.equal(new_state, torch.ones(2))


def test_decode_and_mat_modules_import_cv2_and_h5py_lazily():
    """Importing every module of the port loads neither cv2 nor h5py: the
    card's machine has neither."""
    probe = ("import importlib, pkgutil, sys\n"
             "import iip_uavsal_saliency_tpu_torch as port\n"
             "for m in pkgutil.walk_packages(port.__path__, port.__name__ + '.'):\n"
             "    importlib.import_module(m.name)\n"
             "print(sorted(m for m in ('cv2', 'h5py', 'msgpack') if m in sys.modules))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    out = subprocess.run([sys.executable, "-c", probe], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
