"""Data-parallel serving on the CPU: three videos, `videos_per_batch=2`,
served by two gloo ranks through `cli test --dp_devices 2 --device cpu`,
at 64x128, T=5, batch_size 2 (clips of 10), f32.

The groups are (a, b) and (c): each rank serves one video of the first,
and rank 1's row of the ragged second is padding, so it writes nothing
there. Each rank serves its own videos alone (V=1 a rank, as the JAX
runner's `shard_map` runs each device's program on its shard), so the
maps equal one process serving with `videos_per_batch=1`, on one thread
as each rank runs, bit for bit (the CPU kernels' sums follow the thread
count: with two threads against one, 2 of 138,240 values moved a level),
and lie within one uint8 level of the JAX package's `test_videos` over a
two-device `data` mesh (an empty priors cache, ROADMAP C.2). Also:
`python -m iip_uavsal_saliency_tpu_torch test --device cpu --dp_devices 2`
writes the same files; `--dp_devices 2` with no card and no `--device cpu`
ends the run; `bake_params: false` serves within one level of the baked
step."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from iip_uavsal_saliency_tpu.data import matio as jmatio  # noqa: E402
from iip_uavsal_saliency_tpu.parallel.mesh import make_mesh  # noqa: E402
from iip_uavsal_saliency_tpu.runners import infer as jinfer  # noqa: E402
from iip_uavsal_saliency_tpu.training.checkpoint import save_checkpoint  # noqa: E402
from iip_uavsal_saliency_tpu_torch import cli  # noqa: E402
from iip_uavsal_saliency_tpu_torch.data import matio as tmatio  # noqa: E402
from test_torch_serving import _randomize  # noqa: E402
from test_torch_train_step import few_threads  # noqa: E402,F401

H, W, T, BATCH = 64, 128, 5, 2
IOSIZE = (H, W, H // 8, W // 8)
DATASET = "UAV2"
# name -> (frames, native height, width): a long video, a portrait one, a
# short one padded within its clip
VIDEOS = {"a": (23, 72, 96), "b": (12, 100, 60), "c": (7, 72, 96)}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
        f.write("\n".join(VIDEOS) + "\n")


def _read_dir(path):
    return {f[:-4]: tmatio.loadmat(os.path.join(path, f), "salmap")
            for f in sorted(os.listdir(path)) if f.endswith(".mat")}


def _flags(world, method, **kw):
    flags = {"data_dir": world["data_dir"], "train_dataset": DATASET, "test_dataset": DATASET,
             "iosize": ",".join(map(str, IOSIZE)), "time_dims": T, "test_batch_size": BATCH,
             "serve_bf16": "false", "method_name": method, "videos_per_batch": 1, **kw}
    argv = ["--pre_model_path", world["ckpt"]]
    for k, v in flags.items():
        argv += [f"--{k}", str(v)]
    return argv


def _results(world, method):
    return _read_dir(os.path.join(world["data_dir"], DATASET, "Results", f"Results_{method}",
                                  "Saliency", method))


@pytest.fixture(scope="module")
def world(uavsal_small, tmp_path_factory):
    """Seeded variables as a checkpoint, the dataset (the JAX run's copy
    apart, as the observed priors write into it), the JAX mesh run's maps,
    and the port's runs: one process at V=1, and two ranks in one spawn
    (each with an empty priors cache of its own)."""
    jmodel, variables, _ = uavsal_small
    variables = _randomize(jax.tree_util.tree_map(np.asarray, dict(variables)),
                           np.random.RandomState(1))
    base = tmp_path_factory.mktemp("dp_serve")
    data_dir, jax_root = str(base / "data"), str(base / "jax" / DATASET)
    _write_dataset(jax_root, np.random.RandomState(3))
    shutil.copytree(jax_root, os.path.join(data_dir, DATASET))
    ckpt = str(base / "m.ckpt")
    save_checkpoint(ckpt, {"params": variables["params"],
                           "batch_stats": variables["batch_stats"]})
    os.makedirs(base / "jax_priors")
    jinfer.test_videos(os.path.join(jax_root, "Videos"), str(base / "jax_out"), jmodel,
                       variables, iosize=IOSIZE, batch_size=BATCH, time_dims=T,
                       bias_type=(1, 1, 1), train_data_dir=jax_root, dataset=DATASET,
                       priors_cache_dir=str(base / "jax_priors"), method_name="JAX",
                       videos_per_batch=2, mesh=make_mesh(n_data=2, devices=jax.devices()[:2]))
    world = {"data_dir": data_dir, "ckpt": ckpt, "base": base,
             "jax": _read_dir(str(base / "jax_out" / "JAX"))}

    def cache(name):
        os.makedirs(base / name)
        return str(base / name)

    # one thread, as each rank has (`cli.py::_data_parallel` splits this
    # process's two; module docstring)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert cli.main(["test", "--device", "cpu",
                         *_flags(world, "One", priors_cache_dir=cache("c1"))]) == 0
    finally:
        torch.set_num_threads(threads)
    cfg = cli.load_config(None, _flags(world, "DP", videos_per_batch=2, dp_devices=2,
                                       priors_cache_dir=cache("c2")))
    world["written"] = cli.cmd_test(cfg, "cpu")
    return world


def test_two_ranks_serve_as_one_process(world):
    """Every file once, each by the rank that holds its video; the maps of
    one process at V=1, bit for bit."""
    one, dp = _results(world, "One"), _results(world, "DP")
    assert sorted(dp) == sorted(one) == sorted(VIDEOS)
    for name, maps in one.items():
        n, h, w = VIDEOS[name]
        assert maps.shape == (h, w, 1, n // T * T) and maps.std() > 1
        np.testing.assert_array_equal(dp[name], maps)
    rank0, rank1 = ([os.path.basename(p)[:-4] for p in w] for w in world["written"])
    assert rank0 == ["a", "c"] and rank1 == ["b"]  # rank 1's row of (c) is padding


def test_two_ranks_match_the_jax_mesh_run(world):
    dp = _results(world, "DP")
    assert sorted(world["jax"]) == sorted(dp)
    for name, want in world["jax"].items():
        got = dp[name]
        assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16)).max()
        assert diff <= 1, f"{name}: max uint8 diff {diff}"


def test_python_m_serves_the_same_files(world):
    """The package's `__main__`, the ranks on the CPU."""
    os.makedirs(world["base"] / "c3")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS=str(torch.get_num_threads()))  # the ranks' threads as above
    subprocess.run([sys.executable, "-m", "iip_uavsal_saliency_tpu_torch", "test", "--device",
                    "cpu", *_flags(world, "DPM", videos_per_batch=2, dp_devices=2,
                                   priors_cache_dir=str(world["base"] / "c3"))],
                   check=True, env=env, timeout=600, cwd=str(world["base"]))
    got, want = _results(world, "DPM"), _results(world, "DP")
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


def test_ranks_need_the_cards_or_the_cpu_asked_for(world):
    if torch.cuda.is_available() and torch.cuda.device_count() >= 2:
        pytest.skip("two cards are present")
    with pytest.raises(SystemExit, match="CUDA cards"):
        cli.main(["test", *_flags(world, "NoCard", videos_per_batch=2, dp_devices=2)])


def test_unbaked_step_serves_within_one_level(world):
    """`bake_params: false`: the argument-passing step."""
    os.makedirs(world["base"] / "c4")
    assert cli.main(["test", "--device", "cpu",
                     *_flags(world, "Args", bake_params="false",
                             priors_cache_dir=str(world["base"] / "c4"))]) == 0
    got, want = _results(world, "Args"), _results(world, "One")
    assert sorted(got) == sorted(want)
    for name in want:
        diff = np.abs(got[name].astype(np.int16) - want[name].astype(np.int16)).max()
        assert diff <= 1, f"{name}: max uint8 diff {diff}"
