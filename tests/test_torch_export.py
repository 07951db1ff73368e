"""The port's serving artifacts (`runners/export.py`) on the CPU at 64x128:
an f32 artifact against the live baked step bit for bit over 3 carried
clips, with and without the fused dwBlock, the custom-op nodes of K1 and
K2 in its graph, a bf16 artifact's state chained, a trace that leaves the
caches as they were, the loader's guards (through `cli test-aot` too), and
the port's `cli export` then `cli test-aot` against the JAX runner's
`.mat` files (`tests/test_torch_runner.py`'s world: its own priors from a
synthetic dataset, an empty priors cache each)."""

import json
import os
import shutil
import struct

import numpy as np
import pytest
import torch

from iip_uavsal_saliency_tpu.training.checkpoint import save_checkpoint
from iip_uavsal_saliency_tpu_torch import cli
from iip_uavsal_saliency_tpu_torch.ops import resize
from iip_uavsal_saliency_tpu_torch.runners import export as texport
from iip_uavsal_saliency_tpu_torch.runners import infer as tinfer
from iip_uavsal_saliency_tpu_torch.serving.steps import bake_model, make_baked_infer_step
from test_torch_runner import (BATCH, DATASET, H, IOSIZE, T, VIDEOS, W, _read_dir,  # noqa: F401
                               world)
from test_torch_train_step import few_threads  # noqa: F401

CLIPS = 3


def _priors(seed=2):
    rng = np.random.RandomState(seed)
    return (rng.rand(H // 8, W // 8, 8).astype(np.float32),
            rng.rand(H // 8, W // 8, 20).astype(np.float32))


def _clips(seed=30, v=1):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randint(0, 256, (v, BATCH * T, H, W, 3)).astype(np.uint8))
            for _ in range(CLIPS)]


def _artifact(variables, path, compute_dtype=None, fused=False):
    model = tinfer.load_model_for_inference(variables, time_dims=T, device="cpu",
                                            fused_dwblock=fused)
    g, o = _priors()
    program, meta = texport.export_serving(model, iosize=IOSIZE, batch_size=BATCH, time_dims=T,
                                           gauss=g, ob=o, compute_dtype=compute_dtype)
    texport.save_exported(path, program, meta)
    return texport.ExportedServing(path), program


@pytest.fixture(scope="module")
def artifacts(world, tmp_path_factory):
    """`get(compute_dtype, fused)`: the artifact of the world's weights
    with those settings, exported, saved and loaded once per module."""
    made = {}

    def get(compute_dtype=None, fused=False):
        if (compute_dtype, fused) not in made:
            path = str(tmp_path_factory.mktemp("aot") / "a.aot")
            made[compute_dtype, fused] = _artifact(world["variables"], path, compute_dtype, fused)
        return made[compute_dtype, fused]

    return get


def _live(variables, compute_dtype=None, fused=False):
    model = tinfer.load_model_for_inference(variables, time_dims=T, device="cpu",
                                            fused_dwblock=fused)
    return make_baked_infer_step(model, *_priors(), compute_dtype=compute_dtype)


def _custom_ops(program):
    return sorted({str(n.target) for n in program.graph.nodes
                   if str(n.target).startswith("uavsal")})


@pytest.mark.parametrize("fused", [False, True], ids=["k2_off", "k2_on"])
def test_f32_artifact_equals_the_live_step_bit_for_bit(world, artifacts, fused):
    """Saved, loaded and served over 3 carried clips: the live baked step's
    saliency and state, bit for bit; the graph holds K1's custom op, and
    K2's with the fused dwBlock on; the header is the JAX header's keys."""
    art, program = artifacts(fused=fused)
    want_ops = (["uavsal.dwblock.default"] if fused else []) + ["uavsal.twa_scan.default"]
    assert _custom_ops(program) == want_ops
    assert _custom_ops(art._module) == want_ops
    assert sorted(art.meta) == sorted(
        ["format_version", "iosize", "batch_size", "time_dims", "videos_per_batch", "bias_type",
         "compute_dtype", "x_shape", "state_shape", "state_dtype", "platforms", "torch_version"])
    assert art.meta["platforms"] == ["cpu"] and art.meta["state_dtype"] == "float32"
    live = _live(world["variables"], fused=fused)
    state = art.init_state(H, W, 1)
    live_state = state.clone()
    for x in _clips():
        got, state = art(x, state)
        want, live_state = live(x, live_state)
        assert got.dtype == torch.float32 and got.shape == (1, BATCH * T, H // 8, W // 8, 1)
        assert torch.equal(got, want) and torch.equal(state, live_state)
        assert got.std() > 1e-3


def test_bf16_artifact_chains_its_state(world, artifacts):
    """The state enters and leaves in bf16 and chains over 3 clips; the
    saliency is the live bf16 step's, bit for bit, on the CPU."""
    art, _ = artifacts(torch.bfloat16)
    assert art.meta["compute_dtype"] == art.meta["state_dtype"] == "bfloat16"
    live = _live(world["variables"], torch.bfloat16)
    state = art.init_state(H, W, 1)
    assert state.dtype == torch.bfloat16 and not state.any()
    live_state = state.clone()
    for x in _clips(40):
        before = state.clone()
        got, state = art(x, state)
        want, live_state = live(x, live_state)
        assert state.dtype == torch.bfloat16 and got.dtype == torch.float32
        assert torch.isfinite(got).all() and not torch.equal(state, before)
        assert torch.equal(got, want) and torch.equal(state, live_state)


def test_a_trace_leaves_the_model_serving_its_bits(world):
    """`torch.export` traces with fake tensors: ConvTWA's split and the
    interpolation matrices made while tracing are not cached, so the module
    serves the same bits eagerly afterwards. At 96x160, a size no other
    test uses, the matrices are made inside the trace."""
    model = tinfer.load_model_for_inference(world["variables"], time_dims=T, device="cpu")
    rng = np.random.RandomState(5)
    baked = bake_model(model, rng.rand(12, 20, 8).astype(np.float32),
                       rng.rand(12, 20, 20).astype(np.float32))
    x = torch.from_numpy(rng.randint(0, 256, (1, T, 96, 160, 3)).astype(np.uint8))
    state = model.init_state(96, 160, 1)
    cached = set(resize._MATRICES)
    with torch.no_grad():
        program = torch.export.export(baked, (x, state))
        assert set(resize._MATRICES) == cached
        first = baked(x, state)
        again = program.module()(x, state)
    assert all(type(t) is torch.Tensor for t in resize._MATRICES.values())
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    rnn = model.rnn
    assert type(rnn._split[0]) is torch.Tensor and type(rnn._split[1]) is torch.Tensor


def _write(path, data):
    with open(path, "wb") as f:
        f.write(data)
    return path


def _header(meta):
    body = json.dumps(meta).encode()
    return texport.MAGIC + struct.pack("<I", len(body)) + body


@pytest.mark.parametrize("case", ["jax", "garbage", "header", "program", "newer"])
def test_loader_refuses_what_it_cannot_serve(world, case, tmp_path):
    """A JAX artifact (StableHLO), bytes without the magic, a corrupt
    header, a program that does not load and a newer format_version: each
    refused with a message, by the loader (ValueError) and by `cli
    test-aot` (a SystemExit with the message, no traceback)."""
    good = _header({"format_version": 1, "platforms": ["cpu"]})
    data, message = {
        "jax": (b"UAVSALAOT1" + b"\0" * 64, "JAX StableHLO serving artifact"),
        "garbage": (os.urandom(256), "not a UAVSal PyTorch serving artifact"),
        "header": (texport.MAGIC + struct.pack("<I", 40) + b"{not json", "header is corrupt"),
        "program": (good + b"PK\x03\x04 not an archive", "program does not load"),
        "newer": (_header({"format_version": texport.FORMAT_VERSION + 1, "platforms": ["cpu"]}),
                  "is newer than this loader"),
    }[case]
    path = _write(str(tmp_path / "x.aot"), data)
    with pytest.raises(ValueError, match=message):
        texport.ExportedServing(path)
    with pytest.raises(SystemExit, match=message):
        cli.main(["test-aot", path, "--device", "cpu"])


def test_shapes_are_fixed(artifacts, tmp_path):
    """The artifact's state is fixed to its (H, W, V); another raises."""
    art, _ = artifacts()
    with pytest.raises(ValueError, match=r"fixed to \(H, W, V\)=\(64, 128, 1\)"):
        art.init_state(H, W, 2)
    with pytest.raises(ValueError, match="fixed to"):
        art.init_state(32, 64, 1)
    with pytest.raises(SystemExit, match="artifact not found"):
        cli.main(["test-aot", str(tmp_path / "none.aot")])


def test_a_cuda_artifact_needs_a_card(world, tmp_path, monkeypatch):
    """An artifact exported for cuda refuses to load where there is no
    card, before it reads the program."""
    path = _write(str(tmp_path / "x.aot"), _header({"format_version": 1,
                                                    "platforms": ["cuda"]}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="exported for cuda"):
        texport.ExportedServing(path)


@pytest.mark.parametrize("platforms,message", [
    ("tpu", "the port exports for cuda or cpu"),
    ("cuda", "is not the device the export runs on"),
])
def test_cli_export_refuses_other_platforms(world, platforms, message, tmp_path):
    ckpt = str(tmp_path / "m.ckpt")
    save_checkpoint(ckpt, {"params": world["variables"]["params"],
                           "batch_stats": world["variables"]["batch_stats"]})
    with pytest.raises(SystemExit, match=message):
        cli.main(["export", ckpt, str(tmp_path / "m.aot"), "--export_platforms", platforms,
                  "--device", "cpu"])


def test_cli_export_then_test_aot_matches_jax(world, tmp_path):
    """The port's `cli export` (f32, K2 off, the Gaussian prior and the
    dataset's observed prior inside, an empty priors cache) then `cli
    test-aot` over the dataset: the JAX runner's `.mat` files, every map
    within one uint8 level; resumable, as `test` is."""
    ckpt = str(tmp_path / "m.ckpt")
    save_checkpoint(ckpt, {"params": world["variables"]["params"],
                           "batch_stats": world["variables"]["batch_stats"]})
    data_dir = str(tmp_path / "data")
    shutil.copytree(world["port_root"], os.path.join(data_dir, DATASET),
                    ignore=shutil.ignore_patterns("priors"))
    os.makedirs(tmp_path / "priors")
    flags = ["--data_dir", data_dir, "--train_dataset", DATASET, "--test_dataset", DATASET,
             "--iosize", ",".join(map(str, IOSIZE)), "--time_dims", str(T),
             "--test_batch_size", str(BATCH), "--serve_bf16", "false",
             "--priors_cache_dir", str(tmp_path / "priors"), "--method_name", "AOT"]
    aot = str(tmp_path / "m.aot")
    assert cli.main(["export", ckpt, aot, "--export_platforms", "cpu", "--device", "cpu"]
                    + flags) == 0
    assert cli.main(["test-aot", aot] + flags) == 0
    out = os.path.join(data_dir, DATASET, "Results", "Results_AOT", "Saliency", "AOT")
    got, want = _read_dir(out), _read_dir(world["jax_out"])
    assert sorted(got) == sorted(want) == sorted(VIDEOS)
    for name, maps in got.items():
        assert maps.shape == want[name].shape and maps.dtype == np.uint8
        if maps.size:
            diff = np.abs(maps.astype(np.int16) - want[name].astype(np.int16))
            assert diff.max() <= 1, f"{name}: max uint8 diff {diff.max()}"
    stamp = os.path.getmtime(os.path.join(out, "a.mat"))
    assert cli.main(["test-aot", aot] + flags) == 0  # every .mat exists: nothing is served
    assert os.path.getmtime(os.path.join(out, "a.mat")) == stamp
