"""`cli convert` of the port against the JAX package's on the CPU: a
reference `.pth` (a raw state_dict, or a pickled `nn.Module`, each with
BatchNorm's `num_batches_tracked` and torchvision's unused last MobileNetV2
conv `sfnet.features.features.18.*` beside the model's entries) to a
`.ckpt`, leaf for leaf and bit for bit, for the flagship, `bias_type`
(1, 0, 1), `uavsal_lstm` and `uavsal_stc3d`; ResNet-18, which the JAX
converter does not read (it reads a MobileNetV2 backbone whatever
`--cnn_type` says), against the tree the `.pth` was written from and the
JAX package's ResNet backbone converter; a missing entry named by both;
and `cli test --model-path` of a converted file against the model it
came from."""

import os
import re

import numpy as np
import pytest
import torch

from iip_uavsal_saliency_tpu import cli as jcli
from iip_uavsal_saliency_tpu.models.convert import convert_resnet_backbone
from iip_uavsal_saliency_tpu_torch import cli
from iip_uavsal_saliency_tpu_torch.data import matio as tmatio
from iip_uavsal_saliency_tpu_torch.models.adapters import build_adapted_model
from iip_uavsal_saliency_tpu_torch.models.convert import (load_torch_checkpoint,
                                                          reference_state_dict, table_of,
                                                          to_jax_variables)
from iip_uavsal_saliency_tpu_torch.runners import infer as tinfer
from iip_uavsal_saliency_tpu_torch.training.checkpoint import load_checkpoint
from test_torch_train_step import few_threads  # noqa: F401
from test_torch_runner import _write_dataset

# name -> the flags of both CLIs (the model each builds)
CASES = {
    "flagship": [],
    "bias_101": ["--bias_type", "1,0,1"],
    "uavsal_lstm": ["--model_name", "uavsal_lstm"],
    "uavsal_stc3d": ["--model_name", "uavsal_stc3d"],
}
FEATURES_18 = "sfnet.features.features.18."


class Tree(torch.nn.Module):
    """Stands in for the reference's pickled model: a module whose
    state_dict is `sd`, one child per dotted part of a key and a buffer per
    leaf."""

    def __init__(self, sd=None):
        super().__init__()
        for key, value in (sd or {}).items():
            node = self
            *parts, leaf = key.split(".")
            for part in parts:
                if part not in node._modules:
                    node.add_module(part, Tree())
                node = node._modules[part]
            node.register_buffer(leaf, value)


def _model(flags, cnn_type="mobilenet_v2"):
    kw = dict(zip(flags[::2], flags[1::2]))
    bias = tuple(int(b) for b in kw.get("--bias_type", "1,1,1").split(","))
    return build_adapted_model(kw.get("--model_name", "uavsal"), filter_kwargs=True,
                               cnn_type=cnn_type, num_stblock=2, bias_type=bias)


def _seeded(model, seed):
    """Seeded values for every entry of `model`'s state_dict (kernels of
    std 1/sqrt(fan_in), BatchNorm statistics of order 1)."""
    rng = np.random.RandomState(seed)
    sd = {}
    for key, ref in model.state_dict().items():
        if key.endswith("running_var") or (ref.dim() == 1 and key.endswith("weight")):
            a = rng.uniform(0.5, 1.5, ref.shape)
        elif ref.dim() == 1:
            a = rng.normal(0.0, 0.1, ref.shape)
        else:
            a = rng.normal(0.0, np.sqrt(1.0 / np.prod(ref.shape[1:])), ref.shape)
        sd[key] = torch.tensor(a, dtype=torch.float32)
    return sd


def _with_extras(sd):
    """What a released `.pth` holds beside the model's entries."""
    out = dict(sd)
    for key in sd:
        if key.endswith("running_mean"):
            out[key.replace("running_mean", "num_batches_tracked")] = torch.tensor(11)
    if any(k.startswith("sfnet.features.features.") for k in sd):  # a MobileNetV2 backbone
        out[FEATURES_18 + "0.weight"] = torch.full((1280, 320, 1, 1), 0.5)
        for name in ("weight", "bias", "running_mean", "running_var"):
            out[FEATURES_18 + "1." + name] = torch.ones(1280)
        out[FEATURES_18 + "1.num_batches_tracked"] = torch.tensor(11)
    else:  # torchvision ResNet's classifier, which the pyramid does not use
        out["sfnet.features.fc.weight"] = torch.ones(1000, 512)
    return out


def _write_pth(path, sd, form):
    torch.save(Tree(sd) if form == "module" else sd, path)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def assert_same_tree(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for key, a in want.items():
        assert got[key].dtype == a.dtype and got[key].shape == a.shape, key
        assert np.array_equal(got[key], a), key


@pytest.mark.parametrize("form", ["state_dict", "module"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_convert_matches_jax_cli(case, form, tmp_path):
    """The same `.pth` through both CLIs: the same `.ckpt` tree, bit for
    bit, which is also the tree of the model's own entries."""
    flags = CASES[case]
    model = _model(flags)
    sd = _seeded(model, len(case))
    pth = str(tmp_path / "ref.pth")
    _write_pth(pth, _with_extras(sd), form)
    assert cli.main(["convert", pth, str(tmp_path / "port.ckpt")] + flags) == 0
    assert jcli.main(["convert", pth, str(tmp_path / "jax.ckpt")] + flags) == 0
    got = load_checkpoint(str(tmp_path / "port.ckpt"))
    assert sorted(got) == ["batch_stats", "params"]
    assert_same_tree(got, load_checkpoint(str(tmp_path / "jax.ckpt")))
    assert_same_tree(got, to_jax_variables(sd, table_of(model)))


def test_convert_resnet18(tmp_path):
    """ResNet-18 (`--cnn_type resnet18`): the port's `.ckpt` is the tree the
    `.pth` was written from, its backbone the JAX package's ResNet
    converter's; the JAX `cli convert` reads a MobileNetV2 backbone
    whatever `--cnn_type` says, so it fails on the first MobileNetV2 key
    (ROADMAP C.1)."""
    model = _model([], "resnet18")
    sd = _seeded(model, 18)
    pth = str(tmp_path / "ref.pth")
    _write_pth(pth, _with_extras(sd), "module")
    flags = ["--cnn_type", "resnet18"]
    assert cli.main(["convert", pth, str(tmp_path / "port.ckpt")] + flags) == 0
    got = load_checkpoint(str(tmp_path / "port.ckpt"))
    assert_same_tree(got, to_jax_variables(sd, table_of(model)))
    numpy_sd = {k: v.numpy() for k, v in sd.items()}
    params, stats = convert_resnet_backbone(numpy_sd, "resnet18", prefix="sfnet.features.")
    assert_same_tree(got["params"]["trunk"]["sfnet"]["features"], params)
    assert_same_tree(got["batch_stats"]["trunk"]["sfnet"]["features"], stats)
    with pytest.raises(KeyError, match="sfnet.features.features.0.0.weight"):
        jcli.main(["convert", pth, str(tmp_path / "jax.ckpt")] + flags)


@pytest.mark.parametrize("missing", ["rnn.cell_list.0.rnn_conv.weight",
                                     "sfnet.features.features.3.conv.1.1.running_var"])
def test_convert_names_a_missing_entry(missing, tmp_path):
    """Both packages raise KeyError naming the entry the model needs and
    the file lacks; the port writes no file."""
    sd = _with_extras(_seeded(_model([]), 3))
    del sd[missing]
    pth = str(tmp_path / "ref.pth")
    _write_pth(pth, sd, "state_dict")
    with pytest.raises(KeyError, match=re.escape(missing)):
        cli.main(["convert", pth, str(tmp_path / "port.ckpt")])
    assert not os.path.exists(tmp_path / "port.ckpt")
    with pytest.raises(KeyError, match=re.escape(missing)):
        jcli.main(["convert", pth, str(tmp_path / "jax.ckpt")])


def test_convert_refuses_what_is_not_there(tmp_path):
    """A missing source and a wrong number of paths end the run with the
    JAX CLI's messages."""
    with pytest.raises(SystemExit, match="checkpoint not found: "):
        cli.main(["convert", str(tmp_path / "none.pth"), str(tmp_path / "out.ckpt")])
    with pytest.raises(SystemExit, match=re.escape("usage: convert <reference.pth>")):
        cli.main(["convert", str(tmp_path / "only_one.pth")])


def test_reader_takes_exactly_the_model_entries():
    """`reference_state_dict` keeps the table's entries in its order and
    leaves the rest out; `load_torch_checkpoint` gives numpy arrays of a
    raw state_dict and of a pickled module alike."""
    model = _model([])
    sd = _with_extras(_seeded(model, 5))
    taken = reference_state_dict(sd, table_of(model))
    assert list(taken) == [key for _, key, _ in table_of(model)]
    assert len(sd) - len(taken) == sum(k.endswith("num_batches_tracked") for k in sd) + 5


def test_load_torch_checkpoint_reads_both_forms(tmp_path):
    sd = {"a.weight": torch.arange(6.0).reshape(2, 3), "b.1.running_mean": torch.ones(4),
          "b.1.num_batches_tracked": torch.tensor(3)}
    for form in ("state_dict", "module"):
        path = str(tmp_path / f"{form}.pth")
        _write_pth(path, sd, form)
        got = load_torch_checkpoint(path)
        assert sorted(got) == sorted(sd)
        for key, value in sd.items():
            assert isinstance(got[key], np.ndarray)
            np.testing.assert_array_equal(got[key], value.numpy())


def test_cli_test_serves_a_converted_file_as_its_model(tmp_path):
    """`cli test --model-path` of a converted file writes the maps of the
    model it came from (`test_videos` on it), bit for bit (f32, 64x128)."""
    model = _model([])
    sd = _seeded(model, 7)
    pth, ckpt = str(tmp_path / "ref.pth"), str(tmp_path / "m.ckpt")
    _write_pth(pth, _with_extras(sd), "state_dict")
    assert cli.main(["convert", pth, ckpt]) == 0
    data = tmp_path / "data" / "UAV2"
    _write_dataset(str(data), np.random.RandomState(3))
    os.makedirs(tmp_path / "priors_cli")
    os.makedirs(tmp_path / "priors_direct")
    assert cli.main(["test", "--model-path", ckpt, "--data_dir", str(tmp_path / "data"),
                     "--train_dataset", "UAV2", "--test_dataset", "UAV2",
                     "--iosize", "64,128,8,16", "--test_batch_size", "2", "--serve_bf16",
                     "false", "--priors_cache_dir", str(tmp_path / "priors_cli"),
                     "--method_name", "CLI", "--device", "cpu"]) == 0
    source = tinfer.load_model_for_inference(to_jax_variables(sd, table_of(model)),
                                             device="cpu")
    tinfer.test_videos(str(data / "Videos"), str(tmp_path / "direct"), source,
                       iosize=(64, 128, 8, 16), batch_size=2, train_data_dir=str(data),
                       dataset="UAV2", priors_cache_dir=str(tmp_path / "priors_direct"))
    cli_dir = data / "Results" / "Results_CLI" / "Saliency" / "CLI"
    names = sorted(os.listdir(cli_dir))
    assert names == sorted(os.listdir(tmp_path / "direct")) and len(names) == 4
    for name in names:
        got = tmatio.loadmat(str(cli_dir / name), "salmap")
        np.testing.assert_array_equal(got, tmatio.loadmat(str(tmp_path / "direct" / name),
                                                          "salmap"))
        assert got.size == 0 or got.std() > 1
