"""The image stage against the JAX package on the CPU at 64x64 (`IOSIZE`,
as `tests/test_images.py`): the SALICON data (lists, examples, batches and
their order, and the array entry, bit for bit), `SRFNetImage`'s eval
forward (within 2e-5, the port's f32 parity target) and its weight bridge
(exact both ways), `is_image_stage_variables`, `transfer_sfnet` (exact,
into UAVSal and into a zoo model that inlines its neck) and the image
runner's PNGs (within one uint8 level of the JAX `test_images`).

The JAX model runs un-jitted from a tree whose structure comes from
`jax.eval_shape` (no initializer and no compile of the whole graph), as
`tests/test_torch_zoo_models.py` builds its trees; the JAX `test_images`
jits its own step once."""

import os
import shutil

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from iip_uavsal_saliency_tpu.data import images as jimages
from iip_uavsal_saliency_tpu.models import SRFNetImage as JSRFNetImage
from iip_uavsal_saliency_tpu.models import UAVSal as JUAVSal
from iip_uavsal_saliency_tpu.models import UAVSalSpConv as JUAVSalSpConv
from iip_uavsal_saliency_tpu.models import is_image_stage_variables as j_is_image
from iip_uavsal_saliency_tpu.models import transfer_sfnet as j_transfer
from iip_uavsal_saliency_tpu.runners import infer_images as jinfer_images
from iip_uavsal_saliency_tpu_torch.data import images as timages
from iip_uavsal_saliency_tpu_torch.models.convert import (from_jax_variables, table_for,
                                                          table_of, to_jax_variables)
from iip_uavsal_saliency_tpu_torch.models.srfnet_image import (SRFNetImage,
                                                               is_image_stage_variables,
                                                               transfer_sfnet)
from iip_uavsal_saliency_tpu_torch.models.uavsal import init_model
from iip_uavsal_saliency_tpu_torch.runners import infer_images as tinfer_images
from iip_uavsal_saliency_tpu_torch.training.steps import _maybe_normalize
from test_torch_train_step import few_threads, randomized  # noqa: F401

IOSIZE = (64, 64, 8, 8)
NATIVE = (32, 48)
ATOL = 2e-5


def write_salicon(root, counts=(("train", 5), ("val", 3)), native=NATIVE, seed=0):
    """A SALICON-layout dataset: RGB JPEGs, blurred gaze maps peaking at 255
    around 4 fixations per image, and the fixations as v5 `.mat` files
    (key "I")."""
    rng = np.random.RandomState(seed)
    h, w = native
    for classes, n in counts:
        base = os.path.join(root, classes)
        for d in ("images", "maps", os.path.join("fixations", "maps")):
            os.makedirs(os.path.join(base, d), exist_ok=True)
        for i in range(n):
            name = f"img_{i:03d}"
            cv2.imwrite(os.path.join(base, "images", name + ".jpg"),
                        rng.randint(0, 255, (h, w, 3), np.uint8))
            fix = np.zeros((h, w), np.uint8)
            for _ in range(4):
                fix[rng.randint(2, h - 2), rng.randint(2, w - 2)] = 1
            blur = cv2.GaussianBlur(fix.astype(np.float32), (0, 0), max(h, w) / 12)
            cv2.imwrite(os.path.join(base, "maps", name + ".png"),
                        np.rint(blur / blur.max() * 255).astype(np.uint8))
            scipy.io.savemat(os.path.join(base, "fixations", "maps", name + ".mat"), {"I": fix})
    return str(root)


def zeros_tree(model, *args):
    """The JAX model's variable tree, all zeros, from `jax.eval_shape`."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))


def image_tree(seed=0):
    """A seeded JAX `SRFNetImage` tree at IOSIZE."""
    zeros = zeros_tree(JSRFNetImage(), jnp.zeros((1, IOSIZE[0], IOSIZE[1], 3)))
    return randomized(zeros, np.random.RandomState(seed))


@pytest.fixture(scope="module")
def salicon(tmp_path_factory):
    return write_salicon(tmp_path_factory.mktemp("salicon"))


@pytest.fixture(scope="module")
def tree():
    return image_tree()


@pytest.fixture(scope="module")
def video_trees():
    """Seeded JAX trees of UAVSal (its neck at trunk/sfnet) and of
    UAVSalSpConv (its neck inlined at the top), 64x64, S=5."""
    x = jnp.zeros((1, 5, 64, 64, 3))
    g, o = np.zeros((8, 8, 8), np.float32), np.zeros((8, 8, 20), np.float32)
    uavsal = zeros_tree(JUAVSal(time_dims=5), x, g, o, jnp.zeros((1, 8, 8, 256)))
    spconv = zeros_tree(JUAVSalSpConv(), x[0])
    return {name: randomized(t, np.random.RandomState(i + 1))
            for i, (name, t) in enumerate((("uavsal", uavsal), ("uavsal_spconv", spconv)))}


def test_file_lists_and_examples_equal_jax(salicon):
    for classes in ("train", "val"):
        lists = timages.salicon_file_lists(salicon, classes)
        assert lists == jimages.salicon_file_lists(salicon, classes)
        assert [len(x) for x in lists] == [5 if classes == "train" else 3] * 3
        for paths in zip(*lists):
            for normalize in (True, False):
                got = timages.load_salicon_example(*paths, IOSIZE, normalize=normalize)
                want = jimages.load_salicon_example(*paths, IOSIZE, normalize=normalize)
                for a, b in zip(got, want):
                    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
                    np.testing.assert_array_equal(a, b)
    x, y = timages.load_salicon_example(*[p[0] for p in lists], IOSIZE)
    assert x.shape == (64, 64, 3) and y.shape == (8, 8, 2) and y[..., 1].sum() >= 1
    img_only = timages.load_salicon_example(lists[0][0], None, None, IOSIZE)
    assert img_only[1] is None
    np.testing.assert_array_equal(img_only[0], x)


@pytest.mark.parametrize("classes,shuffle,drop_last", [("train", None, False),
                                                       ("train", None, True),
                                                       ("val", None, False),
                                                       ("train", False, True)])
def test_batches_and_their_order_equal_jax(salicon, classes, shuffle, drop_last):
    """The same batches in the same order for one RandomState seed, and the
    RandomState itself left in the same place."""
    kw = dict(batch_size=2, shuffle=shuffle, drop_last=drop_last)
    r_t, r_j = np.random.RandomState(7), np.random.RandomState(7)
    got = list(timages.salicon_batches(salicon, classes, IOSIZE, rng=r_t, **kw))
    want = list(jimages.salicon_batches(salicon, classes, IOSIZE, rng=r_j, **kw))
    assert len(got) == len(want) > 0
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    assert r_t.randint(1 << 30) == r_j.randint(1 << 30)


def test_array_entry_gives_the_file_entry_batches(salicon):
    """uint8 images decoded and resized as the file entry resizes them, and
    the file entry's targets, batched by `salicon_array_batches` for the
    same draw and normalized as the train step normalizes them: the file
    entry's batches, bit for bit."""
    imgs, maps, fixs = timages.salicon_file_lists(salicon, "train")
    images = np.stack([cv2.resize(cv2.imread(p)[:, :, ::-1], (IOSIZE[1], IOSIZE[0]),
                                  interpolation=cv2.INTER_LINEAR) for p in imgs])
    targets = np.stack([timages.load_salicon_example(*t, IOSIZE)[1]
                        for t in zip(imgs, maps, fixs)])
    for drop_last in (False, True):
        got = list(timages.salicon_array_batches(images, targets, 2, shuffle=True,
                                                 drop_last=drop_last,
                                                 rng=np.random.RandomState(3)))
        want = list(jimages.salicon_batches(salicon, "train", IOSIZE, 2, drop_last=drop_last,
                                            rng=np.random.RandomState(3)))
        assert len(got) == len(want) == (2 if drop_last else 3)
        for (gx, gy), (wx, wy) in zip(got, want):
            assert gx.dtype == np.uint8
            np.testing.assert_array_equal(_maybe_normalize(torch.from_numpy(gx)).numpy(), wx)
            np.testing.assert_array_equal(gy, wy)
    with pytest.raises(ValueError, match="mismatched"):
        next(timages.salicon_array_batches(images, targets[:-1]))


def test_mismatched_lists_raise(salicon, tmp_path):
    root = str(tmp_path / "s")
    shutil.copytree(salicon, root)
    os.remove(os.path.join(root, "train", "maps", "img_001.png"))
    with pytest.raises(ValueError, match="mismatched SALICON lists"):
        next(timages.salicon_batches(root, "train", IOSIZE))


def test_srfnet_image_forward_matches_jax(tree):
    """Eval form from one JAX-layout tree through the bridge, within 2e-5;
    the (B, H, W, 3) input and its channels-last NCHW view alike."""
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    want = np.asarray(JSRFNetImage().apply(tree, jnp.asarray(x)))
    model = SRFNetImage()
    model.load_state_dict(from_jax_variables(tree, table_of(model)), strict=True)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        nchw = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, 8, 8, 1)
    assert np.abs(got - want).max() <= ATOL, np.abs(got - want).max()
    np.testing.assert_array_equal(nchw, got)


def test_bridge_round_trips_the_image_tree_exactly(tree):
    model = SRFNetImage()
    table = table_of(model)
    assert table == table_for(model_name="srfnet_image")
    sd = from_jax_variables(tree, table)
    assert set(sd) == set(model.state_dict())
    back = to_jax_variables(sd, table)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert len(jax.tree_util.tree_leaves(back)) == len(leaves)
    for path, leaf in leaves:
        node = back
        for k in path:
            node = node[k.key]
        assert node.dtype == leaf.dtype and np.array_equal(node, leaf), path
    with pytest.raises(ValueError, match="not the table's configuration"):
        from_jax_variables(tree, table_for())


def test_init_model_draws_the_image_stage_as_jax(tree):
    """The backbone kaiming fan_in, the neck and conv_out fan_out (their std
    within 5% of sqrt(2 / fan)), BatchNorm at the identity."""
    model = init_model(SRFNetImage(), torch.Generator().manual_seed(0))
    sd = model.state_dict()
    for key, fan in (("sfnet.features.features.17.conv.0.0.weight", 160),
                     ("sfnet.conv_last.0.weight", 256 * 9), ("conv_out.conv.0.0.weight", 1536)):
        want = np.sqrt(2.0 / fan)
        assert abs(sd[key].std().item() - want) <= 0.05 * want, key
    assert torch.all(sd["conv_out.conv.3.running_var"] == 1)
    assert torch.all(sd["sfnet.conv_last.1.weight"] == 1)


def test_is_image_stage_variables_as_jax(tree, video_trees):
    cases = {"image": tree, **video_trees}
    for name, t in cases.items():
        assert is_image_stage_variables(t) == j_is_image(t) == (name == "image"), name
    assert not is_image_stage_variables({"batch_stats": {}})


@pytest.mark.parametrize("name", ["uavsal", "uavsal_spconv"])
def test_transfer_sfnet_equals_jax(tree, video_trees, name):
    """Into UAVSal's trunk/sfnet and into UAVSalSpConv's top-level sfnet:
    the JAX function's tree exactly, nothing else changed, the inputs not
    changed."""
    video = video_trees[name]
    before = jax.tree_util.tree_map(np.copy, video), jax.tree_util.tree_map(np.copy, tree)
    got = transfer_sfnet(tree, video)
    want = jax.tree_util.tree_map(np.asarray, j_transfer(tree, video))
    assert (jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    neck = got["params"]["trunk"]["sfnet"] if name == "uavsal" else got["params"]["sfnet"]
    np.testing.assert_array_equal(neck["conv_last"]["conv"]["kernel"],
                                  tree["params"]["sfnet"]["conv_last"]["conv"]["kernel"])
    for a, b in zip(jax.tree_util.tree_leaves((video, tree)), jax.tree_util.tree_leaves(before)):
        np.testing.assert_array_equal(a, b)
    # the result loads into the port's model of that name
    from iip_uavsal_saliency_tpu_torch.models.adapters import build_adapted_model

    model = build_adapted_model(name, filter_kwargs=True, time_dims=5)
    model.load_state_dict(from_jax_variables(got, table_of(model)), strict=True)


def test_transfer_sfnet_without_a_neck_raises(tree):
    bad = {"params": {"head": {"kernel": np.zeros(3)}}, "batch_stats": {"head": {}}}
    with pytest.raises(ValueError, match="no sfnet subtree"):
        transfer_sfnet(tree, bad)


def test_test_images_pngs_match_jax_and_resume(salicon, tree, tmp_path):
    """The port's PNGs (f32 on the CPU, BatchNorm folded) within one uint8
    level of the JAX runner's on the same weights, at the images' native
    size; a second call writes nothing, and a removed PNG alone is made
    again."""
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    jinfer_images.test_images(salicon, jout, JSRFNetImage(), tree, classes="val",
                              iosize=IOSIZE, batch_size=2, method_name="M")
    model = tinfer_images.load_image_model(tree, device="cpu")
    tinfer_images.test_images(salicon, tout, model, classes="val", iosize=IOSIZE, batch_size=2,
                              method_name="M")
    names = sorted(os.listdir(os.path.join(jout, "M")))
    assert names == sorted(os.listdir(os.path.join(tout, "M"))) and len(names) == 3
    diffs = []
    for n in names:
        a = cv2.imread(os.path.join(tout, "M", n), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(os.path.join(jout, "M", n), cv2.IMREAD_UNCHANGED)
        assert a.shape == b.shape == NATIVE and a.dtype == np.uint8 and a.max() == 255
        diffs.append(np.abs(a.astype(int) - b.astype(int)).max())
    assert max(diffs) <= 1, diffs
    stamps = {n: os.stat(os.path.join(tout, "M", n)).st_mtime_ns for n in names}
    os.remove(os.path.join(tout, "M", names[1]))
    tinfer_images.test_images(salicon, tout, model, classes="val", iosize=IOSIZE, batch_size=2,
                              method_name="M")
    after = {n: os.stat(os.path.join(tout, "M", n)).st_mtime_ns for n in names}
    assert {n for n in names if after[n] != stamps.get(n)} == {names[1]}


def test_predict_images_is_the_runner_on_arrays(salicon, tree):
    """`predict_images` on uint8 arrays (what a machine without cv2 serves)
    gives `test_images`' maps: the runner is decode, this, and the writes."""
    imgs, _, _ = timages.salicon_file_lists(salicon, "val")
    raw = [cv2.imread(p) for p in imgs]
    x = np.stack([cv2.resize(r[:, :, ::-1], (64, 64), interpolation=cv2.INTER_LINEAR)
                  for r in raw])
    model = tinfer_images.load_image_model(tree, device="cpu")
    maps = tinfer_images.predict_images(model, x, [r.shape[:2] for r in raw])
    unfolded = tinfer_images.load_image_model(tree, device="cpu", fold_bn=False)
    again = tinfer_images.predict_images(unfolded, torch.from_numpy(x), [NATIVE] * 3)
    for a, b in zip(maps, again):
        assert a.shape == NATIVE and a.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
