"""The training slice's host-side pieces against the JAX package: the split
lists, the ground-truth letterbox (`preprocess_vidmaps`,
`preprocess_vidfixs`, `padding_fixation`), the one-ahead decode thread, the
metrics log and the checkpoint codec (against msgpack and flax)."""

import json
import os
import random

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from iip_uavsal_saliency_tpu.data import letterbox as jletterbox  # noqa: E402
from iip_uavsal_saliency_tpu.data import lists as jlists  # noqa: E402
from iip_uavsal_saliency_tpu.data import video as jvideo  # noqa: E402
from iip_uavsal_saliency_tpu.data.loaders import _prefetched as j_prefetched  # noqa: E402
from iip_uavsal_saliency_tpu.training import checkpoint as jckpt  # noqa: E402
from iip_uavsal_saliency_tpu.utils.metrics_log import MetricsLogger as JMetricsLogger  # noqa: E402
from iip_uavsal_saliency_tpu_torch.data import letterbox as tletterbox  # noqa: E402
from iip_uavsal_saliency_tpu_torch.data import lists as tlists  # noqa: E402
from iip_uavsal_saliency_tpu_torch.data import video as tvideo  # noqa: E402
from iip_uavsal_saliency_tpu_torch.data.loaders import _prefetched  # noqa: E402
from iip_uavsal_saliency_tpu_torch.training import checkpoint as tckpt  # noqa: E402
from iip_uavsal_saliency_tpu_torch.utils.metrics_log import MetricsLogger  # noqa: E402
from test_torch_train_step import few_threads  # noqa: E402,F401
from test_torch_train_trainer import DATASET, VIDEOS, dataset  # noqa: E402,F401


@pytest.mark.parametrize("phase", ["train", "val"])
@pytest.mark.parametrize("out", [(8, 16), (45, 80), (36, 64)])
def test_ground_truth_letterbox_matches_jax(dataset, phase, out):  # noqa: F811
    videos, maps, fixs = tlists.read_video_list(dataset, phase, shuffle=False, ext=".avi")
    assert (videos, maps, fixs) == jlists.read_video_list(dataset, phase, shuffle=False,
                                                          ext=".avi")
    for m, f in zip(maps, fixs):
        for frames in (float("inf"), 7):
            np.testing.assert_array_equal(tvideo.preprocess_vidmaps(m, *out, frames),
                                          jvideo.preprocess_vidmaps(m, *out, frames))
            got = tvideo.preprocess_vidfixs(f, *out, frames)
            np.testing.assert_array_equal(got, jvideo.preprocess_vidfixs(f, *out, frames))
            assert got.dtype == np.uint8 and got.max() == 1
    assert all(tvideo.probe_nframes(v) == jvideo.probe_nframes(v) for v in videos)


@pytest.mark.parametrize("shape,out", [((72, 120), (8, 16)), ((100, 60), (45, 80)),
                                       ((45, 80), (45, 80)), ((30, 40), (60, 80))])
def test_padding_fixation_matches_jax(shape, out):
    rng = np.random.RandomState(sum(shape))
    img = (rng.rand(*shape) < 0.02).astype(np.uint8)
    got = tletterbox.padding_fixation(img, *out)
    np.testing.assert_array_equal(got, jletterbox.padding_fixation(img, *out))
    np.testing.assert_array_equal(tletterbox.resize_fixation(img, *out),
                                  jletterbox.resize_fixation(img, *out))
    if shape == out:  # the reference's quirk: returned as it is
        assert got is img


def test_lists_match_jax(dataset, tmp_path):  # noqa: F811
    assert tlists.VIDEO_EXTS == jlists.VIDEO_EXTS
    for ds in ("UAV2", "uav2-te", "CITIUS", "DHF1K"):
        assert tlists.dataset_ext(ds) == jlists.dataset_ext(ds)
    with pytest.raises(NotImplementedError):
        tlists.read_video_list(dataset, "bogus")
    # the shuffles, under the same seed of the random module
    root = tmp_path / "ds"
    os.makedirs(root / "videos")
    for i in range(7):
        (root / "videos" / f"v{i}.avi").write_bytes(b"")
    for fn in ("shuffle_data_dir",):
        random.seed(3)
        want = getattr(jlists, fn)(str(root), txt_subdir="jtxt")
        random.seed(3)
        got = getattr(tlists, fn)(str(root), txt_subdir="ttxt")
        assert got == want
        assert (root / "ttxt" / "train.txt").read_text() == (root / "jtxt" / "train.txt").read_text()
    random.seed(4)
    want = jlists.shuffle_data_list(str(root / "jtxt" / "train.txt"), save_txt=False)
    random.seed(4)
    assert tlists.shuffle_data_list(str(root / "jtxt" / "train.txt"), save_txt=False) == want
    # the directory-scan variant
    for sub in ("videos", "maps", os.path.join("fixations", "maps")):
        os.makedirs(root / "train" / sub)
    for i in range(3):
        (root / "train" / "videos" / f"v{i}.mp4").write_bytes(b"")
        (root / "train" / "maps" / f"v{i}_fixMaps.mat").write_bytes(b"")
        (root / "train" / "fixations" / "maps" / f"v{i}_fixPts.mat").write_bytes(b"")
    assert tlists.get_video_list(str(root), "train", shuffle=False) == tuple(
        jlists.get_video_list(str(root), "train", shuffle=False))
    os.remove(root / "train" / "maps" / "v2_fixMaps.mat")
    with pytest.raises(ValueError, match="unpaired"):
        tlists.get_video_list(str(root), "train")


def test_prefetched_matches_jax_and_raises_in_the_consumer():
    items = list(range(6))
    assert list(_prefetched(items, lambda i: i * i, 1)) == list(j_prefetched(items, lambda i: i * i, 1))

    def load(i):
        if i == 3:
            raise KeyError("broken video")
        return i

    got = []
    with pytest.raises(KeyError, match="broken video"):
        for item in _prefetched(items, load, 1):
            got.append(item)
    assert got == [0, 1, 2]


def test_metrics_log_lines_match_jax(tmp_path):
    for cls, d in ((MetricsLogger, "port"), (JMetricsLogger, "jax")):
        with cls(str(tmp_path / d)) as log:
            log.scalar("train/loss", np.float32(1.5), 3)
            log.scalar("val/mean_loss", 2.25)
    lines = {d: [json.loads(x) for x in (tmp_path / d / "metrics.jsonl").read_text().splitlines()]
             for d in ("port", "jax")}
    strip = [{k: v for k, v in r.items() if k != "wall"} for r in lines["port"]]
    assert strip == [{k: v for k, v in r.items() if k != "wall"} for r in lines["jax"]]
    assert strip == [{"tag": "train/loss", "value": 1.5, "step": 3},
                     {"tag": "val/mean_loss", "value": 2.25}]


def test_codec_writes_what_msgpack_and_flax_write(tmp_path):
    """Plain values encode to msgpack's own bytes; a tree of arrays and numpy
    scalars is read by flax, and flax's encoding of it by the codec."""
    import flax.serialization
    import msgpack

    plain = {"a": [1, -1, -33, 200, 70000, -40000, 2 ** 40, 1.5, None, True, False, "x" * 40,
                   b"\x00\x01", {"n": list(range(20))}]}
    assert tckpt.packb(plain) == msgpack.packb(plain, use_bin_type=True)
    assert tckpt.unpackb(msgpack.packb(plain, use_bin_type=True)) == plain
    tree = {"params": {"w": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
                       "b": np.zeros((0,), np.float64)},
            "step": np.int32(7), "count": np.arange(3, dtype=np.int64)}
    data = tckpt.packb(tree)
    restored = flax.serialization.msgpack_restore(data)
    assert restored["step"] == 7 and np.array_equal(restored["count"], tree["count"])
    back = tckpt.unpackb(flax.serialization.msgpack_serialize(tree), tckpt._ext_hook)
    assert back["step"] == 7 and isinstance(back["step"], np.int32)
    assert np.array_equal(back["params"]["w"], tree["params"]["w"])
    path = str(tmp_path / "sub" / "x_03_1.2500.ckpt")
    tckpt.save_checkpoint(path, tree)
    assert not os.path.exists(path + ".tmp")
    assert jckpt.load_checkpoint(path)["step"] == 7
    tckpt.save_checkpoint(str(tmp_path / "sub" / "x_11_inf.ckpt"), tree)
    tckpt.save_checkpoint(str(tmp_path / "sub" / "x_final.ckpt"), tree)
    assert tckpt.latest_checkpoint(str(tmp_path / "sub"), "x") == jckpt.latest_checkpoint(
        str(tmp_path / "sub"), "x") == str(tmp_path / "sub" / "x_11_inf.ckpt")
    assert tckpt.latest_checkpoint(str(tmp_path / "none"), "x") is None


def test_codec_reads_bf16_and_refuses_other_extensions():
    import msgpack

    bits = np.asarray([0x3F80, 0xC000], np.uint16)  # 1.0, -2.0
    ext = msgpack.ExtType(1, msgpack.packb(((2,), "bfloat16", bits.tobytes()),
                                           use_bin_type=True))
    got = tckpt.unpackb(msgpack.packb({"w": ext}, use_bin_type=True), tckpt._ext_hook)
    assert got["w"].dtype == np.float32 and got["w"].tolist() == [1.0, -2.0]
    with pytest.raises(ValueError, match="extension type 2"):
        tckpt.unpackb(msgpack.packb(msgpack.ExtType(2, b"xx")), tckpt._ext_hook)
    with pytest.raises(ValueError, match="truncated"):
        tckpt.unpackb(msgpack.packb({"a": "long string"})[:-3])
