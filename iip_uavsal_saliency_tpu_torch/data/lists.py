"""Dataset splits and file lists (own copy of `iip_uavsal_saliency_tpu/data/
lists.py`).

`<DS>/txt/{train,val,test}.txt` hold video basenames; the videos live under
`<DS>/Videos/`, the blurred ground truth under `<DS>/maps/<vid>_fixMaps.mat`
and the fixation points under `<DS>/fixations/maps/<vid>_fixPts.mat`.
"""

from __future__ import annotations

import os
import random
from typing import List, Sequence, Tuple

VIDEO_EXTS = (".mp4", ".avi", ".AVI")


def _split(images: List[str], ratio: float, shuffle: bool, out_dir, save_txt: bool):
    if shuffle:
        random.shuffle(images)
    n = int(len(images) * ratio)
    train_images, val_images = sorted(images[:n]), sorted(images[n:])
    if save_txt:
        os.makedirs(out_dir, exist_ok=True)
        for name, lst in (("train", train_images), ("val", val_images)):
            with open(os.path.join(out_dir, name + ".txt"), "w") as f:
                f.writelines(str(line) + "\n" for line in lst)
    return train_images, val_images


def shuffle_data_dir(data_path: str, ratio: float = 0.8, shuffle: bool = True,
                     save_txt: bool = True, txt_subdir: str = "") -> Tuple[List[str], List[str]]:
    """80/20 split of `<data_path>/videos/` into train/val lists. As in the
    reference, it scans lowercase `videos/` and writes the txt files to the
    dataset root; pass txt_subdir="txt" to write where `read_video_list`
    reads."""
    vid_dir = os.path.join(data_path, "videos")
    images = [f for f in os.listdir(vid_dir) if f.endswith(VIDEO_EXTS)]
    out_dir = os.path.join(data_path, txt_subdir) if txt_subdir else data_path
    return _split(images, ratio, shuffle, out_dir, save_txt)


def shuffle_data_list(list_path: str, ratio: float = 0.8, shuffle: bool = True,
                      save_txt: bool = True) -> Tuple[List[str], List[str]]:
    """Split an existing list file; the txt files go beside it."""
    with open(list_path) as f:
        images = [line.strip("\n") for line in f]
    return _split(images, ratio, shuffle, os.path.dirname(list_path), save_txt)


def read_video_list(datapath: str, phase_gen: str = "train", shuffle: bool = True,
                    ext: str = ".mp4") -> Tuple[List[str], List[str], List[str]]:
    """(videos, fixMaps, fixPts) paths of a txt split, names sorted (then
    shuffled when asked); blank lines and CRLF endings are dropped."""
    if phase_gen not in ("train", "val", "test"):
        raise NotImplementedError(phase_gen)
    with open(os.path.join(datapath, "txt", phase_gen + ".txt")) as f:
        names = sorted(line.strip() for line in f if line.strip())
    if shuffle:
        random.shuffle(names)
    videos = [os.path.join(datapath, "Videos", n + ext) for n in names]
    vidmaps = [os.path.join(datapath, "maps", n + "_fixMaps.mat") for n in names]
    vidfixs = [os.path.join(datapath, "fixations", "maps", n + "_fixPts.mat") for n in names]
    return videos, vidmaps, vidfixs


def get_video_list(datapath: str, phase_gen: str = "train", shuffle: bool = True
                   ) -> Tuple[Sequence[str], Sequence[str], Sequence[str]]:
    """Directory-scan variant: `<datapath>/<phase>/{videos, maps,
    fixations/maps}`, each listing sorted before pairing (the ground truth
    shares the video's basename)."""
    if phase_gen not in ("train", "val", "test"):
        raise NotImplementedError(phase_gen)
    base = os.path.join(datapath, phase_gen)

    def listing(sub, exts):
        d = os.path.join(base, sub)
        return sorted(os.path.join(d, f) for f in os.listdir(d) if f.endswith(exts))

    videos = listing("videos", VIDEO_EXTS)
    vidmaps = listing("maps", ".mat")
    vidfixs = listing(os.path.join("fixations", "maps"), ".mat")
    if not (len(videos) == len(vidmaps) == len(vidfixs)):
        raise ValueError(f"unpaired dataset listing under {base}: {len(videos)} videos, "
                         f"{len(vidmaps)} fixMaps, {len(vidfixs)} fixPts")
    if shuffle:
        zipped = list(zip(videos, vidmaps, vidfixs))
        random.shuffle(zipped)
        videos, vidmaps, vidfixs = map(list, zip(*zipped))
    return videos, vidmaps, vidfixs


def dataset_ext(dataset: str) -> str:
    """Video container of a dataset."""
    return ".avi" if dataset.upper() in ("UAV2", "UAV2-TE", "CITIUS") else ".mp4"
