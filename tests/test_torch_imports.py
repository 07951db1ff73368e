"""The port stands alone: no module of `iip_uavsal_saliency_tpu_torch`, and
not chip_smoke.py, imports JAX, flax, optax or the JAX package."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "iip_uavsal_saliency_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "iip_uavsal_saliency_tpu")

_PROBE = """
import importlib, pkgutil, sys
import iip_uavsal_saliency_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
forbidden = {forbidden!r}
bad = sorted(m for m in sys.modules if m.split(".")[0] in forbidden)
print(len(names), bad)
"""


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_importing_every_port_module_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _PROBE.format(forbidden=FORBIDDEN)],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 20, out.stdout  # every subpackage was walked
    assert bad == "[]", f"importing the port loaded {bad}"


_ZOO_PROBE = """
import sys
import torch
from iip_uavsal_saliency_tpu_torch.models.adapters import build_adapted_model
from iip_uavsal_saliency_tpu_torch.models.convert import table_of
from iip_uavsal_saliency_tpu_torch.models.uavsal import MODEL_ZOO
with torch.device("meta"):
    models = [build_adapted_model(n, filter_kwargs=True, st_type="s2t") for n in MODEL_ZOO]
rows = sum(len(table_of(m)) for m in models)
forbidden = {forbidden!r}
print(len(models), rows, sorted(m for m in sys.modules if m.split(".")[0] in forbidden))
"""


def test_the_zoo_loads_no_jax():
    """The zoo's modules (`models/adapters.py`, the blocks and recurrences
    in `models/stblock.py` and `models/recurrent.py`, the bridge's zoo
    tables): building every `MODEL_ZOO` model and its table loads no JAX."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _ZOO_PROBE.format(forbidden=FORBIDDEN)],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, rows, bad = out.stdout.strip().split(" ", 2)
    assert int(count) == 9 and int(rows) > 9 * 300, out.stdout
    assert bad == "[]", f"building the zoo loaded {bad}"


def _sources():
    for dirpath, _, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", list(_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_source_has_no_jax_import(path):
    tree = ast.parse(open(path).read(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                found.append(node.module)
    assert not found, f"{os.path.relpath(path, ROOT)} imports {found}"


_LAZY_PROBE = """
import importlib, pkgutil, sys
import iip_uavsal_saliency_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
print(sorted(m for m in sys.modules if m.split(".")[0] in ("msgpack", "cv2", "h5py")))
"""


def test_port_needs_no_msgpack_and_loads_cv2_and_h5py_lazily():
    """The card's machine has none of msgpack, cv2 and h5py: importing the
    port loads none of them, and no module of it imports msgpack at all
    (checkpoints go through the port's own codec)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _LAZY_PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    for path in _sources():
        tree = ast.parse(open(path).read(), filename=path)
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        assert not any(name.split(".")[0] == "msgpack" for name in names), path


_SCORE_PROBE = """
import sys
import numpy as np
from iip_uavsal_saliency_tpu_torch.evaluation import scorer
rng = np.random.RandomState(0)
sal = rng.randint(0, 255, (24, 32, 1, 5)).astype(np.uint8)
pts = (rng.rand(24, 32, 1, 5) > 0.9).astype(np.uint8)
pool = [np.stack([rng.rand(9), rng.rand(9)], 1) for _ in range(4)]
for device_auc in (True, False):
    out = scorer._score_video(sal, pts * 255, pts, pool, scorer.KEYS_ORDER, 2, rng,
                              device_auc=device_auc, device="cpu")
    assert out.shape == (5, 7) and np.isfinite(out).all(), out
print(sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r}))
"""


def test_scoring_arrays_needs_no_cv2_h5py_or_jax():
    """The evaluation modules are among those walked above; scoring a video
    given as arrays whose saliency has the ground truth's size (as
    chip_smoke.py scores on the card's machine, which has neither cv2 nor
    h5py) loads neither, nor JAX."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    probe = _SCORE_PROBE.format(forbidden=FORBIDDEN + ("cv2", "h5py"))
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    sources = [os.path.relpath(p, ROOT) for p in _sources()]
    for name in ("__init__", "metrics_np", "metrics_torch", "scorer"):
        assert os.path.join("iip_uavsal_saliency_tpu_torch", "evaluation", name + ".py") in sources


_RECIPE_PROBE = """
import sys
import numpy as np
import torch
from iip_uavsal_saliency_tpu_torch.data.images import salicon_array_batches
from iip_uavsal_saliency_tpu_torch.models.convert import table_of, to_jax_variables
from iip_uavsal_saliency_tpu_torch.models.srfnet_image import (SRFNetImage,
    is_image_stage_variables, transfer_sfnet)
from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal, init_model
from iip_uavsal_saliency_tpu_torch.runners.infer_images import load_image_model, predict_images
from iip_uavsal_saliency_tpu_torch.training.optim import make_optimizer
from iip_uavsal_saliency_tpu_torch.training.steps import create_train_state, make_image_train_step
import iip_uavsal_saliency_tpu_torch.vis.overlay
torch.set_num_threads(2)
rng = np.random.RandomState(0)
images = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
targets = rng.rand(2, 8, 8, 2).astype(np.float32)
model = init_model(SRFNetImage(), torch.Generator().manual_seed(0))
step = make_image_train_step(create_train_state(model, make_optimizer(model)))
for x, y in salicon_array_batches(images, targets, 2, shuffle=True, rng=rng):
    assert torch.isfinite(step(torch.from_numpy(x), torch.from_numpy(y)))
tree = to_jax_variables(model.state_dict(), table_of(model))
maps = predict_images(load_image_model(tree, device="cpu"), images, [(30, 40)] * 2)
assert [m.shape for m in maps] == [(30, 40)] * 2
video = UAVSal()
moved = transfer_sfnet(tree, to_jax_variables(video.state_dict(), table_of(video)))
assert is_image_stage_variables(tree) and not is_image_stage_variables(moved)
print(sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r}))
"""


def test_recipe_on_arrays_needs_no_cv2_h5py_or_jax():
    """The recipe's new modules (`data/images.py`, `models/srfnet_image.py`,
    `training/image_trainer.py`'s step, `runners/infer_images.py`,
    `vis/overlay.py`) are among those walked above, and the image stage on
    arrays (the array batches, a train step, `predict_images`, the
    transplant; what chip_smoke.py runs on the card's machine, which has
    neither cv2 nor h5py) loads neither, nor JAX."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    probe = _RECIPE_PROBE.format(forbidden=FORBIDDEN + ("cv2", "h5py"))
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    sources = [os.path.relpath(p, ROOT) for p in _sources()]
    for name in ("data/images", "models/srfnet_image", "training/image_trainer",
                 "runners/infer_images", "vis/overlay", "vis/__init__"):
        assert os.path.join("iip_uavsal_saliency_tpu_torch", name + ".py") in sources
