"""The image stage's trainer against the JAX package on the CPU at 64x64:
`train_salicon` over 2 epochs (5 train images in batches of 2, the short
last one dropped; 3 val images, the last val batch short), as the JAX
package's `tests/test_images.py` sizes it, from the same weights in both
packages. The per-epoch val losses are read from the checkpoint names and
held within 1e-4 relative.

They are compared in f64, as `tests/test_torch_train_f64.py` compares the
video step: the JAX package under `jax_enable_x64`, the port with f64
parameters, and both packages' batches cast to f64 (`salicon_batches`
wrapped in each trainer's module: with f32 targets the loss's sums over
the target run in f32 in both packages, in other orders, 7e-8 relative
apart, and 4 Adam steps through the BatchNorms of 2 images of 64x64 carry
that to 2.3e-4 by the second epoch). Two f32 runs part after the first
Adam step (a coordinate whose gradient is at the noise level steps the
other way; `tests/test_torch_train_step.py`): the two packages' f32 val
losses read 5.8e-4 and 8.9e-4 apart. The port's f32 trainer runs the same
2 epochs beside them, held to its f64 run, and its `_final.ckpt` is read
by the JAX package's `load_checkpoint`. The JAX f64 compile of the train
step takes most of this file's time.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from iip_uavsal_saliency_tpu.models import is_image_stage_variables as j_is_image
from iip_uavsal_saliency_tpu.training.checkpoint import load_checkpoint as j_load_checkpoint
from iip_uavsal_saliency_tpu.training import image_trainer as jimage_trainer
from iip_uavsal_saliency_tpu.training.image_trainer import ImageTrainConfig as JImageTrainConfig
from iip_uavsal_saliency_tpu.training.image_trainer import train_salicon as j_train_salicon
from iip_uavsal_saliency_tpu_torch.data import images as timages
from iip_uavsal_saliency_tpu_torch.models.convert import table_of, to_jax_variables
from iip_uavsal_saliency_tpu_torch.models.srfnet_image import SRFNetImage
from iip_uavsal_saliency_tpu_torch.models.uavsal import init_model
from iip_uavsal_saliency_tpu_torch.training import image_trainer as timage_trainer
from iip_uavsal_saliency_tpu_torch.training.image_trainer import ImageTrainConfig, train_salicon
from test_torch_images import IOSIZE, write_salicon
from test_torch_train_step import few_threads  # noqa: F401

TOL_EPOCH = 1e-4    # relative, f64 against f64
NAME_STEP = 1e-4    # the checkpoint names' 4 decimals: each within half of this
# the port's f32 trainer against its f64 trainer over 2 epochs (measured
# 5.8e-4 and 8.9e-4 against the JAX package's f32: the trajectories part
# after the first Adam step)
TOL_EPOCH_F32 = 5e-3


def _epoch_losses(model_dir, prefix):
    """{epoch: val loss} from `<prefix>_{epoch:02d}_{val:.4f}.ckpt`."""
    pat = re.compile(re.escape(prefix) + r"_(\d\d)_(-?[\d.]+)\.ckpt$")
    found = [pat.match(f) for f in os.listdir(model_dir)]
    return {int(m.group(1)): float(m.group(2)) for m in found if m}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """2 epochs of both packages' `train_salicon` in f64 from one start (the
    port's `init_model` draw), and of the port's in f32."""
    root = write_salicon(tmp_path_factory.mktemp("salicon_train"), (("train", 5), ("val", 3)))
    save = str(tmp_path_factory.mktemp("image_weights"))
    start = init_model(SRFNetImage(), torch.Generator().manual_seed(0))
    tree = to_jax_variables(start.state_dict(), table_of(start))
    kw = dict(iosize=IOSIZE, batch_size=2, epochs=2)

    def f64_batches(*args, **kwargs):
        for x, y in timages.salicon_batches(*args, **kwargs):
            yield x.astype(np.float64), y.astype(np.float64)

    default = torch.get_default_dtype()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jimage_trainer, "salicon_batches", f64_batches)
        mp.setattr(timage_trainer, "salicon_batches", f64_batches)
        with jax.enable_x64(True):
            j_train_salicon(JImageTrainConfig(method_name="J", **kw), root, save,
                            pre_variables=jax.tree_util.tree_map(
                                lambda a: a.astype(np.float64), tree))
        torch.set_default_dtype(torch.float64)
        try:
            model64, _ = train_salicon(ImageTrainConfig(method_name="P", **kw), root, save,
                                       pre_variables=tree, device="cpu")
        finally:
            torch.set_default_dtype(default)
    model32, variables32 = train_salicon(ImageTrainConfig(method_name="P32", **kw), root, save,
                                         pre_variables=tree, device="cpu")
    assert next(model64.parameters()).dtype == torch.float64
    assert next(model32.parameters()).dtype == torch.float32
    return save, model32, variables32


def test_train_salicon_epochs_match_jax(trained):
    save, _, _ = trained
    jax_epochs = _epoch_losses(os.path.join(save, "J"), "J")
    port_epochs = _epoch_losses(os.path.join(save, "P"), "P")
    port32 = _epoch_losses(os.path.join(save, "P32"), "P32")
    assert sorted(jax_epochs) == sorted(port_epochs) == sorted(port32) == [0, 1]
    for e in (0, 1):
        want = jax_epochs[e]
        assert np.isfinite(port_epochs[e]) and np.isfinite(port32[e])
        assert abs(port_epochs[e] - want) <= TOL_EPOCH * abs(want) + NAME_STEP, (
            e, port_epochs, jax_epochs)
        assert abs(port32[e] - port_epochs[e]) <= TOL_EPOCH_F32 * abs(port_epochs[e]), (
            e, port32, port_epochs)
    for name in ("J", "P", "P32"):
        assert os.path.exists(os.path.join(save, name, f"{name}_final.ckpt"))


def test_final_checkpoint_is_read_by_jax(trained):
    """The port's `_final.ckpt` (f32) through the JAX package's reader: an
    image-stage tree with the returned best weights, which the returned
    model holds."""
    save, model32, variables32 = trained
    ckpt = j_load_checkpoint(os.path.join(save, "P32", "P32_final.ckpt"))
    assert j_is_image(ckpt)
    got = jax.tree_util.tree_leaves_with_path({"params": ckpt["params"],
                                               "batch_stats": ckpt["batch_stats"]})
    assert len(got) == len(jax.tree_util.tree_leaves(variables32))
    for path, leaf in got:
        node = variables32
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(np.asarray(leaf), node)
    held = to_jax_variables(model32.state_dict(), table_of(model32))
    for a, b in zip(jax.tree_util.tree_leaves(held), jax.tree_util.tree_leaves(variables32)):
        np.testing.assert_array_equal(a, b)
