"""The port's backbone pyramids and the space-to-depth stem against the
JAX package on the CPU, f32.

Every pyramid (MobileNetV2, ResNet-18/34/50/101/152, VGG16) at N=2, 32x64:
the JAX variable tree's structure comes from `jax.eval_shape` of the JAX
pyramid (no initializer runs), it is filled with seeded values
(`test_torch_train_step.randomized`), loaded into the port's pyramid
through the weight bridge's rows, read back exactly, and the five stages of
both are compared. The JAX modules run un-jitted, so no XLA compile of a
152-layer graph lands here. Also the S2D stem against the plain stem and
the JAX `S2DStem`, the JAX package's refusals, and the initializers'
moments per backbone against the JAX init."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iip_uavsal_saliency_tpu.models import backbone as jbackbone
from iip_uavsal_saliency_tpu.ops import layers as jl
from iip_uavsal_saliency_tpu_torch.models import backbone as tbackbone
from iip_uavsal_saliency_tpu_torch.models import convert
from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal, init_model
from iip_uavsal_saliency_tpu_torch.ops import layers as tl
from iip_uavsal_saliency_tpu_torch.ops.fold import fold_conv_bn
from test_torch_train_step import few_threads, randomized  # noqa: F401

N, H, W = 2, 32, 64
CNN_TYPES = ["mobilenet_v2", "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
             "vgg16"]
# f32, each stage against its largest value: XLA and torch sum each conv's
# products in other orders. The ResNets' residual sums grow the activations
# with depth on these seeded weights (ResNet-152's c5 reaches 477, where an
# absolute 2e-5 would ask for 4e-8 relative), so the bound is relative;
# measured 1.3e-7 to 1.8e-6 over every stage of every pyramid
RTOL_STAGE = 1e-5
FEATURES = ("trunk", "sfnet", "features")


def _jax_pyramid(cnn_type, s2d_stem=False):
    return jbackbone.build_backbone(cnn_type, s2d_stem).clone(name=None, parent=None)


def _jax_tree(module, x):
    """The JAX module's variable tree at `x`'s shape, seeded (no init runs)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(x))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    return randomized(zeros, np.random.RandomState(len(jax.tree_util.tree_leaves(zeros))))


def _rows(cnn_type):
    """The bridge's rows of the pyramid, with the JAX paths and the keys
    taken relative to the pyramid."""
    pre = "sfnet.features."
    return [((path[0],) + path[len(FEATURES) + 1:], key[len(pre):], is_kernel)
            for path, key, is_kernel in convert._backbone(cnn_type)]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("cnn_type", CNN_TYPES)
def test_pyramid_matches_jax(cnn_type):
    x = np.random.RandomState(1).randn(N, H, W, 3).astype(np.float32)
    jm = _jax_pyramid(cnn_type)
    v = _jax_tree(jm, x)
    rows = _rows(cnn_type)
    tm = tbackbone.build_backbone(cnn_type).eval()
    tm.load_state_dict(convert.from_jax_variables(v, rows), strict=True)
    back = convert.to_jax_variables(tm.state_dict(), rows)
    flat_v = jax.tree_util.tree_flatten_with_path(v)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_b] == [p for p, _ in flat_v]  # the rows cover the tree
    for (_, a), (_, b) in zip(flat_v, flat_b):
        np.testing.assert_array_equal(a, b)
    want = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(_nchw(x))
    assert len(got) == len(want) == 5
    # ResNet's c1 is the pooled stem, at stride 4 as layer1
    strides = (4, 4, 8, 16, 32) if cnn_type.startswith("resnet") else (2, 4, 8, 16, 32)
    for k, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(g.permute(0, 2, 3, 1).shape) == w.shape == (
            N, H // strides[k], W // strides[k], w.shape[-1])
        top = np.abs(w).max()
        err = np.abs(g.permute(0, 2, 3, 1).numpy() - w).max()
        assert err <= RTOL_STAGE * top, (cnn_type, k, err, top)
    assert [np.shape(w)[-1] for w in want][1:] == tbackbone.FEATURE_INPLANES[cnn_type]


def test_space_to_depth_matches_jax():
    x = np.random.RandomState(2).randn(2, 6, 10, 5).astype(np.float32)
    want = np.asarray(jl.space_to_depth(jnp.asarray(x)))
    got = tl.space_to_depth(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="divisible"):
        tl.space_to_depth(torch.zeros(1, 3, 5, 8))


@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
def test_s2d_stem_matches_plain_stem_and_jax(folded):
    """The S2D stem is the plain 3x3 stride-2 stem on the same weights
    (held to 2e-6: the same products summed in another order), loads the
    plain stem's state_dict, folds as it does, and matches the JAX
    `S2DStem` within 2e-6."""
    x = np.random.RandomState(3).randn(N, H, W, 3).astype(np.float32)
    jm = jl.S2DStem(32)
    v = _jax_tree(jm, x)
    sd = convert.from_jax_variables(v, convert._conv_bn((), "0", "1"))
    plain, s2d = tl.ConvBNAct(3, 32, 3, stride=2).eval(), tl.S2DStem(3, 32).eval()
    plain.load_state_dict(sd, strict=True)
    s2d.load_state_dict(sd, strict=True)
    if folded:
        fold_conv_bn(plain)
        fold_conv_bn(s2d)
        assert isinstance(s2d[1], torch.nn.Identity) and s2d[0].bias is not None
    with torch.no_grad():
        a, b = plain(_nchw(x)), s2d(_nchw(x))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    assert a.shape == b.shape == (N, 32, H // 2, W // 2)
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=2e-6, rtol=0)
    np.testing.assert_allclose(b.permute(0, 2, 3, 1).numpy(), want, atol=2e-6, rtol=0)
    # the pyramid's stem keeps the plain stem's keys
    assert set(tbackbone.MobileNetV2Pyramid(s2d_stem=True).state_dict()) == \
        set(tbackbone.MobileNetV2Pyramid().state_dict())


def test_build_backbone_refuses_what_the_jax_package_refuses():
    for cnn_type in ("resnet50", "vgg16"):
        with pytest.raises(NotImplementedError, match="s2d_stem"):
            jbackbone.build_backbone(cnn_type, s2d_stem=True)
        with pytest.raises(NotImplementedError, match="s2d_stem"):
            tbackbone.build_backbone(cnn_type, s2d_stem=True)
    with pytest.raises(NotImplementedError):
        jbackbone.build_backbone("alexnet")
    with pytest.raises(NotImplementedError):
        tbackbone.build_backbone("alexnet")
    with pytest.raises(NotImplementedError):
        UAVSal(cnn_type="resnet50", s2d_stem=True)


@pytest.mark.parametrize("cnn_type", ["resnet18", "vgg16"])
def test_init_moments_match_jax(cnn_type):
    """`init_model`'s draws of the backbone against the JAX pyramid's init,
    layer by layer: each kernel's std within 10% of the JAX init's (or 4
    sampling errors on a kernel too small for 10%), means near 0; VGG16's
    biases 0 (flax's default), BatchNorm at ones and zeros. ResNet draws
    kaiming fan_in (ConvBNAct's default, the same in every ResNet's basic
    and bottleneck blocks, so ResNet-18 stands for them), VGG16 flax's
    truncated lecun_normal, whose tail is cut at two stds: no value beyond.
    The JAX init is jitted: eager, it compiles each kernel shape's draw
    alone and takes three times as long."""
    x = jnp.zeros((1, H, W, 3))
    jv = jax.tree_util.tree_map(np.asarray, dict(
        jax.jit(_jax_pyramid(cnn_type).init)(jax.random.PRNGKey(1), x)))
    rows = _rows(cnn_type)
    want = convert.from_jax_variables(jv, rows)
    model = init_model(UAVSal(cnn_type=cnn_type), torch.Generator().manual_seed(0))
    got = {k[len("sfnet.features."):]: t for k, t in model.state_dict().items()
           if k.startswith("sfnet.features.")}
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if w.dim() == 4:
            ratio = g.std().item() / w.std().item()
            allowed = max(0.1, 4 * np.sqrt(1.0 / w.numel()))
            assert abs(ratio - 1) <= allowed, (k, ratio, allowed)
            assert abs(g.mean().item()) <= 4 * g.std().item() / np.sqrt(g.numel()), k
            if cnn_type == "vgg16":
                fan_in = w[0].numel()
                limit = 2 * np.sqrt(1.0 / fan_in) / 0.87962566103423978
                assert g.abs().max().item() <= limit * (1 + 1e-6), k
        else:
            assert torch.equal(g, w), k
    again = init_model(UAVSal(cnn_type=cnn_type), torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))
