"""The port's conv blocks, resizes and BatchNorm fold against the JAX package.

Same numpy-seeded inputs and weights through both, f32, atol 1e-5 (the
two frameworks sum conv products in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iip_uavsal_saliency_tpu.ops import fold as jfold
from iip_uavsal_saliency_tpu.ops import layers as jl
from iip_uavsal_saliency_tpu.ops import resize as jr
from iip_uavsal_saliency_tpu_torch.models import convert
from iip_uavsal_saliency_tpu_torch.ops import fold as tfold
from iip_uavsal_saliency_tpu_torch.ops import layers as tl
from iip_uavsal_saliency_tpu_torch.ops import resize as tr
from test_torch_train_step import few_threads  # noqa: F401

ATOL = 1e-5


def randomize(tree, rng):
    """Every leaf of a JAX variable tree replaced by seeded values of its
    shape: positive BN variances and scales, small BN means and biases."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rng)
        elif k in ("var", "scale"):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("mean", "bias"):
            out[k] = rng.normal(0.0, 0.2, v.shape).astype(np.float32)
        else:
            out[k] = (rng.normal(0.0, 1.0, v.shape) / np.sqrt(np.prod(v.shape[:-1]))).astype(np.float32)
    return out


def jax_init(module, x, rng):
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    return randomize(variables, rng)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def conv_bn_state_dict(v):
    return convert.from_jax_variables(v, convert._conv_bn((), "0", "1"))


def dwblock_state_dict(v, expand):
    sd = convert.from_jax_variables(v, convert._dwblock((), "m", expand != 1))
    return {k[2:]: t for k, t in sd.items()}


@pytest.mark.parametrize("cin,cout,k,stride,dil,groups,hw", [
    (16, 32, 1, 1, 1, 1, (9, 11)),        # 1x1
    (8, 16, 3, 2, 1, 1, (10, 13)),        # 3x3 stride 2
    (16, 16, 3, 1, 18, 16, (20, 24)),     # rate-18 depthwise: JAX takes its pad-add branch
])
def test_conv_bn_act_matches_jax(cin, cout, k, stride, dil, groups, hw):
    rng = np.random.RandomState(cin + k + dil)
    x = rng.randn(2, *hw, cin).astype(np.float32)
    jm = jl.ConvBNAct(cout, kernel_size=k, stride=stride, dilation=dil, groups=groups)
    v = jax_init(jm, x, rng)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = tl.ConvBNAct(cin, cout, k, stride, dil, groups).eval()
    tm.load_state_dict(conv_bn_state_dict(v), strict=True)
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("cin,cout,stride,expand,dil,res_connect", [
    (16, 16, 1, 6, 1, None),     # expand + identity residual
    (16, 16, 1, 1, 1, None),     # no expand, residual
    (16, 16, 1, 6, 1, False),    # residual forced off
    (16, 24, 2, 6, 1, None),     # stride 2, no residual
    (24, 32, 1, 6, 6, None),     # dilated depthwise (ASPP rate 6)
])
def test_dwblock_matches_jax(cin, cout, stride, expand, dil, res_connect):
    rng = np.random.RandomState(cin + cout + stride + expand + dil)
    x = rng.randn(2, 12, 14, cin).astype(np.float32)
    jm = jl.DWBlock(cout, 3, stride=stride, expand_ratio=expand, dilation=dil,
                    res_connect=res_connect)
    v = jax_init(jm, x, rng)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = tl.DWBlock(cin, cout, 3, stride, expand, dil, res_connect).eval()
    tm.load_state_dict(dwblock_state_dict(v, expand), strict=True)
    assert tm.use_res == (stride == 1 and cin == cout and res_connect is not False)
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_fold_conv_bn_matches_live():
    """Serving folds each BatchNorm into the conv before it; the block
    computes the same function."""
    from iip_uavsal_saliency_tpu_torch.ops.fold import fold_conv_bn

    rng = np.random.RandomState(3)
    block = tl.DWBlock(8, 8, 3).eval()
    with torch.no_grad():
        for name, t in block.named_buffers():
            t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape).astype(np.float32)))
        for name, t in block.named_parameters():
            t.copy_(torch.from_numpy(rng.normal(0.0, 0.3, t.shape).astype(np.float32)))
        x = torch.from_numpy(rng.randn(2, 8, 5, 6).astype(np.float32))
        live = block(x)
        fold_conv_bn(block)
        assert not any(isinstance(m, tl.BatchNorm) for m in block.modules())
        torch.testing.assert_close(block(x), live, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["align_corners", "half_pixel"])
@pytest.mark.parametrize("hw,out_hw", [((5, 7), (23, 40)), ((12, 20), (8, 9)), ((1, 6), (4, 4))])
def test_resize_matches_jax(kind, hw, out_hw):
    rng = np.random.RandomState(hw[0] * 7 + out_hw[1])
    x = rng.randn(2, *hw, 3).astype(np.float32)
    jfn = jr.resize_bilinear_align_corners if kind == "align_corners" else jr.resize_bilinear_half_pixel
    tfn = tr.resize_bilinear_align_corners if kind == "align_corners" else tr.resize_bilinear_half_pixel
    want = np.asarray(jfn(jnp.asarray(x), *out_hw))
    got = nhwc(tfn(nchw(x), *out_hw))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_fold_batchnorm_matches_jax():
    """The copy folds the same pairs to the same values and passes the
    rest (biased convs, the TWA kernel) through."""
    rng = np.random.RandomState(5)

    def r(*shape):
        return rng.randn(*shape).astype(np.float32)

    def bn_p(c):
        return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32), "bias": r(c)}

    def bn_s(c):
        return {"mean": r(c), "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}

    variables = {
        "params": {
            "a": {"conv": {"kernel": r(3, 3, 4, 8)}, "bn": bn_p(8)},
            "blk": {"expand": {"conv": {"kernel": r(1, 1, 8, 16)}, "bn": bn_p(16)},
                    "project": {"kernel": r(1, 1, 16, 8)}, "project_bn": bn_p(8)},
            "vgg": {"kernel": r(3, 3, 4, 4), "bias": r(4)},
            "rnn": {"kernel": r(3, 3, 16, 8)},
        },
        "batch_stats": {
            "a": {"bn": bn_s(8)},
            "blk": {"expand": {"bn": bn_s(16)}, "project_bn": bn_s(8)},
        },
    }
    want = jfold.fold_batchnorm(variables)
    got = tfold.fold_batchnorm(variables)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, a), (_, b) in zip(flat_w, flat_g):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))
