"""The ablation zoo's blocks against the JAX package on the CPU, f32:
`ConvBNAct3D` in eval and train form (BatchNorm stats), the 3-D blocks
`STC3D` and `STC23D` (sum and cat fusion), the orderings `STBlockS2T`,
`STBlockT2S`, `STBlockSS2T`, `STBlock`'s cat fusion, and `res_connect` on
`SpConv` and `TeConvSub`; the Conv3d fold against the unfolded block, and
the numpy `fold_batchnorm` copy on a tree with 3-D nodes against the JAX
fold.

Same numpy-seeded inputs and weights through both; each block's weights go
through the bridge's rows for that block (`models/convert.py`), so the rows
the zoo's tables are built from are held here too. The tolerance is
`test_torch_layers.py`'s (1e-5: the two frameworks sum conv products in
different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iip_uavsal_saliency_tpu.models import stblock as jst
from iip_uavsal_saliency_tpu.ops import fold as jfold
from iip_uavsal_saliency_tpu.ops import layers as jl
from iip_uavsal_saliency_tpu_torch.models import convert
from iip_uavsal_saliency_tpu_torch.models import stblock as tst
from iip_uavsal_saliency_tpu_torch.ops import fold as tfold
from iip_uavsal_saliency_tpu_torch.ops import layers as tl
from test_torch_layers import ATOL, jax_init, nchw, nhwc
from test_torch_train_step import TOL_BN
from test_torch_train_step import few_threads  # noqa: F401

C, T, S = 16, 5, 10   # channels (= planes, so the residuals apply), time_dims, frames
H, W = 6, 7
REDUCTION = 4         # a temporal width of 4


def load(module, variables, rows):
    """`module` (eval form) with the JAX variables through `rows` (paths
    under "params"/"batch_stats", keys under a prefix "m." that is cut)."""
    sd = convert.from_jax_variables(variables, rows)
    module.load_state_dict({k[2:]: t for k, t in sd.items()}, strict=True)
    return module.eval()


def frames(seed, n=S, c=C):
    return np.random.RandomState(seed).randn(n, H, W, c).astype(np.float32)


def test_conv_bn_act_3d_matches_jax_eval_and_train():
    """(N, T, H, W, C) -> the port's (N, C, T, H, W): the output in eval
    form; in train form the output and the moved running stats
    (`mutable=["batch_stats"]`), within `TOL_BN` of their scale."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, T, H, W, C).astype(np.float32)
    jm = jl.ConvBNAct3D(8, 3)
    v = jax_init(jm, x, rng)
    tm = load(tl.ConvBNAct3D(C, 8, 3), v, convert._conv_bn((), "m.0", "m.1"))
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        got = tm(xt).permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))), atol=ATOL, rtol=0)
    want, mutated = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    tm.train()
    with torch.no_grad():
        got = tm(xt).permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    stats = mutated["batch_stats"]["bn"]
    assert not np.allclose(np.asarray(stats["mean"]), v["batch_stats"]["bn"]["mean"])
    np.testing.assert_allclose(tm[1].running_mean.numpy(), np.asarray(stats["mean"]),
                               atol=TOL_BN * np.abs(np.asarray(stats["mean"])).max(), rtol=0)
    np.testing.assert_allclose(tm[1].running_var.numpy(), np.asarray(stats["var"]),
                               atol=TOL_BN * np.asarray(stats["var"]).max(), rtol=0)


@pytest.mark.parametrize("kind", ["stc3d", "stc2_3d-sum", "stc2_3d-cat"])
def test_3d_blocks_match_jax(kind):
    """`STC3D` and `STC23D` over (S, H, W, C) frames taken as runs of
    `time_dims`: the port's reshape and permute against the JAX block's
    reshape, with the residual."""
    rng = np.random.RandomState(len(kind))
    x = frames(1)
    block, _, fu = kind.partition("-")
    if block == "stc3d":
        jm, tm = jst.STC3D(C, T), tst.STC3D(C, C, T)
    else:
        jm, tm = jst.STC23D(C, T, fu_type=fu), tst.STC23D(C, C, T, fu_type=fu)
    v = jax_init(jm, x, rng)
    load(tm, v, convert._st_block((), "m", block))
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))), atol=ATOL, rtol=0)


ORDERINGS = {"s2t": (jst.STBlockS2T, tst.STBlockS2T), "t2s": (jst.STBlockT2S, tst.STBlockT2S),
             "s_s2t": (jst.STBlockSS2T, tst.STBlockSS2T), "st-cat": (jst.STBlock, tst.STBlock)}


@pytest.mark.parametrize("ordering", list(ORDERINGS))
@pytest.mark.parametrize("diff_group", [None, T])
def test_st_orderings_match_jax(ordering, diff_group):
    """The three sequential orderings and the parallel block's cat fusion,
    with the temporal differences over all S frames and per `time_dims`."""
    rng = np.random.RandomState(len(ordering))
    x = frames(2)
    jcls, tcls = ORDERINGS[ordering]
    kw = {"fu_type": "cat"} if ordering == "st-cat" else {}
    jm = jcls(C, T, REDUCTION, diff_group=diff_group, **kw)
    tm = tcls(C, C, REDUCTION, **kw)
    v = jax_init(jm, x, rng)
    load(tm, v, convert._st_block((), "m", "st"))
    with torch.no_grad():
        got = nhwc(tm(nchw(x), diff_group))
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))), atol=ATOL, rtol=0)


@pytest.mark.parametrize("res_connect", [False, True])
@pytest.mark.parametrize("branch", ["spconv", "teconv"])
def test_branch_res_connect_matches_jax(branch, res_connect):
    """`res_connect` on the spatial and the temporal branch (the ablations
    `uavsal_spconv` and `uavsal_teconv` set it), and a branch of another
    width than its input, where no residual applies."""
    rng = np.random.RandomState(3)
    for cin in (C, 8):
        x = frames(4, c=cin)
        if branch == "spconv":
            jm = jst.SpConv(C, res_connect=res_connect)
            tm = tst.SpConv(cin, C, res_connect=res_connect)
            rows = convert._dwblock(("spconv",), "m.spconv")
        else:
            jm = jst.TeConvSub(C, T, REDUCTION, res_connect=res_connect)
            tm = tst.TeConvSub(cin, C, REDUCTION, res_connect=res_connect)
            rows = convert._teconv((), "m")
        v = jax_init(jm, x, rng)
        load(tm, v, rows)
        with torch.no_grad():
            got = nhwc(tm(nchw(x)))
        want = np.asarray(jm.apply(v, jnp.asarray(x)))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        if res_connect and cin == C:  # the residual is there: x plus the plain branch
            plain = jm.clone(res_connect=False).apply(v, jnp.asarray(x))
            np.testing.assert_allclose(got - x, np.asarray(plain), atol=ATOL, rtol=0)


@pytest.mark.parametrize("block", ["stc3d", "stc2_3d"])
def test_fold_conv3d_bn_equals_unfolded(block):
    """`fold_conv_bn` folds ConvBNAct3D's BatchNorm into its Conv3d (and
    STC23D's 2-D pairs) and leaves the block's output as it was."""
    torch.manual_seed(5)
    m = tst.STC3D(C, C, T) if block == "stc3d" else tst.STC23D(C, C, T)
    for bn in (mod for mod in m.modules() if isinstance(mod, tl.BatchNorm)):
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.normal_(0, 0.2)
            bn.running_mean.normal_(0, 0.2)
            bn.running_var.uniform_(0.5, 1.5)
    m.eval()
    x = nchw(frames(6))
    with torch.no_grad():
        want = m(x)
        tfold.fold_conv_bn(m)
        got = m(x)
    assert isinstance(m.stconv_te[1], torch.nn.Identity)
    assert not any(isinstance(mod, tl.BatchNorm) for mod in m.modules())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


def test_fold_batchnorm_3d_nodes_match_jax():
    """The numpy `fold_batchnorm` copy on a tree with ConvBNAct3D nodes
    (DHWIO kernels) and `looks_folded` on its state_dict, against the JAX
    fold: the same tree, leaf for leaf."""
    rng = np.random.RandomState(7)
    x = frames(8)
    jm = jst.STC23D(C, T)
    v = jax_init(jm, x, rng)
    want = jfold.fold_batchnorm(v)
    got = tfold.fold_batchnorm(v)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, a), (_, b) in zip(flat_w, flat_g):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=str(path))
    assert got["params"]["stconv_te"]["conv"]["kernel"].ndim == 5
    rows = convert._st_block((), "m", "stc2_3d")
    assert tfold.looks_folded(convert.from_jax_variables(got, rows))
    assert not tfold.looks_folded(convert.from_jax_variables(v, rows))
    folded = load(tst.STC23D(C, C, T), got, rows)
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(folded(nchw(x))), np.asarray(jm.apply(v, jnp.asarray(x))),
                                   atol=ATOL, rtol=0)
