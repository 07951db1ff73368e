"""The port's fused dwBlock (plain version, module gate, gradients) against
the JAX package on the CPU. The CUDA kernel itself is held against the
plain version on the card by tests/test_torch_kernels_gpu.py."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iip_uavsal_saliency_tpu.ops.pallas_dwblock as jdw
from iip_uavsal_saliency_tpu.ops import fold as jfold
from iip_uavsal_saliency_tpu.ops import layers as jl
from iip_uavsal_saliency_tpu_torch import kernels
from iip_uavsal_saliency_tpu_torch.models import convert
from iip_uavsal_saliency_tpu_torch.models.uavsal import UAVSal
from iip_uavsal_saliency_tpu_torch.ops import dwblock as tdw
from iip_uavsal_saliency_tpu_torch.ops import layers as tl
from iip_uavsal_saliency_tpu_torch.ops.fold import fold_conv_bn
from test_torch_train_step import few_threads  # noqa: F401

# f32 on the CPU: XLA and torch sum the C, 9 and E products in other orders
ATOL = 2e-5


def _case(n=2, h=12, w=16, c=64, expand=6, co=64, seed=0):
    """The inputs of tests/test_pallas_dwblock.py::_case, as numpy."""
    def r(shape, sd, scale=0.5):
        return np.random.RandomState(sd).randn(*shape).astype(np.float32) * scale
    e = c * expand
    return (r((n, h, w, c), seed), r((c, e), seed + 1, 0.1), r((e,), seed + 2),
            r((3, 3, e), seed + 3, 0.3), r((e,), seed + 4), r((e, co), seed + 5, 0.05),
            r((co,), seed + 6))


CASES = {
    "residual": (dict(), True),
    "co_differs": (dict(co=32, seed=7), False),
    "chunked_expand": (dict(c=128, co=128, seed=11), True),  # E = 768
}


@pytest.fixture
def pallas_interpret():
    """The JAX kernel in interpreter mode, set and restored here."""
    jdw.INTERPRET = True
    yield
    jdw.INTERPRET = False


@pytest.mark.parametrize("oracle", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dwblock_ref_matches_jax(case, oracle):
    kwargs, residual = CASES[case]
    arrays = _case(**kwargs)
    jargs = [jnp.asarray(a) for a in arrays]
    if oracle == "xla":
        want = jdw.dwblock_ref(*jargs, residual)
    else:
        want = jdw.fused_dwblock_pallas(*jargs, residual, interpret=True)
    targs = [torch.from_numpy(a) for a in arrays]
    got = tdw.dwblock_ref(*targs, residual)
    # CPU tensors take the plain version, through either wrapper
    torch.testing.assert_close(tdw.fused_dwblock_kernel(*targs, residual), got, atol=0, rtol=0)
    torch.testing.assert_close(tdw.fused_dwblock(*targs, residual), got, atol=0, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_dwblock_ref_bf16_rounds_where_jax_does():
    """bf16 in, bf16 out, e and d rounded to bf16: the two plain versions
    differ only where f32 sums that differ in their last bits round to the
    other neighbour, one bf16 ulp (2^-5 below 8)."""
    arrays = _case(seed=41)
    want = jdw.dwblock_ref(*[jnp.asarray(a).astype(jnp.bfloat16) for a in arrays], True)
    got = tdw.dwblock_ref(*[torch.from_numpy(a).bfloat16() for a in arrays], True)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    assert np.abs(want).max() < 8
    diff = np.abs(got.float().numpy() - want)
    assert diff.max() <= 2.0 ** -5 and (diff > 0).mean() < 0.01


def _jax_block(c, co, x, rng, **kw):
    from test_torch_layers import dwblock_state_dict, jax_init
    jm = jl.DWBlock(co, 3, use_pallas=True, **kw)
    v = jax_init(jl.DWBlock(co, 3, **kw), x, rng)
    return jm, v, dwblock_state_dict


@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
@pytest.mark.parametrize("c,co,res_connect", [(64, 64, None), (64, 128, None), (128, 128, False)],
                         ids=["residual", "co_differs", "residual_off"])
def test_dwblock_use_kernel_matches_jax_use_pallas(pallas_interpret, c, co, res_connect, folded):
    """`DWBlock(use_kernel=True)` against the JAX `DWBlock(use_pallas=True)`
    running its Pallas kernel in interpreter mode, in bf16 (the JAX gate
    admits nothing else). Both round e and d to bf16, so on folded weights
    they differ by single roundings: one bf16 ulp of the output (2^-5 below
    8) on under 1% of the elements. Unfolded, the JAX block folds BatchNorm
    in bf16 arithmetic and the port in f32 before it rounds, so the weights
    themselves differ by an ulp and most outputs move, by at most two ulps."""
    rng = np.random.RandomState(c + co)
    x = rng.randn(2, 12, 16, c).astype(np.float32)
    jm, v, state_dict = _jax_block(c, co, x, rng, res_connect=res_connect)
    tm = tl.DWBlock(c, co, 3, res_connect=res_connect, use_kernel=True).eval()
    plain = tl.DWBlock(c, co, 3, res_connect=res_connect).eval()
    assert list(tm.state_dict()) == list(plain.state_dict())  # same keys on both paths
    if folded:
        v = jax.tree_util.tree_map(np.asarray, jfold.fold_batchnorm(v))
    tm.load_state_dict(state_dict(v, 6), strict=True)
    plain.load_state_dict(state_dict(v, 6), strict=True)
    if folded:
        fold_conv_bn(tm)
        fold_conv_bn(plain)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    assert jm._fused_path(xb, False, True, tm.use_res)
    vb = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), v)
    want = np.asarray(jm.apply(vb, xb).astype(jnp.float32))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16()
    assert tm.takes_kernel(xt.shape, xt.dtype)
    with torch.no_grad():
        # in f32 the fused path computes what the three convs compute
        plain_out = plain(torch.from_numpy(x).permute(0, 3, 1, 2))
        fused_out = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
        got = tm.bfloat16()(xt)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, co, 12, 16)
        got = got.permute(0, 2, 3, 1).float().numpy()
    assert np.abs(want).max() < 8
    diff = np.abs(got - want)
    if folded:
        assert diff.max() <= 2.0 ** -5 and (diff > 0).mean() < 0.01
    else:
        assert diff.max() <= 2.0 ** -4
    torch.testing.assert_close(fused_out, plain_out, atol=ATOL, rtol=0)


@pytest.mark.parametrize("packed", [False, True], ids=["packed_on_the_fly", "packed_at_load"])
def test_bf16_dwblock_with_packed_weights_matches_jax_use_pallas(pallas_interpret, packed):
    """`DWBlock(use_kernel=True)` in bf16 on folded weights, with the kernel
    weights packed by `pack` (serving) or not, against the JAX block running
    its Pallas kernel in interpreter mode: one bf16 ulp of the output on
    under 1% of the elements, as above. On the CPU the plain weights are
    what is read; the packed layout is carried beside them."""
    c = co = 64
    rng = np.random.RandomState(17)
    x = rng.randn(2, 12, 16, c).astype(np.float32)
    jm, v, state_dict = _jax_block(c, co, x, rng)
    v = jax.tree_util.tree_map(np.asarray, jfold.fold_batchnorm(v))
    tm = tl.DWBlock(c, co, 3, use_kernel=True).eval()
    tm.load_state_dict(state_dict(v, 6), strict=True)
    fold_conv_bn(tm)
    tm.bfloat16()
    if packed:
        tm.pack(torch.bfloat16)
    with torch.no_grad():  # with a gradient wanted, the weights are packed on the fly
        weights, blobs = tm.kernel_weights(torch.bfloat16)
        assert (blobs is not None) == packed
        if packed:
            assert weights is tm.packed_weights(torch.bfloat16)
            for got, want in zip(blobs, tdw.pack_dwblock_weights(*weights[:5])):
                assert torch.equal(got, want)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    vb = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), v)
    want = np.asarray(jm.apply(vb, xb).astype(jnp.float32))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16())
    diff = np.abs(got.permute(0, 2, 3, 1).float().numpy() - want)
    assert np.abs(want).max() < 8
    assert diff.max() <= 2.0 ** -5 and (diff > 0).mean() < 0.01


def _unpack(w1_blob, w2_blob, c, e, co):
    """The inverse of `pack_dwblock_weights`, from its docstring: W1, W2 and
    the (11, E) rows b1, bd, taps, each packed piece read back by index."""
    cp, ep = -(-c // 16) * 16, -(-e // 64) * 64
    nq = ep // 64
    w1 = w1_blob.reshape(nq, cp // 8, 64, 8).permute(1, 3, 0, 2).reshape(cp, ep)
    per_chunk = w2_blob.reshape(nq, -1)
    w2, vectors, at = [], [], 0
    for co0 in range(0, co, 256):
        rows = min(256, co - co0)
        w2.append(per_chunk[:, at:at + 64 * rows].reshape(nq, 8, rows, 8).permute(0, 1, 3, 2)
                  .reshape(ep, rows))
        at += 64 * rows
        vectors.append(per_chunk[:, at:at + 11 * 64].reshape(nq, 11, 64).permute(1, 0, 2)
                       .reshape(11, ep))
        at += 11 * 64
    assert at == per_chunk.shape[1]
    return w1, torch.cat(w2, dim=1), vectors


# (C, E, Co) of the admitted blocks' widths: K padded to 16 (C=24), a ragged
# last E chunk (E=144), Co != C (64->96, 160->320, 320->256), Co over two
# column blocks (320), the widest C.
PACK_WIDTHS = {"c24": (24, 144, 24), "c24_to_16": (24, 144, 16), "c32": (32, 192, 32),
               "c64": (64, 384, 64), "c64_to_96": (64, 384, 96), "c96": (96, 576, 96),
               "c160": (160, 960, 160), "c160_to_320": (160, 960, 320),
               "c256": (256, 1536, 256), "c320_to_256": (320, 1920, 256),
               "c352": (352, 2112, 352),
               # ob_cb_layer.0: C % 8 != 0, refused by the gate but packed at load
               "c20_to_64": (20, 120, 64)}


@pytest.mark.parametrize("name", sorted(PACK_WIDTHS))
def test_pack_dwblock_weights_unpacks_exactly(name):
    c, e, co = PACK_WIDTHS[name]
    rng = np.random.RandomState(c + e + co)
    w1, b1, wd, bd, w2 = (torch.from_numpy(rng.randn(*s).astype(np.float32)).bfloat16()
                          for s in ((c, e), (e,), (3, 3, e), (e,), (e, co)))
    w1_blob, w2_blob = tdw.pack_dwblock_weights(w1, b1, wd, bd, w2)
    assert (w1_blob.numel(), w2_blob.numel()) == tdw.packed_sizes(c, e, co)
    assert w1_blob.is_contiguous() and w2_blob.is_contiguous()
    got_w1, got_w2, vectors = _unpack(w1_blob, w2_blob, c, e, co)
    assert torch.equal(got_w1[:c, :e], w1) and torch.equal(got_w2[:e], w2)
    for v in vectors:  # every column block carries the chunk's vectors
        assert torch.equal(v[:, :e], torch.cat([b1[None], bd[None], wd.reshape(9, e)]))
    # the padding the kernel relies on instead of masks is zero
    assert not got_w1[c:].any() and not got_w1[:, e:].any() and not got_w2[e:].any()
    assert not any(v[:, e:].any() for v in vectors)
    # a bulk copy of W1 is SLICE_ROWS rows of one chunk, 8 planes of 64 x 16 bytes
    assert tdw.SLICE_ROWS // tdw.PLANE * tdw.CHUNK * tdw.PLANE * 2 == 8192


def _unpack_f32(w1_blob, w2_blob, c, e, co):
    """The inverse of the f32 `pack_dwblock_weights`, from its docstring: the
    (big, small) halves of W1 (2, C', E') and W2 (2, E', Co), and per column
    block the (11, E') rows b1, bd, taps, each packed piece read back by
    index (C' is C padded to a multiple of 8, E' E to chunks of 64)."""
    cp, ep = -(-c // 8) * 8, -(-e // 64) * 64
    nq = ep // 64
    # [q][s][h][p][n][k] is half h of W1[8s + 2k + p, 64q + n]
    w1 = w1_blob.reshape(nq, cp // 8, 2, 2, 64, 4).permute(2, 1, 5, 3, 0, 4).reshape(2, cp, ep)
    per_chunk = w2_blob.reshape(nq, -1)
    w2, vectors, at = [], [], 0
    for co0 in range(0, co, 256):
        rows = min(256, co - co0)
        # [q][h][plane 2j + p][n][k] is half h of W2[64q + 8j + 2k + p, co0 + n]
        piece = per_chunk[:, at:at + 2 * 64 * rows].reshape(nq, 2, 8, 2, rows, 4)
        w2.append(piece.permute(1, 0, 2, 5, 3, 4).reshape(2, ep, rows))
        at += 2 * 64 * rows
        vectors.append(per_chunk[:, at:at + 11 * 64].reshape(nq, 11, 64).permute(1, 0, 2)
                       .reshape(11, ep))
        at += 11 * 64
    assert at == per_chunk.shape[1]
    return w1, torch.cat(w2, dim=2), vectors


@pytest.mark.parametrize("name", sorted(PACK_WIDTHS))
def test_pack_dwblock_weights_f32_unpacks_exactly(name):
    """The f32 blobs hold each weight's two TF32 halves where the kernel
    reads them, up to C = 352, and zeros in the padding of E."""
    c, e, co = PACK_WIDTHS[name]
    rng = np.random.RandomState(c + e + co + 1)
    w1, b1, wd, bd, w2 = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                          for s in ((c, e), (e,), (3, 3, e), (e,), (e, co)))
    w1_blob, w2_blob = tdw.pack_dwblock_weights(w1, b1, wd, bd, w2)
    assert w1_blob.dtype == w2_blob.dtype == torch.float32
    assert (w1_blob.numel(), w2_blob.numel()) == tdw.packed_sizes(c, e, co, torch.float32)
    assert w1_blob.is_contiguous() and w2_blob.is_contiguous()
    got_w1, got_w2, vectors = _unpack_f32(w1_blob, w2_blob, c, e, co)
    for got, want in ((got_w1[:, :c, :e], w1), (got_w2[:, :e], w2)):
        big, small = tdw.tf32_split(want)
        assert torch.equal(got[0], big) and torch.equal(got[1], small)
    assert not got_w1[:, c:].any() and not got_w1[:, :, e:].any() and not got_w2[:, e:].any()
    for v in vectors:  # every column block carries the chunk's vectors, in channel order
        assert torch.equal(v[:, :e], torch.cat([b1[None], bd[None], wd.reshape(9, e)]))
        assert not v[:, e:].any()
    # a W1 slice is one k8 step of both halves: 8 rows x 64 columns x 2 x 4 bytes
    assert tdw.F32_SLICE_ROWS * tdw.CHUNK * 2 * 4 == 4096
    assert tdw.F32_K_STEP == 2 * tdw.F32_PLANE == tdw.F32_SLICE_ROWS


def _tf32_split_cases():
    rng = np.random.RandomState(3)
    mags = 10.0 ** rng.uniform(-30, 30, 4000)
    w = (rng.choice([-1.0, 1.0], 4000) * mags).astype(np.float32)
    # exact ties of the first rounding (bit 12 set, bits 0-11 clear), both signs, and 0;
    # above 2^-96, where w - big is a normal f32 (TF32 keeps no bits below 2^-126)
    bits = (rng.randint(0x0f800000, 0x7f000000, 200, dtype=np.int64) & ~0x1fff) | 0x1000
    ties = bits.astype(np.uint32).view(np.float32)
    return np.concatenate([w, ties, -ties, np.zeros(1, np.float32)])


def test_tf32_split_reconstructs_each_weight_within_2_pow_minus_22():
    """big and small are TF32 values (the low 13 mantissa bits zero), big is
    w rounded to nearest with ties away from zero, and big + small is w
    within 2^-22 of |w| (for |w| above 2^-96, as every weight is)."""
    w = _tf32_split_cases()
    big, small = tdw.tf32_split(torch.from_numpy(w))
    for half in (big, small):
        assert half.dtype == torch.float32
        assert not (half.numpy().view(np.uint32) & 0x1fff).any()
    w64 = w.astype(np.float64)
    # rounded to nearest at 10 mantissa bits, ties away from zero, in f64
    exp = np.floor(np.log2(np.where(w64 == 0, 1.0, np.abs(w64))))
    ulp = 2.0 ** (exp - 10)
    want_big = np.sign(w64) * np.floor(np.abs(w64) / ulp + 0.5) * ulp
    np.testing.assert_array_equal(big.numpy().astype(np.float64), want_big)
    err = np.abs(w64 - big.numpy().astype(np.float64) - small.numpy().astype(np.float64))
    assert (err <= 2.0 ** -22 * np.abs(w64)).all()
    assert err.max() > 0  # the dropped bits are real: small is rounded too


def test_three_tf32_products_hold_an_f32_dot_product():
    """The f32 kernel's sum small.big + big.small + big.big over a K of 1536
    (the flagship project), computed exactly in f64 from the halves: within
    4 * 2^-22 of sum |x||w| of the exact dot product, far inside the f32
    kernel check's 2e-5 on outputs of order 1 to 8."""
    rng = np.random.RandomState(11)
    x = rng.uniform(0, 6, (64, 1536)).astype(np.float32)  # d after ReLU6
    w = (rng.randn(1536, 32) * np.sqrt(1.0 / 1536)).astype(np.float32)
    xb, xs = (t.numpy().astype(np.float64) for t in tdw.tf32_split(torch.from_numpy(x)))
    wb, ws = (t.numpy().astype(np.float64) for t in tdw.tf32_split(torch.from_numpy(w)))
    exact = x.astype(np.float64) @ w.astype(np.float64)
    three = xs @ wb + xb @ ws + xb @ wb
    scale = np.abs(x.astype(np.float64)) @ np.abs(w.astype(np.float64))
    assert (np.abs(three - exact) <= 4 * 2.0 ** -22 * scale).all()
    assert np.abs(three - exact).max() < 1e-5
    one = xb @ wb  # plain TF32 would not hold the check
    assert np.abs(one - exact).max() > 2e-5


def test_packed_f32_weights_are_cached_until_a_weight_changes():
    """`pack(torch.float32)` makes the f32 kernel's blobs once, from exactly
    the folded weights it keeps; a load or a cast drops them; without `pack`,
    and whenever a gradient is wanted, there are none and the kernel's
    wrapper packs on the fly."""
    tm = tl.DWBlock(8, 8, 3, use_kernel=True).eval()
    with torch.no_grad():
        assert tm.kernel_weights(torch.float32)[1] is None
        tm.pack(torch.float32)
        weights, blobs = tm.kernel_weights(torch.float32)
        assert weights is tm.packed_weights(torch.float32) and blobs is not None
        for got, want in zip(blobs, tdw.pack_dwblock_weights(*weights[:5])):
            assert got.dtype == torch.float32 and torch.equal(got, want)
        assert tm.kernel_weights(torch.float32)[1] is blobs
        assert tm.kernel_weights(torch.bfloat16)[1] is None  # not the dtype packed
        tm.load_state_dict(tm.state_dict())
        assert tm._blobs is None and tm.kernel_weights(torch.float32)[1] is None
        tm.pack(torch.float32)
        tm.double()
        assert tm._blobs is None
        tm.float().pack(torch.float32)
        assert tm.kernel_weights(torch.float32)[1] is not None
    weights, blobs = tm.kernel_weights(torch.float32)  # a gradient is wanted
    assert weights[0].requires_grad and blobs is None


@pytest.mark.parametrize("packed", [False, True], ids=["packed_on_the_fly", "packed_at_load"])
def test_f32_dwblock_with_packed_weights_matches_jax(packed):
    """`DWBlock(use_kernel=True)` in f32 on folded weights, with the f32
    kernel's blobs made by `pack` or not, against the JAX block in f32 (its
    Pallas gate admits only bf16, so XLA's three convs): the same function
    within the sum-order tolerance. On the CPU the plain weights are read."""
    c = co = 64
    rng = np.random.RandomState(19)
    x = rng.randn(2, 12, 16, c).astype(np.float32)
    jm, v, state_dict = _jax_block(c, co, x, rng)
    v = jax.tree_util.tree_map(np.asarray, jfold.fold_batchnorm(v))
    tm = tl.DWBlock(c, co, 3, use_kernel=True).eval()
    tm.load_state_dict(state_dict(v, 6), strict=True)
    fold_conv_bn(tm)
    if packed:
        tm.pack(torch.float32)
    with torch.no_grad():
        assert (tm.kernel_weights(torch.float32)[1] is not None) == packed
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=ATOL, rtol=0)


def test_fused_dwblock_grads_match_jax(pallas_interpret):
    """Gradients of a sum of squares for all 7 arguments against `jax.grad`
    through the JAX `fused_dwblock` (tests/test_pallas_dwblock.py:87-105)."""
    arrays = _case(n=1, h=6, w=8, c=32, expand=6, co=32, seed=31)
    want = jax.grad(lambda *a: jnp.sum(jdw.fused_dwblock(*a, True) ** 2),
                    argnums=tuple(range(7)))(*[jnp.asarray(a) for a in arrays])
    targs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    (tdw.fused_dwblock(*targs, True) ** 2).sum().backward()
    for t, g in zip(targs, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=2e-4, atol=2e-4)


def test_fused_dwblock_skips_gradients_not_wanted():
    arrays = _case(n=1, h=4, w=5, c=8, co=8, seed=3)
    targs = [torch.from_numpy(a) for a in arrays]
    targs[0].requires_grad_()
    targs[5].requires_grad_()
    (tdw.fused_dwblock(*targs, True) ** 2).sum().backward()
    assert [t.grad is not None for t in targs] == [True, False, False, False, False, True, False]


def test_gradient_reaches_block_parameters_through_use_kernel():
    rng = np.random.RandomState(5)
    tm = tl.DWBlock(16, 16, 3, use_kernel=True).eval()
    plain = tl.DWBlock(16, 16, 3).eval()
    plain.load_state_dict(tm.state_dict())
    x = torch.from_numpy(rng.randn(1, 16, 5, 6).astype(np.float32))
    assert tm.takes_kernel(x.shape, x.dtype)
    (tm(x) ** 2).sum().backward()
    (plain(x) ** 2).sum().backward()
    for (name, p), q in zip(tm.named_parameters(), plain.parameters()):
        assert p.grad is not None, name
        torch.testing.assert_close(p.grad, q.grad, rtol=2e-4, atol=2e-4)


def test_packed_weights_are_cached_until_a_weight_changes():
    """Packed once by `pack` (serving); dropped by a load or a cast; without
    `pack`, and whenever a gradient is wanted, made from the weights as they
    are."""
    tm = tl.DWBlock(8, 8, 3, use_kernel=True).eval()
    with torch.no_grad():
        first = tm.packed_weights(torch.float32)
        tm.conv[2].weight.mul_(2.0)
        torch.testing.assert_close(tm.packed_weights(torch.float32)[4], 2.0 * first[4])
        tm.pack(torch.float32)
        packed = tm.packed_weights(torch.float32)
        assert tm.packed_weights(torch.float32) is packed
        assert tm.packed_weights(torch.bfloat16)[0].dtype == torch.bfloat16
        tm.load_state_dict(tm.state_dict())
        assert tm.packed_weights(torch.float32) is not packed
        tm.pack(torch.float32)
        tm.bfloat16()
        assert tm._packed is None and tm.packed_weights(torch.bfloat16)[0].dtype == torch.bfloat16
        tm.float().pack(torch.float32)
    assert tm.packed_weights(torch.float32)[0].requires_grad  # on the fly for a gradient
    tl.DWBlock(8, 8, 3, expand_ratio=1, use_kernel=True).pack(torch.float32)  # nothing to pack


FLAGSHIP = (20, 45, 80, 256)


@pytest.mark.parametrize("shape,args,want", [
    (FLAGSHIP, (torch.bfloat16, 3, 1, 1, 6, 256), True),            # st_layer.*.spconv
    (FLAGSHIP, (torch.bfloat16, 3, 1, 1, 6, 256, True), True),      # fust_layer.0
    ((20, 45, 80, 320), (torch.bfloat16, 3, 1, 1, 6, 256), True),   # fucbst_layer.0
    (FLAGSHIP, (torch.float32, 3, 1, 1, 6, 256), True),             # f32 serving
    ((20, 45, 80, 64), (torch.bfloat16, 3, 1, 1, 6, 32), True),     # sub_conv
    ((1, 13, 7, 24), (torch.float32, 3, 1, 1, 6, 16), True),        # ragged, narrow
    (FLAGSHIP, (torch.bfloat16, 3, 1, 1, 6, 1), False),             # head: Co = 1
    (FLAGSHIP, (torch.bfloat16, 3, 2, 1, 6, 64), False),            # cxt_cb_prior: stride 2
    ((20, 12, 20, 320), (torch.bfloat16, 3, 1, 6, 6, 256), False),  # ASPP: dilated
    ((20, 180, 320, 32), (torch.bfloat16, 3, 1, 1, 1, 16), False),  # features.1: no expand
    ((1, 45, 80, 20), (torch.bfloat16, 3, 1, 1, 6, 64), False),     # ob_cb_layer.0: C % 8
    (FLAGSHIP, (torch.float16, 3, 1, 1, 6, 256), False),
    (FLAGSHIP, (torch.bfloat16, 5, 1, 1, 6, 256), False),
    ((20, 45, 80, 360), (torch.bfloat16, 3, 1, 1, 6, 256), False),  # x tile > shared memory
    ((20, 45, 80, 256), (torch.bfloat16, 3, 1, 1, 6, 128, True), False),  # residual, Co != C
])
def test_supports_gate(shape, args, want):
    assert tdw.supports_fused_dwblock(shape, *args) is want


def test_kernel_shared_memory_fits_the_flagship_blocks():
    """The gate's width limit is the kernel's own constant, which the source
    holds against its shared-memory layout with a `static_assert`."""
    source = (kernels.CSRC / "dwblock.cu").read_text()
    assert int(re.search(r"constexpr int MAX_C = (\d+);", source).group(1)) == tdw.MAX_C
    assert "smem_bytes(MAX_C) <= SMEM_LIMIT" in source
    assert tdw.MAX_C >= 320  # fucbst_layer.0, the widest block of the flagship
    for dtype in (torch.bfloat16, torch.float32):
        assert tdw.supports_fused_dwblock((1, 4, 4, tdw.MAX_C), dtype, 3, 1, 1, 6, 8)
        assert not tdw.supports_fused_dwblock((1, 4, 4, tdw.MAX_C + 8), dtype, 3, 1, 1, 6, 8)


def test_flagship_model_admits_its_stride8_blocks():
    """`UAVSal(fused_dwblock=True)` at 360x640, S=20: which blocks the gate
    admits in eval mode, from their static facts and input shapes alone."""
    model = UAVSal(fused_dwblock=True).eval()
    blocks = {name: m for name, m in model.named_modules() if isinstance(m, tl.DWBlock)}
    assert all(m.use_kernel for m in blocks.values())
    assert not any(m.use_kernel for m in UAVSal().modules() if isinstance(m, tl.DWBlock))
    s8 = {"st_layer.0.stconv_sp.spconv": 256, "st_layer.1.stconv_sp.spconv": 256,
          "fust_layer.0": 256, "fucbst_layer.0": 320, "st_layer.0.stconv_te.sub_conv": 64,
          "gauss_cb_layer.1": 64, "fucb_layer.0": 192}
    for name, c in s8.items():
        assert blocks[name].takes_kernel((20, c, 45, 80), torch.bfloat16), name
    for name, shape in {"conv_out_st": (20, 256, 45, 80), "ob_cb_layer.0": (1, 20, 45, 80),
                        "cxt_cb_prior.0": (4, 256, 45, 80),
                        "sfnet.lv5_aspp2": (20, 320, 12, 20)}.items():
        assert not blocks[name].takes_kernel(shape, torch.bfloat16), name


def test_fused_model_packs_every_block_in_both_dtypes():
    """`DWBlock.pack` (which the baked serving step calls on every block
    with the kernel switched on, whether the gate admits it or not) packs
    each block of the flagship for both kernels; the blobs have the sizes
    the wrapper checks."""
    model = UAVSal(fused_dwblock=True).eval()
    blocks = [m for m in model.modules() if isinstance(m, tl.DWBlock) and len(m.conv) == 4]
    assert len(blocks) > 20
    for dtype in (torch.float32, torch.bfloat16):
        for m in blocks:
            m.pack(dtype)
            w1, _, _, _, w2, _ = m.packed_weights(dtype)
            sizes = tdw.packed_sizes(w1.shape[0], w1.shape[1], w2.shape[1], dtype)
            assert tuple(b.numel() for b in m._blobs) == sizes
            assert all(b.dtype == dtype for b in m._blobs)


def test_cpu_block_does_not_count_launches():
    kernels.reset_launches()
    tdw.fused_dwblock(*[torch.from_numpy(a) for a in _case(n=1, h=3, w=4, c=8, co=8)], True)
    assert kernels.launches["dwblock"] == 0


def test_fused_dwblock_rejects_other_devices():
    x = torch.empty(1, 3, 4, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tdw.fused_dwblock_kernel(x, *[torch.empty(s, device="meta") for s in
                                      ((8, 48), (48,), (3, 3, 48), (48,), (48, 8), (8,))], True)


def test_from_jax_variables_loads_into_fused_model():
    sd = UAVSal().state_dict()
    tree = convert.to_jax_variables(sd)
    UAVSal(fused_dwblock=True).load_state_dict(convert.from_jax_variables(tree), strict=True)
