"""The port's TWA scan and ConvTWA against the JAX package on the CPU.
The kernel itself is held against its plain version on the card by
tests/test_torch_kernels_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iip_uavsal_saliency_tpu.models.recurrent import ConvTWA as JConvTWA
from iip_uavsal_saliency_tpu.ops.pallas_twa import twa_scan_pallas, twa_scan_xla
from iip_uavsal_saliency_tpu_torch import kernels
from iip_uavsal_saliency_tpu_torch.models import recurrent
from iip_uavsal_saliency_tpu_torch.models.recurrent import ConvTWA
from iip_uavsal_saliency_tpu_torch.ops.twa import (clip_takes, kernel_route, twa_scan,
                                                    twa_scan_ref)
from test_torch_train_step import few_threads  # noqa: F401

# f32 on the CPU: XLA and torch sum the 9*C conv products in other orders
ATOL = 1e-5


def _case(v=2, s=4, h=12, w=8, c=8, seed=0):
    """The inputs of tests/test_pallas_twa.py::_case, as numpy."""
    def r(shape, sd):
        return (np.random.RandomState(sd).randn(*shape).astype(np.float32) * 0.5)
    return (r((v, s, h, w, c), seed), r((v, s, h, w, c), seed + 1),
            r((3, 3, c, c), seed + 2) * 0.2, r((v, h, w, c), seed + 3))


CASES = {
    "single_chunk": dict(h=6),
    "multi_chunk": dict(h=20, seed=7),     # row block 10 -> 2 chunks per step
    "three_videos": dict(v=3, seed=11),    # independent videos
}


@pytest.mark.parametrize("oracle", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_twa_scan_ref_matches_jax(case, oracle):
    arrays = _case(**CASES[case])
    jargs = [jnp.asarray(a) for a in arrays]
    if oracle == "xla":
        want_ys, want_last = twa_scan_xla(*jargs)
    else:
        want_ys, want_last = twa_scan_pallas(*jargs, interpret=True)
    targs = [torch.from_numpy(a) for a in arrays]
    ys, last = twa_scan_ref(*targs)
    for got, ref in zip(twa_scan(*targs), (ys, last)):  # CPU tensors take the plain version
        torch.testing.assert_close(got, ref, atol=0, rtol=0)
    np.testing.assert_allclose(ys.numpy(), np.asarray(want_ys), atol=ATOL, rtol=0)
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last), atol=ATOL, rtol=0)


@pytest.mark.parametrize("v,s", [(1, 5), (2, 3)])
def test_conv_twa_matches_jax(v, s, monkeypatch):
    """ConvTWA against the JAX module in f32 on the CPU, where the scan is
    the plain version and no weight is packed for the f32 kernel."""
    def refuse(w_h):
        raise AssertionError("W_h packed on the CPU")

    monkeypatch.setattr(recurrent, "pack_twa_weights", refuse)
    rng = np.random.RandomState(v * 10 + s)
    c, h, w = 8, 6, 7
    x = rng.randn(v, s, h, w, c).astype(np.float32)
    h0 = rng.randn(v, h, w, c).astype(np.float32)
    jm = JConvTWA(hidden_dim=c)
    kernel = (rng.randn(3, 3, 2 * c, c) * 0.15).astype(np.float32)
    want_ys, want_last = jm.apply({"params": {"kernel": jnp.asarray(kernel)}},
                                  jnp.asarray(x), jnp.asarray(h0))
    tm = ConvTWA(c)
    tm.load_state_dict({"cell_list.0.rnn_conv.weight":
                        torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())}, strict=True)
    with torch.no_grad():
        ys, last = tm(torch.from_numpy(x), torch.from_numpy(h0))
    np.testing.assert_allclose(ys.numpy(), np.asarray(want_ys), atol=ATOL, rtol=0)
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last), atol=ATOL, rtol=0)


def test_conv_twa_resplits_weight_after_load():
    tm = ConvTWA(8)
    with torch.no_grad():  # serving: no gradient wanted, the split is cached
        first = tm.split_weight()[1]
        assert tm.split_weight()[1] is first  # cached while the weight is unchanged
        tm.cell_list[0].rnn_conv.weight.mul_(2.0)
        torch.testing.assert_close(tm.split_weight()[1], 2.0 * first)
    assert tm.split_weight()[1].requires_grad  # made on the fly when a gradient is wanted


def test_twa_scan_grads_match_jax():
    """Gradients of a sum of squares of (ys, h_last) w.r.t. x, gx, W_h, h0
    against `jax.grad` through `twa_scan_xla`, f32 (the two frameworks sum
    the conv products and the chain over 3 frames in other orders)."""
    arrays = _case(v=2, s=3, h=6, w=5, c=8, seed=21)

    def loss(*a):
        ys, last = twa_scan_xla(*a)
        return jnp.sum(ys ** 2) + jnp.sum(last ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*[jnp.asarray(a) for a in arrays])
    targs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    ys, last = twa_scan(*targs)
    ((ys ** 2).sum() + (last ** 2).sum()).backward()
    for t, g in zip(targs, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=2e-4, atol=2e-5)


def test_gradient_reaches_conv_twa_gate_weight():
    rng = np.random.RandomState(4)
    tm = ConvTWA(8)
    x = torch.from_numpy(rng.randn(1, 3, 5, 4, 8).astype(np.float32))
    ys, last = tm(x, tm.init_state(5, 4))
    ((ys ** 2).sum() + last.sum()).backward()
    grad = tm.cell_list[0].rnn_conv.weight.grad
    assert grad is not None and grad.shape == (8, 16, 3, 3)
    assert grad[:, :8].abs().sum() > 0 and grad[:, 8:].abs().sum() > 0  # both halves


def test_cpu_scan_does_not_count_launches():
    kernels.reset_launches()
    arrays = [torch.from_numpy(a) for a in _case(v=1, s=3, h=5, w=4, c=8)]
    twa_scan(*arrays)
    assert kernels.launches["twa_scan"] == 0 and kernels.launches["twa_step"] == 0
    # a shape the persistent kernel would take on the card, on the CPU
    twa_scan(*[torch.from_numpy(a).bfloat16() for a in _case(v=1, s=2, h=3, w=4, c=32)])
    assert kernels.launches == {"twa_scan": 0, "twa_step": 0, "dwblock": 0}


def test_cpu_scan_traces_no_kernel_launches():
    """`traced_launches` reads a profiler trace; on the CPU it holds host
    events only, and none of them counts as a kernel's launch."""
    from torch.profiler import ProfilerActivity, profile

    arrays = [torch.from_numpy(a) for a in _case(v=1, s=3, h=5, w=4, c=8)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        twa_scan(*arrays)
    assert kernels.traced_launches(prof) == {"twa_scan": 0, "twa_step": 0, "dwblock": 0}


@pytest.mark.parametrize("traced, shows", [
    ({"twa_scan": 3, "twa_step": 0, "dwblock": 66}, True),
    ({"twa_scan": 3, "twa_step": 0, "dwblock": 65}, True),  # one record dropped
    ({"twa_scan": 2, "twa_step": 0, "dwblock": 44}, True),  # a replay's records dropped
    ({"twa_scan": 3, "twa_step": 0, "dwblock": 0}, False),  # K2 never ran
    ({"twa_scan": 0, "twa_step": 0, "dwblock": 66}, False),  # K1 never ran
    ({"twa_scan": 3, "twa_step": 0, "dwblock": 67}, False),  # more than 3 replays launch
    ({"twa_scan": 4, "twa_step": 0, "dwblock": 66}, False),
    ({"twa_scan": 3, "twa_step": 1, "dwblock": 66}, False),  # a kernel the graph has not
], ids=["exact", "drop1", "drop_replay", "k2none", "k1none", "extra", "k1extra", "other"])
def test_trace_shows_graph_reads_each_kernel_of_the_graph(traced, shows):
    """Three replays of a graph whose nodes launch K1 once and K2 22 times:
    the trace must show each of them, and no more than three replays'
    worth, and no other kernel; dropped records are not a failure."""
    per_replay = {"twa_scan": 1, "twa_step": 0, "dwblock": 22}
    assert kernels.trace_shows_graph(traced, per_replay, 3) == shows


@pytest.mark.parametrize("symbol, kernel", [
    ("_ZN43_GLOBAL__N__5031cd55_10_dwblock_cu_57aa294819dwblock_bf16_kernelEPK13__nv_bfloat16S2_",
     "dwblock"),
    ("_ZN43_GLOBAL__N__5031cd55_10_dwblock_cu_57aa294818dwblock_f32_kernelILi64EEEvPKfS3_",
     "dwblock"),
    ("_Z19twa_step_f32_kernelPKfS0_S0_S0_Pfiiii", "twa_step"),
    ("_ZN12_GLOBAL__N_120twa_step_bf16_kernelILi128EEEvPK13__nv_bfloat16S3_S3_S3_PS1_xxiiii",
     "twa_step"),
    ("_Z15twa_clip_kernelPK13__nv_bfloat16", "twa_scan"),
    ("void twa_clip_kernel(__nv_bfloat16 const*)", "twa_scan"),
    ("_Z22twa_step_kernel_helperv", None),
    ("_ZN2at6native29vectorized_elementwise_kernelILi4EEEvi", None),
], ids=["bf16", "f32-template", "k1-f32", "k1-template", "k1-clip", "demangled", "longer",
        "aten"])
def test_kernel_of_symbol_reads_mangled_names(symbol, kernel):
    """A CUDA graph's kernel nodes name their functions mangled (in the
    sources' anonymous namespace, with template arguments): each kernel's
    device function is found there, and a longer name or another library's
    kernel is not."""
    assert kernels.kernel_of_symbol(symbol) == kernel


def test_kernel_symbols_are_the_sources_device_functions():
    """The names `traced_launches` looks for are the `__global__` functions
    of the kernel sources, each counted for one kernel."""
    import re

    kernel = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")
    names = set()
    for source in kernels.SOURCES:
        names |= set(kernel.findall((kernels.CSRC / f"{source}.cu").read_text()))
    symbols = [sym for syms in kernels.SYMBOLS.values() for sym in syms]
    assert sorted(symbols) == sorted(names)
    assert set(kernels.SYMBOLS) == set(kernels.KERNELS)


# Which kernel a CUDA tensor of this shape and dtype launches: the persistent
# one takes bf16 with C a multiple of 32 when a tile of rows with its halo
# fits in shared memory beside the W_h slice; the per-frame one the rest.
ROUTE_SHAPES = {
    "flagship_45x80x256": ((45, 80, 256), "twa_scan"),
    "288x512_36x64x256": ((36, 64, 256), "twa_scan"),
    "ragged_13x7x24": ((13, 7, 24), "twa_step"),       # C % 32 != 0
}


@pytest.mark.parametrize("v", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", sorted(ROUTE_SHAPES))
def test_kernel_route(name, dtype, v):
    (h, w, c), bf16_route = ROUTE_SHAPES[name]
    want = bf16_route if dtype == torch.bfloat16 else "twa_step"  # f32: the 3xTF32 per-frame kernel
    assert kernel_route((v, 20, h, w, c), dtype) == want


@pytest.mark.parametrize("hwc,takes", [((45, 80, 256), True), ((36, 64, 256), True),
                                       ((7, 50, 64), True), ((2, 80, 256), True),
                                       ((4, 128, 256), True), ((4, 142, 256), True),
                                       ((4, 150, 256), False), ((4, 300, 64), False),
                                       ((4, 80, 320), False), ((4, 80, 24), False),
                                       ((90, 160, 256), False)])  # 720x1280 serving's state
def test_clip_takes(hwc, takes):
    """The persistent kernel's gate: C a multiple of 32 and one image row with
    its halo fits beside the W_h slice; what it refuses goes to the per-frame
    kernel. (The tile height is the kernel source's, and the tests on the
    card hold this gate against it.)"""
    h, w, c = hwc
    assert clip_takes(w, c) == takes
    route = kernel_route((1, 2, *hwc), torch.bfloat16)
    assert route == ("twa_scan" if takes else "twa_step")


@pytest.mark.parametrize("shape,dtype,error", [
    ((1, 2, 3, 4, 12), torch.float32, ValueError),       # C % 8 != 0
    ((1, 2, 3, 4, 12), torch.bfloat16, ValueError),
    ((1, 2, 3, 4, 8), torch.float16, TypeError),
    ((2, 3, 4, 8), torch.float32, ValueError),           # rank 4
    ((1, 0, 3, 4, 8), torch.float32, ValueError),        # no frame
    ((70000, 1, 3, 4, 8), torch.float32, ValueError),    # per-frame grid limit
], ids=["c12_f32", "c12_bf16", "f16", "rank4", "s0", "v70000"])
def test_kernel_route_raises_on_what_no_kernel_takes(shape, dtype, error):
    with pytest.raises(error):
        kernel_route(shape, dtype)


def test_kernel_route_persistent_takes_any_v():
    assert kernel_route((70000, 1, 3, 4, 32), torch.bfloat16) == "twa_scan"


def test_split_v_matches_jax_twa_scan_sharded():
    """`twa_scan_sharded` says that the scan is independent per video: the
    kernel runs unchanged on each V shard. The port's `twa_scan` on whole V
    and on x[:2], x[2:] concatenated against the JAX package's
    `twa_scan_sharded` under a 4-way data mesh (interpret mode, CPU devices,
    as tests/test_sharding.py runs it). f32; the frameworks sum the conv
    products in other orders."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    import iip_uavsal_saliency_tpu.ops.pallas_twa as ptwa
    from iip_uavsal_saliency_tpu.parallel import make_mesh

    arrays = _case(v=4, s=4, h=12, w=8, c=8, seed=7)
    mesh = make_mesh(n_data=4)
    data, rep = NamedSharding(mesh, P("data")), NamedSharding(mesh, P())
    x, gx, w_h, h0 = [jnp.asarray(a) for a in arrays]
    ptwa.INTERPRET = True
    try:
        want_ys, want_last = jax.jit(ptwa.twa_scan_sharded)(
            jax.device_put(x, data), jax.device_put(gx, data), jax.device_put(w_h, rep),
            jax.device_put(h0, data))
    finally:
        ptwa.INTERPRET = False
    tx, tgx, tw, th0 = [torch.from_numpy(a) for a in arrays]
    whole_ys, whole_last = twa_scan(tx, tgx, tw, th0)
    parts = [twa_scan(tx[i:i + 2], tgx[i:i + 2], tw, th0[i:i + 2]) for i in (0, 2)]
    split_ys = torch.cat([p[0] for p in parts])
    split_last = torch.cat([p[1] for p in parts])
    for got_ys, got_last in ((whole_ys, whole_last), (split_ys, split_last)):
        np.testing.assert_allclose(got_ys.numpy(), np.asarray(want_ys), atol=ATOL, rtol=0)
        np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last), atol=ATOL, rtol=0)
    torch.testing.assert_close(split_ys, whole_ys, atol=ATOL, rtol=0)


def test_twa_scan_rejects_other_devices():
    x = torch.empty(1, 2, 3, 4, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        twa_scan(x, x, torch.empty(3, 3, 8, 8, device="meta"),
                 torch.empty(1, 3, 4, 8, device="meta"))

