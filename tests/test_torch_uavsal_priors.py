"""The port's MultiPriors at all 8 `bias_type`s (gauss, ob, context, each
on or off) in the whole UAVSal, eval form, against the JAX model on the CPU
at 64x128, V=1, S=10 (two time_dims groups, so that the context stream's
tiling shows), f32, MobileNetV2 with one STBlock. Priors that are off are
passed as None to both packages. The train form is in
`tests/test_torch_uavsal_priors_train.py`; helpers and bounds in
`tests/test_torch_uavsal_configs.py`."""

import itertools

import pytest

from iip_uavsal_saliency_tpu_torch.models.uavsal import CB_OUPLANES
from test_torch_train_step import few_threads  # noqa: F401
from test_torch_uavsal_configs import (T, assert_close, assert_round_trip, clip, jax_config,
                                       port_model, run_both)

S = 2 * T
BIAS_TYPES = list(itertools.product((0, 1), repeat=3))
STREAMS = ("gauss_cb_layer", "ob_cb_layer", "cxt_cb_prior")


def cfg_of(bias_type):
    return ("mobilenet_v2", 1, bias_type, False)


def bt_id(bias_type):
    return "".join(map(str, bias_type))


def rows_seen(m):
    """{layer: rows of its input} for the first layer of each stream and
    `fucb_layer`, filled by the next forward."""
    rows = {}
    for name in STREAMS + ("fucb_layer",):
        layers = getattr(m, name, None)
        if layers is not None:
            layers[0].register_forward_pre_hook(
                lambda mod, inp, name=name: rows.__setitem__(name, inp[0].shape[0]))
    return rows


@pytest.mark.parametrize("bias_type", BIAS_TYPES, ids=bt_id)
def test_bias_type_eval_form_matches_jax(bias_type):
    """The layers the streams that are on need, and no others (none of
    `fucb`/`fucbst` with all off, `fucb`'s input width the sum of the
    enabled streams'); the eval form runs each stream once and `fucb` on
    one row without the context stream, on G = S / time_dims with it."""
    cfg = cfg_of(bias_type)
    jm, variables = jax_config(*cfg)
    assert_round_trip(cfg, variables)
    m = port_model(cfg, variables)
    for name, on in zip(STREAMS, bias_type):
        assert (getattr(m, name) is not None) == bool(on)
    assert hasattr(m, "fucb_layer") == hasattr(m, "fucbst_layer") == any(bias_type)
    if any(bias_type):
        width = m.fucb_layer[0].conv[0][0].in_channels
        assert width == sum(c for c, on in zip(CB_OUPLANES, bias_type) if on)
    rows = rows_seen(m)
    assert_close(*run_both(cfg, variables, jm, clip(7, bias_type, s=S), m))
    want = {name: 1 for name, on in zip(STREAMS[:2], bias_type) if on}
    if bias_type[2]:
        want["cxt_cb_prior"] = S // T
    if any(bias_type):
        want["fucb_layer"] = S // T if bias_type[2] else 1
    assert rows == want
