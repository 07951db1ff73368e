"""Runs on the ranks of a spatial mesh, for holding them against one process
(`parallel.spawn` a function of this module). The tests and `chip_smoke.py`
share it; it imports nothing of JAX, and a spawned rank imports it by name
from the parent's `sys.path` (`tests/_dp_runs.py` says why).

Each run takes whole arrays, as one process would take them; every rank
cuts them to its videos (`Mesh.videos`) and its band of their rows
(`Mesh.band`) and returns what it computed, on the host, with its mesh
coordinates, so that `assemble` can put the ranks' bands back together:

- `exchanges(group, cases)`: each case a dict with `"mesh"` (n_data,
  n_spatial), `"layer"` (one of `LAYERS`), `"height"` of the input map and
  `"seed"`: the layer on this rank's band against the layer on the whole
  map in f64 (f32 for the fused kernel's path), forward and the gradient of the input (every rank's loss is
  its band's share of sum(out * G)); returns the largest differences;
- `infer_clips(group, run)`: `make_infer_step(mesh=)` over `run["clips"]`
  clips of `run["x"]` from `run["state"]`; `run["model"]` are keyword
  arguments of `build_adapted_model`, `run["weights"]` a state_dict,
  `"dtype"` the model's ("float64" takes normalized frames), `"compute_dtype"`
  "bfloat16" to serve in bf16, `"device"` "cuda" for a rank on the card;
  returns per clip this rank's band of the saliency and of the state, the
  kernel launches and the DWBlock calls the fused kernel's gate admits (its
  launches where the fused dwBlock is on), and on the card the seconds and
  the peak of the rank's allocated memory;
- `run_jobs(group, jobs)`: a list of (name, argument) of these and of
  `tests/_dp_runs.py::train_steps` (whose runs take a `"mesh"`) in one
  spawn.

A run without a group (`group` None) is the one process itself.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from iip_uavsal_saliency_tpu_torch import kernels
from iip_uavsal_saliency_tpu_torch.models.adapters import build_adapted_model
from iip_uavsal_saliency_tpu_torch.ops.layers import ConvBNAct, DWBlock, S2DStem, band_conv
from iip_uavsal_saliency_tpu_torch.ops.resize import resize_bilinear_align_corners
from iip_uavsal_saliency_tpu_torch.parallel import RankGroup, spatial
from iip_uavsal_saliency_tpu_torch.parallel.mesh import Mesh, make_mesh
from iip_uavsal_saliency_tpu_torch.serving.steps import make_infer_step

_meshes: Dict[Tuple[int, int], Mesh] = {}


def mesh_of(group: RankGroup, shape) -> Mesh:
    """The mesh of (n_data, n_spatial), made once a spawn (every rank makes
    the meshes of a spawn in the same order)."""
    key = tuple(shape)
    if key not in _meshes:
        _meshes[key] = make_mesh(group, *key)
    return _meshes[key]


def coords(mesh: Optional[Mesh]) -> Optional[Tuple[int, int]]:
    return None if mesh is None or not mesh.active else (mesh.data.rank, mesh.spatial.rank)


def assemble(results: List[Dict[str, Any]], key: str, index: int, row_axis: int) -> np.ndarray:
    """The whole array of `results[r][key][index]` over the ranks: bands
    joined along `row_axis` in spatial order, then videos along axis 0 in
    data order (idle ranks left out)."""
    active = [r for r in results if r["coords"] is not None]
    n_data = 1 + max(r["coords"][0] for r in active)
    rows = []
    for d in range(n_data):
        bands = sorted((r for r in active if r["coords"][0] == d), key=lambda r: r["coords"][1])
        rows.append(np.concatenate([r[key][index] for r in bands], axis=row_axis))
    return np.concatenate(rows, axis=0)


# (name, maker of the layer, the output's rows for an input of `height`);
# the flagship's geometries: 1x1, 3x3 at stride 1 and 2, the ASPP's
# dilations, the S2D stem, a DWBlock through the fused kernel's path, and
# the align-corners resizes up to a band of 4 and 2 times the rows
def _conv(k, s, d, groups=1):
    return lambda: torch.nn.Conv2d(4, 4, k, s, d * (k - 1) // 2, d, groups=groups, bias=False)


LAYERS = {
    "conv1x1": _conv(1, 1, 1),
    "conv3x3": _conv(3, 1, 1),
    "conv3x3_stride2": _conv(3, 2, 1),
    "depthwise_dilation6": _conv(3, 1, 6, groups=4),
    "depthwise_dilation12": _conv(3, 1, 12, groups=4),
    "depthwise_dilation18": _conv(3, 1, 18, groups=4),
    "s2d_stem": lambda: S2DStem(4, 4),
    "dwblock_kernel_path": lambda: DWBlock(8, 8, 3, use_kernel=True),
    "resize_x2": None,
    "resize_x4": None,
    "gather_rows": None,
}


def _layer_output(name, layer, x, height):
    """(output, the output's rows in the whole map) of the named layer on x
    (a band inside `spatial.over`, else the whole map of `height` rows)."""
    banded = spatial.current() is not None
    if name.startswith("resize"):
        out_h = (2 if name == "resize_x2" else 4) * height - 1
        return resize_bilinear_align_corners(x, out_h, x.shape[-1],
                                             height=height if banded else None), out_h
    if name == "gather_rows":
        return (spatial.gather_rows(x, height) if banded else x), height
    if isinstance(layer, (DWBlock, ConvBNAct)):
        out = layer(x, height=height) if banded else layer(x)
        rows = layer.out_height(height) if isinstance(layer, DWBlock) else height // 2
        return out, rows
    if banded:
        return band_conv(layer, x, height)
    return layer(x), spatial.conv_rows(height, layer.kernel_size[0], layer.stride[0],
                                       layer.dilation[0], layer.padding[0])


def exchanges(group: RankGroup, cases: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    out = []
    for case in cases:
        mesh = mesh_of(group, case["mesh"])
        if not mesh.active:
            out.append({"case": case, "coords": None})
            continue
        name, height = case["layer"], case["height"]
        gen = torch.Generator().manual_seed(case["seed"])
        layer = LAYERS[name]() if LAYERS[name] is not None else None
        # the fused kernel's path takes bf16 or f32 only
        dtype = torch.float32 if name == "dwblock_kernel_path" else torch.float64
        if layer is not None:
            layer = layer.to(dtype).eval()
            with torch.no_grad():
                for p in layer.parameters():
                    p.copy_(torch.randn(p.shape, generator=gen, dtype=dtype))
        width = 8 if name == "dwblock_kernel_path" else 4
        x = torch.randn((2, width, height, 6), generator=gen, dtype=dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        whole_x = x.clone().requires_grad_(True)
        whole, out_h = _layer_output(name, layer, whole_x, height)
        g = torch.randn(whole.shape, generator=gen, dtype=dtype)
        (whole * g).sum().backward()
        axis = mesh.spatial
        lo, hi = spatial.owned(height, axis.world, axis.rank)
        xb = x[:, :, lo:hi].detach().clone().requires_grad_(True)
        with spatial.over(axis):
            yb, _ = _layer_output(name, layer, xb, height)
        if name == "gather_rows":
            want, gb = whole, g
        else:
            olo, ohi = spatial.owned(out_h, axis.world, axis.rank)
            want, gb = whole[:, :, olo:ohi], g[:, :, olo:ohi]
        with spatial.over(axis):
            (yb * gb).sum().backward()
        out.append({"case": case, "coords": coords(mesh), "rows": hi - lo,
                    "out_rows": yb.shape[2],
                    "forward": (yb - want).abs().max().item() if yb.numel() else 0.0,
                    "backward": ((xb.grad - whole_x.grad[:, :, lo:hi]).abs().max().item()
                                 if xb.numel() else 0.0),
                    "scale": max(whole.abs().max().item(), whole_x.grad.abs().max().item())})
    return out


def infer_clips(group: Optional[RankGroup], run: Dict[str, Any]) -> Dict[str, Any]:
    device = group.device if group is not None else torch.device(run.get("device", "cpu"))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if "tf32" in run:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = run["tf32"]
    dtype = getattr(torch, run.get("dtype", "float32"))
    compute = getattr(torch, run["compute_dtype"]) if run.get("compute_dtype") else None
    model = build_adapted_model("uavsal", filter_kwargs=True, **run.get("model", {}))
    model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in run["weights"].items()},
                          strict=True)
    model = model.to(device=device, dtype=dtype)
    mesh = None if group is None or run.get("mesh") is None else mesh_of(group, run["mesh"])
    if mesh is not None and not mesh.active:
        return {"coords": None}
    gauss, ob = (None if run.get(k) is None else torch.as_tensor(np.asarray(run[k]), dtype=dtype)
                 for k in ("gauss", "ob"))
    step = make_infer_step(model, gauss, ob, compute_dtype=compute, mesh=mesh)
    admitted = [0]

    def count(block, args, kwargs):
        """A call of a DWBlock whose whole-map input the fused kernel's gate
        admits (`height` is the whole map's rows on a spatial mesh)."""
        n, c, h, w = args[0].shape
        admitted[0] += block.takes_kernel((n, c, kwargs.get("height") or h, w), args[0].dtype)

    for block in model.modules():
        if isinstance(block, DWBlock):
            block.register_forward_pre_hook(count, with_kwargs=True)
    x, state = np.asarray(run["x"]), np.asarray(run["state"])
    if mesh is not None:
        x, state = x[mesh.videos(len(x))], state[mesh.videos(len(state))]
        x, state = mesh.band(x, 2), mesh.band(state, 1)
    x = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    if x.dtype != torch.uint8:
        x = x.to(dtype)
    state = torch.from_numpy(np.ascontiguousarray(state)).to(device=device, dtype=dtype)
    s = x.shape[1] // run["clips"]
    out: Dict[str, Any] = {"coords": coords(mesh), "saliency": [], "state": [], "launches": [],
                           "admitted": []}
    t0 = time.perf_counter()
    for k in range(run["clips"]):
        kernels.reset_launches()
        admitted[0] = 0
        sal, state = step(x[:, k * s:(k + 1) * s], state)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out["launches"].append(dict(kernels.launches))
        out["admitted"].append(admitted[0])
        out["saliency"].append(sal.double().cpu().numpy())
        out["state"].append(state.double().cpu().numpy())
    out["seconds"] = time.perf_counter() - t0
    if device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    return out


def run_jobs(group: Optional[RankGroup], jobs: List[Any]) -> List[Any]:
    from _dp_runs import train_steps

    table = {"exchanges": exchanges, "infer_clips": infer_clips, "train_steps": train_steps}
    return [table[name](group, arg) for name, arg in jobs]
