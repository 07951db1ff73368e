"""Serving artifacts: the whole serving step as one file (counterpart of
`iip_uavsal_saliency_tpu/runners/export.py`).

`export_serving` exports the baked serving step (`serving/steps.py::
BakedStep`, the step `make_baked_infer_step` serves) with `torch.export`:

    step(frames uint8 (V, S, H, W, 3), state (V, H/8, W/8, C)) -> (saliency f32, state)

with the folded, cast and packed weights and the prior maps inside the
program. `save_exported` writes it after a small JSON header (shapes,
dtypes, iosize; the JAX header's keys, `torch_version` in place of
`jax_version`). `ExportedServing` loads it, and `run_exported` serves it
through the port's `test_videos`, replayed from a CUDA graph on the card
like the live step, without the checkpoint or the prior files.

Notes
-----
- The program holds K1 and K2 as the custom ops `uavsal::twa_scan` and
  `uavsal::dwblock` (`ops/twa.py`, `ops/dwblock.py`): on the card they run
  the port's hand-written kernels, which `kernels.py` builds from
  `csrc/` at their first call. So an artifact needs this package to run;
  it needs neither the model code's weights nor its priors.
- The artifact is fixed to the device type it was exported on (its
  `platforms`), to its shapes and to its dtype. The state enters and
  leaves in the compute dtype, as in the JAX artifact. A step's uint8
  normalization and every cast happen inside the program.
- The file starts with this package's own magic, of the JAX magic's length,
  so that neither package misreads the other's file. A JAX artifact is
  StableHLO, which the port cannot run: it is refused with a message.
"""

from __future__ import annotations

import io
import json
import os
import struct
import warnings
import zipfile
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from ..serving.steps import bake_model

MAGIC = b"UAVSALPT2A"
JAX_MAGIC = b"UAVSALAOT1"
FORMAT_VERSION = 1


def _dtype_name(dtype: Optional[torch.dtype]) -> str:
    return str(dtype or torch.float32).replace("torch.", "")


def export_serving(
    model: torch.nn.Module,
    *,
    iosize: Tuple[int, int, int, int] = (360, 640, 45, 80),
    batch_size: int = 4,
    time_dims: int = 5,
    videos_per_batch: int = 1,
    bias_type: Sequence[int] = (1, 1, 1),
    gauss=None,
    ob=None,
    compute_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.export.ExportedProgram, Dict]:
    """Export the serving step of `model` (from `load_model_for_inference`,
    on the device to export for) with its weights and priors inside.

    Returns (program, meta): the `torch.export.ExportedProgram` and the
    JSON-able header. `batch_size` is clips of `time_dims` frames per step
    (S = batch_size * time_dims): the artifact's shapes are FIXED.
    `compute_dtype=torch.bfloat16` bakes the bf16 serving path; pass None
    for a prior that `bias_type` switches off (it is recorded in the
    header). Takes `model` over, as `bake_model` does. One eager call of the step on zeros comes first: it
    fills the caches that the trace then bakes as constants (ConvTWA's
    split, and on the card its packed W_h) and builds the kernels."""
    shape_r, shape_c = iosize[0], iosize[1]
    baked = bake_model(model, gauss, ob, compute_dtype)
    device = next(model.parameters()).device
    v, s = videos_per_batch, batch_size * time_dims
    x = torch.zeros((v, s, shape_r, shape_c, 3), dtype=torch.uint8, device=device)
    state = model.init_state(shape_r, shape_c, v, dtype=compute_dtype or torch.float32,
                             device=device)
    with torch.no_grad():
        baked(x, state)
        program = torch.export.export(baked, (x, state))
    program.example_inputs = None  # zeros the size of a clip, which torch.export.save would keep
    meta = {
        "format_version": FORMAT_VERSION,
        "iosize": list(iosize),
        "batch_size": batch_size,
        "time_dims": time_dims,
        "videos_per_batch": videos_per_batch,
        "bias_type": list(bias_type),
        "compute_dtype": _dtype_name(compute_dtype),
        "x_shape": list(x.shape),
        "state_shape": list(state.shape),
        "state_dtype": _dtype_name(state.dtype),
        "platforms": [device.type],
        "torch_version": torch.__version__,
    }
    return program, meta


def save_exported(path: str, program: torch.export.ExportedProgram, meta: Dict) -> None:
    """Write `MAGIC | u32 header_len | header JSON | torch.export.save bytes`."""
    header = json.dumps(meta).encode("utf-8")
    blob = io.BytesIO()
    with warnings.catch_warnings():
        # the archive writer calls each channels-last weight "incomplete" (it
        # is not contiguous) and keeps it as it is; the load restores it
        warnings.filterwarnings("ignore", message="No complete tensor found in the group")
        torch.export.save(program, blob)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        f.write(blob.getvalue())


class ExportedServing:
    """A loaded serving artifact: `step(x_uint8, state) -> (saliency, state)`.

    The weights, the priors, the normalization and the dtype policy are
    inside the program; this class adds the fixed-shape header and runs the
    program under `torch.inference_mode()`, on the device type it was
    exported on (`device`). The artifact holds the weights and priors but
    needs this package's `kernels` module to run on the card: its K1 and
    K2 are the custom ops `uavsal::twa_scan` and `uavsal::dwblock`, which
    importing `ops.twa` and `ops.dwblock` registers (done here, before the
    program loads) and whose CUDA implementations launch the kernels that
    `kernels.py` builds. A `cuda` artifact on a machine without a card
    raises. Use `run_exported` to drive the resumable `.mat`-writing runner."""

    def __init__(self, path: str):
        from ..ops import dwblock, twa  # noqa: F401  registers uavsal::twa_scan, uavsal::dwblock

        with open(path, "rb") as f:
            data = f.read()
        if data.startswith(JAX_MAGIC):
            raise ValueError(f"{path}: a JAX StableHLO serving artifact ({JAX_MAGIC.decode()}), "
                             "which the port cannot run: re-export the checkpoint with the "
                             "port's `cli export`")
        if not data.startswith(MAGIC):
            raise ValueError(f"{path}: not a UAVSal PyTorch serving artifact")
        off = len(MAGIC)
        try:
            (hlen,) = struct.unpack_from("<I", data, off)
            self.meta = json.loads(data[off + 4:off + 4 + hlen].decode("utf-8"))
            version, platform = self.meta["format_version"], self.meta["platforms"][0]
        except (struct.error, UnicodeDecodeError, ValueError, KeyError, IndexError,
                TypeError) as e:
            raise ValueError(f"{path}: the artifact's header is corrupt ({e})") from None
        if version > FORMAT_VERSION:
            raise ValueError(f"{path}: format_version {version} is newer than this loader "
                             f"({FORMAT_VERSION})")
        if platform == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{path} was exported for cuda, and no CUDA device is available")
        self.device = torch.device(platform)
        blob = io.BytesIO(data[off + 4 + hlen:])
        try:
            if not zipfile.is_zipfile(blob):  # what torch.export.save writes
                raise ValueError("not a torch.export archive")
            blob.seek(0)
            program = torch.export.load(blob)
        except (RuntimeError, ValueError, KeyError, EOFError, zipfile.BadZipFile) as e:
            raise ValueError(f"{path}: the artifact's program does not load ({e})") from None
        self._module = program.module()

    def init_state(self, shape_r: int, shape_c: int, v: int) -> torch.Tensor:
        """Zero recurrent state in the artifact's state dtype on its device.
        Shapes are FIXED by the artifact: a mismatch raises here instead of
        deep inside the program."""
        expect = (self.meta["iosize"][0], self.meta["iosize"][1], self.meta["videos_per_batch"])
        if (shape_r, shape_c, v) != expect:
            raise ValueError(f"artifact is fixed to (H, W, V)={expect}, got "
                             f"({shape_r}, {shape_c}, {v}): re-export for other shapes")
        return torch.zeros(tuple(self.meta["state_shape"]),
                           dtype=getattr(torch, self.meta["state_dtype"]), device=self.device)

    def __call__(self, x: torch.Tensor, state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.inference_mode():
            return self._module(x, state)


def run_exported(
    input_path: str,
    output_path: str,
    artifact: Union[str, ExportedServing],
    save_frames: float = float("inf"),
    method_name: Optional[str] = None,
) -> None:
    """Resumable per-video inference from an artifact (a path, or one
    loaded): the `test_videos` flow (decode, letterbox, pipelined stateful
    step, un-letterbox, uint8 `.mat`) with every model-side choice frozen
    inside the artifact; on the card the step is replayed from a CUDA
    graph."""
    from .infer import test_videos

    art = artifact if isinstance(artifact, ExportedServing) else ExportedServing(artifact)
    m = art.meta
    test_videos(
        input_path,
        output_path,
        art,
        iosize=tuple(m["iosize"]),
        batch_size=m["batch_size"],
        time_dims=m["time_dims"],
        # the priors live inside the program: the runner must not build them
        bias_type=(0, 0, 0),
        save_frames=save_frames,
        method_name=method_name,
        videos_per_batch=m["videos_per_batch"],
        infer_step=art,
    )
