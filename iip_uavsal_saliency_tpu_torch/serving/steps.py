"""Serving steps (counterparts of `iip_uavsal_saliency_tpu/parallel/steps.py`:
`_build_infer_fn` and `make_baked_infer_step`, and in `graph_step` of the
compiled, state-donating program the JAX runner serves through). The baked
step's body is a module (`BakedStep`), which `runners/export.py` exports.

uint8 frames go to the device as they are and are normalized there
(/255, ImageNet mean/std, in f32), then cast to the compute dtype with the
carried state and the priors; the model runs in eval form under
`torch.inference_mode()`, and the saliency comes back in f32.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from .. import kernels
from ..data.letterbox import IMAGENET_MEAN, IMAGENET_STD
from ..ops.layers import DWBlock, to_channels_last
from ..parallel import spatial
from ..parallel.mesh import Mesh

Step = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def _model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _serve(model: nn.Module, mean: torch.Tensor, std: torch.Tensor,
           compute_dtype: Optional[torch.dtype], x, gauss, ob, state, **kw):
    """The serving step's body: uint8 frames normalized in f32, the inputs
    cast to `compute_dtype`, the model (given `kw`), the saliency in f32."""
    if x.dtype == torch.uint8:
        x = (x.float() / 255.0 - mean) / std
    if compute_dtype is not None:
        x, state, gauss, ob = (None if t is None else t.to(compute_dtype)
                               for t in (x, state, gauss, ob))
    out, new_state = model(x, gauss, ob, state, **kw)
    return out.float(), new_state


def _normalization(device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.as_tensor(IMAGENET_MEAN, device=device),
            torch.as_tensor(IMAGENET_STD, device=device))


def build_infer_fn(model: nn.Module, compute_dtype: Optional[torch.dtype] = None):
    """`fn(x, gauss, ob, state) -> (saliency, new_state)` over `model` as it
    is (its parameters must already be in `compute_dtype`)."""
    mean, std = _normalization(_model_device(model))

    def step(x, gauss, ob, state, **kw):
        with torch.inference_mode():
            return _serve(model, mean, std, compute_dtype, x, gauss, ob, state, **kw)

    return step


def spatial_mesh(mesh: Optional[Mesh]) -> bool:
    """Whether `mesh` splits image rows (a spatial axis of more than one)."""
    return mesh is not None and mesh.n_spatial > 1


def make_infer_step(model: nn.Module, gauss: Optional[torch.Tensor] = None,
                    ob: Optional[torch.Tensor] = None,
                    compute_dtype: Optional[torch.dtype] = None,
                    mesh: Optional[Mesh] = None) -> Step:
    """`step(x, state) -> (saliency, new_state)` over the argument-passing
    step (`build_infer_fn`), the priors handed to it on every call: what
    the JAX runner serves (`make_infer_step`) when `bake_params` is false.
    Takes `model` over as `bake_model` does (cast to `compute_dtype`, its
    weights channels-last), but packs nothing: the fused dwBlock's kernel
    packs its weights from the parameters at each call.

    With `mesh`, x and the state are this rank's videos (`Mesh.videos`)
    and, on a spatial axis, its band of their rows (`Mesh.band`: x's H and
    the state's H/8 rows split evenly), and so are the saliency and the
    state it returns; the priors are whole. On a spatial axis the model
    sees the whole batch's V (as the JAX step's jit over the mesh does) and
    must be UAVSal on MobileNetV2; on a data axis alone each rank serves
    its videos by themselves (the JAX step's `shard_map`)."""
    device = _model_device(model)
    if mesh is not None:
        mesh.check_active()
    if spatial_mesh(mesh):
        spatial.check_model(model)
    model.eval().requires_grad_(False)
    if compute_dtype is not None:
        model.to(compute_dtype)
    to_channels_last(model)
    fn = build_infer_fn(model, compute_dtype)
    gauss, ob = (None if p is None else torch.as_tensor(p).to(device) for p in (gauss, ob))

    if not spatial_mesh(mesh):
        def step(x, state):
            return fn(x, gauss, ob, state)

        return step

    def banded(x, state):
        with spatial.over(mesh.spatial):
            return fn(x, gauss, ob, state, videos=x.shape[0] * mesh.n_data)

    banded.mesh = mesh  # what `graph_step` refuses
    return banded


class BakedStep(nn.Module):
    """`forward(x, state) -> (saliency, new_state)`: the body of the baked
    serving step as a module, the priors and the normalization held as
    plain tensors (which `torch.export` bakes as constants). Made by
    `bake_model`; `make_baked_infer_step` serves it under
    `torch.inference_mode()`, `runners/export.py` exports it."""

    def __init__(self, model: nn.Module, gauss: Optional[torch.Tensor],
                 ob: Optional[torch.Tensor], compute_dtype: Optional[torch.dtype]):
        super().__init__()
        self.model = model
        self.gauss, self.ob = gauss, ob
        self.mean, self.std = _normalization(_model_device(model))
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return _serve(self.model, self.mean, self.std, self.compute_dtype, x, self.gauss,
                      self.ob, state)


def bake_model(model: nn.Module, gauss: Optional[torch.Tensor] = None,
               ob: Optional[torch.Tensor] = None,
               compute_dtype: Optional[torch.dtype] = None) -> BakedStep:
    """`model` with the weights and priors cast once and frozen, as a
    `BakedStep`.

    Takes `model` over: it is cast to `compute_dtype` in place with its 4-D
    weights stored channels-last and its 5-D ones channels-last-3d (and,
    with the fused dwBlock on, packed for its kernel), and must not be
    trained or loaded afterwards. Give it a model from
    `load_model_for_inference` (any zoo name), whose BatchNorms are already
    folded into the convs. The priors are moved to the model's device and
    cast once. A model without priors or state is given them and ignores
    them; its dummy state goes through as it came."""
    device = _model_device(model)
    model.eval().requires_grad_(False)
    if compute_dtype is not None:
        model.to(compute_dtype)
    to_channels_last(model)
    dtype = compute_dtype or torch.float32
    for block in model.modules():
        if isinstance(block, DWBlock) and block.use_kernel:
            block.pack(dtype)  # the fused kernel's weights, once

    def prep(p):
        return None if p is None else torch.as_tensor(p).to(device=device, dtype=dtype)

    return BakedStep(model, prep(gauss), prep(ob), compute_dtype)


def make_baked_infer_step(model: nn.Module, gauss: Optional[torch.Tensor] = None,
                          ob: Optional[torch.Tensor] = None,
                          compute_dtype: Optional[torch.dtype] = None,
                          mesh: Optional[Mesh] = None) -> Step:
    """`step(x, state) -> (saliency, new_state)`: `bake_model` of these
    arguments (which takes `model` over) served under
    `torch.inference_mode()`. A mesh with a data axis alone serves each
    rank's videos by themselves (the JAX baked step's `shard_map`); a
    spatial axis raises ValueError, as the JAX baked step refuses any axis
    but `data` (use `make_infer_step`)."""
    if spatial_mesh(mesh):
        raise ValueError(f"make_baked_infer_step wants a pure-'data' mesh (got {mesh.shape}); "
                         "a spatial mesh serves through make_infer_step")
    baked = bake_model(model, gauss, ob, compute_dtype)

    def step(x, state):
        with torch.inference_mode():
            return baked(x, state)

    return step


# Warm-up calls before a capture: the first builds and loads the kernels
# (`kernels.load` runs nvcc, which must never happen inside a capture) and
# fills the host-side caches (interpolation matrices, the split TWA weight,
# each kernel's launch attributes); the others let cuDNN settle, as the
# documented `torch.cuda.graph` pattern does.
WARMUP_CALLS = 3


class _Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    x: torch.Tensor          # static input, state and outputs of the graph
    state: torch.Tensor
    saliency: torch.Tensor
    new_state: torch.Tensor
    launches: Dict[str, int]  # kernel launches the capture recorded into the graph


class GraphedStep:
    """`step(x, state) -> (saliency, new_state)` served by CUDA-graph replay.

    On a CUDA tensor, the first call for each (x shape, x dtype, state
    shape, state dtype, device) runs the step `WARMUP_CALLS` times on a side
    stream and then captures one call of it into a graph with static input,
    state and output buffers. Every call copies `x` and `state` into the
    static buffers and replays the graph on the current stream, so the host
    issues a few copies and one graph launch instead of every kernel of the
    model. A failed capture raises; nothing falls back to the eager step.

    The returned saliency and state are the graph's static outputs: the next
    replay of the same graph overwrites them, as the JAX runner's step
    donates its state buffer. Use them (or order work that reads them on
    the current stream) before the next call; clone what must outlive it.
    Passing the returned state back in as `state` is the intended use.

    `kernels.launches` counts where the wrappers launch: the warm-up calls
    and the capture count there, a replay runs without the wrappers and
    counts nothing. `replayed` tallies, per kernel, the launches the replays
    ran as their captures recorded them; it is a convenience.
    `graph_launches` reads the same from the graphs' own kernel nodes, and a
    profiler trace (`kernels.traced_launches`) is what shows that they ran.

    On a CPU tensor the step runs eagerly as it is: the CPU is an explicit
    request (`device="cpu"`), and there is nothing to capture."""

    def __init__(self, step: Step):
        self.step = step
        self._graphs: Dict[tuple, _Captured] = {}
        self.replayed: Dict[str, int] = {name: 0 for name in kernels.KERNELS}

    def __call__(self, x: torch.Tensor, state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if x.device.type == "cpu":
            return self.step(x, state)
        if x.device.type != "cuda" or state.device != x.device:
            raise ValueError(f"a graphed step runs on one CUDA device, got x on {x.device} "
                             f"and state on {state.device}")
        key = (tuple(x.shape), x.dtype, tuple(state.shape), state.dtype, x.device)
        captured = self._graphs.get(key)
        if captured is None:
            captured = self._graphs[key] = self._capture(x, state)
        captured.x.copy_(x)
        captured.state.copy_(state)
        captured.graph.replay()
        for name, n in captured.launches.items():
            self.replayed[name] += n
        return captured.saliency, captured.new_state

    def _capture(self, x: torch.Tensor, state: torch.Tensor) -> _Captured:
        static_x, static_state = x.clone(), state.clone()
        current = torch.cuda.current_stream(x.device)
        side = torch.cuda.Stream(x.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                self.step(static_x, static_state)
        current.wait_stream(side)
        before = dict(kernels.launches)
        graph = torch.cuda.CUDAGraph(keep_graph=True)  # its nodes stay readable
        with torch.cuda.device(x.device), torch.cuda.graph(graph):
            saliency, new_state = self.step(static_x, static_state)
        graph.instantiate()
        made = {name: kernels.launches[name] - before[name] for name in kernels.launches}
        return _Captured(graph, static_x, static_state, saliency, new_state, made)


    def graph_launches(self) -> Dict[str, int]:
        """Per kernel, the kernel nodes of the graphs captured so far
        (`kernels.graph_launches`), summed: what one replay of each runs,
        read from the graphs themselves."""
        total = {name: 0 for name in kernels.KERNELS}
        for captured in self._graphs.values():
            for name, n in kernels.graph_launches(captured.graph).items():
                total[name] += n
        return total


def graph_step(step: Step) -> GraphedStep:
    """`step` served by CUDA-graph replay (`GraphedStep`); a step that is
    already graphed is returned as it is, so that its captures are kept. A
    step on a spatial mesh raises ValueError: its exchanges between
    processes cannot be captured."""
    if spatial_mesh(getattr(step, "mesh", None)):
        raise ValueError("a step on a spatial mesh cannot be graphed: its row exchanges run "
                         "between processes, outside any CUDA graph")
    return step if isinstance(step, GraphedStep) else GraphedStep(step)
