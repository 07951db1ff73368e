"""The train, eval and serving steps run on each rank of a group, for
holding N ranks against one process (`parallel.spawn` a function of this
module). The tests and `chip_smoke.py` share it; it imports nothing of
JAX, and a spawned rank imports it by name from the parent's `sys.path`.

Each run takes whole batches, as one process would take them; every rank
cuts them to its rows (`RankGroup.rows`) and returns, on the host, what it
computed. A run is a dict of plain values (arrays, numbers, strings), so
that it pickles into a spawned rank:

- `train_steps(group, runs)`, for each run of the list: train (or, with
  `"eval"`, eval) steps of the model `run["model"]` (keyword arguments of
  `build_adapted_model`) from the weights `run["weights"]` (a state_dict
  of arrays) and, where given, Adam's state `run["adam"]`, over the clips
  `run["clips"]` ((x, y) of the whole batch) from the carried state
  `run["rnn"]`, with the priors `run["gauss"]`, `run["ob"]`; `"dtype"` is
  the parameters' ("float32" or "float64"), `"compute_dtype"` "bfloat16"
  for mixed precision, `"loss"` "masked" (the trainer's) or "plain"
  (`loss_fu`), `"remat"`, `"lr"`, `"wd"`, `"tf32"` for
  cuDNN's and cuBLAS's TF32 switches (a spawned rank starts with PyTorch's
  defaults, cuDNN's TF32 on, whatever its parent set), `"deterministic"`
  for their deterministic algorithms, `"grouped"` False to run the
  plain step of one process on this rank (without the group), and
  `"mesh"` (n_data, n_spatial[, n_seq]) to run the steps on that mesh
  (`tests/_spatial_runs.py::mesh_of`), each rank taking its videos, its
  band of their rows and its run of their frames (x and y; the state is
  whole on a seq axis). Returns per step the loss, the gradients Adam took
  (after the all-reduce), the kernel launches and this rank's rows (and
  band) of the carried state; the state_dict after; a digest of the
  parameters' bytes; the rank's mesh coordinates (None without a mesh);
  and on the card the peak of its allocated memory;
- `train_videos(group, runs)`, for each run of the list: `Trainer.train`
  with `TrainConfig(**run["config"])` over the in-memory videos
  `run["videos"]` into `run["save_model_dir"]`, from `run["weights"]` (a
  JAX variables tree) and the observed prior `run["ob"]`; where
  `run["resume_from"]` is (a directory, file name prefixes), rank 0 first
  copies the files of that directory that start with one of them into
  the run's model directory (an earlier run's first epoch, say). Returns whether this rank
  writes, the steps taken and a digest of the parameters;
- `serve_videos(group, run)`: this rank's rows of each group of
  `run["videos_per_batch"]` videos of `run["videos"]` served by
  `predict_videos` (graphed with `"graphed"`), the model loaded by
  `load_model_for_inference(run["weights"], **run["model"])`: the indices
  of its videos, their maps, the kernel launches, the seconds the clip
  loop took and, graphed, the graphs' kernel nodes (a graph is captured
  in the loop's first clip, so the seconds include it).

`run_jobs(group, jobs)` runs a list of (name of one of these, its
argument) in one spawn, so that a caller pays for one start of the ranks;
`sleep_then_sum` holds `spawn`'s timeouts; `ranks_arithmetic(parts)` makes
one process reduce each BatchNorm's batch as that many ranks do.
A run that takes no group (`group` None) is the one process itself.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import time
from typing import Any, Dict, List, Optional
from unittest import mock

import numpy as np
import torch

from iip_uavsal_saliency_tpu_torch import kernels
from iip_uavsal_saliency_tpu_torch.models.adapters import build_adapted_model
from iip_uavsal_saliency_tpu_torch.ops.layers import to_channels_last
from iip_uavsal_saliency_tpu_torch.parallel import RankGroup, cross_rank_batch_norm
from iip_uavsal_saliency_tpu_torch.runners.infer import load_model_for_inference, predict_videos
from iip_uavsal_saliency_tpu_torch.serving.steps import graph_step, make_baked_infer_step
from iip_uavsal_saliency_tpu_torch.training.losses import loss_fu
from iip_uavsal_saliency_tpu_torch.training.optim import make_optimizer
from iip_uavsal_saliency_tpu_torch.training.steps import (create_train_state, make_eval_step,
                                                          make_train_step)
from iip_uavsal_saliency_tpu_torch.training.trainer import TrainConfig, Trainer, _masked_loss


def ranks_arithmetic(parts: int):
    """Within, this process's train-mode BatchNorm reduces its batch as
    `parts` ranks holding equal shares of it would
    (`cross_rank_batch_norm(group=None, parts=parts)` in place of
    `F.batch_norm`): the one-process step whose sums are the ranks' own,
    which alone can hold a bf16 data-parallel step (in a random network one
    bf16 ulp of a BatchNorm output moves the step's gradients and state by
    O(1))."""

    def batch_norm(x, running_mean, running_var, weight, bias, training, momentum, eps):
        return cross_rank_batch_norm(x, weight, bias, running_mean, running_var, momentum, eps,
                                     None, parts)

    return mock.patch.object(torch.nn.functional, "batch_norm", batch_norm)


def _rows(group: Optional[RankGroup], a):
    return a if group is None else a[group.rows(len(a))]


def _tensor(a, device, dtype=None) -> Optional[torch.Tensor]:
    if a is None:
        return None
    t = torch.from_numpy(np.array(a)).to(device)
    return t if dtype is None or t.dtype == torch.uint8 else t.to(dtype)


def param_digest(model: torch.nn.Module) -> str:
    """A digest of every parameter's and buffer's bytes, in state_dict
    order: equal digests are equal replicas."""
    h = hashlib.sha1()
    for name, t in model.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def train_steps(group: Optional[RankGroup], runs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    return [_train_steps(group, run) for run in runs]


def _train_steps(group: Optional[RankGroup], run: Dict[str, Any]) -> Dict[str, Any]:
    from _spatial_runs import coords, mesh_of  # it imports this module's functions by name

    mesh = mesh_of(group, run["mesh"]) if group is not None and run.get("mesh") else None
    if mesh is not None and not mesh.active:
        return {"coords": None}
    step_group = group if run.get("grouped", True) and mesh is None else None
    device = group.device if group is not None else torch.device(run.get("device", "cpu"))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if "tf32" in run:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = run["tf32"]
    if run.get("deterministic"):
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.use_deterministic_algorithms(True, warn_only=True)
    dtype = getattr(torch, run.get("dtype", "float32"))
    compute = getattr(torch, run["compute_dtype"]) if run.get("compute_dtype") else None
    kw = dict(run["model"])
    model = build_adapted_model(kw.pop("model_name", "uavsal"), filter_kwargs=True, **kw)
    model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in run["weights"].items()},
                          strict=True)
    model = to_channels_last(model.to(dtype), device)
    optimizer = make_optimizer(model, run.get("lr", 1e-4), run.get("wd", 5e-5))
    adam = run.get("adam")
    if adam and adam["step"]:
        for n, p in model.named_parameters():
            if p.requires_grad:
                optimizer.state[p] = {
                    "step": torch.tensor(float(adam["step"])),
                    "exp_avg": torch.as_tensor(adam["mu"][n]).to(device, dtype),
                    "exp_avg_sq": torch.as_tensor(adam["nu"][n]).to(device, dtype)}
    loss_group = step_group if mesh is None else mesh.data
    loss_fn = _masked_loss(loss_fu, loss_group) if run.get("loss") == "masked" else loss_fu
    if run.get("eval"):
        step = make_eval_step(model, loss_fn, step_group, mesh=mesh)
    else:
        state = create_train_state(model, optimizer)
        step = make_train_step(state, loss_fn, compute, remat=run.get("remat", False),
                               group=step_group, mesh=mesh)

    def mine(a, row_axis, frames=False):
        """This rank's rows of a whole batch, and on a mesh its band and,
        for x and y, its frames."""
        if mesh is None:
            return _rows(step_group, a)
        a = mesh.band(np.asarray(a)[mesh.videos(len(a))], row_axis)
        return mesh.frames(a, 1) if frames else a

    gauss, ob = (_tensor(p, device, dtype) for p in (run.get("gauss"), run.get("ob")))
    rnn = _tensor(mine(run["rnn"], 1), device, dtype)
    out: Dict[str, Any] = {"losses": [], "grads": [], "launches": [], "rnn": [],
                           "coords": coords(mesh)}
    for x, y in run["clips"]:
        x, y = (_tensor(mine(a, 2, frames=True), device, dtype) for a in (x, y))
        kernels.reset_launches()
        loss, rnn = step(x, gauss, ob, rnn, y)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out["launches"].append(dict(kernels.launches))
        out["losses"].append(float(loss))
        out["grads"].append({n: p.grad.detach().double().cpu().numpy()
                             for n, p in model.named_parameters() if p.grad is not None})
        out["rnn"].append(rnn.detach().double().cpu().numpy())
        rnn = rnn.to(dtype)
    out["after"] = {n: t.detach().double().cpu().numpy() for n, t in model.state_dict().items()}
    out["digest"] = param_digest(model)
    if device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    return out


def serve_videos(group: Optional[RankGroup], run: Dict[str, Any]) -> Dict[str, Any]:
    device = group.device if group is not None else torch.device(run.get("device", "cpu"))
    compute = getattr(torch, run["compute_dtype"]) if run.get("compute_dtype") else None
    model = load_model_for_inference(run["weights"], device=device, **run["model"])
    step = make_baked_infer_step(model, run.get("gauss"), run.get("ob"), compute_dtype=compute)
    if run.get("graphed"):
        step = graph_step(step)
    videos, native = run["videos"], run["native"]
    v_per = run["videos_per_batch"]
    v_local = v_per if group is None else v_per // group.world
    mine = [i for g0 in range(0, len(videos), v_per)
            for i in _rows(group, list(range(g0, g0 + v_per))) if i < len(videos)]
    kernels.reset_launches()
    t0 = time.perf_counter()
    maps = predict_videos(step, model, [videos[i] for i in mine], [native[i] for i in mine],
                          batch_size=run["batch_size"], time_dims=run["time_dims"],
                          videos_per_batch=v_local)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out = {"indices": mine, "maps": [np.ascontiguousarray(m) for m in maps],
           "launches": dict(kernels.launches), "seconds": time.perf_counter() - t0}
    if run.get("graphed"):
        out["graph_launches"] = step.graph_launches()
    return out


def train_videos(group: Optional[RankGroup], runs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    out = []
    for run in runs:
        config = TrainConfig(**run["config"])
        model_dir = os.path.join(run["save_model_dir"], config.method_name)
        source = run.get("resume_from")
        if source and (group is None or group.is_first):
            os.makedirs(model_dir, exist_ok=True)
            for name in sorted(os.listdir(source[0])):
                if name.startswith(tuple(source[1])):
                    shutil.copy(os.path.join(source[0], name), model_dir)
        if source and group is not None:
            group.barrier()
        trainer = Trainer(config, "", "synthetic", run["save_model_dir"],
                          pre_variables=run.get("weights"), ob_prior=run.get("ob"),
                          videos=run["videos"], group=group,
                          device=None if group is not None else run.get("device", "cpu"))
        trainer.train()
        out.append({"writes": trainer.writes, "step": trainer.state.step,
                    "digest": param_digest(trainer.model)})
    return out


def run_jobs(group: Optional[RankGroup], jobs: List[Any]) -> List[Any]:
    return [JOBS[name](group, arg) for name, arg in jobs]


JOBS = {"train_steps": train_steps, "train_videos": train_videos, "serve_videos": serve_videos}


def sleep_then_sum(group: RankGroup, seconds: float) -> float:
    """Meet the other ranks, sleep `seconds` on each, then sum the ranks'
    numbers: a run that outlasts its collectives' timeout while no
    collective waits."""
    group.barrier()
    time.sleep(seconds)
    return float(group.all_reduce(torch.tensor([group.rank + 1.0]))[0])
