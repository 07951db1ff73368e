"""Runs on the ranks of a seq mesh, for holding them against one process
(`parallel.spawn` `tests/_spatial_runs.py::run_jobs`, whose table holds
`seq_exchanges` beside `infer_clips` and `tests/_dp_runs.py::train_steps`:
their runs take a `"mesh"` of (n_data, 1, n_seq), each rank cutting x and
y to its run of each clip's frames). It imports nothing of JAX; a spawned
rank imports it by name from the parent's `sys.path`.

- `seq_exchanges(group, cases)`: each case a dict with `"mesh"` (n_data, 1,
  n_seq), `"op"` (one of `OPS`), `"videos"` V, `"frames"` S of each clip,
  `"t"` (the group length of `gather_groups`) and `"seed"`: the op on this
  rank's frames against the op on the whole clips in f64, forward and the
  gradients (each rank's loss is sum(out * G) over its part of the output
  with a G of its own, and the whole clips' loss is the sum of those);
  returns the largest differences and the scale of the values;
- `assemble_frames(results, key, index)`: the whole (V, S, ...) array of
  `results[r][key][index]` from the ranks' runs of frames, joined in seq
  order and then videos in data order;
- `assemble_state(results, key, index)`: the state, which every rank of a
  seq axis holds whole: each data rank's, checked equal over its seq
  ranks.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from iip_uavsal_saliency_tpu_torch.models.stblock import temporal_differences
from iip_uavsal_saliency_tpu_torch.ops.twa import twa_scan_ref
from iip_uavsal_saliency_tpu_torch.parallel import RankGroup, seq

OPS = ("differences", "groups", "hand_state")
C, H, W = 4, 3, 5  # the maps' channels and size


def _active(results):
    return [r for r in results if r["coords"] is not None]


def assemble_frames(results: List[Dict[str, Any]], key: str, index: int) -> np.ndarray:
    active = _active(results)
    n_data = 1 + max(r["coords"][0] for r in active)
    videos = []
    for d in range(n_data):
        runs = sorted((r for r in active if r["coords"][0] == d), key=lambda r: r["coords"][2])
        videos.append(np.concatenate([r[key][index] for r in runs], axis=1))
    return np.concatenate(videos, axis=0)


def assemble_state(results: List[Dict[str, Any]], key: str, index: int) -> np.ndarray:
    active = _active(results)
    n_data = 1 + max(r["coords"][0] for r in active)
    states = []
    for d in range(n_data):
        held = [r[key][index] for r in active if r["coords"][0] == d]
        assert all(np.array_equal(h, held[0]) for h in held), "the seq ranks' states differ"
        states.append(held[0])
    return np.concatenate(states, axis=0)


def _draw(case, op):
    """The whole clips' inputs of the op, from the case's seed."""
    gen = torch.Generator().manual_seed(case["seed"])
    v, s, f64 = case["videos"], case["frames"], torch.float64
    if op != "hand_state":
        return {"x": torch.randn((v, s, C, H, W), generator=gen, dtype=f64)}
    return {"x": torch.rand((v, s, H, W, C), generator=gen, dtype=f64),
            "gx": torch.randn((v, s, H, W, C), generator=gen, dtype=f64),
            "w_h": 0.3 * torch.randn((3, 3, C, C), generator=gen, dtype=f64),
            "h0": torch.randn((v, H, W, C), generator=gen, dtype=f64)}


def _run(op: str, xs, t: int, videos: int, frames: int) -> torch.Tensor:
    """The op's output as (videos, frames or groups, ...): over the whole
    clips outside `seq.over`, over this rank's frames inside it (the
    groups' sums are every group's on every rank)."""
    x = xs["x"]
    if op == "differences":
        n = x.shape[1]
        out = temporal_differences(x.reshape(videos * n, *x.shape[2:]), n)
        return out.reshape(videos, n, *out.shape[1:])
    if op == "groups":
        n = x.shape[1]
        flat = x.reshape(videos * n, *x.shape[2:])
        if seq.current() is None:
            out = flat.reshape(videos * n // t, t, *x.shape[2:]).sum(1)
        else:
            out = seq.gather_groups(flat, t, frames)
        return out.reshape(videos, -1, *out.shape[1:])
    if seq.current() is None:
        return twa_scan_ref(x, xs["gx"], xs["w_h"], xs["h0"])
    return seq.hand_state(lambda *args: twa_scan_ref(*args)[0], x, xs["gx"], xs["w_h"], xs["h0"])


def seq_exchanges(group: Optional[RankGroup], cases: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """See the module docstring. A rank's part of the whole output is its
    videos' frames (every group, for `groups`); the whole clips' loss is
    the sum of every rank's loss on its part."""
    from _spatial_runs import coords, mesh_of

    out = []
    for case in cases:
        mesh = mesh_of(group, case["mesh"])
        if not mesh.active:
            out.append({"case": case, "coords": None})
            continue
        op, v, s, t = case["op"], case["videos"], case["frames"], case.get("t", 1)
        n_data, n_seq = mesh.n_data, mesh.n_seq
        frames = s // n_seq

        def part(a, d, q):
            """Rank (d, q)'s part of a whole (V, S or G, ...) output."""
            a = a[d * (v // n_data):(d + 1) * (v // n_data)]
            return a if op == "groups" else a[:, q * frames:(q + 1) * frames]

        def loss_g(d, q, like):
            gen = torch.Generator().manual_seed(case["seed"] + 1000 * d + 7 * q + 1)
            return torch.randn(like.shape, generator=gen, dtype=like.dtype)

        xs = _draw(case, op)
        whole_in = {k: a.clone().requires_grad_(True) for k, a in xs.items()}
        whole = _run(op, whole_in, t, v, s)
        out_whole = whole[0] if op == "hand_state" else whole
        sum((part(out_whole, d, q) * loss_g(d, q, part(out_whole, d, q))).sum()
            for d in range(n_data) for q in range(n_seq)).backward()

        d, q = mesh.data.rank, mesh.seq.rank
        vs = mesh.videos(v)
        mine_in = {k: (mesh.frames(a[vs], 1) if k in ("x", "gx") else a[vs] if k == "h0" else a)
                   .detach().clone().requires_grad_(True) for k, a in xs.items()}
        with seq.over(mesh.seq, mesh.data):
            got = _run(op, mine_in, t, v // n_data, frames)
            got_out = got[0] if op == "hand_state" else got
            (got_out * loss_g(d, q, got_out)).sum().backward()
        errs = [(got_out - part(out_whole, d, q)).abs().max().item()]
        if op == "hand_state":  # the clip's new state, on every rank
            errs.append((got[1] - whole[1][vs]).abs().max().item())
        grads = []
        for k, a in mine_in.items():
            ref = whole_in[k].grad
            if k in ("x", "gx"):
                ref = mesh.frames(ref[vs], 1)
            elif k == "h0":
                if q > 0:  # the carried state is read by the first seq rank alone
                    assert a.grad is None or not a.grad.any()
                    continue
                ref = ref[vs]
            grad = a.grad
            if k == "w_h":  # each rank's part, summed over the mesh
                grad = mesh.everyone.all_reduce(grad)
            grads.append((grad - ref).abs().max().item())
        out.append({"case": case, "coords": coords(mesh), "forward": max(errs),
                    "backward": max(grads),
                    "scale": max(out_whole.abs().max().item(),
                                 max(a.grad.abs().max().item() for a in whole_in.values()))})
    return out
