"""The data axis: ranks that each hold their own videos (counterpart of the
`data` axis of `iip_uavsal_saliency_tpu/parallel/mesh.py`).

The JAX package builds a pure-`data` mesh from `--dp_devices` and lets jit
(training) or `shard_map` (serving) run each device's shard of the video
batch V. Here each shard is a process, a rank of a `torch.distributed`
group:

- `spawn(fn, world, backend)` starts `world` ranks with
  `torch.multiprocessing`, which meet through a `file://` rendezvous in a
  temporary directory (no TCP port: several runs may share a host), runs
  `fn(group, *args)` on each and returns what each returned;
- `RankGroup` is what a rank knows: its rank, the world size, the backend
  and its device; `rows(v)` is its contiguous rows of a V batch, as
  `P("data")` places them (rank r holds rows r*V/N ... (r+1)*V/N - 1);
- the collectives the port runs over it (`all_reduce`, `all_gather`,
  `broadcast_object`, `barrier`, and `rank0_first`);
- `make_mesh(group, n_data, n_spatial, n_seq)` lays the ranks out as the
  JAX `make_mesh` lays devices out (`devices[:n].reshape(n_data, n_spatial,
  n_seq, n_model)`: rank (d * n_spatial + s) * n_seq + q holds data
  coordinate d, spatial coordinate s and seq coordinate q) and gives each
  rank a `Mesh`: an `Axis` per mesh axis (its index along it, the axis's
  ranks and a `torch.distributed` subgroup over them) and one over every
  rank of the mesh (train-mode BatchNorm and the gradients). The `model`
  axis is not ported (ROADMAP A.13.3), nor a mesh with both a spatial and a
  seq axis (A.13.2b).

The backend is the caller's choice and is never replaced by another:
"nccl" when every rank has a card of its own (`--dp_devices N`), "gloo" on
the CPU and where several ranks share one card. Gloo's collectives are run
on host copies of CUDA tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import logging
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
# how long a collective may wait for its peers before it fails (a rank that
# stops alone would hang the others)
DEFAULT_TIMEOUT_S = 1800.0


@dataclasses.dataclass(frozen=True)
class RankGroup:
    """One rank of a data-parallel run (the default process group): `rank`
    of `world`, the `backend` its collectives run on, and its `device`."""

    rank: int
    world: int
    backend: str
    device: torch.device

    @property
    def is_first(self) -> bool:
        """Rank 0, the one that writes checkpoints and metrics."""
        return self.rank == 0

    def rows(self, v: int) -> slice:
        """This rank's contiguous rows of a batch of V videos (V a multiple
        of the world size)."""
        if v % self.world:
            raise ValueError(f"a batch of {v} videos does not split over {self.world} ranks")
        n = v // self.world
        return slice(self.rank * n, (self.rank + 1) * n)

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """t where this backend reduces it: gloo on host copies, nccl on the
        rank's card."""
        if self.backend == "gloo":
            return t.cpu()
        return t.to(self.device)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of t over the ranks, as a new tensor on t's device; t is
        left as it was."""
        staged = self._staged(t).clone()
        dist.all_reduce(staged)
        return staged.to(t.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's t stacked in rank order, (world, *t.shape), on t's
        device."""
        staged = self._staged(t).contiguous()
        out = [torch.empty_like(staged) for _ in range(self.world)]
        dist.all_gather(out, staged)
        return torch.stack(out).to(t.device)

    def broadcast_object(self, obj: Any) -> Any:
        """Rank 0's `obj` (picklable), on every rank."""
        box = [obj]
        device = self.device if self.backend == "nccl" else None
        dist.broadcast_object_list(box, src=0, device=device)
        return box[0]

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def rank0_first(group: Optional[RankGroup], fn: Callable[[], Any]) -> Any:
    """`fn()` on rank 0, then on every other rank: what rank 0 writes (a
    cache of the observed priors, say) the others then read. Without a
    group, `fn()`."""
    if group is None:
        return fn()
    if not group.is_first:
        group.barrier()
    out = fn()
    if group.is_first:
        group.barrier()
    return out


def check_backend(backend: str, device_type: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: the data axis runs on {' or '.join(BACKENDS)}")
    if backend == "nccl" and device_type != "cuda":
        raise ValueError("the nccl backend needs a card per rank (device_type='cuda')")


def rank_device(rank: int, backend: str, device_type: str) -> torch.device:
    """The device of `rank`: the CPU, `cuda:rank` under nccl (a card each),
    and `cuda:0` for every rank under gloo on the card (ranks sharing it)."""
    check_backend(backend, device_type)
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"device_type {device_type!r}: cpu or cuda")
    return torch.device("cuda", rank if backend == "nccl" else 0)


def check_cards(world: int) -> None:
    """SystemExit unless `world` ranks can have a card each: at least as
    many visible cards as ranks (the JAX CLI's check of `--dp_devices`
    against the devices it sees)."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if world > have:
        raise SystemExit(f"--dp_devices {world} needs {world} CUDA cards, {have} are visible "
                         "(pass --device cpu to run the ranks on the CPU)")


def init_ranks(rank: int, world: int, backend: str, init_file: str, device_type: str = "cpu",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> RankGroup:
    """Join the `world` ranks that meet at `init_file` (a path, the
    rendezvous of `torch.distributed`'s `file://` method) as `rank`; a
    collective that waits longer than `timeout_s` for its peers raises."""
    device = rank_device(rank, backend, device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    return RankGroup(rank, world, backend, device)


def _rank_main(rank: int, world: int, backend: str, device_type: str, run_dir: str,
               timeout_s: float, threads: int, fn: Callable, args: Sequence) -> None:
    """A spawned rank: join, run `fn(group, *args)`, leave its result (or
    its traceback) in `run_dir`, and leave the group."""
    if threads:
        torch.set_num_threads(threads)
    out = os.path.join(run_dir, f"rank{rank}")
    try:
        group = init_ranks(rank, world, backend, os.path.join(run_dir, "rendezvous"),
                           device_type, timeout_s)
        try:
            result = fn(group, *args)
        finally:
            dist.destroy_process_group()
        with open(out + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(out + ".tmp", out + ".out")
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn: Callable, world: int, backend: str, args: Sequence = (),
          device_type: str = "cpu", timeout_s: float = DEFAULT_TIMEOUT_S,
          threads: int = 0, deadline_s: Optional[float] = None) -> List[Any]:
    """Run `fn(group, *args)` on `world` new processes, rank r with the
    `RankGroup` of rank r, and return their results in rank order (each
    must pickle). `fn` must be importable by name (a function of a module,
    not of a test or a closure). `timeout_s` bounds each collective's wait
    for its peers, not the run: a run takes as long as its ranks do.
    `threads` > 0 sets each rank's intra-op threads. The ranks and their
    rendezvous live in a temporary directory that is removed after. Any
    rank's failure, or, where `deadline_s` is given, a run longer than
    `deadline_s` seconds, ends every rank and raises RuntimeError with the
    ranks' tracebacks."""
    import torch.multiprocessing as mp

    check_backend(backend, device_type)
    if world < 1:
        raise ValueError(f"world size {world} < 1")
    run_dir = tempfile.mkdtemp(prefix="uavsal_ranks_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, backend, device_type, run_dir, timeout_s, threads, fn,
                               tuple(args)))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = None if deadline_s is None else time.monotonic() + deadline_s
        while not all(p.exitcode == 0 for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs) or (
                    deadline is not None and time.monotonic() > deadline):
                break
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            time.sleep(1.0)  # the others' tracebacks, where a peer's failure ended them
            reports = []
            for r in failed:
                err = os.path.join(run_dir, f"rank{r}.err")
                code = procs[r].exitcode
                text = open(err).read() if os.path.exists(err) else ""
                reports.append(f"rank {r} ({'still running' if code is None else f'exit code {code}'}):"
                               f"\n{text}")
            raise RuntimeError(f"{len(failed)} of {world} ranks failed or timed out\n"
                               + "\n".join(reports))
        results = []
        for r in range(world):
            with open(os.path.join(run_dir, f"rank{r}.out"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(run_dir, ignore_errors=True)


_batch_group: Optional[RankGroup] = None


def batch_group() -> Optional[RankGroup]:
    """The group whose ranks hold the rest of the batch being trained (set
    by `batch_over`), or None."""
    return _batch_group


@contextlib.contextmanager
def batch_over(group: Optional[RankGroup]) -> Iterator[None]:
    """Inside, train-mode BatchNorm reduces its statistics over the ranks
    of `group` (`parallel/batchnorm.py`), as one jit over the whole batch
    does in the JAX package. A global, not a thread-local: the autograd
    engine recomputes a checkpointed forward on a thread of its own. None
    leaves the batch a rank's own."""
    global _batch_group
    prev, _batch_group = _batch_group, group
    try:
        yield
    finally:
        _batch_group = prev


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of a mesh as one of its ranks sees it: `rank`, this rank's
    index along the axis, of `world`; `ranks`, the global ranks on the axis
    in index order; and `pg`, the `torch.distributed` group over them (None
    for the default group, which is the whole world). Its collectives are
    `RankGroup`'s over that group, so it stands where a `RankGroup` does
    (`batch_over`, `all_reduce_grads`, a masked loss's count)."""

    rank: int
    world: int
    ranks: Tuple[int, ...]
    backend: str
    device: torch.device
    pg: Any = None

    def peer(self, index: int) -> int:
        """The global rank at `index` along the axis."""
        return self.ranks[index]

    def staged(self, t: torch.Tensor) -> torch.Tensor:
        """t where this backend moves it: gloo on host copies, nccl on the
        rank's card."""
        return t.cpu() if self.backend == "gloo" else t.to(self.device)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        staged = self.staged(t).clone()
        if self.world > 1:
            dist.all_reduce(staged, group=self.pg)
        return staged.to(t.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        staged = self.staged(t).contiguous()
        if self.world == 1:
            return staged.unsqueeze(0).to(t.device)
        out = [torch.empty_like(staged) for _ in range(self.world)]
        dist.all_gather(out, staged, group=self.pg)
        return torch.stack(out).to(t.device)

    def exchange(self, sends, recvs) -> None:
        """Point to point: `sends` and `recvs` are (index on the axis,
        tensor) pairs, the tensors where this backend moves them (`staged`);
        every send is matched by the peer's recv of the same shape."""
        ops = [dist.P2POp(dist.isend, t, self.peer(p), self.pg) for p, t in sends]
        ops += [dist.P2POp(dist.irecv, t, self.peer(p), self.pg) for p, t in recvs]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()

    def broadcast(self, t: torch.Tensor, index: int) -> torch.Tensor:
        """The t of the rank at `index` along the axis, as a new tensor on
        t's device on every rank (t of the same shape and dtype on each)."""
        staged = self.staged(t).clone()
        if self.world > 1:
            dist.broadcast(staged, self.peer(index), group=self.pg)
        return staged.to(t.device)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A rank's place in a ('data', 'spatial', 'seq', 'model') mesh
    (`make_mesh`): `shape` holds each axis's size, `group` the rank's
    `RankGroup`; `data`, `spatial` and `seq` are its axes and `everyone`
    the axis of every rank of the mesh, all four None on a rank the mesh
    leaves idle."""

    shape: Dict[str, int]
    group: RankGroup
    data: Optional[Axis]
    spatial: Optional[Axis]
    seq: Optional[Axis]
    everyone: Optional[Axis]

    @property
    def active(self) -> bool:
        return self.data is not None

    @property
    def n_data(self) -> int:
        return self.shape["data"]

    @property
    def n_spatial(self) -> int:
        return self.shape["spatial"]

    @property
    def n_seq(self) -> int:
        return self.shape["seq"]

    def videos(self, v: int) -> slice:
        """This rank's rows of a batch of V videos over the data axis."""
        self.check_active()
        if v % self.n_data:
            raise ValueError(f"a batch of {v} videos does not split over {self.n_data} data ranks")
        n = v // self.n_data
        return slice(self.data.rank * n, (self.data.rank + 1) * n)

    def band(self, a, dim: int):
        """This rank's rows of the whole array or tensor `a` along `dim`, as
        `P("spatial")` places them at a step's boundary: equal bands, and a
        ValueError where the rows do not split evenly (what the JAX step's
        jit raises)."""
        self.check_active()
        rows = a.shape[dim]
        if rows % self.n_spatial:
            raise ValueError(f"{rows} image rows do not split over {self.n_spatial} spatial ranks")
        n = rows // self.n_spatial
        index = [slice(None)] * len(a.shape)
        index[dim] = slice(self.spatial.rank * n, (self.spatial.rank + 1) * n)
        return a[tuple(index)]

    def frames(self, a, dim: int):
        """This rank's frames of the whole array or tensor `a` along `dim`,
        as `P("seq")` places them at a step's boundary: equal runs of
        consecutive frames in seq order, and a ValueError where the frames
        do not split evenly (what the JAX step's jit raises)."""
        self.check_active()
        n_frames = a.shape[dim]
        if n_frames % self.n_seq:
            raise ValueError(f"{n_frames} frames do not split over {self.n_seq} seq ranks")
        n = n_frames // self.n_seq
        index = [slice(None)] * len(a.shape)
        index[dim] = slice(self.seq.rank * n, (self.seq.rank + 1) * n)
        return a[tuple(index)]

    def check_active(self) -> None:
        if not self.active:
            raise ValueError(f"rank {self.group.rank} is idle in this {self.shape} mesh")


def make_mesh(group: RankGroup, n_data: Optional[int] = None, n_spatial: int = 1,
              n_seq: int = 1, n_model: int = 1) -> Mesh:
    """This rank's place in a (data, spatial, seq, model) mesh over the
    ranks of `group`'s world (counterpart of the JAX `make_mesh`; every rank
    must call it, with the same arguments, as it creates the axes' groups).
    `n_data` None takes every rank the other axes leave. Too few ranks
    raise ValueError; ranks left over are idle (a warning, and a mesh whose
    axes are None). The `model` axis, and a spatial axis beside a seq axis,
    are not ported."""
    if n_model > 1:
        raise NotImplementedError("the mesh's model axis is not ported (ROADMAP A.13.3)")
    if n_spatial > 1 and n_seq > 1:
        raise NotImplementedError("a mesh with both a spatial and a seq axis is not ported "
                                  "(ROADMAP A.13.2b)")
    world = group.world
    per_shard = n_spatial * n_seq * n_model
    if n_data is None:
        n_data = world // per_shard
    if n_data < 1 or n_spatial < 1 or n_seq < 1:
        raise ValueError(f"mesh needs n_spatial*n_seq*n_model = {per_shard} "
                         f"ranks per data shard, have {world}")
    n = n_data * per_shard
    if n > world:
        raise ValueError(f"mesh {n_data}x{n_spatial}x{n_seq}x{n_model} needs {n} ranks, "
                         f"have {world}")
    if n < world:
        logging.getLogger("uavsal.mesh").warning(
            "mesh %dx%dx%dx%d uses %d of %d ranks — %d sit idle", n_data, n_spatial, n_seq,
            n_model, n, world, world - n)

    def axis_of(ranks: Sequence[int]) -> Optional[Axis]:
        """The axis over `ranks`; every rank of the world takes part in
        making its group, in the same order."""
        ranks = tuple(ranks)
        pg = None
        if 1 < len(ranks) < world:
            pg = dist.new_group(list(ranks))
        if group.rank not in ranks:
            return None
        return Axis(ranks.index(group.rank), len(ranks), ranks, group.backend, group.device, pg)

    def rank(d: int, s: int, q: int) -> int:
        return (d * n_spatial + s) * n_seq + q

    data = [axis_of([rank(d, s, q) for d in range(n_data)])
            for s in range(n_spatial) for q in range(n_seq)]
    spatial = [axis_of([rank(d, s, q) for s in range(n_spatial)])
               for d in range(n_data) for q in range(n_seq)]
    seq = [axis_of([rank(d, s, q) for q in range(n_seq)])
           for d in range(n_data) for s in range(n_spatial)]
    everyone = axis_of(range(n))
    mine = (lambda axes: next((a for a in axes if a is not None), None))
    shape = {"data": n_data, "spatial": n_spatial, "seq": n_seq, "model": n_model}
    return Mesh(shape, group, mine(data), mine(spatial), mine(seq), everyone)
