"""Serving over several ranks: one process per device, the stream batch split.

The port of the mesh plumbing of the reference's multichip dry run
(`__graft_entry__.py:143-247`).  The reference lays its batch over a
device mesh with `PartitionSpec("dp")`; here each rank is one process
with one device that owns a contiguous block of the batch's streams
(`ShardSpec`) and serves it with the ordinary batched decoders, plane A
included.  What crosses ranks is the whole-batch view a caller asks for:
the PCM ring, the final ranges and the multistream frames, assembled with
`torch.distributed.all_gather` (`all_gather_rows`, `gather_ints`).

The device is explicit, as everywhere in the package: `init_ranks` binds
rank r to cuda:r under NCCL or to the CPU under gloo, as the caller's
device says, and never chooses one by itself.  `run_ranks` starts a world of ranks from one process.
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import multiprocessing.resource_tracker
import os
import pathlib
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist

#: The backend that serves each device type.
DEVICE_BACKEND = {"cuda": "nccl", "cpu": "gloo"}
#: Seconds a collective may wait before it fails (and with it the rank).
COLLECTIVE_TIMEOUT_S = 60.0


@dataclass(frozen=True)
class ShardSpec:
    """The rows of a batch of `batch` streams that rank `rank` of `world`
    owns: the contiguous block [rank * batch / world, (rank + 1) * batch /
    world), as `NamedSharding(mesh, P("dp"))` places a batch axis."""

    batch: int
    world: int
    rank: int

    def __post_init__(self):
        if self.world < 1 or not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} is not in a world of {self.world}")
        if self.batch % self.world:
            raise ValueError(f"a batch of {self.batch} does not split evenly over "
                             f"{self.world} ranks")

    @property
    def local(self) -> int:
        return self.batch // self.world

    @property
    def start(self) -> int:
        return self.rank * self.local

    @property
    def stop(self) -> int:
        return self.start + self.local

    def rows(self, xs):
        """This rank's rows of a whole-batch list or array."""
        if len(xs) != self.batch:
            raise ValueError(f"{len(xs)} rows for a batch of {self.batch}")
        return xs[self.start : self.stop]


def init_ranks(world: int, rank: int, *, init_method: str, device: str) -> torch.device:
    """Join the process group as `rank` of `world` and return the rank's
    device: cuda:rank under NCCL (device "cuda"), the CPU under gloo
    (device "cpu").  Another device, a missing card or a failed rendezvous
    raises; every collective fails after COLLECTIVE_TIMEOUT_S."""
    if device not in DEVICE_BACKEND:
        raise ValueError(f"no backend serves device {device!r} (pairs: {DEVICE_BACKEND})")
    if device == "cuda":
        if torch.cuda.device_count() <= rank:
            raise RuntimeError(f"rank {rank} needs cuda:{rank}, but "
                               f"{torch.cuda.device_count()} cards are visible")
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    dist.init_process_group(DEVICE_BACKEND[device], init_method=init_method, world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
                            device_id=dev if device == "cuda" else None)
    return dev


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of a [local, ...] tensor, concatenated in rank
    order: the [batch, ...] tensor, on every rank."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.cat(parts)


def gather_ints(xs) -> list[int]:
    """Every rank's list of ints, concatenated in rank order, on every rank."""
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, [int(x) for x in xs])
    return [x for part in parts for x in part]


def _rank_main(fn, world: int, rank: int, device: str, init_method: str, args: tuple,
               out_dir: str) -> None:
    """A rank's process: join the group, run fn, leave its result (or its
    traceback) in out_dir.  A failing rank stamps its traceback with the
    system's monotonic clock before its exit closes its connections, so
    its stamp is older than those of the ranks that fail because it left."""
    out = pathlib.Path(out_dir)
    try:
        if device == "cpu":
            torch.set_num_threads(1)  # the ranks share the host's cores
        dev = init_ranks(world, rank, init_method=init_method, device=device)
        result = fn(rank, world, dev, *args)
        dist.barrier()
        dist.destroy_process_group()
        with open(out / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    except BaseException:  # noqa: BLE001  (reported to the parent, which raises)
        stamp = time.monotonic_ns()
        (out / f"rank{rank}.err").write_text(f"{stamp}\n{traceback.format_exc()}")
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


def run_ranks(fn, world: int, *, device: str, args: tuple = (),
              deadline_s: float = 300.0) -> list:
    """Run fn(rank, world, device, *args) in `world` new processes, one a
    rank on `device` ("cuda" or "cpu", as init_ranks), and return their
    results in rank order.

    The ranks are spawned (a forked child cannot use CUDA once the parent
    has) and meet through a file in a new temporary directory, so no port is
    taken.  `fn` and `args` must pickle: fn by reference, so it lives in a
    module the children can import.  If a rank fails, the others are
    killed and the traceback of the rank that failed first is raised as a
    RuntimeError; past `deadline_s` every rank is killed and TimeoutError
    raised.  No process outlives the call: the ranks are joined, and the
    resource tracker that spawning starts, when this call started it, is
    stopped and reaped."""
    ctx = multiprocessing.get_context("spawn")
    tracker = multiprocessing.resource_tracker._resource_tracker
    had_tracker = tracker._fd is not None
    tmp = tempfile.mkdtemp(prefix="opus_ranks_")
    init_method = pathlib.Path(tmp, "rendezvous").as_uri()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, world, r, device, init_method, args, tmp),
                         name=f"rank{r}")
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        end = time.monotonic() + deadline_s
        running = set(range(world))
        while running:
            left = end - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(running)} of {world} still running after "
                                   f"{deadline_s} s")
            multiprocessing.connection.wait([procs[r].sentinel for r in running], left)
            ended = [r for r in running if procs[r].exitcode is not None]
            running.difference_update(ended)
            failed = [r for r in ended if procs[r].exitcode != 0]
            if failed:
                # (stamp, traceback); a rank killed before it could write has none
                errs = {r: pathlib.Path(tmp, f"rank{r}.err") for r in failed}
                errs = {r: e.read_text().split("\n", 1) if e.exists()
                        else (float("inf"), f"exit code {procs[r].exitcode}")
                        for r, e in errs.items()}
                r = min(failed, key=lambda r: (float(errs[r][0]), r))
                raise RuntimeError(f"rank {r} of {world} failed:\n{errs[r][1]}")
        results = []
        for r in range(world):
            with open(pathlib.Path(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join()
        if not had_tracker:
            tracker._stop()
        shutil.rmtree(tmp, ignore_errors=True)
