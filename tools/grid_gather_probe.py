"""Gloo collectives on CUDA tensors of ranks that share one NVIDIA GPU.

    python3 tools/grid_gather_probe.py

The dry run's dp x tp grid (opus_tpu_torch/dryrun.py) runs on a one-card
machine as ranks sharing cuda:0 under gloo, since NCCL refuses two ranks
on one card.  This script checks that gloo's all_gather takes the CUDA
tensors of such ranks as they are, with no staging through host tensors:
worlds of 2 (dp=1 x tp=2) and 4 (dp=2 x tp=2) ranks on cuda:0
(mesh.run_ranks, ranks_per_card = world) gather a [4, 3, 1] block over
the dp group (all_gather_rows), the tp group (all_gather_channels) and
the whole world, and a [1024, 960, 1] float32 block (3.9 MB) over the tp
group.  Each rank prints its device, the backend, each gather's device,
shape, first values and host ms (after a synchronize), or the error a
gather raised, and the ints of its dp group (gather_ints), beside the
Python, torch and CUDA versions.  Needs a CUDA device.
"""

from __future__ import annotations

import pathlib
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from opus_tpu_torch.mesh import (  # noqa: E402
    all_gather_channels,
    all_gather_rows,
    gather_ints,
    grid_groups,
    run_ranks,
)


def body(rank: int, world: int, dev, dp: int, tp: int) -> dict:
    out = {"rank": rank, "dev": str(dev), "backend": dist.get_backend()}
    dp_group, tp_group = grid_groups(dp, tp)
    t = torch.full((4, 3, 1), float(rank), device=dev)
    for name, fn in (("rows", lambda: all_gather_rows(t, dp_group)),
                     ("channels", lambda: all_gather_channels(t, tp_group)),
                     ("world_rows", lambda: all_gather_rows(t))):
        try:
            t0 = time.perf_counter()
            g = fn()
            torch.cuda.synchronize()
            out[name] = (str(g.device), tuple(g.shape), g[:, 0, :].flatten().tolist()[:16],
                         (time.perf_counter() - t0) * 1e3)
        except (RuntimeError, ValueError) as e:
            out[name] = f"{type(e).__name__}: {e}"[:400]
    big = torch.randn(1024, 960, 1, device=dev)
    try:
        for _ in range(2):  # the second call is timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_gather_channels(big, tp_group)
            torch.cuda.synchronize()
        out["big_ms"] = (time.perf_counter() - t0) * 1e3
    except (RuntimeError, ValueError) as e:
        out["big_ms"] = f"{type(e).__name__}: {e}"[:400]
    out["ints"] = gather_ints([rank], dp_group)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("grid_gather_probe: no CUDA device", file=sys.stderr)
        return 2
    print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.device_count(),
          flush=True)
    for world, dp, tp in ((2, 1, 2), (4, 2, 2)):
        t0 = time.perf_counter()
        for r in run_ranks(body, world, device="cuda", args=(dp, tp), ranks_per_card=world,
                           deadline_s=120):
            print(world, r, flush=True)
        print("wall", time.perf_counter() - t0, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
