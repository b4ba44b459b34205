"""Start ranks for the multi-device solves (parallel/mesh.py,
parallel/shard_prepare.py).

`run_ranks(fn, world_size, *args)` spawns `world_size` processes with
torch.multiprocessing (the spawn method: each starts from a fresh
import), joins them into one process group through a `file://`
rendezvous in a private temporary directory (so concurrent callers never
share a TCP port), calls `fn(*args)` in every rank and returns the
ranks' return values in rank order (arguments and results go through
torch.save files in that directory; CPU tensors and numpy arrays
travel). `fn` must be importable by module path (a function of a package
module, not of a test file); a script that calls run_ranks does so under
`if __name__ == "__main__"`, since each rank imports the main module.

backend "nccl" (the default) gives rank r CUDA device r and needs that
many cards (NCCL refuses two ranks on one GPU); "gloo", asked for by
name, runs CPU ranks, one intra-op thread each. Every rank ends with
destroy_process_group. A rank that raises makes run_ranks raise.
`start_ranks` starts the ranks and returns at once, so the caller can
work while they run; its `join()` gives the results.

On a cluster, start the ranks with the cluster's launcher instead and
call torch.distributed.init_process_group with its address, world size
and rank; the solves need only an initialized default group.
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("gloo", "nccl")


def _rank_main(rank: int, fn, world_size: int, backend: str,
               tmp: str) -> None:
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend,
                            init_method=f"file://{tmp}/rendezvous",
                            world_size=world_size, rank=rank)
    try:
        res = fn(*torch.load(os.path.join(tmp, "args.pt"),
                             weights_only=False))
        torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


class Ranks:
    """Ranks started by start_ranks: they run while the caller goes on;
    join() waits for them and returns their results in rank order."""

    def __init__(self, fn, world_size: int, args: tuple, backend: str):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
        if backend == "nccl" and torch.cuda.device_count() < world_size:
            raise RuntimeError(f"nccl: {world_size} ranks need as many "
                               f"CUDA devices, found "
                               f"{torch.cuda.device_count()}")
        self.world_size = world_size
        self._tmp = tempfile.TemporaryDirectory(prefix="onbody_ranks_")
        tmp = self._tmp.name
        # the arguments travel in a file: in spawn's pipe, arguments past
        # its buffer would hold each start until the rank before it had
        # imported torch
        torch.save(args, os.path.join(tmp, "args.pt"))
        self._ctx = mp.spawn(_rank_main, args=(fn, world_size, backend, tmp),
                             nprocs=world_size, join=False)

    def join(self) -> list:
        try:
            while not self._ctx.join():
                pass
            return [torch.load(os.path.join(self._tmp.name, f"rank{r}.pt"),
                               weights_only=False)
                    for r in range(self.world_size)]
        finally:
            self._tmp.cleanup()


def start_ranks(fn, world_size: int, *args, backend: str = "nccl") -> Ranks:
    """Start fn(*args) in each of world_size new ranks of one process
    group and return at once; Ranks.join() collects the results."""
    return Ranks(fn, world_size, args, backend)


def run_ranks(fn, world_size: int, *args, backend: str = "nccl") -> list:
    """fn(*args) in each of world_size new ranks of one process group;
    returns their results in rank order."""
    return start_ranks(fn, world_size, *args, backend=backend).join()
