"""Run one function on every rank of a ``torch.distributed`` group, one
process per rank.

``run_ranks(fn, world, *args)`` starts ``world`` processes with the
``spawn`` start method (the caller may have initialized CUDA, which a
forked child cannot use), rendezvous through a ``file://`` store in a
temporary directory, and calls ``fn(rank, world, *args)`` in each. On the
card, rank r takes card ``r % torch.cuda.device_count()`` before it makes
any tensor; the backend is NCCL when every rank has a card of its own and
gloo otherwise (NCCL refuses two ranks on one card). ``device="cpu"`` runs
the ranks on the CPU over gloo.

``fn`` must be importable by name (a module-level function), and its
arguments and result picklable. The call returns the ranks' results in rank
order. A rank that raises makes the call raise, with the rank's traceback,
after the other ranks are stopped.

The CUDA libraries (ops/cuda_build.py) may be built by the caller before
the call, or at first use on several ranks at once: each rank's nvcc writes
a file named by its pid and renames it into place, so concurrent builds of
one library are safe.
"""

from __future__ import annotations

import os
import pickle
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank, fn, world, n_cards, backend, init_method, results, args):
    if n_cards:
        torch.cuda.set_device(rank % n_cards)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    try:
        # Plain pickle: a tensor's bytes travel in the message, not in shared
        # memory that this process releases when it exits.
        results.put((rank, pickle.dumps(fn(rank, world, *args))))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args, device: str = "cuda") -> list:
    """``fn(rank, world, *args)`` on each of ``world`` ranks; their results
    in rank order. Runs on the card unless given ``device="cpu"``."""
    if world < 1:
        raise ValueError(f"a group needs at least one rank, got {world}")
    kind = torch.device(device).type
    if kind == "cuda":
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError("no CUDA device: give device='cpu' to run the ranks on the CPU")
        backend = "nccl" if n_cards >= world else "gloo"
    elif kind == "cpu":
        n_cards, backend = 0, "gloo"
    else:
        raise ValueError(f"ranks run on 'cuda' or 'cpu', not {device!r}")
    results = mp.get_context("spawn").SimpleQueue()
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs = mp.start_processes(
            _rank_main, args=(fn, world, n_cards, backend, init_method, results, args),
            nprocs=world, join=False, start_method="spawn")
        # Read the results while the ranks run: a rank blocks on a full pipe
        # until they are read.
        done = False
        while not done:
            done = procs.join(timeout=0.1)
            while not results.empty():
                rank, value = results.get()
                got[rank] = pickle.loads(value)
    return [got[r] for r in range(world)]
