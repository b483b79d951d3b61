"""Process-group initialisation (port of ``tsar_mvs_tpu.parallel.
distributed``).

The JAX package joins hosts with `jax.distributed`; here the ranks join a
`torch.distributed` process group. The environment contract is the JAX
package's own, set by the launcher for every process:

    TSAR_COORDINATOR     host:port of rank 0 (enables the group)
    TSAR_NUM_PROCESSES   number of ranks
    TSAR_PROCESS_ID      this process's rank
    TSAR_BACKEND         optional: "nccl" (one rank per GPU, the default
                         with a card) or "gloo" (CPU ranks, or ranks that
                         share one card)

Without TSAR_COORDINATOR `initialize()` does nothing and the mesh is a
world of one (`parallel.mesh.view_mesh`).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize(backend: str | None = None) -> bool:
    """Join the process group the TSAR_* environment describes. Returns
    True when a group is active (this call's or one the caller made).
    Idempotent; a no-op without TSAR_COORDINATOR. `backend` defaults to
    TSAR_BACKEND, else "nccl" with a CUDA device and "gloo" without."""
    if dist.is_initialized():
        return True
    coord = os.environ.get("TSAR_COORDINATOR")
    if not coord:
        return False
    backend = (backend or os.environ.get("TSAR_BACKEND")
               or ("nccl" if torch.cuda.is_available() else "gloo"))
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coord}",
        world_size=int(os.environ.get("TSAR_NUM_PROCESSES", "1")),
        rank=int(os.environ.get("TSAR_PROCESS_ID", "0")))
    return True


def global_view_mesh(device: torch.device | str = "cuda"):
    """The view mesh of the initialised group (a world of one without
    one), on `device`."""
    from tsar_mvs_tpu_torch.parallel import mesh
    return mesh.view_mesh(device)


def process_local_slice(n_total: int, rank: int | None = None,
                        world: int | None = None) -> slice:
    """This rank's contiguous slice of a length-n_total view axis:
    ceil(n_total / world) views each, the last rank's slice shorter (or
    empty). rank and world default to the initialised group's (0 and 1
    without one)."""
    if rank is None or world is None:
        active = dist.is_initialized()
        rank = dist.get_rank() if active else 0
        world = dist.get_world_size() if active else 1
    per = -(-n_total // world)
    return slice(min(rank * per, n_total), min((rank + 1) * per, n_total))


def _rank_main(rank: int, fn, world: int, init_method: str, backend: str,
               args: tuple) -> None:
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world, rank=rank)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, init_method: str, backend: str = "gloo",
              args: tuple = ()) -> None:
    """Run fn(*args) in `world` spawned processes joined in one process
    group (`init_method`, e.g. "file:///tmp/pg" or "tcp://localhost:<port>")
    and wait for them; fn must be importable by the children (a module-level
    function). Raises if any rank fails. Under gloo the ranks may share one
    card; under NCCL each needs its own. Build the CUDA kernels once in the
    caller first (one launch of each wrapper), or every rank builds them."""
    import torch.multiprocessing as mp
    mp.start_processes(_rank_main,
                       args=(fn, world, init_method, backend, tuple(args)),
                       nprocs=world, join=True, start_method="spawn")
