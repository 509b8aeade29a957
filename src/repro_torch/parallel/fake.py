"""A fake ``torch.distributed`` world: N ranks in one process, for tracing.

The dry-run (``launch/dryrun.py``) runs rank 0's per-rank program of a
production mesh (16 x 16 or 2 x 16 x 16 ranks) in one process, on meta
tensors. Its collectives need a process group of the mesh's size that
moves nothing: c10d's ``FakeProcessGroup`` is one. Every collective on it
returns at once and leaves its outputs as they are (on meta tensors: of
the right shape, with no data), so the program runs to its end and every
collective it issues is seen by a dispatch mode with its group.

``register()`` registers the ``fake`` backend over ``FakeProcessGroup``
once a process; ``fake_world(n)`` initializes a world of ``n`` fake ranks
as rank 0 and destroys it on exit, so one process can trace 16 x 16 and
then 2 x 16 x 16.
"""
from __future__ import annotations

import contextlib

BACKEND = "fake"


def available() -> bool:
    """Whether this PyTorch has c10d's ``FakeProcessGroup``."""
    try:
        from torch._C._distributed_c10d import FakeProcessGroup  # noqa: F401
    except ImportError:
        return False
    return True


def _create(common_opts, backend_opts=None):
    from torch._C._distributed_c10d import FakeProcessGroup

    rank, size = common_opts.group_rank, common_opts.group_size
    if hasattr(FakeProcessGroup, "_create_internal"):
        return FakeProcessGroup._create_internal(rank, size, backend_opts)
    return FakeProcessGroup(rank, size)


def register() -> None:
    """Register the ``fake`` c10d backend (once a process)."""
    import torch.distributed as dist

    if BACKEND.upper() in getattr(dist.Backend, "_plugins", {}):
        return
    dist.Backend.register_backend(BACKEND, _create, extended_api=True,
                                  devices=["cpu", "cuda"])


@contextlib.contextmanager
def fake_world(world_size: int):
    """A default process group of ``world_size`` fake ranks, this process
    rank 0, for the block; destroyed on exit. Refuses to start inside a
    live world."""
    import torch.distributed as dist

    from repro_torch.parallel import sharding as sh

    if not available():
        raise RuntimeError("this PyTorch has no FakeProcessGroup "
                           "(torch._C._distributed_c10d); the dry-run "
                           "needs it")
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the "
                           "fake world needs its own")
    register()
    dist.init_process_group(BACKEND, store=dist.HashStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
        sh._GROUPS.clear()
        sh._COORDS.clear()
