"""Production meshes. A FUNCTION, not a module-level constant: importing
this module touches no process group.

PyTorch port of the reference's ``repro.launch.mesh``: 16×16 (data, model)
or 2×16×16 (pod, data, model) over the live ``torch.distributed`` world,
one rank a device. With fewer ranks it raises the reference launcher's
``ValueError`` (``jax.make_mesh``'s message).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import MULTI_POD, SINGLE_POD


def mesh_config(*, multi_pod: bool = False):
    return MULTI_POD if multi_pod else SINGLE_POD


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    import torch.distributed as dist

    from repro_torch.parallel.sharding import make_mesh_from_config

    cfg = mesh_config(multi_pod=multi_pod)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < cfg.n_devices:
        raise ValueError(f"Number of devices {have} must be >= the product "
                         f"of mesh_shape {cfg.shape}")
    return make_mesh_from_config(cfg, device_type)
