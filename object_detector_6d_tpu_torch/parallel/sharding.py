"""Frames over ``data``, the template bank and the ICP hypothesis lanes
over ``model``: a 2D device mesh over torch.distributed (port of
object_detector_6d_tpu/parallel/sharding.py).

* **data axis**: each rank quantizes, matches and refines its own
  contiguous share of the frame batch;
* **model axis**: in the match stage each rank sweeps its contiguous
  share of the packed template bank and the candidates merge with one
  all_gather and a re-ranking (match/program.py
  ``merge_shard_candidates``); in the refine stage each rank runs its
  contiguous share of every frame's ICP hypothesis lanes and all_gathers
  merge them (api/detect_program.py).

Every rank is one process with a real process group: the caller starts
the processes (torchrun, or a spawned group) and calls
``torch.distributed.init_process_group`` before ``make_mesh``. Every
rank is given the whole batch and the whole bank and returns the whole
result, as the reference's ``shard_map`` takes and returns global arrays.
The sharded programs live with the programs they shard; this module
builds the mesh and holds the one collective they use.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist


def mesh_shape(n: int) -> Tuple[int, int]:
    """(data, model) sizes for ``n`` ranks, the reference's square-ish
    factorization: the model axis takes the larger factor (1 -> (1, 1),
    2 -> (1, 2), 4 -> (2, 2), 8 -> (2, 4))."""
    tp = 1
    for cand in (2, 4, 8):
        if n % cand == 0 and n // cand <= cand:
            tp = cand
            break
    else:
        for cand in (8, 4, 2):
            if n % cand == 0:
                tp = cand
                break
    return n // tp, tp


def make_mesh(n_devices: Optional[int] = None, device="cuda"):
    """2D (data, model) DeviceMesh over the first ``n_devices`` ranks of
    the initialized process group (all of them when None), on ``device``'s
    type. Raises ValueError when no process group is initialized or the
    world has fewer ranks than asked for: it never starts a group by
    itself and never shrinks the mesh."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            "make_mesh needs an initialized torch.distributed process group: start "
            "one process per rank (torchrun, or a spawned group) and call "
            "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    n = n_devices or world
    if world < n:
        raise ValueError(f"make_mesh({n}) needs {n} ranks but the process group has "
                         f"{world} ({dist.get_backend()} backend)")
    dp, tp = mesh_shape(n)
    device_type = torch.device(device).type
    names = ("data", "model")
    if n == world:
        return init_device_mesh(device_type, (dp, tp), mesh_dim_names=names)
    return DeviceMesh(device_type, torch.arange(n).reshape(dp, tp), mesh_dim_names=names)


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along ``axis`` ("data" or "model")."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def all_gather_cat(t: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` along the mesh ``axis``, concatenated along
    ``dim`` in the axis's rank order (bool goes over the wire as uint8)."""
    group = mesh.get_group(axis)
    wire = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat(parts, dim)
    return out.to(torch.bool) if t.dtype == torch.bool else out
