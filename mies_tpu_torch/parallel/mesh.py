"""Process groups and ('data', 'space') device meshes on torch.distributed.

The port of ``mies_tpu.parallel.mesh``. One process runs each device (a
rank): on the card, ``cuda:{local_rank}`` under NCCL; on the CPU, gloo.
``init_distributed`` joins the process group once per process, then
``make_mesh`` lays the ranks out as a 2-D ``DeviceMesh`` whose 'space'
dimension is innermost, so neighbouring row bands sit on neighbouring
ranks. Nothing tells a process of its cluster: give ``init_method``
(``tcp://host:port`` or a ``file://`` store), the world size and the rank,
or set the ``env://`` variables.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

MESH_DIMS = ("data", "space")


def init_distributed(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    device="cuda",
) -> torch.device:
    """Join the default process group (NCCL for ``device="cuda"``, gloo for
    "cpu") and return the device this rank runs on: ``cuda:{local_rank}``
    (``$LOCAL_RANK``, else the rank modulo the cards), made current, or
    the CPU. A second call in the same process is the benign double
    initialisation and only returns the device; any other failure raises,
    so a failed multi-process bring-up never goes on as one process."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r}: expected 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "init_distributed(device='cuda') without a card; pass "
            "device='cpu' for gloo on the CPU"
        )
    try:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
            world_size=-1 if world_size is None else world_size,
            rank=-1 if rank is None else rank,
        )
    except (RuntimeError, ValueError) as e:
        # torch says "trying to initialize the default process group twice"
        if "twice" not in str(e):
            raise
    if dev.type == "cpu":
        return dev
    local = int(os.environ.get("LOCAL_RANK",
                               dist.get_rank() % torch.cuda.device_count()))
    dev = torch.device("cuda", local)
    torch.cuda.set_device(dev)
    return dev


def mesh_devices(n: int | None = None) -> list[int]:
    """The first ``n`` ranks of the process group (all by default)."""
    ranks = list(range(dist.get_world_size()))
    if n is not None:
        if n > len(ranks):
            raise ValueError(f"requested {n} devices, have {len(ranks)}")
        ranks = ranks[:n]
    return ranks


def make_mesh(
    data: int | None = None,
    space: int = 1,
    devices: list[int] | None = None,
) -> DeviceMesh:
    """A ('data', 'space') mesh over the ranks (``devices``, default all).

    data=None uses all the ranks / space. The mesh is on the card under
    NCCL and on the CPU under gloo."""
    devs = devices if devices is not None else mesh_devices()
    if data is None:
        if len(devs) % space:
            raise ValueError(f"{len(devs)} devices not divisible by space={space}")
        data = len(devs) // space
    need = data * space
    if need > len(devs):
        raise ValueError(f"mesh {data}x{space} needs {need} devices, have {len(devs)}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(devs[:need]).reshape(data, space),
                      mesh_dim_names=MESH_DIMS)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on for ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
