"""Production mesh definitions.

Single pod:  (data=16, model=16)            = 256 GPUs
Multi-pod:   (pod=2, data=16, model=16)     = 512 GPUs

Defined as functions over the process group the caller has started, so
importing this module touches no process-group state (the dry run starts a
fake group of 256 or 512 ranks first; `make_host_mesh` starts a group of
one if none is running)."""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type="cpu"):
    """A `DeviceMesh` of the reference's shape and axis names over the
    running process group, which must have 256 ranks (512 with
    `multi_pod`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device="cuda"):
    """Degenerate 1x1 mesh (data, model) over a world-size-1 group, on the
    card unless asked for "cpu".  Starts that group (over gloo on a free
    local port, or nccl on the card) if none is running; the caller
    destroys it."""
    if not dist.is_initialized():
        import socket
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                rank=0, world_size=1)
    return init_device_mesh(device, (1, 1), mesh_dim_names=("data", "model"))


# H100 SXM hardware constants (roofline denominators), per GPU
PEAK_FLOPS_BF16 = 989e12   # dense bf16 tensor-core peak, H100 SXM data sheet
HBM_BW = 3.35e12           # HBM3 bytes/s, H100 SXM data sheet
# bytes/s a GPU sends over the network: one NDR InfiniBand port at 400 Gb/s.
# The 16-wide model axis spans two 8-GPU NVLink nodes, so its collectives
# cross the network; NVLink 4's 450e9 a direction (same sheet) would hold
# within a node and is not used.
ICI_BW = 50e9
