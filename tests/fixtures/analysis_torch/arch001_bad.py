"""ARCH001 violation: the kernel library and the mesh APIs outside their shims."""
import ctypes

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.kernels import _lib


def launch(path, x, ranks):
    handle = ctypes.CDLL(path)
    _lib.lib().flash_attention(x.data_ptr())
    fn = getattr(_lib.lib(), "rwkv6_scan")
    held = _lib.lib()
    dist.init_process_group("gloo", rank=0, world_size=1)
    mesh = DeviceMesh("cpu", ranks)
    grid = init_device_mesh("cpu", (1,))
    return handle, fn, held, mesh, grid
