"""ARCH001 clean: launches through _lib.launch, query entries, meshes through the shim."""
import ctypes

from repro_torch.kernels import _lib
from repro_torch.launch.mesh import make_host_mesh


def launch(x, dev):
    _lib.launch("rwkv6_scan", dev, x.data_ptr(), count_as="rwkv6_scan")
    return make_host_mesh(device="cpu")


def query(hd, chunk):
    need = ctypes.c_longlong(0)
    _lib.lib().rwkv6_scan_bwd_smem(hd, chunk, ctypes.byref(need))
    attrs = getattr(_lib.lib(), "flash_attention_attrs")
    return need.value, attrs, _lib.kernel_attrs("flash_attention_sm90_attrs", 128, 128)
