"""Hand-written CUDA kernels for Hopper (sm_90a) on the FedEEC main path:

  distill_loss  fused CE + beta*KL over the vocabulary axis, forward and
                backward (BSBODP Eq. 3/32; a torch.autograd.Function)
  skr_rectify   the SKR rectification map (Eq. 31)

and on the LM serving path:

  flash_attention  GQA attention with causal / sliding-window masks, prefill
                   and decode (forward only)
  rwkv6_scan       the RWKV6 time-mix recurrence (forward only)

Each kernel: a CUDA source in ``repro_torch/csrc``, a wrapper module here
(<name>.py), a plain PyTorch version in ref.py, and a public entry point in
ops.py. ``_lib`` builds the sources at first use and counts launches.
"""
