"""Hand-written CUDA kernels for Hopper (sm_90a) on the FedEEC main path:

  distill_loss  fused CE + beta*KL over the vocabulary axis, forward and
                backward (BSBODP Eq. 3/32; a torch.autograd.Function)
  skr_rectify   the SKR rectification map (Eq. 31)

Each kernel: a CUDA source in ``repro_torch/csrc``, a wrapper module here
(<name>.py), a plain PyTorch version in ref.py, and a public entry point in
ops.py. ``_lib`` builds the sources at first use and counts launches.
"""
