"""PyTorch + CUDA port of the FedEEC reproduction in ``repro``.

The package mirrors ``repro``'s module layout (``configs``, ``data``,
``core``, ``models``, ``optim``, ``fl``, ``kernels``) so each module has an
obvious counterpart. It imports neither JAX nor anything of ``repro``: the
numpy-only modules it needs are its own copies. The FedEEC student loss and
teacher rectification run through hand-written CUDA kernels for Hopper
(``repro_torch/csrc``) whenever their tensors live on the card.
"""
