"""repro_torch: the PyTorch/CUDA port of ``repro``'s serving and training
paths (``launch/serve.py``, ``launch/train.py``).

Module names mirror ``src/repro/``.  The package imports ``torch``,
``numpy`` and ``scipy`` only; each kernel of the serving path is a
hand-written CUDA C++ kernel for Hopper (``csrc/``), with a plain PyTorch
version beside it that runs whenever the tensors lie on the CPU.  The
kernels' plans come from the port's own copy of the PolyTOPS scheduler
(``core/``, pure Python: exact ILP scheduling, schedule trees and their
lowering to the kernels' tiles).  Training runs plain PyTorch ops, as
the reference's trainer runs plain jnp.
"""
