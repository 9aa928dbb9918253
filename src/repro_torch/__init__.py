"""repro_torch: the PyTorch/CUDA port of ``repro``'s serving and training
paths (``launch/serve.py``, ``launch/train.py``).

Module names mirror ``src/repro/``.  The package imports ``torch`` and
``numpy`` only; each kernel of the serving path is a hand-written CUDA
C++ kernel for Hopper (``csrc/``), with a plain PyTorch version beside it
that runs whenever the tensors lie on the CPU.  Training runs plain
PyTorch ops, as the reference's trainer runs plain jnp.
"""
