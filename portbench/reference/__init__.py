"""The plain reference the benchmark holds the program against: model
forwards by family (``resnet.py``, ``vit.py``), attributions by method
(``ig.py``, ``rollout.py``) and the perturbation battery
(``battery.py``).  Float32 plain PyTorch and NumPy; nothing here imports
the program, the JAX package or JAX (``portbench/tests/test_imports.py``).
"""
import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool = False):
    """Float32 matrix products and convolutions with TF32 off (the
    reference), or on (the lower-precision control); the flags are put
    back on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
