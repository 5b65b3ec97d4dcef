"""The float32 arithmetic of the port's training and eval.

cuDNN runs float32 convolutions in TF32 unless told otherwise
(``torch.backends.cudnn.allow_tf32`` is True by default), which keeps
about three decimal digits of each product; float32 matrix products run
in full float32 by default (``torch.backends.cuda.matmul.allow_tf32`` is
False). The JAX package's families train in full float32, and TF32 is
not that: on an H100 the losses of MobileLite's first SGD steps differ
from the CPU's by ~6e-3 with cuDNN's TF32 and by ~2e-6 without it
(LeNet's small convolutions run in full float32 either way). So the port
states its setting, ``CUDNN_TF32`` False and no TF32 in matrix products
either, and sets it in scope: ``LocalTrainer``'s steps and the families'
forward run inside :func:`float32_scope`, which sets both flags for the
call and restores the caller's after it. Nothing is set process wide.
"""

from __future__ import annotations

import contextlib

from .._lazy import torch

#: TF32 in cuDNN's float32 convolutions inside the port's training step
#: and forward passes (float32 matrix products there never take TF32)
CUDNN_TF32 = False


@contextlib.contextmanager
def float32_scope():
    """Run the block with cuDNN's TF32 set to ``CUDNN_TF32`` (read on
    entry) and the matrix products' off; the previous settings come back
    on exit."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32, matmul.allow_tf32 = CUDNN_TF32, False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
