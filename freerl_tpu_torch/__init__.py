"""freerl_tpu_torch: the PyTorch / CUDA port of ``freerl_tpu`` for one
NVIDIA H100.

The module layout mirrors ``freerl_tpu`` so that each module's counterpart
is easy to find. Entry points default to ``device="cuda"`` and run on the
CPU only when the caller passes ``device="cpu"``: that argument (``--device``
on the command lines) is the counterpart of the JAX package's
``FREERL_PLATFORM``. The port imports nothing of JAX or of ``freerl_tpu``.

``FREERL_MATMUL_PRECISION``, where set, is read at import and applied with
:func:`set_matmul_precision`.
"""

__version__ = "0.1.0"

import os as _os

import torch as _torch

# JAX's names for ``jax_default_matmul_precision`` -> (torch's float32
# matmul precision, TF32 in cuBLAS matmuls, TF32 in cuDNN convolutions);
# None leaves torch's setting as it is
_PRECISIONS = {
    "float32": ("highest", False, False),
    "highest": ("highest", False, False),
    "tensorfloat32": ("high", True, True),
    "high": ("high", True, True),
    "bfloat16": ("medium", None, None),
    "fastest": ("medium", None, None),
    # torch's own defaults
    "default": ("highest", False, True),
}


def set_matmul_precision(name: str) -> None:
    """Set the process's float32 matmul and convolution precision from one
    of JAX's names: ``float32`` / ``highest`` (full float32, TF32 off for
    both cuBLAS and cuDNN), ``tensorfloat32`` / ``high`` (TF32 on for
    both), ``bfloat16`` / ``fastest`` (torch's ``"medium"``), ``default``
    (torch's defaults: full float32 matmuls, TF32 convolutions). Another
    name raises ``ValueError``."""
    if name not in _PRECISIONS:
        raise ValueError(
            f"FREERL_MATMUL_PRECISION={name!r}: expected one of "
            f"{sorted(_PRECISIONS)}")
    matmul, cublas_tf32, cudnn_tf32 = _PRECISIONS[name]
    _torch.set_float32_matmul_precision(matmul)
    if cublas_tf32 is not None:
        _torch.backends.cuda.matmul.allow_tf32 = cublas_tf32
    if cudnn_tf32 is not None:
        _torch.backends.cudnn.allow_tf32 = cudnn_tf32


if _os.environ.get("FREERL_MATMUL_PRECISION"):
    set_matmul_precision(_os.environ["FREERL_MATMUL_PRECISION"])

from freerl_tpu_torch import (  # noqa: E402,F401
    envs, buffers, nets, algos, train)
