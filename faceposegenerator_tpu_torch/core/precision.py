"""Precision policy (port of `faceposegenerator_tpu/core/precision.py`).

bf16 compute with fp32 accumulation is the serving default. The fp32
"parity" policy is what the tests hold against the JAX package; on the card
it must also switch TF32 off, because cuDNN runs fp32 convolutions in TF32
unless told otherwise (`torch.backends.cudnn.allow_tf32` defaults to True).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """param_dtype: storage dtype of the weights; compute_dtype: dtype of
    activations and matmul inputs; accum_dtype: dtype of norm statistics,
    softmax and matmul accumulation."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    accum_dtype: torch.dtype = torch.float32

    def configure_backends(self) -> None:
        """In fp32 compute, forbid TF32 in both cuBLAS matmuls and cuDNN
        convolutions, so fp32 means fp32 on the card too."""
        if self.compute_dtype == torch.float32:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False


DEFAULT_POLICY = Policy()
PARITY_POLICY = Policy(compute_dtype=torch.float32)
