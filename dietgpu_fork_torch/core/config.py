"""Where work runs: a CUDA tensor takes the hand-written kernel, a CPU
tensor takes the kernel's plain PyTorch version. There is no override."""

from __future__ import annotations

import torch


def use_kernels(t: torch.Tensor) -> bool:
    return t.is_cuda
