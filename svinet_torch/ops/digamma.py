"""Kernel 1: E[log p] = psi(x) - psi(sum over the last axis), in one pass.

The CUDA kernel (csrc/dirichlet_expectation.cu) replaces the TPU kernel
svinet_tpu/ops/pallas_digamma.py:68-102. Its plain version is what the
JAX engine computes through XLA (svinet_tpu/ops/expectations.py:21-22).
A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. The kernel is chosen by K alone: up to 512 columns a row is
held in registers by a group of lanes (several rows to a warp when K is
small), above that one warp reads its row twice.
"""

from __future__ import annotations

import torch

from svinet_torch.kernels import build


def dirichlet_expectation_plain(x: torch.Tensor) -> torch.Tensor:
    return (torch.special.digamma(x)
            - torch.special.digamma(x.sum(dim=-1, keepdim=True)))


def dirichlet_expectation(x: torch.Tensor) -> torch.Tensor:
    """E[log p] for rows of Dirichlet/Beta parameters: gamma (n,K) and
    lambda (K,2) alike, f32, reduced over the last axis."""
    if x.device.type == "cpu":
        return dirichlet_expectation_plain(x)
    build.require_cuda(x, "dirichlet_expectation")
    if x.dim() != 2:
        raise ValueError(f"dirichlet_expectation takes (rows, k), "
                         f"got {tuple(x.shape)}")
    build.check_cuda(x, "x", torch.float32, tuple(x.shape), x.device)
    out = torch.empty_like(x)
    rows, k = x.shape
    build.launch("svt_dirichlet_expectation", x.device, x.data_ptr(),
                 out.data_ptr(), rows, k)
    dirichlet_expectation.launches += 1
    return out


dirichlet_expectation.launches = 0
