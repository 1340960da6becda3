"""Kernel 1: E[log p] = psi(x) - psi(sum over the last axis), in one pass.

The CUDA kernel (csrc/dirichlet_expectation.cu) replaces the TPU kernel
svinet_tpu/ops/pallas_digamma.py:68-102. Its plain version is what the
JAX engine computes through XLA (svinet_tpu/ops/expectations.py:21-22).
A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. The kernel is chosen by K alone: up to 512 columns a row is
held in registers by a group of lanes (several rows to a warp when K is
small), above that one warp reads its row twice. Its top-W form
(-sparse-w) also picks, per row, the W largest columns of its input.
"""

from __future__ import annotations

from typing import Tuple

import torch

from svinet_torch.kernels import build


def dirichlet_expectation_plain(x: torch.Tensor, rest: float = 0.0,
                                out_dtype: torch.dtype = torch.float32
                                ) -> torch.Tensor:
    out = (torch.special.digamma(x)
           - torch.special.digamma(x.sum(dim=-1, keepdim=True) + rest))
    return out.to(out_dtype)


def dirichlet_expectation(x: torch.Tensor, rest: float = 0.0,
                          out_dtype: torch.dtype = torch.float32,
                          out: "torch.Tensor | None" = None
                          ) -> torch.Tensor:
    """E[log p] for rows of Dirichlet/Beta parameters: gamma (n,K) and
    lambda (K,2) alike, f32, reduced over the last axis.

    `rest` is added to every row sum before psi: the Dirichlet mass of the
    columns a column-compacted gamma leaves out
    (svinet_tpu/svi/sweep_math.py:289-299, compact_elogpi). `out_dtype`
    torch.bfloat16 gives the result rounded to nearest even, as a cast
    does; the kernel rounds in its store and writes no f32 copy. `out`, a
    contiguous tensor of x's shape and out_dtype, receives the result
    (the leading rows of a larger buffer, as -mesh-locality gives it)."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, "
                        f"got {out_dtype}")
    if x.device.type == "cpu":
        res = dirichlet_expectation_plain(x, rest, out_dtype)
        return res if out is None else out.copy_(res)
    build.require_cuda(x, "dirichlet_expectation")
    if x.dim() != 2:
        raise ValueError(f"dirichlet_expectation takes (rows, k), "
                         f"got {tuple(x.shape)}")
    build.check_cuda(x, "x", torch.float32, tuple(x.shape), x.device)
    if out is None:
        out = torch.empty_like(x, dtype=out_dtype)
    else:
        build.check_cuda(out, "out", out_dtype, tuple(x.shape), x.device)
    rows, k = x.shape
    build.launch("svt_dirichlet_expectation", x.device, x.data_ptr(),
                 out.data_ptr(), rows, k, float(rest),
                 int(out_dtype == torch.bfloat16))
    build.count_launch(
        dirichlet_expectation,
        ("bf16" if out_dtype == torch.bfloat16 else "f32")
        + ("+rest" if rest else ""))
    return out


dirichlet_expectation.launches = 0
dirichlet_expectation.forms = {}


def top_columns_plain(x: torch.Tensor, w: int) -> torch.Tensor:
    """(rows, w) int32: the columns of the w largest values of each row,
    largest first and the lower column first among equal values, as
    jax.lax.top_k orders them (a descending stable sort; torch.topk
    promises no order among ties)."""
    return torch.sort(x, dim=1, descending=True,
                      stable=True).indices[:, :w].to(torch.int32)


def _check_pair(x, pair) -> None:
    n, k = x.shape
    if tuple(pair.shape) != (n, k, 2) or pair.dtype != torch.float32:
        raise ValueError(f"pair must be ({n}, {k}, 2) float32, got "
                         f"{tuple(pair.shape)} {pair.dtype}")
    if not pair.is_contiguous():
        raise ValueError("pair must be contiguous")


def dirichlet_expectation_topw_plain(x: torch.Tensor, w: int,
                                     pair: torch.Tensor
                                     ) -> Tuple[torch.Tensor, ...]:
    """dirichlet_expectation_topw in plain PyTorch (a stable descending
    sort for the ids)."""
    _check_pair(x, pair)
    ids = top_columns_plain(x, w)
    idl = ids.long()
    elogpi = pair[..., 0].copy_(dirichlet_expectation_plain(x))
    return elogpi, ids, elogpi.gather(1, idl), pair[..., 1].gather(1, idl)


def dirichlet_expectation_topw(x: torch.Tensor, w: int, pair: torch.Tensor
                               ) -> Tuple[torch.Tensor, ...]:
    """The top-W form of kernel 1 (svinet_tpu/svi/sweep_math.py:241-245)
    into `pair`, the (n, K, 2) f32 rows of -sparse-w (Elogpi and the mean
    indicators of the sweep before side by side, csrc/sparse_union.cu).
    Returns (Elogpi, ids (n,w) int32, topvals (n,w) f32, topm (n,w) f32):
    Elogpi is written into the even half of `pair` and returned as a view
    of it; ids are the columns of the w largest entries of x per row
    (top_columns_plain's order), topvals = Elogpi[row, ids] and topm the
    odd half at ids. One pass on the card: the row kernel 1 holds for
    Elogpi is searched by a threshold and one sort of the picks
    (csrc/dirichlet_expectation.cu); counted as the form "topw"."""
    if not 1 <= w <= x.shape[-1]:
        raise ValueError(f"w must lie in [1, {x.shape[-1]}], got {w}")
    if x.device.type == "cpu":
        return dirichlet_expectation_topw_plain(x, w, pair)
    build.require_cuda(x, "dirichlet_expectation_topw")
    if x.dim() != 2:
        raise ValueError(f"dirichlet_expectation_topw takes (rows, k), "
                         f"got {tuple(x.shape)}")
    build.check_cuda(x, "x", torch.float32, tuple(x.shape), x.device)
    rows, k = x.shape
    build.check_cuda(pair, "pair", torch.float32, (rows, k, 2), x.device)
    ids = torch.empty((rows, w), dtype=torch.int32, device=x.device)
    topvals = torch.empty((rows, w), dtype=torch.float32, device=x.device)
    topm = torch.empty((rows, w), dtype=torch.float32, device=x.device)
    build.launch("svt_dirichlet_topw", x.device, x.data_ptr(),
                 pair.data_ptr(), ids.data_ptr(), topvals.data_ptr(),
                 topm.data_ptr(), rows, k, w)
    build.count_launch(dirichlet_expectation, "topw")
    return pair[..., 0], ids, topvals, topm
