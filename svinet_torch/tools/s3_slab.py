"""The slab form of kernel 4 (the s3 pass), a design around the H100's L2
that is kept off the package's path: csrc/alt/s3_slab.cu with its wrapper,
the forward lists it walks, the slab-major layout it gathers from, and its
plain PyTorch version. tools/bench_kernels.py builds it into the library of
alternative designs and times it beside the pull form (csrc/s3_pass.cu),
which is the s3 pass at every shape; tests/test_torch_s3_slab.py holds the
plain version to the JAX package's s3_pass.

The columns of s3 are independent, so the pass can run slab by slab over
column slabs of 32, 64 or 128 bytes of every row, each small enough for the
L2, with a lane or two per link. On an H100 80GB HBM3 at 700 W, K = 500 and
20 links a node, it is 1.4 to 1.6 times as fast as the pull form where a
slab of at least 64 bytes a row fits the L2 (n = 250k to 500k) and level or
slower from n = 1M on (rows of 32 bytes come from the L2 no faster than 2 KB
rows from DRAM) and under -freeze.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from svinet_torch.kernels import build
from svinet_torch.ops.edges import Adjacency
from svinet_torch.svi.sweep_math import (
    _check_rows, _conv_ptr, _reduce_scratch)

_P, _I64, _I32 = build._P, build._I64, build._I32
# rows, whether they are bf16, mode (0 copy, 1 in place, 2 slab-major
# already), slab_buf, its slabs, conv, fwd_ptr, fwd_nbr, chunk_owner,
# partial, s3, n, links, k, slab bytes, units a lane, L2 hint, one launch
# for a run of slabs
SIGNATURES = {
    "svt_s3_slab_pass": (_P, _I32, _I32, _P, _I32) + (_P,) * 6
                        + (_I64, _I64, _I32, _I32, _I32, _I32, _I32, _P),
}

# Entries of the forward lists between two recorded owners: the kernel gives
# a lane four consecutive forward entries and finds their owners by a search
# of `ptr` between the owners recorded for their chunk's ends
# (csrc/alt/s3_slab.cu kOwnerChunk; a multiple of four).
FWD_CHUNK = 32
SLAB_ROW_BYTES = (128, 64, 32)     # what the kernel has forms for
# bytes of slab-major scratch the kernel copies mphi through at a time
SLAB_BATCH_BYTES = 1 << 29


class ForwardLists(NamedTuple):
    """Every link once, under its lower end: node p lists its neighbours
    q > p, ascending, E entries in all and compact, so a pass that meets
    each link once reads E ids and skips nothing. No hub segments: a lane
    takes flat entries. `chunk_owner[c]` is the owner of entry c * FWD_CHUNK
    (of the last entry, past the end). All int32."""
    ptr: torch.Tensor          # (n+1,) p lists nbr[ptr[p]:ptr[p+1]]
    nbr: torch.Tensor          # (E,) the neighbours q > p of each node
    chunk_owner: torch.Tensor  # (ceil(E / FWD_CHUNK) + 1,)


def forward_lists(adj: Adjacency) -> ForwardLists:
    """The forward lists of a symmetric adjacency: its entries with
    neighbour > owner, in the same order."""
    n, dev = adj.n, adj.nbr.device
    counts = (adj.rowptr[1:] - adj.rowptr[:-1]).long()
    owner = torch.repeat_interleave(torch.arange(n, device=dev), counts)
    forward = adj.nbr > owner
    fwd_owner = owner[forward]
    ptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(fwd_owner, minlength=n), 0, out=ptr[1:])
    n_fwd = fwd_owner.shape[0]
    at = torch.arange(-(-n_fwd // FWD_CHUNK) + 1, device=dev) * FWD_CHUNK
    chunk_owner = (fwd_owner[at.clamp(max=n_fwd - 1)] if n_fwd
                   else torch.zeros(1, dtype=torch.int64, device=dev))
    return ForwardLists(ptr.to(torch.int32), adj.nbr[forward].contiguous(),
                        chunk_owner.to(torch.int32))


def _forward_entries(fwd: ForwardLists, block: int):
    """(owner p, neighbour q > p) of the E forward entries, in blocks of
    `block`, as int64 index tensors: every link once."""
    ptr = fwd.ptr.long()
    total = fwd.nbr.shape[0]
    for lo in range(0, total, block):
        pos = torch.arange(lo, min(lo + block, total), device=ptr.device)
        yield (torch.searchsorted(ptr, pos, right=True) - 1,
               fwd.nbr[pos].long())


def s3_pass_slab_plain(mphi, fwd: ForwardLists, width: int, block: int,
                       conv=None) -> torch.Tensor:
    """s3 in the slab kernel's form, in plain PyTorch: the columns are cut
    into slabs of `width` (the last one narrower), and each slab's sums are
    taken over the forward lists, every link once, from that slab's columns
    of the two ends alone. With `conv` a one-sided link adds the free end's
    value to column max(cp, cq) - 1 in the slab that holds that column and
    nothing to any other."""
    n, k = mphi.shape
    s3 = torch.zeros(k, dtype=torch.float32, device=mphi.device)
    for c0 in range(0, k, width):
        slab = mphi[:, c0:c0 + width].float()
        w = slab.shape[1]
        for p, q in _forward_entries(fwd, block):
            mp, mq = slab[p], slab[q]
            contrib = mp * mq
            if conv is not None:
                cp, cq = conv[p], conv[q]
                one_sided = (cp > 0) ^ (cq > 0)
                col = (torch.maximum(cp, cq) - 1 - c0).long()
                here = one_sided & (col >= 0) & (col < w)
                hard = F.one_hot(col.clamp(0, w - 1), w) * here[:, None]
                free_end = torch.where((cp > 0)[:, None], mq, mp)
                contrib = torch.where(one_sided[:, None], hard * free_end,
                                      contrib)
            s3[c0:c0 + w] += contrib.sum(dim=0)
    return s3


def to_slabs(mphi, row_bytes: int) -> torch.Tensor:
    """mphi (n, K) as slab-major rows (ceil(K / W), n, W), W = row_bytes
    over the value's size, zero in the columns past K: the layout the slab
    kernel gathers from. Plain PyTorch."""
    n, k = mphi.shape
    w = row_bytes // mphi.element_size()
    n_slabs = -(-k // w)
    padded = F.pad(mphi, (0, n_slabs * w - k))
    return padded.view(n, n_slabs, w).permute(1, 0, 2).contiguous()


def s3_slab_pass(lib: build.Library, mphi, fwd: ForwardLists, row_bytes: int,
                 conv=None, *, layout: str = "copy", k=None,
                 lane_units: int = 2, hint: bool = True, persistent=None
                 ) -> torch.Tensor:
    """The slab kernel of `lib` (a library that holds csrc/alt/s3_slab.cu)
    on CUDA tensors. Returns s3 (K,) f32. mphi is (n, K) f32 or bf16, conv
    None or the (n,) int32 converged flags, row_bytes 32, 64 or 128.

    mphi is copied slab-major through a scratch of at most SLAB_BATCH_BYTES
    and the forward lists are walked once per slab: one cooperative launch
    per batch of slabs, whose blocks cross from slab to slab together, and
    sums in a fixed order. The variants timed beside that: `layout`
    "strided" gathers from the row-major array in place (rows on 16-byte
    boundaries only) and "slabs" takes `mphi` as to_slabs made it, with its
    `k` columns; `lane_units` 1 gives a lane one 16-byte unit of a link's
    row where 2 gives it two; `hint` False drops the L2 evict_last policy;
    `persistent` False makes a launch per slab in place of the cooperative
    launch (which has no form for `conv`, one unit a lane or no policy)."""
    build.require_cuda(mphi, "s3_slab_pass")
    dev = mphi.device
    if row_bytes not in SLAB_ROW_BYTES:
        raise ValueError(f"a slab's row is one of {SLAB_ROW_BYTES} bytes, "
                         f"got {row_bytes}")
    if layout == "slabs":
        _, n, w = mphi.shape
        bf16 = _check_rows(mphi, "mphi", (-(-k // w), n, w), dev)
        if w * mphi.element_size() != row_bytes:
            raise ValueError(f"slabs of {w} columns are not rows of "
                             f"{row_bytes} bytes")
    else:
        n, k = mphi.shape
        bf16 = _check_rows(mphi, "mphi", (n, k), dev)
    n_links = fwd.nbr.shape[0]
    build.check_cuda(fwd.ptr, "ptr", torch.int32, (n + 1,), dev)
    build.check_cuda(fwd.nbr, "nbr", torch.int32, (n_links,), dev)
    build.check_cuda(fwd.chunk_owner, "chunk_owner", torch.int32,
                     (-(-n_links // FWD_CHUNK) + 1,), dev)
    s3 = torch.empty(k, dtype=torch.float32, device=dev)
    partial = _reduce_scratch(k, dev)
    mode = ("copy", "strided", "slabs").index(layout)
    buf, buf_slabs = None, 0
    if layout == "copy":
        n_slabs = -(-k * mphi.element_size() // row_bytes)
        buf_slabs = max(1, min(n_slabs, SLAB_BATCH_BYTES // (n * row_bytes)))
        buf = torch.empty((buf_slabs, n, row_bytes // mphi.element_size()),
                          dtype=mphi.dtype, device=dev)
    elif layout == "strided" and k * mphi.element_size() % 16:
        raise ValueError(f"rows of {k * mphi.element_size()} bytes do not "
                         f"keep 16-byte units aligned in place")
    if persistent is None:
        persistent = conv is None and lane_units == 2 and hint
    with torch.cuda.device(dev):
        lib.call("svt_s3_slab_pass", mphi.data_ptr(), int(bf16), mode,
                 None if buf is None else buf.data_ptr(), buf_slabs,
                 _conv_ptr(conv, n, dev), fwd.ptr.data_ptr(),
                 fwd.nbr.data_ptr(), fwd.chunk_owner.data_ptr(),
                 partial.data_ptr(), s3.data_ptr(), n, n_links, k, row_bytes,
                 lane_units, int(hint), int(persistent),
                 torch.cuda.current_stream(dev).cuda_stream)
    return s3
