"""Native checkpoint/resume (svinet_tpu/io/checkpoint.py).

An engine's state is saved under <outdir>/ckpt/<step>: the tensors as one
torch.save file of CPU tensors (<step>.pt) and the host scalars as JSON
(<step>.meta.json). The step is the next iteration to run. The `latest`
pointer is written last and atomically (tmp + rename), so an interrupted
save never leaves an unreadable pointer, and steps beyond KEEP_LAST are
removed. These files are the port's own: the JAX package's orbax (or
npz) checkpoints are not read, and it cannot read these; the TSV model
files (-load) are what both read.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

KEEP_LAST = 3   # checkpoint retention


def save_checkpoint(outdir: str, state: Dict[str, Any], step: int) -> str:
    """Save `state` (tensors, anywhere, and JSON scalars) as step `step`;
    returns the path of its tensor file."""
    path = os.path.abspath(os.path.join(outdir, "ckpt"))
    os.makedirs(path, exist_ok=True)
    # a copy of each, so that a view saves its own values and not the
    # whole storage it looks into
    tensors = {k: v.detach().to("cpu", copy=True).contiguous()
               for k, v in state.items() if isinstance(v, torch.Tensor)}
    scalars = {k: v for k, v in state.items()
               if not isinstance(v, torch.Tensor)}
    pt = os.path.join(path, f"{step}.pt")
    torch.save(tensors, pt + ".tmp")
    os.replace(pt + ".tmp", pt)
    meta = os.path.join(path, f"{step}.meta.json")
    with open(meta + ".tmp", "w") as f:
        json.dump(scalars, f)
    os.replace(meta + ".tmp", meta)
    with open(os.path.join(path, "latest.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(path, "latest.tmp"),
               os.path.join(path, "latest"))
    _prune(path, step)
    return pt


def _steps_on_disk(path: str):
    steps = []
    for name in os.listdir(path):
        base = name.split(".")[0]
        if base.isdigit() and not name.endswith(".tmp"):
            steps.append(int(base))
    return sorted(set(steps))


def _prune(path: str, newest: int) -> None:
    steps = [s for s in _steps_on_disk(path) if s != newest]
    for s in steps[: max(0, len(steps) - (KEEP_LAST - 1))]:
        for suffix in (".pt", ".meta.json"):
            try:
                os.remove(os.path.join(path, f"{s}{suffix}"))
            except OSError:
                pass


def latest_step(outdir: str) -> Optional[int]:
    """The step the `latest` pointer names, else the newest on disk."""
    path = os.path.join(outdir, "ckpt")
    p = os.path.join(path, "latest")
    if os.path.exists(p):
        txt = open(p).read().strip()
        if txt.isdigit():
            return int(txt)
    if os.path.isdir(path):
        steps = _steps_on_disk(path)
        if steps:
            return steps[-1]
    return None


def _load_step(path: str, step: int) -> Optional[Dict[str, Any]]:
    pt = os.path.join(path, f"{step}.pt")
    if not os.path.exists(pt):
        return None
    out: Dict[str, Any] = dict(torch.load(pt, map_location="cpu",
                                          weights_only=True))
    mp = os.path.join(path, f"{step}.meta.json")
    if os.path.exists(mp):
        with open(mp) as f:
            out.update(json.load(f))
    return out


def load_checkpoint(outdir: str, step: Optional[int] = None
                    ) -> Optional[Dict[str, Any]]:
    """The state saved by save_checkpoint (tensors on the CPU, scalars
    merged), or None when there is none. A step that fails to load is
    skipped with a message and the next older one is tried; an explicit
    `step` raises its error instead."""
    path = os.path.abspath(os.path.join(outdir, "ckpt"))
    if step is not None:
        return _load_step(path, step)
    latest = latest_step(outdir)
    if latest is None:
        return None
    older = [s for s in _steps_on_disk(path) if s != latest]
    candidates = [latest] + older[::-1]
    for i, s in enumerate(candidates):
        try:
            out = _load_step(path, s)
        except Exception as e:   # a truncated file
            rest = candidates[i + 1:]
            print(f"+ checkpoint step {s} unreadable ({e!r}); "
                  + (f"falling back to step {rest[0]}: the report files "
                     "already hold rows past it, the resumed trace "
                     "repeats those iterations"
                     if rest else "no older step; starting fresh"))
            continue
        if out is not None:
            return out
    return None
