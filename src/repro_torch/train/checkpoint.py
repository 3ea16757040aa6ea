"""Step-atomic checkpoints with async file I/O, in the format of
``repro.train.checkpoint``:

  ``ckpt_<step:08d>/manifest.json``  — step, leaf names, shapes, dtypes
  ``ckpt_<step:08d>/arr_<i>.npy``    — one file per leaf (on the host)

The state is a flat dict of tensors keyed by dotted names
(``params.embed.table``, ``opt.m.embed.table``, ``opt.step``). Leaves are
written in ``params.tree_order``, the order ``jax.tree.flatten`` gives the
reference's nested dict, so :func:`restore` also reads a checkpoint the
reference's ``Trainer`` wrote: its manifest holds a pickled treedef in
place of the names, which is ignored, and the leaves are mapped by the
caller's own sorted names and checked by shape. bfloat16 leaves are stored
as their 16-bit patterns (numpy has no bfloat16), with ``bfloat16`` in
the manifest's dtypes.

  * **step-atomic**: written to a ``.tmp`` directory and ``os.rename``d on
    completion, so a crash mid-save never corrupts the latest checkpoint;
  * **async**: the copy to the host happens on the caller's thread (a
    copy on the CPU too), the file I/O on a background thread;
  * **GC**: keep the newest ``keep`` checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.params import tree_order


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    # a copy even of a CPU tensor: the trainer's next step updates the
    # parameters and moments in place while the writer thread saves them
    t = t.detach().to("cpu", copy=True)
    bf16 = t.dtype == torch.bfloat16
    # a checkpoint is a deliberate full host transfer (the copy above)
    a = (t.view(torch.int16) if bf16 else t).numpy()  # lint: allow(host-sync)
    return a, "bfloat16" if bf16 else str(a.dtype)


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save(path: str, step: int, state: Dict[str, torch.Tensor], keep: int = 3,
         async_io: bool = True) -> Optional[threading.Thread]:
    """state: {dotted name: tensor}. Returns the writer thread."""
    names = sorted(state, key=tree_order)
    host = [_to_host(state[n]) for n in names]
    manifest = {
        "step": int(step),
        "names": names,
        "n_leaves": len(host),
        "shapes": [list(a.shape) for a, _ in host],
        "dtypes": [dt for _, dt in host],
    }

    def write():
        final = os.path.join(path, f"ckpt_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        for i, (a, _) in enumerate(host):
            np.save(os.path.join(tmp, f"arr_{i}.npy"), a)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(path, keep)

    if async_io:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def _ckpts(path: str):
    return sorted(d for d in os.listdir(path) if d.startswith("ckpt_")
                  and not d.endswith(".tmp"))


def _gc(path: str, keep: int) -> None:
    for d in _ckpts(path)[:-keep]:
        shutil.rmtree(os.path.join(path, d), ignore_errors=True)


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    ckpts = _ckpts(path)
    if not ckpts:
        return None
    return int(ckpts[-1].split("_")[1])


def restore(path: str, step: Optional[int] = None,
            like: Optional[Dict[str, torch.Tensor]] = None
            ) -> Tuple[int, Dict[str, torch.Tensor]]:
    """Load a checkpoint (the latest by default) as host tensors. ``like``
    (the caller's state) names the leaves of a manifest without names,
    such as the reference's, and every leaf is checked against its shape.
    Returns (step, {dotted name: tensor})."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    d = os.path.join(path, f"ckpt_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    names = manifest.get("names")
    if names is None:
        if like is None:
            raise ValueError(f"{d}: the manifest names no leaves; pass "
                             f"like= to map them")
        names = sorted(like, key=tree_order)
    if len(names) != manifest["n_leaves"]:
        raise ValueError(f"{d}: {manifest['n_leaves']} leaves, expected "
                         f"{len(names)}")
    if like is not None and set(names) != set(like):
        raise ValueError(f"{d}: leaves {sorted(set(names) ^ set(like))} "
                         f"are in one state only")
    state = {}
    for i, (name, dtype) in enumerate(zip(names, manifest["dtypes"])):
        t = _from_host(np.load(os.path.join(d, f"arr_{i}.npy")), dtype)
        if like is not None and tuple(t.shape) != tuple(like[name].shape):
            raise ValueError(f"{d}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(like[name].shape)}")
        state[name] = t
    return int(manifest["step"]), state
