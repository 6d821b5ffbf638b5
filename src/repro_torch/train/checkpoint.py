"""Checkpointing: param / optimizer trees -> .npz + JSON manifest, the
JAX package's ``repro/train/checkpoint.py`` format.

Leaves are saved flat under ``params/<path>`` and ``opt/<path>`` keys,
the path ``/``-joined in the JAX package's flattening order (dict keys
sorted, list entries by index); a bfloat16 leaf is stored as float32
under its key plus ``|bf16``. ``step_XXXXXXXX.npz`` beside a
``manifest.json`` of ``{"step", "extra"}``. A checkpoint written by
either package restores into the other, bit for bit. Restore rebuilds
the structure of the trees it is given, each leaf a tensor on its
counterpart's device. A tree placed on a mesh (``models/params.py``'s
``place_tree``) is saved gathered whole, and a placed leaf of the tree
restore is given is split the same way again: one checkpoint drives
either package and any mesh.
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.models.params import tree_items, whole_tree
from repro_torch.sharding.rules import Parts, place

BF16 = "|bf16"


def _flatten(tree) -> Dict[str, Any]:
    return {"/".join(path): leaf for path, leaf in tree_items(tree)}


def _to_numpy(leaf) -> Tuple[np.ndarray, bool]:
    """(the leaf as numpy, whether it was bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.float().cpu().numpy(), True
        return t.cpu().numpy(), False
    return np.asarray(leaf), False


def save(path: str, step: int, params, opt_state=None, extra=None) -> None:
    p = pathlib.Path(path)
    p.mkdir(parents=True, exist_ok=True)
    blobs: Dict[str, np.ndarray] = {}
    for prefix, tree in (("params", params), ("opt", opt_state)):
        if tree is None:
            continue
        for k, v in _flatten(whole_tree(tree)).items():
            arr, bf16 = _to_numpy(v)
            blobs[f"{prefix}/{k}{BF16 if bf16 else ''}"] = arr
    np.savez(p / f"step_{step:08d}.npz", **blobs)
    (p / "manifest.json").write_text(json.dumps(
        {"step": step, "extra": extra or {}}))


def latest_step(path: str) -> int:
    p = pathlib.Path(path)
    ckpts = sorted(p.glob("step_*.npz"))
    if not ckpts:
        return -1
    return int(ckpts[-1].stem.split("_")[1])


def restore(path: str, step: int, params_like, opt_like=None
            ) -> Tuple[Any, Any]:
    """Restore into the structure of ``params_like`` / ``opt_like``:
    each leaf a tensor of the stored dtype on the device of the leaf it
    replaces (the CPU where that is not a tensor or is an
    ``abstract_tree`` leaf on the meta device)."""
    p = pathlib.Path(path)
    loaded: Dict[str, torch.Tensor] = {}
    with np.load(p / f"step_{step:08d}.npz") as data:
        for k in data.files:
            if k.endswith(BF16):
                loaded[k[:-len(BF16)]] = torch.from_numpy(
                    data[k]).to(torch.bfloat16)
            else:
                loaded[k] = torch.from_numpy(data[k])

    def rebuild(node, path):
        if isinstance(node, dict):
            return {k: rebuild(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v, path + (str(i),))
                              for i, v in enumerate(node))
        if isinstance(node, Parts):
            return place(loaded["/".join(path)], node.spec, node.mesh)
        meta = not isinstance(node, torch.Tensor) or node.is_meta
        return loaded["/".join(path)].to("cpu" if meta else node.device)

    return (rebuild(params_like, ("params",)),
            None if opt_like is None else rebuild(opt_like, ("opt",)))
