"""Tree checkpoints as flattened path → array ``.npz`` files (port of
``repro/checkpoint/io.py``, the same format, so either package reads what
the other wrote).

Keys are ``/``-joined dict paths, ``#i`` for the i-th item of a list or
tuple, and ``__none__`` (a 0-d int8) for ``None``.  numpy has no bfloat16
without ``ml_dtypes``, so a bf16 leaf is stored as its raw bits, a
``uint16`` array, under its key plus ``__bf16__``.  Writes are atomic,
and ``meta`` goes to a ``.meta.json`` beside the file.  :func:`load`
returns CPU tensors; :func:`to_device` moves them.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

PyTree = Any
_SEP = "/"
_BF16 = "__bf16__"


def _to_numpy(leaf) -> Tuple[np.ndarray, bool]:
    """(array, is_bf16): a bf16 tensor as its bits in a uint16 array."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16), \
                True
        return t.numpy(), False
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":              # an ml_dtypes array
        return arr.view(np.uint16), True
    return arr, False


def _flatten(tree: PyTree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{_SEP}#{i}" if prefix
                                else f"#{i}"))
    elif tree is None:
        out[prefix + f"{_SEP}__none__" if prefix else "__none__"] = \
            np.zeros((), np.int8)
    else:
        arr, bf16 = _to_numpy(tree)
        out[prefix + _BF16 if bf16 else prefix] = arr
    return out


def save(path: str, tree: PyTree, meta: Optional[dict] = None) -> None:
    """Write ``tree`` (and ``meta``) atomically: to a sibling temporary
    file, then ``os.replace`` into place, so a crash mid-save never leaves
    a truncated archive under the final name."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = _flatten(tree)
    final = path if path.endswith(".npz") else path + ".npz"
    tmp = final + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, final)
    if meta is not None:
        with open(path + ".meta.json.tmp", "w") as f:
            json.dump(meta, f, indent=2)
        os.replace(path + ".meta.json.tmp", path + ".meta.json")


def _from_numpy(arr: np.ndarray, bf16: bool) -> torch.Tensor:
    if bf16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def load(path: str) -> Tuple[PyTree, Optional[dict]]:
    """``(tree, meta)``: leaves are CPU tensors, ``meta`` is ``None``
    when no ``.meta.json`` sits beside the file."""
    tree: dict = {}
    with np.load(path if path.endswith(".npz") else path + ".npz",
                 allow_pickle=False) as data:
        for key in data.files:
            parts = key.split(_SEP)
            if parts[-1] == "__none__":
                parts = parts[:-1]
                value = None
            elif parts[-1].endswith(_BF16):
                value = _from_numpy(data[key], True)
                parts[-1] = parts[-1][:-len(_BF16)]
            else:
                value = _from_numpy(data[key], False)
            if not parts:
                return value, _load_meta(path)
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = value
    return _restore_sequences(tree), _load_meta(path)


def _load_meta(path: str) -> Optional[dict]:
    mp = (path if path.endswith(".npz") else path + ".npz") + ".meta.json"
    mp = mp.replace(".npz.meta.json", ".meta.json") \
        if not os.path.exists(mp) else mp
    for cand in (path + ".meta.json", mp):
        if os.path.exists(cand):
            with open(cand) as f:
                return json.load(f)
    return None


def _restore_sequences(node):
    if isinstance(node, dict):
        node = {k: _restore_sequences(v) for k, v in node.items()}
        if node and all(k.startswith("#") for k in node):
            return [node[f"#{i}"] for i in range(len(node))]
    return node


def to_device(tree: PyTree, device) -> PyTree:
    """Every tensor leaf of ``tree`` (dicts, lists, ``None``) on
    ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device) for v in tree]
    if tree is None:
        return None
    return torch.as_tensor(tree).to(device)
