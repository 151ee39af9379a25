"""Checkpointing: a tree of tensors <-> a flat .npz with path-encoded keys
(the port's own copy of ``repro.checkpoint.store``).

Handles nested dict / list / tuple trees (params, optimizer states, decode
caches). A key joins the path to a leaf with "/": a dict key as
``str(key)``, a list or tuple index as ``#i``; dict keys are visited in
sorted order, as JAX flattens them. The files are the reference's byte for
byte, so either package reads what the other wrote:

- fp32, int and other NumPy-typed leaves are plain ``.npy`` arrays;
- a bf16 leaf is its raw 2 bytes an element under the descr ``<V2``, which
  is what NumPy writes for the reference's ``ml_dtypes.bfloat16``. NumPy
  has no bf16 of its own, so the port goes through ``torch.int16`` and
  writes that entry's header itself; ``load`` reads a 2-byte void leaf
  back as ``torch.bfloat16`` (the reference hands back the void bytes).
"""
from __future__ import annotations

import json
import os
import tempfile
import zipfile
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from numpy.lib import format as npy_format

_SEP = "/"
_BF16_DESCR = "<V2"


def _items(tree: Any, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) in the reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _items(t, prefix + (f"#{i}",))
    else:
        yield _SEP.join(prefix), tree


def _write_npy(fid, leaf: Any) -> None:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            npy_format.write_array_header_1_0(
                fid, {"descr": _BF16_DESCR, "fortran_order": False,
                      "shape": tuple(t.shape)})
            fid.write(t.contiguous().view(torch.int16).numpy().tobytes())
            return
        leaf = t.numpy()
    npy_format.write_array(fid, np.asanyarray(leaf), allow_pickle=True)


def _savez(f, entries: Dict[str, Any]) -> None:
    """``np.savez`` (uncompressed, zip64 entries) with the bf16 entries
    written by ``_write_npy``."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in entries.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                _write_npy(fid, leaf)


def save(path: str, tree: Any, metadata: Dict[str, Any] | None = None) -> None:
    """Atomic save: written through a ``mkstemp`` file with the ``.npz``
    suffix in the target directory, then ``os.replace``d onto `path`, so
    concurrent savers to one path never share a temporary name."""
    entries = {"__meta__": np.asarray(json.dumps(metadata or {}))}
    entries.update(_items(tree))
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz")
    try:
        with os.fdopen(fd, "wb") as f:
            _savez(f, entries)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _to_tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def load(path: str, template: Any) -> Any:
    """Restore into the structure of `template`: each leaf a tensor of the
    saved dtype on the device of the template's leaf (the CPU where that
    is not a tensor). A missing key raises KeyError, a shape that differs
    from the template's ValueError."""
    with np.load(path, allow_pickle=False) as zf:
        flat = {k: zf[k] for k in zf.files if k != "__meta__"}

    def rebuild(tree, prefix):
        if isinstance(tree, dict):
            return {k: rebuild(v, prefix + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(t, prefix + (f"#{i}",))
                              for i, t in enumerate(tree))
        key = _SEP.join(prefix)
        if key not in flat:
            raise KeyError(f"checkpoint missing {key!r}")
        arr = flat[key]
        is_tensor = isinstance(tree, torch.Tensor)
        shape = tuple(tree.shape) if is_tensor else np.shape(tree)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} "
                             f"vs template {shape}")
        return _to_tensor(arr, tree.device if is_tensor
                          else torch.device("cpu"))

    return rebuild(template, ())


def load_metadata(path: str) -> Dict[str, Any]:
    with np.load(path, allow_pickle=False) as zf:
        if "__meta__" in zf.files:
            return json.loads(str(zf["__meta__"]))
    return {}
