"""Tree checkpoints: a path-keyed npz payload and JSON metadata (twin of
``repro.checkpoint.ckpt``, the same files).

A tree is nested dicts, lists, tuples and NamedTuples whose leaves are
tensors or numpy arrays (None is an empty node and holds no leaf).  Each
leaf is taken to the host as a numpy array and stored under its path, the
dict keys, sequence indices and ".field" names joined by "/"
(``layers_scan/0/time/wr``, ``layers_scan/0/moe/experts/.w_gate``), as
the reference keys ``jax.tree_util`` paths; a dict is walked in sorted key
order, as ``jax.tree_util`` walks it.  So the port's files and the
reference's restore into each other: save ``decoder.reference_tree(model)``
and the reference restores it into its own parameter tree, and a
reference file restores into that tree here and loads into the port's
model through ``decoder.load_reference_params``.  Files are
``ckpt_<step:08d>.npz`` beside ``ckpt_<step:08d>.json``, which holds the
caller's metadata and "step" and "num_leaves".

Hardening, as the reference's: a corrupt or truncated npz raises
:class:`CheckpointError` naming the file; ``latest_checkpoint(valid_only=
True)`` skips unreadable steps; :func:`restore_latest` walks back to the
newest step that opens and restores.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["CheckpointError", "save_checkpoint", "restore_checkpoint",
           "restore_latest", "latest_checkpoint"]


class CheckpointError(ValueError):
    """A checkpoint file is corrupt, truncated, or schema-incompatible."""


def _leaves(tree: Any, path: Tuple[str, ...] = ()):
    """(path key, leaf) pairs in ``jax.tree_util``'s order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        fields = getattr(tree, "_fields", None)   # a NamedTuple: ".name"
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (f".{fields[i]}" if fields
                                          else str(i),))
    else:
        yield "/".join(path), tree


def _map(tree: Any, fn: Callable[[Any], Any]) -> Any:
    """``tree`` with every leaf replaced by ``fn(leaf)`` (leaves in
    :func:`_leaves`'s order), same containers."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _map(tree[k], fn) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        items = [_map(v, fn) for v in tree]
        if isinstance(tree, list):
            return items
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return fn(tree)


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(directory: str, step: int, tree: Any,
                    metadata: Optional[dict] = None,
                    compress: bool = True) -> str:
    """Write ``tree`` to ``directory/ckpt_<step>.npz`` (+ .json metadata);
    -> the npz's path.  ``compress=False`` stores the arrays deflated not
    at all (``np.savez``; the reference reads both): random f32 weights do
    not compress, and deflating GBs of them takes minutes."""
    os.makedirs(directory, exist_ok=True)
    payload = {key: _to_numpy(leaf) for key, leaf in _leaves(tree)}
    base = os.path.join(directory, f"ckpt_{step:08d}")
    (np.savez_compressed if compress else np.savez)(base + ".npz", **payload)
    meta = dict(metadata or {})
    meta["step"] = step
    meta["num_leaves"] = len(payload)
    with open(base + ".json", "w") as f:
        json.dump(meta, f)
    return base + ".npz"


def _open_payload(path: str):
    """np.load with corrupt/truncated files mapped to CheckpointError
    naming the file (a truncated zip fails at the central directory; a
    damaged member fails when its array is read)."""
    try:
        return np.load(path)
    except Exception as e:                    # BadZipFile/OSError/ValueError
        raise CheckpointError(
            f"checkpoint {path!r} is corrupt or truncated: {e}") from e


def restore_checkpoint(path: str, template: Any, *,
                       validate_shapes: bool = True) -> Any:
    """Restore into the structure of ``template``: each leaf comes back in
    its template leaf's type, a numpy array for a numpy leaf and a tensor
    on the template tensor's device for a tensor.  A leaf the file lacks
    raises ``KeyError``, a leaf of another shape ``ValueError``.

    ``validate_shapes=False`` skips the per-leaf shape check (dtypes are
    still cast) — for callers that reshard the result across a placement
    change (``resilience.reshard.restore_resharded``) before shapes can
    match."""
    with _open_payload(path) as data:
        arrays = {}
        for key, leaf in _leaves(template):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            try:
                arr = data[key]
            except Exception as e:
                raise CheckpointError(
                    f"checkpoint {path!r} is corrupt or truncated "
                    f"(leaf {key!r}): {e}") from e
            if validate_shapes and arr.shape != tuple(np.shape(leaf)):
                raise ValueError(
                    f"shape mismatch at {key}: ckpt {arr.shape} vs "
                    f"template {tuple(np.shape(leaf))}")
            arrays[key] = arr
    keys = iter(key for key, _ in _leaves(template))

    def restore(leaf):
        arr = arrays[next(keys)]
        if isinstance(leaf, torch.Tensor):
            return torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=leaf.device, dtype=leaf.dtype)
        return arr.astype(np.asarray(leaf).dtype)

    return _map(template, restore)


def _checkpoint_steps(directory: str) -> List[Tuple[int, str]]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"ckpt_(\d+)\.npz", name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(out)


def _readable(path: str) -> bool:
    try:
        with _open_payload(path) as data:
            for key in data.files:
                data[key]                     # force every member through
        return True
    except CheckpointError:
        return False


def latest_checkpoint(directory: str,
                      valid_only: bool = False) -> Optional[str]:
    """Newest checkpoint path in ``directory`` (None if there is none).
    ``valid_only=True`` also requires the file to be readable, skipping
    corrupt or truncated steps."""
    for _step, path in reversed(_checkpoint_steps(directory)):
        if not valid_only or _readable(path):
            return path
    return None


def restore_latest(directory: str, template: Any) -> Tuple[Any, str]:
    """Restore the newest checkpoint that restores, walking back over
    corrupt or truncated steps (the fallback to the previous valid step).
    -> ``(tree, path)``; raises :class:`CheckpointError` when no step in
    ``directory`` is usable."""
    steps = _checkpoint_steps(directory)
    skipped = []
    for _step, path in reversed(steps):
        try:
            return restore_checkpoint(path, template), path
        except CheckpointError:
            skipped.append(path)
    raise CheckpointError(
        f"no restorable checkpoint in {directory!r} "
        f"({len(steps)} candidate(s), corrupt: {skipped})")
