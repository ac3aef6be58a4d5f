"""Restart-based checkpointing of state trees of tensors.

Counterpart: ``src/repro/checkpoint/store.py`` (all of it).  The paper leans
on Spark RDD lineage for fault tolerance; the port, like the reference,
checkpoints and restarts: :meth:`repro_torch.core.runner.DistributedRunner.
run_epochs` snapshots its state through this module (see
``CheckpointPolicy``) and ``resume`` restarts a killed run from the newest
snapshot, bit for bit on the same device.

The file format is the reference's, so a file written by either package
restores in the other:

  * one ``step_<n>.npz`` per step whose members are the tree's leaves under
    flattened key paths — a dict key is its key and a sequence index is its
    index, joined by ``/`` (the reference's ``_path_key``);
  * a reserved ``__checkpoint_meta__`` member holding the JSON record
    ``{step, dtypes, metadata}``: each leaf's dtype by name and the
    caller's host-side metadata (epoch and round counters, the stream
    position, an rng key);
  * leaves of a dtype numpy lacks (``bfloat16``, ``float8_e4m3fn``,
    ``float8_e5m2``) are written as their raw bits (a void array of the
    element's width, which is how numpy stores the reference's
    ``ml_dtypes`` leaves too) with the dtype's name in ``dtypes``; restore
    reinterprets them through the same-width unsigned integer.

The port walks nested dicts (keys in sorted order, as the reference's tree
utilities order them), lists, tuples and named tuples itself; ``None`` is an
empty subtree; anything else is a leaf (a tensor, a numpy array or a Python
scalar).  Tensors come to the host with ``.cpu()`` before the write;
``restore_*`` return tensors on ``device`` (``None`` is the CUDA card, and
raises without one).

Writes are crash-safe: the payload goes to a pid-unique ``.tmp`` sibling,
is fsync'd, then atomically renamed, and the directory entry fsync'd, so a
kill mid-write never corrupts the newest visible checkpoint; ``latest_step``
ignores ``.tmp`` leftovers and any file that is not a checkpoint.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "restore_with_metadata",
    "load_metadata",
    "latest_step",
    "prune_checkpoints",
    "save_artifact",
    "load_artifact",
    "atomic_write_text",
    "atomic_write_json",
    "ARTIFACT_STEP",
    "artifact_path",
]

# anchored on both ends: "step_3.npz.tmp", "xstep_3.npz", "notes.txt" never match
_STEP_RE = re.compile(r"^step_(\d+)\.npz$")
#: reserved key inside the npz holding the JSON {step, dtypes, metadata} record
_META_KEY = "__checkpoint_meta__"

#: dtypes numpy lacks: written as raw bits, read back through the unsigned
#: integer of the same width
_RAW_DTYPES = {
    "bfloat16": (torch.bfloat16, torch.uint16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8),
}
_RAW_NAMES = {t: name for name, (t, _, _) in _RAW_DTYPES.items()}


# --------------------------------------------------------------------------- #
# tree walking
# --------------------------------------------------------------------------- #
def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node: Any) -> Optional[List[Tuple[str, Any]]]:
    """``(key part, child)`` pairs of a container node, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _leaves_with_keys(tree: Any, prefix: Tuple[str, ...] = ()):
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield "/".join(prefix), tree
        return
    for part, child in kids:
        yield from _leaves_with_keys(child, prefix + (part,))


def _flatten(tree: Any) -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for key, leaf in _leaves_with_keys(tree):
        if key in flat:
            raise ValueError(
                f"two leaves flatten to the same key {key!r} (a dict key "
                f"containing '/'?) — the checkpoint would silently drop one")
        flat[key] = leaf
    return flat


def _rebuild(template: Any, values: Dict[str, Any],
             prefix: Tuple[str, ...] = ()) -> Any:
    """``template``'s structure with each leaf replaced by ``values[key]``."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _rebuild(v, values, prefix + (str(k),))
                for k, v in template.items()}
    if _is_namedtuple(template):
        return type(template)(*(_rebuild(getattr(template, f), values, prefix + (f,))
                                for f in template._fields))
    if isinstance(template, (list, tuple)):
        out = [_rebuild(v, values, prefix + (str(i),))
               for i, v in enumerate(template)]
        return out if isinstance(template, list) else tuple(out)
    return values["/".join(prefix)]


# --------------------------------------------------------------------------- #
# leaves <-> host arrays
# --------------------------------------------------------------------------- #
def _to_host(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf as the numpy array the file holds, and its dtype's name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = _RAW_NAMES.get(t.dtype)
        if name is not None:
            _, bits, np_bits = _RAW_DTYPES[name]
            raw = t.contiguous().view(bits).numpy().view(np_bits)
            return raw.view(np.dtype(f"V{raw.itemsize}")), name
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _to_tensor(a: np.ndarray, want: Optional[str],
               device: torch.device) -> torch.Tensor:
    """A stored array as a tensor of its recorded dtype on ``device``."""
    if want in _RAW_DTYPES:
        dtype, _, np_bits = _RAW_DTYPES[want]
        bits = np.asarray(a, order="C").view(np_bits)
        return torch.from_numpy(bits.copy()).view(dtype).to(device)
    if want is not None and str(a.dtype) != want:
        try:
            a = a.view(np.dtype(want))
        except TypeError as e:
            raise ValueError(
                f"recorded dtype {want!r} is neither a numpy dtype nor one "
                f"the port reads as raw bits ({sorted(_RAW_DTYPES)})") from e
    try:
        return torch.from_numpy(np.asarray(a, order="C")).to(device)
    except TypeError as e:
        raise ValueError(f"torch has no dtype for a stored {a.dtype} array") from e


# --------------------------------------------------------------------------- #
# atomic publishing
# --------------------------------------------------------------------------- #
def _ckpt_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step}.npz")


def _fsync_dir(dirname: str) -> None:
    """Persist the directory entry of a just-renamed file (the rename is
    atomic but not durable until the directory is synced)."""
    fd = os.open(dirname, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _publish(path: str, write) -> None:
    """``write(file)`` into a pid-unique tmp sibling, fsync, atomic rename,
    directory fsync.  Two writers on one directory never clobber each
    other's in-flight file; the rename stays last-wins atomic."""
    parent = os.path.dirname(path) or "."
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    _fsync_dir(parent)


def atomic_write_text(path: str, text: str) -> str:
    """Durably publish ``text`` at ``path``: a reader sees either the old
    complete file or the new complete file, never a torn one."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _publish(path, lambda f: f.write(text.encode()))
    return path


def atomic_write_json(path: str, obj: Any, *, indent: Optional[int] = 2) -> str:
    """Atomic JSON publish (see :func:`atomic_write_text`)."""
    return atomic_write_text(path, json.dumps(obj, indent=indent) + "\n")


# --------------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------------- #
def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    metadata: Optional[Dict[str, Any]] = None,
                    keep: Optional[int] = None) -> str:
    """Write ``tree`` at ``step``; returns the path.

    ``metadata`` is any JSON-serializable dict of host-side loop state
    stored inside the same file — one atomic unit, so state and counters
    can never be torn apart by a crash.  ``keep`` prunes all but the newest
    ``keep`` checkpoints after a successful publish."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays, dtypes = {}, {}
    for k, v in _flatten(tree).items():
        if k == _META_KEY:
            raise ValueError(f"tree key collides with reserved {_META_KEY!r}")
        arrays[k], dtypes[k] = _to_host(v)
    record = {"step": step, "dtypes": dtypes, "metadata": metadata}
    arrays[_META_KEY] = np.array(json.dumps(record))
    path = _ckpt_path(ckpt_dir, step)
    _publish(path, lambda f: np.savez(f, **arrays))
    if keep is not None:
        prune_checkpoints(ckpt_dir, keep)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest published step, or None.  ``.tmp`` leftovers from a killed
    write and any non-checkpoint files are ignored."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for fn in os.listdir(ckpt_dir)
             if (m := _STEP_RE.match(fn))]
    return max(steps) if steps else None


def prune_checkpoints(ckpt_dir: str, keep: int) -> None:
    """Delete all but the newest ``keep`` published checkpoints.  ``.tmp``
    partials are left alone: one may belong to a writer still flushing."""
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    if not os.path.isdir(ckpt_dir):
        return
    found = sorted((int(m.group(1)), fn) for fn in os.listdir(ckpt_dir)
                   if (m := _STEP_RE.match(fn)))
    for _, fn in found[:-keep] if len(found) > keep else []:
        os.remove(os.path.join(ckpt_dir, fn))


def _read_record(data) -> Dict[str, Any]:
    if _META_KEY in data.files:
        return json.loads(str(data[_META_KEY][()]))
    return {"dtypes": {}, "metadata": None}


def _resolve_step(ckpt_dir: str, step: Optional[int]) -> int:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return step


def _restore(ckpt_dir: str, tree: Any, step: Optional[int],
             device: DeviceLike) -> Tuple[Any, int, Optional[Dict[str, Any]]]:
    dev = resolve_device(device)
    step = _resolve_step(ckpt_dir, step)
    path = _ckpt_path(ckpt_dir, step)
    want = _flatten(tree)
    with np.load(path) as data:
        record = _read_record(data)
        stored = [k for k in data.files if k != _META_KEY]
        missing = set(want) - set(stored)
        extra = set(stored) - set(want)
        if missing or extra:
            raise ValueError(
                f"checkpoint {path} does not match the template tree: "
                f"{len(missing)} template leaves absent from the checkpoint "
                f"(e.g. {sorted(missing)[:5]}), {len(extra)} checkpoint arrays "
                f"with no template leaf (e.g. {sorted(extra)[:5]}) — was the "
                f"checkpoint written for a different model/optimizer state?")
        values = {k: _to_tensor(data[k], record["dtypes"].get(k), dev)
                  for k in want}
    return _rebuild(tree, values), step, record.get("metadata")


def restore_checkpoint(ckpt_dir: str, tree: Any, step: Optional[int] = None,
                       *, device: DeviceLike = None) -> Tuple[Any, int]:
    """Restore into the structure of ``tree`` (its leaves' values are not
    read).  Returns ``(restored_tree, step)``, the tensors on ``device``."""
    restored, step, _ = _restore(ckpt_dir, tree, step, device)
    return restored, step


def restore_with_metadata(ckpt_dir: str, tree: Any, step: Optional[int] = None,
                          *, device: DeviceLike = None
                          ) -> Tuple[Any, int, Optional[Dict[str, Any]]]:
    """Like :func:`restore_checkpoint`, and also the host-side ``metadata``
    the checkpoint was saved with (None for one written without)."""
    return _restore(ckpt_dir, tree, step, device)


def load_metadata(ckpt_dir: str, step: Optional[int] = None
                  ) -> Optional[Dict[str, Any]]:
    """Just the host-side metadata of a checkpoint: only the JSON record is
    decompressed, not the arrays."""
    step = _resolve_step(ckpt_dir, step)
    with np.load(_ckpt_path(ckpt_dir, step)) as data:
        return _read_record(data).get("metadata")


#: step id under which one-shot artifacts (fitted models and pipelines: no
#: training-loop counter) are published
ARTIFACT_STEP = 0


def save_artifact(ckpt_dir: str, tree: Any,
                  metadata: Optional[Dict[str, Any]] = None) -> str:
    """Publish a fitted artifact (a state tree + JSON host state) as one
    atomic checkpoint file at :data:`ARTIFACT_STEP`."""
    return save_checkpoint(ckpt_dir, ARTIFACT_STEP, tree, metadata=metadata)


def artifact_path(ckpt_dir: str) -> str:
    """The file :func:`save_artifact` publishes in ``ckpt_dir``."""
    return _ckpt_path(ckpt_dir, ARTIFACT_STEP)


def load_artifact(ckpt_dir: str, tree: Any, *, device: DeviceLike = None
                  ) -> Tuple[Any, Optional[Dict[str, Any]]]:
    """Restore an artifact written by :func:`save_artifact` into the
    structure of ``tree``; returns ``(restored_tree, metadata)``."""
    restored, _, meta = _restore(ckpt_dir, tree, ARTIFACT_STEP, device)
    return restored, meta
