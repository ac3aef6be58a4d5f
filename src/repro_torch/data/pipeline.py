"""Seekable batch iterator: host batches → tensors on the device.

Counterpart: ``src/repro/data/pipeline.py`` (``BatchIterator``,
``shard_batch``).  The stream's position is a single integer ``step`` and
the source is a pure function of it, so the stream is *seekable*:
:meth:`BatchIterator.seek` repositions it exactly, which is how
:meth:`repro_torch.core.runner.DistributedRunner.resume` replays a killed
run bit for bit (the checkpoint's metadata records the step).

The port takes ``device=`` (the CUDA card unless ``device="cpu"``; with no
card and no ``device="cpu"`` it raises) and puts each batch there whole:
the runner views a window as ``(num_shards, rows_per_shard, cols)``
partition blocks on that one device, which is the layout of a resident
:class:`repro_torch.core.numeric_table.MLNumericTable`.  With ``mesh=`` (a
:class:`repro_torch.core.hostmesh.HostMesh`), as the reference lays a
batch's rows out over the mesh, every host receives the same host window
and carves out its own rows (:func:`repro_torch.core.hostmesh.
local_row_slice`) onto the mesh's device: the runner then views them as the
host's ``L`` partitions.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, to_tensor

__all__ = ["BatchIterator", "shard_batch"]


def _place(v: Any, device: torch.device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.float64:
            v = v.float()
        return v.to(device, non_blocking=v.device.type == "cpu" and v.is_pinned())
    return to_tensor(v, device)


def shard_batch(batch: Dict[str, Any], device: torch.device,
                mesh=None) -> Dict[str, torch.Tensor]:
    """Put each value of a host batch on ``device``; with ``mesh=``, only
    this host's rows of each value (and on the mesh's device).

    A value may be a numpy array (copied to the device; float64 becomes
    float32, as ``jnp.asarray`` makes it) or a tensor.  A CPU tensor goes to
    a CUDA device with ``non_blocking=True`` when it is pinned, so the copy
    runs on the current stream beside the host's next work; kernels queued
    after it on that stream read the copied rows.  A source that reuses a
    pinned buffer must therefore not overwrite it before the copy has
    completed (a ``torch.cuda.synchronize()`` or an event after the
    epoch): the sources of this package and of ``chip_smoke.py`` hand out
    read-only slices of a pool made once, which nothing overwrites.  A
    tensor already on ``device`` is not copied."""
    if mesh is None:
        return {k: _place(v, device) for k, v in batch.items()}
    from repro_torch.core.hostmesh import local_row_slice

    return {k: _place(v[local_row_slice(int(v.shape[0]), mesh)], mesh.device)
            for k, v in batch.items()}


class BatchIterator:
    """Iterate ``source(step) -> host batch`` onto ``device``.

    ``source`` must be a pure function of ``step`` — that determinism is
    what makes kill-and-resume exact: after a restart,
    ``seek(checkpointed_step)`` reproduces the identical remaining batch
    sequence.
    """

    def __init__(self, source: Callable[[int], Dict[str, Any]],
                 device: DeviceLike = None, start_step: int = 0,
                 mesh=None):
        self.source = source
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.step = int(start_step)

    def seek(self, step: int) -> "BatchIterator":
        """Reposition the stream; the next batch will be ``source(step)``."""
        self.step = int(step)
        return self

    def restrict(self, indices) -> "BatchIterator":
        """Fold-restricted view of this stream: every window the source
        yields is row-gathered to ``indices`` on the host, before it is put
        on the device, so a streamed cross-validation split trains on
        exactly the rows a resident fold view would.

        The restricted source stays a pure function of the step, so the
        view remains seekable and resume-exact; it starts at this stream's
        current position.  Values whose leading dim covers every index are
        row-gathered; shorter values (per-window broadcast extras) pass
        through — but a ``"data"`` window too short for the fold raises,
        and so does a window where nothing covers the indices, so a fold
        restriction can never be silently ignored (CV leakage)."""
        idx = np.asarray(indices)
        if idx.ndim != 1:
            raise ValueError(f"indices must be 1-D, got shape {idx.shape}")
        if idx.size == 0:
            raise ValueError("cannot restrict a stream to zero rows")
        needed = int(idx.max()) + 1
        source = self.source

        def restricted(step: int) -> Dict[str, Any]:
            batch = source(step)
            out = {}
            for k, v in batch.items():
                if np.ndim(v) >= 1 and np.shape(v)[0] >= needed:
                    out[k] = v[torch.as_tensor(idx)] if isinstance(v, torch.Tensor) else v[idx]
                elif k == "data":
                    # the row-carrying key (run_epochs consumes batch["data"])
                    # must cover the fold: a too-short window training on
                    # unrestricted rows is the leakage this guards against
                    raise ValueError(
                        f"restricted stream at step {step}: 'data' window "
                        f"has {np.shape(v)[0]} rows, cannot cover fold "
                        f"indices up to {needed - 1}")
                else:
                    out[k] = v
            if all(o is v for o, v in zip(out.values(), batch.values())):
                sizes = {k: tuple(np.shape(v)[:1]) for k, v in batch.items()}
                raise ValueError(
                    f"restricted stream at step {step}: no value covers "
                    f"fold indices up to {needed - 1} (leading dims "
                    f"{sizes}) — the restriction would be silently ignored")
            return out

        return BatchIterator(restricted, device=self.device, start_step=self.step,
                             mesh=self.mesh)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        batch = shard_batch(self.source(self.step), self.device, self.mesh)
        self.step += 1
        return batch
