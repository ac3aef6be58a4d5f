"""Logistic-regression gradient — the paper's §IV-A inner loop — as
hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

Counterpart: ``src/repro/kernels/logreg_grad.py`` (``logreg_margin``,
``logreg_xt_z``, ``logreg_grad_pallas``) and the oracle ``logreg_grad_ref``
of ``src/repro/kernels/ref.py``.

    gradient:  g = Xᵀ(σ(Xw) − y)    kernel ``grad_kernel`` (``logreg_grad``)
    margin:    z = σ(Xw) − y        kernel ``margin_kernel`` (``logreg_margin``)
    Xᵀz:       g = Xᵀz              kernel ``xtz_kernel`` (``logreg_xt_z``)

The reference computes the gradient in two passes over X, because a TPU
core cannot hold a row of the paper's 160,000 features.  ``logreg_grad``
reads X once: a cluster of up to 16 blocks holds a chunk's rows, each
block one slice of the columns, and the blocks exchange the rows' partial
margins through distributed shared memory (``csrc/logreg_grad.cu``, where
the design is described).  Its plan (:func:`grad_plan`) is a function of
(n, d) alone, and so is the order of every sum, so a partition's gradient
is bitwise the same whatever P, the strides or the alignment.  A width the
largest cluster cannot hold (d above 163,840) takes the two other kernels
in turn, a route chosen by the shape (``logreg_grad.routes``: ``one_pass``,
``chain``), never a fallback after a failure.  The fit paths launch
``logreg_grad``; the served path (``predict_proba``) launches
``logreg_margin`` with no labels (σ(Xw)).

All take a leading partition dimension, X ``(P, n, d)``, so one launch
serves every partition of a runner round; a 2-D X is one partition.  X may
be a strided view (the feature columns of a table whose column 0 is the
label) as long as its last dimension is contiguous, and fp32 or bf16; the
margin and the gradient are fp32.

Each wrapper runs its kernel for a CUDA tensor and the plain version for a
CPU tensor, and raises for anything else: a CUDA tensor never reaches the
plain version.  ``<wrapper>.launches`` counts kernel launches.  The
tickets the kernels' last blocks take are cached per device and left at
zero by the kernels, so a launch needs no fill beside it; launches on one
device must therefore not run concurrently on two streams.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["GradPlan", "grad_clusters", "grad_plan", "grad_plan_of", "logreg_margin",
           "logreg_xt_z", "logreg_grad", "logreg_margin_plain", "logreg_xt_z_plain",
           "logreg_grad_plain"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("logreg_grad")
        lib.logreg_margin_scratch.argtypes = [_I32, _I32, _I32,
                                              ctypes.POINTER(_I64),
                                              ctypes.POINTER(_I64)]
        lib.logreg_margin_scratch.restype = None
        lib.logreg_margin_launch.argtypes = [_I32, _P, _I64, _I64, _P, _I64,
                                             _P, _P, _P, _P, _I32, _I32, _I32,
                                             _P]
        lib.logreg_margin_launch.restype = _I32
        lib.logreg_xt_z_launch.argtypes = [_I32, _P, _I64, _I64, _P, _P,
                                           _I32, _I32, _I32, _P]
        lib.logreg_xt_z_launch.restype = _I32
        lib.logreg_grad_launch.argtypes = [_I32, _P, _I64, _I64, _P, _I64, _P,
                                           _I64, _I64, _P, _P, _P] + [_I32] * 9 + [_P]
        lib.logreg_grad_launch.restype = _I32
        lib.logreg_grad_clusters.argtypes = [_I32] * 9 + [ctypes.POINTER(_I32)]
        lib.logreg_grad_clusters.restype = _I32
        _lib_handle = lib
    return _lib_handle


# --------------------------------------------------------------------------- #
# the one-pass kernel's plan (csrc/logreg_grad.cu's grad_kernel)
# --------------------------------------------------------------------------- #
GRAD_THREADS = 512              # a block's threads (kGradThreads)
#: the kernel's forms, tried in turn: (columns a thread K, rows a stage R,
#: blocks a cluster at most).  A block's slices of g and w stay in
#: registers, K each.
GRAD_FORMS = ((8, 4, 8), (20, 1, 16))
GRAD_SMEM = 232448 - 2048       # the ring's shared memory (kGradRingSmem)
GRAD_MAX_STAGES = 8
#: chunks a partition is cut into, at most, by cluster size: an H100 holds 7
#: clusters of more than 8 blocks at once (one a GPC), so 7 chunks a
#: partition keep every wave of them full whatever P; smaller clusters fill
#: the card with 16
GRAD_CHUNKS = {False: 16, True: 7}
#: ... of at least these rows: a chunk's partial g costs one row's bytes
#: twice, which weighs more in a cluster of more than 8 blocks
GRAD_MIN_CHUNK_ROWS = {False: 16, True: 32}


def _slot_bytes(width: int) -> int:
    """A row's stage slot: the fp32 slice and up to 15 bytes on either side
    (csrc's grad_slot_bytes)."""
    return (width * 4 + 32 + 15) // 16 * 16


@dataclasses.dataclass(frozen=True)
class GradPlan:
    """How ``grad_kernel`` cuts an (n, d) partition: ``clusters`` blocks a
    cluster, each owning ``width`` columns (the last slice may be
    narrower) with ``cols_per_thread`` of them a thread; chunks of
    ``chunk_rows`` rows, one a cluster; a ring of ``stages`` stages of
    ``group_rows`` rows in shared memory.  Only ``clusters``, ``width``
    and ``chunk_rows`` bear on the order of the sums."""
    n: int
    d: int
    clusters: int
    width: int
    cols_per_thread: int
    chunk_rows: int
    group_rows: int
    stages: int

    @property
    def chunks(self) -> int:
        return -(-self.n // self.chunk_rows)

    @property
    def smem_bytes(self) -> int:
        """The ring's shared memory: group_rows · stages row slots."""
        return self.group_rows * self.stages * _slot_bytes(self.width)

    def scratch(self, P: int) -> Tuple[int, int]:
        """Floats of chunk partials and tickets a launch over P partitions
        needs (none where a partition is one chunk)."""
        if self.chunks == 1:
            return 0, 0
        return P * self.chunks * self.d, P * self.clusters


def grad_plan(n: int, d: int) -> Optional[GradPlan]:
    """The one-pass kernel's plan for partitions of n rows and d columns,
    or None where no cluster holds d (d > 163,840: the chain route).  A
    function of (n, d) alone, and so is the order of every sum: the first
    form of ``GRAD_FORMS`` whose slices (≤ 512·K columns) the largest
    cluster it allows covers, as many stages as shared memory holds (≤ 8),
    and chunks of ⌈n / 16⌉ rows, at least 16 (⌈n / 7⌉, at least 32, in
    clusters of more than 8 blocks)."""
    for K, R, most in GRAD_FORMS:
        C = -(-d // (K * GRAD_THREADS))
        if C <= most:
            break
    else:
        return None
    W = -(-d // C)
    S = min(GRAD_SMEM // (_slot_bytes(W) * R), GRAD_MAX_STAGES)
    Rc = max(-(-n // GRAD_CHUNKS[C > 8]), GRAD_MIN_CHUNK_ROWS[C > 8])
    return GradPlan(n, d, C, W, K, Rc, R, S)


def grad_plan_of(X: torch.Tensor) -> Optional[GradPlan]:
    """The plan :func:`logreg_grad` launches for X (n, d) or (P, n, d):
    :func:`grad_plan` of its rows and columns, whatever P, the strides or
    the dtype."""
    return grad_plan(X.shape[-2], X.shape[-1])


def grad_clusters(plan: GradPlan, dtype: torch.dtype = torch.float32) -> int:
    """Clusters of ``plan.clusters`` blocks the card holds at once
    (cudaOccupancyMaxActiveClusters at the plan's shared memory)."""
    out = _I32()
    err = _lib().logreg_grad_clusters(
        _build.DTYPE_CODES[dtype], plan.n, plan.d, plan.clusters, plan.width,
        plan.cols_per_thread, plan.chunk_rows, plan.group_rows, plan.stages,
        ctypes.byref(out))
    if err:
        raise RuntimeError(f"logreg_grad_clusters failed: CUDA error {err}")
    return out.value


# tickets of the kernels' last blocks, per device: made zero once, grown by
# a new buffer (an old one stays alive for any CUDA graph that holds it),
# and left at zero by every launch
_TICKETS: Dict[torch.device, torch.Tensor] = {}
_RETIRED: List[torch.Tensor] = []


def _tickets(device: torch.device, count: int) -> torch.Tensor:
    have = _TICKETS.get(device)
    if have is None or have.numel() < count:
        if have is not None:
            _RETIRED.append(have)
        have = torch.zeros(max(count, 4096), dtype=torch.int32, device=device)
        _TICKETS[device] = have
    return have


# --------------------------------------------------------------------------- #
# shapes
# --------------------------------------------------------------------------- #
def _check_logreg(X: torch.Tensor, y: Optional[torch.Tensor],
                  w: torch.Tensor) -> None:
    """The reference's shape check (``kernels/ops.py``), widened to a
    leading partition dimension: X (n, d) with y (n,), w (d,); or X
    (P, n, d) with y (P, n) and w (d,) shared or (P, d) per partition.
    ``y`` None (no labels) passes."""
    y_shape = tuple(X.shape[:-1]) if y is None else tuple(y.shape)
    if X.ndim == 2:
        n, d = X.shape
        ok = y_shape == (n,) and tuple(w.shape) == (d,)
    elif X.ndim == 3:
        P, n, d = X.shape
        ok = y_shape == (P, n) and tuple(w.shape) in ((d,), (P, d))
    else:
        ok = False
    if not ok:
        raise ValueError(f"shape mismatch: X{tuple(X.shape)} y{y_shape} "
                         f"w{tuple(w.shape)}")


def _as_parts(X: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """(P, n, d) view of X and whether X was 2-D (one partition)."""
    return (X.unsqueeze(0), True) if X.ndim == 2 else (X, False)


# --------------------------------------------------------------------------- #
# plain versions (CPU tensors; the card compares the kernels against them)
# --------------------------------------------------------------------------- #
def logreg_margin_plain(X: torch.Tensor, y: Optional[torch.Tensor],
                        w: torch.Tensor) -> torch.Tensor:
    """z = σ(Xw) − y in fp32 (σ(Xw) where y is None); shapes as
    :func:`logreg_margin`.  With a partition dimension, one product per
    partition: a partition's margins then never depend on how many
    partitions share the call (a batched product may pick its blocking by
    the batch), as the kernels' do not."""
    if X.ndim == 3:
        return torch.stack([
            logreg_margin_plain(X[i], None if y is None else y[i],
                                w[i] if w.ndim == 2 else w)
            for i in range(X.shape[0])])
    s = torch.sigmoid(X.float() @ w.float())
    return s if y is None else s - y.float()


def logreg_xt_z_plain(X: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """g = Xᵀz in fp32; shapes as :func:`logreg_xt_z`, one product per
    partition (as :func:`logreg_margin_plain`)."""
    if X.ndim == 3:
        return torch.stack([logreg_xt_z_plain(X[i], z[i])
                            for i in range(X.shape[0])])
    return X.float().t() @ z.float()


def logreg_grad_plain(X: torch.Tensor, y: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """Paper Eq. (1): ∇f = Xᵀ(σ(Xw) − y), cast to ``w.dtype``."""
    return logreg_xt_z_plain(X, logreg_margin_plain(X, y, w)).to(w.dtype)


# --------------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------------- #
def logreg_margin(X: torch.Tensor, y: Optional[torch.Tensor],
                  w: torch.Tensor) -> torch.Tensor:
    """z = σ(Xw) − y.  X (n, d) or (P, n, d); y (n,) or (P, n), or None
    for σ(Xw) alone (the served path: one launch, nothing beside it); w (d,)
    shared or (P, d) per partition → z (n,) or (P, n) fp32."""
    _check_logreg(X, y, w)
    if _build.on_cpu(X):
        return logreg_margin_plain(X, y, w)
    X3, flat = _as_parts(X)
    _build.check_cuda_operands(X3, w, *(() if y is None else (y,)))
    P, n, d = X3.shape
    yf = None if y is None else y.reshape(P, n).float().contiguous()
    wf = w.float().contiguous()
    z = torch.empty((P, n), dtype=torch.float32, device=X.device)
    lib = _lib()
    n_partial, n_tickets = _I64(), _I64()
    lib.logreg_margin_scratch(P, n, d, ctypes.byref(n_partial),
                              ctypes.byref(n_tickets))
    partial = torch.empty(n_partial.value, dtype=torch.float32, device=X.device)
    tickets = _tickets(X.device, n_tickets.value)
    err = lib.logreg_margin_launch(
        _build.DTYPE_CODES[X3.dtype], X3.data_ptr(), X3.stride(0), X3.stride(1),
        wf.data_ptr(), d if wf.ndim == 2 else 0, None if yf is None else yf.data_ptr(),
        z.data_ptr(),
        partial.data_ptr(), tickets.data_ptr(), P, n, d,
        torch.cuda.current_stream(X.device).cuda_stream)
    if err:
        raise RuntimeError(f"logreg_margin launch failed: CUDA error {err}")
    logreg_margin.launches += 1
    return z[0] if flat else z


logreg_margin.launches = 0


def logreg_xt_z(X: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """g = Xᵀz.  X (n, d) or (P, n, d); z (n,) or (P, n) → g (d,) or
    (P, d) fp32: each partition's own sum over its rows."""
    if X.ndim not in (2, 3) or tuple(z.shape) != tuple(X.shape[:-1]):
        raise ValueError(f"shape mismatch: X{tuple(X.shape)} z{tuple(z.shape)}")
    if _build.on_cpu(X):
        return logreg_xt_z_plain(X, z)
    X3, flat = _as_parts(X)
    _build.check_cuda_operands(X3, z)
    P, n, d = X3.shape
    zf = z.reshape(P, n).float().contiguous()
    g = torch.empty((P, d), dtype=torch.float32, device=X.device)
    err = _lib().logreg_xt_z_launch(
        _build.DTYPE_CODES[X3.dtype], X3.data_ptr(), X3.stride(0), X3.stride(1),
        zf.data_ptr(), g.data_ptr(), P, n, d,
        torch.cuda.current_stream(X.device).cuda_stream)
    if err:
        raise RuntimeError(f"logreg_xt_z launch failed: CUDA error {err}")
    logreg_xt_z.launches += 1
    return g[0] if flat else g


logreg_xt_z.launches = 0


def logreg_grad(X: torch.Tensor, y: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """∇f = Xᵀ(σ(Xw) − y), fp32, cast to ``w.dtype`` (the reference's
    ``logreg_grad_pallas``).  X (n, d) or (P, n, d); y (n,) or (P, n), fp32
    at any strides (the label column of the table X is a view of); w (d,)
    shared or (P, d) per partition → g (d,) or (P, d), each partition's own
    sum over its rows.  One launch of ``grad_kernel`` under
    :func:`grad_plan`, or, where no cluster holds d, the chain of
    :func:`logreg_margin` and :func:`logreg_xt_z`."""
    _check_logreg(X, y, w)
    if _build.on_cpu(X):
        return logreg_grad_plain(X, y, w)
    X3, flat = _as_parts(X)
    _build.check_cuda_operands(X3, y, w)
    P, n, d = X3.shape
    plan = grad_plan_of(X3)
    if plan is None:
        logreg_grad.routes["chain"] += 1
        return logreg_xt_z(X, logreg_margin(X, y, w)).to(w.dtype)
    y3 = (y.unsqueeze(0) if flat else y).float()
    wf = w.float()
    if wf.stride(-1) != 1:
        wf = wf.contiguous()
    g = torch.empty((P, d), dtype=torch.float32, device=X.device)
    n_partial, n_tickets = plan.scratch(P)
    # pointers the kernel does not touch where a partition is one chunk
    partial = torch.empty(n_partial, dtype=torch.float32, device=X.device) if n_partial else g
    tickets = _tickets(X.device, n_tickets) if n_tickets else g
    err = _lib().logreg_grad_launch(
        _build.DTYPE_CODES[X3.dtype], X3.data_ptr(), X3.stride(0), X3.stride(1),
        wf.data_ptr(), wf.stride(0) if wf.ndim == 2 else 0,
        y3.data_ptr(), y3.stride(0), y3.stride(1), g.data_ptr(), partial.data_ptr(),
        tickets.data_ptr(), P, n, d, plan.clusters, plan.width, plan.cols_per_thread,
        plan.chunk_rows, plan.group_rows, plan.stages,
        torch.cuda.current_stream(X.device).cuda_stream)
    if err:
        raise RuntimeError(f"logreg_grad launch failed: CUDA error {err}")
    logreg_grad.launches += 1
    logreg_grad.routes["one_pass"] += 1
    return (g[0] if flat else g).to(w.dtype)


logreg_grad.launches = 0
logreg_grad.routes = collections.Counter()
