"""Jobs of several processes: the process group behind the data axis.

The counterpart of ``mxnet_tpu/parallel/multihost.py``.  The JAX package
runs one XLA program on every process over a process-spanning mesh and
lets GSPMD place the gradient sum.  The port runs an eager step on each
rank and reduces explicitly, through one ``torch.distributed`` process
group that every rank joins from the launcher's environment
(``tools/launch.py``: ``MXNET_TPU_COORDINATOR`` as ``host:port``,
``MXNET_TPU_NUM_PROCESSES``, ``MXNET_TPU_PROCESS_ID``).

The backend follows from the devices, not from a knob: ``nccl`` where
each rank has a card of its own, ``gloo`` on the CPU and where ranks
share a card (NCCL refuses two ranks on one device; gloo reduces CUDA
tensors through host memory).  A rank's device is ``cuda:(rank %
device_count)``.  Gloo takes CUDA tensors for ``all_reduce``,
``broadcast`` and ``barrier`` only, so gathers go through host copies
(:func:`collective_device`).

The helpers cover what the JAX module covers:

* joining the job (:func:`ensure_initialized`, bounded by
  ``MXNET_TPU_INIT_TIMEOUT`` and retried ``MXNET_TPU_INIT_RETRIES``
  times; ``MXNET_TPU_HEARTBEAT_TIMEOUT`` bounds every later collective,
  so a rank blocked on a dead peer fails instead of waiting out the
  30-minute default);
* the rows of the global batch each rank runs (:func:`stage_local`,
  JAX's process-local staging: rank r holds the r-th contiguous block);
* host copies of state for rank-0 checkpoint writes
  (:func:`gather_to_host`) and the timeout-bounded barrier
  (:func:`process_barrier`).
"""
from __future__ import annotations

import datetime
import time

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["ensure_initialized", "spans_processes", "stage_local",
           "scale_local_shape", "gather_to_host", "process_barrier",
           "world_size", "rank", "backend", "device", "collective_device",
           "all_reduce", "broadcast_from_rank0", "launch_all_reduce",
           "batch_group",
           "batch_sums_span_ranks",
           "reduce_batch_sums"]


def _dist():
    import torch.distributed as dist
    return dist


def _joined():
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def world_size():
    """Processes in the running job (1 outside a job)."""
    return _dist().get_world_size() if _joined() else 1


def rank():
    """This process's rank (0 outside a job)."""
    return _dist().get_rank() if _joined() else 0


def backend():
    """The process group's backend (``"nccl"`` or ``"gloo"``), or None
    outside a job."""
    return str(_dist().get_backend()) if _joined() else None


def _choose_backend(nproc):
    """``nccl`` when every rank of the job can have a card of its own on
    this host, else ``gloo`` (the CPU, or ranks sharing a card)."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= nproc:
        return "nccl"
    return "gloo"


def device():
    """This rank's device: ``cuda:(rank % device_count)`` with a card,
    else the CPU."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    from .. import config
    r = rank() if _joined() else config.get_int("MXNET_TPU_PROCESS_ID", 0)
    return torch.device("cuda", r % torch.cuda.device_count())


def collective_device(dev=None):
    """Where a gather's tensors must lie: the card under ``nccl``, the
    host under ``gloo`` (whose CUDA support stops at all_reduce,
    broadcast and barrier)."""
    if backend() == "nccl":
        return dev if dev is not None else device()
    return torch.device("cpu")


def _timeout_s():
    from .. import config
    return config.get_int("MXNET_TPU_HEARTBEAT_TIMEOUT") or None


def ensure_initialized():
    """Join the process group the ``MXNET_TPU_*`` environment describes;
    a no-op outside a job or when joined already.  A job is a
    coordinator with more than one process, or a launched job of one
    process (so its collectives still run, on NCCL where there is a
    card).  Returns the world size.

    The join is bounded by ``MXNET_TPU_INIT_TIMEOUT`` seconds (0: the
    backend's own) and a failed connect is retried with backoff up to
    ``MXNET_TPU_INIT_RETRIES`` times (a coordinator still binding its
    port); a timed-out join is terminal.  The ``multihost.init`` seam
    fires inside the retried attempt."""
    from .. import config
    from .. import resilience

    nproc = config.get_int("MXNET_TPU_NUM_PROCESSES") or 1
    coordinator = config.get("MXNET_TPU_COORDINATOR")
    need = (nproc > 1 or bool(coordinator)) and not _joined()
    if need and not coordinator:
        raise MXNetError(
            "MXNET_TPU_NUM_PROCESSES=%d but MXNET_TPU_COORDINATOR is "
            "unset; launch through tools/launch.py or export the "
            "coordinator address" % nproc)
    init_timeout = config.get_int("MXNET_TPU_INIT_TIMEOUT") or None
    coll_timeout = _timeout_s()

    def attempt():
        resilience.fault_point("multihost.init")
        if not need or _joined():
            return
        pid = config.get_int("MXNET_TPU_PROCESS_ID", 0)
        chosen = _choose_backend(nproc)
        if chosen == "nccl":
            torch.cuda.set_device(pid % torch.cuda.device_count())
        kw = {}
        if coll_timeout or init_timeout:
            kw["timeout"] = datetime.timedelta(
                seconds=coll_timeout or init_timeout)
        host_port = coordinator if "://" in coordinator \
            else "tcp://" + coordinator
        resilience.with_timeout(
            lambda: _dist().init_process_group(
                chosen, init_method=host_port, world_size=nproc,
                rank=pid, **kw),
            init_timeout, name="init_process_group(%s)" % coordinator)

    resilience.retry_call(
        attempt,
        retries=config.get_int("MXNET_TPU_INIT_RETRIES", "2"),
        exceptions=(resilience.FaultInjected, RuntimeError,
                    ConnectionError, OSError),
        no_retry=(resilience.TimeoutError,),
        base_delay=0.2, max_delay=5.0,
        name="multihost.ensure_initialized")
    return world_size()


def spans_processes(mesh):
    """True when the mesh's data axis spans more than one process."""
    return int(getattr(mesh, "world", 1)) > 1


def scale_local_shape(local_shape, world=None):
    """The global shape a rank's local rows imply: the batch dimension
    times the processes (a partial tail batch follows its local size, as
    in JAX)."""
    world = world_size() if world is None else int(world)
    shape = list(local_shape)
    if shape:
        shape[0] *= world
    return tuple(shape)


def stage_local(value, world=None, r=None):
    """This rank's rows of a global batch ``value`` (dim 0): the r-th of
    ``world`` contiguous equal blocks, the rows JAX's process-local
    staging gives process r.  A value whose leading dim is not a multiple
    of the world raises."""
    world = world_size() if world is None else int(world)
    r = rank() if r is None else int(r)
    n = int(value.shape[0])
    if n % world:
        raise MXNetError("a global batch of %d rows does not split over "
                         "%d processes" % (n, world))
    step = n // world
    return value[r * step:(r + 1) * step]


def all_reduce(tensor, group=None):
    """Sum ``tensor`` in place across the job (a no-op outside one)."""
    if _joined():
        _dist().all_reduce(tensor, group=group)
    return tensor


def broadcast_from_rank0(tensors):
    """Overwrite ``tensors`` in place with rank 0's values: one broadcast
    of one flat buffer a dtype (a collective per tensor costs a round trip
    each)."""
    groups = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    for same in groups.values():
        buf = torch.cat([t.detach().reshape(-1) for t in same])
        _dist().broadcast(buf, 0)
        off = 0
        with torch.no_grad():
            for t in same:
                n = t.numel()
                t.copy_(buf[off:off + n].reshape(t.shape))
                off += n


def launch_all_reduce(values):
    """Start summing ``{key: tensor}`` across the job: the tensors
    flattened into one buffer a dtype, keys in order, each buffer one
    asynchronous all-reduce.  Returns ``(wait, collectives)``: ``wait()``
    waits for them and gives ``{key: summed tensor}``."""
    groups = {}
    for k, t in values.items():
        groups.setdefault(t.dtype, []).append(k)
    flat, works = [], []
    for keys in groups.values():
        buf = torch.cat([values[k].reshape(-1) for k in keys])
        flat.append((keys, buf))
        works.append(_dist().all_reduce(buf, async_op=True))

    def wait():
        for w in works:
            w.wait()
        out = {}
        for keys, buf in flat:
            off = 0
            for k in keys:
                n = values[k].numel()
                out[k] = buf[off:off + n].reshape(values[k].shape)
                off += n
        return out
    return wait, len(works)


def gather_to_host(tensor):
    """A numpy copy of a tensor every rank holds whole.  Data-parallel
    state is replicated, so this is a local read on every rank, as JAX's
    ``gather_to_host`` of a fully replicated array is."""
    return tensor.detach().float().cpu().numpy() \
        if tensor.is_floating_point() else tensor.detach().cpu().numpy()


_barrier_state = {"warm": False}


def process_barrier(name="mxnet_tpu_multihost"):
    """Block until every rank reaches this point (rank-0 checkpoint
    writes before any rank reads them).  ``MXNET_TPU_BARRIER_TIMEOUT``
    seconds bound it: a timeout is terminal and names the barrier (a dead
    peer, not a hang).  The ``multihost.barrier`` seam is retried
    ``MXNET_TPU_BARRIER_RETRIES`` times.  Every barrier after the first
    records its wait in ``mxtpu_collective_wait_seconds``."""
    from .. import config
    from .. import resilience

    timeout = config.get_int("MXNET_TPU_BARRIER_TIMEOUT") or None

    def attempt():
        resilience.fault_point("multihost.barrier")
        if world_size() > 1:
            t0 = time.perf_counter()
            resilience.with_timeout(_dist().barrier, timeout,
                                    name="process_barrier(%r)" % name)
            if _barrier_state["warm"]:
                from ..telemetry.registry import histogram
                histogram("mxtpu_collective_wait_seconds").observe(
                    time.perf_counter() - t0)
            else:
                _barrier_state["warm"] = True

    resilience.retry_call(
        attempt,
        retries=config.get_int("MXNET_TPU_BARRIER_RETRIES", "1"),
        exceptions=(resilience.FaultInjected,),
        base_delay=0.1, max_delay=2.0,
        name="process_barrier(%r)" % name)


class batch_group:
    """While active (a data-parallel trainer's step), reductions over the
    batch axis span the job: BatchNorm's batch statistics and their
    backward sums are summed across ranks (:func:`reduce_batch_sums`), as
    the JAX step's one global program sums them over the global batch.
    Outside it (the Module path, one process) each rank reduces its own
    rows."""

    _active = 0

    def __init__(self, on=True):
        self._on = bool(on) and world_size() > 1

    def __enter__(self):
        if self._on:
            batch_group._active += 1
        return self

    def __exit__(self, *exc):
        if self._on:
            batch_group._active -= 1
        return False


def batch_sums_span_ranks():
    """Whether BatchNorm's batch sums must be summed across the job."""
    return batch_group._active > 0


def reduce_batch_sums(*vectors):
    """Sum the per-rank tensors across the job in one collective (one flat
    f32 buffer) and return the sums, in order, shaped as given.  Nothing
    waits for the device: the counts of rows these sums divide by are
    the local count times the world (:func:`stage_local` splits evenly),
    kept on the host."""
    shapes = [v.shape for v in vectors]
    buf = torch.cat([v.detach().float().reshape(-1) for v in vectors])
    _dist().all_reduce(buf)
    out, off = [], 0
    for shape in shapes:
        n = int(np.prod(shape)) if len(shape) else 1
        out.append(buf[off:off + n].reshape(shape))
        off += n
    return out
