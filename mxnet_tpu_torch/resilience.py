"""Resilience primitives: fault injection, retry and backoff, atomic files
and checkpoint manifests.

The counterpart of ``mxnet_tpu/resilience.py``, the substrate the
checkpoint and resume paths build on:

* a deterministic, seeded **fault-injection registry**: seams are named
  sites (:data:`KNOWN_SITES`) that code evaluates with
  :func:`fault_point`, armed through ``MXNET_TPU_FAULTS`` (or
  :func:`configure_faults`), so tests reproduce exact failure sequences.
  The grammar, sites separated by ``;``::

      MXNET_TPU_FAULTS="recordio.read:p=0.05,seed=7;checkpoint.save:n=1"

  per-site keys: ``p`` (probability, default 1), ``seed`` (the site's
  ``random.Random`` seed, default 0), ``n`` (most injections, default no
  limit), ``after`` (skip the first K evaluations), ``kind`` (``error``
  raises :class:`FaultInjected`, ``delay`` sleeps ``delay`` seconds).  The
  same spec gives the same injections as in the JAX package;
* **retry, timeout and backoff**: :func:`backoff_delays` (exponential with
  seeded jitter), :func:`retry_call` and :func:`retryable` (bounded retry
  under a deadline), :func:`with_timeout`, :class:`Deadline`;
* **atomic files and manifests**: :func:`atomic_write` (temporary file,
  fsync, rename) and :func:`write_manifest` / :func:`verify_manifest`
  (per-file and per-array CRC32 records that prove a checkpoint complete
  before a loader parses it), in the JAX package's manifest format, so a
  manifest written by either package verifies in the other.

Retries and injections count ``mxtpu_retry_total{site}`` and
``mxtpu_fault_injected_total{site}`` in the telemetry registry (an
injection also leaves a ``fault`` flight event), as in the JAX package,
and :func:`fault_stats` keeps plain counts under those names.
"""
from __future__ import annotations

import functools
import json
import logging
import os
import random
import threading
import time
import zlib

import numpy as np

from .base import MXNetError
from . import telemetry as _telemetry

__all__ = [
    "KNOWN_SITES", "FaultInjected", "TimeoutError",
    "configure_faults", "clear_faults", "fault_point", "fault_stats",
    "faults_active",
    "Deadline", "backoff_delays", "retry_call", "retryable",
    "with_timeout",
    "atomic_write", "array_crc32", "manifest_path", "write_manifest",
    "verify_manifest", "load_manifest",
]

# the declared seams, the JAX package's list; fault_point() takes any name
# (a misspelt site never fires), configure_faults() warns on unknown ones
KNOWN_SITES = (
    "recordio.read", "checkpoint.save", "checkpoint.load",
    "multihost.init", "multihost.barrier", "io.prefetch",
    "io.decode",
    # io_resume.restore_iterator, before any iterator changes; io.remap in
    # io_resume.remap_state
    "io.resume", "io.remap",
    "trainer.step",
    "kvstore.collective",
    "reshard.gather", "reshard.scatter", "elastic.rejoin",
    "numerics.nonfinite",
    "serve.dispatch",
)


class FaultInjected(MXNetError):
    """Raised by an armed :func:`fault_point` seam (never by real code)."""

    def __init__(self, site, hit):
        super().__init__(
            "injected fault at site %r (injection #%d), armed via "
            "MXNET_TPU_FAULTS / configure_faults()" % (site, hit))
        self.site = site
        self.hit = hit


class TimeoutError(MXNetError):
    """A :func:`with_timeout` call ran past its limit."""


# --------------------------------------------------------------- fault registry

class _Site:
    __slots__ = ("name", "p", "seed", "times", "after", "kind", "delay",
                 "rng", "calls", "hits")

    def __init__(self, name, p=1.0, seed=0, times=None, after=0,
                 kind="error", delay=0.05):
        self.name = name
        self.p = float(p)
        self.seed = int(seed)
        self.times = None if times is None else int(times)
        self.after = int(after)
        if kind not in ("error", "delay"):
            raise MXNetError("fault site %r: unknown kind=%r "
                             "(use error|delay)" % (name, kind))
        self.kind = kind
        self.delay = float(delay)
        self.rng = random.Random(self.seed)
        self.calls = 0
        self.hits = 0


# reentrant: a preemption handler's save fires a seam in the main thread,
# which the signal may have interrupted inside this lock
_LOCK = threading.RLock()
_SITES = {}
_ENV_SNAPSHOT = None     # the MXNET_TPU_FAULTS value last parsed
_INJECTED = {}           # site -> injections since import
_RETRIES = {}            # call name -> retries since import


def _parse_spec(spec):
    sites = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, params = part.partition(":")
        name = name.strip()
        if name not in KNOWN_SITES:
            logging.warning(
                "MXNET_TPU_FAULTS: site %r is not a declared seam %s; "
                "the spec will never fire there", name, list(KNOWN_SITES))
        kw = {}
        for item in params.split(","):
            item = item.strip()
            if not item:
                continue
            if "=" not in item:
                raise MXNetError(
                    "bad fault spec %r: expected key=value, got %r "
                    "(grammar: site:p=0.05,seed=7[,n=3,after=2,"
                    "kind=error|delay,delay=0.1];site2:...)" % (spec, item))
            k, _, v = item.partition("=")
            k = k.strip()
            if k not in ("p", "seed", "n", "after", "kind", "delay"):
                raise MXNetError("bad fault spec %r: unknown key %r"
                                 % (spec, k))
            kw["times" if k == "n" else k] = v.strip()
        sites[name] = _Site(name, **kw)
    return sites


def configure_faults(spec=None):
    """Arm the sites of ``spec`` (``MXNET_TPU_FAULTS`` when None), replacing
    the current ones and starting their counts and generators over, so the
    injections follow from the seeds alone.  Returns the armed names."""
    global _SITES, _ENV_SNAPSHOT
    if spec is None:
        spec = os.environ.get("MXNET_TPU_FAULTS", "")
    with _LOCK:
        _SITES = _parse_spec(spec)
        _ENV_SNAPSHOT = os.environ.get("MXNET_TPU_FAULTS", "")
    return sorted(_SITES)


def clear_faults():
    """Disarm every site (until ``MXNET_TPU_FAULTS`` changes)."""
    global _SITES, _ENV_SNAPSHOT
    with _LOCK:
        _SITES = {}
        _ENV_SNAPSHOT = os.environ.get("MXNET_TPU_FAULTS", "")


def faults_active():
    """Whether at least one site is armed."""
    _sync_env()
    return bool(_SITES)


def _sync_env():
    # arm from the environment on first use and whenever it changes, so a
    # child process inherits the spec; a string compare keeps a seam cheap
    if os.environ.get("MXNET_TPU_FAULTS", "") != _ENV_SNAPSHOT:
        configure_faults(None)


def fault_point(site):
    """Evaluate the seam ``site``: nothing unless it is armed; an armed
    site draws from its own seeded generator, so its k-th evaluation fires
    alike in every run.  ``kind=error`` raises :class:`FaultInjected`,
    ``kind=delay`` sleeps."""
    _sync_env()
    s = _SITES.get(site)
    if s is None:
        return
    with _LOCK:
        s.calls += 1
        if s.calls <= s.after:
            return
        if s.times is not None and s.hits >= s.times:
            return
        if s.p < 1.0 and s.rng.random() >= s.p:
            return
        s.hits += 1
        hit, kind, delay = s.hits, s.kind, s.delay
        _INJECTED[site] = _INJECTED.get(site, 0) + 1
    _telemetry.counter("mxtpu_fault_injected_total").labels(site=site).inc()
    _telemetry.flight.record("fault", site=site, hit=hit, fault_kind=kind)
    if kind == "delay":
        time.sleep(delay)
        return
    raise FaultInjected(site, hit)


def fault_stats():
    """``{site: {"calls": n, "hits": m}}`` of every armed site, with
    ``"mxtpu_fault_injected_total"`` (injections by site) and
    ``"mxtpu_retry_total"`` (retries by call name) since import."""
    with _LOCK:
        out = {name: {"calls": s.calls, "hits": s.hits}
               for name, s in _SITES.items()}
        out["mxtpu_fault_injected_total"] = dict(_INJECTED)
        out["mxtpu_retry_total"] = dict(_RETRIES)
    return out


# ------------------------------------------------------------- retry / backoff

class Deadline:
    """A wall-clock budget shared across retries; ``seconds=None`` never
    expires."""

    def __init__(self, seconds):
        self.seconds = seconds
        self._expiry = None if seconds is None \
            else time.monotonic() + float(seconds)

    def remaining(self):
        """Seconds left (None: no limit)."""
        if self._expiry is None:
            return None
        return max(0.0, self._expiry - time.monotonic())

    def expired(self):
        return self._expiry is not None and \
            time.monotonic() >= self._expiry


def backoff_delays(base=0.05, factor=2.0, max_delay=2.0, jitter=0.1,
                   seed=None):
    """Endless exponential delays ``base * factor**k`` capped at
    ``max_delay``, each times a uniform draw in ``[1-jitter, 1+jitter]``
    from ``random.Random(seed)``: the same seed, the same sequence."""
    rng = random.Random(seed)
    delay = float(base)
    while True:
        if jitter:
            yield min(delay, max_delay) * \
                (1.0 + jitter * (2.0 * rng.random() - 1.0))
        else:
            yield min(delay, max_delay)
        delay = min(delay * factor, max_delay)


def retry_call(fn, args=(), kwargs=None, retries=3,
               exceptions=(Exception,), no_retry=(), base_delay=0.05,
               factor=2.0, max_delay=2.0, jitter=0.1, deadline=None,
               seed=None, on_retry=None, name=None):
    """``fn(*args, **kwargs)``, retried up to ``retries`` more times with
    backoff on one of ``exceptions`` (``no_retry`` ones re-raise at once),
    never past ``deadline`` seconds in all.  ``on_retry(attempt, exc,
    delay)`` runs before each sleep.  When the retries or the deadline run
    out, raises MXNetError naming the call, chained to the last error."""
    kwargs = kwargs or {}
    what = name or getattr(fn, "__name__", repr(fn))
    dl = deadline if isinstance(deadline, Deadline) else Deadline(deadline)
    delays = backoff_delays(base_delay, factor, max_delay, jitter, seed)
    last = None
    for attempt in range(retries + 1):
        try:
            return fn(*args, **kwargs)
        except exceptions as e:
            if no_retry and isinstance(e, tuple(no_retry)):
                raise
            last = e
            if attempt >= retries:
                break
            delay = next(delays)
            rem = dl.remaining()
            if rem is not None:
                if rem <= 0:
                    break
                delay = min(delay, rem)
            with _LOCK:
                _RETRIES[what] = _RETRIES.get(what, 0) + 1
            _telemetry.counter("mxtpu_retry_total").labels(site=what).inc()
            if on_retry is not None:
                on_retry(attempt + 1, e, delay)
            else:
                logging.warning("%s failed (%s: %s); retry %d/%d in "
                                "%.2fs", what, type(e).__name__, e,
                                attempt + 1, retries, delay)
            time.sleep(delay)
    raise MXNetError(
        "%s failed after %d attempt(s)%s: %s: %s"
        % (what, attempt + 1,
           " (deadline %.1fs expired)" % dl.seconds
           if dl.expired() and dl.seconds is not None else "",
           type(last).__name__, last)) from last


def retryable(**cfg):
    """:func:`retry_call` as a decorator::

        @retryable(retries=2, exceptions=(IOError,), deadline=30)
        def fetch(): ...
    """
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            return retry_call(fn, args=args, kwargs=kwargs, **cfg)
        return inner
    return wrap


def with_timeout(fn, timeout, name=None, args=(), kwargs=None):
    """``fn(*args, **kwargs)`` in a daemon thread; raises
    :class:`TimeoutError` after ``timeout`` seconds (the thread is left
    parked).  ``timeout`` None or <= 0 calls ``fn`` in this thread."""
    if timeout is None or timeout <= 0:
        return fn(*args, **(kwargs or {}))
    what = name or getattr(fn, "__name__", repr(fn))
    result, error = [], []

    def runner():
        try:
            result.append(fn(*args, **(kwargs or {})))
        except BaseException as e:   # re-raised on the caller after join
            error.append(e)

    t = threading.Thread(target=runner, daemon=True,
                         name="timeout:%s" % what)
    t.start()
    t.join(timeout)
    if t.is_alive():
        raise TimeoutError("%s did not complete within %.1fs"
                           % (what, timeout))
    if error:
        raise error[0]
    return result[0]


# --------------------------------------------------- atomic files + manifests

def atomic_write(path, write_fn, fault_site=None):
    """``write_fn(tmp_path)`` writes a sibling temporary file, which is
    fsynced and renamed over ``path``: a reader sees the old file or the
    whole new one.  ``fault_site`` (e.g. ``"checkpoint.save"``) is
    evaluated between the write and the rename, the window a crash leaves
    a stray temporary file in: an injected fault leaves it there, any
    other error removes it and propagates."""
    tmp = "%s.tmp.%d" % (path, os.getpid())
    try:
        write_fn(tmp)
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except BaseException:    # clean up, then the bare raise propagates
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    if fault_site is not None:
        fault_point(fault_site)
    os.replace(tmp, path)


def array_crc32(arr):
    """CRC32 of an array's bytes in C order."""
    a = np.ascontiguousarray(arr)
    return zlib.crc32(a.tobytes()) & 0xFFFFFFFF


def _file_crc32(path, chunk=1 << 20):
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                break
            crc = zlib.crc32(buf, crc)
    return crc & 0xFFFFFFFF


def manifest_path(prefix, epoch):
    """The manifest beside a ``prefix-%04d.*`` checkpoint."""
    return "%s-%04d.manifest.json" % (prefix, epoch)


def _host_array(arr):
    """A numpy array of an NDArray, a tensor (any device) or an array."""
    if hasattr(arr, "asnumpy"):
        return np.asarray(arr.asnumpy())
    if hasattr(arr, "detach"):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def write_manifest(prefix, epoch, files, arrays=None, meta=None):
    """Write the checkpoint's manifest, atomically and last: it commits the
    checkpoint.  ``files``: the checkpoint's paths, each recorded with its
    size and CRC32; ``arrays``: ``{name: array}``, each recorded with its
    CRC32, shape and dtype; ``meta``: a JSON-able dict stored as it is
    (``meta["mesh"]`` makes the manifest format 2, ``meta["data_state"]``
    is the data iterator's durable state).  Returns the manifest's path."""
    entry_files = {}
    for p in files:
        entry_files[os.path.basename(p)] = {
            "size": os.path.getsize(p),
            "crc32": _file_crc32(p),
        }
    entry_arrays = {}
    for name, arr in (arrays or {}).items():
        a = _host_array(arr)
        entry_arrays[name] = {
            "crc32": array_crc32(a),
            "shape": list(a.shape),
            "dtype": str(a.dtype),
        }
    meta = dict(meta or {})
    doc = {
        "format": 2 if meta.get("mesh") else 1,
        "epoch": int(epoch),
        "files": entry_files,
        "arrays": entry_arrays,
        "meta": meta,
    }
    path = manifest_path(prefix, epoch)
    atomic_write(path, lambda tmp: _dump_json(tmp, doc))
    return path


def _dump_json(path, doc):
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)


def load_manifest(prefix, epoch):
    """The parsed manifest, or None when there is none (a checkpoint from
    before manifests still loads); an unreadable one raises MXNetError
    naming it."""
    path = manifest_path(prefix, epoch)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (ValueError, OSError) as e:
        raise MXNetError("corrupt checkpoint manifest %r: %s"
                         % (path, e)) from e


def verify_manifest(prefix, epoch, quick=False):
    """Check every file the manifest lists: present, of its size, and (not
    ``quick``) of its CRC32.  Returns the manifest (None when there is
    none); a mismatch raises MXNetError naming the file.  ``quick`` is the
    screening of many epochs; a loader CRC-checks the epoch it opens."""
    doc = load_manifest(prefix, epoch)
    if doc is None:
        return None
    base = os.path.dirname(prefix)
    for fname, rec in doc.get("files", {}).items():
        path = os.path.join(base, fname) if base else fname
        if not os.path.exists(path):
            raise MXNetError(
                "checkpoint %s epoch %d is incomplete: %r listed in "
                "manifest but missing on disk" % (prefix, epoch, path))
        size = os.path.getsize(path)
        if size != rec["size"]:
            raise MXNetError(
                "checkpoint file %r is truncated/corrupt: size %d != "
                "manifest size %d" % (path, size, rec["size"]))
        if quick:
            continue
        crc = _file_crc32(path)
        if crc != rec["crc32"]:
            raise MXNetError(
                "checkpoint file %r failed CRC32 verification "
                "(0x%08x != manifest 0x%08x)" % (path, crc, rec["crc32"]))
    return doc
