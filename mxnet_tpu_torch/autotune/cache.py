"""The persistent tuning cache: measured-best tile configurations by key.

The counterpart of ``mxnet_tpu/autotune/cache.py``.  One entry maps a
tunable-kernel key (op, shape signature, dtypes, mesh, backend, extra
statics), hashed as the JAX package hashes it, to the tile configuration
that measured fastest, with the walls of the winner and of the built-in
choice.  The commit target of :mod:`.search` and
:mod:`mxnet_tpu_torch.analysis.plansearch`; the lookup the kernel
wrappers (``ops.flash_attention``, ``ops.fused.matmul_stats``) and
``analysis.fusion.apply_block`` consult.

Persistence is JSONL (schema ``mxtpu-tunecache/1``, one entry a line)
under ``MXNET_TPU_TUNE_CACHE``; every ``tunecache*.jsonl`` in the directory
is merged on load, the best measured wall winning per key, so that caches
of several runs compose.  A file written by the JAX package reads here, and
the reverse.  A corrupt or empty cache degrades to the built-in choice: the
lookup never raises into a kernel call.

``MXNET_TPU_AUTOTUNE`` is ``off`` (no lookup at all), ``cache`` (the
default: a miss takes the built-in choice) or ``search`` (a miss of a
kernel the tuners know runs a bounded search, commits its winner and uses
it; never while the current stream is capturing a CUDA graph, where the
search's synchronisations would break the capture).

Where the JAX package looks a key up once a trace, the eager port would
look it up at every kernel call; so :func:`kernel_config` resolves each key
once a cache generation (a :func:`put` or :func:`reload_cache` starts a new
one) and counts the hit or miss (``mxtpu_tune_cache_{hit,miss}_total``) and
writes the ``tune_lookup`` flight event at that first resolution, the
counterpart of JAX's once a trace.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time

__all__ = [
    "SCHEMA", "TuneCache", "CACHE",
    "autotune_mode", "cache_dir", "key_sig",
    "kernel_config", "block_config", "lookup", "put",
    "read_entries", "reload_cache", "summary", "reset_stats",
    "resolution_token",
]

SCHEMA = "mxtpu-tunecache/1"

_MODES = ("off", "cache", "search")


def autotune_mode():
    """``MXNET_TPU_AUTOTUNE``: ``off`` | ``cache`` (default) | ``search``.
    Unknown values read as ``cache``."""
    v = os.environ.get("MXNET_TPU_AUTOTUNE", "cache").strip().lower()
    return v if v in _MODES else "cache"


def cache_dir():
    """The persistence directory (``MXNET_TPU_TUNE_CACHE``), or None when
    the cache lives in memory only (puts do not persist)."""
    return os.environ.get("MXNET_TPU_TUNE_CACHE") or None


def _backend():
    from ..telemetry import costdb
    return costdb.backend_name()


def key_sig(op, shapes, dtypes, mesh=None, backend=None, extra=None):
    """The 12-hex key of one tunable-kernel identity and its payload: the
    JAX package's payload and sha1, so one key gives the same digest in
    both packages.  Dtypes are spelled as numpy spells them (``float32``,
    ``bfloat16``); the backend is ``costdb.backend_name``'s (``gpu`` on the
    card)."""
    payload = {
        "op": str(op),
        "shapes": [list(s) for s in shapes],
        "dtypes": [str(d) for d in dtypes],
        "mesh": dict(mesh) if mesh else None,
        "backend": backend or _backend(),
        "extra": dict(extra) if extra else None,
    }
    blob = json.dumps(payload, sort_keys=True, default=repr)
    return hashlib.sha1(blob.encode("utf-8")).hexdigest()[:12], payload


def _ts(entry):
    ts = entry.get("ts")
    return float(ts) if isinstance(ts, (int, float)) else float("-inf")


class TuneCache:
    """The merged in-memory view of the persistent tuning cache.  One
    instance (:data:`CACHE`) serves the process and loads
    ``MXNET_TPU_TUNE_CACHE`` at first use; tests build their own."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries = {}        # sig -> entry dict
        self._loaded_dir = None   # the directory the entries came from

    def load(self, path, merge=True):
        """Merge the entries of a ``tunecache*.jsonl`` file or a directory
        of them (best measured wall wins per key); bad lines are skipped.
        Returns the number of entries merged."""
        entries, _skipped = read_entries(path, strict=False)
        with self._lock:
            if not merge:
                self._entries.clear()
            return sum(1 for e in entries if self._merge_locked(e))

    def _merge_locked(self, entry):
        sig = entry.get("sig")
        if not sig or not isinstance(entry.get("config"), dict):
            return False
        prev = self._entries.get(sig)
        if prev is None:
            self._entries[sig] = entry
            return True
        # a full-shape measurement displaces a proxy one (an inline search
        # measures at batch and heads of 1); within one fidelity the best
        # measured wall wins, ties and unmeasured entries going to the newer
        ep, pp = bool(entry.get("proxy")), bool(prev.get("proxy"))
        if ep != pp:
            if pp:
                self._entries[sig] = entry
                return True
            return False
        pw, ew = prev.get("wall_s"), entry.get("wall_s")
        if ew is not None and (pw is None or ew < pw or
                               (ew == pw and _ts(entry) >= _ts(prev))):
            self._entries[sig] = entry
            return True
        if ew is None and pw is None and _ts(entry) >= _ts(prev):
            self._entries[sig] = entry
            return True
        return False

    def ensure_loaded(self):
        """Merge the configured directory once (again when
        ``MXNET_TPU_TUNE_CACHE`` changes).  Returns True when it merged."""
        d = cache_dir()
        if d == self._loaded_dir:      # the kernel calls' path: no lock
            return False
        with self._lock:
            if d == self._loaded_dir:
                return False
            self._loaded_dir = d
        if d:
            try:
                self.load(d)
            except OSError:
                pass
        return True

    def lookup(self, op, shapes, dtypes, mesh=None, backend=None,
               extra=None):
        """The entry for this key (a copy), or None."""
        sig, _payload = key_sig(op, shapes, dtypes, mesh=mesh,
                                backend=backend, extra=extra)
        with self._lock:
            e = self._entries.get(sig)
            return dict(e) if e else None

    def put(self, op, shapes, dtypes, config, wall_s=None, mesh=None,
            backend=None, extra=None, heuristic_config=None,
            heuristic_wall_s=None, candidates=None, source="search",
            proxy=False, persist=True):
        """Commit one entry (merged as :meth:`load` merges) and, with
        ``persist`` and ``MXNET_TPU_TUNE_CACHE`` set, append it to
        ``<dir>/tunecache-<pid>.jsonl``.  Returns the entry."""
        sig, payload = key_sig(op, shapes, dtypes, mesh=mesh,
                               backend=backend, extra=extra)
        entry = {
            "schema": SCHEMA, "sig": sig,
            "op": payload["op"], "shapes": payload["shapes"],
            "dtypes": payload["dtypes"], "mesh": payload["mesh"],
            "backend": payload["backend"], "extra": payload["extra"],
            "config": dict(config),
            "wall_s": None if wall_s is None else float(wall_s),
            "heuristic_config": dict(heuristic_config)
            if heuristic_config else None,
            "heuristic_wall_s": None if heuristic_wall_s is None
            else float(heuristic_wall_s),
            "candidates": None if candidates is None else int(candidates),
            "proxy": bool(proxy),
            "source": source, "ts": round(time.time(), 6),
        }
        with self._lock:
            self._merge_locked(entry)
        if persist:
            self._persist(entry)
        if self is CACHE:
            _new_generation()
        return entry

    def _persist(self, entry):
        d = cache_dir()
        if not d:
            return None
        path = os.path.join(d, "tunecache-%d.jsonl" % os.getpid())
        try:
            os.makedirs(d, exist_ok=True)
            with open(path, "a") as f:
                f.write(json.dumps(entry, sort_keys=True, default=repr)
                        + "\n")
        except OSError as e:
            logging.getLogger(__name__).warning(
                "tunecache: cannot write %r: %s", path, e)
            return None
        return path

    def entries(self):
        """A copy of every merged entry."""
        with self._lock:
            return [dict(e) for e in self._entries.values()]

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._loaded_dir = None


#: the process-wide cache
CACHE = TuneCache()

# lookup statistics for tools.bench and the tests, apart from the telemetry
# registry (telemetry.reset must not zero them)
_STATS_LOCK = threading.Lock()
_STATS = {"hits": 0, "misses": 0, "searches": 0}
_HIT_LOG = {}          # sig -> {op, shapes, config} (bounded)
_HIT_LOG_CAP = 256

# kernel_config's resolutions of the current generation: key -> config
_RESOLVED = {}
_GENERATION = [0]


def _new_generation():
    with _STATS_LOCK:
        _RESOLVED.clear()
        _GENERATION[0] += 1


def reset_stats():
    """Zero the hit, miss and search counts and the hit log, and start a
    new generation (every key is resolved, and counted, anew)."""
    with _STATS_LOCK:
        _STATS.update(hits=0, misses=0, searches=0)
        _HIT_LOG.clear()
    _new_generation()


def _note_lookup(op, sig, hit, entry, searched=False):
    """Count one resolution: ``hit`` is the cache lookup's outcome,
    ``entry`` what the kernel dispatches with (the cached entry, an inline
    search's winner, or None)."""
    with _STATS_LOCK:
        _STATS["hits" if hit else "misses"] += 1
        if searched:
            _STATS["searches"] += 1
        if entry is not None and sig not in _HIT_LOG \
                and len(_HIT_LOG) < _HIT_LOG_CAP:
            _HIT_LOG[sig] = {"op": str(op), "shapes": entry.get("shapes"),
                             "config": entry.get("config")}
    from ..telemetry import counter, flight
    name = ("mxtpu_tune_cache_hit_total" if hit
            else "mxtpu_tune_cache_miss_total")
    counter(name).labels(op=str(op)).inc()
    flight.record("tune_lookup", op=str(op), sig=sig, hit=hit,
                  searched=bool(searched),
                  config=entry.get("config") if entry is not None else None)


def lookup(op, shapes, dtypes, mesh=None, backend=None, extra=None):
    """The raw lookup on the process cache (no mode gate, no counts): the
    entry or None."""
    if CACHE.ensure_loaded():
        _new_generation()
    return CACHE.lookup(op, shapes, dtypes, mesh=mesh, backend=backend,
                        extra=extra)


def put(*args, **kwargs):
    """Commit to the process cache (:meth:`TuneCache.put`); starts a new
    generation."""
    return CACHE.put(*args, **kwargs)


def reload_cache():
    """Drop the in-memory view, re-merge ``MXNET_TPU_TUNE_CACHE`` and start
    a new generation."""
    CACHE.clear()
    CACHE.ensure_loaded()
    _new_generation()


def resolution_token():
    """``(mode, generation)``: what a caller's own memo of resolved configs
    is valid for (a kernel wrapper keys it by its tensors' shapes, dtype and
    device, and skips the key's construction).  It loads a changed
    ``MXNET_TPU_TUNE_CACHE`` first, which starts a new generation."""
    mode = autotune_mode()
    if mode != "off" and CACHE.ensure_loaded():
        _new_generation()
    return mode, _GENERATION[0]


def _capturing():
    try:
        import torch
        return bool(torch.cuda.is_available()
                    and torch.cuda.is_current_stream_capturing())
    except (RuntimeError, AttributeError):
        return False


def kernel_config(op, shapes, dtypes, mesh=None, extra=None,
                  searchable=True, backend=None):
    """The tuned config for this key, or None (take the built-in choice).
    ``off`` looks nothing up.  Each key is resolved once a generation: the
    first call looks it up, counts the hit or miss and writes a
    ``tune_lookup`` flight event; later calls return the same answer
    uncounted.  In ``search`` mode a miss of a ``searchable`` op runs
    :func:`.search.inline_search` and commits its winner, except while
    the current stream captures a CUDA graph, where the miss stays a plain
    miss (and is resolved again after the capture)."""
    mode = autotune_mode()
    if mode == "off":
        return None
    if CACHE.ensure_loaded():
        _new_generation()
    memo = (op, tuple(tuple(s) for s in shapes), tuple(map(str, dtypes)),
            tuple(sorted((mesh or {}).items())),
            tuple(sorted((extra or {}).items())), backend, mode)
    try:
        return _RESOLVED[memo]
    except KeyError:
        pass
    except TypeError:        # an unhashable extra value: not memoized
        memo = None
    backend = backend or _backend()
    sig, _payload = key_sig(op, shapes, dtypes, mesh=mesh, backend=backend,
                            extra=extra)
    entry = CACHE.lookup(op, shapes, dtypes, mesh=mesh, backend=backend,
                         extra=extra)
    hit = entry is not None
    searched = False
    remember = memo is not None
    if entry is None and mode == "search" and searchable:
        if _capturing():
            remember = False
        else:
            from . import search as _search
            entry = _search.inline_search(op, shapes, dtypes, mesh=mesh,
                                          extra=extra, backend=backend)
            searched = True
    _note_lookup(op, sig, hit, entry, searched=searched)
    cfg = entry.get("config") if entry is not None else None
    cfg = dict(cfg) if isinstance(cfg, dict) else None
    if remember:
        with _STATS_LOCK:
            _RESOLVED[memo] = cfg
    return cfg


def block_config(kind, shapes, dtypes, mesh=None, extra=None, backend=None):
    """The tuned config of a fused-block key (``block:<kind>``), which
    ``analysis.fusion.apply_block`` consults; lookup only."""
    return kernel_config("block:%s" % kind, shapes, dtypes, mesh=mesh,
                         extra=extra, searchable=False, backend=backend)


def summary():
    """The roll-up ``tools.bench`` embeds: mode, cache directory and size,
    hit, miss and search counts, and the distinct tuned keys that hit."""
    if CACHE.ensure_loaded():
        _new_generation()
    with _STATS_LOCK:
        stats = dict(_STATS)
        tuned = [dict(v) for v in _HIT_LOG.values()]
    return {
        "schema": SCHEMA,
        "mode": autotune_mode(),
        "cache": cache_dir(),
        "entries": len(CACHE),
        "hits": stats["hits"],
        "misses": stats["misses"],
        "searches": stats["searches"],
        "tuned": tuned,
    }


# -------------------------------------------------------------- reader

_REQUIRED = ("schema", "sig", "op", "config")


def _validate(entry, where):
    if not isinstance(entry, dict):
        raise ValueError("%s: entry is not an object" % where)
    for f in _REQUIRED:
        if f not in entry:
            raise ValueError("%s: entry missing %r" % (where, f))
    if entry["schema"] != SCHEMA:
        raise ValueError("%s: schema %r != %r"
                         % (where, entry["schema"], SCHEMA))
    if not isinstance(entry["config"], dict):
        raise ValueError("%s: config is not an object" % where)
    return entry


def read_entries(path, strict=False):
    """The entries of a ``tunecache*.jsonl`` file or a directory of them,
    merged best-measured-wall-wins per key, and the count of bad lines
    skipped: ``(entries, skipped)``.  ``strict=True`` raises ValueError at
    the first bad line."""
    if os.path.isdir(path):
        files = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.startswith("tunecache") and f.endswith(".jsonl"))
        if not files and strict:
            raise ValueError("no tunecache*.jsonl files under %r" % path)
    else:
        files = [path]
    merged = TuneCache()
    skipped = 0
    for fp in files:
        try:
            fh = open(fp)
        except OSError as e:
            if strict:
                raise ValueError("cannot read %r: %s" % (fp, e))
            skipped += 1
            continue
        with fh:
            for i, line in enumerate(fh, 1):
                line = line.strip()
                if not line:
                    continue
                where = "%s:%d" % (os.path.basename(fp), i)
                try:
                    entry = _validate(json.loads(line), where)
                except ValueError:
                    if strict:
                        raise
                    skipped += 1
                    continue
                with merged._lock:
                    merged._merge_locked(entry)
    return merged.entries(), skipped
