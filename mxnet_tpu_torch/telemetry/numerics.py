"""Training-health numerics: tensor statistics, NaN/Inf provenance, and a
divergence ledger.

The counterpart of ``mxnet_tpu/telemetry/numerics.py``, watching the
*values*:

* **stats** (:func:`tensor_stats`, :func:`step_stats`) — per named
  param/grad: l2 norm, mean/max absolute value, non-finite count, zero
  fraction and a bit-level value digest, plus the global gradient norm.
  The JAX package computes them inside its jitted step; the port's step
  is eager, so they are torch reductions on the device, computed only on
  sampled steps (every ``MXNET_TPU_NUMERICS_EVERY`` steps, 0 = off, the
  default) and fetched in ONE host transfer (:func:`process_step`) —
  the only sync numerics adds, and only on sampled steps;
* **anomaly rules** (:func:`process_step`) — ``nonfinite``,
  ``grad_spike`` (global grad norm above ``MXNET_TPU_NUMERICS_SPIKE`` x
  its running EWMA) and ``dead_grad`` (a gradient whose zero fraction
  reaches ``MXNET_TPU_NUMERICS_DEAD``): each firing emits a
  ``numerics_anomaly`` flight event and bumps
  ``mxtpu_numerics_anomalies_total{rule}``; under
  ``MXNET_TPU_NUMERICS_STRICT`` the flight ring is dumped and an
  :class:`~mxnet_tpu_torch.base.MXNetError` names the step and tensors;
* **divergence ledger** — one ``mxtpu-numerics/1`` line per sampled step
  in ``MXNET_TPU_NUMERICS_LEDGER``, the JAX package's format, which its
  ``tools/numdiff.py`` compares.

The digest is the wrapping uint32 sum of the float32 bit patterns, the
JAX package's, so equal values give equal digests in both packages.
Fused-block output stats (:func:`block_stats` / :func:`note_block`) keep
the JAX interface; the port's fusion pass does not feed them yet.

Metrics: ``mxtpu_tensor_norm{tensor,kind}``, ``mxtpu_grad_global_norm``,
``mxtpu_nonfinite_total{tensor}``,
``mxtpu_numerics_anomalies_total{rule}``.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import threading

__all__ = [
    "SCHEMA", "every", "enabled", "sampled", "strict", "ledger_path",
    "tensor_stats", "value_digest", "step_stats", "block_stats",
    "note_block", "process_step", "note_monitored", "read_ledger",
    "compare_ledgers", "summary", "reset",
]

#: ledger record schema tag (one JSON object per sampled step)
SCHEMA = "mxtpu-numerics/1"

#: anomaly rule names (the ``rule`` label values)
RULES = ("nonfinite", "grad_spike", "dead_grad")

_log = logging.getLogger(__name__)

_lock = threading.Lock()
# running EWMA of the global grad norm per program (the grad_spike
# baseline) and the process-level roll-up summary() reports
_state = {
    "ewma": {},          # program -> (ewma value, samples folded in)
    "sampled": 0,        # sampled steps processed
    "last_grad_norm": None,
    "last_step": None,
}
_ledger = {"path": None, "fh": None}

# trace-time fused-block stat sink (see block_stats/note_block);
# thread-local: a step runs on its caller's thread
_TLS = threading.local()


# ----------------------------------------------------------- env knobs

def every():
    """Sampling cadence (``MXNET_TPU_NUMERICS_EVERY``): compute the
    in-graph stats every Nth step (step 1 is always sampled when
    enabled); 0 (default) disables numerics entirely."""
    try:
        n = int(os.environ.get("MXNET_TPU_NUMERICS_EVERY", "0"))
    except ValueError:
        return 0
    return max(0, n)


def enabled():
    """True when numerics sampling is on (``every() > 0``)."""
    return every() > 0


def sampled(step):
    """True when 1-based step number ``step`` is a sampled step."""
    n = every()
    return n > 0 and (int(step) - 1) % n == 0


def strict():
    """``MXNET_TPU_NUMERICS_STRICT``: anomalies raise a descriptive
    MXNetError (after dumping the flight ring) instead of warning."""
    return os.environ.get("MXNET_TPU_NUMERICS_STRICT", "0") == "1"


def spike_factor():
    """``MXNET_TPU_NUMERICS_SPIKE``: grad_spike fires when the global
    grad norm exceeds this factor times its running EWMA (default 10);
    ``<= 0`` disables the rule (the repo-wide '0 = off' convention —
    strict runs can keep NaN detection with the spike alarm off)."""
    try:
        f = float(os.environ.get("MXNET_TPU_NUMERICS_SPIKE", "10"))
    except ValueError:
        return 10.0
    return max(f, 0.0)


def dead_threshold():
    """``MXNET_TPU_NUMERICS_DEAD``: dead_grad fires when a gradient's
    zero fraction reaches this value (default 1.0 — only an entirely
    zero gradient); ``<= 0`` disables the rule (the repo-wide '0 =
    off' env convention — a 0 threshold would fire on every grad)."""
    try:
        f = float(os.environ.get("MXNET_TPU_NUMERICS_DEAD", "1.0"))
    except ValueError:
        return 1.0
    return min(f, 1.0)


def ledger_path():
    """Ledger destination (``MXNET_TPU_NUMERICS_LEDGER``), or None when
    the ledger is off.  One file per rank: a multi-process launch must
    assign distinct paths per worker (the same contract as
    ``MXNET_TPU_TELEMETRY_JSONL``)."""
    return os.environ.get("MXNET_TPU_NUMERICS_LEDGER") or None


# ------------------------------------------------------ in-graph stats

def tensor_stats(x, digest=False):
    """The per-tensor stat bundle as 0-d tensors on ``x``'s device (no
    host transfer): ``{"l2", "mean_abs", "max_abs", "nonfinite",
    "zero_frac"}`` (+ ``"digest"``).  l2/mean/max are over the FINITE
    values, ``nonfinite`` counts NaN/Inf entries, ``zero_frac`` is the
    exact-zero fraction, ``digest`` the wrapping uint32 sum of the
    float32 bit patterns."""
    import torch

    xf = torch.as_tensor(x).detach().float()
    if xf.numel() == 0:
        z = torch.zeros((), device=xf.device)
        out = {"l2": z, "mean_abs": z, "max_abs": z,
               "nonfinite": torch.zeros((), dtype=torch.int64,
                                        device=xf.device),
               "zero_frac": z}
        if digest:
            out["digest"] = torch.zeros((), dtype=torch.int64,
                                        device=xf.device)
        return out
    finite = torch.isfinite(xf)
    xz = torch.where(finite, xf, torch.zeros((), device=xf.device))
    ab = xz.abs()
    out = {
        "l2": torch.sqrt(torch.sum(xz * xz)),
        "mean_abs": ab.mean(),
        "max_abs": ab.max(),
        "nonfinite": (~finite).sum(),
        "zero_frac": (xf == 0).float().mean(),
    }
    if digest:
        out["digest"] = value_digest(xf)
    return out


def value_digest(x):
    """Wrapping uint32 sum of the float32 bit patterns of ``x`` (the JAX
    package's digest), as a 0-d int64 tensor in [0, 2**32)."""
    import torch
    xf = torch.as_tensor(x).detach().float().contiguous()
    bits = xf.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return bits.sum() & 0xFFFFFFFF


def step_stats(params, grads, blocks=None, loss=None):
    """The sampled step's stat tree: per-param and per-grad
    :func:`tensor_stats` (+digests), merged fused-block stats
    (``blocks``), the global gradient l2 norm, and the loss — every leaf
    a 0-d tensor on the device."""
    import torch

    tensors = {}
    sq = None
    for name in sorted(params):
        tensors["param/%s" % name] = tensor_stats(params[name],
                                                  digest=True)
    for name in sorted(grads):
        st = tensor_stats(grads[name], digest=True)
        tensors["grad/%s" % name] = st
        sq = st["l2"] * st["l2"] if sq is None else sq + st["l2"] * st["l2"]
    for name, st in sorted((blocks or {}).items()):
        tensors[name] = st
    out = {"tensors": tensors,
           "grad_norm": torch.sqrt(sq) if sq is not None
           else torch.zeros(())}
    if loss is not None:
        out["loss"] = torch.as_tensor(loss).detach().float()
    return out


@contextlib.contextmanager
def block_stats(active=True):
    """Collection window for fused-block output stats (the JAX
    interface); :func:`note_block` feeds it.  Yields the sink dict
    (``None`` when inactive)."""
    if not active:
        yield None
        return
    prev = getattr(_TLS, "blocks", None)
    _TLS.blocks = {}
    try:
        yield _TLS.blocks
    finally:
        _TLS.blocks = prev


def note_block(name, out):
    """Record one fused-block output into the active collection window
    (no-op outside a :func:`block_stats` context).  Never raises."""
    sink = getattr(_TLS, "blocks", None)
    if sink is None:
        return
    try:
        sink["block/%s" % name] = tensor_stats(out)
    except MemoryError:  # pragma: no cover - never mask resource exhaustion
        raise
    except Exception:  # observability must not fail the step
        pass


# ----------------------------------------------------- host-side pump

def _rank():
    from . import distview
    return distview.rank()


def _round(v):
    return round(float(v), 9)


def _flatten(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _host_payload(stats, step, program):
    """Fetch the stats tree in ONE device-to-host transfer (the one sync
    a sampled step adds) and shape it into the ledger record."""
    import torch
    leaves = list(_flatten(stats))
    if leaves:
        vals = torch.stack([torch.as_tensor(v).double().reshape(())
                            .to(leaves[0][1].device)
                            for _k, v in leaves]).cpu().tolist()
    else:
        vals = []
    host = {}
    for (path, _v), val in zip(leaves, vals):
        d = host
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = val
    tensors = {}
    total_digest = 0
    for name, st in sorted((host.get("tensors") or {}).items()):
        rec = {
            "l2": _round(st["l2"]),
            "mean_abs": _round(st["mean_abs"]),
            "max_abs": _round(st["max_abs"]),
            "nonfinite": int(st["nonfinite"]),
            "zero_frac": _round(st["zero_frac"]),
        }
        if "digest" in st:
            rec["digest"] = int(st["digest"])
            total_digest = (total_digest + rec["digest"]) & 0xFFFFFFFF
        tensors[name] = rec
    payload = {
        "schema": SCHEMA,
        "step": int(step),
        "rank": _rank(),
        "program": str(program),
        "grad_norm": _round(host["grad_norm"])
        if "grad_norm" in host else None,
        "digest": total_digest,
        "tensors": tensors,
    }
    if "loss" in host:
        payload["loss"] = _round(host["loss"])
    return payload


def _publish_gauges(payload):
    from .registry import counter, gauge
    norm_g = gauge("mxtpu_tensor_norm")
    for name, st in payload["tensors"].items():
        kind = name.split("/", 1)[0]
        norm_g.labels(tensor=name.split("/", 1)[-1],
                      kind=kind).set(st["l2"])
        if st.get("nonfinite"):
            counter("mxtpu_nonfinite_total").labels(
                tensor=name).inc(st["nonfinite"])
    if payload.get("grad_norm") is not None:
        gauge("mxtpu_grad_global_norm").set(payload["grad_norm"])


def _check_rules(payload, scope=None):
    """Evaluate the anomaly rules against one payload; returns the list
    of fired anomalies (dicts with at least ``rule``).  ``scope`` keys
    the grad_spike EWMA baseline (defaults to the program name —
    callers owning multiple step streams pass a per-instance token so
    one model's baseline cannot false-trip another's)."""
    import math
    anomalies = []
    bad = [n for n, st in sorted(payload["tensors"].items())
           if st.get("nonfinite")]
    gn = payload.get("grad_norm")
    if gn is not None and not math.isfinite(gn):
        if "grad_norm" not in bad:
            bad.append("grad_norm")
    if bad:
        anomalies.append({
            "rule": "nonfinite", "tensors": bad[:16],
            "total": sum(payload["tensors"].get(n, {}).get("nonfinite", 0)
                         for n in bad)})
    factor = spike_factor()
    if gn is not None and math.isfinite(gn) and factor > 0:
        key = scope if scope is not None else payload["program"]
        with _lock:
            ew = _state["ewma"].get(key)
            if ew is not None and ew[0] > 0 and gn > factor * ew[0]:
                anomalies.append({"rule": "grad_spike", "grad_norm": gn,
                                  "ewma": _round(ew[0]),
                                  "factor": factor})
                # the baseline is NOT updated with the spike: repeated
                # explosions keep firing instead of normalizing the alarm
            elif ew is None:
                _state["ewma"][key] = (gn, 1)
            else:
                _state["ewma"][key] = (0.9 * ew[0] + 0.1 * gn,
                                       ew[1] + 1)
    thresh = dead_threshold()
    dead = [] if thresh <= 0 else \
        [n for n, st in sorted(payload["tensors"].items())
         if n.startswith("grad/") and st.get("nonfinite", 0) == 0
         and st.get("zero_frac", 0.0) >= thresh]
    if dead:
        anomalies.append({"rule": "dead_grad", "tensors": dead[:16],
                          "threshold": thresh})
    return anomalies


def json_safe(obj):
    """Recursively map non-finite floats to None so a payload always
    serializes as STRICT JSON (`json.dumps(allow_nan=True)` would emit
    a bare ``NaN`` token jq and non-Python consumers reject — the
    ledger contract is one valid JSON object per line)."""
    import math
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    return obj


def _ledger_handle():
    path = ledger_path()
    if path != _ledger["path"]:
        if _ledger["fh"] is not None:
            try:
                _ledger["fh"].close()
            except OSError:
                pass
        fh = None
        if path:
            try:
                fh = open(path, "a")
            except OSError as e:
                _log.warning(
                    "MXNET_TPU_NUMERICS_LEDGER=%r cannot be opened "
                    "(%s); ledger disabled for this run", path, e)
        _ledger["fh"] = fh
        _ledger["path"] = path
    return _ledger["fh"]


def _write_ledger(payload):
    with _lock:
        fh = _ledger_handle()
        if fh is None:
            return False
        try:
            fh.write(json.dumps(json_safe(payload), sort_keys=True,
                                allow_nan=False) + "\n")
            fh.flush()
        except (OSError, ValueError):
            return False
        return True


def _raise_strict(payload, anomalies, provenance):
    """Dump the flight ring, then raise the descriptive error.  The
    exception is tagged so outer ``flight.crash_guard`` levels pass it
    through instead of dumping a second black box."""
    from ..base import MXNetError
    from . import flight
    rules = [a["rule"] for a in anomalies]
    names = sorted({n for a in anomalies for n in a.get("tensors", ())})
    dump_path = flight.dump("numerics")
    msg = ("numerics anomaly at step %d (%s): rule(s) %s fired on %s"
           % (payload["step"], payload["program"], "/".join(rules),
              names[:8] or ["<global>"]))
    if payload.get("grad_norm") is not None:
        msg += "; global grad norm %g" % payload["grad_norm"]
    if provenance:
        msg += ("; first non-finite producing node: %r (%s non-finite "
                "value(s) in the eager replay)"
                % (provenance.get("node"),
                   provenance.get("nonfinite", "?")))
    if dump_path:
        msg += "; flight dump: %s" % dump_path
    msg += (" — MXNET_TPU_NUMERICS_STRICT=1 stops the run on the first "
            "anomaly")
    err = MXNetError(msg)
    err._mxtpu_flight_dumped = True
    raise err


def process_step(stats, step, program="trainer.step",
                 provenance_fn=None, scope=None):
    """Publish one sampled step's stat tree: fetch it (one sync),
    update the gauges/counters, append the ledger record, and run the
    anomaly rules.  ``provenance_fn``: zero-arg callable invoked only
    when non-finite values were detected; it should replay the step
    eagerly and return ``{"node": name, "nonfinite": count}`` for the
    first producing node (or None).  ``scope``: per-caller token keying
    the grad_spike EWMA (the trainer passes an instance-unique one so
    two models in one process keep separate baselines).  Returns the
    ledger payload (with ``"anomalies"`` attached when any rule
    fired); raises MXNetError in strict mode after dumping the flight
    ring."""
    try:
        payload = _host_payload(stats, step, program)
    except MemoryError:  # pragma: no cover - never mask resource exhaustion
        raise
    except Exception as e:  # observability must not kill the step it observes
        _log.warning("numerics: cannot fetch step stats: %s", e)
        return None
    with _lock:
        _state["sampled"] += 1
        _state["last_grad_norm"] = payload.get("grad_norm")
        _state["last_step"] = payload["step"]
    _publish_gauges(payload)
    anomalies = _check_rules(payload, scope=scope)
    _write_ledger(payload)
    if not anomalies:
        return payload
    payload["anomalies"] = anomalies
    provenance = None
    if provenance_fn is not None and \
            any(a["rule"] == "nonfinite" for a in anomalies):
        try:
            provenance = provenance_fn()
        except MemoryError:  # pragma: no cover - never mask resource exhaustion
            raise
        except Exception as e:  # forensics must not mask the anomaly
            _log.warning("numerics: provenance replay failed: %s", e)
    if provenance:
        payload["provenance"] = provenance
    from .registry import counter
    from . import flight
    anom_counter = counter("mxtpu_numerics_anomalies_total")
    for a in anomalies:
        anom_counter.labels(rule=a["rule"]).inc()
        ev = {"rule": a["rule"], "step": payload["step"],
              "program": payload["program"]}
        if a.get("tensors"):
            ev["tensors"] = a["tensors"]
        if payload.get("grad_norm") is not None:
            ev["grad_norm"] = payload["grad_norm"]
        if a["rule"] == "grad_spike":
            ev["ewma"] = a.get("ewma")
        if provenance and a["rule"] == "nonfinite":
            ev["provenance"] = provenance
        flight.record("numerics_anomaly", **ev)
    if strict():
        _raise_strict(payload, anomalies, provenance)
    _log.warning(
        "numerics anomaly at step %d (%s): %s (MXNET_TPU_NUMERICS_"
        "STRICT=1 would stop the run)", payload["step"],
        payload["program"],
        "; ".join("%s on %s" % (a["rule"], a.get("tensors", ["<global>"]))
                  for a in anomalies))
    return payload


def note_monitored(stats_by_name, program="executor.forward",
                   step=None):
    """Anomaly pass over a monitored forward's per-node stat
    bundles (``{node name: tensor_stats dict of host scalars}``): count
    non-finite values per node, and — since per-node stats ARE the
    provenance — name the first non-finite producing node directly in
    the ``numerics_anomaly`` event.  Strict mode raises like
    :func:`process_step`."""
    from .registry import counter, gauge
    from . import flight
    bad = []
    norm_g = gauge("mxtpu_tensor_norm")
    for name in sorted(stats_by_name):
        st = stats_by_name[name]
        if st.get("l2") is not None:
            norm_g.labels(tensor=name, kind="node").set(st["l2"])
        n = int(st.get("nonfinite", 0))
        if n:
            counter("mxtpu_nonfinite_total").labels(
                tensor="node/%s" % name).inc(n)
            bad.append((name, n))
    if not bad:
        return None
    first = {"node": bad[0][0], "nonfinite": bad[0][1]}
    counter("mxtpu_numerics_anomalies_total").labels(
        rule="nonfinite").inc()
    ev = {"rule": "nonfinite", "program": program,
          "tensors": [n for n, _c in bad[:16]], "provenance": first}
    if step is not None:
        ev["step"] = int(step)
    flight.record("numerics_anomaly", **ev)
    if strict():
        payload = {"step": int(step or 0), "program": program,
                   "grad_norm": None}
        _raise_strict(payload,
                      [{"rule": "nonfinite",
                        "tensors": [n for n, _c in bad[:16]]}], first)
    return first


# ------------------------------------------------------- ledger reader

def read_ledger(path):
    """Parse a numerics ledger: returns the list of ``mxtpu-numerics/1``
    records (ascending step order preserved).  Accepts a pure ledger
    file or a telemetry JSONL stream carrying ledger records inline
    (a ``"numerics"`` sub-object per step record).  Raises ValueError
    when the file is unreadable or contains no record with the
    schema — a wrong-schema file must be rejected, not silently
    compared as empty."""
    try:
        with open(path) as f:
            raw = f.read()
    except OSError as e:
        raise ValueError("cannot read numerics ledger %r: %s"
                         % (path, e))
    records = []
    saw_line = False
    for line in raw.split("\n"):
        line = line.strip()
        if not line:
            continue
        saw_line = True
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if not isinstance(rec, dict):
            continue
        if rec.get("schema") == SCHEMA:
            records.append(rec)
        elif isinstance(rec.get("numerics"), dict) and \
                rec["numerics"].get("schema") == SCHEMA:
            records.append(rec["numerics"])
    if not records:
        raise ValueError(
            "%r is not an %s ledger (%s)"
            % (path, SCHEMA,
               "no parseable lines" if not saw_line
               else "no record carries the schema"))
    for rec in records:
        if not isinstance(rec.get("step"), int) or \
                not isinstance(rec.get("tensors"), dict):
            raise ValueError(
                "numerics ledger %r: malformed record (needs an int "
                "'step' and a 'tensors' object): %r"
                % (path, {k: rec.get(k) for k in ("step", "tensors")}))
    return records


def compare_ledgers(recs_a, recs_b, rtol=1e-4, atol=1e-9):
    """Compare two ledgers (record lists from :func:`read_ledger`).

    Walks the common steps in ascending order; per step, the common
    tensor names (tensors present in only one ledger — e.g. ``block/*``
    entries a fused run adds — are counted, not compared).  Returns a
    dict::

        {"steps_compared", "tensors_compared", "only_a", "only_b",
         "bit_clean": bool,
         "first_bit_divergence": {"step", "tensor"} | None,
         "divergence": {"step", "tensor", "stat", "a", "b",
                        "rel"} | None}

    ``divergence`` is the first (step, tensor) whose l2/mean_abs/
    grad_norm differs beyond ``rtol`` (relative, floored by ``atol``)
    — the bisection answer; ``first_bit_divergence`` is the first
    digest mismatch even when within tolerance (fused-vs-unfused runs
    are rarely bit-identical but must stay within rtol)."""
    a_by = {r["step"]: r for r in recs_a}
    b_by = {r["step"]: r for r in recs_b}
    common = sorted(set(a_by) & set(b_by))
    out = {"steps_compared": len(common), "tensors_compared": 0,
           "only_a": 0, "only_b": 0, "bit_clean": True,
           "first_bit_divergence": None, "divergence": None}

    def rel(x, y):
        d = abs(x - y)
        m = max(abs(x), abs(y), atol)
        return d / m

    for step in common:
        ra, rb = a_by[step], b_by[step]
        ta, tb = ra["tensors"], rb["tensors"]
        names = sorted(set(ta) & set(tb))
        out["only_a"] += len(set(ta) - set(tb))
        out["only_b"] += len(set(tb) - set(ta))
        for name in names:
            out["tensors_compared"] += 1
            sa, sb = ta[name], tb[name]
            da, db = sa.get("digest"), sb.get("digest")
            if da is not None and db is not None and da != db \
                    and out["bit_clean"]:
                out["bit_clean"] = False
                out["first_bit_divergence"] = {"step": step,
                                               "tensor": name}
            # non-finite counts compare EXACTLY, never under rtol: the
            # l2/mean stats are finite-masked, so NaNs appearing in one
            # run and not the other — the worst drift a lowering can
            # have — would otherwise be invisible within tolerance
            na, nb = sa.get("nonfinite"), sb.get("nonfinite")
            if isinstance(na, int) and isinstance(nb, int) \
                    and na != nb and out["divergence"] is None:
                out["divergence"] = {"step": step, "tensor": name,
                                     "stat": "nonfinite", "a": na,
                                     "b": nb,
                                     "rel": round(rel(na, nb), 6)}
            for stat in ("l2", "mean_abs", "max_abs"):
                va, vb = sa.get(stat), sb.get(stat)
                if not isinstance(va, (int, float)) or \
                        not isinstance(vb, (int, float)):
                    continue
                r = rel(va, vb)
                if r > rtol and out["divergence"] is None:
                    out["divergence"] = {"step": step, "tensor": name,
                                         "stat": stat, "a": va, "b": vb,
                                         "rel": round(r, 6)}
            # zero_frac compares ABSOLUTELY (it lives in [0,1]): a
            # relative test would flag a legitimate borderline element
            # flipping zero/nonzero between lowerings (0 vs 1/N is
            # rel=1), while a flush-to-zero corruption still jumps it
            za, zb = sa.get("zero_frac"), sb.get("zero_frac")
            if isinstance(za, (int, float)) and \
                    isinstance(zb, (int, float)) \
                    and abs(za - zb) > rtol \
                    and out["divergence"] is None:
                out["divergence"] = {"step": step, "tensor": name,
                                     "stat": "zero_frac", "a": za,
                                     "b": zb,
                                     "rel": round(abs(za - zb), 6)}
        # the global grad norm is checked AFTER the named tensors so a
        # localizable divergence is reported by name, not by the
        # aggregate that merely reflects it
        gna, gnb = ra.get("grad_norm"), rb.get("grad_norm")
        if isinstance(gna, (int, float)) and \
                isinstance(gnb, (int, float)):
            r = rel(gna, gnb)
            if r > rtol and out["divergence"] is None:
                out["divergence"] = {"step": step, "tensor": "grad_norm",
                                     "stat": "grad_norm", "a": gna,
                                     "b": gnb, "rel": round(r, 6)}
        if out["divergence"] is not None:
            break
    return out


# ------------------------------------------------------------ roll-up

def summary():
    """Process-level numerics roll-up for ``tools.bench``: the sampling cadence, sampled-step and
    per-rule anomaly counts, and the last observed global grad norm."""
    from .registry import counter
    anom = {}
    m = counter("mxtpu_numerics_anomalies_total")
    for key, val in m.samples().items():
        anom[dict(key).get("rule", "?")] = int(val)
    with _lock:
        return {
            "every": every(),
            "strict": strict(),
            "sampled_steps": _state["sampled"],
            "anomalies": anom,
            "last_step": _state["last_step"],
            "last_grad_norm": json_safe(_state["last_grad_norm"]),
            "ledger": ledger_path(),
        }


def reset():
    """Clear the EWMA baselines, the roll-up counters, and the ledger
    handle (the env var is re-read on the next sampled step).
    ``telemetry.reset()`` calls this."""
    with _lock:
        _state["ewma"].clear()
        _state["sampled"] = 0
        _state["last_grad_norm"] = None
        _state["last_step"] = None
        if _ledger["fh"] is not None:
            try:
                _ledger["fh"].close()
            except OSError:
                pass
        _ledger["fh"] = None
        _ledger["path"] = None
