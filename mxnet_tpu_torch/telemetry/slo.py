"""healthd: declarative SLOs, burn-rate alerting, and the health verdict.

The counterpart of ``mxnet_tpu/telemetry/slo.py``, the same code, so the
two packages judge the same readings alike and write the same
``mxtpu-health/1`` documents, alert flight events and ``mxtpu_alert_*``
metrics (the JAX ``tools/health_top.py`` reads either):

* **rule types** — ``threshold`` (a gauge/counter-rate/ratio/rolling-
  regression reading vs a bound), ``burn_rate`` (error-budget
  consumption over a FAST and a SLOW window; the alert fires only when
  both burn above the factor: quick on a real storm, quiet on a blip),
  ``absence`` (a heartbeat counter that stopped advancing, armed only
  after it first moves) and ``anomaly_passthrough`` (the numerics /
  io-bottleneck verdict counters as alerts);
* **rule catalog** — :data:`RULES`, validated by :func:`selfcheck_rules`
  against ``telemetry.CATALOG``; ``MXNET_TPU_SLO_RULES`` overrides
  parameters, disables rules, or loads a JSON rule file;
* **alert state machine** — inactive → pending → firing → resolved, with
  ``for_s`` debounce on the way up and ``resolve_for_s`` anti-flap on
  the way down.  Transitions emit ``alert`` flight events and
  ``mxtpu_alert_*`` metrics and feed :meth:`SloEngine.health`
  (healthy/degraded/critical);
* **evaluation** — the serving ``Server`` arms a background ticker
  thread; training loops ride ``telemetry.step_end`` (one clock read a
  step, a full evaluation at most every ``MXNET_TPU_SLO_TICK_S``).
  :class:`FleetHealth` evaluates the ``scope="fleet"`` rules over
  ``mxtpu-run/1`` step records as pure logic; nothing in the port feeds
  it a live fleet yet (multi-GPU supervision, ROADMAP Queue A item 6).

Module-level imports are stdlib-only and in-package imports are deferred
into the engine methods, as in the JAX module.

The health verdict document schema is ``mxtpu-health/1``::

    {
      "schema": "mxtpu-health/1",
      "ts": <unix seconds>, "rank": <MXNET_TPU_PROCESS_ID>,
      "status": "healthy" | "degraded" | "critical",
      "firing":   [{"rule", "severity", "since_s", "value", "summary"}],
      "pending":  [... same shape ...],
      "resolved": [{"rule", "severity", "ago_s"}],   # recently cleared
      "rules": <number of enabled rank-scope rules>
    }
"""
from __future__ import annotations

import copy
import json
import logging
import os
import threading
import time

__all__ = [
    "HEALTH_SCHEMA", "RULES", "TYPES", "SEVERITIES",
    "selfcheck_rules", "load_rules",
    "SloEngine", "FleetHealth",
    "engine", "on_step", "start_ticker", "stop_ticker", "reset",
    "enabled", "tick_seconds", "fast_seconds", "slow_seconds",
    "latency_threshold_s", "health",
]

log = logging.getLogger(__name__)

#: the health verdict / health_top --json document schema tag
HEALTH_SCHEMA = "mxtpu-health/1"

TYPES = ("threshold", "burn_rate", "absence", "anomaly_passthrough")
SEVERITIES = ("warn", "critical")

#: alert states, in escalation order (gauge value = index)
STATES = ("inactive", "pending", "firing")


# ------------------------------------------------------------- env knobs

def enabled():
    """SLO evaluation switch (``MXNET_TPU_SLO``, default on)."""
    return os.environ.get("MXNET_TPU_SLO", "1").strip().lower() \
        not in ("0", "false", "off", "no")


def tick_seconds():
    """Minimum interval between evaluations (``MXNET_TPU_SLO_TICK_S``,
    default 1.0; floor 0.05 — the ticker must never busy-spin)."""
    try:
        return max(0.05, float(os.environ.get("MXNET_TPU_SLO_TICK_S",
                                              "1.0")))
    except ValueError:
        return 1.0


def fast_seconds():
    """Default FAST burn-rate window (``MXNET_TPU_SLO_FAST_S``,
    default 60)."""
    try:
        return max(1.0, float(os.environ.get("MXNET_TPU_SLO_FAST_S",
                                             "60")))
    except ValueError:
        return 60.0


def slow_seconds():
    """Default SLOW burn-rate window (``MXNET_TPU_SLO_SLOW_S``,
    default 300)."""
    try:
        return max(1.0, float(os.environ.get("MXNET_TPU_SLO_SLOW_S",
                                             "300")))
    except ValueError:
        return 300.0


def latency_threshold_s():
    """Serving latency SLO target (``MXNET_TPU_SLO_LATENCY_MS``,
    default 250 ms), in seconds."""
    try:
        ms = float(os.environ.get("MXNET_TPU_SLO_LATENCY_MS", "250"))
    except ValueError:
        ms = 250.0
    return max(0.0001, ms / 1e3)


# ----------------------------------------------------------- rule catalog
# Every rule the framework evaluates, the JAX package's table entry for
# entry (summaries included): selfcheck_rules() validates it and
# MXNET_TPU_SLO_RULES overrides parameters per deployment.
#
# Common fields: name, type, severity (warn|critical), scope
# (rank|fleet), summary, for_s (debounce before pending -> firing),
# resolve_for_s (condition-false hold before firing -> resolved).
# Window fields left at None inherit MXNET_TPU_SLO_FAST_S/_SLOW_S at
# load time.

RULES = [
    # ------------------------------------------------- serving tier SLOs
    dict(name="serve_p99_latency_burn", type="burn_rate",
         severity="critical", scope="rank",
         summary="serving latency error budget burning (requests over "
                 "the MXNET_TPU_SLO_LATENCY_MS target)",
         kind="latency", metric="mxtpu_serve_request_seconds",
         labels={"segment": "total"}, threshold_s=None,
         objective=0.99, factor=2.0, fast_s=None, slow_s=None,
         for_s=0.0, resolve_for_s=60.0),
    dict(name="serve_shed_burn", type="burn_rate", severity="critical",
         scope="rank",
         summary="serving shed-rate error budget burning (requests "
                 "refused by the load shedder)",
         kind="ratio",
         bad_metric="mxtpu_serve_requests_total",
         bad_labels={"outcome": "shed"},
         total_metric="mxtpu_serve_requests_total", total_labels=None,
         objective=0.99, factor=2.0, fast_s=None, slow_s=None,
         for_s=0.0, resolve_for_s=60.0),
    dict(name="serve_error_rate", type="threshold", severity="warn",
         scope="rank", mode="share",
         summary="serving dispatch error share over the fast window",
         metric="mxtpu_serve_requests_total",
         labels={"outcome": "error"},
         denom_metric="mxtpu_serve_requests_total", denom_labels=None,
         op=">", bound=0.05, window_s=None,
         for_s=0.0, resolve_for_s=30.0),
    dict(name="serve_queue_depth", type="threshold", severity="warn",
         scope="rank", mode="value",
         summary="batcher queue near capacity (Server arms the bound "
                 "at 0.9x its queue depth)",
         metric="mxtpu_serve_queue_depth", labels=None,
         op=">", bound=1e18, window_s=None,
         for_s=5.0, resolve_for_s=10.0),
    dict(name="serve_heartbeat", type="absence", severity="warn",
         scope="rank",
         summary="no rung dispatched for hold_s despite earlier "
                 "traffic (scheduler stalled or traffic stopped)",
         metric="mxtpu_serve_rung_dispatch_total", labels=None,
         hold_s=300.0, for_s=0.0, resolve_for_s=0.0),
    # ---------------------------------------------- training-run SLOs
    dict(name="train_step_time_regression", type="threshold",
         severity="warn", scope="rank", mode="regression",
         summary="fast-window mean step time regressed vs the rolling "
                 "slow-window baseline",
         metric="mxtpu_step_seconds", labels=None,
         op=">", bound=1.5, fast_s=None, slow_s=None, min_count=3,
         for_s=0.0, resolve_for_s=30.0),
    dict(name="train_collective_wait_share", type="threshold",
         severity="warn", scope="rank", mode="share",
         summary="collective wait dominates step time (a straggler "
                 "peer is stalling this rank)",
         metric="mxtpu_step_segment_seconds",
         labels={"segment": "collective_wait"},
         denom_metric="mxtpu_step_seconds", denom_labels=None,
         op=">", bound=0.5, window_s=None,
         for_s=0.0, resolve_for_s=30.0),
    dict(name="train_input_starved_share", type="threshold",
         severity="warn", scope="rank", mode="share",
         summary="input wait dominates step time (the data plane, not "
                 "compute, bounds throughput)",
         metric="mxtpu_step_segment_seconds",
         labels={"segment": "input_wait"},
         denom_metric="mxtpu_step_seconds", denom_labels=None,
         op=">", bound=0.5, window_s=None,
         for_s=0.0, resolve_for_s=30.0),
    dict(name="train_heartbeat", type="absence", severity="critical",
         scope="rank",
         summary="no training step completed for hold_s despite "
                 "earlier progress (hung collective or dead loop)",
         metric="mxtpu_step_total", labels=None,
         hold_s=120.0, for_s=0.0, resolve_for_s=0.0),
    # -------------------------------------- verdict passthrough alerts
    dict(name="numerics_anomaly", type="anomaly_passthrough",
         severity="critical", scope="rank",
         summary="training-health numerics rule fired (nonfinite / "
                 "grad_spike / dead_grad — see the numerics_anomaly "
                 "flight events)",
         metric="mxtpu_numerics_anomalies_total", labels=None,
         exclude=None, window_s=None, for_s=0.0, resolve_for_s=120.0),
    dict(name="io_bottleneck", type="anomaly_passthrough",
         severity="warn", scope="rank",
         summary="ioview classified the input pipeline producer-bound "
                 "(a pipeline stage, not the device, bounds "
                 "throughput)",
         metric="mxtpu_io_bottleneck_total", labels=None,
         exclude={"stage": ("balanced", "consumer")},
         window_s=None, for_s=0.0, resolve_for_s=60.0),
    # ------------------------------------------------- fleet-scope SLOs
    # Evaluated by FleetHealth over mxtpu-run/1 step records (a
    # supervisor), NOT by the per-rank engine.  `field` names
    # a step-record key ("ranks.<k>" fans out per rank); `quorum` is
    # "any" | "all" | a fraction of reporting values that must breach.
    dict(name="fleet_skew", type="threshold", severity="warn",
         scope="fleet", field="skew_s", op=">", bound=1.0,
         quorum="any",
         summary="cross-rank step skew above bound (a straggler is "
                 "stalling every collective)",
         for_s=0.0, resolve_for_s=30.0),
    dict(name="fleet_digest_mismatch", type="threshold",
         severity="critical", scope="fleet", field="digest_mismatch",
         op=">", bound=0.5, quorum="any",
         summary="ranks disagree on the sampled state digest (numeric "
                 "divergence — bisect with tools/numdiff.py)",
         for_s=0.0, resolve_for_s=60.0),
    dict(name="fleet_rank_missing", type="threshold",
         severity="critical", scope="fleet", field="n_ranks",
         op="<", bound=-1, quorum="any",
         summary="a step completed without every rank reporting "
                 "(launch.py arms the bound at the fleet size)",
         for_s=0.0, resolve_for_s=30.0),
]


def selfcheck_rules(rules=None):
    """Validate a rule table (default :data:`RULES`); returns a list of
    problem strings (empty = clean).  Checked: unique slug names, known
    types/severities/scopes, per-type required params, referenced
    metrics declared in ``telemetry.CATALOG``, sane numeric ranges
    (burn objective in (0, 1), positive windows)."""
    import re
    problems = []
    rules = RULES if rules is None else rules
    name_re = re.compile(r"^[a-z][a-z0-9_]*$")
    try:
        from .catalog import CATALOG
    except ImportError:          # loaded by path in a supervisor
        CATALOG = None
    seen = set()
    for r in rules:
        name = r.get("name")
        if not isinstance(name, str) or not name_re.match(name or ""):
            problems.append("rule %r: illegal name" % (name,))
            continue
        if name in seen:
            problems.append("rule %r: duplicate name" % name)
        seen.add(name)
        rtype = r.get("type")
        if rtype not in TYPES:
            problems.append("rule %r: unknown type %r" % (name, rtype))
            continue
        if r.get("severity") not in SEVERITIES:
            problems.append("rule %r: severity must be one of %s"
                            % (name, list(SEVERITIES)))
        if r.get("scope", "rank") not in ("rank", "fleet"):
            problems.append("rule %r: scope must be rank|fleet" % name)
        if not r.get("summary"):
            problems.append("rule %r: empty summary" % name)
        for k in ("for_s", "resolve_for_s"):
            if not isinstance(r.get(k), (int, float)) or r[k] < 0:
                problems.append("rule %r: %s must be a number >= 0"
                                % (name, k))
        if r.get("scope") == "fleet":
            if rtype != "threshold":
                problems.append("rule %r: fleet rules are thresholds "
                                "over step-record fields" % name)
            if not isinstance(r.get("field"), str):
                problems.append("rule %r: fleet rule needs a 'field'"
                                % name)
            q = r.get("quorum")
            if q not in ("any", "all") and \
                    not (isinstance(q, (int, float)) and 0 < q <= 1):
                problems.append("rule %r: quorum must be any|all|"
                                "fraction" % name)
            if r.get("op") not in (">", "<"):
                problems.append("rule %r: op must be > or <" % name)
            continue
        # rank-scope rules reference catalog metrics
        metrics = []
        if rtype == "burn_rate":
            if r.get("kind") == "latency":
                metrics = [r.get("metric")]
            elif r.get("kind") == "ratio":
                metrics = [r.get("bad_metric"), r.get("total_metric")]
            else:
                problems.append("rule %r: burn_rate kind must be "
                                "latency|ratio" % name)
            obj = r.get("objective")
            if not (isinstance(obj, (int, float)) and 0 < obj < 1):
                problems.append("rule %r: objective must be in (0, 1)"
                                % name)
            if not (isinstance(r.get("factor"), (int, float))
                    and r["factor"] > 0):
                problems.append("rule %r: factor must be > 0" % name)
        elif rtype == "threshold":
            metrics = [r.get("metric")]
            if r.get("mode") not in ("value", "rate", "share",
                                     "regression"):
                problems.append("rule %r: threshold mode must be "
                                "value|rate|share|regression" % name)
            if r.get("mode") == "share":
                metrics.append(r.get("denom_metric"))
            if r.get("op") not in (">", "<"):
                problems.append("rule %r: op must be > or <" % name)
            if not isinstance(r.get("bound"), (int, float)):
                problems.append("rule %r: bound must be a number"
                                % name)
        elif rtype == "absence":
            metrics = [r.get("metric")]
            if not (isinstance(r.get("hold_s"), (int, float))
                    and r["hold_s"] > 0):
                problems.append("rule %r: hold_s must be > 0" % name)
        elif rtype == "anomaly_passthrough":
            metrics = [r.get("metric")]
        for m in metrics:
            if not isinstance(m, str):
                problems.append("rule %r: missing metric reference"
                                % name)
            elif CATALOG is not None and m not in CATALOG:
                problems.append("rule %r: metric %r is not declared in "
                                "telemetry.CATALOG" % (name, m))
    return problems


# --------------------------------------------------------- rule loading

def _parse_value(tok):
    try:
        return json.loads(tok)
    except ValueError:
        return tok


def load_rules(spec=None):
    """The effective rule table: :data:`RULES` (deep-copied, window
    defaults filled from the env) with ``MXNET_TPU_SLO_RULES``
    overrides applied.  Three override grammars:

    * ``@/path/rules.json`` — a JSON list of rule objects, merged by
      ``name`` into the defaults (a full new rule is appended;
      ``{"name": x, "disable": true}`` removes one);
    * inline JSON (``[...]``) — same semantics;
    * compact ``rule.param=value;rule2.disable=1`` — parameter
      overrides only (values parse as JSON scalars, bare words as
      strings).

    A malformed spec logs ONE warning and falls back to the defaults —
    the judge must never take down the process it judges.  The merged
    table is selfchecked; offending overrides are dropped."""
    rules = copy.deepcopy(RULES)
    by_name = {r["name"]: r for r in rules}
    if spec is None:
        spec = os.environ.get("MXNET_TPU_SLO_RULES", "")
    spec = (spec or "").strip()
    try:
        if spec.startswith("@"):
            with open(spec[1:]) as f:
                overrides = json.load(f)
            rules = _merge_rules(rules, by_name, overrides)
        elif spec.startswith("[") or spec.startswith("{"):
            overrides = json.loads(spec)
            if isinstance(overrides, dict):
                overrides = overrides.get("rules", [])
            rules = _merge_rules(rules, by_name, overrides)
        elif spec:
            for entry in spec.split(";"):
                entry = entry.strip()
                if not entry:
                    continue
                lhs, _, rhs = entry.partition("=")
                rname, _, param = lhs.strip().partition(".")
                if not param or rname not in by_name:
                    raise ValueError("bad override %r (want "
                                     "rule.param=value)" % entry)
                if param == "disable":
                    if _parse_value(rhs.strip()) in (1, True, "1",
                                                     "true"):
                        by_name[rname]["disable"] = True
                else:
                    by_name[rname][param] = _parse_value(rhs.strip())
            rules = [r for r in rules if not r.get("disable")]
    except (OSError, ValueError) as e:
        log.warning("MXNET_TPU_SLO_RULES %r unusable (%s); using the "
                    "default rule catalog", spec, e)
        rules = copy.deepcopy(RULES)
    rules = _fill_defaults(rules)
    problems = selfcheck_rules(rules)
    if problems:
        bad = {p.split("'")[1] for p in problems if "'" in p}
        log.warning("slo: dropping %d invalid rule(s) after overrides: "
                    "%s", len(bad), "; ".join(sorted(problems)[:4]))
        rules = [r for r in rules if r.get("name") not in bad]
    return rules


def _merge_rules(rules, by_name, overrides):
    if not isinstance(overrides, list):
        raise ValueError("rule override document must be a JSON list")
    for ov in overrides:
        if not isinstance(ov, dict) or not ov.get("name"):
            raise ValueError("each rule override needs a 'name'")
        cur = by_name.get(ov["name"])
        if cur is None:
            rules.append(dict(ov))
            by_name[ov["name"]] = rules[-1]
        else:
            cur.update(ov)
    return [r for r in rules if not r.get("disable")]


def _fill_defaults(rules):
    fast, slow = fast_seconds(), slow_seconds()
    for r in rules:
        if r.get("fast_s") is None and "fast_s" in r:
            r["fast_s"] = fast
        if r.get("slow_s") is None and "slow_s" in r:
            r["slow_s"] = slow
        if r.get("window_s") is None and "window_s" in r:
            r["window_s"] = fast
        if r.get("threshold_s") is None and "threshold_s" in r:
            r["threshold_s"] = latency_threshold_s()
    return rules


# ------------------------------------------------------ alert machinery

class Alert:
    """One rule's alert state.  The transition logic lives in
    :meth:`advance` and is shared by the per-rank engine and the fleet
    evaluator; only the *emission* of transitions differs."""

    __slots__ = ("name", "severity", "state", "since", "last_true",
                 "fired_ts", "resolved_ts", "value", "info")

    def __init__(self, name, severity):
        self.name = name
        self.severity = severity
        self.state = "inactive"
        self.since = None         # entered current state at
        self.last_true = None     # condition last observed true at
        self.fired_ts = None
        self.resolved_ts = None
        self.value = None         # last headline reading (display)
        self.info = {}            # last evaluation detail

    def advance(self, cond, now, for_s, resolve_for_s):
        """Feed one evaluation; returns the transition names emitted
        this tick (subset of ``pending``/``firing``/``cleared``/
        ``resolved``).  ``cond=None`` (unknown — e.g. no traffic yet)
        freezes the state."""
        out = []
        if cond is None:
            return out
        if cond:
            self.last_true = now
            if self.state == "inactive":
                self.state = "pending"
                self.since = now
                out.append("pending")
            if self.state == "pending" and now - self.since >= for_s:
                self.state = "firing"
                self.since = now
                self.fired_ts = now
                out.append("firing")
        else:
            if self.state == "pending":
                self.state = "inactive"
                self.since = now
                out.append("cleared")
            elif self.state == "firing":
                ref = self.last_true if self.last_true is not None \
                    else self.since
                if now - ref >= resolve_for_s:
                    self.state = "inactive"
                    self.since = now
                    self.resolved_ts = now
                    out.append("resolved")
        return out

    def describe(self, now):
        d = {"rule": self.name, "severity": self.severity,
             "state": self.state}
        if self.state != "inactive" and self.since is not None:
            d["since_s"] = round(max(0.0, now - self.since), 3)
        if self.value is not None:
            d["value"] = self.value
        if self.info:
            d.update(self.info)
        return d


def _cmp(op, value, bound):
    return value > bound if op == ">" else value < bound


def _status_of(alerts):
    """healthy | degraded | critical from a list of Alert objects."""
    status = "healthy"
    for al in alerts:
        if al.state != "firing":
            continue
        if al.severity == "critical":
            return "critical"
        status = "degraded"
    return status


def _rank():
    try:
        return int(os.environ.get("MXNET_TPU_PROCESS_ID", "0") or 0)
    except ValueError:
        return 0


# ----------------------------------------------------- per-rank engine

class SloEngine:
    """Evaluate the rank-scope rules against the live metrics registry.

    The engine snapshots ONLY the metrics the rules reference (a few
    dict reads per tick), keeps a bounded time-indexed history per rule
    for window math, and advances each rule's :class:`Alert`.  All
    methods are thread-safe; ``tick`` is rate-limited by its callers,
    not here, and accepts an explicit ``now`` for deterministic tests.
    """

    def __init__(self, rules=None):
        self.rules = [r for r in (load_rules() if rules is None
                                  else rules)
                      if r.get("scope", "rank") == "rank"]
        self._lock = threading.Lock()
        self._alerts = {r["name"]: Alert(r["name"], r["severity"])
                        for r in self.rules}
        self._hist = {r["name"]: [] for r in self.rules}
        self._absence = {}      # rule -> {last, last_advance, armed}
        self._ticks = 0

    # ------------------------------------------------------- configure
    def configure(self, name, **params):
        """Adjust one rule's parameters at arm time (e.g. the serving
        front door sets ``serve_queue_depth.bound`` from its batcher's
        real depth).  Unknown rule names are ignored (the rule may have
        been disabled by MXNET_TPU_SLO_RULES)."""
        with self._lock:
            for r in self.rules:
                if r["name"] == name:
                    r.update(params)
                    return True
        return False

    # ------------------------------------------------------- readings
    def _metric(self, name):
        from .registry import REGISTRY
        return REGISTRY.get(name)

    @staticmethod
    def _match(key, labels, exclude=None):
        kd = dict(key)
        if labels:
            for k, v in labels.items():
                if kd.get(k) != str(v):
                    return False
        if exclude:
            for k, vals in exclude.items():
                if kd.get(k) in tuple(str(v) for v in vals):
                    return False
        return True

    def _scalar(self, name, labels=None, exclude=None):
        """Sum of matching counter/gauge samples (0.0 when absent)."""
        m = self._metric(name)
        if m is None:
            return 0.0
        total = 0.0
        for key, val in m.samples().items():
            if isinstance(val, dict):   # histogram: use its sum
                val = val.get("sum", 0.0)
            if self._match(key, labels, exclude):
                total += val
        return total

    def _hist_pair(self, name, labels=None):
        """(sum, count) over matching histogram samples."""
        m = self._metric(name)
        s = c = 0.0
        if m is None:
            return s, c
        for key, val in m.samples().items():
            if isinstance(val, dict) and self._match(key, labels):
                s += val.get("sum", 0.0)
                c += val.get("count", 0)
        return s, c

    def _latency_pair(self, name, labels, threshold_s):
        """(good, total) observation counts: good = observations whose
        histogram bucket upper bound is <= the latency target."""
        m = self._metric(name)
        good = total = 0.0
        if m is None:
            return good, total
        bounds = getattr(m, "buckets", ())
        for key, val in m.samples().items():
            if not isinstance(val, dict) or \
                    not self._match(key, labels):
                continue
            total += val.get("count", 0)
            for ub, n in zip(bounds, val.get("buckets", ())):
                if ub <= threshold_s:
                    good += n
        return good, total

    def _reading(self, r):
        """The rule's raw reading tuple for this tick (window math
        happens against the history of these)."""
        t = r["type"]
        if t == "burn_rate":
            if r["kind"] == "latency":
                good, total = self._latency_pair(
                    r["metric"], r.get("labels"), r["threshold_s"])
                return (total - good, total)
            return (self._scalar(r["bad_metric"], r.get("bad_labels")),
                    self._scalar(r["total_metric"],
                                 r.get("total_labels")))
        if t == "threshold":
            mode = r["mode"]
            if mode == "value":
                return (self._scalar(r["metric"], r.get("labels")),)
            if mode == "rate":
                return (self._scalar(r["metric"], r.get("labels")),)
            if mode == "share":
                return (self._scalar(r["metric"], r.get("labels")),
                        self._scalar(r["denom_metric"],
                                     r.get("denom_labels")))
            if mode == "regression":
                return self._hist_pair(r["metric"], r.get("labels"))
        if t in ("absence", "anomaly_passthrough"):
            return (self._scalar(r["metric"], r.get("labels"),
                                 r.get("exclude")),)
        return (0.0,)

    # ---------------------------------------------------- window math
    @staticmethod
    def _at(hist, cutoff):
        """(ts, reading) of the newest sample at or before ``cutoff``
        (the oldest sample when the engine is younger than the
        window — windows are bounded by engine age)."""
        best = None
        for ts, reading in hist:
            if ts <= cutoff:
                best = (ts, reading)
            else:
                break
        return best if best is not None else hist[0]

    def _delta(self, name, now, window, index=None):
        hist = self._hist[name]
        t0, r0 = self._at(hist, now - window)
        t1, r1 = hist[-1]
        if index is None:
            d = tuple(b - a for a, b in zip(r0, r1))
        else:
            d = r1[index] - r0[index]
        return d, max(1e-9, t1 - t0)

    # ---------------------------------------------------- evaluation
    def _evaluate(self, r, now):
        """(condition, headline value, info dict) for one rule; the
        condition is None when the rule cannot be judged yet (no
        traffic / not armed / not enough samples)."""
        name, t = r["name"], r["type"]
        if t == "burn_rate":
            budget = 1.0 - r["objective"]
            burns = {}
            for wname, w in (("fast", r["fast_s"]),
                             ("slow", r["slow_s"])):
                (d_bad, d_total), _el = self._delta(name, now, w)
                if d_total <= 0:
                    burns[wname] = 0.0
                else:
                    burns[wname] = (d_bad / d_total) / budget
            cond = (burns["fast"] > r["factor"]
                    and burns["slow"] > r["factor"])
            info = {"burn_fast": round(burns["fast"], 3),
                    "burn_slow": round(burns["slow"], 3),
                    "factor": r["factor"]}
            if r.get("kind") == "latency":
                # name an ACTUAL slow trace next to the burning
                # quantile: the histogram's slowest-bucket exemplar
                # (rides describe() -> /alerts -> health_top, and the
                # alert flight event)
                from . import tracing
                ex = tracing.exemplar_for(r["metric"], r.get("labels"))
                if ex:
                    info["exemplar_trace"] = ex
            return cond, round(max(burns.values()), 3), info
        if t == "threshold":
            mode = r["mode"]
            if mode == "value":
                v = self._hist[name][-1][1][0]
            elif mode == "rate":
                (dv,), el = self._delta(name, now, r["window_s"])
                v = dv / el
            elif mode == "share":
                (d_num, d_den), _el = self._delta(name, now,
                                                  r["window_s"])
                if d_den <= 0:
                    return None, None, {}
                v = d_num / d_den
            else:  # regression: fast mean vs slow-window baseline mean
                (fs, fc), _ = self._delta(name, now, r["fast_s"])
                (ss, sc), _ = self._delta(name, now, r["slow_s"])
                mc = r.get("min_count", 3)
                bs, bc = ss - fs, sc - fc   # baseline = slow \ fast
                if fc < mc or bc < mc or bs <= 0:
                    return None, None, {}
                v = (fs / fc) / (bs / bc)
            cond = _cmp(r["op"], v, r["bound"])
            return cond, round(v, 6), {"bound": r["bound"]}
        if t == "absence":
            st = self._absence.get(name)
            cum = self._hist[name][-1][1][0]
            if st is None:
                st = {"last": cum, "last_advance": now,
                      "armed": cum > 0}
                self._absence[name] = st
            if cum > st["last"]:
                st["last"] = cum
                st["last_advance"] = now
                st["armed"] = True
            if not st["armed"]:
                return None, None, {}
            idle = now - st["last_advance"]
            return idle >= r["hold_s"], round(idle, 3), \
                {"hold_s": r["hold_s"]}
        if t == "anomaly_passthrough":
            (dv,), _el = self._delta(name, now, r["window_s"])
            return dv > 0, dv, {}
        return None, None, {}

    # ---------------------------------------------------------- tick
    def tick(self, now=None):
        """Run one evaluation pass: snapshot the referenced metrics,
        evaluate every rule, advance the alert machines, emit
        transition metrics + flight events, refresh the state gauges.
        Returns the number of firing rules.  Never raises — the judge
        must not kill the process it judges."""
        try:
            return self._tick(time.time() if now is None else
                              float(now))
        except Exception as e:  # "unjudged", never a dead loop or replica
            log.warning("slo: evaluation tick failed (%s: %s)",
                        type(e).__name__, e)
            return 0

    def _tick(self, now):
        with self._lock:
            self._ticks += 1
            retain = max([now - 2 * max(
                r.get("slow_s") or 0, r.get("window_s") or 0,
                r.get("fast_s") or 0, 60.0) for r in self.rules]
                or [now - 600.0])
            transitions = []
            for r in self.rules:
                name = r["name"]
                hist = self._hist[name]
                hist.append((now, self._reading(r)))
                while len(hist) > 2 and hist[1][0] < retain:
                    # keep >= 2 entries so deltas always have a base
                    hist.pop(0)
                cond, value, info = self._evaluate(r, now)
                al = self._alerts[name]
                if value is not None:
                    al.value = value
                    al.info = info
                for to in al.advance(cond, now, r["for_s"],
                                     r["resolve_for_s"]):
                    transitions.append((r, al, to))
            firing = [a for a in self._alerts.values()
                      if a.state == "firing"]
            status = _status_of(self._alerts.values())
        self._emit(transitions, firing, status)
        return len(firing)

    def _emit(self, transitions, firing, status):
        from . import flight
        from .registry import counter, gauge
        for r, al, to in transitions:
            counter("mxtpu_alert_transitions_total").labels(
                rule=al.name, to=to).inc()
            if to in ("firing", "resolved"):
                flight.record("alert", rule=al.name, to=to,
                              severity=al.severity, value=al.value,
                              summary=r.get("summary", ""),
                              **{k: v for k, v in al.info.items()
                                 if isinstance(v, (int, float, str))})
        g_state = gauge("mxtpu_alert_state")
        for name, al in self._alerts.items():
            g_state.labels(rule=name).set(STATES.index(al.state))
        g_burn = gauge("mxtpu_slo_burn_rate")
        for r in self.rules:
            info = self._alerts[r["name"]].info
            if r["type"] == "burn_rate" and "burn_fast" in info:
                g_burn.labels(rule=r["name"],
                              window="fast").set(info["burn_fast"])
                g_burn.labels(rule=r["name"],
                              window="slow").set(info["burn_slow"])
        g_firing = gauge("mxtpu_alerts_firing")
        counts = {s: 0 for s in SEVERITIES}
        for al in firing:
            counts[al.severity] += 1
        for sev, n in counts.items():
            g_firing.labels(severity=sev).set(n)
        gauge("mxtpu_health_status").set(
            {"healthy": 0, "degraded": 1, "critical": 2}[status])

    # --------------------------------------------------------- verdict
    def health(self, now=None):
        """The per-rank health verdict — the ``mxtpu-health/1``
        document (see the module docstring)."""
        now = time.time() if now is None else float(now)
        with self._lock:
            alerts = list(self._alerts.values())
            doc = {
                "schema": HEALTH_SCHEMA,
                "ts": round(now, 6),
                "rank": _rank(),
                "status": _status_of(alerts),
                "firing": [a.describe(now) for a in alerts
                           if a.state == "firing"],
                "pending": [a.describe(now) for a in alerts
                            if a.state == "pending"],
                "resolved": [
                    {"rule": a.name, "severity": a.severity,
                     "ago_s": round(now - a.resolved_ts, 3)}
                    for a in alerts
                    if a.state == "inactive"
                    and a.resolved_ts is not None
                    and now - a.resolved_ts <= 600.0],
                "rules": len(self.rules),
            }
        return doc

    def alerts(self, now=None):
        """Every rule's current alert state (the ``/alerts`` endpoint
        body under ``"alerts"``)."""
        now = time.time() if now is None else float(now)
        with self._lock:
            return [self._alerts[r["name"]].describe(now)
                    for r in self.rules]


# ------------------------------------------------------ fleet evaluator

class FleetHealth:
    """Evaluate ``scope="fleet"`` rules over the merged run timeline.

    Supervisor-side (stdlib only — never touches the registry or
    flight recorder): a run aggregator calls :meth:`observe_step` for
    every emitted step record and appends the returned alert event
    records to the ``mxtpu-run/1`` timeline::

        {"kind": "event", "event": "alert", "scope": "fleet",
         "rule": ..., "to": "firing" | "resolved" | ...,
         "severity": ..., "value": ..., "step": N, "ts": ...}

    The clock is the step records' own ``ts`` — a postmortem replay
    over an old timeline reproduces the same transitions."""

    def __init__(self, rules=None, num_ranks=None):
        self.specs = [r for r in (load_rules() if rules is None
                                  else rules)
                      if r.get("scope") == "fleet"]
        if num_ranks is not None:
            for r in self.specs:
                # the "every rank reported" bound is the fleet size
                if r["name"] == "fleet_rank_missing" and \
                        r.get("bound", -1) < 0:
                    r["bound"] = int(num_ranks)
        self._alerts = {r["name"]: Alert(r["name"], r["severity"])
                        for r in self.specs}

    @staticmethod
    def _values(rec, field):
        """The field's value list for quorum math: step-level fields
        give one value; ``ranks.<key>`` fans out per reporting rank.
        Booleans read as 0/1; missing values are skipped."""
        if field.startswith("ranks."):
            key = field[len("ranks."):]
            vals = [v.get(key) for v in (rec.get("ranks") or {})
                    .values()]
        else:
            vals = [rec.get(field)]
        out = []
        for v in vals:
            if isinstance(v, bool):
                out.append(1.0 if v else 0.0)
            elif isinstance(v, (int, float)):
                out.append(float(v))
        return out

    def observe_step(self, rec):
        """Feed one ``kind="step"`` timeline record; returns the alert
        event records to append to the timeline."""
        now = rec.get("ts") or time.time()
        events = []
        for r in self.specs:
            vals = self._values(rec, r["field"])
            # an unsampled field (e.g. skew measured every Nth step)
            # freezes the alert rather than resolving it
            cond = None
            value = None
            if vals:
                breaches = [v for v in vals
                            if _cmp(r["op"], v, r["bound"])]
                q = r.get("quorum", "any")
                if q == "any":
                    cond = len(breaches) >= 1
                elif q == "all":
                    cond = len(breaches) == len(vals)
                else:
                    cond = (len(breaches) / len(vals)) >= float(q)
                value = max(vals) if r["op"] == ">" else min(vals)
            al = self._alerts[r["name"]]
            if value is not None:
                al.value = round(value, 6)
                al.info = {"bound": r["bound"]}
            for to in al.advance(cond, now, r["for_s"],
                                 r["resolve_for_s"]):
                if to in ("firing", "resolved"):
                    events.append({
                        "kind": "event", "event": "alert",
                        "scope": "fleet", "rule": r["name"],
                        "to": to, "severity": r["severity"],
                        "value": al.value, "bound": r["bound"],
                        "step": rec.get("step"),
                        "ts": round(now, 6),
                    })
        return events

    def verdict(self, now=None):
        """Fleet-level health roll-up (written into the timeline as a
        ``fleet_health`` event at close)."""
        now = time.time() if now is None else float(now)
        alerts = list(self._alerts.values())
        return {
            "status": _status_of(alerts),
            "firing": [a.describe(now) for a in alerts
                       if a.state == "firing"],
            "rules": len(self.specs),
        }


# ------------------------------------------------- process-wide singleton

_mod_lock = threading.Lock()
_state = {"engine": None, "ticker": None, "stop": None,
          "last_step_tick": 0.0}


def engine():
    """The process-wide engine (created on first use)."""
    with _mod_lock:
        if _state["engine"] is None:
            _state["engine"] = SloEngine()
        return _state["engine"]


def health(now=None):
    """The process-wide engine's health verdict (creates the engine on
    first use; returns a disabled stub when ``MXNET_TPU_SLO=0``)."""
    if not enabled():
        return {"schema": HEALTH_SCHEMA, "ts": round(time.time(), 6),
                "rank": _rank(), "status": "healthy", "firing": [],
                "pending": [], "resolved": [], "rules": 0,
                "disabled": True}
    return engine().health(now)


def on_step():
    """The training-loop hook (``telemetry.step_end`` calls this):
    one clock read per step, a full evaluation at most every
    :func:`tick_seconds`.  Inert when ``MXNET_TPU_SLO=0``."""
    if not enabled():
        return
    now = time.time()
    if now - _state["last_step_tick"] < tick_seconds():
        return
    _state["last_step_tick"] = now
    engine().tick(now)


def start_ticker(interval=None):
    """Arm the background evaluation thread (the serving front door
    calls this; training loops ride :func:`on_step` instead).  Returns
    the thread, or None when SLO evaluation is disabled.  Idempotent.
    """
    if not enabled():
        return None
    with _mod_lock:
        if _state["ticker"] is not None and \
                _state["ticker"].is_alive():
            return _state["ticker"]
        stop = threading.Event()

        def _loop():
            while not stop.wait(interval if interval is not None
                                else tick_seconds()):
                eng = _state["engine"]
                if eng is not None:
                    eng.tick()

        t = threading.Thread(target=_loop, daemon=True,
                             name="mxtpu-slo-ticker")
        _state["stop"] = stop
        _state["ticker"] = t
        # the engine must exist before the first wait expires
        if _state["engine"] is None:
            _state["engine"] = SloEngine()
        t.start()
        return t


def stop_ticker():
    """Stop the background ticker (idempotent)."""
    with _mod_lock:
        if _state["stop"] is not None:
            _state["stop"].set()
        _state["ticker"] = None
        _state["stop"] = None


def reset():
    """Drop the engine and ticker (``telemetry.reset`` calls this);
    the next use rebuilds the engine from the current env."""
    stop_ticker()
    with _mod_lock:
        _state["engine"] = None
        _state["last_step_tick"] = 0.0
