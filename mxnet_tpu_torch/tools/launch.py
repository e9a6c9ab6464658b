#!/usr/bin/env python
"""The job launcher: N worker processes of one command, under a watchdog.

The counterpart of ``tools/launch.py`` of the JAX package (the
reference's ``tools/launch.py`` over dmlc_tracker).  There are no
parameter servers: every worker runs the same command and joins one
``torch.distributed`` process group from the environment this launcher
sets (``MXNET_TPU_COORDINATOR``, ``MXNET_TPU_NUM_PROCESSES``,
``MXNET_TPU_PROCESS_ID``; read by
``mxnet_tpu_torch.parallel.multihost.ensure_initialized``, which
``build_mesh`` and ``mx.kv.create("dist_*")`` call).  ``--launcher
local`` starts the workers on this host by ``subprocess`` (each in its
own process group); ``--launcher ssh`` starts one a host of
``--hostfile``.

Run it by path, ``python mxnet_tpu_torch/tools/launch.py -n 2 -- CMD``:
the supervisor imports neither torch nor the package, so it never touches
CUDA (``python -m mxnet_tpu_torch.tools.launch`` works too, but imports
the package, and with it torch).

Supervision (local launcher): the watchdog polls the workers every
``--heartbeat-interval`` seconds (``MXNET_TPU_HEARTBEAT_INTERVAL``); a
worker that exits non-zero (a crash, a kill) makes it tear the others
down (SIGTERM, then SIGKILL after a grace period: a survivor would block
in a collective against the dead rank) and, within ``--restart-budget``
(``MXNET_TPU_RESTART_BUDGET``), relaunch the whole job with
``MXNET_TPU_RESTART_COUNT`` set to the attempt, so workers resume from
their latest checkpoint.

Run observability (local launcher, ``MXNET_TPU_TELEMETRY_JSONL`` set):
each worker writes its own step log ``<base>.rank<N>`` and, with
``MXNET_TPU_TELEMETRY_PORT`` set, serves metrics on ``port+N``; the
supervisor appends its own events to ``<base>`` and merges the ranks'
streams into the ``mxtpu-run/1`` timeline ``<base>.run`` through the
aggregation half of ``telemetry/distview.py``, loaded by file path
(stdlib only).  SIGUSR1 sent to the supervisor is relayed to every
worker, whose handler captures a profiler window and a flight snapshot
(``MXNET_TPU_CAPTURE_DIR``); ``launch.py --capture`` sends it to a
running job found through the supervisor's JSONL.

``--elastic``, ``--min-workers`` and ``--fleet`` raise: elastic resizing
and serving-fleet supervision come with the next slice of multi-GPU work
(ROADMAP Queue A item 4).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

_NEXT_SLICE = ("not yet ported to mxnet_tpu_torch (elastic resizing and "
               "serving fleets come with the next slice of ROADMAP Queue A "
               "item 4)")


def dmlc_opts(opts):
    """Map the reference's flags onto env for each process."""
    env = dict(os.environ)
    env["MXNET_TPU_NUM_PROCESSES"] = str(opts.num_workers)
    env["MXNET_TPU_COORDINATOR"] = opts.coordinator
    return env


def _load_by_path(relpath, name):
    """A stdlib-only module of the package, executed from its file
    (``relpath`` under the package), without importing the package."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, relpath)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_distview():
    """Load the aggregation half of telemetry/distview.py by file path
    (stdlib-only module-level imports) — the supervisor must never
    import the framework.  Returns None when unavailable; the launcher
    then runs exactly as before, without the run timeline."""
    try:
        return _load_by_path("telemetry/distview.py", "mxtpu_distview")
    except Exception as e:  # the run timeline is optional: a broken module must not kill the job it watches
        sys.stderr.write("launch.py: run-timeline aggregator "
                         "unavailable (%s)\n" % e)
        return None


def _merge_traces():
    """Merge per-rank ``mxtpu-trace/1`` files (``MXNET_TPU_TRACE_DIR``)
    into ``trace.merged.jsonl`` at job end, so a fleet-wide request or
    step is ONE trace record for ``tools/trace_top.py``.  Optional
    observability — never raises."""
    tdir = os.environ.get("MXNET_TPU_TRACE_DIR")
    if not tdir or not os.path.isdir(tdir):
        return None
    try:
        return _load_by_path("telemetry/tracing.py",
                             "mxtpu_tracing").merge_trace_dir(tdir)
    except Exception as e:  # the trace merge is optional: a finished job must not fail at teardown
        sys.stderr.write("launch.py: trace merge unavailable (%s)\n"
                         % e)
        return None


def _supervisor_jsonl():
    """The supervisor's own event stream (the base
    MXNET_TPU_TELEMETRY_JSONL path; workers write ``<base>.rank<N>``)."""
    return os.environ.get("MXNET_TPU_TELEMETRY_JSONL")


def _sup_event(record, agg=None):
    """Append one supervisor event to the base JSONL stream (and, when
    the aggregator runs, pass it through into the run timeline)."""
    rec = {"ts": round(time.time(), 6)}
    rec.update(record)
    if agg is not None:
        try:
            agg.note_event(rec)
        except Exception as e:  # a timeline write failure must not take the supervisor down
            sys.stderr.write("launch.py: run-timeline event failed: "
                             "%s\n" % e)
    path = _supervisor_jsonl()
    if not path:
        return
    try:
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    except OSError as e:
        sys.stderr.write("launch.py: cannot append telemetry event to "
                         "%s: %s\n" % (path, e))


def _make_aggregator(opts):
    """RunAggregator over the per-rank streams (None when the step-log
    is off or distview cannot load).  The timeline lands beside the
    supervisor JSONL as ``<base>.run``; besides per-step fleet rows it
    carries worker event breadcrumbs (reshard, rank_join/rank_leave,
    and the exactly-once data plane's data_resume / data_remap /
    backpressure_adjust — docs/api/io_resume.md)."""
    base = _supervisor_jsonl()
    if not base or opts.launcher != "local":
        return None
    dv = _load_distview()
    if dv is None:
        return None
    try:
        agg = dv.RunAggregator(base, opts.num_workers)
    except Exception as e:  # optional observability, see _load_distview
        sys.stderr.write("launch.py: cannot start run aggregator: "
                         "%s\n" % e)
        return None
    # fleet-scope SLO rules (telemetry/slo.py, loaded by path — same
    # stdlib-only contract): every merged step is judged and alert
    # transitions land in the timeline; a broken module degrades to an
    # unjudged timeline, exactly like a missing aggregator
    try:
        slo = _load_by_path("telemetry/slo.py", "mxtpu_slo")
        if slo.enabled():
            fh = slo.FleetHealth(num_ranks=opts.num_workers)
            if fh.specs:
                agg.health = fh
    except Exception as e:  # optional observability, see _load_distview
        sys.stderr.write("launch.py: fleet SLO evaluation unavailable "
                         "(%s)\n" % e)
    return agg


def _run_workers_once(opts, command, attempt, agg=None):
    """Start N workers and watchdog them until the job ends.

    The watchdog polls worker liveness every ``--heartbeat-interval``
    seconds: a dead rank (crash, OOM kill, nonzero exit) is detected
    within one interval, the remaining workers are torn down after a
    short grace period (SIGTERM, then SIGKILL — a synchronous peer
    would otherwise block forever in a collective against the dead
    rank), and the attempt exits nonzero with a clear message.  SIGTERM
    or SIGINT to the supervisor tears the workers down the same way
    and exits.
    ``MXNET_TPU_RESTART_COUNT`` tells workers which restart attempt
    they are (0 = first launch) so resume-aware scripts reload their
    latest checkpoint.

    Observability: per-rank step-log/port env (see the module
    docstring), a ``worker_start`` supervisor event per rank (pid +
    chosen telemetry port — the postmortem's rank→process map), the
    run-timeline aggregator polled on every heartbeat, and a SIGUSR1
    relay so one signal to the supervisor captures the whole fleet."""
    hb = max(0.05, float(opts.heartbeat_interval))
    procs = []
    base_env = dmlc_opts(opts)
    base_env["MXNET_TPU_RESTART_COUNT"] = str(attempt)
    base_jsonl = _supervisor_jsonl()
    try:
        base_port = int(base_env.get("MXNET_TPU_TELEMETRY_PORT", "0"))
    except ValueError:
        base_port = 0
    if agg is not None:
        agg.begin_attempt(attempt)
    flight_before = _flight_dump_names()
    for rank in range(opts.num_workers):
        env = dict(base_env)
        env["MXNET_TPU_PROCESS_ID"] = str(rank)
        port = 0
        if base_port > 0:
            # one fixed port cannot serve N co-located ranks: assign
            # rank N port+N (ssh workers — one per host — keep the
            # configured port) and record the choice below
            port = base_port + (rank if opts.num_workers > 1 else 0)
            env["MXNET_TPU_TELEMETRY_PORT"] = str(port)
        if base_jsonl:
            # each rank appends its OWN stream; the supervisor keeps the
            # base file and merges the ranks into <base>.run
            env["MXNET_TPU_TELEMETRY_JSONL"] = \
                "%s.rank%d" % (base_jsonl, rank)
        def _child_setup():
            # own process group so teardown reaches the python under
            # the shell=True sh wrapper, not just the wrapper
            os.setsid()
            # SIG_IGN survives exec: a wrapper sh that lingers must
            # ignore the fleet-wide capture signal instead of dying of
            # it (which the watchdog would read as a dead rank); the
            # worker's telemetry re-arms its own SIGUSR1 handler when
            # MXNET_TPU_CAPTURE_DIR is set
            signal.signal(signal.SIGUSR1, signal.SIG_IGN)

        p = subprocess.Popen(command, shell=True, env=env,
                             preexec_fn=_child_setup)
        procs.append(p)
        _sup_event({"event": "worker_start", "attempt": attempt,
                    "rank": rank, "pid": p.pid,
                    "telemetry_port": port or None,
                    "jsonl": env.get("MXNET_TPU_TELEMETRY_JSONL")},
                   agg)

    def signal_group(p, sig):
        try:
            os.killpg(os.getpgid(p.pid), sig)
        except (ProcessLookupError, PermissionError):
            pass

    code, failed_rank = 0, None
    live = dict(enumerate(procs))

    def relay_usr1(signum, frame):
        # fleet-wide on-demand capture: one signal to the supervisor
        # reaches every live worker (tools/launch.py --capture)
        for p in live.values():
            signal_group(p, signal.SIGUSR1)

    def teardown(signum, frame):
        # the supervisor itself is stopped: its workers, each in a
        # session of its own, must not outlive it
        for p in live.values():
            signal_group(p, signal.SIGTERM)
        grace = time.time() + 10
        for p in live.values():
            try:
                p.wait(max(0.1, grace - time.time()))
            except subprocess.TimeoutExpired:
                signal_group(p, signal.SIGKILL)
        sys.exit(128 + signum)

    prev = {}
    for sig, handler in ((signal.SIGUSR1, relay_usr1),
                         (signal.SIGTERM, teardown),
                         (signal.SIGINT, teardown)):
        try:
            prev[sig] = signal.signal(sig, handler)
        except (ValueError, OSError):   # non-main thread embedding
            pass
    try:
        while live:
            for rank in list(live):
                rc = live[rank].poll()
                if rc is None:
                    continue
                del live[rank]
                if rc != 0 and failed_rank is None:
                    failed_rank, code = rank, rc
                    sys.stderr.write(
                        "launch.py: worker %d exited with code %d "
                        "(signal %s); aborting job — surviving workers "
                        "would block on the dead rank's collectives. "
                        "Resume from the last checkpoint.\n"
                        % (rank, rc, -rc if rc < 0 else "none"))
                    sys.stderr.flush()
                    for other in live.values():
                        signal_group(other, signal.SIGTERM)
                    grace = time.time() + 10
                    for other in live.values():
                        try:
                            other.wait(max(0.1, grace - time.time()))
                        except subprocess.TimeoutExpired:
                            signal_group(other, signal.SIGKILL)
                elif rc != 0:
                    code = code or rc
            if agg is not None:
                agg.poll()
            if live:
                time.sleep(hb)
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, handler)
    if agg is not None:
        agg.poll()
    if failed_rank is not None:
        # postmortem breadcrumb: any black box the dead worker (or its
        # torn-down peers) left behind — collected AFTER the grace
        # teardown so SIGTERM'd survivors' dumps are included too
        _note_worker_death(attempt, failed_rank, code,
                           sorted(_flight_dump_names() - flight_before),
                           agg)
    return code


def _flight_dump_names():
    """Flight-recorder dump paths currently in MXNET_TPU_FLIGHT_DIR
    (empty set when black-box dumping is off or the dir is unreadable —
    the supervisor stays stdlib-only and never imports the framework)."""
    d = os.environ.get("MXNET_TPU_FLIGHT_DIR")
    if not d:
        return set()
    try:
        return {os.path.join(d, f) for f in os.listdir(d)
                if f.startswith("flight-") and f.endswith(".json")}
    except OSError:
        return set()


def _note_worker_death(attempt, rank, code, flight_dumps, agg=None):
    """Record a worker-death event (with any collected flight dumps) in
    the supervisor JSONL stream and the run timeline — the
    machine-readable twin of the stderr dead-rank message."""
    if flight_dumps:
        sys.stderr.write("launch.py: collected %d flight dump(s) from "
                         "the dead attempt: %s\n"
                         % (len(flight_dumps), ", ".join(flight_dumps)))
    _sup_event({"event": "worker_death", "attempt": attempt,
                "rank": rank, "exit_code": code,
                "flight_dumps": flight_dumps}, agg)


def launch_local(opts, command):
    """Start N workers on this host under the watchdog, relaunching the
    whole job up to ``--restart-budget`` times after a failed attempt
    (workers resume from their latest complete checkpoint: see
    ``ShardedTrainer.load_latest_checkpoint`` and
    ``MXNET_TPU_RESTART_COUNT``).  Budget 0 fails fast."""
    agg = _make_aggregator(opts)
    _sup_event({"event": "job_start", "pid": os.getpid(),
                "num_workers": opts.num_workers,
                "run_timeline": agg.out_path if agg else None}, agg)
    # SIGUSR1 must never kill the supervisor between attempts
    try:
        prev_usr1 = signal.signal(signal.SIGUSR1, signal.SIG_IGN)
    except (ValueError, OSError):       # non-main thread embedding
        prev_usr1 = None
    try:
        attempt = 0
        while True:
            code = _run_workers_once(opts, command, attempt, agg)
            if code == 0:
                if attempt:
                    sys.stderr.write(
                        "launch.py: job recovered after %d restart(s)\n"
                        % attempt)
                return 0
            if attempt >= opts.restart_budget:
                if opts.restart_budget:
                    sys.stderr.write(
                        "launch.py: restart budget (%d) exhausted; "
                        "giving up with exit code %d\n"
                        % (opts.restart_budget, code))
                return code
            attempt += 1
            sys.stderr.write(
                "launch.py: restarting job (attempt %d/%d) from the "
                "last complete checkpoint\n"
                % (attempt, opts.restart_budget))
            sys.stderr.flush()
            _sup_event({"event": "watchdog_restart",
                        "attempt": attempt}, agg)
    finally:
        if prev_usr1 is not None:
            signal.signal(signal.SIGUSR1, prev_usr1)
        # the end marker --capture reads: a later capture must not signal
        # this finished job's (possibly reused) pids
        _sup_event({"event": "job_end", "pid": os.getpid()}, agg)
        if agg is not None:
            agg.close()
        merged = _merge_traces()
        if merged:
            sys.stderr.write("launch.py: merged fleet traces -> %s\n"
                             % merged)


def launch_ssh(opts, command):
    """One worker per host over ssh."""
    hosts = []
    with open(opts.hostfile) as f:
        for line in f:
            h = line.strip()
            if h:
                hosts.append(h)
    assert len(hosts) >= opts.num_workers
    procs = []
    # dist_async multi-server: servers run inside ranks 0..N-1, so
    # their reachable hosts are the first N hostfile entries (workers
    # default all servers to the coordinator host otherwise, which is
    # wrong the moment rank 1 lives on another machine)
    nserv = int(_load_by_path("config.py", "mxtpu_config").uncatalogued(
        "MXNET_TPU_NUM_SERVERS") or 1)
    server_hosts = ",".join(hosts[:nserv])
    for rank in range(opts.num_workers):
        env_prefix = ("MXNET_TPU_NUM_PROCESSES=%d MXNET_TPU_PROCESS_ID=%d "
                      "MXNET_TPU_COORDINATOR=%s MXNET_TPU_NUM_SERVERS=%d "
                      "MXNET_TPU_SERVER_HOSTS=%s"
                      % (opts.num_workers, rank, opts.coordinator,
                         nserv, server_hosts))
        cmd = "ssh -o StrictHostKeyChecking=no %s 'cd %s; %s %s'" % (
            hosts[rank], os.getcwd(), env_prefix, command)
        procs.append(subprocess.Popen(cmd, shell=True))
    code = 0
    for p in procs:
        p.wait()
        code = code or p.returncode
    return code


def capture_job(jsonl=None):
    """Broadcast the on-demand capture signal (SIGUSR1) to every live
    worker of a RUNNING launch.py job — ``tools/launch.py --capture``.

    The job is found through its supervisor JSONL stream
    (``--jsonl PATH`` or MXNET_TPU_TELEMETRY_JSONL): the latest
    ``worker_start`` events name each rank's pid/process group.  Every
    signaled worker whose telemetry has ``MXNET_TPU_CAPTURE_DIR`` set
    writes a bounded ``torch.profiler`` trace window plus a flight
    snapshot under ``<dir>/rank<N>/`` without restarting (the flight
    dump reads with ``tools/flight_read.py``).
    Falls back to signaling the supervisor (which relays fleet-wide)
    when no worker pid is alive.  Returns a shell exit code."""
    path = jsonl or os.environ.get("MXNET_TPU_TELEMETRY_JSONL")
    if not path:
        sys.stderr.write("launch.py --capture: no supervisor JSONL "
                         "(--jsonl PATH or MXNET_TPU_TELEMETRY_JSONL)\n")
        return 2
    workers = {}        # rank -> pid, latest worker_start wins
    supervisor = None
    try:
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(rec, dict):
                    continue
                if rec.get("event") == "job_start" and rec.get("pid"):
                    supervisor = int(rec["pid"])
                    workers = {}     # a fresh job supersedes old pids
                elif rec.get("event") == "worker_start" \
                        and rec.get("pid") is not None:
                    workers[rec.get("rank", len(workers))] = \
                        int(rec["pid"])
                elif rec.get("event") == "worker_death":
                    workers.pop(rec.get("rank"), None)
                elif rec.get("event") == "job_end":
                    # the job finished: its pids are stale, and a pid
                    # the OS reused would get a SIGUSR1 it has no
                    # handler for (default disposition: termination)
                    supervisor = None
                    workers = {}
    except OSError as e:
        sys.stderr.write("launch.py --capture: cannot read %s: %s\n"
                         % (path, e))
        return 2

    def alive(pid):
        try:
            os.kill(pid, 0)
            return True
        except (ProcessLookupError, PermissionError):
            return False

    signaled = []
    for rank in sorted(workers):
        pid = workers[rank]
        if not alive(pid):
            continue
        try:
            # the whole process group: workers run under a shell=True
            # wrapper in their own group (os.setsid at spawn)
            os.killpg(os.getpgid(pid), signal.SIGUSR1)
        except (ProcessLookupError, PermissionError, OSError):
            try:
                os.kill(pid, signal.SIGUSR1)
            except OSError:
                continue
        signaled.append((rank, pid))
    if not signaled and supervisor is not None and alive(supervisor):
        # let the supervisor's SIGUSR1 relay reach workers we cannot see
        os.kill(supervisor, signal.SIGUSR1)
        print("launch.py --capture: signaled supervisor pid %d (relay)"
              % supervisor)
        return 0
    if not signaled:
        sys.stderr.write("launch.py --capture: no live workers found "
                         "in %s\n" % path)
        return 1
    print("launch.py --capture: signaled %d worker(s): %s"
          % (len(signaled), ", ".join("rank %d (pid %d)" % w
                                      for w in signaled)))
    return 0


def main():
    # capture mode is selected by a LEADING --capture only: the worker
    # command after -n may legitimately contain a --capture of its own
    if sys.argv[1:2] == ["--capture"]:
        cap = argparse.ArgumentParser(
            prog="launch.py --capture",
            description="broadcast SIGUSR1 to a running job: every "
                        "worker captures a bounded profiler window + "
                        "flight snapshot (MXNET_TPU_CAPTURE_DIR)")
        cap.add_argument("--capture", action="store_true")
        cap.add_argument("--jsonl", default=None,
                         help="supervisor JSONL of the running job "
                              "(default: MXNET_TPU_TELEMETRY_JSONL)")
        args = cap.parse_args()
        sys.exit(capture_job(args.jsonl))
    parser = argparse.ArgumentParser(
        description="Launch a distributed job (reference tools/launch.py)")
    parser.add_argument("-n", "--num-workers", required=True, type=int,
                        help="number of worker processes to launch")
    parser.add_argument("-s", "--num-servers", type=int, default=0,
                        help="accepted as the reference's; dist_sync has "
                             "no parameter servers (collectives replace "
                             "them), dist_async reads "
                             "MXNET_TPU_NUM_SERVERS")
    parser.add_argument("-H", "--hostfile", type=str,
                        help="host file with one host per line (ssh mode)")
    parser.add_argument("--launcher", type=str, default="local",
                        choices=["local", "ssh"],
                        help="cluster launcher mode")
    parser.add_argument("--coordinator", type=str,
                        default="127.0.0.1:8431",
                        help="the process group's rendezvous host:port")
    parser.add_argument("--restart-budget", type=int,
                        default=int(os.environ.get(
                            "MXNET_TPU_RESTART_BUDGET", "0")),
                        help="relaunch a failed job up to this many times "
                             "(workers resume from their latest complete "
                             "checkpoint; local launcher only)")
    parser.add_argument("--heartbeat-interval", type=float,
                        default=float(os.environ.get(
                            "MXNET_TPU_HEARTBEAT_INTERVAL", "0.2")),
                        help="watchdog poll interval in seconds — a dead "
                             "rank is detected within one interval")
    parser.add_argument("--elastic", action="store_true",
                        help="size-aware restarts: " + _NEXT_SLICE)
    parser.add_argument("--min-workers", type=int, default=None,
                        help="floor of elastic shrinking: " + _NEXT_SLICE)
    parser.add_argument("--fleet", action="store_true",
                        help="serving-fleet supervision: " + _NEXT_SLICE)
    parser.add_argument("command", nargs="+", help="command to launch")
    opts = parser.parse_args()
    for flag, on in (("--elastic", opts.elastic),
                     ("--min-workers", opts.min_workers is not None),
                     ("--fleet", opts.fleet)):
        if on:
            parser.error("%s is %s" % (flag, _NEXT_SLICE))
    command = " ".join(opts.command)
    if opts.launcher == "local":
        code = launch_local(opts, command)
    else:
        code = launch_ssh(opts, command)
    sys.exit(code)


if __name__ == "__main__":
    main()
