"""Launching the port's multi-process test jobs on the CPU: a free port for
the rendezvous, ``mxnet_tpu_torch/tools/launch.py`` run by path with a
time limit of its own (this host has no pytest-timeout), and the whole
process group killed when the limit runs out."""
import os
import signal
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH = os.path.join(ROOT, "mxnet_tpu_torch", "tools", "launch.py")


def free_port():
    """A port nothing listens on (bound to 0 and released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(args, n=2, env=None, launcher_args=()):
    """Start ``python <args...>`` as an ``n``-rank job under the launcher,
    in a session of its own; returns the Popen (stdout and stderr piped)."""
    cmd = [sys.executable, LAUNCH, "-n", str(n), "--coordinator",
           "127.0.0.1:%d" % free_port(), *launcher_args, "--",
           sys.executable, *args]
    full_env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                    MKL_NUM_THREADS="1", **(env or {}))
    full_env.pop("PYTEST_XDIST_WORKER_COUNT", None)
    return subprocess.Popen(cmd, cwd=ROOT, env=full_env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)


def finish(p, timeout):
    """Wait for a job of :func:`start`; returns the CompletedProcess.  A
    job that outlives ``timeout`` seconds is stopped (the launcher tears
    its workers down on SIGTERM, else the session is killed) and
    fails."""
    cmd = p.args
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        # the launcher tears its workers down on SIGTERM
        os.killpg(p.pid, signal.SIGTERM)
        try:
            out, err = p.communicate(timeout=15)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            out, err = p.communicate()
        raise AssertionError("the job outlived %d s:\n%s\n%s"
                             % (timeout, out[-4000:], err[-4000:]))
    return subprocess.CompletedProcess(cmd, p.returncode, out, err)


def launch(args, n=2, timeout=120, env=None, launcher_args=()):
    """Run ``python <args...>`` as an ``n``-rank job under the launcher
    and wait for it (:func:`start`, :func:`finish`)."""
    return finish(start(args, n, env, launcher_args), timeout)
