"""The port's ``parallel/multihost.py`` and the process-spanning mesh
against the JAX package, in process (the two-rank jobs of
``test_torch_dist_*.py`` and ``test_torch_launch.py`` join real groups).

* ``stage_local`` gives rank r the rows JAX's staging gives process r: a
  ``data`` axis of one device a process shards the batch into contiguous
  blocks in device order (read from a JAX ``NamedSharding`` over the
  CPU's virtual devices);
* ``ensure_initialized`` outside a job, its refusal without a
  coordinator, and its retries of the ``multihost.init`` seam (as many
  as ``MXNET_TPU_INIT_RETRIES`` allows) match JAX's; so do the barrier's
  (``MXNET_TPU_BARRIER_RETRIES``);
* ``build_mesh`` outside a job is a mesh of one device; ``tp``, ``pp``,
  several devices in a process and a world it is not raise, naming the
  next slice; BatchNorm's batch reductions stay local outside a
  data-parallel step.
"""
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec  # noqa: E402

from mxnet_tpu import resilience as jres  # noqa: E402
from mxnet_tpu.parallel import multihost as jmh  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import resilience as tres  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.parallel import build_mesh, multihost  # noqa: E402


@pytest.fixture(autouse=True)
def _no_job(monkeypatch):
    for k in ("MXNET_TPU_COORDINATOR", "MXNET_TPU_NUM_PROCESSES",
              "MXNET_TPU_PROCESS_ID", "MXNET_TPU_FAULTS"):
        monkeypatch.delenv(k, raising=False)
    yield
    tres.clear_faults()
    jres.clear_faults()


@pytest.mark.parametrize("world", [1, 2, 4])
def test_stage_local_gives_jax_rows(world):
    x = np.arange(8 * world * 3, dtype=np.float32).reshape(8 * world, 3)
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    rows = NamedSharding(mesh, PartitionSpec("data")) \
        .addressable_devices_indices_map(x.shape)
    for r, dev in enumerate(mesh.devices.flat):
        want = x[rows[dev]]
        np.testing.assert_array_equal(
            multihost.stage_local(x, world=world, r=r), want)
        assert multihost.scale_local_shape(want.shape, world) == x.shape
    with pytest.raises(MXNetError, match="does not split"):
        multihost.stage_local(x[:3], world=2, r=0)


def test_outside_a_job_as_jax():
    assert multihost.ensure_initialized() == 1
    jmh.ensure_initialized()
    assert multihost.world_size() == jmh.world_size() == 1
    assert multihost.rank() == 0 and multihost.backend() is None
    multihost.process_barrier("t")
    jmh.process_barrier("t")
    assert not multihost.batch_sums_span_ranks()
    with multihost.batch_group(True):
        # one process: nothing to reduce across
        assert not multihost.batch_sums_span_ranks()


def test_a_job_needs_a_coordinator(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_NUM_PROCESSES", "2")
    with pytest.raises(MXNetError, match="MXNET_TPU_COORDINATOR is unset"):
        multihost.ensure_initialized()
    with pytest.raises(Exception, match="MXNET_TPU_COORDINATOR is unset"):
        jmh.ensure_initialized()


@pytest.mark.parametrize("fires,retries", [(1, 2), (2, 2), (3, 2), (1, 0)])
@pytest.mark.parametrize("seam", ["init", "barrier"])
def test_seam_retries_as_jax(monkeypatch, fires, retries, seam):
    knob = "MXNET_TPU_%s_RETRIES" % seam.upper()
    monkeypatch.setenv(knob, str(retries))
    outcomes = []
    for res, call in ((tres, multihost.ensure_initialized
                       if seam == "init" else multihost.process_barrier),
                      (jres, jmh.ensure_initialized
                       if seam == "init" else jmh.process_barrier)):
        res.configure_faults("multihost.%s:p=1,n=%d" % (seam, fires))
        try:
            call()
            outcomes.append("ok")
        except Exception as e:  # noqa: BLE001 - the outcome is compared
            outcomes.append(type(e).__name__)
        res.clear_faults()
    assert outcomes[0] == outcomes[1]
    assert outcomes[0] == ("ok" if fires <= retries else "MXNetError")


def test_build_mesh_outside_a_job():
    mesh = build_mesh(devices=[tmx.cpu()])
    assert mesh.shape == {"data": 1, "model": 1} and mesh.world == 1
    assert not multihost.spans_processes(mesh)
    for kw in ({"tp": 2}, {"pp": 2}, {"devices": [tmx.cpu(), tmx.cpu()]},
               {"n_devices": 2, "devices": [tmx.cpu()]}):
        with pytest.raises(MXNetError, match="next slice"):
            build_mesh(**kw)


def _mlp():
    x = tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=4,
                               name="fc")
    return tmx.sym.SoftmaxOutput(x, name="softmax")


@pytest.mark.parametrize("option", [{"pipeline_stages": 2},
                                    {"sequence_parallel": True},
                                    {"tp_rules": {}}])
def test_model_parallel_options_name_the_next_slice(option):
    from mxnet_tpu_torch.parallel import ShardedTrainer
    with pytest.raises(MXNetError, match="next slice"):
        ShardedTrainer(_mlp(), build_mesh(devices=[tmx.cpu()]),
                       data_shapes={"data": (2, 3)},
                       label_shapes={"softmax_label": (2,)}, **option)


def test_expert_mesh_and_group2ctx_name_the_next_slice():
    from mxnet_tpu_torch.parallel.moe import make_expert_mesh
    with pytest.raises(MXNetError, match="next slice"):
        make_expert_mesh(2)
    with pytest.raises(MXNetError, match="next slice"):
        _mlp().simple_bind(tmx.cpu(), data=(2, 3),
                           group2ctx={"dev1": tmx.cpu()})


class _FakeGroup:
    """A two-rank group's all-gather: the other rank arrives ``lag``
    seconds after this one."""

    def __init__(self, lag):
        self.lag, self.gathers = lag, 0

    def all_gather(self, out, mine):
        self.gathers += 1
        out[0].copy_(mine)
        out[1].copy_(mine + self.lag)


@pytest.mark.parametrize("every", ["1", "3"])
def test_timestamp_barrier_as_jax(monkeypatch, every):
    """The port's pre-collective barrier over a fake two-rank group reads
    what the JAX one reads over the same arrivals: the straggler, the
    skew, the calls it measures on, the metrics and the flight event."""
    import jax as jax_mod
    from jax.experimental import multihost_utils
    from mxnet_tpu import telemetry as jtel
    from mxnet_tpu.telemetry import distview as jdv
    from mxnet_tpu_torch import telemetry as ttel
    from mxnet_tpu_torch.telemetry import distview as tdv
    monkeypatch.setenv("MXNET_TPU_SKEW_EVERY", every)
    fake = _FakeGroup(0.25)
    monkeypatch.setattr(multihost, "world_size", lambda: 2)
    monkeypatch.setattr(multihost, "rank", lambda: 0)
    monkeypatch.setattr(multihost, "_dist", lambda: fake)
    monkeypatch.setattr(multihost, "backend", lambda: "gloo")
    jcalls = []

    def jgather(x):
        jcalls.append(1)
        return np.asarray([[float(x[0])], [float(x[0]) + 0.25]])
    monkeypatch.setattr(jax_mod, "process_count", lambda: 2)
    monkeypatch.setattr(jax_mod, "process_index", lambda: 0)
    monkeypatch.setattr(multihost_utils, "process_allgather", jgather)
    for dv in (tdv, jdv):
        dv._skew_state.clear()
        dv._skew_state["calls"] = 0
    ttel.reset()
    jtel.reset()
    got = [tdv.pre_collective_barrier("t") for _ in range(4)]
    want = [jdv.pre_collective_barrier("t") for _ in range(4)]
    assert [g is None for g in got] == [w is None for w in want]
    assert fake.gathers == len(jcalls)
    for g, w in zip(got, want):
        if g is not None:
            assert (g["slowest_rank"], g["rank"]) == \
                (w["slowest_rank"], w["rank"]) == (1, 0)
            assert g["skew_s"] == pytest.approx(w["skew_s"])
    assert ttel.gauge("mxtpu_rank_step_skew_seconds").get() == \
        pytest.approx(jtel.gauge("mxtpu_rank_step_skew_seconds").get())
    assert ttel.histogram("mxtpu_collective_wait_seconds").get()["count"] \
        == jtel.histogram("mxtpu_collective_wait_seconds").get()["count"]
    assert [e["slowest_rank"] for e in ttel.flight.events()
            if e.get("kind") == "skew"] == \
        [e["slowest_rank"] for e in jtel.flight.events()
         if e.get("kind") == "skew"]
    ttel.reset()
    jtel.reset()


_BUILDER = """
import sys
from pathlib import Path
from mxnet_tpu_torch import cuda_build
d = Path(sys.argv[1])
cuda_build.build_dir = lambda: d
print(cuda_build._compile([("k", d / "k.cu", d / "libk.so")])[0]["cached"])
"""


def test_concurrent_builds_run_nvcc_once(tmp_path):
    """Two processes build one kernel at once (the ranks of a job on a
    fresh machine): the build directory's lock lets one run nvcc while the
    other waits, then loads its library."""
    import subprocess
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\necho run >> %s\nsleep 1\n"
                    "for a; do out=$prev; prev=$a; done\n"
                    "touch \"$out\"\n" % (tmp_path / "runs"))
    nvcc.chmod(0o755)
    (tmp_path / "k.cu").write_text("// kernel\n")
    env = dict(os.environ, PATH="%s:%s" % (nvcc.parent, os.environ["PATH"]),
               PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER,
                               str(tmp_path)], env=env, text=True,
                              stdout=subprocess.PIPE) for _ in range(2)]
    outs = sorted(p.communicate(timeout=120)[0].split()[-1] for p in procs)
    assert outs == ["False", "True"]
    assert (tmp_path / "runs").read_text().split() == ["run"]
    assert (tmp_path / "libk.so").exists()


@pytest.mark.parametrize("cuda,count,nproc,want", [
    (False, 0, 2, "gloo"),       # the CPU
    (True, 1, 2, "gloo"),        # two ranks share the one card
    (True, 1, 1, "nccl"),        # one rank, one card: NCCL at world 1
    (True, 4, 4, "nccl"),        # a card a rank
    (True, 2, 4, "gloo")])
def test_backend_follows_the_devices(monkeypatch, cuda, count, nproc, want):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    assert multihost._choose_backend(nproc) == want
    monkeypatch.setenv("MXNET_TPU_PROCESS_ID", "3")
    dev = multihost.device()
    assert (dev.type, dev.index) == (("cuda", 3 % count) if cuda
                                     else ("cpu", None))
