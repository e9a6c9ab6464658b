"""chip_smoke's dist_train checks on the CPU, at the tiny size of
``mxnet_tpu_torch.tools.dist_train``: one two-rank gloo job through the
launcher runs the phase's legs job (``tests/torch_dist_train.py gate``,
which is ``chip_smoke.dist_worker``), then the phase's readers hold it
against one process here.

* ResNet's state gate: the masters and moving statistics after the first
  step, ||two ranks - one process|| in units of one process's step, read
  within 1e-4 in f32, as does one process on the batch with its halves
  swapped (the floor), and the control (each rank's BatchNorm over its
  own rows, on a batch whose rank halves differ) reads its moving
  statistics beyond ``TOL_DIST_AUX``, so ``_gate_resnet`` passes the
  pair, and refuses it with the two swapped;
* the async parameter server's final weights equal, to the bit, a host
  replay of the pushes in the order the server applied them;
* the tool's legs: the ranks' states equal to the bit, the Module's
  parameters equal with overlap off and on, each trainer's build timed
  apart from its steps.
"""
import copy
import os
import sys

import numpy as np
import pytest

import torch_threads  # noqa: F401  (xdist workers share the cores)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import chip_smoke  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.tools import dist_train as dt  # noqa: E402

import torch_dist_common  # noqa: E402


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dist_gate"))
    res = torch_dist_common.launch(
        [os.path.join(ROOT, "tests", "torch_dist_train.py"), "gate", out],
        timeout=150,
        env={"MXNET_TPU_ASYNC_PORT": str(torch_dist_common.free_port())})
    assert res.returncode == 0, res.stderr[-4000:]
    cfg = dict(dt.TINY["resnet"])
    ref, floor = (chip_smoke._resnet_reference(cfg, dt.RESNET_STEPS,
                                               tmx.cpu(), swap=swap)
                  for swap in (False, True))
    return out, ref, chip_smoke._resnet_readings(out, ref, floor)


def test_resnet_state_gate_tells_the_control_from_a_sound_run(job):
    _out, ref, got = job
    sound = got["resnet"]["state_gap"]
    control = got["resnet_control"]["state_gap"]
    for name in ("resnet", "floor"):
        gap = got[name]["state_gap"]
        assert gap["params"] < 1e-4 and gap["aux"] < 1e-4, (name, gap)
        assert got[name]["max_rel_loss_diff"] < 1e-3
    assert len(got["resnet"]["losses"]) == len(ref[0]) == dt.RESNET_STEPS
    assert control["aux"] > chip_smoke.TOL_DIST_AUX, control
    assert control["params"] > 0.1, control
    chip_smoke._gate_resnet(got)
    swapped = copy.deepcopy(got)
    swapped["resnet"]["state_gap"], swapped["resnet_control"][
        "state_gap"] = control, sound
    with pytest.raises(SystemExit, match="moving statistics"):
        chip_smoke._gate_resnet(swapped)


def test_async_server_replays_from_the_harness_records(job):
    out = job[0]
    docs = chip_smoke._ranks(out, "async")
    pushes, keys, equal = chip_smoke.replay_async(out)
    assert pushes == docs[0]["stats"]["updates"] > 0
    assert equal == keys > 0


def test_legs_ranks_agree_and_builds_are_timed_apart(job):
    out = job[0]
    for leg in ("gpt", "resnet"):
        a, b = chip_smoke._ranks(out, leg)
        assert a["params"] == b["params"] and a["aux"] == b["aux"]
        assert a["losses"] == b["losses"]
        assert 0 < a["build_s"] and len(a["step_wall_s"]) == a["steps"]
    assert all(d["context_s"] >= 0 for d in chip_smoke._ranks(out, "gpt"))
    m0, m1 = chip_smoke._ranks(out, "module")
    assert m0["overlap0"]["params"] == m0["overlap1"]["params"] \
        == m1["overlap1"]["params"]
    state = np.load(os.path.join(out, "resnet.state1.npz"))
    assert any(k.startswith("aux:") for k in state.files)
