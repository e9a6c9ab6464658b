"""The port's ShardedTrainer over a data axis of two processes (gloo on the
CPU, through ``mxnet_tpu_torch/tools/launch.py``) against the JAX
package's ShardedTrainer run in one process on the global batch.

One job (``tests/torch_dist_train.py legs``) trains three nets from the
JAX trainers' initial states, each with ``MXNET_TPU_OVERLAP`` off and on:
an MLP, a small conv net with BatchNorm (NCHW; its batch statistics span
the ranks), and the same net NHWC under block fusion (its 1x1 block on
K5, the plain version here, whose column sums are all-reduced).

Tolerances, f32: the losses step by step rtol 1e-5 (each rank reduces its
half of the batch, then the halves are added: another order of the same
sums); parameters and moving statistics by the norm of the difference
over all arrays against the JAX state's norm, 1e-5.  The ranks' arrays
are equal to the bit, and so are the runs with overlap off and on.  Rank
0's checkpoint loads in the JAX package.
"""
import os
import sys

import numpy as np
import pytest

import torch_threads  # noqa: F401  (xdist workers share the cores)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer  # noqa: E402
from mxnet_tpu.parallel import build_mesh as jax_build_mesh  # noqa: E402

import torch_dist_common  # noqa: E402
import torch_dist_train as w  # noqa: E402

NETS = list(w.NETS)


def _jax_trainer(net):
    build, _row, opts = w.NETS[net]
    np.random.seed(0)
    return JaxTrainer(build(jmx.sym), jax_build_mesh(n_devices=1),
                      dtype="float32", **w.shapes(net), **w.SGD, **opts)


def _jax_state(jt):
    out = {"arg:" + k: np.asarray(v) for k, v in jt.params.items()}
    out.update({"aux:" + k: np.asarray(v) for k, v in jt.aux.items()})
    return out


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The two-rank job's outputs beside the JAX runs' losses and final
    states."""
    out = str(tmp_path_factory.mktemp("dist_trainer"))
    jax = {}
    for net in NETS:
        jt = _jax_trainer(net)
        np.savez(os.path.join(out, "init_%s.npz" % net), **_jax_state(jt))
        jax[net] = jt
    res = torch_dist_common.launch(
        [os.path.join(ROOT, "tests", "torch_dist_train.py"), "legs", out],
        timeout=150)
    assert res.returncode == 0, res.stderr[-4000:]
    for net, jt in jax.items():
        losses = [float(jt.step(b)) for b in w.batches(net)]
        jax[net] = (losses, _jax_state(jt))
    return out, jax


def _load(out, net, overlap, r):
    return dict(np.load(os.path.join(
        out, "%s-overlap%d.rank%d.npz" % (net, overlap, r))))


def _rel(got, want, prefix):
    keys = sorted(k for k in want if k.startswith(prefix))
    a = np.concatenate([got[k].ravel() for k in keys])
    b = np.concatenate([want[k].ravel() for k in keys])
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("net", NETS)
def test_two_ranks_match_jax_on_the_global_batch(job, net):
    out, jax = job
    jl, jstate = jax[net]
    got = _load(out, net, 0, 0)
    np.testing.assert_allclose(got["losses"], jl, rtol=1e-5)
    assert _rel(got, jstate, "arg:") <= 1e-5
    if net != "mlp":
        assert _rel(got, jstate, "aux:") <= 1e-5
        # the moving statistics moved: the batch's statistics reached them
        assert _rel(got, _jax_state(_jax_trainer(net)), "aux:") > 1e-3


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("overlap", [0, 1])
def test_ranks_equal_to_the_bit(job, net, overlap):
    out, _jax = job
    a, b = (_load(out, net, overlap, r) for r in (0, 1))
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("net", NETS)
def test_overlap_on_and_off_give_the_same_bits(job, net):
    out, _jax = job
    off, on = (_load(out, net, overlap, 0) for overlap in (0, 1))
    for k in off:
        assert np.array_equal(off[k], on[k]), k


def test_ranks_start_from_rank0s_state(job):
    out, _jax = job
    a, b = (np.load(os.path.join(out, "seeded.rank%d.npz" % r))
            for r in (0, 1))
    own = w.state(w.trainer("convbn", seed=1))     # what seed 1 draws
    assert any(not np.array_equal(b[k], own[k]) for k in own)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_the_mesh_spans_the_processes(job):
    import json
    out, _jax = job
    for r in (0, 1):
        doc = json.load(open(os.path.join(out, "job.rank%d.json" % r)))
        assert doc == {"mesh": {"data": 2, "model": 1}, "world": 2,
                       "rank": r, "backend": "gloo"}


def test_rank0_checkpoint_loads_in_jax(job):
    out, _jax = job
    saved = _load(out, "mlp", 0, 0)
    jt = _jax_trainer("mlp")
    jt.load_checkpoint(os.path.join(out, "ckpt"), w.STEPS,
                       load_optimizer_states=True)
    for k, v in _jax_state(jt).items():
        np.testing.assert_array_equal(v, saved[k])
    assert jt.optimizer.begin_num_update == w.STEPS
