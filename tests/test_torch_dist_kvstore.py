"""The port's ``dist_sync`` store and the Module's data parallelism against
numpy and the JAX package, on the CPU.

One two-rank job (gloo, through ``mxnet_tpu_torch/tools/launch.py``; the
worker is ``tests/torch_dist_kvstore.py sync``): each push of three keys
(two local values each, one key of 1.2M entries) is one collective and
its pull gives the numpy sum of both ranks' values; an SGD updater on
the store applies the same update on both ranks; ``save_state`` and
``load_state`` round-trip.  ``Module.fit`` of an MLP with ``dist_sync``
on each rank's half of every batch (``MXNET_TPU_OVERLAP`` off and on)
matches the JAX ``Module.fit`` on the global batch (rescale_grad
1/(batch x workers), as JAX sets it), and the two overlap settings give
the same bits.  ``tools.fit --kv-store dist_sync`` (Module route) on each
rank's part of every batch matches the JAX harness's fit (its
``examples/image_classification/common/fit.py``, one process) on the
global batch; its fused route (``ShardedTrainer`` on the job's data axis)
keeps the ranks equal to the bit.  In process: a Module bound to two
CPU contexts matches the JAX Module on one, and ``kv.create`` dispatches
as JAX's.

Tolerances, f32: parameters rtol 1e-5 with an atol of 1e-5 of the
array's largest entry (sums in another order), the Module test's.
"""
import json
import os
import sys

import numpy as np
import pytest

import torch_threads  # noqa: F401  (xdist workers share the cores)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402

import torch_dist_common  # noqa: E402
import torch_dist_kvstore as w  # noqa: E402

GLOBAL = 2 * w.LOCAL


def _fit(mx, contexts, batch=GLOBAL):
    x, y = w.data()
    it = mx.io.NDArrayIter(x, y, batch)
    mod = mx.mod.Module(w.mlp(mx.sym), context=contexts)
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in w.init().items()})
    args, _aux = mod.get_params()
    return {k: v.asnumpy().copy() for k, v in args.items()}


def _close(got, want):
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5,
                                   atol=1e-5 * np.abs(v).max(), err_msg=k)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dist_kvstore"))
    res = torch_dist_common.launch(
        [os.path.join(ROOT, "tests", "torch_dist_kvstore.py"), "sync", out],
        timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]
    docs = [json.load(open(os.path.join(out, "sync.rank%d.json" % r)))
            for r in (0, 1)]
    return out, docs


def test_push_sums_across_ranks_in_one_collective(job):
    out, docs = job
    want = {k: sum(sum(w.rank_values(r)[k]) for r in (0, 1))
            for k in w.KEYS}
    for r, doc in enumerate(docs):
        assert doc["rank"] == r and doc["num_workers"] == 2
        assert doc["type"] == "dist_sync"
        assert doc["collectives_a_push"] == 1
        assert doc["collectives_an_update"] == 1
        got = np.load(os.path.join(out, "sums.rank%d.npz" % r))
        for k, v in want.items():
            np.testing.assert_allclose(got[str(k)], v, rtol=1e-6,
                                       atol=1e-6)


def test_the_updater_runs_on_every_rank(job):
    out, _docs = job
    sums = np.load(os.path.join(out, "sums.rank0.npz"))
    a, b = (np.load(os.path.join(out, "updated.rank%d.npz" % r))
            for r in (0, 1))
    for k in sums.files:
        np.testing.assert_array_equal(a[k], b[k])
        want = sums[k] - np.float32(0.5) * (np.float32(0.25) * sums[k])
        np.testing.assert_allclose(a[k], want, rtol=1e-6, atol=1e-6)


def test_state_round_trip(job):
    _out, docs = job
    for doc in docs:
        assert doc["loaded_world"] == 2 and doc["loaded_equal"]


def test_module_dist_sync_matches_jax_on_the_global_batch(job):
    out, docs = job
    np.random.seed(0)
    want = _fit(jmx, jmx.cpu())
    for r in (0, 1):
        _close(dict(np.load(os.path.join(out, "fit-overlap0.rank%d.npz"
                                         % r))), want)
    assert [d["overlap_active0"] for d in docs] == [False, False]
    assert [d["overlap_active1"] for d in docs] == [True, True]


@pytest.mark.parametrize("r", [0, 1])
def test_module_overlap_on_and_off_give_the_same_bits(job, r):
    out, _docs = job
    off, on = (np.load(os.path.join(out, "fit-overlap%d.rank%d.npz"
                                    % (o, r))) for o in (0, 1))
    other = np.load(os.path.join(out, "fit-overlap1.rank%d.npz" % (1 - r)))
    for k in off.files:
        np.testing.assert_array_equal(off[k], on[k])
        np.testing.assert_array_equal(on[k], other[k])


def test_two_contexts_match_jax_on_one():
    np.random.seed(0)
    want = _fit(jmx, jmx.cpu())
    got = _fit(tmx, [tmx.cpu(0), tmx.cpu(1)])
    _close(got, want)


def test_create_dispatches_as_jax(monkeypatch):
    from mxnet_tpu_torch.parallel.dist_kvstore import DistKVStore
    from mxnet_tpu_torch.base import MXNetError
    monkeypatch.delenv("MXNET_TPU_COORDINATOR", raising=False)
    monkeypatch.setenv("MXNET_TPU_NUM_PROCESSES", "1")
    for name in ("dist_sync", "dist_device_sync", "dist_async"):
        kv = tmx.kv.create(name)
        assert isinstance(kv, DistKVStore) and kv.type == name
        assert (kv.rank, kv.num_workers) == (0, 1)
        assert not kv.overlap_active
    assert type(tmx.kv.create("local")) is tmx.kv.KVStore
    with pytest.raises(MXNetError, match="unknown kvstore"):
        tmx.kv.create("nonsense")
    monkeypatch.setenv("MXNET_TPU_NUM_PROCESSES", "2")
    with pytest.raises(MXNetError, match="COORDINATOR"):
        tmx.kv.create("dist_sync")


def test_fit_tool_dist_sync_matches_the_jax_harness(job, monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(ROOT, "examples",
                                             "image_classification"))
    from common import fit as jfit
    out, _docs = job
    args = w.fit_args(jfit.add_fit_args, 0, GLOBAL)
    x, y = w.data()
    np.random.seed(0)     # the JAX Xavier draws from the global generator
    mod = jfit.fit(args, w.mlp(jmx.sym),
                   lambda a, kv: (jmx.io.NDArrayIter(x, y, GLOBAL), None))
    want = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    for r in (0, 1):
        _close(dict(np.load(os.path.join(out, "tool-fused0.rank%d.npz"
                                         % r))), want)
    a, b = (np.load(os.path.join(out, "tool-fused1.rank%d.npz" % r))
            for r in (0, 1))
    assert len(a["losses"]) == 4 and np.isfinite(a["losses"]).all()
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_fit_gpus_lists(monkeypatch):
    """``--gpus`` lists give the Module route a context a card; the fused
    route takes one device a process (inside a launched job the rank's
    card) and refuses several, naming the launcher."""
    import argparse
    import torch
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.tools import fit as pfit
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("MXNET_TPU_NUM_PROCESSES", raising=False)
    args = argparse.Namespace(gpus="0,2", tpus=None, cpu=0)
    assert pfit.get_contexts(args) == [tmx.gpu(0), tmx.gpu(2)]
    with pytest.raises(MXNetError, match="tools/launch.py"):
        pfit.get_context(args)
    assert pfit.get_context(argparse.Namespace(gpus="3", tpus=None,
                                               cpu=0)) == tmx.gpu(3)
    monkeypatch.setenv("MXNET_TPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("MXNET_TPU_PROCESS_ID", "1")
    assert pfit.get_context(args) == tmx.gpu(1)
    assert pfit.get_contexts(argparse.Namespace(gpus="0,2", tpus=None,
                                                cpu=1)) == [tmx.cpu()]
