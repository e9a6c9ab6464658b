"""The port's ``parallel/overlap.py`` against the JAX package's, in process.

The bucket plan, the scheduler's drain order and the bucket queue's
launches are fleet-agreed decisions: a rank that planned or ordered
otherwise would deadlock its peers.  Each is held equal to the JAX
function's on the same sizes, skews and pushes, with the collective
replaced by the same fake transport in both packages: the plans, the
orders, the launch sequences (bucket, keys, phase) and the drained sums.
The overlap-on and overlap-off parity of real collectives is held by the
two-rank jobs of ``test_torch_dist_trainer.py`` and
``test_torch_dist_kvstore.py``.
"""
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mxnet_tpu.base import MXNetError as JaxError  # noqa: E402
from mxnet_tpu.parallel import overlap as jov  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.parallel import overlap as tov  # noqa: E402

SIZES = [
    [("a", 100), ("b", 3000), ("c", 5000), ("d", 10), ("e", 9000)],
    [(i, (i * 7919) % 4096) for i in range(40)],
    [("big", 1 << 30), ("s", 1), ("t", 0), ("u", -5)],
    [],
]


@pytest.mark.parametrize("sizes", SIZES)
@pytest.mark.parametrize("target", [None, 1, 4096, 8000, 1 << 40])
def test_plan_buckets_equal_jax(sizes, target):
    assert tov.plan_buckets(sizes, target) == jov.plan_buckets(sizes,
                                                               target)


@pytest.mark.parametrize("seed", range(4))
def test_scheduler_order_equal_jax(seed):
    rng = np.random.RandomState(seed)
    port, jax = tov.OverlapScheduler(alpha=0.3), jov.OverlapScheduler(0.3)
    for _ in range(30):
        b = int(rng.randint(0, 6))
        skew = None if rng.rand() < 0.1 else float(rng.exponential(0.01))
        port.observe_skew(b, skew)
        jax.observe_skew(b, skew)
        ids = sorted(rng.choice(8, size=int(rng.randint(1, 8)),
                                replace=False).tolist())
        assert port.order(ids) == jax.order(ids)
        assert port.cost(b) == jax.cost(b)


def _transport(log):
    """A collective stand-in: doubles each value, logs the launch."""
    def reduce_fn(bucket):
        log.append(sorted(bucket, key=str))
        out = {k: np.asarray(v) * 2 for k, v in bucket.items()}
        return lambda: out
    return reduce_fn


def _drive(mod, pushes, target, cap, skews):
    log = []
    it = iter(skews)

    def probe():
        s = next(it, None)
        return None if s is None else {"skew_s": s, "wait_s": 0.0}
    q = mod.BucketQueue(_transport(log), target_bytes=target,
                        skew_probe=probe, inflight_cap=cap)
    results = []
    for step in pushes:
        for k, n in step:
            q.push(k, np.full(3, float(n)), n)
        pending = q.pending
        got = q.drain()
        results.append((pending, {k: v.tolist() for k, v in got.items()}))
    return log, results


@pytest.mark.parametrize("target", [1, 50, 1 << 20])
@pytest.mark.parametrize("cap", [0, 1, 2])
def test_bucket_queue_launches_equal_jax(target, cap):
    step = [("w%d" % i, 10 * (i + 1)) for i in range(7)]
    skews = [0.001 * ((i * 5) % 7) for i in range(40)]
    assert _drive(tov, [step, step, step[::-1]], target, cap, skews) == \
        _drive(jov, [step, step, step[::-1]], target, cap, skews)


def test_duplicate_key_and_failed_drain_as_jax():
    for mod, err in ((tov, MXNetError), (jov, JaxError)):
        q = mod.BucketQueue(_transport([]), target_bytes=1 << 20,
                            skew_probe=lambda: None)
        q.push("a", np.ones(2), 8)
        with pytest.raises(err, match="already holds key"):
            q.push("a", np.ones(2), 8)
        q.drain()

        def broken(bucket):
            def handle():
                raise RuntimeError("peer gone")
            return handle
        q = mod.BucketQueue(broken, target_bytes=1,
                            skew_probe=lambda: None)
        q.push("a", np.ones(2), 8)
        with pytest.raises(err, match="optimizer state is untouched"):
            q.drain()
        assert q.pending == 0


def test_knobs_read_as_jax(monkeypatch):
    for env in ({}, {"MXNET_TPU_OVERLAP": "0"},
                {"MXNET_TPU_BUCKET_BYTES": "1234",
                 "MXNET_TPU_OVERLAP_INFLIGHT": "3"},
                {"MXNET_TPU_BUCKET_BYTES": "x",
                 "MXNET_TPU_OVERLAP_INFLIGHT": "y"}):
        for k in ("MXNET_TPU_OVERLAP", "MXNET_TPU_BUCKET_BYTES",
                  "MXNET_TPU_OVERLAP_INFLIGHT"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for fn in ("overlap_enabled", "bucket_bytes", "max_inflight"):
            assert getattr(tov, fn)() == getattr(jov, fn)(), (env, fn)
