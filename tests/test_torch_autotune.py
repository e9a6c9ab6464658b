"""``mxnet_tpu_torch.autotune.measure``, the experiments' timing runner, on
the CPU: one untimed call, then ``repeats`` samples of ``chain`` calls, the
least sample divided by ``chain``."""
import time

import pytest

from mxnet_tpu_torch.autotune import measure


@pytest.mark.parametrize("repeats,chain", [(1, 1), (3, 4)])
def test_measure_counts_calls_and_divides_by_chain(repeats, chain):
    calls = []

    def fn(x):
        calls.append(x)
        time.sleep(0.002)

    t = measure(fn, (7,), repeats=repeats, chain=chain)
    assert calls == [7] * (1 + repeats * chain)
    assert 0.002 <= t < 0.05


def test_measure_takes_the_least_sample():
    sleeps = iter([0.0, 0.03, 0.002, 0.03])

    def fn():
        time.sleep(next(sleeps))

    assert 0.002 <= measure(fn, repeats=3) < 0.02
