"""chip_smoke's resume_train phase at a tiny size on the CPU: the
preemption drill of ``tools.resume_train`` (run U in this process, runs P
and R in child processes, P sent SIGTERM by this one) on ResNet-8 at
16x16, batch 4, f32, and the ``tools.train_imagenet`` checkpoint round
trip.  On the CPU every step is deterministic, so the resumed run's losses
and the state P saved equal the uninterrupted run's to the bit."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402


def test_resume_phase_at_a_tiny_size(tmp_path):
    recs, _s = chip_smoke.make_image_records(
        str(tmp_path), {"train": (24, 0), "val": (8, 1)}, size=40)
    out = chip_smoke.resume_train_phase(
        tmx.cpu(), recs, str(tmp_path), steps=4, signal_after=1,
        layers=8, image=16, batch=4, dtype="float32")
    assert out["checkpoint_epoch"] == 1
    assert out["data_state"]["offset"] == 4 == out["applied_state"]["offset"]
    assert out["batches_equal"] and out["loaded_equal_saved"]
    assert out["losses_equal"] and out["u_state_equals_p_saved"]
    assert out["p_batches_equal_u"] and len(out["losses_p"]) == 1
    assert not out["control_dropped_state_batches_equal"]
    assert out["cli"]["verified"] == {1: True, 2: True}
    assert out["cli"]["epochs_second"] == [1]
    assert out["checkpoint_total_bytes"] > 0
