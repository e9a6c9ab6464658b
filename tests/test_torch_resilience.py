"""The port's ``resilience`` module against ``mxnet_tpu.resilience``, on
the CPU: the same fault specs give the same injection sequences, the same
seeds the same backoff delays; retries, deadlines and timeouts behave
alike; a manifest written by either package verifies under the other's
``verify_manifest`` (and the two packages write the same bytes for the
same files); an injected ``checkpoint.save`` fault leaves the last good
epoch loadable; a truncated or bit-flipped ``.params`` is named in the
error; the ``recordio.read`` seam drops the same records in both
readers."""
import json
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import resilience as jres

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import io_resume, resilience as pres
from mxnet_tpu_torch.base import MXNetError

SPECS = [
    "checkpoint.save:n=1",
    "recordio.read:p=0.3,seed=7",
    "io.prefetch:p=0.5,seed=3,n=4,after=2",
    "trainer.step:after=5;io.resume:p=0.25,seed=11",
]


@pytest.fixture(autouse=True)
def _disarmed(monkeypatch):
    monkeypatch.delenv("MXNET_TPU_FAULTS", raising=False)
    for mod in (jres, pres):
        mod.clear_faults()
    yield
    for mod in (jres, pres):
        mod.clear_faults()
    jmx.io_resume.clear_pending()
    io_resume.clear_pending()


def _sequence(mod, spec, sites, n=40):
    mod.configure_faults(spec)
    fired = []
    for i in range(n):
        for site in sites:
            try:
                mod.fault_point(site)
            except mod.FaultInjected as e:
                fired.append((i, site, e.hit))
    return fired, {k: v for k, v in mod.fault_stats().items()
                   if not k.startswith("mxtpu_")}


@pytest.mark.parametrize("spec", SPECS)
def test_same_spec_same_injections(spec):
    sites = sorted({p.split(":")[0] for p in spec.split(";")})
    want = _sequence(jres, spec, sites)
    got = _sequence(pres, spec, sites)
    assert got == want and want[0]
    assert pres.KNOWN_SITES == jres.KNOWN_SITES


def test_the_environment_arms_the_sites(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_FAULTS", "trainer.step:n=2")
    assert pres.faults_active()
    hits = 0
    for _ in range(5):
        try:
            pres.fault_point("trainer.step")
        except pres.FaultInjected:
            hits += 1
    assert hits == 2
    assert pres.fault_stats()["trainer.step"] == {"calls": 5, "hits": 2}
    assert tmx.config.describe()["MXNET_TPU_FAULTS"][1] == "honored"


def test_delay_sites_sleep_instead_of_raising():
    pres.configure_faults("io.decode:kind=delay,delay=0.01,n=1")
    pres.fault_point("io.decode")          # sleeps, does not raise
    assert pres.fault_stats()["io.decode"]["hits"] == 1


@pytest.mark.parametrize("spec", ["trainer.step:p", "trainer.step:q=1",
                                  "trainer.step:kind=crash"])
def test_bad_specs_raise_in_both(spec):
    for mod, err in ((jres, jmx.base.MXNetError), (pres, MXNetError)):
        with pytest.raises(err):
            mod.configure_faults(spec)


@pytest.mark.parametrize("kw", [{}, {"seed": 3}, {"seed": 5, "jitter": 0.5},
                                {"base": 0.2, "factor": 3.0, "max_delay": 1.0,
                                 "seed": 9}, {"jitter": 0.0}])
def test_backoff_delays_equal_for_the_same_seed(kw):
    want = [next(d) for d in [jres.backoff_delays(**kw)] for _ in range(12)]
    got = [next(d) for d in [pres.backoff_delays(**kw)] for _ in range(12)]
    if "seed" in kw or kw.get("jitter") == 0.0:
        assert got == want
    assert all(0 < g <= kw.get("max_delay", 2.0) * 1.5 for g in got)


def _flaky(failures):
    calls = []

    def fn(x):
        calls.append(x)
        if len(calls) <= failures:
            raise IOError("flake %d" % len(calls))
        return x * 2
    return fn, calls


@pytest.mark.parametrize("failures,retries,ok", [(0, 3, True), (2, 3, True),
                                                 (4, 3, False)])
def test_retry_call_behaves_alike(failures, retries, ok):
    for mod, err in ((jres, jmx.base.MXNetError), (pres, MXNetError)):
        fn, calls = _flaky(failures)
        if ok:
            assert mod.retry_call(fn, args=(4,), retries=retries,
                                  base_delay=0.001, seed=0,
                                  on_retry=lambda *a: None) == 8
        else:
            with pytest.raises(err, match="fn failed after 4 attempt"):
                mod.retry_call(fn, args=(4,), retries=retries,
                               base_delay=0.001, seed=0,
                               on_retry=lambda *a: None)
        assert len(calls) == min(failures, retries) + 1


def test_no_retry_and_the_decorator():
    fn, calls = _flaky(5)
    with pytest.raises(IOError):
        pres.retry_call(fn, args=(1,), no_retry=(IOError,))
    assert len(calls) == 1
    fn, calls = _flaky(1)
    wrapped = pres.retryable(retries=2, base_delay=0.001,
                             on_retry=lambda *a: None)(fn)
    before = pres.fault_stats()["mxtpu_retry_total"].get("fn", 0)
    assert wrapped(3) == 6 and len(calls) == 2
    assert pres.fault_stats()["mxtpu_retry_total"]["fn"] == before + 1


def test_deadline_and_timeout():
    import time
    assert pres.Deadline(None).remaining() is None
    d = pres.Deadline(0.0)
    assert d.expired() and d.remaining() == 0.0
    with pytest.raises(pres.TimeoutError, match="slow did not complete"):
        pres.with_timeout(lambda: time.sleep(0.5), 0.05, name="slow")
    assert pres.with_timeout(lambda: 5, 1.0) == 5
    with pytest.raises(ZeroDivisionError):
        pres.with_timeout(lambda: 1 / 0, 1.0)


def _files(tmp_path, tag):
    rng = np.random.RandomState(0)
    arrays = {"arg:w": rng.randn(3, 4).astype(np.float32),
              "aux:m": np.arange(5, dtype=np.float32)}
    prefix = str(tmp_path / tag)
    path = "%s-0003.params" % prefix
    with open(path, "wb") as f:
        f.write(rng.bytes(1000))
    return prefix, path, arrays


@pytest.mark.parametrize("writer,reader", [(pres, jres), (jres, pres)])
def test_manifests_verify_across_packages(writer, reader, tmp_path):
    prefix, path, arrays = _files(tmp_path, "m")
    meta = {"mesh": {"format": 2, "axes": {"data": 1}, "world": 1},
            "data_state": {"v": 1, "state": None, "position": None}}
    writer.write_manifest(prefix, 3, [path], arrays=arrays, meta=meta)
    doc = reader.verify_manifest(prefix, 3)
    assert doc["format"] == 2 and doc["meta"] == meta
    assert doc["arrays"]["arg:w"]["shape"] == [3, 4]
    assert reader.array_crc32(arrays["arg:w"]) == \
        writer.array_crc32(arrays["arg:w"])


def test_both_packages_write_the_same_manifest(tmp_path):
    prefix, path, arrays = _files(tmp_path, "same")
    out = []
    for mod in (jres, pres):
        p = mod.write_manifest(prefix, 3, [path], arrays=arrays,
                               meta={"note": "x"})
        with open(p, "rb") as f:
            out.append(f.read())
    assert out[0] == out[1]


@pytest.mark.parametrize("damage", ["truncate", "flip", "delete"])
def test_a_damaged_params_file_is_named(damage, tmp_path):
    prefix, path, arrays = _files(tmp_path, "d")
    pres.write_manifest(prefix, 3, [path], arrays=arrays)
    if damage == "truncate":
        with open(path, "r+b") as f:
            f.truncate(500)
    elif damage == "flip":
        with open(path, "r+b") as f:
            f.seek(10)
            b = f.read(1)
            f.seek(10)
            f.write(bytes([b[0] ^ 1]))
    else:
        os.remove(path)
    for mod, err in ((pres, MXNetError), (jres, jmx.base.MXNetError)):
        with pytest.raises(err, match="d-0003.params"):
            mod.verify_manifest(prefix, 3)
    if damage == "flip":
        assert pres.verify_manifest(prefix, 3, quick=True) is not None


def test_a_corrupt_manifest_raises_and_none_is_legacy(tmp_path):
    prefix = str(tmp_path / "c")
    assert pres.verify_manifest(prefix, 1) is None
    with open(pres.manifest_path(prefix, 1), "w") as f:
        f.write("{not json")
    with pytest.raises(MXNetError, match="corrupt checkpoint manifest"):
        pres.load_manifest(prefix, 1)


def _module_checkpoint(prefix, epoch, value):
    net = tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=3,
                                 name="fc")
    args = {"fc_weight": tmx.nd.array(np.full((3, 4), value, np.float32),
                                      ctx=tmx.cpu()),
            "fc_bias": tmx.nd.zeros((3,), ctx=tmx.cpu())}
    tmx.model.save_checkpoint(prefix, epoch, net, args, {})


def test_an_injected_save_fault_leaves_the_last_epoch_loadable(tmp_path):
    prefix = str(tmp_path / "ck")
    _module_checkpoint(prefix, 1, 1.0)
    pres.configure_faults("checkpoint.save:n=1")
    with pytest.raises(pres.FaultInjected):
        _module_checkpoint(prefix, 2, 2.0)
    # the crash residue: the temporary file, never renamed, no manifest
    assert any(".params.tmp." in f for f in os.listdir(tmp_path))
    assert not os.path.exists("%s-0002.params" % prefix)
    assert tmx.model.find_checkpoints(prefix) == [1]
    ep, _sym, args, _aux = tmx.model.load_latest_checkpoint(prefix)
    assert ep == 1 and float(args["fc_weight"].asnumpy()[0, 0]) == 1.0
    # the JAX loader takes the port's checkpoint, manifest and all
    assert jmx.model.load_latest_checkpoint(prefix)[0] == 1
    _module_checkpoint(prefix, 2, 2.0)         # the fault was spent
    assert tmx.model.find_latest_checkpoint(prefix) == 2


def test_latest_checkpoint_falls_back_past_a_bad_crc(tmp_path):
    prefix = str(tmp_path / "fb")
    for ep in (1, 2):
        _module_checkpoint(prefix, ep, float(ep))
    with open("%s-0002.params" % prefix, "r+b") as f:
        f.seek(-4, 2)
        f.write(b"\xff\xfe\xfd\xfc")
    assert tmx.model.find_checkpoints(prefix) == [1, 2]   # sizes screen
    assert tmx.model.find_latest_checkpoint(prefix) == 1
    assert tmx.model.load_latest_checkpoint(prefix)[0] == 1
    with pytest.raises(MXNetError, match="fb-0002.params"):
        tmx.model.load_checkpoint(prefix, 2)


def test_the_load_seam_fires(tmp_path):
    prefix = str(tmp_path / "ls")
    _module_checkpoint(prefix, 1, 1.0)
    pres.configure_faults("checkpoint.load:n=1")
    with pytest.raises(pres.FaultInjected):
        tmx.model.load_checkpoint(prefix, 1)
    assert tmx.model.load_checkpoint(prefix, 1)[1]["fc_bias"].shape == (3,)


def _write_rec(path, n=30):
    w = tmx.recordio.MXRecordIO(path, "w")
    for i in range(n):
        w.write(tmx.recordio.pack(tmx.recordio.IRHeader(0, float(i), i, 0),
                                  bytes([i]) * (7 + i)))
    w.close()


def _read_all(mod, path, spec, quota):
    mod.resilience.configure_faults(spec)
    r = mod.recordio.MXRecordIO(path, "r", skip_bad_records=quota)
    out = []
    while True:
        rec = r.read()
        if rec is None:
            break
        out.append(mod.recordio.unpack(rec)[0].id)
    return out, r.bad_records


def test_the_recordio_seam_drops_the_same_records(tmp_path):
    path = str(tmp_path / "seam.rec")
    _write_rec(path)
    spec = "recordio.read:p=0.2,seed=4"
    want = _read_all(jmx, path, spec, 100)
    got = _read_all(tmx, path, spec, 100)
    assert got == want and 0 < got[1] < 30 and len(got[0]) == 30 - got[1]
    with pytest.raises(pres.FaultInjected):
        _read_all(tmx, path, spec, 0)          # strict: the fault raises


def test_native_reader_seam_counts_against_the_quota(tmp_path):
    from mxnet_tpu_torch import io_native
    if not io_native.available():
        pytest.skip("the port's native library did not build here")
    path = str(tmp_path / "nat.rec")
    _write_rec(path)
    pres.configure_faults("recordio.read:p=0.2,seed=4")
    r = io_native.NativeRecordIOReader(path, skip_bad_records=100)
    ids = []
    while True:
        rec = r.read()
        if rec is None:
            break
        ids.append(tmx.recordio.unpack(rec)[0].id)
    pres.configure_faults("recordio.read:p=0.2,seed=4")
    want, bad = _read_all(tmx, path, "recordio.read:p=0.2,seed=4", 100)
    assert ids == want and r.bad_records == bad
    r.close()


def test_io_resume_seam_leaves_the_iterator_restorable():
    it = tmx.io.NDArrayIter(np.arange(20, dtype=np.float32).reshape(10, 2),
                            batch_size=2)
    next(it)
    st = it.state()
    fresh = tmx.io.NDArrayIter(np.arange(20, dtype=np.float32)
                               .reshape(10, 2), batch_size=2)
    pres.configure_faults("io.resume:n=1")
    with pytest.raises(MXNetError, match="io.resume seam"):
        io_resume.restore_iterator(fresh, st)
    assert fresh.state()["offset"] == 0
    io_resume.restore_iterator(fresh, st)
    assert json.dumps(fresh.state()) == json.dumps(st)
