"""Durable iterator state (``io_resume``) in the port against the JAX
package, on the CPU.

For each iterator of ``recordio``, ``io_native``, ``io`` and ``image``:
consume k batches (or records), take ``state()``, restore a fresh
iterator, and it yields the uninterrupted remainder; the state dict equals
the JAX iterator's at the same point, and restores in the other package to
the same remainder.  The wrappers (``PrefetchingIter``,
``DevicePrefetchIter``) report the state from before the batches they
fetched ahead.  The ledger functions (``epoch_permutation``,
``rank_stream``, ``remap_cursor``, ``remap_state``, ``ShardedLedgerIter``,
``SampleAccountant``) equal JAX's over several (old, new) world pairs, and
a checkpoint saved mid-epoch resumes ``Module.fit`` at the next sample,
from either package's checkpoint."""
import io as _pyio
import json
import random
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import io_resume as jior

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import io_resume as pior
from mxnet_tpu_torch.base import MXNetError


@pytest.fixture(autouse=True)
def _clean_stash():
    yield
    jior.clear_pending()
    pior.clear_pending()
    pior.track(None)


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def _arrays(b):
    """A batch (DataBatch or a staged dict) as a tuple of numpy arrays."""
    if isinstance(b, dict):
        return tuple(np.asarray(b[k]) for k in sorted(b)) + (None,)
    return tuple(d.asnumpy() for d in list(b.data) + list(b.label or [])) \
        + (b.pad,)


def _take(it, k):
    return [_arrays(next(it)) for _ in range(k)]


def _rest(it):
    out = []
    while True:
        try:
            out.append(_arrays(next(it)))
        except StopIteration:
            return out


def _same(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w) and g[-1] == w[-1]
        for a, b in zip(g[:-1], w[:-1]):
            np.testing.assert_array_equal(a, b)


def _json(st):
    return json.loads(json.dumps(st))


# ----------------------------------------------------------- data sources
def _xy(n=23, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3, 2).astype(np.float32),
            rng.randint(0, 5, n).astype(np.float32))


def _write_idx(path, arr, magic):
    with open(path, "wb") as f:
        f.write(struct.pack(">i", magic))
        f.write(struct.pack(">" + "i" * arr.ndim, *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


def _jpeg(img):
    from PIL import Image
    buf = _pyio.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("resume")
    rng = np.random.RandomState(1)
    out = {"img": str(d / "img"), "lab": str(d / "lab"),
           "csv": str(d / "d.csv"), "csv_lab": str(d / "l.csv"),
           "rec": str(d / "a.rec"), "idx": str(d / "a.idx")}
    _write_idx(out["img"], rng.randint(0, 256, (30, 28, 28)), 2051)
    _write_idx(out["lab"], rng.randint(0, 10, (30,)), 2049)
    x, y = _xy(11)
    np.savetxt(out["csv"], x.reshape(11, -1), delimiter=",")
    np.savetxt(out["csv_lab"], y, delimiter=",")
    w = tmx.recordio.MXIndexedRecordIO(out["idx"], out["rec"], "w")
    for i in range(21):
        img = rng.randint(0, 255, (20 + i % 3, 24, 3), dtype=np.uint8)
        w.write_idx(i, tmx.recordio.pack(
            tmx.recordio.IRHeader(0, float(i % 5), i, 0), _jpeg(img)))
    w.close()
    return out


# the iterators, built alike in either package: (make(mx, files), k)
def _ndarray(mx, f, **kw):
    x, y = _xy()
    return mx.io.NDArrayIter(x, y, batch_size=4, **kw)


ITERS = {
    "ndarray": (lambda mx, f: _ndarray(mx, f), 2),
    "ndarray_discard": (lambda mx, f: _ndarray(
        mx, f, last_batch_handle="discard"), 3),
    "resize": (lambda mx, f: mx.io.ResizeIter(_ndarray(mx, f), 9), 7),
    "prefetch_one": (lambda mx, f: mx.io.PrefetchingIter(_ndarray(mx, f)),
                     2),
    "prefetch_two": (lambda mx, f: mx.io.PrefetchingIter(
        [_ndarray(mx, f), mx.io.NDArrayIter({"x2": _xy()[0] * 2},
                                            batch_size=4)],
        rename_data=[{"data": "a"}, {"x2": "b"}]), 3),
    "mnist": (lambda mx, f: mx.io.MNISTIter(
        image=f["img"], label=f["lab"], batch_size=8, shuffle=True,
        seed=3), 2),
    "csv": (lambda mx, f: mx.io.CSVIter(
        data_csv=f["csv"], data_shape=(3, 2), label_csv=f["csv_lab"],
        batch_size=4), 1),
    "image_iter_rec": (lambda mx, f: mx.image.ImageIter(
        batch_size=4, data_shape=(3, 16, 16), path_imgrec=f["rec"],
        resize=16), 2),
    "image_iter_shuffle": (lambda mx, f: mx.image.ImageIter(
        batch_size=4, data_shape=(3, 16, 16), path_imgrec=f["rec"],
        path_imgidx=f["idx"], shuffle=True, resize=16), 3),
    "image_iter_shard": (lambda mx, f: mx.image.ImageIter(
        batch_size=3, data_shape=(3, 16, 16), path_imgrec=f["rec"],
        path_imgidx=f["idx"], num_parts=2, part_index=1, resize=16), 1),
}


def _native(mx, f, **kw):
    from mxnet_tpu_torch import io_native
    if not io_native.jpeg_available():
        pytest.skip("the port's native library has no JPEG decoder here")
    return mx.io.ImageRecordIter(
        path_imgrec=f["rec"], data_shape=(3, 16, 16), batch_size=4,
        preprocess_threads=1, shuffle=True, rand_crop=True,
        rand_mirror=True, seed=5, **kw)


ITERS["image_record"] = (_native, 2)
ITERS["image_record_raw"] = (lambda mx, f: _native(mx, f, raw_uint8=True),
                             3)


def _build(name, mod, files, epochs_done=0):
    _seed(11)
    it = ITERS[name][0](mod, files)
    for _ in range(epochs_done):
        _rest(it)
        it.reset()
    return it


@pytest.mark.parametrize("epochs_done", [0, 1])
@pytest.mark.parametrize("name", sorted(ITERS))
def test_state_restores_the_remainder_in_both_packages(name, epochs_done,
                                                       files):
    k = ITERS[name][1]
    port = _build(name, tmx, files, epochs_done)
    jax = _build(name, jmx, files, epochs_done)
    _same(_take(port, k), _take(jax, k))
    st, jst = _json(port.state()), _json(jax.state())
    assert st == jst
    want = _rest(port)
    for mod, state in ((tmx, st), (tmx, jst), (jmx, st)):
        fresh = _build(name, mod, files)
        fresh.restore(state)
        got = _rest(fresh)
        if want:
            _same(got, want)
        else:
            assert got == []


def test_an_image_record_offset_off_a_batch_boundary(files):
    port, jax = _build("image_record", tmx, files), \
        _build("image_record", jmx, files)
    st = dict(port.state(), offset=5)
    port.restore(st)
    jax.restore(st)
    assert port.state() == jax.state() == st
    _same(_rest(port), _rest(jax))


def test_an_image_record_state_of_another_shard_raises(files):
    it = _build("image_record", tmx, files)
    st = dict(it.state(), num_shards=2)
    with pytest.raises(MXNetError, match="shard"):
        it.restore(st)


def _rec_reads(r, k=None):
    out = []
    while k is None or len(out) < k:
        rec = r.read()
        if rec is None:
            break
        out.append(rec)
    return out


@pytest.mark.parametrize("indexed", [False, True])
def test_recordio_state(indexed, files):
    def make(mx):
        if indexed:
            return mx.recordio.MXIndexedRecordIO(files["idx"], files["rec"],
                                                 "r")
        return mx.recordio.MXRecordIO(files["rec"], "r")
    port, jax = make(tmx), make(jmx)
    port.reset()
    jax.reset()
    assert _rec_reads(port, 7) == _rec_reads(jax, 7)
    st, jst = port.state(), jax.state()
    assert st == jst and st["kind"] == "recordio" and st["epoch"] == 1
    want = _rec_reads(port)
    for mod, state in ((tmx, st), (tmx, jst), (jmx, st)):
        fresh = make(mod)
        fresh.restore(state)
        assert _rec_reads(fresh) == want
        assert fresh.position()["offset"] == 21
    with pytest.raises(MXNetError, match="4-aligned"):
        make(tmx).restore(dict(st, byte=3))
    with pytest.raises(MXNetError, match="kind mismatch"):
        make(tmx).restore(dict(st, kind="ndarray"))
    w = tmx.recordio.MXRecordIO(files["rec"] + ".w", "w")
    assert w.state() is None
    w.close()


def test_native_recordio_state(files):
    from mxnet_tpu_torch import io_native
    from mxnet_tpu import io_native as jio_native
    if not io_native.available():
        pytest.skip("the port's native library did not build here")
    port = io_native.NativeRecordIOReader(files["rec"])
    jax = jio_native.NativeRecordIOReader(files["rec"])
    assert _rec_reads(port, 9) == _rec_reads(jax, 9)
    st, jst = port.state(), jax.state()
    assert st == jst == {"v": 1, "kind": "native_recordio", "offset": 9}
    want = _rec_reads(port)
    for reader, state in ((io_native, st), (io_native, jst),
                          (jio_native, st)):
        fresh = reader.NativeRecordIOReader(files["rec"])
        fresh.restore(state)
        assert _rec_reads(fresh) == want
    with pytest.raises(MXNetError, match="shrank"):
        io_native.NativeRecordIOReader(files["rec"]).restore(
            dict(st, offset=99))


def test_the_base_iterator_declares_no_state():
    class Plain(tmx.io.DataIter):
        pass
    it = Plain(2)
    assert it.state() is None and it.position() is None
    it.restore(None)
    with pytest.raises(MXNetError, match="declares no durable state"):
        it.restore({"v": 1, "kind": "ndarray"})


@pytest.mark.parametrize("bad", [[], {"v": 2, "kind": "ndarray"},
                                 {"v": 1, "kind": "image"},
                                 {"v": 1, "kind": "ndarray", "epoch": 0,
                                  "offset": 99, "num_data": 23},
                                 {"v": 1, "kind": "ndarray", "epoch": 0,
                                  "offset": 0, "num_data": 5}])
def test_rejected_states_leave_the_iterator_as_it_was(bad):
    it = _ndarray(tmx, None)
    next(it)
    before = it.state()
    with pytest.raises(MXNetError):
        it.restore(bad)
    assert it.state() == before


def _prefetched(mod, it):
    return mod.io.DevicePrefetchIter(it, lambda host: host, depth=2)


def test_device_prefetch_reports_the_oldest_undelivered_batch():
    x, y = _xy(40)
    inner = tmx.io.NDArrayIter(x, y, batch_size=4)
    dp = _prefetched(tmx, inner)
    ref = tmx.io.NDArrayIter(x, y, batch_size=4)
    for k in range(1, 4):
        next(dp)
        next(ref)
        # the worker has fetched ahead of the consumer by now
        st = dp.state()
        assert st == ref.state() and st["offset"] == 4 * k
        assert dp.position() == ref.position()
    rest = _rest(dp)
    fresh = _prefetched(tmx, tmx.io.NDArrayIter(x, y, batch_size=4))
    next(fresh)                          # restore drops what it staged
    fresh.restore(st)
    _same(_rest(fresh), rest)
    for it in (dp, fresh):
        it.close()


def test_device_prefetch_state_equals_the_jax_wrappers():
    x, y = _xy(40)
    port = _prefetched(tmx, tmx.io.NDArrayIter(x, y, batch_size=4))
    jax = _prefetched(jmx, jmx.io.NDArrayIter(x, y, batch_size=4))
    for _ in range(3):
        next(port)
        next(jax)
    st, jst = port.state(), jax.state()
    assert st == jst
    want = _rest(port)
    fresh = _prefetched(jmx, jmx.io.NDArrayIter(x, y, batch_size=4))
    fresh.restore(st)
    _same(_rest(fresh), want)
    for it in (port, jax, fresh):
        getattr(it, "close", it._cancel_worker)()


def test_device_prefetch_restore_of_a_bad_state_raises():
    x, y = _xy(40)
    dp = _prefetched(tmx, tmx.io.NDArrayIter(x, y, batch_size=4))
    next(dp)
    with pytest.raises(MXNetError, match="kind mismatch"):
        dp.restore({"v": 1, "kind": "image"})
    dp.restore({"v": 1, "kind": "ndarray", "epoch": 0, "offset": 8,
                "num_data": 40})
    assert len(_rest(dp)) == 8
    dp.close()


# ------------------------------------------------------------ the ledger
WORLDS = [(1, 2), (2, 4), (4, 2), (3, 5), (4, 1), (5, 3)]


@pytest.mark.parametrize("seed,epoch,n", [(0, 0, 10), (7, 3, 101),
                                          (2 ** 31 - 5, 12, 37)])
def test_epoch_permutation_and_rank_streams(seed, epoch, n):
    perm = pior.epoch_permutation(seed, epoch, n)
    np.testing.assert_array_equal(perm, jior.epoch_permutation(seed, epoch,
                                                               n))
    for world in (1, 2, 3, 7):
        for rank in range(world):
            np.testing.assert_array_equal(
                pior.rank_stream(perm, rank, world),
                jior.rank_stream(perm, rank, world))
    with pytest.raises(MXNetError):
        pior.rank_stream(perm, 3, 3)


def test_remap_cursor_over_a_grid():
    for g in range(0, 40, 3):
        for w in range(1, 7):
            for r in range(w):
                assert pior.remap_cursor(g, r, w) == \
                    jior.remap_cursor(g, r, w)


@pytest.mark.parametrize("old,new", WORLDS)
def test_remap_and_ledger_iterators_across_worlds(old, new):
    n, batch, steps = 53, 3, 4
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    acct = {m: m.SampleAccountant(n) for m in (pior, jior)}
    states = {}
    for mod, mx in ((pior, tmx), (jior, jmx)):
        its = [mod.ShardedLedgerIter(x, batch_size=batch, seed=4, rank=r,
                                     world=old) for r in range(old)]
        for _ in range(steps):
            for it in its:
                b = next(it)
                acct[mod].record(b.index)
        states[mod] = [it.state() for it in its]
    assert states[pior] == states[jior]
    for r in range(new):
        got = pior.remap_state(states[pior][0], r, new)
        assert got == jior.remap_state(states[jior][0], r, new)
        assert states[pior][0]["rank"] == 0      # the input is not changed
    for mod in (pior, jior):
        its = [mod.ShardedLedgerIter(x, batch_size=batch, seed=4, rank=r,
                                     world=new) for r in range(new)]
        for it in its:
            it.restore(states[mod][0])
            while True:
                try:
                    acct[mod].record(next(it).index)
                except StopIteration:
                    break
    assert acct[pior].verdict() == acct[jior].verdict()
    assert acct[pior].verdict()["ok"]


def test_ledger_iterator_batches_equal_jax():
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    y = np.arange(20, dtype=np.float32)
    its = [m.ShardedLedgerIter(x, y, batch_size=3, seed=2, rank=1, world=2)
           for m in (pior, jior)]
    for _ in range(2):
        for got, want in zip(_rest(its[0]), _rest(its[1])):
            for a, b in zip(got[:-1], want[:-1]):
                np.testing.assert_array_equal(a, b)
        for it in its:
            it.reset()
    assert its[0].state() == its[1].state()
    with pytest.raises(MXNetError, match="ledger state mismatch"):
        its[0].restore(dict(its[0].state(), seed=3))


def test_accountant_names_drops_and_doubles():
    for mod in (pior, jior):
        a = mod.SampleAccountant(5)
        a.record([0, 1, 1, 7])
        assert a.verdict() == {"ok": False, "consumed": 3,
                               "dropped": [2, 3, 4], "double": [1],
                               "alien": [7]}


# ----------------------------------------- manifest <-> fit plumbing
def test_entries_stash_and_apply():
    it = _ndarray(tmx, None)
    next(it)
    assert pior.data_state_entry() is None
    pior.track(it)
    entry = pior.data_state_entry()
    assert entry == {"v": 1, "state": it.state(),
                     "position": it.position()}
    pior.note_loaded_state({"v": 99, "state": {}})     # unreadable: dropped
    assert pior.pending_state() is None
    pior.note_loaded_state(entry, source="x")
    fresh = _ndarray(tmx, None)
    bad = tmx.io.CSVIter.__new__(tmx.io.CSVIter)
    bad._inner = tmx.io.NDArrayIter(np.zeros((3, 1), np.float32),
                                    batch_size=1)
    with pytest.raises(MXNetError):
        pior.apply_pending(bad)                 # the entry stays stashed
    assert pior.pending_state()["source"] == "x"
    assert pior.apply_pending(fresh)["state"] == entry["state"]
    assert pior.pending_state() is None and fresh.state() == it.state()


def test_data_resume_off_writes_and_restores_nothing(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_DATA_RESUME", "0")
    it = _ndarray(tmx, None)
    pior.track(it)
    assert pior.data_state_entry() is None
    pior.note_loaded_state({"v": 1, "state": it.state()})
    assert pior.pending_state() is None


def _mlp(mx):
    data = mx.sym.Variable("data")
    x = mx.sym.FullyConnected(mx.sym.Flatten(data), num_hidden=5, name="fc")
    return mx.sym.SoftmaxOutput(x, name="softmax")


class _SaveAt:
    """A batch-end callback saving a checkpoint after batch ``at``."""

    def __init__(self, mx, prefix, at):
        self.mx, self.prefix, self.at = mx, prefix, at

    def __call__(self, param):
        if param.nbatch == self.at and param.epoch == 0:
            mod = param.locals["self"]
            args, auxs = mod.get_params()
            self.mx.model.save_checkpoint(self.prefix, 1, mod.symbol, args,
                                          auxs)


class _Seen:
    def __init__(self):
        self.labels = []

    def __call__(self, param):
        self.labels.append(param.locals["batch"].label[0].asnumpy().copy())


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_fit_resumes_mid_epoch_from_a_checkpoint(saver, tmp_path):
    x, y = _xy(40)
    y = np.arange(40, dtype=np.float32) % 5
    prefix = str(tmp_path / "mid")
    mx = tmx if saver == "port" else jmx
    mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=4), num_epoch=1,
            batch_end_callback=_SaveAt(mx, prefix, 3))
    mx.io_resume.clear_pending()
    doc = tmx.resilience.verify_manifest(prefix, 1)
    assert doc["meta"]["data_state"]["state"]["offset"] == 16
    _sym, args, auxs = tmx.model.load_checkpoint(prefix, 1)
    seen = _Seen()
    resumed = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
    resumed.fit(tmx.io.NDArrayIter(x, y, batch_size=4), num_epoch=1,
                arg_params=args, aux_params=auxs, batch_end_callback=seen)
    np.testing.assert_array_equal(np.concatenate(seen.labels), y[16:])
    assert pior.pending_state() is None
