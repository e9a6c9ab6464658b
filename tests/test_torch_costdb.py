"""The port's cost database (``telemetry.costdb``) against the JAX
package's on the CPU: the roofline fields under pinned peaks, record
aggregation and the JSONL the JAX reader takes with ``strict=True`` (and
the other way round), the H100 peak row, sampling at the Executor and
ShardedTrainer seams (the first dispatch never timed, ``0`` disables),
program records with the analytic flops, block and kernel records from a
sampled dispatch with the JAX estimates, noting behind one flag, and the
``perf_top`` document equal to the JAX tool's."""
import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest

import torch_threads  # noqa: F401  (xdist workers share the cores)

import mxnet_tpu_torch as tmx
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.telemetry import costdb as jdb
from mxnet_tpu_torch import models as tmodels, telemetry as ttel
from mxnet_tpu_torch.telemetry import costdb as tdb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = ("MXNET_TPU_COSTDB", "MXNET_TPU_COSTDB_SAMPLE", "MXNET_TPU_PEAK_FLOPS",
       "MXNET_TPU_PEAK_BW")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    jtel.reset()
    ttel.reset()
    yield
    jtel.reset()
    ttel.reset()


def _pin(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("MXNET_TPU_PEAK_BW", "1e11")


@pytest.mark.parametrize("args", [
    (2e9, 1e6, 0.004), (1e8, 1e8, 0.01), (None, 1e6, 0.1), (1e9, None, 0.0),
    (1e9, 0.0, None), (5e11, 1e10, 2.0)])
def test_roofline_equal_under_pinned_peaks(monkeypatch, args):
    _pin(monkeypatch)
    for backend in ("cpu", "gpu", "tpu"):
        assert tdb.roofline(*args, backend=backend) == \
            jdb.roofline(*args, backend=backend)


def test_peak_table_and_backend(monkeypatch):
    assert tdb.PEAKS["gpu"] == (989e12, 3.35e12)
    assert tdb.PEAKS["tpu"] == jdb.PEAKS["tpu"]
    assert tdb.backend_name("cuda:0") == "gpu"
    assert tdb.backend_name("cpu") == "cpu"
    assert tdb.peak_flops("gpu") == 989e12
    monkeypatch.setenv("MXNET_TPU_PEAK_FLOPS", "7e13")
    monkeypatch.setenv("MXNET_TPU_PEAK_BW", "2e12")
    assert tdb.peak_flops("gpu") == jdb.peak_flops("gpu") == 7e13
    assert tdb.peak_bandwidth("cpu") == jdb.peak_bandwidth("cpu") == 2e12


def _feed(db):
    for wall in (0.02, 0.01, 0.03):
        db.record("block", "b0", wall_s=wall, flops=1e9,
                  bytes_accessed=1e6, shapes=[(8, 64)], dtypes=["float32"],
                  backend="cpu", block_kind="fc_act")
    db.record("block", "b0", wall_s=0.5, flops=1e9, bytes_accessed=1e6,
              shapes=[(16, 64)], dtypes=["float32"], backend="cpu",
              block_kind="fc_act")
    db.record("kernel", "matmul_stats", wall_s=0.002, flops=5e8,
              bytes_accessed=2e6, shapes=[(128, 64)], dtypes=["bfloat16"],
              backend="gpu", block_config={"bm": 128, "grid_m": 4})
    db.record("program", "trainer.step", wall_s=0.013, flops=1.5e9,
              bytes_accessed=1.03e8, shapes=[(8, 8)], dtypes=["float32"],
              n_leaves=2, leaves_digest="abc", mesh={"data": 1},
              backend="cpu")


def _strip(recs):
    return sorted(({k: v for k, v in r.items() if k != "ts"} for r in recs),
                  key=lambda r: (r["kind"], r["name"], r["sig"]))


def test_records_and_files_equal_jax(monkeypatch, tmp_path):
    _pin(monkeypatch)
    jd, td = jdb.CostDB(), tdb.CostDB()
    _feed(jd)
    _feed(td)
    assert _strip(td.records()) == _strip(jd.records())
    tsum, jsum = td.summary(), jd.summary()
    for s in (tsum, jsum):
        s.pop("backend")
    assert tsum == jsum
    # the port's file passes the JAX reader, strict, and the other way
    tpath = td.flush(str(tmp_path / "t"))
    jpath = jd.flush(str(tmp_path / "j"))
    jrecs, skipped = jdb.read_records(tpath, strict=True)
    assert skipped == 0 and _strip(jrecs) == _strip(td.records())
    trecs, _ = tdb.read_records(jpath, strict=True)
    assert _strip(trecs) == _strip(jd.records())
    with open(tpath, "a") as f:
        f.write('{"schema": "other/1", "kind": "op", "name": "x", '
                '"sig": "s"}\n')
    for reader in (jdb, tdb):
        with pytest.raises(ValueError, match="schema"):
            reader.read_records(tpath, strict=True)
        assert reader.read_records(tpath)[1] == 1


def test_metrics_emitted_as_jax(monkeypatch):
    _pin(monkeypatch)
    _feed(tdb.DB)
    _feed(jdb.DB)
    for name in ("mxtpu_costdb_records_total", "mxtpu_block_mfu"):
        kind = ttel.CATALOG[name][0]
        getter = ttel.counter if kind == "counter" else ttel.gauge
        jgetter = jtel.counter if kind == "counter" else jtel.gauge
        assert getter(name).samples() == jgetter(name).samples()


def _mlp_exe():
    net = tmodels.get_model("mlp", num_classes=10)
    exe = net.simple_bind(tmx.cpu(), grad_req="write", data=(8, 64),
                          softmax_label=(8,))
    rng = np.random.RandomState(0)
    for n, arr in exe.arg_dict.items():
        arr[:] = rng.standard_normal(arr.shape).astype(np.float32) * 0.1
    return exe


def test_executor_seams_sample_after_the_first(monkeypatch, tmp_path):
    _pin(monkeypatch)
    monkeypatch.setenv("MXNET_TPU_COSTDB_SAMPLE", "1")
    monkeypatch.setenv("MXNET_TPU_COSTDB", str(tmp_path))
    exe = _mlp_exe()
    exe.forward(is_train=True)
    exe.backward()
    assert tdb.records() == []            # the first of each is not timed
    for _ in range(2):
        exe.forward(is_train=True)
        exe.backward()
    progs = {r["name"]: r for r in tdb.records() if r["kind"] == "program"}
    assert set(progs) == {"executor.forward", "executor.backward"}
    fwd, bwd = progs["executor.forward"], progs["executor.backward"]
    assert fwd["count"] == 2 and fwd["wall_s"] > 0
    # the analytic flops: the MLP's three FullyConnected layers
    from mxnet_tpu_torch.analysis.perf import graph_cost
    flops, bytes_ = graph_cost(exe._symbol, {"data": (8, 64),
                                             "softmax_label": (8,)})
    assert fwd["flops"] == flops > 2 * 8 * 64 * 128
    assert bwd["flops"] == 2 * flops and fwd["bytes_accessed"] == bytes_
    assert 0 < fwd["mfu"] <= 1.0
    path = tdb.flush()
    assert path and jdb.read_records(path, strict=True)[1] == 0
    assert not tdb.SAMPLING


def test_sampling_off_and_every_nth(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_COSTDB_SAMPLE", "0")
    exe = _mlp_exe()
    for _ in range(4):
        exe.forward()
    assert tdb.records() == []
    monkeypatch.setenv("MXNET_TPU_COSTDB_SAMPLE", "3")
    exe = _mlp_exe()
    seen = []
    orig = tdb.DB._record_dispatch
    monkeypatch.setattr(tdb.DB, "_record_dispatch",
                        lambda job, wall: seen.append(1) or orig(job, wall))
    for _ in range(8):
        exe.forward()
    # the JAX cadence: dispatches 2, 5 and 8 (count % n == 1)
    assert len(seen) == 3


def _gpt_exe(layers=1):
    from mxnet_tpu_torch.models import gpt
    net = gpt.gpt_symbol(64, 128, 64, 2, layers, dropout=0.0)
    exe = net.simple_bind(tmx.cpu(), grad_req="write", data=(2, 128),
                          softmax_label=(2, 128))
    rng = np.random.RandomState(0)
    for n, arr in exe.arg_dict.items():
        if n in ("data", "softmax_label"):
            arr[:] = rng.randint(0, 64, arr.shape).astype(np.float32)
        else:
            arr[:] = rng.standard_normal(arr.shape).astype(np.float32) * 0.05
    return exe


def test_kernel_records_from_the_flash_wrappers(monkeypatch):
    _pin(monkeypatch)
    monkeypatch.setenv("MXNET_TPU_COSTDB_SAMPLE", "1")
    exe = _gpt_exe()
    noted = []
    orig = tdb.note_kernel
    monkeypatch.setattr(tdb, "note_kernel",
                        lambda *a, **k: noted.append(a[0]) or orig(*a, **k))
    exe.forward(is_train=True)
    exe.backward()
    assert noted == []                    # unsampled: nothing is noted
    exe.forward(is_train=True)
    exe.backward()
    assert noted == ["flash_attention_fwd", "flash_attention_bwd"]
    kern = {r["name"]: r for r in tdb.records() if r["kind"] == "kernel"}
    b, t, h, d = 2, 128, 2, 32
    assert kern["flash_attention_fwd"]["flops"] == 4.0 * b * h * t * t * d
    assert kern["flash_attention_bwd"]["flops"] == 10.0 * b * h * t * t * d
    assert kern["flash_attention_fwd"]["bytes_accessed"] == \
        4.0 * b * t * h * d * 4
    assert kern["flash_attention_fwd"]["block_config"]["n_k"] == 1
    assert kern["flash_attention_fwd"]["program"] == "executor.forward"
    assert kern["flash_attention_bwd"]["program"] == "executor.backward"
    for r in tdb.records():
        assert r["mfu"] is None or r["mfu"] <= 1.0


def test_trainer_blocks_kernels_and_cost_summary(monkeypatch):
    _pin(monkeypatch)
    monkeypatch.setenv("MXNET_TPU_COSTDB_SAMPLE", "1")
    from mxnet_tpu_torch.parallel import ShardedTrainer, build_mesh
    net = tmodels.get_model("resnet", num_classes=10, num_layers=50,
                            image_shape="3,32,32")
    tr = ShardedTrainer(net, build_mesh(devices=[tmx.cpu()]),
                        data_shapes={"data": (2, 3, 32, 32)},
                        label_shapes={"softmax_label": (2,)},
                        layout="NHWC", fuse_blocks=True)
    rng = np.random.RandomState(0)
    batch = tr.put_batch({"data": rng.rand(2, 3, 32, 32).astype(np.float32),
                          "softmax_label": np.array([1.0, 2.0], np.float32)})
    tr.run_steps(batch, 2)              # the first dispatch: not timed
    tr.run_steps(batch, 2)
    s = tr.cost_summary(top=3)
    assert set(s["programs"]) == {"trainer.run_steps"}
    recs = tdb.records()
    ms = [r for r in recs if r["kind"] == "kernel"]
    # K5 in the 16 pointwise blocks: one record a distinct (M, K, N)
    assert s["by_kind"]["block"] > 40 and s["by_kind"]["kernel"] == 8
    assert {r["name"] for r in ms} == {"matmul_stats"}
    assert all(r["block_config"]["bm"] == 128 for r in ms)
    prog = next(r for r in recs if r["kind"] == "program")
    assert prog["flops"] > 0 and prog["count"] == 1
    for r in recs:
        assert r["mfu"] is None or r["mfu"] <= 1.0
    tr.step(batch)
    tr.step(batch)
    assert "trainer.step" in tr.cost_summary()["programs"]


def test_perf_top_document_equals_jax(monkeypatch, tmp_path):
    _pin(monkeypatch)
    db = tdb.CostDB()
    _feed(db)
    db.flush(str(tmp_path))
    spec = importlib.util.spec_from_file_location(
        "jax_perf_top", os.path.join(ROOT, "tools", "perf_top.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    from mxnet_tpu_torch.tools import perf_top as ttool
    docs = []
    for tool in (jtool, ttool):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert tool.main([str(tmp_path), "--json", "--strict"]) == 0
        docs.append(json.loads(buf.getvalue()))
    assert docs[1] == docs[0]
    assert docs[1]["worst"]["name"] == "b0"
    # --suggest joins the tuning cache: an explicit cache that is not
    # there is a usage error, as in the JAX tool
    assert ttool.main([str(tmp_path), "--suggest", "--cache",
                       str(tmp_path / "no-cache")]) == 2
    assert jtool.main([str(tmp_path), "--suggest", "--cache",
                       str(tmp_path / "no-cache")]) == 2
    assert ttool.main([str(tmp_path / "none")]) == 2
