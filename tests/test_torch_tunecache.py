"""The port's tuning cache (``mxnet_tpu_torch.autotune.cache``) against the
JAX package's: key digests, files written by either package read and merged
by the other, the merge rules, the mode and directory variables; and the
port's own lookup contract (one resolution, hit or miss, a key a
generation; ``off`` looks nothing up; ``search`` never searches inside a
CUDA-graph capture)."""
import json
import os

import numpy as np
import pytest
import torch

from mxnet_tpu import autotune as jautotune
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu_torch import autotune as tautotune
from mxnet_tpu_torch import telemetry as ttelemetry
from mxnet_tpu_torch.autotune import cache as tcache
from mxnet_tpu_torch.autotune import search as tsearch

#: key payloads: (op, shapes, dtypes, mesh, backend, extra)
PAYLOADS = [
    ("flash_attention_fwd", [(16, 1024, 16, 64)], ["bfloat16"], None,
     "gpu", {"causal": True}),
    ("flash_attention_bwd", [(4, 1024, 16, 64)], ["float32"], None, "gpu",
     {"causal": False}),
    ("matmul_stats", [(25088, 1024), (1024, 256)], ["bfloat16"] * 2, None,
     "gpu", None),
    ("block:conv_bn_act", [(128, 56, 56, 64), (256, 64, 1, 1)],
     ["bfloat16"] * 2, None, "tpu", {"layout": "NHWC", "act": "relu"}),
    ("graph_plan", [], [], {"data": 1, "model": 1}, "cpu",
     {"graph": "d50bf9e5d586", "layout": "NHWC"}),
]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Both packages' process caches empty, the variables unset, the
    counts zeroed, before and after each test."""
    for name in ("MXNET_TPU_TUNE_CACHE", "MXNET_TPU_AUTOTUNE",
                 "MXNET_TPU_PLAN_SEARCH"):
        # set first, so that teardown restores it even where a tool under
        # test sets it in os.environ itself
        monkeypatch.setenv(name, "")
        monkeypatch.delenv(name)
    for pkg in (jautotune, tautotune):
        pkg.CACHE.clear()
        pkg.reset_stats()
    yield
    for pkg in (jautotune, tautotune):
        pkg.CACHE.clear()
        pkg.reset_stats()


@pytest.mark.parametrize("payload", PAYLOADS, ids=lambda p: p[0])
def test_key_sig_equals_jax(payload):
    op, shapes, dtypes, mesh, backend, extra = payload
    got = tautotune.key_sig(op, shapes, dtypes, mesh=mesh, backend=backend,
                            extra=extra)
    want = jautotune.key_sig(op, shapes, dtypes, mesh=mesh,
                             backend=backend, extra=extra)
    assert got == want
    assert len(got[0]) == 12


def _fill(pkg, directory, monkeypatch):
    """Five entries through ``pkg``'s process cache, persisted under
    ``directory``, with walls from a seed; two keys put twice."""
    monkeypatch.setenv("MXNET_TPU_TUNE_CACHE", str(directory))
    pkg.reload_cache()
    rng = np.random.RandomState(0)
    for i, (op, shapes, dtypes, mesh, backend, extra) in \
            enumerate(PAYLOADS + PAYLOADS[:2]):
        pkg.put(op, shapes, dtypes, {"block_k": 64 + 32 * i},
                wall_s=float(rng.uniform(1e-4, 1e-3)), mesh=mesh,
                backend=backend, extra=extra,
                heuristic_config={"block_k": 64},
                heuristic_wall_s=2e-3, candidates=2)
    monkeypatch.delenv("MXNET_TPU_TUNE_CACHE")
    pkg.CACHE.clear()


@pytest.mark.parametrize("writer,reader", [(jautotune, tautotune),
                                           (tautotune, jautotune)],
                         ids=["jax_to_port", "port_to_jax"])
def test_cache_files_read_by_the_other_package(tmp_path, monkeypatch,
                                               writer, reader):
    _fill(writer, tmp_path, monkeypatch)
    got, skipped = reader.read_entries(str(tmp_path), strict=True)
    want, _s = writer.read_entries(str(tmp_path), strict=True)
    assert skipped == 0 and len(got) == len(PAYLOADS)

    def key(entries):
        return sorted(json.dumps(e, sort_keys=True) for e in entries)

    assert key(got) == key(want)
    # and the reader's lookup finds each key by its own digest
    c = reader.TuneCache()
    assert c.load(str(tmp_path)) == len(PAYLOADS)
    for op, shapes, dtypes, mesh, backend, extra in PAYLOADS:
        assert c.lookup(op, shapes, dtypes, mesh=mesh, backend=backend,
                        extra=extra) is not None


def _merge_sequence(pkg):
    c = pkg.TuneCache()
    seq = [({"bm": 1}, 2e-3, False), ({"bm": 2}, 1e-3, False),
           ({"bm": 3}, 3e-3, False), ({"bm": 4}, 1e-3, False),
           ({"bm": 5}, None, False), ({"bm": 6}, 1e-6, True)]
    out = []
    for cfg, wall, proxy in seq:
        c.put("matmul_stats", [(8, 8), (8, 8)], ["float32"] * 2, cfg,
              wall_s=wall, backend="gpu", proxy=proxy, persist=False)
        out.append(c.lookup("matmul_stats", [(8, 8), (8, 8)],
                            ["float32"] * 2, backend="gpu")["config"])
    return out


def test_merge_best_measured_wall_wins_equals_jax():
    """The same sequence of puts keeps the same winner after each in both
    packages: the best wall, a tie to the newer, an unmeasured entry never
    over a measured one, a proxy never over a full-shape one."""
    got, want = _merge_sequence(tautotune), _merge_sequence(jautotune)
    assert got == want
    assert got[-1] == {"bm": 4}


@pytest.mark.parametrize("pkg", [jautotune, tautotune], ids=["jax", "port"])
def test_full_shape_entry_displaces_proxy(pkg):
    c = pkg.TuneCache()
    args = ("flash_attention_fwd", [(4, 1024, 16, 64)], ["float32"])
    c.put(*args, {"block_k": 32}, wall_s=1e-6, proxy=True, backend="gpu",
          persist=False)
    c.put(*args, {"block_k": 64}, wall_s=1e-3, backend="gpu",
          persist=False)
    c.put(*args, {"block_k": 16}, wall_s=1e-9, proxy=True, backend="gpu",
          persist=False)
    assert c.lookup(*args, backend="gpu")["config"] == {"block_k": 64}


def test_corrupt_or_empty_cache_degrades(tmp_path, monkeypatch):
    """Bad lines are skipped (and counted), an empty directory is an empty
    cache, and the lookup never raises: both packages read the same."""
    good = tautotune.TuneCache().put(
        "matmul_stats", [(8, 8), (8, 8)], ["float32"] * 2, {"bn": 64},
        backend="gpu", persist=False)
    (tmp_path / "tunecache-1.jsonl").write_text(
        "not json\n" + json.dumps({"schema": "other/1", "sig": "x",
                                   "op": "y", "config": {}}) + "\n"
        + json.dumps(good) + "\n\n" + json.dumps({"config": 3}) + "\n")
    for pkg in (tautotune, jautotune):
        entries, skipped = pkg.read_entries(str(tmp_path))
        assert [e["sig"] for e in entries] == [good["sig"]]
        assert skipped == 3
        with pytest.raises(ValueError):
            pkg.read_entries(str(tmp_path), strict=True)
    monkeypatch.setenv("MXNET_TPU_TUNE_CACHE", str(tmp_path / "empty"))
    tautotune.reload_cache()
    assert tautotune.kernel_config("matmul_stats", [(8, 8), (8, 8)],
                                   ["float32"] * 2, backend="gpu") is None


@pytest.mark.parametrize("value,mode", [
    (None, "cache"), ("off", "off"), ("SEARCH", "search"), (" cache ",
                                                           "cache"),
    ("bogus", "cache")])
def test_mode_variable_equals_jax(monkeypatch, value, mode):
    if value is None:
        monkeypatch.delenv("MXNET_TPU_AUTOTUNE", raising=False)
    else:
        monkeypatch.setenv("MXNET_TPU_AUTOTUNE", value)
    assert tautotune.autotune_mode() == jautotune.autotune_mode() == mode


def test_off_mode_looks_nothing_up(monkeypatch):
    tautotune.put("matmul_stats", [(8, 8), (8, 8)], ["float32"] * 2,
                  {"bn": 64}, backend="gpu", persist=False)
    monkeypatch.setenv("MXNET_TPU_AUTOTUNE", "off")
    tautotune.reset_stats()
    assert tautotune.kernel_config("matmul_stats", [(8, 8), (8, 8)],
                                   ["float32"] * 2, backend="gpu") is None
    s = tautotune.summary()
    assert (s["hits"], s["misses"], s["mode"]) == (0, 0, "off")


def test_lookup_resolved_once_a_key_and_generation():
    """The eager port looks a key up at its first kernel call of a cache
    generation only (JAX looks up once a trace): later calls return the
    same answer uncounted; a put or reload starts a new generation."""
    args = ("matmul_stats", [(64, 8), (8, 64)], ["bfloat16"] * 2)
    hit0 = ttelemetry.counter("mxtpu_tune_cache_miss_total").labels(
        op="matmul_stats").get()
    for _ in range(5):
        assert tautotune.kernel_config(*args, backend="gpu") is None
    s = tautotune.summary()
    assert (s["hits"], s["misses"]) == (0, 1)
    assert ttelemetry.counter("mxtpu_tune_cache_miss_total").labels(
        op="matmul_stats").get() == hit0 + 1
    tautotune.put(*args, {"bn": 64, "rows": 1}, backend="gpu",
                  persist=False)
    for _ in range(3):
        assert tautotune.kernel_config(*args, backend="gpu") == \
            {"bn": 64, "rows": 1}
    s = tautotune.summary()
    assert (s["hits"], s["misses"]) == (1, 1)
    assert s["tuned"] == [{"op": "matmul_stats",
                           "shapes": [[64, 8], [8, 64]],
                           "config": {"bn": 64, "rows": 1}}]
    # another backend is another key
    assert tautotune.kernel_config(*args, backend="cpu") is None
    tautotune.reload_cache()
    assert tautotune.kernel_config(*args, backend="gpu") is None
    assert tautotune.summary()["misses"] == 3


def test_lookup_writes_the_flight_event():
    """One ``tune_lookup`` event a resolution, with JAX's fields."""
    ttelemetry.flight.clear()
    tautotune.put("flash_attention_fwd", [(1, 128, 1, 64)], ["bfloat16"],
                  {"block_q": 128, "block_k": 64}, backend="gpu",
                  extra={"causal": True}, persist=False)
    for _ in range(3):
        tautotune.kernel_config("flash_attention_fwd", [(1, 128, 1, 64)],
                                ["bfloat16"], extra={"causal": True},
                                backend="gpu")
    events = [e for e in ttelemetry.flight.events()
              if e.get("kind") == "tune_lookup"]
    assert len(events) == 1
    ev = events[0]
    assert ev["op"] == "flash_attention_fwd" and ev["hit"] is True
    assert ev["config"] == {"block_q": 128, "block_k": 64}
    assert ev["searched"] is False
    assert ev["sig"] == tautotune.key_sig(
        "flash_attention_fwd", [(1, 128, 1, 64)], ["bfloat16"],
        backend="gpu", extra={"causal": True})[0]


def test_search_mode_never_searches_inside_a_capture(monkeypatch):
    """``search``: a miss while the current stream captures a CUDA graph
    stays a plain miss and is not remembered; the next call outside the
    capture searches and commits."""
    monkeypatch.setenv("MXNET_TPU_AUTOTUNE", "search")
    calls = []

    def fake_search(op, shapes, dtypes, mesh=None, extra=None,
                    backend=None):
        calls.append(op)
        return tautotune.put(op, shapes, dtypes, {"bn": 128, "rows": 2},
                             backend=backend, persist=False,
                             source="inline-search", proxy=True)

    monkeypatch.setattr(tsearch, "inline_search", fake_search)
    monkeypatch.setattr(tcache, "_capturing", lambda: True)
    args = ("matmul_stats", [(256, 64), (64, 256)], ["bfloat16"] * 2)
    assert tautotune.kernel_config(*args, backend="gpu") is None
    assert tautotune.kernel_config(*args, backend="gpu") is None
    assert calls == [] and tautotune.summary()["misses"] == 2
    monkeypatch.setattr(tcache, "_capturing", lambda: False)
    assert tautotune.kernel_config(*args, backend="gpu") == \
        {"bn": 128, "rows": 2}
    assert calls == ["matmul_stats"]
    s = tautotune.summary()
    assert s["searches"] == 1 and s["misses"] == 3
    # a block key is never searched
    assert tautotune.block_config("conv_bn_act", [(1, 2, 2, 8)],
                                  ["float32"], backend="gpu") is None
    assert calls == ["matmul_stats"]


def test_summary_block_has_the_jax_keys():
    got, want = tautotune.summary(), jautotune.summary()
    assert set(got) == set(want)
    assert got["schema"] == want["schema"] == "mxtpu-tunecache/1"


def test_put_persists_one_line_a_put(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_TUNE_CACHE", str(tmp_path))
    tautotune.reload_cache()
    tautotune.put("matmul_stats", [(8, 8), (8, 8)], ["float32"] * 2,
                  {"bn": 64}, wall_s=1e-3, backend="gpu")
    files = os.listdir(tmp_path)
    assert files == ["tunecache-%d.jsonl" % os.getpid()]
    lines = (tmp_path / files[0]).read_text().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["config"] == {"bn": 64}
    # a fresh view of the directory finds it
    tautotune.CACHE.clear()
    assert tautotune.lookup("matmul_stats", [(8, 8), (8, 8)],
                            ["float32"] * 2, backend="gpu")["wall_s"] \
        == 1e-3


def test_the_tune_and_plan_counters_are_emitted():
    for name in ("mxtpu_tune_cache_hit_total", "mxtpu_tune_cache_miss_total",
                 "mxtpu_plan_cache_hit_total",
                 "mxtpu_plan_cache_miss_total"):
        assert name not in ttelemetry.NOT_EMITTED
        assert name in ttelemetry.CATALOG
        assert ttelemetry.CATALOG[name] == jtelemetry.CATALOG[name]


def test_wrappers_consult_the_cache_only_on_the_card():
    """On the CPU the wrappers run their plain versions, which have no
    tile: no lookup (JAX consults only where its Pallas path runs)."""
    from mxnet_tpu_torch.ops import flash_attention as tfa
    from mxnet_tpu_torch.ops import fused as tfused
    x = torch.randn(16, 8)
    tfused.matmul_stats(x, torch.randn(8, 16), torch.zeros(16))
    q = torch.randn(1, 16, 1, 32)
    tfa.flash_attention_fwd(q, q, q, True)
    s = tautotune.summary()
    assert (s["hits"], s["misses"]) == (0, 0)
