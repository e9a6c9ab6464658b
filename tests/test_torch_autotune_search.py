"""The port's tuners and the tiles the kernels take: the candidate spaces
(the CUDA kernels' own tiles, the built-in one first), the wrappers' tile
selection (a cached tile the kernel cannot take degrades, an explicit one
raises), the tuners and the inline search on the CPU (the plain versions:
the control flow only), the ``tools.autotune`` CLI (tune, then every key
cached), ``perf_top --suggest`` against the JAX tool, and chip_smoke's
autotune helpers.  The times of the tiles come from the card
(chip_smoke's autotune phase)."""
import contextlib
import importlib.util
import io
import json
import os
import re

import pytest
import torch

from mxnet_tpu import autotune as jautotune
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import autotune as tautotune
from mxnet_tpu_torch.autotune import search as tsearch
from mxnet_tpu_torch.ops import flash_attention as tfa
from mxnet_tpu_torch.ops import fused as tfused
from mxnet_tpu_torch.telemetry import costdb as tcostdb
from mxnet_tpu_torch.tools import autotune as ttool
from mxnet_tpu_torch.tools import perf_top as tperf_top

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "mxnet_tpu_torch", "csrc")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("MXNET_TPU_TUNE_CACHE", "MXNET_TPU_AUTOTUNE",
                 "MXNET_TPU_COSTDB"):
        # set first, so that teardown restores it even where a tool under
        # test sets it in os.environ itself
        monkeypatch.setenv(name, "")
        monkeypatch.delenv(name)
    for pkg in (jautotune, tautotune):
        pkg.CACHE.clear()
        pkg.reset_stats()
    tcostdb.reset()
    # the zoo model built here must not move later tests' auto names
    with tmx.name.NameManager():
        yield
    for pkg in (jautotune, tautotune):
        pkg.CACHE.clear()
        pkg.reset_stats()
    tcostdb.reset()


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


# ------------------------------------------------------ the legal tiles
@pytest.mark.parametrize("which", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_kernel_tiles_builtin_first(which, dtype, d):
    """The built-in tile leads each list, and the lists hold what the C
    entries dispatch: the defaults as the sources state them."""
    tiles = tfa.kernel_tiles(which, dtype, d)
    assert tiles and len(set(tiles)) == len(tiles)
    f32 = dtype == torch.float32
    if which == "fwd" and f32:
        want = (64, 32) if d == 128 else (128, 64)
    elif which == "fwd":
        want = (128, 64) if d == 128 else (128, 128)
    else:
        want = (64, 32) if f32 else (64, 64)
    assert tiles[0] == want
    # two where two fit; the f32 kernels at D=128 take one
    assert len(tiles) == (1 if f32 and d == 128 else
                          4 if f32 and which == "fwd" else 2)
    assert tfa.kernel_tiles(which, torch.float16, d) == []


def test_sources_state_the_builtin_tiles():
    """The defaults the wrappers list first are the sources' own."""
    fwd = _source("flash_attention_fwd_sm90.cu")
    assert "static constexpr int BN = D == 128 ? 64 : 128;" in fwd
    assert "launch_tile<128, 32>" in fwd and "launch_tile<64, 64>" in fwd
    f32 = _source("flash_attention_fwd.cu")
    assert "static constexpr int MT = D == 128 ? 1 : 2;" in f32
    assert "static constexpr int BN = D == 128 ? 32 : 64;" in f32
    for m, n in ((1, 32), (1, 64), (2, 32), (2, 64)):
        assert "MXTT_FWD_TILE(%d, %d)" % (m, n) in f32
    assert "static constexpr int TILE = 32;" in _source(
        "flash_attention_bwd.cu")
    bwd = _source("flash_attention_bwd_sm90.cu")
    assert "constexpr int DEFAULT_TILE = 64;" in bwd
    assert "if (tile == 32) return launch<D, 32>(a, st);" in bwd
    k5 = _source("matmul_stats.cu")
    cost = re.search(r"constexpr int ITEM_COST = (\d+);", k5).group(1)
    assert int(cost) == tfused._ITEM_COST
    assert "int part_rows, int tile, int rows, int dtype" in k5


@pytest.mark.parametrize("cached,want", [
    ({"block_q": 128, "block_k": 64}, (128, 64)),
    ({"block_k": 64}, (128, 64)),
    ({"block_q": 64, "block_k": 64}, None),      # bf16's block is 128
    ({"block_k": 192}, None), ({"block_k": "x"}, None), ({}, None)])
def test_cached_tile_degrades_to_the_builtin(monkeypatch, cached, want):
    """A cached tile the kernel takes at this dtype and D is launched; any
    other reads as the built-in one (JAX's ``_select_blocks`` rule)."""
    q = torch.empty((16, 1024, 16, 64), dtype=torch.bfloat16,
                    device="meta")
    monkeypatch.setattr(tfa._costdb, "backend_name", lambda dev=None: "gpu")
    tautotune.put("flash_attention_fwd", [tuple(q.shape)], ["bfloat16"],
                  cached, extra={"causal": True}, backend="gpu",
                  persist=False)
    assert tfa.select_tile("fwd", q, True) == want
    assert tautotune.summary()["hits"] == 1


def test_explicit_tile_must_be_legal():
    q = torch.randn(1, 64, 1, 64)
    with pytest.raises(MXNetError, match="not one the"):
        tfa.flash_attention_fwd(q, q, q, True, blocks=(128, 128))
    with pytest.raises(MXNetError, match="not one the"):
        tfa.flash_attention_bwd(q, q, q, q, None, q, True, blocks=(64, 16))
    o, _lse = tfa.flash_attention_fwd(q, q, q, True, blocks=(64, 32))
    assert o.shape == q.shape
    x = torch.randn(300, 30)
    with pytest.raises(MXNetError, match="not one K5 takes"):
        tfused.matmul_stats(x, torch.randn(30, 70), torch.zeros(70),
                            config={"bn": 256})
    with pytest.raises(MXNetError, match="not one K5 takes"):
        tfused.matmul_stats(x, torch.randn(30, 70), torch.zeros(70),
                            config={"rows": 4})     # 3 m-tiles
    tfused.matmul_stats(x, torch.randn(30, 70), torch.zeros(70),
                        config={"bn": 64, "rows": 2})


@pytest.mark.parametrize("cfg,ok", [
    ({"bn": 64, "rows": 132}, True), ({"bn": 256, "rows": 1}, True),
    ({}, True), ({"bn": 0, "rows": 0}, True), ({"bn": 512}, False),
    ({"bn": 96}, False), ({"rows": 133}, False), ({"rows": -1}, False),
    ({"bn": "wide"}, False)])
def test_k5_config_takes(cfg, ok):
    assert tfused.config_takes(cfg, 100352, 256, torch.bfloat16) == ok
    # f32 stops at 128 columns; N = 64 needs no more than 64
    assert not tfused.config_takes({"bn": 256}, 25088, 256, torch.float32)
    assert not tfused.config_takes({"bn": 128}, 25088, 64, torch.bfloat16)


@pytest.mark.parametrize("m,k,n,count", chip_smoke.K5_BENCH_SHAPES)
def test_k5_heuristic_and_candidates(m, k, n, count):
    """The built-in config as the source computes it (bf16_tile, bf16_rows
    at 132 SMs), first among the candidates, every candidate one K5
    takes."""
    heur = tfused.heuristic_config(m, n, torch.bfloat16)
    m_tiles = -(-m // 128)
    assert heur["rows"] == min(132 // -(-n // heur["bn"]), m_tiles)
    cands = tautotune.candidate_matmul_configs(m, n, "bfloat16")
    assert cands[0] == heur and len(cands) <= 8
    assert all(tfused.config_takes(c, m, n, torch.bfloat16) for c in cands)
    widths = {c["bn"] for c in cands}
    assert widths == {b for b in (64, 128, 256)
                      if b <= tfused.widest_tile(n)}


def test_k5_heuristic_known_widths():
    """The source's comment: 25088 x 1024 x 256 runs 128-column tiles
    (least rounds of items); K8 and f32 keep the widest."""
    assert tfused.heuristic_config(25088, 256, torch.bfloat16)["bn"] == 128
    assert tfused.heuristic_config(25088, 256, torch.bfloat16,
                                   prologue=True)["bn"] == 256
    assert tfused.heuristic_config(25088, 256, torch.float32)["bn"] == 128


@pytest.mark.parametrize("n,lo,hi", [(2176, 1, None), (1024, 64, 512),
                                     (98, 2, 1024), (97, 1, None)])
def test_divisors_equal_jax(n, lo, hi):
    assert tautotune.divisors(n, lo, hi) == jautotune.divisors(n, lo, hi)


@pytest.mark.parametrize("a,b", [
    ({"block_q": 128, "block_k": 64}, {"block_q": 128, "block_k": 64,
                                       "n_k": 16}),
    ({"bn": 64}, {"bn": 128, "rows": 2}), ({}, {"bn": 1}),
    ({"pallas": 1}, {"pallas": 1}), ({"x": 1}, {"y": 1})])
def test_same_config_equals_jax(a, b):
    assert tautotune.same_config(a, b) == jautotune.same_config(a, b)


def test_candidate_flash_configs_are_the_kernel_tiles():
    for which in ("fwd", "bwd"):
        cands = tautotune.candidate_flash_configs(1024, 64, "bfloat16",
                                                  which)
        assert [(c["block_q"], c["block_k"]) for c in cands] == \
            tfa.kernel_tiles(which, torch.bfloat16, 64)
        assert all(c["n_k"] == 1024 // c["block_k"] for c in cands)


# ------------------------------------------------------------- tuners
def test_tune_matmul_stats_commits_and_feeds_costdb():
    rep = tautotune.tune_matmul_stats(256, 64, 128, dtype="bfloat16",
                                      repeats=1, device="cpu")
    assert rep["heuristic"]["config"] == rep["candidates"][0]["config"]
    assert rep["best"]["wall_s"] <= rep["heuristic"]["wall_s"]
    e = tautotune.lookup("matmul_stats", [(256, 64), (64, 128)],
                         ["bfloat16"] * 2, backend="cpu")
    assert e["config"] == rep["best"]["config"]
    assert e["heuristic_config"] == rep["heuristic"]["config"]
    recs = [r for r in tcostdb.records() if r["name"] == "matmul_stats"]
    assert len(recs) == len(rep["candidates"])
    assert all(r["source"] == "autotune" for r in recs)


@pytest.mark.parametrize("which", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tune_flash_on_the_cpu(which, dtype):
    rep = tautotune.tune_flash((1, 64, 2, 32), dtype=dtype, causal=True,
                               which=which, repeats=1, device="cpu",
                               key_shape=(8, 64, 4, 32))
    assert len(rep["candidates"]) == len(
        tfa.kernel_tiles(which, tsearch._DTYPES[dtype], 32))
    e = rep["entry"]
    assert e["proxy"] and e["shapes"] == [[8, 64, 4, 32]]
    assert e["extra"] == {"causal": True} and e["backend"] == "cpu"


def test_tune_conv_block_ab():
    rep = tautotune.tune_conv_block((2, 4, 4, 8), (16, 8, 1, 1),
                                    repeats=1, device="cpu")
    assert {c["config"]["pallas"] for c in rep["candidates"]} == {0, 1}
    assert rep["heuristic"]["config"] == {"pallas": 1}
    assert rep["entry"]["op"] == "block:conv_bn_act"
    assert rep["entry"]["extra"] == {"layout": "NHWC", "act": "relu"}


def test_inline_search_in_search_mode(monkeypatch, tmp_path):
    """A miss in ``search`` mode tunes at the proxy shape, commits under
    the original key and dispatches the winner; the next resolution, in a
    fresh view of the cache directory, hits."""
    monkeypatch.setenv("MXNET_TPU_AUTOTUNE", "search")
    monkeypatch.setenv("MXNET_TPU_TUNE_CACHE", str(tmp_path))
    args = ("flash_attention_fwd", [(4, 64, 8, 32)], ["float32"])
    cfg = tautotune.kernel_config(*args, extra={"causal": True},
                                  backend="cpu")
    assert (cfg["block_q"], cfg["block_k"]) in tfa.kernel_tiles(
        "fwd", torch.float32, 32)
    s = tautotune.summary()
    assert (s["misses"], s["searches"]) == (1, 1)
    e = tautotune.lookup(*args, extra={"causal": True}, backend="cpu")
    assert e["proxy"] and e["source"] == "inline-search"
    tautotune.reload_cache()
    tautotune.reset_stats()
    assert tautotune.kernel_config(*args, extra={"causal": True},
                                   backend="cpu") == cfg
    assert tautotune.summary()["hits"] == 1
    assert tsearch.inline_search("block:conv_bn", [(1, 1)], ["f"]) is None


def test_model_keys_of_resnet50():
    """The zoo mode's keys: K5's 8 GEMMs of the bench step and its 8 K5
    block shapes, no attention."""
    gemms, blocks, flashes = ttool.model_keys("resnet50", 128)
    assert gemms == sorted((m, k, n) for m, k, n, _c in
                           chip_smoke.K5_BENCH_SHAPES)
    assert len(blocks) == 8 and not flashes
    # each K5 block's NHWC input and OIHW weight are one GEMM's operands
    assert sorted((x[0] * x[1] * x[2], x[3], w[0])
                  for _kind, _act, x, w in blocks) == gemms


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ttool.main(argv)
    out = buf.getvalue().strip()
    return rc, json.loads(out.splitlines()[-1]) if out else None


def test_autotune_cli_tune_then_all_hits(tmp_path):
    cache, db = str(tmp_path / "cache"), str(tmp_path / "db")
    argv = ["--op", "matmul_stats", "--shapes", "256x64x128,512x32x64",
            "--dtype", "bfloat16", "--repeats", "1", "--cpu", "--cache",
            cache, "--costdb", db, "--json"]
    rc, doc = _run(argv)
    assert rc == 0 and (doc["tuned"], doc["cached"]) == (2, 0)
    assert all(k["heuristic_wall_s"] >= k["wall_s"] for k in doc["keys"])
    rc, doc = _run(argv)
    assert rc == 0 and (doc["tuned"], doc["cached"]) == (0, 2)
    lines = sum(1 for f in os.listdir(cache) for _l in
                open(os.path.join(cache, f)))
    assert lines == 2           # a cached run commits nothing
    rc, rep = _run(["--report", "--cache", cache, "--costdb", db, "--json"])
    assert rc == 0 and rep["tuned_never_worse"] and len(rep["keys"]) == 2
    # the JAX tool reads the port's cache
    jentries, _s = jautotune.read_entries(cache, strict=True)
    assert len(jentries) == 2


def test_autotune_cli_usage_errors():
    with pytest.raises(SystemExit) as e:
        ttool.main([])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        ttool.main(["--op", "matmul_stats", "--cpu"])
    assert e.value.code == 2
    assert ttool.main(["--op", "matmul_stats", "--shapes", "3x4", "--cpu"]) \
        == 2
    if not torch.cuda.is_available():
        assert ttool.main(["--op", "flash_fwd"]) == 2


# ---------------------------------------------------- perf_top --suggest
def _jax_perf_top():
    spec = importlib.util.spec_from_file_location(
        "jax_perf_top_suggest", os.path.join(ROOT, "tools", "perf_top.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _records_and_entries(db, pkg_cache):
    """Three kernel records (tuned better, tuned the same, untuned) and
    two block records of one graph (its plan committed at NHWC, one record
    dispatching another plan), written by the port's costdb."""
    cdb = tcostdb.CostDB()
    cdb.record("kernel", "matmul_stats", wall_s=5e-3, flops=1e9,
               bytes_accessed=1e6, shapes=[(256, 64), (64, 128)],
               dtypes=["float32", "float32"],
               block_config={"bn": 128, "rows": 2}, backend="cpu")
    cdb.record("kernel", "flash_attention_fwd", wall_s=2e-3, flops=2e9,
               bytes_accessed=1e6, shapes=[(1, 256, 2, 64)],
               dtypes=["float32"], block_config={"block_q": 128,
                                                  "block_k": 64},
               backend="cpu")
    cdb.record("kernel", "flash_attention_bwd", wall_s=1e-3, flops=1e9,
               bytes_accessed=1e6, shapes=[(1, 999, 1, 32)],
               dtypes=["float32"], block_config={"block_k": 32},
               backend="cpu")
    for name, plan, layout in (("r0", "greedy", "NHWC"),
                               ("r1", "plan-0123456789", "NCHW")):
        cdb.record("block", name, wall_s=1e-3, flops=1e8,
                   bytes_accessed=1e6, shapes=[(2, 8, 8, 8)],
                   dtypes=["float32"], block_kind="conv_bn_act",
                   layout=layout, pallas=False, graph="abc123def456",
                   plan=plan, backend="cpu")
    cdb.flush(str(db))
    pkg_cache.put("matmul_stats", [(256, 64), (64, 128)],
                  ["float32", "float32"], {"bn": 64, "rows": 2},
                  wall_s=1e-3, heuristic_config={"bn": 128, "rows": 2},
                  heuristic_wall_s=5e-3, backend="cpu", persist=False)
    pkg_cache.put("flash_attention_fwd", [(1, 256, 2, 64)], ["float32"],
                  {"block_q": 128, "block_k": 64}, wall_s=2e-3,
                  heuristic_wall_s=2e-3, backend="cpu", persist=False,
                  extra={"causal": True})
    pkg_cache.put("graph_plan", [], [],
                  {"decisions": {"chains": {"3": "off"}},
                   "plan_id": "plan-deadbeef00"}, wall_s=1e-3,
                  extra={"graph": "abc123def456", "layout": "NHWC"},
                  backend="cpu", persist=False)


def test_perf_top_suggest_rows_equal_jax(tmp_path, monkeypatch):
    """One costdb and one cache through both tools' ``--suggest``: the same
    rows (better-available, already-tuned, untuned, plan-stale and, for a
    record at another layout, plan-untuned)."""
    monkeypatch.setenv("MXNET_TPU_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("MXNET_TPU_PEAK_BW", "1e11")
    db, cache = tmp_path / "db", tmp_path / "cache"
    db.mkdir(), cache.mkdir()
    c = tautotune.TuneCache()
    _records_and_entries(db, c)
    with open(cache / "tunecache-1.jsonl", "w") as f:
        for e in c.entries():
            f.write(json.dumps(e, sort_keys=True) + "\n")
    jtool = _jax_perf_top()
    docs = []
    for tool in (jtool, tperf_top):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert tool.main([str(db), "--suggest", "--cache", str(cache),
                              "--json"]) == 0
        docs.append(json.loads(buf.getvalue()))
    # the hints name each package's own tools
    for doc in docs:
        for row in doc["suggestions"]:
            row.pop("hint", None)
    assert docs[1]["suggestions"] == docs[0]["suggestions"]
    status = sorted(r["status"] for r in docs[1]["suggestions"])
    assert status == ["already-tuned", "better-available", "plan-stale",
                      "plan-untuned", "untuned", "untuned", "untuned"]
    better = next(r for r in docs[1]["suggestions"]
                  if r["status"] == "better-available")
    assert better["expected_delta_frac"] == pytest.approx(0.8)
    # text mode renders the rows
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tperf_top.main([str(db), "--suggest", "--cache", str(cache)])
    assert "plan-stale" in buf.getvalue()


def test_perf_top_suggest_bad_cache_is_a_usage_error(tmp_path, monkeypatch,
                                                      capsys):
    db = tmp_path / "db"
    db.mkdir()
    cdb = tcostdb.CostDB()
    cdb.record("kernel", "matmul_stats", wall_s=1e-3, flops=1e9,
               bytes_accessed=1e6, shapes=[(8, 8), (8, 8)],
               dtypes=["float32"] * 2, backend="cpu")
    cdb.flush(str(db))
    assert tperf_top.main([str(db), "--suggest", "--cache",
                           str(tmp_path / "nope")]) == 2
    corrupt = tmp_path / "tunecache-bad.jsonl"
    corrupt.write_text("not json\n")
    assert tperf_top.main([str(db), "--suggest", "--cache",
                           str(corrupt)]) == 2
    assert "no readable" in capsys.readouterr().err
    monkeypatch.setenv("MXNET_TPU_TUNE_CACHE", str(tmp_path / "gone"))
    assert tperf_top.main([str(db), "--suggest"]) == 0
    assert "does not exist yet" in capsys.readouterr().err


# ------------------------------------------------- chip_smoke's helpers
def test_chip_smoke_names_every_tile_instantiation():
    text = "\n".join([
        "ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__c38aed5a"
        "_22_flash_attention_fwd_cu_9508f4d414flash_fwd_tf32ILi64ELi1ELi32E"
        "EEv14CUtensorMap_stS1_S1_NS_6ParamsE' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 135 registers, used 1 barriers, 48 bytes smem",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117flash_"
        "bwd_dq_sm90ILi128ELi32EEEv14CUtensorMap_stS1_S1_S1_NS_6ParamsE' for "
        "'sm_90a'",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 153 registers, used 1 barriers"])
    assert chip_smoke.ptxas_summary(text) == {
        "flash_fwd_tf32<64,1,32>": {"stack": 0, "spill_stores": 0,
                                    "spill_loads": 0, "registers": 135,
                                    "smem": 48},
        "flash_bwd_dq_sm90<128,32>": {"stack": 8, "spill_stores": 4,
                                      "spill_loads": 4, "registers": 153,
                                      "smem": 0}}


def test_chip_smoke_tile_summaries():
    flash = {"shape": [16, 1024, 16, 64], "dtype": "bfloat16",
             "fwd": [{"tile": [128, 128], "ms": 0.11},
                     {"tile": [128, 64], "ms": 0.13}], "bwd": []}
    t = chip_smoke._tile_times(flash, "fwd")
    assert t["heuristic"] == t["winner"] == [128, 128]
    assert t["legal"] == [[128, 128], [128, 64]]
    assert t["ms"] == {"128x128": 0.11, "128x64": 0.13}
    k5 = {"shape": [25088, 1024, 256], "dtype": "bfloat16",
          "heuristic": {"bn": 128, "rows": 66},
          "configs": [{"bn": 128, "rows": 66, "device_ms": 0.031},
                      {"bn": 64, "rows": 33, "device_ms": 0.030}]}
    t = chip_smoke._k5_tile_times(k5)
    assert t["winner"] == {"bn": 64, "rows": 33}
    assert t["heuristic_ms"] == 0.031
    assert chip_smoke.AUTOTUNE_FLASH[0] == chip_smoke.TRAIN_SHAPE


def test_chip_smoke_runs_the_cli_twice(tmp_path):
    """chip_smoke's autotune phase runs ``tools.autotune`` as a process of
    its own, then again: the second finds every key cached (here on the
    CPU, at a tiny shape)."""
    argv = ["--op", "matmul_stats", "--shapes", "64x8x16", "--cpu",
            "--repeats", "1", "--cache", str(tmp_path)]
    first = chip_smoke._tool_process("mxnet_tpu_torch.tools.autotune", argv)
    assert (first["tuned"], first["cached"]) == (1, 0)
    rc, second = chip_smoke._tool_main(ttool, argv)
    assert rc == 0 and (second["tuned"], second["cached"]) == (0, 1)
    with pytest.raises(SystemExit, match="failed"):
        chip_smoke._tool_process("mxnet_tpu_torch.tools.autotune",
                                 ["--op", "matmul_stats"])
