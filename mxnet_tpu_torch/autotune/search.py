"""The tuners: measure the tiles a hand-written kernel takes, keep the best.

The counterpart of ``mxnet_tpu/autotune/search.py``.  :func:`measure` is
the one timing code path (min of N, the first call untimed).  The tuners
(:func:`tune_flash`, :func:`tune_matmul_stats`, :func:`tune_conv_block`)
enumerate a candidate space that always holds the kernel's built-in choice,
first, so that a winner never measures worse than it; run every candidate
through the wrapper's explicit override (``blocks=`` of the flash wrappers,
``config=`` of K5, the ``pallas`` flag of the fused block); record each
measurement in the cost database (kind ``kernel``, ``source="autotune"``,
the cost model's training data); and commit the winner to the tuning cache
with the built-in choice's wall beside it.

Where JAX enumerates a TPU's divisor lattice of blocks, the candidates here
are the CUDA kernels' own tiles (``ops.flash_attention.kernel_tiles``:
``block_q`` by ``block_k``; K5's ``bn`` widths and persistent-grid
``rows``).  On the card a candidate is timed by CUDA events around a CUDA
graph of ``chain`` calls (:func:`measure_device`): a tile changes what the
kernel does on the card, not the host's cost a call, which at ResNet-50's
shapes is longer than K5's own time.  On the CPU the wrappers run their
plain versions, so the tuners exercise their control flow only.

:func:`inline_search` is the bounded search ``MXNET_TPU_AUTOTUNE=search``
runs on a miss: few candidates, one repeat, flash shapes with batch and
heads shrunk to 1, committed under the original key (as a proxy entry).
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

__all__ = [
    "measure", "measure_device", "divisors",
    "candidate_flash_configs", "candidate_matmul_configs",
    "tune_flash", "tune_matmul_stats", "tune_conv_block",
    "inline_search", "same_config",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def measure(fn, args=(), repeats=3, chain=1):
    """Min-of-N wall seconds of one ``fn(*args)`` application.

    One untimed call first (it builds and loads what the call needs).  Each
    of ``repeats`` samples then runs ``chain`` applications back to back and
    is closed by ``torch.cuda.synchronize()`` when the card is in use, by
    the host clock alone on the CPU; the least sample is divided by
    ``chain``.  The JAX runner chains its applications inside one jitted
    ``lax.scan`` with a data dependence between them, so that XLA neither
    merges them nor pays a dispatch for each; eager PyTorch runs every call
    as it is called and enqueues kernels without waiting for them, so a plain
    loop does the same here.
    """
    args = tuple(args)
    chain = max(1, int(chain))
    fn(*args)
    _sync()
    walls = []
    for _ in range(max(1, int(repeats))):
        t0 = time.perf_counter()
        for _ in range(chain):
            fn(*args)
        _sync()
        walls.append(time.perf_counter() - t0)
    return min(walls) / chain


def measure_device(fn, args=(), repeats=3, chain=10, device=None):
    """Min-of-N device seconds of one ``fn(*args)`` on a CUDA ``device``:
    one untimed call, then ``chain`` calls captured into a CUDA graph whose
    replays are timed by CUDA events, the least replay divided by
    ``chain``.  On any other device, :func:`measure`."""
    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda":
        return measure(fn, args, repeats=repeats, chain=1)
    args = tuple(args)
    chain = max(1, int(chain))
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*args)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(chain):
                fn(*args)
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        walls = []
        for _ in range(max(1, int(repeats))):
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            walls.append(start.elapsed_time(end) * 1e-3)
        del graph
    return min(walls) / chain


# ---------------------------------------------------- candidate spaces

def divisors(n, lo=1, hi=None):
    """Sorted divisors of ``n`` in ``[lo, hi]``."""
    hi = n if hi is None else hi
    out = [d for d in range(1, int(math.isqrt(n)) + 1) if n % d == 0]
    out = sorted(set(out + [n // d for d in out]))
    return [d for d in out if lo <= d <= hi]


def candidate_flash_configs(t, head_dim=64, dtype="float32", which="fwd",
                            limit=8):
    """The tiles of the ``which`` flash kernel at sequence length ``t``,
    head dim and dtype (``ops.flash_attention.kernel_tiles``), the built-in
    one first: ``{"block_q", "block_k", "n_k"}`` each."""
    from ..ops import flash_attention as fa
    out = [{"block_q": int(bq), "block_k": int(bk),
            "n_k": int(-(-t // bk))}
           for bq, bk in fa.kernel_tiles(which, _DTYPES[str(dtype)],
                                         head_dim)]
    return out[:max(2, int(limit))]


def candidate_matmul_configs(m, n, dtype="float32", limit=8, sms=None):
    """K5's configs at (M, N): ``{"bn", "rows"}`` with the built-in choice
    first (``ops.fused.heuristic_config``), then every width the kernel takes
    (``ops.fused.K5_TILES``, no wider than N needs), widest first, each at
    its built-in grid rows and at half of them.  ``sms``: the card's SM
    count (an H100's 132 by default)."""
    from ..ops import fused
    tdt = _DTYPES[str(dtype)]
    sms = int(sms or fused.H100_SMS)
    out, seen = [], set()

    def add(bn, rows):
        key = (int(bn), int(rows))
        if key not in seen and fused.config_takes(
                {"bn": bn, "rows": rows}, m, n, tdt, sms):
            seen.add(key)
            out.append({"bn": key[0], "rows": key[1]})

    heur = fused.heuristic_config(m, n, tdt, sms)
    add(heur["bn"], heur["rows"])
    for bn in sorted(fused.K5_TILES[tdt], reverse=True):
        rows = fused.grid_rows(m, n, bn, sms)
        add(bn, rows)
        add(bn, max(1, rows // 2))
    return out[:max(2, int(limit))]


# -------------------------------------------------------------- tuners

def _device(device):
    return torch.device(device if device is not None else "cuda")


def _record_candidate(op, shapes, dtypes, cfg, wall, flops=None,
                      bytes_accessed=None, backend=None):
    """Every measured candidate becomes a cost-database kernel record
    (``source="autotune"``), the cost model's food."""
    from ..telemetry import costdb
    costdb.record("kernel", op, wall_s=wall, flops=flops,
                  bytes_accessed=bytes_accessed, shapes=shapes,
                  dtypes=dtypes, block_config=dict(cfg), backend=backend,
                  source="autotune")


def same_config(a, b):
    """Config equality over the shared keys (a built-in config may omit a
    derived field such as ``n_k`` that a candidate carries); also the
    comparator ``tools.perf_top --suggest`` uses for "already-tuned"."""
    if not a or not b:
        return False
    keys = set(a) & set(b)
    return bool(keys) and all(a[k] == b[k] for k in keys)


def _finish(op, shapes, dtypes, extra, results, heur_cfg, commit, cache,
            source, proxy=False, backend=None):
    """Pick the winner, commit it to the cache, return the report."""
    from . import cache as _cache
    best = min(results, key=lambda r: r["wall_s"])
    heur = next((r for r in results
                 if same_config(r["config"], heur_cfg)), None)
    entry = None
    if commit:
        c = cache or _cache.CACHE
        entry = c.put(op, shapes, dtypes, best["config"],
                      wall_s=best["wall_s"], extra=extra, backend=backend,
                      heuristic_config=heur_cfg,
                      heuristic_wall_s=heur["wall_s"] if heur else None,
                      candidates=len(results), source=source, proxy=proxy)
    return {
        "op": op, "shapes": [list(s) for s in shapes],
        "dtypes": [str(d) for d in dtypes], "extra": extra,
        "best": best, "heuristic": heur,
        "candidates": results, "entry": entry,
    }


def _run_candidates(candidates, fn_of, repeats, chain, device, record):
    results = []
    for cfg in candidates:
        fn = fn_of(cfg)
        wall = measure_device(fn, (), repeats=repeats, chain=chain,
                              device=device)
        results.append({"config": cfg, "wall_s": wall})
        record(cfg, wall)
    return results


def tune_flash(shape, dtype="float32", causal=False, which="fwd",
               repeats=3, max_candidates=8, commit=True, cache=None,
               key_shape=None, seed=0, source="search", device=None,
               chain=10):
    """Tune the ``which`` (``fwd``/``bwd``) flash kernel at q, k, v shape
    ``(B, T, H, D)`` on ``device`` (the card unless the caller asks for the
    CPU), committing the winner under ``key_shape or shape``.  The
    backward's o and lse come from the forward at the built-in tile passed
    explicitly, so that no lookup (or, in search mode, no nested search)
    runs mid-tune.  Returns the report (``best``, ``heuristic``,
    ``candidates``, ``entry``)."""
    from ..ops import flash_attention as fa
    from ..telemetry import costdb
    dev = _device(device)
    b, t, h, d = shape
    tdt = _DTYPES[str(dtype)]
    rng = np.random.RandomState(seed)

    def mk():
        return torch.from_numpy(rng.normal(0, 1, (b, t, h, d)).astype(
            np.float32)).to(device=dev, dtype=tdt)

    q, k, v = mk(), mk(), mk()
    cands = candidate_flash_configs(t, d, dtype, which, max_candidates)
    heur_cfg = dict(cands[0])
    op = "flash_attention_%s" % which
    dtypes = [str(dtype)]
    n_mat, n_tens = (4, 4) if which == "fwd" else (10, 8)
    flops = float(n_mat) * b * h * t * t * d
    bytes_ = float(n_tens) * b * t * h * d * q.element_size()
    backend = costdb.backend_name(dev)
    if which == "bwd":
        # the forward's own built-in tile
        o, lse = fa.flash_attention_fwd(
            q, k, v, causal, blocks=fa.kernel_tiles("fwd", tdt, d)[0])
        g = mk()

    def fn_of(cfg):
        blocks = (cfg["block_q"], cfg["block_k"])
        if which == "fwd":
            return lambda: fa.flash_attention_fwd(q, k, v, causal,
                                                  blocks=blocks)
        return lambda: fa.flash_attention_bwd(q, k, v, o, lse, g, causal,
                                              blocks=blocks)

    results = _run_candidates(
        cands, fn_of, repeats, chain, dev,
        lambda cfg, wall: _record_candidate(
            op, [tuple(shape)], dtypes, cfg, wall, flops=flops,
            bytes_accessed=bytes_, backend=backend))
    # a reduced proxy's walls must not pass for full-shape ones
    proxy = key_shape is not None and tuple(key_shape) != tuple(shape)
    return _finish(op, [tuple(key_shape or shape)], dtypes,
                   {"causal": bool(causal)}, results, heur_cfg, commit,
                   cache, source, proxy=proxy, backend=backend)


def tune_matmul_stats(m, k, n, dtype="float32", repeats=3,
                      max_candidates=8, commit=True, cache=None, seed=0,
                      source="search", device=None, chain=10):
    """Tune K5's tile width and grid rows at GEMM shape (M, K, N) on
    ``device``.  Every shape is tunable: the wrapper pads what TMA does not
    take (the JAX tuner refuses the shapes its Pallas path does not
    take)."""
    from ..ops import fused
    from ..telemetry import costdb
    dev = _device(device)
    tdt = _DTYPES[str(dtype)]
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).to(
        device=dev, dtype=tdt)
    w = torch.from_numpy((rng.normal(0, 1, (k, n)) * 0.05).astype(
        np.float32)).to(device=dev, dtype=tdt)
    c = torch.from_numpy(rng.normal(0, 1, (n,)).astype(np.float32)).to(dev)
    sms = fused._partial_rows(dev) if dev.type == "cuda" else None
    cands = candidate_matmul_configs(m, n, dtype, max_candidates, sms)
    op = "matmul_stats"
    shapes = [(m, k), (k, n)]
    dtypes = [str(dtype)] * 2
    flops = 2.0 * m * n * k
    bytes_ = float((m * k + k * n + m * n) * x.element_size())
    backend = costdb.backend_name(dev)
    results = _run_candidates(
        cands, lambda cfg: (lambda: fused.matmul_stats(x, w, c, config=cfg)),
        repeats, chain, dev,
        lambda cfg, wall: _record_candidate(
            op, shapes, dtypes, cfg, wall, flops=flops,
            bytes_accessed=bytes_, backend=backend))
    return _finish(op, shapes, dtypes, None, results, dict(cands[0]),
                   commit, cache, source, backend=backend)


def tune_conv_block(x_shape, w_shape, kind="conv_bn_act", act="relu",
                    layout="NHWC", dtype="float32", repeats=3, commit=True,
                    cache=None, seed=0, source="search", device=None,
                    chain=5):
    """A/B the two lowerings of a K5-eligible fused conv block: K5's leg
    (``FusedConvBN``) against the library leg (``ConvBNAct``: cuDNN's
    convolution and the BN math), forward only as in JAX.  The winner
    persists as ``{"pallas": 0|1}`` under the ``block:<kind>`` key that
    ``analysis.fusion.apply_block`` consults.  ``x_shape``: NHWC
    activations ``(N, H, W, C)``; ``w_shape``: OIHW ``(O, C, 1, 1)``."""
    from ..ops import fused
    from ..telemetry import costdb
    dev = _device(device)
    tdt = _DTYPES[str(dtype)]
    nout = w_shape[0]
    rng = np.random.RandomState(seed)

    def t(a, dt=tdt):
        return torch.from_numpy(a.astype(np.float32)).to(device=dev,
                                                         dtype=dt)

    x = t(rng.uniform(-1, 1, x_shape))
    w = t(rng.normal(0, 0.1, w_shape))
    if layout == "NHWC" and dev.type == "cuda":
        w = w.contiguous(memory_format=torch.channels_last)
    gamma = t(rng.uniform(0.5, 1.5, (nout,)), torch.float32)
    beta = t(rng.uniform(-0.2, 0.2, (nout,)), torch.float32)
    mm = torch.zeros(nout, device=dev)
    mv = torch.ones(nout, device=dev)
    conv_attrs = {"kernel": (1, 1), "stride": (1, 1), "pad": (0, 0),
                  "dilate": (1, 1), "num_group": 1, "no_bias": True}
    bn_attrs = {"eps": 1e-5, "momentum": 0.9, "fix_gamma": False}

    def fn_of(cfg):
        def fn():
            with torch.no_grad():
                return fused.fused_block_conv_bn_act(
                    conv_attrs, bn_attrs, layout, True, act,
                    bool(cfg["pallas"]), x, w, None, gamma, beta, mm,
                    mv)[0]
        return fn

    op = "block:%s" % kind
    shapes = [tuple(x_shape), tuple(w_shape)]
    dtypes = [str(dtype)] * 2
    results = _run_candidates([{"pallas": 1}, {"pallas": 0}], fn_of,
                              repeats, chain, dev, lambda cfg, wall: None)
    # the planner's default is K5's leg where the block takes it
    return _finish(op, shapes, dtypes, {"layout": layout, "act": act or ""},
                   results, {"pallas": 1}, commit, cache, source,
                   backend=costdb.backend_name(dev))


# -------------------------------------------------------- inline search

#: the bounded inline search's budget (MXNET_TPU_AUTOTUNE=search, a miss)
_INLINE_CANDIDATES = 4
_INLINE_REPEATS = 1


def inline_search(op, shapes, dtypes, mesh=None, extra=None, backend=None):
    """The bounded search a miss runs in ``search`` mode: flash shapes with
    batch and heads shrunk to 1 (the tile is a matter of the sequence and
    head geometry), few candidates, one repeat, committed under the
    original key as a proxy entry; K5 at its own shape.  Returns the
    committed entry, or None for an op it does not know (the caller reads
    None as a plain miss).  On a backend other than ``gpu`` it measures the
    plain versions on the CPU."""
    extra = dict(extra or {})
    device = "cuda" if backend in (None, "gpu") and \
        torch.cuda.is_available() else "cpu"
    if op in ("flash_attention_fwd", "flash_attention_bwd"):
        _b, t, _h, d = shapes[0]
        rep = tune_flash((1, t, 1, d), dtype=dtypes[0],
                         causal=bool(extra.get("causal")),
                         which=op.rsplit("_", 1)[1],
                         repeats=_INLINE_REPEATS,
                         max_candidates=_INLINE_CANDIDATES,
                         key_shape=tuple(shapes[0]),
                         source="inline-search", device=device)
        return rep["entry"]
    if op == "matmul_stats":
        (m, k), (_k2, n) = shapes[0], shapes[1]
        rep = tune_matmul_stats(m, k, n, dtype=dtypes[0],
                                repeats=_INLINE_REPEATS,
                                max_candidates=_INLINE_CANDIDATES,
                                source="inline-search", device=device)
        return rep["entry"]
    return None
