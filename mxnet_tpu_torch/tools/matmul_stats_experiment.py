"""Experiment: the GEMM with a BatchNorm-statistics epilogue, with and without
the previous BatchNorm folded into its prologue, against cuBLAS and separate
statistics passes, at the ResNet-50 1x1-convolution shapes.

    python -m mxnet_tpu_torch.tools.matmul_stats_experiment

The counterpart of ``tools/pallas_matmul_stats_experiment.py``.  K7,
:func:`matmul_stats`, is ``y = x @ w``, ``s = sum(y)``, ``ss = sum(y * y)``
over the rows from the f32 accumulator: the K5 kernel
(``csrc/matmul_stats.cu``) with ``c = 0``.  K8, :func:`matmul_stats_prologue`,
is the same of ``bf16(relu(x * scale + shift))``, the kernel's prologue
variant.  The yardsticks are cuBLAS ``x @ w`` in bf16, alone
(:func:`library_dot_only`), followed by two f32 ``torch.sum`` passes over
the rounded ``y`` (:func:`library_ref`), and after an eager prologue
(:func:`library_prologue`).  Any M.

The weight lies as the kernel reads it, (N, K) rows, and is passed as its
(K, N) transpose, so the K5 wrapper's ``w.t().contiguous()`` makes no copy
and none is timed; the ``c = 0`` vector the wrapper is given is made once
per call, for K7 here and for K8 inside ``ops.fused``.  Times are
:func:`mxnet_tpu_torch.autotune.measure`'s: min over ``repeats`` samples of
``chain`` calls each, closed by ``torch.cuda.synchronize()``.  It prints a
table in ms and the card's name and power limit, and needs a CUDA device.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import fused

__all__ = ["shapes", "matmul_stats", "matmul_stats_prologue", "library_ref",
           "library_dot_only", "library_prologue", "experiment", "main"]


def shapes(batch=128):
    """``(M, K, N)`` of the ResNet-50 1x1 convolutions the JAX tool times,
    M = batch * H * W."""
    return [(batch * 56 * 56, 64, 256), (batch * 56 * 56, 256, 64),
            (batch * 28 * 28, 512, 128), (batch * 28 * 28, 128, 512),
            (batch * 14 * 14, 1024, 256), (batch * 14 * 14, 256, 1024),
            (batch * 7 * 7, 2048, 512), (batch * 7 * 7, 512, 2048)]


def _rows(out):
    y, s, ss = out
    return y, s.reshape(1, -1), ss.reshape(1, -1)


def matmul_stats(x, w):
    """K7: ``(y, s, ss)``, ``y = x @ w`` in x's dtype and the f32 (1, N)
    sums of y and y^2 from the accumulator (``ops.fused.matmul_stats`` with
    ``c = 0``)."""
    c = torch.zeros(w.shape[1], dtype=torch.float32, device=x.device)
    return _rows(fused.matmul_stats(x, w, c))


def matmul_stats_prologue(x, w, scale, shift):
    """K8: :func:`matmul_stats` of ``relu(x * scale + shift)`` rounded to
    x's dtype; ``scale``, ``shift`` (1, K) f32."""
    return _rows(fused.matmul_stats_prologue(x, w, scale, shift))


def library_ref(x, w):
    """cuBLAS ``x @ w`` in x's dtype, then the f32 sums of the rounded y
    and its square over the rows (the JAX tool's ``xla_ref``)."""
    y = x @ w
    yf = y.float()
    return y, yf.sum(0), (yf * yf).sum(0)


def library_dot_only(x, w):
    """cuBLAS ``x @ w`` alone (the JAX tool's ``xla_dot_only``)."""
    return x @ w


def library_prologue(x, w, scale, shift):
    """:func:`library_ref` after the prologue in eager PyTorch."""
    return library_ref(torch.relu(x.float() * scale + shift).to(x.dtype), w)


def experiment(batch=128, repeats=2, chain=24, device="cuda"):
    """For each shape: inputs from ``RandomState(0)``, K7 held against
    :func:`library_ref` as the JAX tool holds its kernel against XLA, then
    the five timings.  Returns one dict a shape, times in ms."""
    from ..autotune import measure

    rng = np.random.RandomState(0)
    out = []
    for m, k, n in shapes(batch):
        x, w, scale, shift = (
            torch.from_numpy(a.astype(np.float32)).to(device)
            for a in (rng.randn(m, k), rng.randn(k, n) * 0.05,
                      rng.rand(1, k), rng.randn(1, k)))
        x = x.to(torch.bfloat16)
        # (N, K) rows as the kernel reads them, passed as the (K, N) view
        w = w.to(torch.bfloat16).t().contiguous().t()
        # y within bf16 rounding; the statistics within the slack of
        # summing the rounded y (the kernel sums the f32 accumulator)
        y0, s0, ss0 = library_ref(x, w)
        y1, s1, _ss1 = matmul_stats(x, w)
        torch.testing.assert_close(y1.float(), y0.float(), rtol=2e-2,
                                   atol=2e-1)
        stat_scale = ss0.mean().sqrt().item()
        err = ((s1[0] - s0).abs() / stat_scale).max().item()
        if not err < 0.05:
            raise AssertionError("stats diverge: %g" % err)
        del y0, y1

        def ms(fn, *args):
            return measure(fn, args, repeats=repeats, chain=chain) * 1e3

        out.append({
            "M": m, "K": k, "N": n,
            "dot_ms": ms(library_dot_only, x, w),
            "library_ms": ms(library_ref, x, w),
            "kernel_ms": ms(matmul_stats, x, w),
            "prologue_ms": ms(matmul_stats_prologue, x, w, scale, shift),
            "library_prologue_ms": ms(library_prologue, x, w, scale, shift)})
    return out


def main(argv=None):
    from . import nvidia_smi

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--chain", type=int, default=24)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("matmul_stats_experiment: no CUDA device; this "
                         "tool measures the GPU")
    rows = experiment(a.batch, a.repeats, a.chain)
    print(nvidia_smi())
    print(f"{'M':>9} {'K':>5} {'N':>5} | {'lib dot':>8} {'lib+st':>8} "
          f"{'kernel':>8} {'ker+pro':>8} {'lib+pro':>8}  (ms)")
    for r in rows:
        print(f"{r['M']:>9} {r['K']:>5} {r['N']:>5} | {r['dot_ms']:8.3f} "
              f"{r['library_ms']:8.3f} {r['kernel_ms']:8.3f} "
              f"{r['prologue_ms']:8.3f} {r['library_prologue_ms']:8.3f}")
    return rows


if __name__ == "__main__":
    main()
