"""Experiment: one ResNet stage-1 bottleneck block as one CUDA kernel (K9)
against three library convolutions with eager BatchNorm-ReLU between them.

    python -m mxnet_tpu_torch.tools.block_experiment [--batch 128]

The counterpart of ``tools/pallas_block_experiment.py``: BN-ReLU, 1x1
cin -> cmid, BN-ReLU, 3x3 cmid -> cmid, BN-ReLU, 1x1 cmid -> cout over an
NHWC (N, 56, 56, cin) bf16 activation, each BatchNorm folded to a
per-channel scale and shift (the inference form).  :func:`block_kernel`
launches ``csrc/bottleneck_block.cu`` for a CUDA tensor (or raises) and
takes :func:`block_plain` for a CPU tensor; ``block_kernel.launches``
counts launches.  :func:`library_block` is the yardstick, the JAX tool's
``xla_block``: cuDNN's convolutions on the channels-last view, the
BatchNorm-ReLU passes in eager f32, each input rounded to bf16 before its
convolution.

The kernel keeps a band of ``--rows`` image rows and its halo in shared
memory; the TPU kernel's 8 rows do not fit beside the weights there, so
the default is 4.  It prints one JSON line (times from
:func:`mxnet_tpu_torch.autotune.measure`, ``--repeats`` samples of 10
chained calls) with the card's name and power limit, and needs a CUDA
device.  ``--check-only`` runs batch 2 and checks the error alone.
"""
from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError

__all__ = ["H", "W", "KERNEL_CONFIGS", "block_kernel", "block_plain",
           "library_block", "inputs", "rel_err", "experiment", "main"]

H = W = 56

#: (cin, cmid, cout, rows) that csrc/bottleneck_block.cu instantiates
KERNEL_CONFIGS = ((64, 64, 256, 4), (64, 64, 256, 2), (16, 16, 32, 4),
                  (16, 16, 32, 2))


def _channels(x, w1, w2, w3, scales, shifts, rows):
    """``(cin, cmid, cout)``; raises on shapes the block does not take."""
    if x.dim() != 4 or tuple(x.shape[1:3]) != (H, W) or H % rows:
        raise MXNetError("bottleneck block: x must be (N, %d, %d, cin) with "
                         "rows dividing %d, got %s and rows %d"
                         % (H, W, H, tuple(x.shape), rows))
    cin = x.shape[3]
    cmid, cout = w1.shape[1], w3.shape[1]
    if tuple(w1.shape) != (cin, cmid) or tuple(w2.shape) != (9, cmid, cmid) \
            or tuple(w3.shape) != (cmid, cout):
        raise MXNetError("bottleneck block: need w1 (cin, cmid), w2 (9, "
                         "cmid, cmid), w3 (cmid, cout), got %s %s %s"
                         % (tuple(w1.shape), tuple(w2.shape),
                            tuple(w3.shape)))
    if scales.shape != shifts.shape or scales.dim() != 2 or \
            scales.shape[0] != 3 or scales.shape[1] < max(cin, cmid):
        raise MXNetError("bottleneck block: scales and shifts must be (3, "
                         ">= max(cin, cmid)), got %s and %s"
                         % (tuple(scales.shape), tuple(shifts.shape)))
    return cin, cmid, cout


def block_plain(x, w1, w2, w3, scales, shifts):
    """The TPU kernel's math in f32 over the whole image: the one-cell zero
    halo, BN-ReLU, the 1x1, BN-ReLU, the image-edge ring set to 0 (the
    pointwise chain turned its zeros into relu(b1)), the 3x3 as 9 shifted
    products, BN-ReLU, the 1x1 expand; ``y`` in x's dtype."""
    cin, cmid, cout = _channels(x, w1, w2, w3, scales, shifts, 1)
    s, b = scales.float(), shifts.float()
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))          # (N, H+2, W+2, cin)
    a = torch.relu(xp * s[0, :cin] + b[0, :cin])
    t1 = torch.relu((a @ w1.float()) * s[1, :cmid] + b[1, :cmid])
    interior = torch.zeros(H + 2, W + 2, 1, dtype=torch.bool,
                           device=x.device)
    interior[1:H + 1, 1:W + 1] = True
    t1 = torch.where(interior, t1, torch.zeros((), device=x.device))
    acc = 0
    for dy in range(3):
        for dx in range(3):
            acc = acc + t1[:, dy:dy + H, dx:dx + W] @ w2[dy * 3 + dx].float()
    t2 = torch.relu(acc * s[2, :cmid] + b[2, :cmid])
    return (t2 @ w3.float()).to(x.dtype)


def library_block(x, w1, w2, w3, scales, shifts):
    """The same block through the library's convolutions (cuDNN on the
    card) on the channels-last view of the NHWC activations, with the
    weights in ``channels_last`` OIHW form, BN-ReLU in f32 and each
    convolution's input rounded to x's dtype: the JAX tool's
    ``xla_block``."""
    cin, cmid, cout = _channels(x, w1, w2, w3, scales, shifts, 1)

    def bn_relu(t, i, c):
        return torch.relu(t.float() * scales[i, :c] + shifts[i, :c]) \
            .to(x.dtype)

    def conv(t, w_oihw, pad):
        w_oihw = w_oihw.to(x.dtype).contiguous(
            memory_format=torch.channels_last)
        return F.conv2d(t.permute(0, 3, 1, 2), w_oihw, padding=pad) \
            .permute(0, 2, 3, 1)

    t1 = conv(bn_relu(x, 0, cin), w1.t()[:, :, None, None], 0)
    w2k = w2.reshape(3, 3, cmid, cmid).permute(3, 2, 0, 1)
    t2 = conv(bn_relu(t1, 1, cmid), w2k, 1)
    return conv(bn_relu(t2, 2, cmid), w3.t()[:, :, None, None], 0)


def _kernel():
    from .. import cuda_build
    lib = cuda_build.library("bottleneck_block")
    fn = lib.mxtt_bottleneck_block
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mxtt_bottleneck_block_error_string.argtypes = [ctypes.c_int]
        lib.mxtt_bottleneck_block_error_string.restype = ctypes.c_char_p
    return lib, fn


def _launch(x, w1, w2, w3, scales, shifts, rows):
    cin, cmid, cout = _channels(x, w1, w2, w3, scales, shifts, rows)
    if (cin, cmid, cout, rows) not in KERNEL_CONFIGS:
        raise MXNetError("bottleneck block: the kernel takes (cin, cmid, "
                         "cout, rows) in %s, got %s"
                         % (KERNEL_CONFIGS, (cin, cmid, cout, rows)))
    if any(t.dtype != torch.bfloat16 for t in (x, w1, w2, w3)) or \
            scales.dtype != torch.float32 or shifts.dtype != torch.float32:
        raise MXNetError("bottleneck block: the kernel takes bf16 x and "
                         "weights and f32 scales and shifts")
    if any(t.device != x.device for t in (w1, w2, w3, scales, shifts)):
        raise MXNetError("bottleneck block: inputs on different devices")
    x, w1, w2, w3, scales, shifts = (
        t.contiguous() for t in (x, w1, w2, w3, scales, shifts))
    y = torch.empty(x.shape[:3] + (cout,), dtype=x.dtype, device=x.device)
    lib, fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), w1.data_ptr(), w2.data_ptr(), w3.data_ptr(),
                scales.data_ptr(), shifts.data_ptr(), y.data_ptr(),
                x.shape[0], H, W, cin, cmid, cout, scales.shape[1], rows,
                stream)
    if rc != 0:
        raise MXNetError("bottleneck block: CUDA launch failed: %s (%d)" % (
            lib.mxtt_bottleneck_block_error_string(rc).decode(), rc))
    return y


def block_kernel(x, w1, w2, w3, scales, shifts, rows=4):
    """``x`` (N, 56, 56, cin) -> (N, 56, 56, cout), weights as the JAX
    tool's ``pallas_block`` takes them: w1 (cin, cmid), w2 (9, cmid, cmid),
    w3 (cmid, cout); scales, shifts (3, >= max(cin, cmid)) f32.  A CUDA
    tensor launches K9 on bands of ``rows`` image rows (or raises); a CPU
    tensor takes :func:`block_plain`."""
    kind = x.device.type
    if kind == "cuda":
        y = _launch(x, w1, w2, w3, scales, shifts, rows)
        block_kernel.launches += 1
        return y
    if kind == "cpu":
        _channels(x, w1, w2, w3, scales, shifts, rows)
        return block_plain(x, w1, w2, w3, scales, shifts)
    raise MXNetError("bottleneck block: no path for device %s" % x.device)


block_kernel.launches = 0


def inputs(n, cin=64, cmid=64, cout=256, device="cuda", seed=0):
    """``(x, w1, w2, w3, scales, shifts)`` from ``RandomState(seed)``, drawn
    as the JAX tool draws them: bf16 activation and weights, f32 scales in
    [0.5, 1.5) and shifts in [-0.2, 0.2)."""
    rng = np.random.RandomState(seed)
    cmax = max(cin, cmid)
    arrays = (rng.uniform(-1, 1, (n, H, W, cin)),
              rng.normal(0, 0.1, (cin, cmid)),
              rng.normal(0, 0.05, (9, cmid, cmid)),
              rng.normal(0, 0.1, (cmid, cout)),
              rng.uniform(0.5, 1.5, (3, cmax)),
              rng.uniform(-0.2, 0.2, (3, cmax)))
    out = [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]
    return tuple(t.to(torch.bfloat16) for t in out[:4]) + tuple(out[4:])


def rel_err(args, rows):
    """max |kernel - library| over max |library| on ``args``, as the JAX
    tool reports its error."""
    y = block_kernel(*args, rows=rows).float()
    ref = library_block(*args).float()
    return ((y - ref).abs().max() / ref.abs().max().clamp_min(1e-6)).item()


def experiment(batch=128, cin=64, cmid=64, cout=256, rows=4, repeats=10,
               device="cuda"):
    """K9 against :func:`library_block` at ``batch``: :func:`rel_err` and
    the times in ms per call."""
    from ..autotune import measure

    args = inputs(batch, cin, cmid, cout, device)
    err = rel_err(args, rows)
    chain = 10
    t_k = measure(lambda *a: block_kernel(*a, rows=rows), args, repeats,
                  chain)
    t_l = measure(library_block, args, repeats, chain)
    gflop = 2 * batch * H * W * (cin * cmid + 9 * cmid * cmid
                                 + cmid * cout) / 1e9
    return {"metric": "stage1_block_kernel_vs_library",
            "kernel_ms": t_k * 1e3, "library_ms": t_l * 1e3,
            "speedup": t_l / t_k, "rel_err": err, "gflop": gflop,
            "kernel_tflops": gflop / t_k / 1e3,
            "library_tflops": gflop / t_l / 1e3,
            "batch": batch, "rows": rows, "channels": [cin, cmid, cout]}


def main(argv=None):
    from . import nvidia_smi

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--cin", type=int, default=64)
    ap.add_argument("--cmid", type=int, default=64)
    ap.add_argument("--cout", type=int, default=256)
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--check-only", action="store_true")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("block_experiment: no CUDA device; this tool "
                         "measures the GPU")
    if a.check_only:
        err = rel_err(inputs(2, a.cin, a.cmid, a.cout), a.rows)
        print("rel err %.3e" % err)
        if not err < 5e-2:
            raise SystemExit("block_experiment: rel err %g >= 5e-2" % err)
        print("OK")
        return None
    out = experiment(a.batch, a.cin, a.cmid, a.cout, a.rows, a.repeats)
    out.update(device=torch.cuda.get_device_name(0),
               nvidia_smi=nvidia_smi())
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
