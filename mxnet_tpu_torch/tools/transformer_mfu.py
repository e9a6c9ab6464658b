"""Training throughput and MFU of the GPT LM on one NVIDIA GPU.

    python -m mxnet_tpu_torch.tools.transformer_mfu            # one JSON line
    python -m mxnet_tpu_torch.tools.transformer_mfu --json-only

The port's counterpart of ``tools/transformer_mfu.py``: the same FLOP
accounting and the same JSON fields, plus ``device`` and ``nvidia_smi``
(the card's name and power limit, since a card set below its 700 W
maximum runs slower under load).  It has the same flags but
``--auto-layouts``, which picks XLA state layouts and has no counterpart
in eager PyTorch.  It
trains the GPT of ``models.gpt.build_bench_trainer`` (default d_model 1024,
12 layers, seq 1024, batch 16, bf16, Adam) on ``gpu(0)``, times
``run_steps`` on the host clock after ``torch.cuda.synchronize()``, and
reports tokens/s and model FLOPs utilization against ``--peak-tflops``
(default: the H100's 989 TFLOP/s bf16 dense peak, NVIDIA data sheet).  It
needs a CUDA device and fails without one.

FLOP accounting (per token, forward; train = 3x forward):

  per layer : qkv 6*d^2, proj 2*d^2, ffn 16*d^2 (two 2*d*4d matmuls),
              attn 4*S*d (QK^T and AV over the full panel, the standard
              MFU convention even though the causal kernels skip half)
  head      : 2*d*V
  (embedding lookups, layernorms, softmax: not counted)
"""
from __future__ import annotations

import argparse
import json
import time

from . import nvidia_smi

#: the H100 SXM's bf16 dense tensor-core peak (NVIDIA data sheet), TFLOP/s
H100_BF16_PEAK_TFLOPS = 989.0


def flops_per_token(d, n_layers, seq, vocab):
    per_layer = 24 * d * d + 4 * seq * d
    head = 2 * d * vocab
    fwd = n_layers * per_layer + head
    return {"per_layer": per_layer, "head": head, "fwd": fwd,
            "train": 3 * fwd}


def measure_steps(trainer, batch, steps, repeats, d_model, layers, seq,
                  vocab, peak_tflops=H100_BF16_PEAK_TFLOPS):
    """Time ``repeats`` calls of ``trainer.run_steps(batch, steps)`` on the
    host clock, each between two ``torch.cuda.synchronize()`` calls when
    the trainer lives on the card, and derive from the best the step time,
    tokens/s, TFLOP/s and MFU against ``peak_tflops`` by the accounting
    above.  The tokens of a step are the elements of ``batch["data"]``."""
    import torch

    def sync():
        if trainer.mesh.device.type == "cuda":
            torch.cuda.synchronize()

    times = []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        losses = trainer.run_steps(batch, steps)
        sync()
        times.append(time.perf_counter() - t0)
    step_s = min(times) / steps
    tokens = int(batch["data"].numel())
    acct = flops_per_token(d_model, layers, seq, vocab)
    step_tflop = acct["train"] * tokens / 1e12
    tflops = step_tflop / step_s
    return {"losses": losses, "repeats_s": times, "step_ms": step_s * 1e3,
            "tokens_per_s": tokens / step_s, "accounting": acct,
            "step_tflop": step_tflop, "tflops_per_s": tflops,
            "mfu": tflops / peak_tflops}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--d-model", type=int, default=1024)
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--heads", type=int, default=16)
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--vocab", type=int, default=16384)
    p.add_argument("--steps", type=int, default=8,
                   help="steps per timed run_steps call")
    p.add_argument("--repeats", type=int, default=3,
                   help="timed run_steps calls (best is reported)")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--peak-tflops", type=float,
                   default=H100_BF16_PEAK_TFLOPS,
                   help="device bf16 peak (H100 SXM: 989)")
    p.add_argument("--json-only", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    import numpy as np
    import torch

    from ..models.gpt import build_bench_trainer

    a = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("transformer_mfu: no CUDA device; this tool "
                         "measures the GPU")

    def note(msg):
        if not a.json_only:
            print("[mfu] " + msg, flush=True)

    note("building trainer...")
    trainer, batch = build_bench_trainer(
        vocab=a.vocab, seq=a.seq, d_model=a.d_model, heads=a.heads,
        layers=a.layers, batch=a.batch, dtype=a.dtype)

    note("warming up with one %d-step run..." % a.steps)
    losses = trainer.run_steps(batch, a.steps)
    if not np.isfinite(float(losses[-1])):
        raise SystemExit("transformer_mfu: non-finite loss %r" % losses)
    note("measuring...")
    m = measure_steps(trainer, batch, a.steps, a.repeats, a.d_model,
                      a.layers, a.seq, a.vocab, a.peak_tflops)
    last = float(m["losses"][-1])
    if not np.isfinite(last):
        raise SystemExit("transformer_mfu: non-finite loss %r" % last)
    acct = m["accounting"]

    n_params = sum(int(np.prod(v.shape)) for v in trainer.params.values())
    if not a.json_only:
        print("config: d=%d L=%d H=%d S=%d B=%d V=%d dtype=%s  "
              "params=%.1fM" % (a.d_model, a.layers, a.heads, a.seq,
                                a.batch, a.vocab, a.dtype, n_params / 1e6))
        print("flops/token: layer=%s x%d  head=%s  fwd=%s  train=%s"
              % ("{:,}".format(acct["per_layer"]), a.layers,
                 "{:,}".format(acct["head"]),
                 "{:,}".format(acct["fwd"]),
                 "{:,}".format(acct["train"])))
        print("step: %.2f ms  (%d-step run, best of %d; loss %.4f)"
              % (m["step_ms"], a.steps, a.repeats, last))
    print(json.dumps({
        "metric": "transformer_lm_mfu",
        "value": round(m["mfu"] * 100, 2), "unit": "%",
        "tokens_per_sec": round(m["tokens_per_s"], 1),
        "tflops_per_sec": round(m["tflops_per_s"], 2),
        "peak_tflops": a.peak_tflops,
        "step_ms": round(m["step_ms"], 3),
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": nvidia_smi(),
        "config": {"d_model": a.d_model, "layers": a.layers,
                   "heads": a.heads, "seq": a.seq, "batch": a.batch,
                   "vocab": a.vocab, "dtype": a.dtype,
                   "params_m": round(n_params / 1e6, 1)},
    }))


if __name__ == "__main__":
    main()
