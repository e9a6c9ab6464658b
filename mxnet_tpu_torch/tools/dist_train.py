"""Data-parallel training of the full-width models: one rank of a job.

    python mxnet_tpu_torch/tools/launch.py -n 2 -- \\
        python -m mxnet_tpu_torch.tools.dist_train legs OUT
    python mxnet_tpu_torch/tools/launch.py -n 2 --restart-budget 1 -- \\
        python -m mxnet_tpu_torch.tools.dist_train recovery OUT
    python mxnet_tpu_torch/tools/launch.py -n 1 -- \\
        python -m mxnet_tpu_torch.tools.dist_train nccl OUT
    python mxnet_tpu_torch/tools/launch.py -n 2 -- \\
        python -m mxnet_tpu_torch.tools.dist_train build OUT

Each rank writes ``OUT/<leg>.rank<r>.json``.  ``--cpu 1`` runs on the CPU
at a tiny size (:data:`TINY`), for a rehearsal.

``legs`` runs four legs in turn on this rank's card, each from seeded
weights, the rank stepping its own rows (``multihost.stage_local``) of
one seeded global batch:

* ``gpt``: the benchmark GPT (:data:`FULL`; bf16 over f32 masters, Adam
  at 1e-4) for :data:`GPT_STEPS` steps at global batch 16, on
  ``models.gpt.build_bench_trainer``'s batch (so the train phase of
  ``chip_smoke.py`` is its one-process reference);
* ``resnet``: ResNet-50 v2 as ``tools.bench`` trains it (bf16, NHWC,
  block fusion, SGD momentum) for :data:`RESNET_STEPS` steps at global
  batch 128, on :func:`resnet_batch`, whose halves differ in
  distribution; rank 0 also writes its masters and aux states after the
  first step (``OUT/resnet.state1.npz``), to be held against one
  process's;
* ``module``: ``tools.module_fit``'s ``Module.fit`` of the GPT (f32,
  dropout 0.1, Adam at 3e-3) at full width with :data:`MODULE_LAYERS`
  layers through a ``dist_sync`` store, :data:`MODULE_BATCHES` batches of
  16 with ``MXNET_TPU_OVERLAP`` off, then again from the same weights
  with it on;
* ``async``: the same Module under ``dist_async`` with DCASGD on the
  parameter server in rank 0.

Each leg records the losses, each step's wall (host clock after a
synchronize) and its ``collective_wait`` segment, the kernels' launch
counts over its steps, the peak memory, the CRC32 of every master and
aux array, and the trainer's build apart from its steps.  ``recovery``:
attempt 0 (``MXNET_TPU_RESTART_COUNT``) trains the GPT at full width with
:data:`RECOVERY_LAYERS` layers for :data:`RECOVERY_STEPS` steps
uninterrupted, then again with a checkpoint after step
:data:`KILL_AFTER` (rank 0 writes it), after which rank 1 SIGKILLs
itself; the launcher relaunches the job, and attempt 1 resumes from that
checkpoint.  ``nccl``: a job of one process (NCCL, the card's route at
world 1): a ``dist_sync`` push and pull of the full-width GPT's
parameters, which come back equal to the bit.  ``build``: the parts of a
rank's build of the full-width GPT trainer, timed apart (the first CUDA
touch, the symbol, the host draw of the initial weights, the trainer's
constructor, one broadcast of the state from rank 0); in a job or in a
process of its own, for the comparison.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import time

import numpy as np

__all__ = ["FULL", "TINY", "GPT_STEPS", "RESNET_STEPS", "MODULE_LAYERS",
           "MODULE_BATCHES", "RECOVERY_LAYERS", "RECOVERY_STEPS",
           "KILL_AFTER", "gpt_batch", "resnet_batch", "gpt_trainer",
           "resnet_trainer", "resnet_leg", "host_state", "main"]

#: the benchmark configuration of the GPT LM, ResNet-50 at bench.py's, the
#: global batches
FULL = {"gpt": {"vocab": 16384, "seq": 1024, "d_model": 1024, "heads": 16,
                "layers": 12, "batch": 16, "dtype": "bfloat16"},
        "resnet": {"layers": 50, "image": 224, "batch": 128, "classes": 1000,
                   "dtype": "bfloat16"}}
#: the CPU rehearsal's
TINY = {"gpt": {"vocab": 64, "seq": 32, "d_model": 32, "heads": 2,
                "layers": 2, "batch": 4, "dtype": "float32"},
        "resnet": {"layers": 18, "image": 32, "batch": 4, "classes": 10,
                   "dtype": "float32"}}
GPT_STEPS = 4
RESNET_STEPS = 3
MODULE_LAYERS = 2
MODULE_BATCHES = 2
RECOVERY_LAYERS = 2
RECOVERY_STEPS = 4
KILL_AFTER = 2
SEED = 0


def gpt_batch(cfg, step):
    """The GPT's global batch of ``step``: tokens from
    ``RandomState(step)``, labels the tokens shifted by one (step 0's is
    ``build_bench_trainer``'s)."""
    x = np.random.RandomState(step).randint(
        0, cfg["vocab"], (cfg["batch"], cfg["seq"])).astype(np.float32)
    return {"data": x, "softmax_label": np.roll(x, -1, 1).copy()}


def resnet_batch(cfg, step):
    """ResNet-50's global batch of ``step``: uniform(-1, 1) NCHW images
    and labels from ``RandomState(step)``, the second half of the rows
    (rank 1's of two) scaled by 2 and shifted by 1.  A rank's own batch
    statistics then differ from the global batch's at every BatchNorm, so
    a step that normalized each rank by its own rows would part from one
    process's at once."""
    rng = np.random.RandomState(step)
    n, s = cfg["batch"], cfg["image"]
    x = rng.uniform(-1, 1, (n, 3, s, s)).astype(np.float32)
    x[n // 2:] = x[n // 2:] * 2 + 1
    return {"data": x, "softmax_label": rng.randint(0, cfg["classes"], n)
            .astype(np.float32)}


def gpt_trainer(cfg, ctx, layers=None):
    """The GPT's ShardedTrainer on ``ctx``'s mesh (its data axis spans the
    job): Adam at 1e-4, weights from seed 0; ``cfg``'s global shapes."""
    from ..models.gpt import gpt_symbol
    from ..parallel import ShardedTrainer, build_mesh
    net = gpt_symbol(cfg["vocab"], cfg["seq"], cfg["d_model"], cfg["heads"],
                     layers or cfg["layers"], dropout=0.0)
    shape = (cfg["batch"], cfg["seq"])
    return ShardedTrainer(net, build_mesh(devices=[ctx]),
                          data_shapes={"data": shape},
                          label_shapes={"softmax_label": shape},
                          optimizer="adam", learning_rate=1e-4,
                          dtype=cfg["dtype"], seed=SEED)


def resnet_trainer(cfg, ctx):
    """``tools.bench``'s ResNet trainer (SGD momentum 0.9, lr 0.1, wd
    1e-4, NHWC, block fusion) on ``ctx``'s mesh, at ``cfg``'s global
    batch."""
    from ..models import get_model
    from ..parallel import ShardedTrainer, build_mesh
    s = cfg["image"]
    net = get_model("resnet%d" % cfg["layers"], num_classes=cfg["classes"],
                    image_shape="3,%d,%d" % (s, s))
    return ShardedTrainer(
        net, build_mesh(devices=[ctx]),
        data_shapes={"data": (cfg["batch"], 3, s, s)},
        label_shapes={"softmax_label": (cfg["batch"],)}, optimizer="sgd",
        learning_rate=0.1, momentum=0.9, weight_decay=1e-4,
        dtype=cfg["dtype"], layout="NHWC", fuse_blocks=True, seed=SEED)


def host_state(trainer):
    """The trainer's f32 masters and aux states as host arrays, keyed
    ``arg:<name>`` and ``aux:<name>``."""
    out = {"arg:" + k: v.detach().float().cpu().numpy().copy()
           for k, v in trainer.params.items()}
    out.update({"aux:" + k: v.detach().float().cpu().numpy().copy()
                for k, v in trainer.aux.items()})
    return out


def _crcs(named):
    from ..resilience import array_crc32
    return {k: array_crc32(v.detach().float().cpu().numpy())
            for k, v in sorted(named.items())}


def _source_counts():
    """The flash forward's and backward's launches by source (the f32 and
    the bf16 kernels apart)."""
    from ..ops.flash_attention import flash_attention_bwd, flash_attention_fwd
    return dict(flash_attention_fwd.source_launches,
                **flash_attention_bwd.source_launches)


def _sync(ctx):
    import torch
    if ctx.device_type == "gpu":
        torch.cuda.synchronize()


def _steps(trainer, ctx, batch_of, steps, first=0, state_to=None):
    """``steps`` steps from global batch ``first`` on this rank's rows:
    losses, walls, collective waits and the kernels' launches.  With
    ``state_to``, rank 0 writes :func:`host_state` there after the first
    step."""
    import torch
    from . import kernel_counts, zero_kernel_counts
    from ..parallel import multihost
    if ctx.device_type == "gpu":
        torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    losses, walls, waits = [], [], []
    for i in range(first, first + steps):
        local = {k: multihost.stage_local(v) for k, v in batch_of(i).items()}
        _sync(ctx)
        t0 = time.perf_counter()
        loss = trainer.step(local)
        _sync(ctx)
        walls.append(time.perf_counter() - t0)
        waits.append(trainer._seg["collective_s"])
        losses.append(float(loss))
        if state_to and i == first and multihost.rank() == 0:
            np.savez(state_to, **host_state(trainer))
    out = {"losses": losses, "step_wall_s": walls,
           "collective_wait_s": waits, "launches": kernel_counts(),
           "source_launches": _source_counts(),
           "steps": steps, "params": _crcs(trainer.params),
           "aux": _crcs(trainer.aux)}
    if ctx.device_type == "gpu":
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    return out


def _module_data(cfg, layers):
    from . import module_fit
    mcfg = dict(cfg, layers=layers)
    net, x, y = module_fit._net_and_data(mcfg, cfg["batch"], MODULE_BATCHES,
                                         module_fit.SUPPORT)
    return net, x, y


def _module_fit(cfg, ctx, kv, optimizer, opt_params):
    """``module_fit``'s Module route on this rank's rows of each batch,
    through ``kv``; returns the module and each batch's wall."""
    from .. import Module, init, io, random
    from ..parallel import multihost
    net, x, y = _module_data(cfg, MODULE_LAYERS)
    local = cfg["batch"] // kv.num_workers
    rows = [np.arange(i * cfg["batch"], (i + 1) * cfg["batch"])
            for i in range(MODULE_BATCHES)]
    mine = np.concatenate([multihost.stage_local(r) for r in rows])
    it = io.NDArrayIter(x[mine], y[mine], local)
    stamps = []

    def stamp(_param):
        _sync(ctx)
        stamps.append(time.perf_counter())

    random.seed(SEED)
    mod = Module(net, context=ctx)
    _sync(ctx)
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, kvstore=kv, initializer=init.Xavier(rng=SEED),
            optimizer=optimizer, optimizer_params=opt_params,
            batch_end_callback=[stamp])
    return mod, [b - a for a, b in zip([t0] + stamps[:-1], stamps)]


def _module_leg(cfg, ctx):
    import torch
    from .. import kvstore
    from . import kernel_counts, zero_kernel_counts
    out = {}
    for overlap in (0, 1):
        os.environ["MXNET_TPU_OVERLAP"] = str(overlap)
        kv = kvstore.create("dist_sync")
        if ctx.device_type == "gpu":
            torch.cuda.reset_peak_memory_stats()
        zero_kernel_counts()
        mod, walls = _module_fit(cfg, ctx, kv, "adam",
                                 {"learning_rate": 3e-3})
        args, aux = mod.get_params()
        rec = {"overlap_active": kv.overlap_active, "batch_wall_s": walls,
               "launches": kernel_counts(),
               "source_launches": _source_counts(),
               "collectives": kv.collectives,
               "params": _crcs({k: v.data for k, v in args.items()})}
        if ctx.device_type == "gpu":
            rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        out["overlap%d" % overlap] = rec
    os.environ.pop("MXNET_TPU_OVERLAP", None)
    return out


def _async_leg(cfg, ctx):
    """Module.fit under ``dist_async`` with DCASGD on the parameter server
    in rank 0; each batch's wall and the server's counts."""
    from .. import kvstore
    kv = kvstore.create("dist_async")
    _mod, walls = _module_fit(cfg, ctx, kv, "dcasgd",
                              {"learning_rate": 3e-3, "momentum": 0.9})
    kv.barrier()
    rec = {"type": kv.type, "batch_wall_s": walls,
           "stats": kv.server_stats()}
    kv.barrier()
    kv.close()
    return rec


def _dump(out_dir, name, r, doc):
    with open(os.path.join(out_dir, "%s.rank%d.json" % (name, r)), "w") as f:
        json.dump(doc, f)


def _context(cpu_only):
    from .. import cpu, gpu
    from ..parallel import multihost
    if cpu_only:
        return cpu()
    return gpu(multihost.device().index)


def _first_touch(ctx):
    """Seconds to this process's first operation on its device (the CUDA
    context and the allocator on a card)."""
    import torch
    t0 = time.perf_counter()
    torch.zeros(1, device=ctx.torch_device())
    _sync(ctx)
    return time.perf_counter() - t0


def resnet_leg(cfg, ctx, out_dir, name="resnet", steps=RESNET_STEPS):
    """ResNet-50's leg: the trainer's build, ``steps`` steps on
    :func:`resnet_batch` 0, rank 0's state after the first step in
    ``OUT/<name>.state1.npz``; each rank's record in
    ``OUT/<name>.rank<r>.json``."""
    from ..parallel import multihost
    t0 = time.perf_counter()
    tr = resnet_trainer(cfg, ctx)
    build_s = time.perf_counter() - t0
    res = _steps(tr, ctx, lambda i: resnet_batch(cfg, 0), steps,
                 state_to=os.path.join(out_dir, "%s.state1.npz" % name))
    res.update(build_s=build_s, fusion=tr.fusion_summary())
    _dump(out_dir, name, multihost.rank(), dict(_head(ctx), **res))


def _head(ctx):
    from ..parallel import multihost
    return {"rank": multihost.rank(), "world": multihost.world_size(),
            "backend": multihost.backend(), "context": str(ctx)}


def legs(out_dir, cfgs, ctx):
    from ..parallel import multihost
    r = multihost.rank()
    head = _head(ctx)
    gcfg = cfgs["gpt"]
    context_s = _first_touch(ctx)
    t0 = time.perf_counter()
    tr = gpt_trainer(gcfg, ctx)
    build_s = time.perf_counter() - t0
    gpt = _steps(tr, ctx, lambda i: gpt_batch(gcfg, 0), GPT_STEPS)
    gpt.update(build_s=build_s, context_s=context_s)
    del tr
    _dump(out_dir, "gpt", r, dict(head, **gpt))
    resnet_leg(cfgs["resnet"], ctx, out_dir)
    _dump(out_dir, "module", r, dict(head, **_module_leg(gcfg, ctx)))
    _dump(out_dir, "async", r, dict(head, **_async_leg(gcfg, ctx)))


def recovery(out_dir, cfgs, ctx):
    from ..parallel import multihost
    r = multihost.rank()
    cfg = cfgs["gpt"]
    attempt = int(os.environ.get("MXNET_TPU_RESTART_COUNT", "0"))
    prefix = os.path.join(out_dir, "recovery")
    batch_of = lambda i: gpt_batch(cfg, i)     # noqa: E731
    if attempt == 0:
        tr = gpt_trainer(cfg, ctx, RECOVERY_LAYERS)
        full = _steps(tr, ctx, batch_of, RECOVERY_STEPS)
        _dump(out_dir, "uninterrupted", r, full)
        del tr
        tr = gpt_trainer(cfg, ctx, RECOVERY_LAYERS)
        _steps(tr, ctx, batch_of, KILL_AFTER)
        t0 = time.perf_counter()
        tr.save_checkpoint(prefix, KILL_AFTER, save_optimizer_states=True)
        _dump(out_dir, "checkpointed", r,
              {"save_s": time.perf_counter() - t0})
        if r == 1:
            os.kill(os.getpid(), signal.SIGKILL)
        _steps(tr, ctx, batch_of, RECOVERY_STEPS - KILL_AFTER, KILL_AFTER)
        raise SystemExit("recovery: rank %d stepped past its dead peer" % r)
    tr = gpt_trainer(cfg, ctx, RECOVERY_LAYERS)
    t0 = time.perf_counter()
    epoch = tr.load_latest_checkpoint(prefix, load_optimizer_states=True)
    load_s = time.perf_counter() - t0
    res = _steps(tr, ctx, batch_of, RECOVERY_STEPS - epoch, epoch)
    _dump(out_dir, "resumed", r, dict(res, epoch=epoch, load_s=load_s,
                                      attempt=attempt))


def nccl(out_dir, cfgs, ctx):
    """A ``dist_sync`` push and pull of the GPT's parameters (random f32
    values of their shapes, from a seeded generator on the device) in a
    job of one process: the sums of one rank are its values."""
    import torch
    from .. import kvstore, nd
    from ..models.gpt import gpt_symbol
    from ..parallel import multihost
    cfg = cfgs["gpt"]
    net = gpt_symbol(cfg["vocab"], cfg["seq"], cfg["d_model"], cfg["heads"],
                     cfg["layers"], dropout=0.0)
    shape = (cfg["batch"], cfg["seq"])
    arg_shapes, _, _ = net.infer_shape(data=shape, softmax_label=shape)
    dev = ctx.torch_device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    names = [n for n in net.list_arguments()
             if n not in ("data", "softmax_label")]
    shapes = dict(zip(net.list_arguments(), arg_shapes))
    vals = [nd.NDArray(torch.randn(shapes[n], generator=gen, device=dev))
            for n in names]
    kv = kvstore.create("dist_sync")
    kv.init(names, vals)
    _sync(ctx)
    t0 = time.perf_counter()
    kv.push(names, vals)
    outs = [nd.NDArray(torch.zeros_like(v.data)) for v in vals]
    kv.pull(names, outs)
    _sync(ctx)
    wall = time.perf_counter() - t0
    _dump(out_dir, "nccl", multihost.rank(), {
        "backend": multihost.backend(), "world": multihost.world_size(),
        "keys": len(names), "collectives": kv.collectives,
        "bytes": sum(v.data.numel() * 4 for v in vals),
        "push_pull_s": wall,
        "equal": all(torch.equal(a.data, b.data)
                     for a, b in zip(outs, vals))})


def build(out_dir, cfgs, ctx):
    """The parts of this rank's build of the full-width GPT trainer, each
    timed alone: the first touch of the device, the symbol, the host draw
    of the initial weights (the trainer's initializer over the same
    shapes), the trainer's constructor (which draws them again, moves
    them and, in a job, broadcasts rank 0's state), then one more
    broadcast of that state alone."""
    import torch
    from ..initializer import InitDesc, Xavier
    from ..models.gpt import gpt_symbol
    from ..parallel import multihost
    cfg = cfgs["gpt"]
    t = {"context_s": _first_touch(ctx)}
    t0 = time.perf_counter()
    net = gpt_symbol(cfg["vocab"], cfg["seq"], cfg["d_model"], cfg["heads"],
                     cfg["layers"], dropout=0.0)
    shape = (cfg["batch"], cfg["seq"])
    arg_shapes, _, _ = net.infer_shape(data=shape, softmax_label=shape)
    t["symbol_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    init = Xavier(rnd_type="gaussian", factor_type="in", magnitude=2,
                  rng=np.random.RandomState(SEED))
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n not in ("data", "softmax_label"):
            init(InitDesc(n), np.zeros(s, np.float32))
    t["host_init_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr = gpt_trainer(cfg, ctx)
    _sync(ctx)
    t["trainer_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if multihost.world_size() > 1:
        multihost.broadcast_from_rank0(list(tr.params.values())
                                       + list(tr.aux.values()))
    _sync(ctx)
    t["broadcast_s"] = time.perf_counter() - t0
    t["state_bytes"] = sum(v.numel() * v.element_size() for v in
                           list(tr.params.values()) + list(tr.aux.values()))
    t["threads"] = torch.get_num_threads()
    _dump(out_dir, "build", multihost.rank(), dict(_head(ctx), **t))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("legs", "recovery", "nccl", "build"))
    ap.add_argument("out", help="directory for each rank's JSON")
    ap.add_argument("--cpu", type=int, default=0,
                    help="1: the CPU at the tiny size (a rehearsal)")
    a = ap.parse_args(argv)
    from ..parallel import multihost
    multihost.ensure_initialized()
    os.makedirs(a.out, exist_ok=True)
    cfgs = TINY if a.cpu else FULL
    {"legs": legs, "recovery": recovery, "nccl": nccl, "build": build}[
        a.mode](
        a.out, cfgs, _context(a.cpu))


if __name__ == "__main__":
    main()
