"""One rank of the port's data-parallel ShardedTrainer jobs on the CPU
(gloo), run under ``mxnet_tpu_torch/tools/launch.py`` by
``test_torch_dist_trainer.py`` and ``test_torch_launch.py``.

    python tests/torch_dist_train.py legs OUT      # the trainer legs
    python tests/torch_dist_train.py capture OUT   # the SIGUSR1 capture
    python tests/torch_dist_train.py gate OUT      # chip_smoke's legs job

``legs``: each net of :data:`NETS` (its initial state from
``OUT/init_<net>.npz``, written by the test from the JAX trainer) trains
:data:`STEPS` f32 SGD steps on this rank's rows of the global batches of
:func:`batches`, with ``MXNET_TPU_OVERLAP`` off and then on; each run
writes ``OUT/<net>-overlap<0|1>.rank<r>.npz`` (the losses, every
parameter and aux state).  Rank 0 also saves the MLP's checkpoint
(``OUT/ckpt``) for the JAX package to load, and each rank writes the
state of a trainer seeded by its rank (``OUT/seeded.rank<r>.npz``).

``capture``: with ``MXNET_TPU_CAPTURE_DIR`` set, the rank writes
``OUT/ready.rank<r>`` and steps the MLP until every rank's capture
handler has run a capture (the test sends SIGUSR1 to the launcher, which
relays it), then writes its capture's record to
``OUT/capture.rank<r>.json``.

``gate``: the rank of chip_smoke's dist_train legs job
(``chip_smoke.dist_worker``) at ``tools.dist_train``'s tiny CPU size: the
tool's legs with the async server's records, then ResNet's control.
"""
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch.parallel import (  # noqa: E402
    ShardedTrainer, build_mesh, multihost)

STEPS = 4
BATCH = 8                      # global: 4 rows a rank
SGD = dict(optimizer="sgd", learning_rate=0.1, momentum=0.9,
           weight_decay=1e-4)


def mlp(sym):
    x = sym.Variable("data")
    x = sym.FullyConnected(x, num_hidden=32, name="fc1")
    x = sym.Activation(x, act_type="relu", name="relu1")
    x = sym.FullyConnected(x, num_hidden=10, name="fc2")
    return sym.SoftmaxOutput(x, name="softmax")


def convbn(sym):
    x = sym.Variable("data")
    x = sym.Convolution(x, num_filter=8, kernel=(3, 3), pad=(1, 1),
                        no_bias=True, name="conv1")
    x = sym.BatchNorm(x, fix_gamma=False, name="bn1")
    x = sym.Activation(x, act_type="relu", name="relu1")
    x = sym.Convolution(x, num_filter=16, kernel=(1, 1), no_bias=True,
                        name="conv2")
    x = sym.BatchNorm(x, fix_gamma=False, name="bn2")
    x = sym.Activation(x, act_type="relu", name="relu2")
    x = sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="avg",
                    name="pool")
    x = sym.FullyConnected(x, num_hidden=10, name="fc")
    return sym.SoftmaxOutput(x, name="softmax")


#: net -> (builder, data shape of one row, trainer options)
NETS = {
    "mlp": (mlp, (20,), {}),
    "convbn": (convbn, (3, 8, 8), {}),
    # the same net NHWC with block fusion: its 1x1 conv->BN block runs on
    # K5 (the plain version here), whose column sums are all-reduced
    "convbn_fused": (convbn, (3, 8, 8), {"layout": "NHWC",
                                         "fuse_blocks": True}),
}


def shapes(net):
    row = NETS[net][1]
    return dict(data_shapes={"data": (BATCH,) + row},
                label_shapes={"softmax_label": (BATCH,)})


def batches(net, steps=STEPS, seed=0):
    """The global batches, one a step."""
    rng = np.random.RandomState(seed)
    row = NETS[net][1]
    return [{"data": rng.uniform(-1, 1, (BATCH,) + row).astype(np.float32),
             "softmax_label": rng.randint(0, 10, BATCH).astype(np.float32)}
            for _ in range(steps)]


def trainer(net, seed=0):
    build, _row, opts = NETS[net]
    return ShardedTrainer(build(mx.sym), build_mesh(devices=[mx.cpu()]),
                          dtype="float32", seed=seed, **shapes(net), **SGD,
                          **opts)


def state(tr):
    out = {"arg:" + k: v.numpy() for k, v in tr.params.items()}
    out.update({"aux:" + k: v.numpy() for k, v in tr.aux.items()})
    return out


def run(tr, net, steps=STEPS):
    losses = []
    for b in batches(net, steps):
        local = {k: multihost.stage_local(v) for k, v in b.items()}
        losses.append(float(tr.step(local)))
    return losses


def legs(out):
    r = multihost.rank()
    for net in NETS:
        init = np.load(os.path.join(out, "init_%s.npz" % net))
        for overlap in (0, 1):
            os.environ["MXNET_TPU_OVERLAP"] = str(overlap)
            os.environ["MXNET_TPU_BUCKET_BYTES"] = "2048"
            tr = trainer(net)
            for k, v in tr.params.items():
                v.copy_(torch.from_numpy(init["arg:" + k]))
            for k, v in tr.aux.items():
                v.copy_(torch.from_numpy(init["aux:" + k]))
            losses = run(tr, net)
            np.savez(os.path.join(out, "%s-overlap%d.rank%d.npz"
                                  % (net, overlap, r)),
                     losses=np.array(losses), **state(tr))
            if net == "mlp" and overlap == 0:
                tr.save_checkpoint(os.path.join(out, "ckpt"), STEPS,
                                   save_optimizer_states=True)
    # a trainer seeded by the rank starts from rank 0's state
    np.savez(os.path.join(out, "seeded.rank%d.npz" % r),
             **state(trainer("convbn", seed=r)))
    mesh = build_mesh(devices=[mx.cpu()])
    with open(os.path.join(out, "job.rank%d.json" % r), "w") as f:
        json.dump({"mesh": mesh.shape, "world": multihost.world_size(),
                   "rank": r, "backend": multihost.backend()}, f)


def capture(out):
    """Step until every rank's capture has finished: each step the ranks
    sum their done flags, so all of them stop after the same step."""
    import time
    from mxnet_tpu_torch.telemetry import distview
    r = multihost.rank()
    tr = trainer("mlp")
    open(os.path.join(out, "ready.rank%d" % r), "w").close()
    for _ in range(3000):
        run(tr, "mlp", steps=1)
        done = torch.tensor([float(distview.capture_status()["last"]
                                   is not None)])
        if float(multihost.all_reduce(done)) == multihost.world_size():
            break
        time.sleep(0.02)
    with open(os.path.join(out, "capture.rank%d.json" % r), "w") as f:
        json.dump(distview.capture_status()["last"], f)


def gate(out):
    import chip_smoke
    chip_smoke.dist_worker(out, cpu=True)


if __name__ == "__main__":
    multihost.ensure_initialized()
    {"legs": legs, "capture": capture, "gate": gate}[sys.argv[1]](
        sys.argv[2])
