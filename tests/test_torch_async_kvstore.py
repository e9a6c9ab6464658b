"""The port's ``dist_async`` store (the host parameter server) on the CPU.

In process: the wire format is the JAX package's, byte for byte (an
8-byte big-endian length, then the protocol-4 pickle), and a message
either package frames reads in the other.  One two-rank job (through
``mxnet_tpu_torch/tools/launch.py``; worker ``tests/torch_dist_kvstore.py
async``): ``Module.fit`` of an MLP under ``dist_async`` with DCASGD, the
optimizer running on the server in rank 0.  The server applies every
push at once, so its final weights are a replay, on the host, of the
pushes in the order its log records: the initial values, then the
shipped optimizer's updater over each logged gradient.  They are equal
to the bit.  Before it, two parameter servers (one in each rank) take a key
above the bigarray bound in two slices and a small key whole, as JAX
shards them: every push applied once, the pulls the exact sums.
"""
import json
import os
import pickle
import socket
import sys

import numpy as np
import pytest

import torch_threads  # noqa: F401  (xdist workers share the cores)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from mxnet_tpu.parallel import async_kvstore as jasync  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.parallel import async_kvstore as tasync  # noqa: E402

import torch_dist_common  # noqa: E402

MESSAGES = [("push", 3, np.arange(12, dtype=np.float32).reshape(3, 4)),
            ("pull", "w"), ("set_optimizer", b"\x00\x01"), ("bye",),
            ("val", {"updates": 4, "keys": 2})]


def _wire(send, msg):
    a, b = socket.socketpair()
    with a, b:
        send(a, msg)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            c = b.recv(1 << 16)
            if not c:
                return b"".join(chunks)
            chunks.append(c)


@pytest.mark.parametrize("i", range(len(MESSAGES)))
def test_wire_bytes_equal_jax(i):
    msg = MESSAGES[i]
    got, want = _wire(tasync._send_msg, msg), _wire(jasync._send_msg, msg)
    assert got == want
    assert int.from_bytes(got[:8], "big") == len(got) - 8
    for send, recv in ((tasync._send_msg, jasync._recv_msg),
                       (jasync._send_msg, tasync._recv_msg)):
        a, b = socket.socketpair()
        with a, b:
            send(a, msg)
            back = recv(b)
        assert pickle.dumps(back, protocol=4) == \
            pickle.dumps(msg, protocol=4)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dist_async"))
    res = torch_dist_common.launch(
        [os.path.join(ROOT, "tests", "torch_dist_kvstore.py"), "async",
         out], timeout=120,
        env={"MXNET_TPU_ASYNC_PORT": str(torch_dist_common.free_port()),
             "DIST_TEST_SHARDED_PORT": str(torch_dist_common.free_port())})
    assert res.returncode == 0, res.stderr[-4000:]
    return out


def test_server_weights_replay_from_its_push_log(job):
    out = job
    docs = [json.load(open(os.path.join(out, "async.rank%d.json" % r)))
            for r in (0, 1)]
    sent = [pickle.load(open(os.path.join(out, "sent.rank%d.pkl" % r),
                             "rb")) for r in (0, 1)]
    assert [d["type"] for d in docs] == ["dist_async"] * 2
    log = docs[0]["push_log"]
    # every push applied at once: 2 ranks x 4 batches x 4 parameters
    assert len(log) == docs[0]["stats"]["updates"] == 2 * 4 * 4
    assert docs[1]["stats"]["updates"] == len(log)
    grads = {**sent[0]["grads"], **sent[1]["grads"]}
    assert sent[0]["optimizer"] == sent[1]["optimizer"]
    updater = tmx.optimizer.get_updater(pickle.loads(sent[0]["optimizer"]))
    weights = {k: tmx.nd.array(v, ctx=tmx.cpu())
               for k, v in sent[0]["init"].items()}
    for key, crc in log:
        updater(int(key), tmx.nd.array(grads[str(crc)], ctx=tmx.cpu()),
                weights[key])
    final = np.load(os.path.join(out, "server.npz"))
    assert sorted(final.files) == sorted(weights)
    for k, v in weights.items():
        np.testing.assert_array_equal(v.asnumpy(), final[k])
    # the replay moved the weights: the pushes reached the server
    assert any(not np.array_equal(final[k], sent[0]["init"][k])
               for k in final.files)


def test_big_keys_slice_across_two_servers(job):
    out = job
    docs = [json.load(open(os.path.join(out, "async.rank%d.json" % r)))
            for r in (0, 1)]
    for r in (0, 1):
        got = np.load(os.path.join(out, "sharded.rank%d.npz" % r))
        # SGD at lr 1 from zeros: minus the sum of both ranks' pushes
        np.testing.assert_array_equal(got["big"], np.full((10, 100), -3.0))
        np.testing.assert_array_equal(got["small"], -np.arange(3.0) * 3)
    stats = docs[0]["sharded_stats"]
    # the big key's two slices, one on each server, and the small key on
    # one: 3 keys; each rank's push is one update a key a server
    assert stats["keys"] == 3 and stats["updates"] == 2 * 3
    assert [p["keys"] for p in stats["per_server"]] in ([2, 1], [1, 2])
