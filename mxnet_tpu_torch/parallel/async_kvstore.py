"""``dist_async``: a host parameter server, every push applied at once.

The counterpart of ``mxnet_tpu/parallel/async_kvstore.py``, the
reference's ``kvstore_dist_server.h:200-208`` contract: the server applies
each push to the weights immediately (no aggregation gate) and workers
pull whatever the weights are at that moment.  Collectives are globally
synchronous, so async keeps the reference's host architecture: a
parameter-server thread in the first ``MXNET_TPU_NUM_SERVERS`` ranks'
processes, workers pushing and pulling numpy arrays over TCP, and the
optimizer running on the server (``set_optimizer`` ships it pickled).
Gradients leave the card as host copies; nothing of this path runs on a
device.

Wire format, the JAX package's: an 8-byte big-endian length, then a
pickle (protocol 4).  One persistent connection a worker; the server
runs a thread a connection and serializes updates with a lock.
"""
from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
import time

import numpy as np

from ..base import MXNetError
from ..context import cpu
from .. import telemetry
from ..kvstore import KVStore, _group, _key_value

__all__ = ["AsyncKVStore", "ParameterServer"]

# push/pull byte children come bound from KVStore.__init__
# (store="dist_async"); only the in-flight gauge is module-level
_PENDING = telemetry.gauge("mxtpu_kvstore_pending_async")


def _send_msg(sock, obj):
    payload = pickle.dumps(obj, protocol=4)
    sock.sendall(struct.pack(">Q", len(payload)) + payload)


def _recv_msg(sock):
    hdr = b""
    while len(hdr) < 8:
        chunk = sock.recv(8 - len(hdr))
        if not chunk:
            raise ConnectionError("peer closed")
        hdr += chunk
    (n,) = struct.unpack(">Q", hdr)
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf += chunk
    return pickle.loads(bytes(buf))


class ParameterServer:
    """The server role (runs as a thread inside the rank-0 process)."""

    def __init__(self, num_workers, port, host="0.0.0.0"):
        self.num_workers = num_workers
        self._store = {}
        self._updater = None
        self._updater_obj = None
        self._lock = threading.Lock()
        self.update_count = 0
        self._barrier_gen = 0
        self._barrier_count = 0
        self._barrier_cv = threading.Condition()
        self._byes = 0
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._listener.bind((host, port))
        except OSError as e:
            raise MXNetError(
                "dist_async parameter server cannot bind %s:%d (%s) — "
                "set MXNET_TPU_ASYNC_PORT to a free port"
                % (host, port, e)) from e
        self._listener.listen(num_workers + 1)
        self._threads = []
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def _accept_loop(self):
        for _ in range(self.num_workers):
            conn, _addr = self._listener.accept()
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)
        self._listener.close()

    def _serve(self, conn):
        msg = ("<recv>",)  # so the fault-report path below can never NameError
        try:
            while True:
                msg = _recv_msg(conn)
                op = msg[0]
                if op == "init":
                    from .. import ndarray as _nd
                    _key, val = msg[1], msg[2]
                    with self._lock:
                        # first writer wins (every worker inits); the
                        # store holds NDArrays — updaters/optimizers
                        # expect the NDArray surface (context, state
                        # creation), exactly as on the reference server
                        self._store.setdefault(_key, _nd.array(
                            val, ctx=cpu()))
                    _send_msg(conn, ("ok",))
                elif op == "push":
                    from .. import ndarray as _nd
                    _key, grad = msg[1], msg[2]
                    with self._lock:
                        if _key not in self._store:
                            _send_msg(conn, ("err",
                                             "key %r not inited" % _key))
                            continue
                        # ASYNC CONTRACT: applied immediately, per push
                        if self._updater is not None:
                            self._updater(_key, _nd.array(grad, ctx=cpu()),
                                          self._store[_key])
                        else:
                            # no updater installed: assign, matching the
                            # facade's assign-vs-updater contract
                            self._store[_key] = _nd.array(grad, ctx=cpu())
                        self.update_count += 1
                    _send_msg(conn, ("ok",))
                elif op == "pull":
                    with self._lock:
                        if msg[1] not in self._store:
                            _send_msg(conn, ("err",
                                             "key %r not inited" % (msg[1],)))
                            continue
                        val = self._store[msg[1]].asnumpy()
                    _send_msg(conn, ("val", val))
                elif op == "set_optimizer":
                    from .. import optimizer as opt_mod
                    optimizer = pickle.loads(msg[1])
                    with self._lock:
                        # idempotent across workers: one shared updater
                        if self._updater is None:
                            self._updater_obj = opt_mod.get_updater(
                                optimizer)
                            self._updater = self._updater_obj
                    _send_msg(conn, ("ok",))
                elif op == "barrier":
                    with self._barrier_cv:
                        gen = self._barrier_gen
                        self._barrier_count += 1
                        if self._barrier_count == self.num_workers:
                            self._barrier_count = 0
                            self._barrier_gen += 1
                            self._barrier_cv.notify_all()
                        else:
                            while self._barrier_gen == gen:
                                self._barrier_cv.wait()
                    _send_msg(conn, ("ok",))
                elif op == "stats":
                    with self._lock:
                        _send_msg(conn, ("val",
                                         {"updates": self.update_count,
                                          "keys": len(self._store)}))
                elif op == "opt_states":
                    with self._lock:
                        st = (self._updater_obj.get_states()
                              if self._updater_obj is not None else b"")
                    _send_msg(conn, ("val", st))
                elif op == "set_opt_states":
                    with self._lock:
                        if self._updater_obj is None:
                            _send_msg(conn, ("err", "set_optimizer must "
                                             "run before state restore"))
                            continue
                        self._updater_obj.set_states(msg[1])
                    _send_msg(conn, ("ok",))
                elif op == "bye":
                    _send_msg(conn, ("ok",))
                    with self._lock:
                        self._byes += 1
                    return
                else:
                    _send_msg(conn, ("err", "unknown op %r" % (op,)))
        except (ConnectionError, OSError):
            return
        except Exception as e:  # mxlint: allow-broad-except(server loop must survive any handler fault; the error is sent to the worker)
            try:
                _send_msg(conn, ("err", "server error on %r: %r"
                                 % (msg[:1], e)))
            except (ConnectionError, OSError):
                pass
            return
        finally:
            conn.close()


class AsyncKVStore(KVStore):
    """Worker-side ``dist_async`` client (reference kvstore_dist.h
    worker role under ``--launcher`` env, without the sync gate).

    Multi-server sharding (reference ``kvstore_dist.h:273-314``
    ``EncodeKey``): ``MXNET_TPU_NUM_SERVERS`` (default 1) parameter
    servers run inside the first N worker processes.  Small keys hash
    to one server; arrays above ``MXNET_KVSTORE_BIGARRAY_BOUND``
    elements (reference env var, default 1e6) are sliced into
    near-equal contiguous flat ranges, one per server, so no single
    server carries a whole big tensor or its push traffic.
    """

    def __init__(self, kv_type="dist_async"):
        super().__init__(kv_type)
        from .. import config

        self._rank = config.get_int("MXNET_TPU_PROCESS_ID", 0)
        self._num_workers = config.get_int("MXNET_TPU_NUM_PROCESSES", 1)
        coordinator = config.get("MXNET_TPU_COORDINATOR") or \
            "127.0.0.1:8431"
        host, cport = coordinator.rsplit(":", 1)
        port = int(config.uncatalogued("MXNET_TPU_ASYNC_PORT") or 0) \
            or int(cport) + 1
        nserv = int(config.uncatalogued("MXNET_TPU_NUM_SERVERS") or 1)
        if nserv < 1 or nserv > self._num_workers:
            raise MXNetError(
                "MXNET_TPU_NUM_SERVERS=%d must be in [1, num_workers=%d]"
                " (servers run inside the first N worker processes)"
                % (nserv, self._num_workers))
        self._num_servers = nserv
        self._big_bound = config.get_int(
            "MXNET_KVSTORE_BIGARRAY_BOUND", 1000 * 1000)
        hosts_env = config.uncatalogued("MXNET_TPU_SERVER_HOSTS")
        server_hosts = (hosts_env.split(",") if hosts_env
                        else [host] * nserv)
        if len(server_hosts) != nserv:
            raise MXNetError("MXNET_TPU_SERVER_HOSTS lists %d hosts for "
                             "%d servers" % (len(server_hosts), nserv))
        self._server = None
        if self._rank < nserv:
            self._server = ParameterServer(self._num_workers,
                                           port + self._rank,
                                           host="0.0.0.0")
        self._socks = [self._connect(h, port + i)
                       for i, h in enumerate(server_hosts)]
        self._sock = self._socks[0]  # back-compat alias
        self._plans = {}             # key -> None (small) | [(lo, hi)]*S
        self._push_pool = None       # lazy single sender thread
        self._bucket_queue = None    # lazy overlap.BucketQueue

    @staticmethod
    def _connect(host, port, timeout=60.0):
        deadline = time.time() + timeout
        while True:
            try:
                s = socket.create_connection((host, port), timeout=5)
                # blocking RPCs (barrier waits on the slowest worker —
                # the point of async mode) must not inherit the connect
                # timeout
                s.settimeout(None)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                return s
            except OSError:
                if time.time() > deadline:
                    raise MXNetError(
                        "dist_async: cannot reach the parameter server "
                        "at %s:%d (rank 0 hosts it; launch through "
                        "tools/launch.py)" % (host, port))
                time.sleep(0.2)

    def _rpc_to(self, sidx, *msg):
        sock = self._socks[sidx]
        # in-flight depth: the async contract means a slow server shows
        # up as this gauge sticking above 0, not as a training stall
        _PENDING.inc()
        try:
            _send_msg(sock, msg)
            resp = _recv_msg(sock)
        finally:
            _PENDING.dec()
        if resp[0] == "err":
            telemetry.flight.record("kvstore", op="rpc_error",
                                    store="dist_async", server=int(sidx),
                                    message=str(resp[1])[:500])
            raise MXNetError("dist_async server %d: %s" % (sidx, resp[1]))
        return resp[1] if len(resp) > 1 else None

    def _rpc(self, *msg):
        return self._rpc_to(0, *msg)

    def _rpc_all(self, *msg):
        return [self._rpc_to(i, *msg) for i in range(self._num_servers)]

    # --------------------------------------------------- key sharding
    def _server_of(self, key):
        import zlib
        return zlib.crc32(str(key).encode()) % self._num_servers

    def _plan_of(self, key, size):
        """None for hash-routed small keys; a list of S contiguous flat
        ranges [lo, hi) for arrays above the bigarray bound (reference
        EncodeKey slicing, kvstore_dist.h:273-314)."""
        plan = self._plans.get(key, "?")
        if plan != "?":
            return plan
        if self._num_servers == 1 or size <= self._big_bound:
            plan = None
        else:
            S = self._num_servers
            edges = [size * i // S for i in range(S + 1)]
            plan = [(edges[i], edges[i + 1]) for i in range(S)]
        self._plans[key] = plan
        return plan

    # ------------------------------------------------------------------ api
    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._num_workers

    def init(self, key, value):
        keys, vals = _key_value(key, value)
        for k, v in zip(keys, vals):
            arr = v.asnumpy()
            plan = self._plan_of(k, arr.size)
            if plan is None:
                self._rpc_to(self._server_of(k), "init", k, arr)
            else:
                flat = arr.reshape(-1)
                for i, (lo, hi) in enumerate(plan):
                    self._rpc_to(i, "init", "%s#%d" % (k, i), flat[lo:hi])

    def _send_push(self, k, merged):
        """Wire one merged gradient to its server(s) — the per-key
        protocol shared by the synchronous push and the bucketed
        sender thread (sockets are serialized either way: a single
        caller, or the single worker of the push pool)."""
        plan = self._plan_of(k, merged.size)
        if plan is None:
            self._rpc_to(self._server_of(k), "push", k, merged)
        else:
            flat = merged.reshape(-1)
            for i, (lo, hi) in enumerate(plan):
                self._rpc_to(i, "push", "%s#%d" % (k, i), flat[lo:hi])

    def push(self, key, value, priority=0):
        keys, vals = _key_value(key, value)
        uniq, grouped = _group(keys, vals)
        for k, group in zip(uniq, grouped):
            merged = group[0].asnumpy()
            for other in group[1:]:
                merged = merged + other.asnumpy()
            self._push_bytes.inc(merged.nbytes)
            self._send_push(k, merged)

    # ------------------------------------------- bucketed overlap path
    @property
    def overlap_active(self):
        """Bucketed pushes (parallel/overlap.py, MXNET_TPU_OVERLAP):
        the RPC round trips — the async path's per-key latency — move
        onto a background sender thread, overlapping the rest of
        gradient production; :meth:`drain` is the ack point before the
        weight pulls."""
        from . import overlap as _overlap
        return _overlap.overlap_enabled()

    def _launch_push_bucket(self, bucket):
        """BucketQueue reduce_fn: ship one bucket's pushes on the
        single sender thread (one worker — the per-server sockets are
        not concurrency-safe and the server applies updates per push
        in arrival order anyway).  The handle joins the send; async
        semantics mean there is no reduced value to hand back."""
        import concurrent.futures

        if self._push_pool is None:
            self._push_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="mxtpu-async-push")

        def send(items=tuple(bucket.items())):
            for k, merged in items:
                self._send_push(k, merged)

        fut = self._push_pool.submit(send)

        def handle():
            fut.result()
            return {}
        return handle

    def push_bucketed(self, key, value, priority=0):
        """Merge local replicas and buffer into size-targeted buckets;
        full buckets ship on the sender thread immediately.  Updates
        still apply server-side per push (the dist_async contract) —
        nothing is applied locally at :meth:`drain`."""
        from . import overlap as _overlap
        if self._bucket_queue is None:
            self._bucket_queue = _overlap.BucketQueue(
                self._launch_push_bucket, site="kvstore.async_push",
                skew_probe=lambda: None)
        keys, vals = _key_value(key, value)
        uniq, grouped = _group(keys, vals)
        for k, group in zip(uniq, grouped):
            merged = group[0].asnumpy()
            for other in group[1:]:
                merged = merged + other.asnumpy()
            self._push_bytes.inc(merged.nbytes)
            self._bucket_queue.push(k, merged, merged.nbytes)

    def drain(self):
        """Ship the remaining buckets and join every in-flight send —
        the ordering point that keeps push-before-pull semantics for
        the Module update path.  No-op when nothing was pushed."""
        if self._bucket_queue is None or not self._bucket_queue.pending:
            return
        self._bucket_queue.drain()

    def pull(self, key, out=None, priority=0):
        assert out is not None
        # join any in-flight bucketed sends first: per-worker
        # push-then-pull ordering, and the sender thread must not
        # share a socket with this pull mid-message
        self.drain()
        keys, outs = _key_value(key, out)
        cache = {}
        for k, o in zip(keys, outs):
            if k not in cache:
                plan = self._plan_of(k, int(np.prod(o.shape)))
                if plan is None:
                    cache[k] = self._rpc_to(self._server_of(k), "pull", k)
                else:
                    parts = [self._rpc_to(i, "pull", "%s#%d" % (k, i))
                             for i in range(self._num_servers)]
                    cache[k] = np.concatenate(
                        [np.asarray(p).reshape(-1) for p in parts]
                    ).reshape(o.shape)
                self._pull_bytes.inc(np.asarray(cache[k]).nbytes)
            o[:] = cache[k]

    def set_optimizer(self, optimizer):
        # ship the optimizer to the server (reference pickled-command
        # protocol); updates happen server-side per push.  The attached
        # Symbol (attribute hints only) holds op closures — the server
        # needs the update rule, not the graph, so drop it
        import copy
        optimizer = copy.copy(optimizer)
        optimizer.sym = None
        blob = pickle.dumps(optimizer, protocol=4)
        self._rpc_all("set_optimizer", blob)

    def set_updater(self, updater):
        raise MXNetError("dist_async applies updates on the server; "
                         "use set_optimizer")

    def barrier(self):
        # every server gates on all workers, so the slowest server
        # bounds the barrier exactly once per generation
        self.drain()
        self._rpc_all("barrier")

    def server_stats(self):
        """{'updates': per-push update count, 'keys': n} — observability
        for the async contract (updates grow per push, not per round)."""
        per = self._rpc_all("stats")
        return {"updates": sum(p["updates"] for p in per),
                "keys": sum(p["keys"] for p in per),
                "per_server": per}

    def save_optimizer_states(self, fname):
        """Write SERVER-side updater states to ``fname`` (rank 0 only).

        SHARED-STORAGE CONTRACT (same as the fused path's checkpoint
        helpers): rank 0 writes the file; every rank later reads it in
        :meth:`load_optimizer_states`, so ``fname`` must live on storage
        all ranks can see (NFS, GCS fuse, single-host launch).
        """
        if self._rank != 0:
            return           # rank 0 writes; no N-way state transfer
        blobs = self._rpc_all("opt_states")
        with open(fname, "wb") as f:
            f.write(pickle.dumps({"per_server": blobs}, protocol=4))

    def load_optimizer_states(self, fname):
        # restore SERVER-side updater states (call after set_optimizer,
        # as Module.init_optimizer's preload path does).  Shared-storage
        # contract: see save_optimizer_states.
        if not os.path.exists(fname):
            raise MXNetError(
                "optimizer-states file %r not found on rank %d: "
                "save_optimizer_states writes on rank 0 only, so the "
                "path must be on storage shared by all ranks"
                % (fname, self._rank))
        with open(fname, "rb") as f:
            raw = f.read()
        try:
            blobs = pickle.loads(raw)["per_server"]
        except Exception:  # mxlint: allow-broad-except(any unpickle failure means a pre-sharding single-server file; fall back to raw)
            blobs = [raw]    # pre-sharding single-server file
        if len(blobs) != self._num_servers:
            raise MXNetError(
                "optimizer-states file holds %d server shards, job runs "
                "%d servers" % (len(blobs), self._num_servers))
        for i, b in enumerate(blobs):
            self._rpc_to(i, "set_opt_states", b)

    def close(self):
        try:
            self.drain()
        except MXNetError:
            pass          # best-effort teardown: sends may be half-dead
        for i, sock in enumerate(list(self._socks)):
            try:
                self._rpc_to(i, "bye")
                sock.close()
            except (ConnectionError, OSError, EOFError, MXNetError,
                    pickle.UnpicklingError):
                # best-effort handshake: a server dying mid-send can
                # also deliver a corrupt (unpicklable) response
                pass
        self._socks = []

    def __del__(self):
        try:
            self.close()
        except Exception:  # mxlint: allow-broad-except(__del__ at interpreter teardown must never raise)
            pass
