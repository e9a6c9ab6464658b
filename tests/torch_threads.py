"""Share the host's cores among pytest-xdist workers: in a worker
(``PYTEST_XDIST_WORKER_COUNT`` set) torch's intra-op pool is cut to the
cores per worker, at least 1.  Each worker's pool otherwise takes every
core, and the pools' OpenMP threads spin against each other: the port's
CPU tests ran 3.1x slower in all (191.4 s against 60.8 s for four of its
files on 4 workers of an 8-core host).  Outside xdist nothing changes.
Imported for its effect by the port's test files."""
import os

import torch

_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
if _workers > 0:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _workers))
