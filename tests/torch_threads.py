"""Torch's intra-op threads for the port's tests: one share of the cores.

Under pytest-xdist every worker process would start torch with a thread
per core, so ``-n 6`` on 8 cores runs 48 spinning intra-op threads and a
CPU engine's barrier takes many times its time alone.  Each port test
module imports this first: in an xdist worker it gives torch
``cores // workers`` threads (at least one); alone it changes nothing.
"""

import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))
