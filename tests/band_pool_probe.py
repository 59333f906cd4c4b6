"""The toy-store band pool of ``chip_smoke.py`` alone, at several process
counts one after another, on the card: each count's wall time and band
means as one JSON line (``probe_pool``), after the kernels' build
(``probe_build``). Needs a CUDA device; run from the repo root:

    chiprun -- python3 tests/band_pool_probe.py 40,24,16

Compare counts only within one call: the host's speed varies between
machines.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    import torch

    from recboard_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()
    cs.emit("probe_build", seconds=time.perf_counter() - t0)
    base = cs.WORK
    for procs in [int(x) for x in sys.argv[1].split(",")]:
        cs.WORK = os.path.join(base, f"p{procs}")
        cs.STORE_PROCESSES = procs
        t0 = time.perf_counter()
        out = cs.quality(cs.STORE_SEEDS, *cs.STORE_BANDS)
        cs.emit("probe_pool", processes=procs, wall_s=time.perf_counter() - t0,
                means={k: v["mean"] for k, v in out.items()})
