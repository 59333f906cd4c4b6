"""The graph CF slices of ``chip_smoke.py`` (GCN, NGCF, SimGCL, SGL) alone on the
card: the XL dataset, SGL's views (``check_sgl_views``), each slice trained,
served and held against the CPU's lists (``train_slice``; the CPU's inline),
SimGCL's and SGL's profiles, and their toy-store bands (``quality``), each
phase's seconds after it. The first call to make after a change to these
paths, in about two minutes of phases. Needs a CUDA device; run from the
repo root:

    python3 tests/graph_cf_chip_probe.py
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    import torch

    from recboard_tpu_torch.serve import load_run_config

    if not torch.cuda.is_available():
        sys.exit("graph_cf_chip_probe: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        cs.emit("phase_seconds", name=name, seconds=time.perf_counter() - t0)
        return out

    dataset = timed("dataset", cs.make_dataset)
    timed("sgl_views", cs.check_sgl_views, 0, dataset)
    for name in cs.GRAPH_SLICES:
        spec = cs.SLICES[name]
        out = timed(spec["tag"] + "train", cs.train_slice, 0, dataset, name)
        steps = spec.get("profile_steps", cs.PROFILE_STEPS)
        if steps:
            timed(spec["tag"] + "train_time", cs.time_training, load_run_config(out["run_dir"]),
                  spec["tag"] + "train", None, spec.get("timings", True), steps)
    timed("quality", cs.quality, cs.STORE_SEEDS, *cs.GRAPH_SLICES)
