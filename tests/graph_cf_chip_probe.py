"""The graph CF slices of ``chip_smoke.py`` alone on the card: ``graph`` (GCN,
NGCF, SimGCL, SGL, with SGL's views, ``check_sgl_views``) or ``cf2`` (JGCF,
PairNorm, CAGCN, AlphaRec, with CAGCN's operator built on the card,
``check_cagcn_adj``, and AlphaRec's features, ``check_alpharec_features``): the
XL dataset, each slice trained, served and held against the CPU's lists
(``train_slice``; the CPU's inline), the profiled slices' profiles, and their
toy-store bands (``quality``), each phase's seconds after it. The first call to
make after a change to these paths, in about two to four minutes of phases.
Needs a CUDA device; run from the repo root:

    python3 tests/graph_cf_chip_probe.py [graph|cf2]
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

    group = sys.argv[1] if len(sys.argv) > 1 else "graph"
    slices, checks = {"graph": (cs.GRAPH_SLICES, [cs.check_sgl_views]),
                      "cf2": (cs.CF2_SLICES, [cs.check_cagcn_adj,
                                              cs.check_alpharec_features])}[group]
    dataset = timed("dataset", cs.make_dataset)
    for check in checks:
        timed(check.__name__, check, 0, dataset)
    for name in slices:
        spec = cs.SLICES[name]
        out = timed(spec["tag"] + "train", cs.train_slice, 0, dataset, name)
        steps = spec.get("profile_steps", cs.PROFILE_STEPS)
        if steps:
            timed(spec["tag"] + "train_time", cs.time_training, load_run_config(out["run_dir"]),
                  spec["tag"] + "train", None, spec.get("timings", True), steps)
    timed("quality", cs.quality, cs.STORE_SEEDS, *slices)
