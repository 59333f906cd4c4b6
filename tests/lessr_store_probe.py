"""One seed of LESSR's toy-store protocol (``chip_smoke.store_run``) alone on
the card, with ``modules.GRU``'s cuDNN bound as it is and with every batch
through PyTorch's own GRU, each timed whole and by part: the host pipe's
epoch alone, and 20 steps under torch.profiler (device and host µs a step,
launches). One JSON line each (``probe_lessr_store``), after the card's
name and power limit. Needs a CUDA device; run from the repo root:

    python3 tests/lessr_store_probe.py
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    import itertools

    import torch
    from torch.profiler import ProfilerActivity, profile

    from recboard_tpu_torch import run
    from recboard_tpu_torch.data.datasets import NextItemRecDataSet
    from recboard_tpu_torch.launcher import Coach
    from recboard_tpu_torch.models.modules import GRU
    from recboard_tpu_torch.parser import Parser

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    data_root, name = cs.store_dataset()
    for backend, bound in (("as_is", GRU.CUDNN_MAX_BATCH), ("native", 0)):
        GRU.CUDNN_MAX_BATCH = bound
        ndcg, seconds = cs.store_run("LESSR", data_root, name, 0, {})
        argv = cs.train_argv("LESSR", data_root, name, 0, **cs.STORE_PROTOCOL)
        cfg = Parser().compile(argv + ["--description", "LESSR"])
        dataset = NextItemRecDataSet(data_root, name)
        model = run.build_model("LESSR", dataset, cfg, torch.device("cuda"))
        pipe = run.train_pipe(model, int(cfg.maxlen), int(cfg.batch_size)).set_seed(0)
        t0 = time.perf_counter()
        batches = list(pipe)
        pipe_s = time.perf_counter() - t0
        coach = Coach(dataset, None, None, None, model, cfg, torch.device("cuda"))
        staged = [coach.to_device(b) for b in batches[:23]]
        for b in staged[:3]:
            coach.train_step(b)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in itertools.islice(staged, 3, None):
                coach.train_step(b)
            torch.cuda.synchronize()
            steps_s = time.perf_counter() - t0
        totals = cs.profile_totals(prof)
        kernels = cs.profiled_ops(totals, 20, device=True)
        print(json.dumps(dict(
            phase="probe_lessr_store", backend=backend, cudnn_max_batch=bound, ndcg10=ndcg,
            seed_s=seconds, host_pipe_epoch_s=pipe_s, batches=len(batches),
            step_ms=1e3 * steps_s / 20, device_us_per_step=sum(us for _, us, _ in kernels),
            launches_per_step=sum(n for _, _, n in kernels),
            top=[dict(name=n[:70], us=us, per_step=c) for n, us, c in kernels[:6]])), flush=True)
