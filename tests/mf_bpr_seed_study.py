"""MF-BPR's toy-store band, seed by seed, in both packages on the CPU.

The toy store's protocol for MF-BPR (``tools/seed_sweep.py``'s arguments:
200 epochs, lr 0.005, batch 128, valid every 3 epochs; the dataset and
flags ``chip_smoke.py``'s band uses) run for each seed

* by ``recboard_tpu`` from its own initial weights (saved as it draws them),
* by ``recboard_tpu_torch`` from its own initial weights,
* by ``recboard_tpu_torch`` from ``recboard_tpu``'s initial weights of the
  same seed (the same start and the same batches: the two packages'
  trajectories should agree), and of the next seed (another start with
  this seed's batches).

Prints one JSON line per run (package, seed, init, best NDCG@10) and then
each group's mean and standard deviation over the seeds. Run from the
repo root:

    python tests/mf_bpr_seed_study.py --seeds 10 --work <scratch dir> [--jobs 6]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import pickle
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def argv(work: str, seed: int, tag: str) -> list:
    """``run`` arguments of the band's protocol, logs and checkpoints under
    ``work`` in a tree of the run's own."""
    import chip_smoke as cs

    out = ["--model", "MF-BPR", "--root", os.path.join(work, "store_data"),
           "--dataset", cs.STORE_DATASET["name"], "--seed", str(seed), "--log2console", "false",
           "--log-path", os.path.join(work, "logs", tag),
           "--checkpoint-path", os.path.join(work, "infos", tag)]
    for key, value in cs.SLICES["MF-BPR"]["protocol"].items():
        out += ["--" + key.replace("_", "-"), str(value)]
    return out


def jax_run(work: str, seed: int) -> float:
    """``recboard_tpu`` from its own initial weights, which it saves."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from recboard_tpu import run
    from recboard_tpu.launcher import coach

    init_state = coach.Coach._init_state

    def saving(self, batch):
        fresh = self.state is None
        init_state(self, batch)
        if fresh:
            with open(os.path.join(work, f"jax_init_{seed}.pkl"), "wb") as fh:
                pickle.dump({"params": jax.tree.map(np.asarray, self.state.params)}, fh)

    coach.Coach._init_state = saving
    try:
        return float(run.main(argv(work, seed, f"jax_s{seed}"))["NDCG@10"])
    finally:
        coach.Coach._init_state = init_state


def port_run(work: str, seed: int, init_seed) -> float:
    """``recboard_tpu_torch`` on the CPU from its own initial weights
    (``init_seed`` None) or from ``recboard_tpu``'s of ``init_seed``."""
    import torch

    from recboard_tpu_torch import run
    from recboard_tpu_torch.models.convert import from_flax

    torch.set_num_threads(1)
    build = run.build_model
    if init_seed is not None:
        with open(os.path.join(work, f"jax_init_{init_seed}.pkl"), "rb") as fh:
            params = from_flax(pickle.load(fh)["params"])

        def from_jax(*a, **k):
            model = build(*a, **k)
            model.load_state_dict(params)
            return model

        run.build_model = from_jax
    try:
        tag = f"port_s{seed}_i{init_seed}"
        return float(run.main(argv(work, seed, tag) + ["--device", "cpu"])["NDCG@10"])
    finally:
        run.build_model = build


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--work", required=True)
    ap.add_argument("--jobs", type=int, default=6)
    args = ap.parse_args()
    import chip_smoke as cs

    cs.WORK = args.work
    cs.store_dataset()
    seeds = range(args.seeds)
    groups = {}
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(args.jobs, mp_context=ctx) as pool:
        jobs = {("jax", s, "own"): pool.submit(jax_run, args.work, s) for s in seeds}
        jobs |= {("port", s, "own"): pool.submit(port_run, args.work, s, None) for s in seeds}
        for job in list(jobs.values()):  # the JAX package's initial weights first
            job.result()
        for s in seeds:
            jobs[("port", s, "jax_same_seed")] = pool.submit(port_run, args.work, s, s)
            jobs[("port", s, "jax_next_seed")] = pool.submit(
                port_run, args.work, s, (s + 1) % args.seeds)
        for (package, seed, init), job in jobs.items():
            value = job.result()
            groups.setdefault((package, init), []).append(value)
            print(json.dumps(dict(package=package, seed=seed, init=init, ndcg10=value)),
                  flush=True)
    for (package, init), values in groups.items():
        print(json.dumps(dict(package=package, init=init, seeds=len(values),
                              mean=float(np.mean(values)), std=float(np.std(values)),
                              first5_mean=float(np.mean(values[:5])),
                              first5_std=float(np.std(values[:5])))))


if __name__ == "__main__":
    main()
