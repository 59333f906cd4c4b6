"""The toy store's protocol (``tools/seed_sweep.py``'s arguments: 30 epochs, lr
0.005, batch 128, eval every 3, the model's defaults; AlphaRec ``--tfile``
over the store's 24-wide SVD features) for one graph CF model and a range of
seeds, on the CPU, through ``recboard_tpu``'s runner (``jax``)
or the port's (``torch``, ``chip_smoke.store_runs`` in 4 processes): each
seed's best NDCG@10, then their mean and sample std. A study of a band's
anchor: how far the store's 5-seed mean lies from more seeds of the same
protocol in either package. Run from the repo root:

    python3 tests/graph_cf_band_probe.py jax SGL 5 15
    python3 tests/graph_cf_band_probe.py torch SGL 0 15
    python3 tests/graph_cf_band_probe.py jax AlphaRec 0 15
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def jax_runs(model: str, seeds: range) -> list:
    """recboard_tpu's runner on the CPU over the toy store, seed by seed."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from recboard_tpu import run
    from recboard_tpu_torch.data import synthetic
    from recboard_tpu_torch.data.datasets import NextItemRecDataSet

    data = dict(cs.STORE_DATASET)
    name = data.pop("name")
    data_root = os.path.join(cs.WORK, "band_probe", model, "data")  # one a model: runs in parallel
    synthetic.make_synthetic_dataset(data_root, name, **data)
    synthetic.write_item_features(NextItemRecDataSet(data_root, name))  # AlphaRec's --tfile
    extra = ["--tfile", cs.FEATURES["tfile"]] if model == "AlphaRec" else []
    out = []
    for seed in seeds:
        work = os.path.join(cs.WORK, "band_probe", f"{model}-s{seed}")
        best = run.main(["--model", model, "--root", data_root, "--dataset", name,
                         "--epochs", "30", "--lr", "0.005", "--batch-size", "128",
                         "--eval-freq", "3", "--seed", str(seed), "--description", model,
                         "--log2console", "false", "--log-path", os.path.join(work, "logs"),
                         "--checkpoint-path", os.path.join(work, "infos")] + extra)
        out.append(best["NDCG@10"])
    return out


if __name__ == "__main__":
    package, model, first, last = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    seeds = range(first, last)
    if package == "jax":
        values = jax_runs(model, seeds)
    else:
        cs.STORE_PROCESSES = 4
        values = cs.store_runs((model,), seeds, concurrent=True, device="cpu")[model][0]
    for seed, value in zip(seeds, values):
        print(f"{package} {model} seed {seed}: {value:.6f}")
    print(f"{package} {model} seeds {first}-{last - 1}: mean {np.mean(values):.6f} "
          f"std {np.std(values, ddof=1):.6f}")
