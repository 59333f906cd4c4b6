"""The slice as a whole: a SASRec run trained by recboard_tpu is served by
recboard_tpu.serve and by recboard_tpu_torch.serve (on the CPU), and the
two top-k tables must agree.

Agreement is tie-tolerant (chip_smoke.compare_topk): the same users,
scores equal to 1e-4 position by position, and the same top-i id sets
wherever the i-th and (i+1)-th scores differ by more than 1e-4
(``lax.top_k`` and ``torch.topk`` may order ties differently).
"""

import numpy as np
import pytest

from chip_smoke import compare_topk, read_scored_tsv

K = 7


@pytest.fixture(scope="module")
def trained_run(tiny_dataset, tmp_path_factory):
    from recboard_tpu import run as run_mod

    tmp = tmp_path_factory.mktemp("torch_serve")
    run_mod.main([
        "--model", "SASRec", "--root", tiny_dataset.root,
        "--dataset", tiny_dataset.dataset,
        "--epochs", "3", "--lr", "0.01", "--maxlen", "10", "--batch-size", "16",
        "--num-heads", "2", "--embedding-dim", "16",
        "--log-path", str(tmp / "logs"), "--checkpoint-path", str(tmp / "infos"),
    ])
    run_dirs = sorted((tmp / "logs" / "SASRec" / tiny_dataset.dataset).iterdir())
    return run_dirs[-1], tmp


def test_port_serves_jax_run_like_jax(tiny_dataset, trained_run):
    from recboard_tpu import serve as serve_jax
    from recboard_tpu_torch import serve

    run_dir, tmp = trained_run
    # K + 1 ids: the (K+1)-th score bounds ties at the K-th
    common = ["--run", str(run_dir), "--topk", str(K + 1), "--with-scores",
              "--batch-size", "16"]
    serve_jax.main(common + ["--output", str(tmp / "jax.tsv")])
    serve.main(common + ["--output", str(tmp / "torch.tsv"), "--device", "cpu"])
    jax_rows = read_scored_tsv(tmp / "jax.tsv")
    torch_rows = read_scored_tsv(tmp / "torch.tsv")
    assert compare_topk(jax_rows, torch_rows) == []

    n_items = tiny_dataset.fields["ITEM", "ID"].count
    train = tiny_dataset.train().user_seqs()
    valid = tiny_dataset.valid().user_seqs()
    for user, (ids, vals) in torch_rows.items():
        top = ids[:K].tolist()
        assert len(set(top)) == K
        assert all(0 <= i < n_items for i in top)
        assert not set(top) & (set(train[user]) | set(valid[user]))
        assert np.all(np.diff(vals) <= 0)


def test_port_plain_tsv_and_bench(trained_run, capsys):
    from recboard_tpu import serve as serve_jax
    from recboard_tpu_torch import serve

    run_dir, tmp = trained_run
    serve_jax.main(["--run", str(run_dir), "--output", str(tmp / "jax_plain.tsv"),
                    "--retain-seen", "--split", "valid"])
    serve.main(["--run", str(run_dir), "--output", str(tmp / "torch_plain.tsv"),
                "--retain-seen", "--split", "valid", "--device", "cpu"])
    rows_j = (tmp / "jax_plain.tsv").read_text().splitlines()
    rows_t = (tmp / "torch_plain.tsv").read_text().splitlines()
    assert [r.split("\t")[0] for r in rows_j] == [r.split("\t")[0] for r in rows_t]
    assert all(len(r.split("\t")) == 11 for r in rows_t)

    capsys.readouterr()
    serve.main(["--run", str(run_dir), "--bench", "--device", "cpu",
                "--batch-size", "8", "--bench-batches", "3"])
    import json

    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["metric"] == "recommend_latency_ms" and stats["batches"] == 3
    assert stats["device"] == "cpu"
    assert stats["p50"] <= stats["p95"] <= stats["p99"]


@pytest.mark.parametrize("flag", [
    ["--num-model-shards", "2"], ["--sharded-rank"], ["--blocked-topk", "64"],
])
def test_unported_routes_refuse(trained_run, flag):
    from recboard_tpu_torch import serve

    run_dir, _ = trained_run
    with pytest.raises(SystemExit, match="not ported"):
        serve.main(["--run", str(run_dir), "--device", "cpu"] + flag)


def test_recommend_without_gpu_raises(trained_run, monkeypatch):
    import torch

    from recboard_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run_dir, _ = trained_run
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["recommend", "--run", str(run_dir)])
