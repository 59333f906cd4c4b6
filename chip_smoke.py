#!/usr/bin/env python3
"""Drive recboard_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0]

Phases, one JSON line each; any failure exits non-zero:

1. device  — the card's name and power limit (nvidia-smi).
2. build   — compiles every CUDA source in recboard_tpu_torch/ops/csrc.
3. kernels — each kernel against its plain PyTorch version on the card
   (float32, TF32 off), with its max |error| against a stated tolerance
   and CUDA-event times beside the plain version and a library call.
4. slice   — ``recommend`` for SASRec at full width (D 64, 2 blocks,
   1 head, maxlen 50) over a dataset of SynBeautyXL's shape (22,363
   users, 12,101 items) with random weights made from --seed: checks
   every list, that each served batch launched the attention kernel
   once per block, and that the GPU lists agree with ``--device cpu``;
   then the ``--bench`` latency line.
5. profile — device time by kernel over one ``--bench`` call, from
   torch.profiler, and the device's idle share.

Then a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1
before printing any result. Scratch files go to build/chip_smoke/.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

TOL = 1e-5  # max |kernel - plain| for float32 attention outputs of O(1)
TIE_TOL = 1e-4  # scores closer than this may rank in either order
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOP_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores

# (name, B, L, S, H, hd, causal, key_pad, bias, fully-masked rows)
ATTN_SHAPES = [
    ("sasrec_serving", 512, 50, 50, 1, 64, True, False, False, False),
    ("long_keypad", 256, 200, 200, 2, 32, False, True, False, False),
    ("bias_masked_rows", 64, 6, 50, 4, 16, False, False, True, True),
]
# correctness-only cases for the paths the timed shapes leave out:
# causal with L != S, causal with pad and bias, rows with no visible key,
# and the 128-wide head that needs more than 48 KB of shared memory
ATTN_EXTRA = [
    ("causal_pad_bias_hd128", 8, 37, 70, 2, 128, True, True, True, False),
    ("causal_L_gt_S", 4, 70, 40, 3, 24, True, True, False, False),
]

SASREC = dict(maxlen=50, embedding_dim=64, num_blocks=2, num_heads=1)
DATASET = dict(  # benchmark/SynBeautyXL_000_LOU/meta.json build_command
    name="SynBeautyXL_000_LOU", num_users=22_363, num_items=12_101,
    avg_len=8.9, seed=7, markov_strength=0.45, group_strength=0.45,
    num_groups=96, group_markov=True, splitting="LOU",
)
TOPK = 10
BATCH = 512


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_inputs(case, rng):
    """Inputs of one attention case, made with numpy and moved to the card."""
    import torch

    name, B, L, S, H, hd, causal, key_pad, bias, masked_rows = case
    D = H * hd
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    q = t(rng.normal(size=(B, L, D)).astype(np.float32))
    k = t(rng.normal(size=(B, S, D)).astype(np.float32))
    v = t(rng.normal(size=(B, S, D)).astype(np.float32))
    pad = t(rng.random((B, S)) < 0.3) if key_pad else None
    if pad is not None:
        pad[0] = True  # one batch row with every key padded
    b = None
    if bias:
        b = rng.normal(size=(1, H, L, S)).astype(np.float32)
        if masked_rows:
            b[0, :, 0, :] = -1e30  # query row 0 masked in every head
            b[0, 1 % H, 2, :] = -1e30
        b = t(b)
    return dict(q=q, k=k, v=v, num_heads=H, causal=causal,
                key_padding_mask=pad, bias=b)


def attention_bound(inp) -> tuple:
    """(ms, "bytes" or "operations"): the least time for the work these
    inputs need, the larger of each input read once and the output written
    once at the HBM rate, and 4*hd FLOP (QK and PV FMAs) per unmasked
    (query, key) pair at the float32 rate."""
    import torch

    from recboard_tpu_torch.ops.attention import NEG_INF, _merge_masks

    q, k = inp["q"], inp["k"]
    B, L, D = q.shape
    S, H = k.shape[1], inp["num_heads"]
    tensors = [q, k, inp["v"], q, inp["key_padding_mask"], inp["bias"]]
    nbytes = sum(x.numel() * x.element_size() for x in tensors if x is not None)
    add = _merge_masks(L, S, inp["causal"], inp["key_padding_mask"], q.dtype, q.device)
    scores = torch.zeros((B, H, L, S), device=q.device)
    if add is not None:
        scores = scores + add[:, None]
    if inp["bias"] is not None:
        scores = scores + inp["bias"]
    pairs = int((scores > NEG_INF / 2).sum())
    flops = 4 * (D // H) * pairs
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(bytes_s, ops_s), "bytes" if bytes_s >= ops_s else "operations"


def library_attention(inp):
    """One PyTorch call computing the same function (a yardstick only:
    it gives NaN where a row has no unmasked key)."""
    import torch
    import torch.nn.functional as F

    q, k, v, H = inp["q"], inp["k"], inp["v"], inp["num_heads"]
    B, L, D = q.shape
    S = k.shape[1]
    heads = lambda x, n: x.view(B, n, H, D // H).transpose(1, 2)  # noqa: E731
    mask = None
    if inp["causal"] and not (L == S and inp["key_padding_mask"] is None
                              and inp["bias"] is None):
        raise ValueError("library_attention: causal only at L == S without masks")
    if inp["key_padding_mask"] is not None:
        mask = ~inp["key_padding_mask"][:, None, None, :]
    if inp["bias"] is not None:
        mask = inp["bias"] if mask is None else inp["bias"].masked_fill(~mask, -math.inf)
    qh, kh, vh = heads(q, L), heads(k, S), heads(v, S)
    return lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, is_causal=inp["causal"]
    )


def check_attention(rng):
    """Kernel against the plain version on the card; times the timed shapes."""
    import torch

    from recboard_tpu_torch.ops import attention as A

    rows, worst = [], 0.0
    for case in ATTN_SHAPES + ATTN_EXTRA:
        inp = attention_inputs(case, rng)
        want = A.mha_reference(**inp)
        got = A.mha_fwd(**inp)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        finite = bool(torch.isfinite(got).all())
        worst = max(worst, err)
        row = dict(shape=case[0], B=case[1], L=case[2], S=case[3], H=case[4],
                   hd=case[5], max_abs_err=err, tol=TOL, finite=finite)
        if case in ATTN_SHAPES:
            bound_ms, bound_by = attention_bound(inp)
            row.update(
                ms=cuda_ms(lambda: A.mha_fwd(**inp)),
                plain_ms=cuda_ms(lambda: A.mha_reference(**inp)),
                library_ms=cuda_ms(library_attention(inp)),
                bound_ms=bound_ms, bound_by=bound_by,
            )
        emit("kernels", kernel="mha_fwd", **row)
        if not finite or not err <= TOL:
            raise SystemExit(f"mha_fwd disagrees with mha_reference at {case[0]}: {err}")
        rows.append(row)
    return rows, worst


def xavier(rng, fan_in, fan_out, shape=None):
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return (rng.normal(size=shape or (fan_in, fan_out)) * std).astype(np.float32)


def sasrec_flax_params(rng, num_items, maxlen, embedding_dim, num_blocks, **_):
    """SASRec params in recboard_tpu's flax layout (what its Coach
    pickles), made with numpy: xavier weights, small random biases and
    LayerNorm affines."""
    D = embedding_dim
    small = lambda: (rng.normal(size=D) * 0.02).astype(np.float32)  # noqa: E731
    ln = lambda: {"scale": 1.0 + small(), "bias": small()}  # noqa: E731
    dense = lambda: {"kernel": xavier(rng, D, D), "bias": small()}  # noqa: E731
    params = {
        "item_embeddings": {"embedding": xavier(rng, num_items + 1, D)},
        "position_embeddings": {"embedding": xavier(rng, maxlen, D)},
        "last_ln": ln(),
    }
    for i in range(num_blocks):
        params[f"blocks_{i}"] = {
            "LayerNorm_0": ln(), "q_proj": dense(), "k_proj": dense(),
            "v_proj": dense(), "out_proj": dense(), "LayerNorm_1": ln(),
            "PointWiseFFN_0": {"Dense_0": dense(), "Dense_1": dense()},
        }
    return params


def read_scored_tsv(path):
    """``user \\t item:score ...`` → {user: (ids, scores)}."""
    out = {}
    with open(path) as fh:
        for line in fh:
            user, *cells = line.rstrip("\n").split("\t")
            pairs = [c.split(":") for c in cells]
            out[int(user)] = (
                np.asarray([int(i) for i, _ in pairs]),
                np.asarray([float(s) for _, s in pairs]),
            )
    return out


def compare_topk(a, b, tol=TIE_TOL):
    """Tie-tolerant agreement of two scored top-K tables: the same users,
    scores equal to ``tol`` position by position, and wherever the i-th
    and (i+1)-th scores differ by more than ``tol`` the first i ids are
    the same set. Returns a list of disagreements (empty when they agree)."""
    bad = []
    if a.keys() != b.keys():
        return [f"users differ: {len(a)} vs {len(b)}"]
    for user, (ids_a, vals_a) in a.items():
        ids_b, vals_b = b[user]
        if len(ids_a) != len(ids_b) or not np.allclose(vals_a, vals_b, rtol=0, atol=tol):
            bad.append(f"user {user}: scores {vals_a} vs {vals_b}")
            continue
        for i in range(1, len(ids_a)):
            if vals_a[i - 1] - vals_a[i] > tol and set(ids_a[:i]) != set(ids_b[:i]):
                bad.append(f"user {user}: top-{i} {ids_a[:i]} vs {ids_b[:i]}")
                break
    return bad


def write_run(seed: int) -> tuple:
    """Dataset of SynBeautyXL's shape + a run directory holding a SASRec
    config snapshot and a random flax-layout params pickle."""
    import yaml

    from recboard_tpu_torch import utils
    from recboard_tpu_torch.data import synthetic
    from recboard_tpu_torch.data.datasets import NextItemRecDataSet

    shutil.rmtree(WORK, ignore_errors=True)
    data_root = os.path.join(WORK, "data")
    spec = dict(DATASET)
    synthetic.make_synthetic_dataset(data_root, spec.pop("name"), **spec)
    dataset = NextItemRecDataSet(data_root, DATASET["name"])
    num_items = dataset.fields["ITEM", "ID"].count

    run_dir = os.path.join(WORK, "run")
    ckpt_dir = os.path.join(run_dir, "ckpt")
    cfg = dict(model="SASRec", root=data_root, dataset=DATASET["name"],
               tasktag="NEXTITEM", seed=seed, CHECKPOINT_PATH=ckpt_dir,
               BEST_FILENAME="best.safetensors", **SASREC)
    utils.mkdirs(ckpt_dir)
    with open(os.path.join(run_dir, "config.yaml"), "w") as fh:
        yaml.safe_dump(cfg, fh, sort_keys=True)
    params = sasrec_flax_params(np.random.default_rng(seed), num_items, **SASREC)
    utils.export_pickle({"params": params}, os.path.join(ckpt_dir, "best.safetensors"))
    return dataset, run_dir


def serve_slice(seed: int) -> dict:
    from recboard_tpu_torch import serve
    from recboard_tpu_torch.ops import attention as A

    t0 = time.perf_counter()
    dataset, run_dir = write_run(seed)
    setup_s = time.perf_counter() - t0
    num_items = dataset.fields["ITEM", "ID"].count
    # K + 1 ids per user: the (K+1)-th score bounds ties at the K-th
    common = ["--run", run_dir, "--topk", str(TOPK + 1), "--with-scores",
              "--batch-size", str(BATCH)]
    gpu_tsv, cpu_tsv = os.path.join(WORK, "gpu.tsv"), os.path.join(WORK, "cpu.tsv")

    A.mha_fwd.launches = 0
    t0 = time.perf_counter()
    serve.main(common + ["--output", gpu_tsv])
    gpu_s = time.perf_counter() - t0
    launches = A.mha_fwd.launches

    gpu = read_scored_tsv(gpu_tsv)
    batches = math.ceil(len(gpu) / BATCH)
    if launches != SASREC["num_blocks"] * batches:
        raise SystemExit(
            f"mha_fwd launched {launches} times for {batches} batches "
            f"of {SASREC['num_blocks']} blocks"
        )
    train, valid = dataset.train().user_seqs(), dataset.valid().user_seqs()
    for user, (ids, vals) in gpu.items():
        top = ids[:TOPK]
        seen = set(train[user]) | set(valid[user])
        if (len(set(top)) != TOPK or top.min() < 0 or top.max() >= num_items
                or seen & set(top.tolist()) or not np.isfinite(vals).all()):
            raise SystemExit(f"user {user}: bad list {top} (seen {sorted(seen)})")

    t0 = time.perf_counter()
    serve.main(common + ["--output", cpu_tsv, "--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    bad = compare_topk(gpu, read_scored_tsv(cpu_tsv))
    if bad:
        raise SystemExit("GPU and CPU lists disagree:\n" + "\n".join(bad[:10]))

    emit("slice", users=len(gpu), items=num_items, batches=batches,
         mha_fwd_launches=launches, topk=TOPK, cpu_agree=True,
         setup_s=setup_s, serve_gpu_s=gpu_s, serve_cpu_s=cpu_s, **SASREC)

    bench = run_bench(run_dir)
    emit("bench", **bench)
    return dict(launches=launches, run_dir=run_dir, bench=bench)


def run_bench(run_dir: str) -> dict:
    """``recommend --bench`` at the slice's settings; its JSON line."""
    from recboard_tpu_torch import serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--run", run_dir, "--topk", str(TOPK), "--bench",
                    "--batch-size", str(BATCH)])
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def profile_bench(run_dir: str, p50_ms: float) -> None:
    """Device time by kernel over one ``--bench`` call under torch.profiler
    (its warm-up and timed passes each serve every staged batch), and the
    device's idle share of the unprofiled p50 batch time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        bench = run_bench(run_dir)
    calls = 2 * bench["batches"]
    kernels = sorted(
        ((e.key, e.self_device_time_total / calls, e.count / calls)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda row: -row[1],
    )
    device_us = sum(us for _, us, _ in kernels)
    emit("profile", device_us_per_batch=device_us,
         launches_per_batch=sum(n for _, _, n in kernels),
         unprofiled_p50_ms=p50_ms,
         idle_share=1.0 - device_us / (1e3 * p50_ms),
         kernels=[dict(name=name[:90], us_per_batch=us, per_batch=n)
                  for name, us, n in kernels[:12]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and kernel inputs")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # float32 everywhere: the plain versions are the references
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from recboard_tpu_torch.ops import _build

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    logs = _build.build()
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", sources=list(_build.SOURCES), seconds=time.perf_counter() - t0,
         ptxas=ptxas)

    rows, worst = check_attention(np.random.default_rng(args.seed))
    slice_ = serve_slice(args.seed)
    profile_bench(slice_["run_dir"], slice_["bench"]["p50"])

    serving = rows[0]
    print(json.dumps({"kernels": [{
        "name": "mha_fwd", "route": "cuda",
        "source": "recboard_tpu_torch/ops/csrc/mha_fwd.cu",
        "replaces": "recboard_tpu/ops/attention.py:143",
        "launches": slice_["launches"], "max_abs_err": worst,
        "ms": serving["ms"], "plain_ms": serving["plain_ms"],
        "bound_ms": serving["bound_ms"], "bound_by": serving["bound_by"],
        "library_ms": serving["library_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
