"""``models.modules.GRU`` at the shapes the ported models give it, through
cuDNN and through PyTorch's own CUDA GRU (``torch.backends.cudnn.flags(
enabled=False)``: a fused cell kernel per step beside cuBLAS products), on
the card: the forward and forward + backward times by CUDA events, the two
backends' largest output difference, as one JSON line a shape
(``probe_gru``), after the card's name and power limit. Needs a CUDA
device; run from the repo root:

    python3 tests/gru_backend_probe.py

Compare the backends only within one call: the host's and the card's speed
vary between machines.
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (name, batch, steps, input, hidden): LESSR's EOPA layers over B x L node
# sequences of L - 1 neighbour slots (training at batch 512, evaluation at
# 256, the toy store at 128 and maxlen 20), GRU4Rec's, NARM's and GLINT-RU's
SHAPES = [
    ("lessr_train_layer0", 512 * 50, 49, 64, 64),
    ("lessr_train_layer2", 512 * 50, 49, 192, 192),
    ("lessr_eval_layer2", 256 * 50, 49, 192, 192),
    ("lessr_store_layer0", 128 * 20, 19, 64, 64),
    ("lessr_store_layer2", 128 * 20, 19, 192, 192),
    ("gru4rec_train", 512, 50, 64, 128),
    ("narm_train", 512, 50, 64, 64),
    ("glint_ru_train", 2048, 50, 128, 128),
]


def timed_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


if __name__ == "__main__":
    import torch

    from recboard_tpu_torch.models.modules import GRU

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    for name, B, T, D, H in SHAPES:
        gen = torch.Generator().manual_seed(0)
        gru = GRU(D, H).cuda()
        x = torch.randn(B, T, D, generator=gen).cuda().requires_grad_()
        g = torch.randn(B, T, H, generator=gen).cuda()
        row, outs = dict(shape=name, batch=B, steps=T, input=D, hidden=H), {}
        for backend, enabled in (("cudnn", True), ("native", False)):
            with torch.backends.cudnn.flags(enabled=enabled, allow_tf32=False):
                with torch.no_grad():
                    outs[backend] = gru(x)[0]
                iters = 3 if B * T * H > 1e8 else 20

                def step():
                    gru(x)[0].backward(g)

                with torch.no_grad():
                    row[f"{backend}_fwd_ms"] = timed_ms(lambda: gru(x), iters)
                row[f"{backend}_fwd_bwd_ms"] = timed_ms(step, iters)
                torch.cuda.reset_peak_memory_stats()
                step()
                row[f"{backend}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        row["max_abs_diff"] = float((outs["cudnn"] - outs["native"]).abs().max())
        print(json.dumps(dict(phase="probe_gru", **row)), flush=True)
