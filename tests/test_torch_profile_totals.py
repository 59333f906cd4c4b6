"""chip_smoke.profile_totals against torch.profiler's own key_averages.

chip_smoke reads every training and serving profile through
``profile_totals``, one pass over the profiler's raw events, instead of
``key_averages()``, which builds a Python object for every event first.
Here, on the CPU, a few Adam steps of a small model (nested operators,
``Optimizer.step``'s user annotation, a ``record_function`` range, an
operator nested alone in one of its own name) are profiled, and each
host operator's name, self µs and calls must equal key_averages' (times
within float rounding). The card's rows are the device spans' own
lengths, summed by name as key_averages sums them.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from chip_smoke import profile_totals, profiled_ops


def averaged_rows(prof, per: int) -> dict:
    return {e.key: (e.self_cpu_time_total / per, e.count / per) for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and not e.is_user_annotation}


@pytest.mark.parametrize("steps", [1, 6])
def test_host_rows_equal_key_averages(steps):
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    model = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.GELU(), torch.nn.LayerNorm(32),
                                torch.nn.Linear(32, 8))
    gru = torch.nn.GRU(8, 8, batch_first=True)
    opt = torch.optim.Adam([*model.parameters(), *gru.parameters()], lr=1e-3, weight_decay=1e-4)
    x = torch.from_numpy(rng.normal(size=(steps, 12, 5, 16)).astype(np.float32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for step in range(steps):
            with record_function("one_step"):
                out, _ = gru(model(x[step]))
                loss = out.square().mean()
                opt.zero_grad()
                loss.backward()
                opt.step()
    totals = profile_totals(prof)
    assert not totals[True]  # no device on the CPU
    got = {name: (us, n) for name, us, n in profiled_ops(totals, steps, device=False)}
    want = averaged_rows(prof, steps)
    assert set(got) == set(want)
    assert "one_step" not in got and not any(k.startswith("Optimizer.step") for k in got)
    for name, (us, n) in want.items():
        assert got[name][1] == n, name
        assert got[name][0] == pytest.approx(us, rel=1e-9, abs=1e-9), name
    rows = profiled_ops(totals, steps, device=False)
    assert [us for _, us, _ in rows] == sorted((us for _, us, _ in rows), reverse=True)
