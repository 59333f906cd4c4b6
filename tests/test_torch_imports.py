"""recboard_tpu_torch stands without JAX: importing every module of the
port (and chip_smoke.py) loads no jax, flax or recboard_tpu module, and a
checkpoint written by recboard_tpu unpickles with those blocked."""

import os
import pkgutil
import subprocess
import sys

import numpy as np

import recboard_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "recboard_tpu")


def _run(code: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_port_modules_import_without_jax():
    modules = sorted(
        m.name for m in pkgutil.walk_packages(
            recboard_tpu_torch.__path__, prefix="recboard_tpu_torch."
        )
        if not m.name.endswith(".__main__")  # runs the CLI when imported
    )
    assert "recboard_tpu_torch.ops.attention" in modules
    assert "recboard_tpu_torch.serve" in modules
    code = (
        "import importlib, sys\n"
        f"for name in {modules + ['recboard_tpu_torch', 'chip_smoke']!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_jax_checkpoint_loads_with_jax_blocked(tiny_dataset, tmp_path):
    import jax

    from recboard_tpu import utils as utils_jax
    from recboard_tpu.models.zoo import SASRec as SASRecJax

    model = SASRecJax(tiny_dataset, maxlen=10, embedding_dim=16)
    batch = next(iter(model.sure_trainpipe(10, 8)))
    arrays = {f: v for f, v in batch.items() if isinstance(v, np.ndarray)}
    params = model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, arrays
    )["params"]
    path = tmp_path / "best.safetensors"
    # the payload recboard_tpu's Coach.save writes
    utils_jax.export_pickle({"params": jax.tree.map(np.asarray, params)}, str(path))

    code = (
        "import sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None  # any import of these now fails\n"
        "from recboard_tpu_torch import utils\n"
        "from recboard_tpu_torch.data.datasets import NextItemRecDataSet\n"
        "from recboard_tpu_torch.models.convert import from_flax\n"
        "from recboard_tpu_torch.models.zoo import SASRec\n"
        f"payload = utils.import_pickle({str(path)!r})\n"
        f"ds = NextItemRecDataSet({tiny_dataset.root!r}, {tiny_dataset.dataset!r})\n"
        "model = SASRec(ds, maxlen=10, embedding_dim=16)\n"
        "model.load_state_dict(from_flax(payload['params']))\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
