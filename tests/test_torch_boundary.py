"""The port's package boundary: ``filodb_tpu_torch`` and ``chip_smoke.py``
never import JAX or anything of the JAX package ``filodb_tpu``, and the
port's stores default to the CUDA device, refusing to start without one
rather than moving to the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "filodb_tpu_torch")

_DRIVE = r'''
import sys
import numpy as np
from filodb_tpu_torch.core.filters import ColumnFilter, Equals
from filodb_tpu_torch.core.record import RecordBuilder
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
from filodb_tpu_torch.core.storeconfig import StoreConfig
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.query.logical import RangeFunctionId as F

STEP, T0 = 60_000, 1_700_000_040_000
ms = TimeSeriesMemStore(device="cpu")
shard = ms.setup("prom", DEFAULT_SCHEMAS, 0, StoreConfig())
b = RecordBuilder(DEFAULT_SCHEMAS["prom-counter"])
for i in range(4):
    ts = T0 + np.arange(40, dtype=np.int64) * STEP - STEP + 1000 * (i + 1)
    b.add_series(ts, [np.cumsum(np.full(40, 2.0))],
                 {"__name__": "m", "pod": f"p{i}", "_ws_": "w", "_ns_": "n"})
for off, c in enumerate(b.containers()):
    shard.ingest_container(c, off)
shard.flush_all()
ids = shard.lookup_partitions([ColumnFilter("_metric_", Equals("m"))],
                              0, 2**62).part_ids
st = shard.scan_grid_grouped(ids, F.RATE, T0 + 10 * STEP, 20, STEP,
                             5 * STEP, [0, 0, 1, 1], 2, "sum")
assert st is not None and np.isfinite(st["sum"]).all(), st
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "filodb_tpu"
             or m.startswith("filodb_tpu."))
print("LOADED", bad)
'''


def test_import_and_serve_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _DRIVE], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


def _sources():
    for dirpath, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "filodb_tpu")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_default_device_without_cuda_raises(monkeypatch):
    from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
    from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.memstore.shard import TimeSeriesShard

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TimeSeriesMemStore()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TimeSeriesShard("prom", DEFAULT_SCHEMAS, 0)
    assert TimeSeriesMemStore(device="cpu").device.type == "cpu"
