"""The port stands alone: importing every ``dragonfly2_tpu_torch`` module
(and ``chip_smoke.py``) in a fresh interpreter loads no JAX-family
package and nothing of ``dragonfly2_tpu``."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "grpc", "pyarrow",
             "tensorstore", "dragonfly2_tpu")

_PROBE = """
import importlib, importlib.util, json, pkgutil, sys
import dragonfly2_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    dragonfly2_tpu_torch.__path__, "dragonfly2_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps({"imported": names, "modules": sorted(sys.modules)}))
"""


@pytest.fixture(scope="module")
def probe():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_every_port_module_imports(probe):
    expected = {
        "dragonfly2_tpu_torch.device",
        "dragonfly2_tpu_torch.ops._build",
        "dragonfly2_tpu_torch.ops.table_gather",
        "dragonfly2_tpu_torch.ops.flash_attention",
        "dragonfly2_tpu_torch.data.synthetic",
        "dragonfly2_tpu_torch.data.features",
        "dragonfly2_tpu_torch.models.graph_transformer",
        "dragonfly2_tpu_torch.models.mlp",
        "dragonfly2_tpu_torch.train.checkpoint",
        "dragonfly2_tpu_torch.train.gat_trainer",
        "dragonfly2_tpu_torch.train.metrics",
        "dragonfly2_tpu_torch.train.split",
        "dragonfly2_tpu_torch.train.step_budget",
        "dragonfly2_tpu_torch.inference.scorer",
        "dragonfly2_tpu_torch.inference.sidecar",
    }
    assert expected <= set(probe["imported"])


@pytest.mark.parametrize("package", FORBIDDEN)
def test_no_forbidden_module_loaded(probe, package):
    # Match the top-level name exactly: "dragonfly2_tpu_torch" shares the
    # "dragonfly2_tpu" prefix but is not that package.
    hits = [m for m in probe["modules"] if m.split(".")[0] == package]
    assert hits == [], hits
