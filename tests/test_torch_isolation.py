"""The PyTorch port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports JAX or the JAX package ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
want = {"repro_torch.launch.serve", "repro_torch.core.gmm",
        "repro_torch.core.random_forest", "repro_torch.kernels.topk_select",
        "repro_torch.kernels.pairwise_sq_dist",
        "repro_torch.kernels.quantized", "repro_torch.kernels.ann",
        "repro_torch.core.quantization", "repro_torch.core.ann",
        "repro_torch.serving.quant", "repro_torch.models.transformer",
        "repro_torch.kernels.gemm", "repro_torch.kernels.flash_attention",
        "repro_torch.configs.registry", "repro_torch.serving.scheduler",
        "repro_torch.serving.degrade", "repro_torch.runtime.events",
        "repro_torch.runtime.straggler", "repro_torch.core.gemm_based",
        "repro_torch.serving.model_store", "repro_torch.runtime.chaos",
        "repro_torch.core.precision", "repro_torch.core.amdahl",
        "repro_torch.core.calibrate"}
assert want <= set(names), sorted(want - set(names))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), "modules;", "foreign:", bad)
sys.exit(1 if bad else 0)
"""


def test_importing_every_module_pulls_in_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_names_jax_or_the_reference_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20 and files[-1].exists()
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"
