"""Import hygiene of the port: ``torchdistx_tpu_torch`` imports neither JAX
nor the JAX package, and importing it builds nothing."""

import ast
import os
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "torchdistx_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "torchdistx_tpu")


def test_import_pulls_in_no_jax_and_builds_nothing(tmp_path):
    code = (
        "import sys\n"
        "import torchdistx_tpu_torch, torchdistx_tpu_torch.serve, "
        "torchdistx_tpu_torch.models, torchdistx_tpu_torch.interop, "
        "torchdistx_tpu_torch.trainer, torchdistx_tpu_torch.optimizers, "
        "torchdistx_tpu_torch.deferred_init, torchdistx_tpu_torch.utils.benchmarks, "
        "torchdistx_tpu_torch.data, torchdistx_tpu_torch.examples.train_gpt2, "
        "torchdistx_tpu_torch.models.gpt2, torchdistx_tpu_torch.ops.fused_ce\n"
        "from torchdistx_tpu_torch.ops import _build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "assert not _build._libs\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT), PATH="/usr/bin:/bin")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


@pytest.mark.parametrize(
    "path", sorted(p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py"))
    + ["chip_smoke.py"]
)
def test_source_has_no_jax_import(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: import {name}"


def test_every_subpackage_is_packaged():
    """``pyproject.toml`` lists its packages one by one: every package of
    the port on disk must be in that list, or an installed wheel lacks it."""
    listed = set(tomllib.loads((ROOT / "pyproject.toml").read_text())
                 ["tool"]["setuptools"]["packages"])
    on_disk = {p.parent.relative_to(ROOT).as_posix().replace("/", ".")
               for p in PORT.rglob("__init__.py")}
    assert "torchdistx_tpu_torch.optimizers" in on_disk
    assert on_disk <= listed, sorted(on_disk - listed)
