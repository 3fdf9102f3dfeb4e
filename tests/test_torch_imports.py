"""The port stands alone: importing every module of ``relaxtpu_torch`` and
``chip_smoke`` loads no JAX, no Flax and nothing of ``relaxtpu``; entry
points default to CUDA and raise without it; ``chip_smoke.py`` fails without
a card and without the package.

The import check runs in a subprocess because tests/conftest.py imports jax.
"""

import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import relaxtpu_torch
names = [m.name for m in pkgutil.walk_packages(relaxtpu_torch.__path__, "relaxtpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "relaxtpu"))
print(len(names), bad)
"""


def _clean_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return env


def test_port_imports_nothing_of_jax_or_relaxtpu():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=_clean_env(),
                         capture_output=True, text=True, timeout=120, check=True)
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 20, out.stdout  # every module of the slice was imported
    assert bad == "[]", bad


def test_entry_points_raise_without_cuda(monkeypatch):
    from relaxtpu_torch.cli.__main__ import main
    from relaxtpu_torch.device import resolve_device
    from relaxtpu_torch.features.pipeline import FeatureExtractor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FeatureExtractor({}, {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["predict", "--video", "x.yuv", "--model", "m.npz", "--imputer", "i.pkl",
              "--scaler", "s.pkl"])
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "script_alone"])
def test_chip_smoke_fails_without_card_or_package(tmp_path, alone):
    """No result line and a non-zero exit: on a host without CUDA, and in a
    directory holding chip_smoke.py and nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cwd = ROOT
    env = _clean_env()
    if alone:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
        env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
