"""The port stands alone: importing every module of ``relaxtpu_torch`` and
``chip_smoke`` loads no JAX, no Flax, nothing of ``relaxtpu``, neither
sklearn nor pandas (the card's host has none of them), and no cv2 (loaded
only where a container is read or a greyscale report is made); entry
points default to CUDA and raise without it; ``chip_smoke.py`` fails without
a card and without the package; and every public name of ``relaxtpu/``
has a counterpart in the port, or a stated reason in ``NOT_PORTED``.

The import check runs in a subprocess because tests/conftest.py imports jax.
"""

import ast
import collections
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
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "relaxtpu", "sklearn", "pandas", "cv2"))
print(len(names), bad, " ".join(names))
"""
# modules that a later slice added; each must be among those imported
LATER_MODULES = {"relaxtpu_torch.config", "relaxtpu_torch.parallel.mesh", "relaxtpu_torch.parallel.distributed",
                 "relaxtpu_torch.parallel.eval", "relaxtpu_torch.parallel.train_dp", "relaxtpu_torch.visualize",
                 "relaxtpu_torch.parity", "relaxtpu_torch.oracle", "relaxtpu_torch.data.recover",
                 "relaxtpu_torch.utils.report", "relaxtpu_torch.utils.plots"}


def _clean_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return env


def test_port_imports_nothing_of_jax_or_relaxtpu():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=_clean_env(),
                         capture_output=True, text=True, timeout=120, check=True)
    n, bad, names = out.stdout.strip().split(" ", 2)
    assert int(n) >= 58, out.stdout  # every module of the slice was imported
    assert LATER_MODULES <= set(names.split()), names
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
    head = ["--model", "m.npz", "--imputer", "i.pkl", "--scaler", "s.pkl"]
    for argv in (["predict", "--video", "x.yuv"], ["predict-batch", "--videos", "x.yuv"], ["serve"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv + head)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["warmup"])
    pair = ["--train-metadata", "a.csv", "--test-metadata", "b.csv",
            "--train-features", "a.npy", "--test-features", "b.npy"]
    for argv in (["train", "--metadata-csv", "m.csv", "--features", "f.npy"],
                 ["train-lsvq", *pair], ["train-cross", *pair],
                 ["finetune", "--dataset", "konvid_1k", "--metadata-csv", "m.csv",
                  "--features", "f.npy", "--base-model", "b.npz"],
                 ["extract", "--dataset", "live_qualcomm", "--metadata-csv", "m.csv"],
                 ["visualize", "--frame", "a.png", "--next-frame", "b.png"],
                 ["parity", "--check", "features"], ["parity", "--check", "production"],
                 ["parity", "--check", "all"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
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


# JAX package names with no counterpart of that name in the port's module
# of the same path, and why ("module.name", or "module.Class.method")
NOT_PORTED = {
    "ops.attention.fused_mha": "the Pallas kernel; ported as K3, ops.attention.mha",
    "ops.boxsolve.box_blur_solve_pallas": "the Pallas kernel; ported as K2, ops.boxsolve.box_blur_solve",
    "ops.warp.warp_planes_banded": "the TPU's banded one-hot warp; K1 (ops.warp.update_matrices) gathers exactly",
    "ops.warp.warp_planes_banded_pallas": "the Pallas kernel; ported as K1, ops.warp.update_matrices",
    "ops.warp.warp_planes_banded_xla": "the XLA form of the banded warp; K1's plain version is update_matrices_plain",
    "utils.jaxcache.enable_compilation_cache": "XLA's compile cache; the port's is _native's nvcc build cache",
    "parallel.mesh.data_sharding": "a jax sharding; the port's mesh is torch.distributed ranks (mesh.shard_batch)",
    "parallel.mesh.replicate": "a jax sharding; every rank holds its own copy of the weights",
    "parallel.train_dp.DistributedMlpTrainStep.shard_params": "a jax sharding; each rank builds its own slice",
    "features.pipeline.FeatureExtractor.stack_videos_i420": "makes a padded program: the port pads nothing to buckets",
    "features.pipeline.FeatureExtractor.videos_fn": "makes a jitted program: eager PyTorch compiles none",
    "model.mlp.TorchBatchNorm": "a flax class; the port's BN is torch's, its train mode by these formulas",
    "model.train.MlpTrainer.init_variables": "flax's init; the port's is model.mlp.flax_init_",
    "models.initutil.fast_init": "flax's init without a compile; the port's is models.initutil.random_init_",
    "models.initutil.init_on_cpu": "flax's init placement; the port's is models.initutil.random_init_",
    "models.porters.load_torch_checkpoint": "renamed: utils.checkpoint.load_torch_state",
    "models.porters.port_torch_resnet50": "the port takes torchvision state dicts as they are (resnet50_from_jax "
                                          "is the reverse)",
    "models.porters.port_torch_vit": "the port takes DINO state dicts as they are (vit_from_jax is the reverse)",
    "models.vgg.port_torch_vgg16": "the port takes torchvision state dicts as they are (vgg16_from_jax is the "
                                   "reverse)",
    "model.mlp.port_torch_mlp": "a reference .pth loads as it is after model.mlp.fix_state_dict",
}


def _public_names(root: str) -> dict:
    """{module path: public names}: top-level functions, classes and
    assignments (module loggers aside), and each class's public methods and
    aliases (``name = other``; not annotated fields, which are flax's
    module attributes or dataclass fields) as ``Class.name``."""
    out = collections.defaultdict(set)

    def assigned(node):
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        return [t.id for t in targets if isinstance(t, ast.Name) and not t.id.startswith("_")]

    def is_logger(node):
        return isinstance(node.value, ast.Call) and ast.unparse(node.value.func).endswith("getLogger")

    for dirpath, _, files in os.walk(os.path.join(ROOT, root)):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            mod = os.path.relpath(path, os.path.join(ROOT, root))[:-3].replace(os.sep, ".")
            for node in ast.parse(open(path).read()).body:
                if isinstance(node, (ast.Assign, ast.AnnAssign)) and node.value is not None and not is_logger(node):
                    out[mod].update(assigned(node))
                elif isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
                    out[mod].add(node.name)
                    for sub in node.body if isinstance(node, ast.ClassDef) else ():
                        if isinstance(sub, ast.FunctionDef) and not sub.name.startswith("_"):
                            out[mod].add(f"{node.name}.{sub.name}")
                        elif isinstance(sub, ast.Assign):
                            out[mod].update(f"{node.name}.{n}" for n in assigned(sub))
    return out


def test_every_public_name_of_relaxtpu_has_a_counterpart():
    """What is left to port shows here: a name of ``relaxtpu/<path>.py``
    without the same name in ``relaxtpu_torch/<path>.py`` fails unless
    ``NOT_PORTED`` gives the reason; an entry there that the port now has
    fails too."""
    jax_names, port_names = _public_names("relaxtpu"), _public_names("relaxtpu_torch")
    missing = {f"{mod}.{n}" for mod, names in jax_names.items() for n in names
               if n not in port_names.get(mod, set())}
    assert missing - set(NOT_PORTED) == set(), sorted(missing - set(NOT_PORTED))
    assert set(NOT_PORTED) - missing == set(), sorted(set(NOT_PORTED) - missing)
