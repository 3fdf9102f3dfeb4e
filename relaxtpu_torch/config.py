"""One serializable run configuration (counterpart of ``relaxtpu/config.py``).

The JAX package's sections and keys, so a JSON file that
``relaxtpu.config.RunConfig`` wrote loads here unchanged and ``--config``
gives the port's subcommands the defaults it gives the JAX CLI's.
``TrainConfig`` is the port's own, with the JAX package's field set.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from relaxtpu_torch.model.train import TrainConfig


@dataclasses.dataclass
class ExtractConfig:
    dataset: str = "konvid_1k"
    data_root: str = "."
    metadata_dir: str = "metadata"
    output_dir: str = "features_out"
    backbone_dtype: str = "bfloat16"  # 'float32' for strict-parity mode
    resnet_weights: str | None = None
    vit_weights: str | None = None
    frame_bucket: int = 8  # JAX's shape bucket: the port runs eagerly and pads nothing
    ingest: str = "auto"


@dataclasses.dataclass
class RuntimeConfig:
    # Mesh shape for extract/predict-batch: n_data * n_model > 1 shards the
    # work over a ('data', 'model') mesh of ranks (relaxtpu_torch.parallel,
    # started with torchrun); None/1 = the one-device streaming path.
    n_data: int | None = None
    n_model: int = 1
    decode_workers: int = 4
    dispatch_ahead: int = 2
    # Accepted so a JAX config file loads; no effect here: the port's
    # counterpart of the XLA compile cache is the nvcc build cache of
    # relaxtpu_torch/_native.py (build/relaxtpu_torch/).
    compilation_cache: str | None = None
    profile_dir: str | None = None


SECTIONS = {"extract": ExtractConfig, "train": TrainConfig, "runtime": RuntimeConfig}


@dataclasses.dataclass
class RunConfig:
    extract: ExtractConfig = dataclasses.field(default_factory=ExtractConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "RunConfig":
        raw: dict[str, Any] = json.loads(text)
        unknown = set(raw) - set(SECTIONS)
        if unknown:
            raise ValueError(f"unknown config sections: {sorted(unknown)} (expected extract/train/runtime)")
        # an unknown key inside a section raises TypeError from the dataclass
        return cls(**{name: section(**raw.get(name, {})) for name, section in SECTIONS.items()})

    @classmethod
    def load(cls, path: str) -> "RunConfig":
        with open(path) as f:
            return cls.from_json(f.read())

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
