"""``--config`` and ``relaxtpu_torch.config`` against the JAX package's.

The JAX CLI's config cases (``tests/test_cli_protocols.py``: defaults from
the file, explicit flags win, every subcommand fed or excluded, unknown
keys raise) run on the port's parser; and one JSON file, written by
``relaxtpu.config.RunConfig``, gives both CLIs the same defaults on every
dest that a subcommand of both has.
"""

import dataclasses
import json

import pytest

import relaxtpu.cli.__main__ as jax_cli
from relaxtpu.config import RunConfig as JaxRunConfig
from relaxtpu_torch import config as port_config
from relaxtpu_torch.cli import __main__ as cli
from relaxtpu_torch.config import RunConfig


def parse(argv, mod=cli):
    p, submap = mod.build_parser()
    mod._apply_config(argv, submap)
    return p.parse_args(argv)


HEAD = ["--model", "m.npz", "--imputer", "i.pkl", "--scaler", "s.pkl"]
PAIR = ["--train-metadata", "a.csv", "--test-metadata", "b.csv", "--train-features", "a.npy",
        "--test-features", "b.npy"]
# each subcommand of the port with the flags it requires
ARGV = {
    "predict": ["--video", "v.mp4", *HEAD],
    "predict-batch": ["--videos", "d", *HEAD],
    "serve": HEAD,
    "warmup": [],
    "extract": [],
    "metadata": ["--video-dir", "d"],
    "greyscale": [],
    "train": ["--metadata-csv", "m.csv", "--features", "f.npy"],
    "train-lsvq": PAIR,
    "finetune": ["--dataset", "konvid_1k", "--metadata-csv", "m.csv", "--features", "f.npy",
                 "--base-model", "b.npz"],
    "train-cross": PAIR,
    "visualize": ["--frame", "a.png", "--next-frame", "b.png"],
    "parity": [],
    "report": [],
}


def test_config_defaults_feed_cli(tmp_path):
    """--config values become argparse defaults; explicit flags still win."""
    cfg = RunConfig()
    cfg.extract.dataset = "live_vqc"
    cfg.extract.output_dir = str(tmp_path / "feats")
    cfg.runtime.decode_workers = 7
    cfg.train.n_repeats = 3
    cfg.train.use_bn = False
    path = str(tmp_path / "run.json")
    cfg.save(path)
    args = parse(["--config", path, "extract", "--decode-workers", "2"])
    assert args.dataset == "live_vqc" and args.output == str(tmp_path / "feats")
    assert args.decode_workers == 2
    args = parse(["--config", path, "train", *ARGV["train"]])
    assert args.n_repeats == 3 and args.no_bn is True


def test_config_defaults_feed_all_subcommands(tmp_path):
    cfg = RunConfig()
    cfg.extract.dataset = "youtube_ugc"
    cfg.extract.data_root = "/data"
    cfg.extract.ingest = "bgr"
    cfg.extract.backbone_dtype = "float32"
    cfg.runtime.decode_workers = 9
    cfg.runtime.n_data = 2
    cfg.runtime.n_model = 2
    cfg.train.epochs = 7
    cfg.train.n_repeats = 5
    cfg.train.use_bn = False
    path = str(tmp_path / "run.json")
    cfg.save(path)
    a = parse(["--config", path, "predict", *ARGV["predict"]])
    assert a.video_type == "youtube_ugc" and a.ingest == "bgr" and a.bf16 is False
    a = parse(["--config", path, "predict-batch", *ARGV["predict-batch"]])
    assert (a.decode_workers, a.n_data, a.n_model, a.ingest) == (9, 2, 2, "bgr")
    a = parse(["--config", path, "extract"])
    assert (a.n_data, a.n_model, a.root, a.bf16) == (2, 2, "/data", False)
    a = parse(["--config", path, "train-lsvq", *ARGV["train-lsvq"]])
    assert a.epochs == 7
    a = parse(["--config", path, "finetune", *ARGV["finetune"]])
    assert a.epochs == 7 and a.n_repeats == 5 and a.no_bn is True
    a = parse(["--config", path, "greyscale"])
    assert a.dataset == "youtube_ugc" and a.root == "/data"
    a = parse(["--config", path, "warmup"])
    assert a.ingest == "bgr" and a.bf16 is False
    a = parse(["--config", path, "train-cross", *ARGV["train-cross"]])
    assert a.epochs == 7 and a.no_bn is True
    a = parse(["--config", path, "serve", *HEAD])
    assert a.video_type == "youtube_ugc"


def test_config_covers_every_subcommand(tmp_path):
    """Every subparser is fed by _apply_config or in CONFIG_EXCLUDED."""
    path = str(tmp_path / "run.json")
    RunConfig().save(path)
    _, submap = cli.build_parser()

    class Spy(dict):
        seen: set

        def __getitem__(self, k):
            self.seen.add(k)
            return super().__getitem__(k)

    spy = Spy(submap)
    spy.seen = set()
    cli._apply_config(["--config", path, "extract"], spy)
    assert spy.seen | cli.CONFIG_EXCLUDED >= set(submap) and set(submap) == set(ARGV)
    assert not (spy.seen & cli.CONFIG_EXCLUDED)


def test_config_value_satisfies_a_required_flag(tmp_path):
    """A required flag that the file gives needs no value on the line (the
    JAX CLI's rule): finetune's --dataset."""
    path = str(tmp_path / "run.json")
    RunConfig().save(path)
    a = parse(["--config", path, "finetune", *ARGV["finetune"][2:]])
    assert a.dataset == "konvid_1k"
    with pytest.raises(SystemExit):
        parse(["finetune", *ARGV["finetune"][2:]])


def test_config_rejects_unknown_keys(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"extract": {}, "typo_section": {}}))
    with pytest.raises(ValueError, match="unknown config sections"):
        RunConfig.load(str(bad))
    bad.write_text(json.dumps({"extract": {"no_such_knob": 1}}))
    with pytest.raises(TypeError):
        RunConfig.load(str(bad))


def test_config_round_trips_and_matches_jax_fields(tmp_path):
    """The port's sections have JAX's keys and defaults; a JAX file loads
    and writes back unchanged."""
    jax_cfg = JaxRunConfig()
    for section in ("extract", "runtime", "train"):
        ours, theirs = getattr(RunConfig(), section), getattr(jax_cfg, section)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs), section
    jax_cfg.runtime.compilation_cache = "/tmp/cache"
    jax_cfg.train.optimizer_type = "adamw"
    path = str(tmp_path / "jax.json")
    jax_cfg.save(path)
    assert json.loads(RunConfig.load(path).to_json()) == json.loads(jax_cfg.to_json())
    assert set(port_config.SECTIONS) == {"extract", "train", "runtime"}


def _changed_jax_config() -> JaxRunConfig:
    cfg = JaxRunConfig()
    cfg.extract.dataset = "live_qualcomm"
    cfg.extract.data_root = "/data"
    cfg.extract.metadata_dir = "meta"
    cfg.extract.output_dir = "out"
    cfg.extract.backbone_dtype = "float32"
    cfg.extract.resnet_weights = "rn.pth"
    cfg.extract.vit_weights = "vit.pth"
    cfg.extract.ingest = "yuv"
    cfg.runtime.n_data = 4
    cfg.runtime.n_model = 2
    cfg.runtime.decode_workers = 3
    cfg.runtime.dispatch_ahead = 5
    cfg.runtime.profile_dir = "prof"
    cfg.train.n_repeats = 4
    cfg.train.n_splits = 6
    cfg.train.batch_size = 64
    cfg.train.epochs = 11
    cfg.train.initial_lr = 0.03
    cfg.train.weight_decay = 0.001
    cfg.train.select_criteria = "bykrcc"
    cfg.train.use_bn = False
    cfg.train.kfold = False
    return cfg


@pytest.mark.parametrize("cmd", sorted(ARGV))
def test_one_file_gives_both_clis_the_same_defaults(tmp_path, cmd):
    """A file written by the JAX package's RunConfig, every field changed:
    on each dest the JAX subcommand also has, the port's parsed value is
    the JAX CLI's (the geometry, pkl and path flags on the line are the
    same in both)."""
    path = str(tmp_path / "run.json")
    _changed_jax_config().save(path)
    argv = ["--config", path, cmd, *ARGV[cmd]]
    ours, theirs = vars(parse(argv)), vars(parse(argv, jax_cli))
    shared = (set(ours) & set(theirs)) - {"fn", "cmd", "config"}
    assert shared, cmd
    assert {k: ours[k] for k in shared} == {k: theirs[k] for k in shared}, cmd
