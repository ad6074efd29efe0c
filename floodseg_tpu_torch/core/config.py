"""Layered dataclass config (counterpart of floodseg_tpu/core/config.py).

The JAX package's config surface, kept as the port's own copy:

- layered YAML configs, later files win (``--config train_base.yaml
  --config train_<method>.yaml --config dataset_flow.yaml --config
  pspnet.yaml``), read by the port's own YAML reader (core/yaml_subset.py;
  the port does not depend on PyYAML), which resolves scalars as
  ``yaml.safe_load`` does;
- dot-path CLI overrides (``--model.arch vit``, ``--data.batch_size=4``),
  whose values go through the same reader when the field is not a string;
- the links ``apply_links`` makes (square crops rounded for the
  architecture, test size = train size, the flags shared by model and
  data).

The seven dataclasses have the JAX package's fields and defaults.
``fit_config`` maps a resolved ``Config`` onto ``FitConfig``, the settings
the port's ``run_*`` entry points take (train/fit.py), through ``FIELDS``.
The layered YAML of configs/ is the one source of the port's settings:
``FitConfig`` has no defaults of its own, and ``default_fit_config`` is
``fit_config`` of the flow_supervised PSPNet-50 layering (train_base +
train_flow_supervised + dataset_flow + pspnet, ``DEFAULT_LAYERING``).

``FIELDS`` says, for every field of the seven dataclasses, what in the
port reads it; ``NOT_READ``, the fields the port does not read (with the
ROADMAP item that would port them), is empty: every field is read.

Quirks copied from the JAX package (ROADMAP, queue 3): a CLI override
resolves as YAML 1.1 does, so ``--model.optim.lr 1e-4`` sets the *string*
"1e-4" (YAML 1.1 floats need a dot: write ``1.0e-4``); a field that holds
a string takes the override as it is (``--data.data_variant ~`` is "~");
a whole sub-config given as a mapping replaces the dataclass by a dict; a
YAML int in a float field (``unsupervised_drop_percent: 80``) stays an
int.
"""

import copy
import dataclasses
import functools
import os
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from floodseg_tpu_torch.core import yaml_subset


def round_train(x: int, arch: str) -> int:
    """The crop size an architecture takes: 8k + 1 for the CNNs, a
    multiple of 32 (the patch) for the ViT."""
    if arch == "vit":
        return x // 32 * 32
    return (x - 1) // 8 * 8 + 1


@dataclass
class OptimConfig:
    optim: str = "SGD"
    lr: float = 1e-4
    lr_D: float = 1e-4          # the s4GAN discriminator's
    momentum: float = 0.9
    weight_decay: float = 1e-4


@dataclass
class LossConfig:
    loss: str = "ohem"           # "ohem" | "cross_entropy"
    thresh: float = 0.7
    min_kept: int = 100000


@dataclass
class ContrastiveCfg:
    enabled: bool = True
    negative_high_entropy: bool = True
    low_rank: int = 3
    high_rank: int = 20
    current_class_threshold: float = 0.3
    current_class_negative_threshold: float = 1.0
    low_entropy_threshold: float = 20.0
    num_negatives: int = 50
    num_queries: int = 256
    temperature: float = 0.5
    loss_weight: float = 1.0
    max_enqueue: int = 1024
    bank_capacity: int = 30000
    bank_class0_capacity: int = 50000
    # False: the teacher's parameters alias the student's after the
    # boundary sync (the reference's de facto behaviour); True: a real EMA
    true_ema: bool = False


@dataclass
class ModelConfig:
    arch: str = "pspnet"
    classes: int = 5
    layers: int = 101
    test_h: int = 873
    test_w: int = 873
    ignore_index: int = 255
    test_scales: List[float] = field(default_factory=lambda: [1.0])
    test_base_size: int = 2048   # long side at scale 1.0
    power: float = 0.9
    aux: bool = True
    aux_weight: float = 0.4
    pretrained: bool = True
    pretrained_path: Optional[str] = None
    semisupervised: bool = False
    # flow
    feature_based: bool = True
    no_warp: bool = False
    no_cropping: bool = False
    no_interpolation_percentage: float = 0.0
    # the int8 decoder on predict; None: the port's rule on the card is
    # False, the bf16 decoder (cli/runner.py::Runner._int8_decode)
    int8_decode: Optional[bool] = None
    int8_encode: bool = False
    predict_v_id: str = "florida-01"
    save_images: bool = False
    save_video: bool = True
    compute_metrics: bool = True
    # s4GAN
    threshold_st: float = 0.6
    lambda_fm: float = 0.1
    lambda_st: float = 1.0
    # U2PL
    sup_only_epoch: int = 2
    unsupervised_apply_aug: str = "cutmix"
    unsupervised_drop_percent: float = 80.0
    unsupervised_loss_weight: float = 1.0
    ema_decay: float = 0.99
    # numerics
    remat: bool = False
    dtype: str = "float32"       # "float32" | "bfloat16"
    optim: OptimConfig = field(default_factory=OptimConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    contrastive: ContrastiveCfg = field(default_factory=ContrastiveCfg)


@dataclass
class DataConfig:
    data_root: str = "dataset/flow/"
    data_variant: Optional[str] = "all"
    data_classes_ignore: List[int] = field(default_factory=list)
    batch_size: int = 2
    batch_size_val: int = 1
    batch_size_test: int = 1
    train_h: int = 873
    train_w: int = 873
    workers: int = 8
    workers_test: int = 8
    normalize_on_device: bool = False
    ignore_index: int = 255
    semisupervised: bool = False
    data_ratio: float = 1.0
    scale_min: float = 0.5
    scale_max: float = 2.0
    resize_h: int = 1072
    resize_w: int = 1920
    no_cropping: bool = False
    no_warp: bool = False
    predict_v_id: str = "florida-01"
    # flow
    frame_delta: int = 25
    resize_factor: float = 1.0
    resize_factor_test: float = 1.0
    resize_factor_predict: float = 1.0
    no_random_frame_delta: bool = False
    arch: str = "pspnet"


@dataclass
class TrainerConfig:
    max_epochs: int = 100
    seed: int = 42
    log_dir: str = "logs"
    run_name: Optional[str] = None
    check_val_every_n_epoch: int = 1
    early_stopping_patience: int = 10
    early_stopping_min_delta: float = 1e-3
    save_top_k: int = 5
    # rows of (image, colorized gt, prediction) saved at test time
    log_test_images: int = 0
    limit_train_batches: Optional[int] = None
    limit_val_batches: Optional[int] = None
    limit_test_batches: Optional[int] = None
    num_devices: Optional[int] = None   # None: every rank of the world
    debug_nans: bool = False            # torch.autograd.set_detect_anomaly
    resume: bool = True                 # resume from the run's last checkpoint


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    method: str = "supervised"   # supervised|gan|contrastive|flow_supervised|flow_gan
    ckpt_path: Optional[str] = None
    wandb: Optional[str] = None
    runid: Optional[str] = None
    tag: Optional[str] = None


def _update_dataclass(obj, values: Dict[str, Any]):
    for k, v in values.items():
        if not hasattr(obj, k):
            raise KeyError(f"unknown config key {k!r} on {type(obj).__name__}")
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _update_dataclass(cur, v)
        else:
            setattr(obj, k, v)


def _set_dotted(obj, path: str, value: Any):
    parts = path.split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    leaf = parts[-1]
    if not hasattr(obj, leaf):
        raise KeyError(f"unknown config key {path!r}")
    cur = getattr(obj, leaf)
    if isinstance(value, str):
        if cur is not None and not isinstance(cur, str):
            value = yaml_subset.load(value)
        elif cur is None and _field_wants_yaml(type(obj), leaf):
            # Optional[int/float/bool] fields default to None: coerce by the
            # annotation, not the (absent) current value
            value = yaml_subset.load(value)
    setattr(obj, leaf, value)


def _field_wants_yaml(cls, name: str) -> bool:
    t = typing.get_type_hints(cls).get(name)
    if t is None:
        return False
    args = [a for a in typing.get_args(t) if a is not type(None)]
    return (all(a is not str for a in args)) if args else (t is not str)


def load_config(config_files: List[str], overrides: Optional[Dict[str, Any]] = None) -> Config:
    """Layer YAML files (later wins), apply dot-path overrides, derive links."""
    cfg = Config()
    for path in config_files:
        with open(path) as f:
            raw = yaml_subset.load(f.read()) or {}
        _update_dataclass(cfg, raw)
    for k, v in (overrides or {}).items():
        _set_dotted(cfg, k, v)
    return apply_links(cfg)


def apply_links(cfg: Config) -> Config:
    """Square crops rounded for the architecture, test size = train size,
    the flags shared by model and data."""
    cfg.data.arch = cfg.model.arch
    cfg.data.train_h = round_train(cfg.data.train_w, cfg.model.arch)
    cfg.data.train_w = round_train(cfg.data.train_w, cfg.model.arch)
    cfg.model.test_h = cfg.data.train_h
    cfg.model.test_w = cfg.data.train_w
    cfg.data.semisupervised = cfg.model.semisupervised
    cfg.data.no_warp = cfg.model.no_warp
    cfg.data.no_cropping = cfg.model.no_cropping
    # predict_v_id: whichever side differs from the default wins, the model
    # side checked first
    default_vid = ModelConfig().predict_v_id
    if cfg.model.predict_v_id != default_vid:
        cfg.data.predict_v_id = cfg.model.predict_v_id
    elif cfg.data.predict_v_id != default_vid:
        cfg.model.predict_v_id = cfg.data.predict_v_id
    cfg.data.ignore_index = cfg.model.ignore_index
    return cfg


def parse_cli_overrides(argv: List[str]) -> Dict[str, Any]:
    """``--model.arch vit`` / ``--model.arch=vit`` style pairs."""
    out: Dict[str, Any] = {}
    i = 0
    while i < len(argv):
        a = argv[i]
        if not a.startswith("--"):
            raise SystemExit(f"unexpected argument {a!r}")
        a = a[2:]
        if "=" in a:
            k, v = a.split("=", 1)
            out[k] = v
            i += 1
        else:
            if i + 1 >= len(argv):
                raise SystemExit(f"missing value for --{a}")
            out[a] = argv[i + 1]
            i += 2
    return out


def config_to_dict(cfg) -> Dict:
    return dataclasses.asdict(cfg)


# What in the port reads each field. "fit": a FitConfig field, through
# fit_config; "runner" / "main": cli/runner.py::Runner or cli/main.py;
# "linked": set by apply_links from the field named, which is read.
_RUNNER = "runner"
FIELDS: Dict[str, str] = {
    "model.optim.optim": "fit:optimizer", "model.optim.lr": "fit:lr",
    "model.optim.lr_D": "fit:lr_D", "model.optim.momentum": "fit:momentum",
    "model.optim.weight_decay": "fit:weight_decay",
    "model.loss.loss": "fit:loss", "model.loss.thresh": "fit:ohem_thresh",
    "model.loss.min_kept": "fit:ohem_min_kept",
    **{f"model.contrastive.{f}": f"fit:contrastive.{f}" for f in (
        "enabled", "negative_high_entropy", "low_rank", "high_rank",
        "current_class_threshold", "current_class_negative_threshold",
        "low_entropy_threshold", "num_negatives", "num_queries", "temperature",
        "loss_weight", "max_enqueue")},
    "model.contrastive.bank_capacity": "fit:bank_capacity",
    "model.contrastive.bank_class0_capacity": "fit:bank_class0_capacity",
    "model.contrastive.true_ema": "fit:true_ema",
    "model.arch": _RUNNER, "model.classes": "fit:classes", "model.layers": _RUNNER,
    "model.test_h": "fit:test_h", "model.test_w": "fit:test_w",
    "model.ignore_index": "fit:ignore_index", "model.test_scales": "fit:test_scales",
    "model.test_base_size": "fit:test_base_size", "model.power": "fit:power",
    "model.aux": "fit:aux_weight", "model.aux_weight": "fit:aux_weight",
    "model.pretrained": _RUNNER, "model.pretrained_path": _RUNNER,
    "model.semisupervised": _RUNNER, "model.feature_based": "fit:feature_based",
    "model.no_warp": "fit:no_warp", "model.no_cropping": "fit:no_cropping",
    "model.no_interpolation_percentage": "fit:no_interpolation_percentage",
    "model.int8_decode": _RUNNER, "model.int8_encode": _RUNNER, "model.remat": _RUNNER,
    "model.predict_v_id": "linked:data.predict_v_id",
    "model.save_images": _RUNNER, "model.save_video": _RUNNER,
    "model.compute_metrics": _RUNNER, "model.threshold_st": "fit:threshold_st",
    "model.lambda_fm": "fit:lambda_fm", "model.lambda_st": "fit:lambda_st",
    "model.sup_only_epoch": "fit:sup_only_epoch",
    "model.unsupervised_apply_aug": "fit:unsupervised_apply_aug",
    "model.unsupervised_drop_percent": "fit:unsupervised_drop_percent",
    "model.unsupervised_loss_weight": "fit:unsupervised_loss_weight",
    "model.ema_decay": "fit:ema_decay", "model.dtype": _RUNNER,
    "data.data_root": _RUNNER, "data.data_variant": "fit:data_variant",
    "data.data_classes_ignore": "fit:classes_ignore", "data.batch_size": "fit:batch_size",
    "data.batch_size_val": "fit:batch_size_val", "data.batch_size_test": "fit:batch_size_test",
    "data.train_h": "fit:train_h", "data.train_w": "fit:train_w", "data.workers": "fit:workers",
    "data.workers_test": "fit:workers_test", "data.ignore_index": "linked:model.ignore_index",
    "data.semisupervised": "linked:model.semisupervised", "data.data_ratio": "fit:data_ratio",
    "data.scale_min": "fit:scale_min", "data.scale_max": "fit:scale_max",
    "data.resize_h": "fit:resize_h", "data.resize_w": "fit:resize_w",
    "data.no_cropping": "linked:model.no_cropping", "data.no_warp": "linked:model.no_warp",
    "data.predict_v_id": _RUNNER, "data.frame_delta": "fit:frame_delta",
    "data.resize_factor": "fit:resize_factor",
    "data.resize_factor_test": "fit:resize_factor_test",
    "data.resize_factor_predict": _RUNNER,
    "data.no_random_frame_delta": "fit:no_random_frame_delta",
    "data.normalize_on_device": "fit:normalize_on_device",
    "data.arch": "linked:model.arch",
    "trainer.max_epochs": "fit:max_epochs", "trainer.seed": "fit:seed",
    "trainer.log_dir": _RUNNER, "trainer.run_name": _RUNNER,
    "trainer.check_val_every_n_epoch": "fit:check_val_every_n_epoch",
    "trainer.early_stopping_patience": "fit:early_stopping_patience",
    "trainer.early_stopping_min_delta": "fit:early_stopping_min_delta",
    "trainer.save_top_k": _RUNNER, "trainer.log_test_images": _RUNNER,
    "trainer.limit_train_batches": "fit:limit_train_batches",
    "trainer.limit_val_batches": "fit:limit_val_batches",
    "trainer.limit_test_batches": "fit:limit_test_batches",
    "trainer.debug_nans": "main", "trainer.resume": _RUNNER, "trainer.num_devices": _RUNNER,
    "method": _RUNNER, "ckpt_path": _RUNNER, "wandb": _RUNNER, "runid": _RUNNER,
    "tag": _RUNNER,
}

# Not read by the port: field -> (ROADMAP item, what the port accepts). Empty.
NOT_READ: Dict[str, tuple] = {}


def get_dotted(cfg, path: str) -> Any:
    for p in path.split("."):
        cfg = getattr(cfg, p)
    return cfg


def fit_config(cfg: Config, num_devices: int = 1):
    """The ``FitConfig`` (train/fit.py) of a resolved ``Config`` (the port's
    or the JAX package's): each of its fields from the config field that
    ``FIELDS`` maps to it ("fit:"), with the optimizer's name lower case,
    ``aux_weight`` 0 without the aux head, lists as tuples, and the
    "contrastive." fields a ``ContrastiveConfig`` whose loss is divided by
    ``num_devices`` (the ranks of the run)."""
    from floodseg_tpu_torch.train.contrastive import ContrastiveConfig
    from floodseg_tpu_torch.train.fit import FitConfig

    values: Dict[str, Any] = {}
    contrastive: Dict[str, Any] = {}
    for path, reader in FIELDS.items():
        if reader.startswith("fit:"):
            value = get_dotted(cfg, path)
            name = reader[len("fit:"):]
            if name.startswith("contrastive."):
                contrastive[name[len("contrastive."):]] = value
            else:
                values[name] = tuple(value) if isinstance(value, list) else value
    values["optimizer"] = values["optimizer"].lower()
    values["aux_weight"] = cfg.model.aux_weight if cfg.model.aux else 0.0
    values["contrastive"] = ContrastiveConfig(**contrastive, num_devices=num_devices)
    return FitConfig(**values)


CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs")
DEFAULT_LAYERING = ("train_base.yaml", "train_flow_supervised.yaml", "dataset_flow.yaml",
                    "pspnet.yaml")


@functools.lru_cache(maxsize=None)
def _default_fit():
    return fit_config(load_config([os.path.join(CONFIG_DIR, n) for n in DEFAULT_LAYERING]))


def default_fit_config(**overrides):
    """``fit_config`` of the repository's flow_supervised PSPNet-50 layering
    (configs/, ``DEFAULT_LAYERING``), the settings a ``run_*`` call takes
    when given none, with ``overrides`` (FitConfig fields) on top. Its test
    crop is None, so that it follows the train crop as ``apply_links``
    links them when an override sets the train crop."""
    base = copy.deepcopy(_default_fit())
    return dataclasses.replace(base, **{"test_h": None, "test_w": None, **overrides})
