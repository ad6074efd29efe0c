"""The experiment runner (counterpart of floodseg_tpu/cli/runner.py::Runner):
fit, validate, test and predict for every training method, over the port's
entry points, on one device or over the ranks of the process group
(parallel/mesh.py::World, one GPU a rank; ``trainer.num_devices``: None
for every rank, n for min(n, ranks), below the ranks raises). The global
batch is ``batch_size`` times the ranks; only rank 0 writes checkpoints,
logs and predict's files.

- ``fit``: the resolved config written to the run's config.json, then the
  method's ``run_*`` (train/fit.py) with the Runner as its ``FitHooks``: an
  optional warm start from a reference checkpoint
  (``--torch_ckpt``), resume from the run's ``last`` checkpoint at the next
  epoch with the early-stopping state of ``early_stop.json``, then every
  epoch the logger's records, a checkpoint (top-k by val mIoU plus last,
  core/checkpoint.py) and ``early_stop.json``; the best validation in the
  run summary.
- ``restore_best``: the best checkpoint, for the test and predict after a
  fit; ``load_for_eval``: a checkpoint (or the run's last, or best) into a
  fresh state; ``load_torch_ckpt``: a reference Lightning checkpoint.
- ``validate`` (``run_validate``), ``test`` (``run_test``, with the
  test-image table) and ``predict`` (``run_flow_predict``: the crop route,
  or under ``no_cropping`` the cached route, or one window a rank over
  several ranks) on the served model: the
  generator for s4GAN, the U2PL teacher once synced.

The model is ``build_model`` of the config with weights drawn from a
generator seeded with ``trainer.seed`` in the JAX package's initial
distributions (``Runner.initializer``, ``init_flax_defaults_``), and a
pretrained ResNet trunk overlaid when ``model.pretrained_path`` names one.
"""

import json
import os
import uuid
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from floodseg_tpu_torch.core.checkpoint import CheckpointManager
from floodseg_tpu_torch.core.config import Config, config_to_dict, fit_config
from floodseg_tpu_torch.core.device import DeviceLike, resolve_device
from floodseg_tpu_torch.core.logging import RunLogger
from floodseg_tpu_torch.data.transforms import MEAN, STD
from floodseg_tpu_torch.models import build_model, init_flax_defaults_
from floodseg_tpu_torch.models.torch_import import convert_resnet_backbone, load_torch_file
from floodseg_tpu_torch.parallel.mesh import World, current_world, resolve_num_devices
from floodseg_tpu_torch.train.contrastive import U2PLState, served_model
from floodseg_tpu_torch.train.fit import (
    FLOW_METHODS,
    GAN_METHODS,
    METHODS,
    FitHooks,
    flow_frame_size,
    method_state,
    run_contrastive_fit,
    run_fit,
    run_flow_fit,
    run_gan_fit,
    run_test,
    run_validate,
)
from floodseg_tpu_torch.train.optim import AUX_KEYS
from floodseg_tpu_torch.train.predict import run_flow_predict

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _load_role(module: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """``load_state_dict`` of one imported role: strict, but for the
    module's aux head (``AUX_KEYS``) when ``sd`` has none of it, which
    keeps the module's own."""
    own_aux = {k for k in module.state_dict() if k.split(".")[0] in AUX_KEYS}
    if own_aux and not any(k.split(".")[0] in AUX_KEYS for k in sd):
        sd = {**{k: v for k, v in module.state_dict().items() if k in own_aux}, **sd}
    module.load_state_dict(sd, strict=True)


class Runner(FitHooks):
    # the model's initial weights: the JAX Runner's ``model.init`` distributions
    initializer = staticmethod(init_flax_defaults_)

    def __init__(self, cfg: Config, device: DeviceLike = None, world: Optional[World] = None):
        if cfg.method not in METHODS:
            raise ValueError(f"unknown method {cfg.method!r}; expected one of {METHODS}")
        self.cfg = cfg
        self.world = world if world is not None else current_world()
        self.num_devices = resolve_num_devices(cfg.trainer.num_devices, self.world)
        self.device = resolve_device(device)
        if self.world.parallel and self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.is_flow = cfg.method in FLOW_METHODS
        self.fit_cfg = fit_config(cfg, num_devices=self.num_devices)
        run_name = cfg.trainer.run_name or cfg.runid or uuid.uuid4().hex[:8]
        self.logger = RunLogger(cfg.trainer.log_dir, run_name, wandb_project=cfg.wandb,
                                tags=[cfg.tag] if cfg.tag else None, world=self.world)
        self.ckpt = CheckpointManager(os.path.join(self.logger.log_dir, "checkpoints"),
                                      save_top_k=cfg.trainer.save_top_k, world=self.world)
        self.model = self._build_model()
        self.state = None
        self.fit_summary: Optional[Dict] = None
        self._torch_ckpt: Optional[str] = None

    # ------------------------------------------------------------------
    # model and state
    # ------------------------------------------------------------------

    def _build_model(self) -> nn.Module:
        m = self.cfg.model
        model = build_model(m.arch, classes=m.classes, layers=m.layers, image_size=m.test_w,
                            with_aux=m.aux, remat=m.remat, dtype=_DTYPES[m.dtype],
                            semisupervised=self.cfg.method == "contrastive" and m.semisupervised)
        return self.initializer(model, torch.Generator().manual_seed(self.cfg.trainer.seed))

    def _pretrained_variables(self) -> Optional[Dict[str, torch.Tensor]]:
        """The trunk of ``model.pretrained_path`` (a reference ResNet
        state_dict, or a module) in the port's names, or None."""
        m = self.cfg.model
        if not m.pretrained or not m.pretrained_path:
            return None
        sd = torch.load(m.pretrained_path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        return convert_resnet_backbone(sd, m.arch, m.layers)

    def _fresh_state(self):
        """The method's state for this run's model on the device (the
        structure a checkpoint restores into)."""
        return method_state(self.model, self.fit_cfg, self.cfg.method, 1, device=self.device)

    def _int8_decode(self) -> bool:
        """``model.int8_decode``: True or False as set; None resolves to
        False, the bf16 decoder. The JAX package's None means the int8
        decoder only on a TPU backend (floodseg_tpu/ops/quant.py::
        int8_auto_default); on the card the port keeps the bf16 decoder
        until its benchmark settles an H100 rule. A forced True runs K3 on
        the int8 paths."""
        v = self.cfg.model.int8_decode
        return False if v is None else bool(v)

    def _eval_model(self, state) -> nn.Module:
        """The model evaluation serves: the generator for s4GAN, the U2PL
        teacher once synced (the student before), else the state's."""
        if isinstance(state, tuple):
            return state[0].model
        if isinstance(state, U2PLState):
            return served_model(state)
        return state.model

    # ------------------------------------------------------------------
    # fit
    # ------------------------------------------------------------------

    def fit(self, torch_ckpt: Optional[str] = None):
        """Train with the method's run_* (the Runner as its hooks) and
        return the final state; ``torch_ckpt``: a reference checkpoint to
        warm-start from (fresh optimizer; a resume of this run wins)."""
        cfg, fc = self.cfg, self.fit_cfg
        self._torch_ckpt = torch_ckpt
        self.logger.write_config(config_to_dict(cfg))
        kw = dict(pretrained=self._pretrained_variables(), device=self.device, hooks=self,
                  world=self.world)
        root = cfg.data.data_root
        if cfg.method == "supervised":
            summary = run_fit(self.model, root, fc, **kw)
        elif cfg.method == "flow_supervised":
            summary = run_flow_fit(self.model, root, fc, **kw)
        elif cfg.method in GAN_METHODS:
            summary = run_gan_fit(self.model, root, fc, method=cfg.method, **kw)
        else:
            summary = run_contrastive_fit(self.model, root, fc, **kw)
        best, best_epoch = summary["best_val_miou"], summary["best_epoch"]
        self.logger.update_summary({"best_val_miou": best, "best_epoch": best_epoch}
                                   if best is not None else {"best_epoch": best_epoch})
        self.fit_summary = summary
        self.state = summary["state"]
        return self.state

    def _es_path(self) -> str:
        return os.path.join(self.logger.log_dir, "early_stop.json")

    def start(self, state, steps_per_epoch: int):
        if self._torch_ckpt is not None:
            self._graft_torch_ckpt(state, self._torch_ckpt, eval_only=False)
        start_epoch, early_stop = 0, (-np.inf, -1, 0)
        if self.cfg.trainer.resume and self.ckpt.last_path is not None:
            state = self.ckpt.restore(state, self.ckpt.last_path)
            last_epoch = self.ckpt.last_epoch
            start_epoch = last_epoch + 1 if last_epoch is not None else 0
            print(f"resumed from {self.ckpt.last_path} at epoch {start_epoch}", flush=True)
        # the early-stopping state survives a resume: without it the first
        # validation after it would always count as an improvement
        if start_epoch > 0 and os.path.exists(self._es_path()):
            with open(self._es_path()) as f:
                es = json.load(f)
            early_stop = (-np.inf if es.get("best_metric") is None else float(es["best_metric"]),
                          int(es.get("best_epoch", -1)), int(es.get("wait_count", 0)))
        return state, start_epoch, early_stop

    def end_epoch(self, epoch, state, record, global_step, early_stop) -> None:
        self.logger.log({"train_loss_epoch": record["train_loss"],
                         "train_miou_epoch": record["train_miou"],
                         "epoch_time": record["epoch_time"], "epoch": epoch}, global_step)
        ckpt_metrics = {}
        if "val_miou" in record:
            ckpt_metrics["val_miou_epoch"] = record["val_miou"]
            self.logger.log({"val_miou_epoch": record["val_miou"],
                             "val_macc_epoch": record["val_macc"],
                             "val_accuracy_epoch": record["val_accuracy"]}, global_step)
            print(f"epoch {epoch}: loss {record['train_loss']:.4f} "
                  f"val_miou {record['val_miou']:.4f}", flush=True)
        else:
            print(f"epoch {epoch}: loss {record['train_loss']:.4f} (val every "
                  f"{max(1, self.fit_cfg.check_val_every_n_epoch)} epochs)", flush=True)
        # an epoch without validation writes only last-{epoch}
        self.ckpt.save(state, epoch, ckpt_metrics)
        best, best_epoch, wait_count = early_stop
        if "val_miou" in record and wait_count >= self.fit_cfg.early_stopping_patience:
            print(f"early stopping at epoch {epoch} (best {best:.4f} @ {best_epoch})",
                  flush=True)
        if not self.logger.writes:  # rank 0 writes
            return
        with open(self._es_path(), "w") as f:
            json.dump({"best_metric": float(best) if np.isfinite(best) else None,
                       "best_epoch": best_epoch, "wait_count": wait_count}, f)

    def restore_best(self, state):
        """The best-val checkpoint restored into ``state``, for the test and
        predict after a fit; ``state`` itself when none was written."""
        path = self.ckpt.best_path
        if path is None:
            return state
        self.state = self.ckpt.restore(state, path)
        return self.state

    # ------------------------------------------------------------------
    # evaluation states
    # ------------------------------------------------------------------

    def load_for_eval(self, ckpt_path: Optional[str] = None):
        """A fresh state with ``ckpt_path`` (or the run's last, or best
        checkpoint) restored into it; the fresh weights when there is
        none."""
        state = self._fresh_state()
        path = ckpt_path or self.ckpt.last_path or self.ckpt.best_path
        if path is None:
            print("[runner] no checkpoint found: evaluating the fresh weights")
        else:
            state = self.ckpt.restore(state, path)
        self.state = state
        return state

    def load_torch_ckpt(self, path: str):
        """A fresh state with a reference Lightning checkpoint's weights
        (all roles) loaded; a U2PL teacher in it is served."""
        state = self._fresh_state()
        self._graft_torch_ckpt(state, path, eval_only=True)
        self.state = state
        return state

    def _graft_torch_ckpt(self, state, path: str, eval_only: bool) -> None:
        """Load each role of a reference checkpoint into ``state``'s modules
        (optimizer states untouched): the model into the generator or
        student, the discriminator and the U2PL teacher where present.
        Every key must match, but the model may keep its own aux head where
        the checkpoint has none (a FlowModel's), as the JAX
        ``graft_variables`` keeps target leaves the source lacks. For
        evaluation the teacher is marked synced; a fit syncs it at the
        boundary epoch as it would otherwise."""
        imported = load_torch_file(path)
        if imported["arch"] != self.cfg.model.arch:
            raise ValueError(f"checkpoint is a {imported['arch']} model but the config says "
                             f"model.arch={self.cfg.model.arch!r}")
        fam = imported["method_family"]
        if fam.split("_")[0] not in self.cfg.method:
            print(f"[import] note: checkpoint looks like {fam!r}, config method is "
                  f"{self.cfg.method!r}; weights load anyway", flush=True)
        roles = imported["roles"]
        if isinstance(state, tuple):
            _load_role(state[0].model, roles["model"])
            if "discriminator" in roles:
                _load_role(state[1].model, roles["discriminator"])
        elif isinstance(state, U2PLState):
            _load_role(state.student.model, roles["model"])
            if "teacher" in roles:
                _load_role(state.teacher, roles["teacher"])
                state.teacher_synced = state.teacher_synced or eval_only
        else:
            _load_role(state.model, roles["model"])
        print(f"[import] loaded {fam} {imported['arch']} checkpoint (epoch "
              f"{imported.get('epoch')}) from {path}", flush=True)

    # ------------------------------------------------------------------
    # validate / test / predict
    # ------------------------------------------------------------------

    def validate(self, state=None) -> Dict:
        """One pass over the val split. For U2PL it serves the teacher when
        ``max_epochs`` reaches ``sup_only_epoch`` (the JAX Runner's
        validate passes the fit's last epoch to its eval function)."""
        state = state if state is not None else self.state
        if isinstance(state, U2PLState):
            past = self.cfg.trainer.max_epochs >= self.cfg.model.sup_only_epoch
            model = state.teacher if past else state.student.model
        else:
            model = self._eval_model(state)
        results = run_validate(model, self.cfg.data.data_root, self.fit_cfg, self.cfg.method,
                               device=self.device, world=self.world)
        if results:
            self.logger.update_summary(results)
        return results

    def _table_colors(self) -> Optional[np.ndarray]:
        path = os.path.join(self.cfg.data.data_root, "list", "colors.txt")
        if not self.cfg.trainer.log_test_images or not os.path.exists(path):
            return None
        pal = np.loadtxt(path).astype(np.uint8)
        colors = np.zeros((256, 3), np.uint8)  # ignore-index pixels render black
        colors[: len(pal)] = pal
        return colors

    def test(self, state=None) -> Dict:
        """``run_test`` on the served model, with up to ``log_test_images``
        rows of (image, colorized ground truth, colorized prediction) saved
        through the logger. Over D ranks the flow methods test each rank's
        share of the samples (rank 0: samples 0, D, 2D, ...), so the table,
        which rank 0 writes, holds other samples than a one-rank run logs;
        the single-frame methods share out each frame's crops and log the
        same rows."""
        cfg = self.cfg
        if self.fit_cfg.limit_test_batches == 0:
            return {}
        state = state if state is not None else self.state
        colors, rows = self._table_colors(), []

        def on_sample(sub, pred):
            if colors is None or len(rows) >= cfg.trainer.log_test_images:
                return
            key = "frame_current" if "frame_current" in sub else "frame_prev"
            frame = np.asarray(sub[key])[0]
            if self.is_flow:  # the flow test transform normalizes
                frame = frame * STD + MEAN
            label = np.asarray(sub["label"])[0]
            rows.append([np.clip(frame, 0, 255).astype(np.uint8),
                         colors[label.astype(np.int64)], colors[np.asarray(pred, np.int64)]])

        results = run_test(self._eval_model(state), cfg.data.data_root, self.fit_cfg,
                           cfg.method, device=self.device, on_sample=on_sample,
                           world=self.world)
        if rows:
            self.logger.log_image_table("test_outputs", ["image", "ground truth", "prediction"],
                                        rows)
        self.logger.update_summary(results)
        return results

    def predict_size(self):
        """(frame size, map size) of predict: the frames as the predict
        transform resizes them (``flow_frame_size`` at
        ``resize_factor_predict``), the maps at (resize_h, resize_w)."""
        d = self.cfg.data
        return (flow_frame_size(self.fit_cfg, d.arch, d.resize_factor_predict),
                (d.resize_h, d.resize_w))

    def predict(self, state=None) -> Dict:
        """``run_flow_predict`` of the predict video on the served model
        (flow methods; {} otherwise): the crop route by default, the cached
        route under ``no_cropping`` (the only one ``model.int8_encode``
        reaches, as in the JAX Runner); PNGs under ``<run>/frames/<video>`` and
        the AVI under ``<run>/video`` as the config asks."""
        cfg = self.cfg
        if not self.is_flow:
            return {}
        state = state if state is not None else self.state
        model = self._eval_model(state)
        m, d = cfg.model, cfg.data
        frame, out = self.predict_size()
        log_dir = self.logger.log_dir
        summary = run_flow_predict(
            model, model.state_dict(), d.data_root, d.predict_v_id, frame_delta=d.frame_delta,
            resize=out, crop=(m.test_h, m.test_w), no_cropping=m.no_cropping,
            num_classes=m.classes, feature_based=m.feature_based, no_warp=m.no_warp,
            int8_decode=self._int8_decode(), int8_encode=m.int8_encode,
            classes_ignore=d.data_classes_ignore,
            save_images_dir=(os.path.join(log_dir, "frames", d.predict_v_id)
                             if m.save_images else None),
            video_path=(os.path.join(log_dir, "video", f"{d.predict_v_id}.avi")
                        if m.save_video else None),
            compute_metrics=m.compute_metrics, workers=d.workers, seed=cfg.trainer.seed,
            device=self.device, frame_size=frame, world=self.world)
        self.logger.update_summary(summary)
        return summary
