"""Predict over a whole video from files (counterpart of
floodseg_tpu/train/predict.py and the wiring of the JAX package's
``Runner.predict``, floodseg_tpu/cli/runner.py).

``run_predict`` drives a predict function over the loader's clip batches:
the key-feature cache keyed on the resolved key-frame ids, the class maps
cast to uint8 on the device and copied to the host once a window, the
temporal-consistency meter (each frame's map against the previous one,
across windows through the carried ``last_output``), palette PNGs and an
MJPG AVI. ``run_flow_predict`` builds what ``Runner.predict`` builds on one
device (the dataset, the colours, the predict builders and the loader)
without the config layer and the logger, and picks the route as it does:
the sliding window of crops by default, the cached whole-frame route with
``no_cropping``.
"""

import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from floodseg_tpu_torch.core.device import DeviceLike, resolve_device
from floodseg_tpu_torch.core.profiler import PhaseProfiler
from floodseg_tpu_torch.data.avi import MJPGWriter
from floodseg_tpu_torch.data.dataset import FlowDataset
from floodseg_tpu_torch.data.image import write_png
from floodseg_tpu_torch.data.loader import DataLoader, device_put
from floodseg_tpu_torch.data.transforms import build_test_transform
from floodseg_tpu_torch.ops.metrics import MetricMeter, intersection_and_union
from floodseg_tpu_torch.train.evaluate import flow_sliding_window_predict
from floodseg_tpu_torch.train.flow import (
    make_cached_flow_predict_fn,
    make_flow_predict_crop_fn,
    make_flow_predict_fn,
)


def colorize(class_map: np.ndarray, colors: np.ndarray) -> np.ndarray:
    """(H, W) int -> (H, W, 3) uint8 through the palette."""
    return colors[class_map]


def _sync(x: torch.Tensor) -> None:
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def _frame_id(batch, key) -> Optional[int]:
    return int(np.asarray(batch[key]).reshape(-1)[0]) if key in batch else None


def run_predict(
    predict_fn: Callable,
    variables,
    loader,
    num_classes: int,
    colors: Optional[np.ndarray] = None,
    save_images_dir: Optional[str] = None,
    video_path: Optional[str] = None,
    fps: int = 25,
    compute_metrics: bool = True,
    profiler: Optional[PhaseProfiler] = None,
    cached_fns=None,
) -> Dict:
    """Drive ``predict_fn`` over clip batches from ``loader``.

    predict_fn(variables, frame_prev, frame_next, mvs_left, mvs_right) ->
    (n, H, W) int class maps. ``cached_fns``: an optional (full_fn,
    cached_fn) pair from make_cached_flow_predict_fn, which reuses the
    previous window's next-key encoding when this window's resolved prev
    key is that frame, and encodes both keys otherwise. Returns the JAX
    package's summary: predict time, frames, frames/s and the temporal-
    consistency mIoU, mAcc, accuracy and per-class IoU.
    """
    profiler = profiler or PhaseProfiler()
    cache_feat = None
    cache_key_fid = None  # resolved frame id the cached encoding belongs to
    meter = MetricMeter(num_classes)
    last_output = None
    writer = None
    if video_path:
        os.makedirs(os.path.dirname(video_path) or ".", exist_ok=True)
        writer = MJPGWriter(video_path, fps)
    if save_images_dir:
        os.makedirs(save_images_dir, exist_ok=True)

    frames_done = 0
    try:
        for batch in loader:
            fp, fn = batch["frame_prev"], batch["frame_next"]
            ml, mr = batch["mvs_left"], batch["mvs_right"]
            pfid = _frame_id(batch, "prev_frame_id")
            nfid = _frame_id(batch, "next_frame_id")
            with profiler.profile("predict_interference"):
                if cached_fns is not None and fp.shape[0] == 1:
                    full_fn, cached_fn = cached_fns
                    if cache_feat is not None and pfid is not None and pfid == cache_key_fid:
                        out, cache_feat = cached_fn(variables, cache_feat, fn, ml, mr)
                    else:
                        out, cache_feat = full_fn(variables, fp, fn, ml, mr)
                    # the returned encoding is of the resolved next key
                    cache_key_fid = nfid
                    if nfid is None:
                        cache_feat = None
                else:
                    out = predict_fn(variables, fp, fn, ml, mr)
                out = torch.as_tensor(out)
                _sync(out)
            # uint8 on the device: a quarter of the bytes to the host
            maps = out.to(torch.uint8)
            n = maps.shape[0]
            frames_done += n

            if compute_metrics:
                prev = maps[:-1] if last_output is None else torch.cat(
                    [last_output.to(maps.device)[None], maps[:-1]])
                cur = maps[1:] if last_output is None else maps
                if len(cur):
                    counts = torch.stack([torch.stack(intersection_and_union(
                        c.to(torch.int32), p.to(torch.int32), num_classes))
                        for c, p in zip(cur, prev)]).cpu().numpy()
                    for inter, union, tgt in counts:
                        meter.update(inter, union, tgt)
                last_output = maps[n - 1]
            out_np = maps.cpu().numpy()

            # per-frame ids from each clip's own frame_id
            if "frame_id" in batch:
                fids = np.asarray(batch["frame_id"]).reshape(-1)
            else:
                fids = np.asarray([frames_done - n])
            if n % len(fids):
                raise ValueError(f"{n} maps for {len(fids)} clips")
            n_per_clip = n // len(fids)
            for p in range(n):
                fid = int(fids[p // n_per_clip]) + p % n_per_clip
                if save_images_dir is not None and colors is not None:
                    write_png(os.path.join(save_images_dir, f"{fid}.png"), out_np[p],
                              palette=colors)
                if writer is not None and colors is not None:
                    writer.append_data(colorize(out_np[p], colors))
    finally:
        if writer is not None:
            writer.close()

    summary = {
        "predict_time_mean": profiler.mean("predict_interference"),
        "predict_time_sum": profiler.sum("predict_interference"),
        "frames": frames_done,
    }
    if compute_metrics and meter.count > 0:
        s = meter.summary()
        summary.update({
            "predict_miou1_epoch": s["miou"],
            "predict_macc1_epoch": s["macc"],
            "predict_accuracy1_epoch": s["allacc"],
            "predict_miou1_epoch_classes": s["iou_class"],
        })
    if summary["predict_time_sum"] > 0:
        summary["frames_per_second"] = frames_done / summary["predict_time_sum"]
    return summary


def run_flow_predict(
    model: nn.Module,
    variables,
    data_root: str,
    predict_v_id: str,
    frame_delta: int = 25,
    resize: Tuple[int, int] = (1072, 1920),
    crop: Tuple[int, int] = (433, 433),
    no_cropping: bool = False,
    num_classes: int = 5,
    feature_based: bool = True,
    no_warp: bool = False,
    int8_decode: bool = False,
    classes_ignore=None,
    save_images_dir: Optional[str] = None,
    video_path: Optional[str] = None,
    compute_metrics: bool = True,
    workers: int = 8,
    seed: int = 0,
    profiler: Optional[PhaseProfiler] = None,
    device: DeviceLike = None,
    frame_size: Optional[Tuple[int, int]] = None,
) -> Dict:
    """Predict the video ``predict_v_id`` under ``data_root`` as the JAX
    package's ``Runner.predict`` does on one device, and return
    ``run_predict``'s summary.

    Frames are read by the predict FlowDataset, resized to ``frame_size``
    (None: ``resize``; the CLI's predict transform may size them apart
    from the maps) and left as raw pixels (``build_test_transform(normalize=False)``): the
    port's builders normalize on the device. With ``no_cropping`` every
    window runs whole through the cached builders (key-feature reuse), its
    batches copied to the device by the loader; otherwise each window runs
    as a sliding window of ``crop`` crops (make_flow_predict_crop_fn and
    flow_sliding_window_predict). Maps are resized to ``resize``. PNGs are
    written to ``save_images_dir`` and the AVI to ``video_path`` when
    given and the tree has ``list/colors.txt``. ``profiler`` records
    run_predict's "predict_interference" and, on the crop route,
    flow_sliding_window_predict's regions.
    """
    dev = resolve_device(device)
    ds = FlowDataset("predict", data_root, None, type="u",
                     transform=build_test_transform(classes_ignore, frame_size or resize,
                                                    normalize=False),
                     frame_delta=frame_delta, no_warp=no_warp, predict_v_id=predict_v_id)
    colors_path = os.path.join(data_root, "list", "colors.txt")
    colors = (np.loadtxt(colors_path).astype("uint8") if os.path.exists(colors_path)
              else None)
    common = dict(feature_based=feature_based, no_warp=no_warp,
                  default_grid=ds.default_grid, int8_decode=int8_decode, device=dev)
    cached_fns = None
    if not no_cropping:
        crop_fn = make_flow_predict_crop_fn(model, n=frame_delta, num_classes=num_classes,
                                            **common)

        def predict_fn(v, fp, fn_, ml, mr):
            batch = {"frame_prev": fp, "frame_next": fn_, "mvs_left": ml, "mvs_right": mr}
            return flow_sliding_window_predict(crop_fn, v, batch, num_classes, crop[0],
                                               crop[1], resize, profiler=profiler)

        loader = DataLoader(ds, batch_size=1, num_workers=workers, seed=seed)
    else:
        predict_fn = make_flow_predict_fn(model, n=frame_delta, out_size=resize, **common)
        cached_fns = make_cached_flow_predict_fn(model, n=frame_delta, out_size=resize,
                                                 **common)
        loader = DataLoader(ds, batch_size=1, num_workers=workers, seed=seed,
                            device_put=lambda b: device_put(b, dev))
    return run_predict(predict_fn, variables, loader, num_classes, colors=colors,
                       save_images_dir=save_images_dir, video_path=video_path,
                       compute_metrics=compute_metrics, profiler=profiler,
                       cached_fns=cached_fns)
