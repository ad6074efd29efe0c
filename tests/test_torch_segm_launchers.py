"""The Segmenter stack's launchers (floodseg_tpu_torch/cli/segm_accuracy.py,
segm_inference.py, show_attn_map.py, prepare_seg_dataset.py and
export_ckpt.py) against the scripts that drive the JAX package
(scripts/*.py), on the CPU, with the same weights on both sides: the JAX
script's ``restore_variables`` returns variables drawn in its init's
shapes, and the port's launcher reads the weight bridge's state_dict of
them from a file. show_attn_map builds a full-width Segmenter on both
sides; it runs here with a narrow one (d = 64, one layer each side),
patched in on both sides.

- segm_accuracy: the same printed top-1 / top-k accuracy over an
  ImageFolder tree (a ViT/16 classifier at 32 px);
- segm_inference: every written image equal to the script's (PNG and
  quality-75 JPEG, decoded), and the printed mean IoU / accuracy lines
  equal (``--ann-dir``, ``--reduce-zero-label``);
- show_attn_map: every per-head PNG equal, encoder and decoder, patch and
  class queries;
- prepare_seg_dataset: ADE20K linked through and Cityscapes' labelIds
  converted to the same trainIds and the same layout;
- export_ckpt: a checkpoint of the port's CLI exported as
  ``export_lightning_checkpoint`` exports its state, and imported back.
"""

import functools
import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import floodseg_tpu.core.checkpoint as jckpt
import floodseg_tpu.models.vit as jvit

import floodseg_tpu_torch.models.vit as pvit
from floodseg_tpu_torch.cli import export_ckpt, prepare_seg_dataset, segm_accuracy
from floodseg_tpu_torch.cli import segm_inference, show_attn_map
from floodseg_tpu_torch.cli.runner import Runner
from floodseg_tpu_torch.core.config import load_config
from floodseg_tpu_torch.data.image import imread, write_jpeg, write_png
from floodseg_tpu_torch.models import SegmenterViT, from_jax_variables, init_from_generator_
from floodseg_tpu_torch.models.lightning_export import export_lightning_checkpoint
from floodseg_tpu_torch.models.torch_import import load_torch_file

from torch_port_fixtures import numpy_leaves, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                      f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _draw(module, x, seed):
    shapes = jax.eval_shape(lambda: module.init({"params": jax.random.PRNGKey(0)}, x,
                                                train=False))
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        numpy_leaves(dict(shapes), np.random.default_rng(seed)))


def _weights(monkeypatch, tmp_path, variables):
    """JAX's restore_variables returns ``variables``; the port's file of
    the same weights."""
    monkeypatch.setattr(jckpt, "restore_variables", lambda path, target: variables)
    path = str(tmp_path / "weights.pt")
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in from_jax_variables(variables).items()}, path)
    return path


def _images(root, names, rng, hw=((52, 70), (64, 48), (45, 60))):
    os.makedirs(root, exist_ok=True)
    for name, (h, w) in zip(names, hw):
        im = rng.integers(0, 256, (h, w, 3), np.uint8)
        (write_png if name.endswith(".png") else write_jpeg)(os.path.join(root, name), im)


def test_segm_accuracy_matches_the_script(tmp_path, monkeypatch, capsys, one_torch_thread):  # noqa: F811
    rng = np.random.default_rng(0)
    for c in ("apple", "boat"):
        _images(str(tmp_path / "cls" / c), ["a.jpg", "b.png", "c.jpg"], rng)
    cfg = dict(n_cls=5, image_size=32, patch_size=16, d_model=64, n_layers=1)
    v = _draw(jvit.ViTClassifier(**cfg), jnp.zeros((1, 32, 32, 3)), 1)
    path = _weights(monkeypatch, tmp_path, v)
    argv = ["--data-dir", str(tmp_path / "cls"), "--n-cls", "5", "--image-size", "32",
            "--patch-size", "16", "--d-model", "64", "--n-layers", "1", "-bs", "4", "-nw", "2"]
    assert _script("segm_accuracy").main(argv + ["--ckpt", "x"]) == 0
    ref = re.findall(r"accuracy: .*", capsys.readouterr().out)
    assert segm_accuracy.main(argv + ["--ckpt", path, "--device", "cpu"]) == 0
    ours = re.findall(r"accuracy: .*", capsys.readouterr().out)
    assert ours == ref and ref[0].endswith("(6 images)")


def test_segm_inference_matches_the_script(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(2)
    names = ["a.jpg", "b.png", "c.jpg"]
    _images(str(tmp_path / "in"), names, rng)
    os.makedirs(tmp_path / "ann")
    for name, (h, w) in zip(names[:2], ((52, 70), (64, 48))):
        lab = np.kron(rng.integers(0, 6, (4, 4)), np.ones((h // 4 + 1, w // 4 + 1)))[:h, :w]
        write_png(str(tmp_path / "ann" / (name[:-4] + ".png")), lab.astype(np.uint8))
    cfg = dict(classes=5, image_size=64, patch_size=32, d_model=64, n_layers=1, dec_layers=1)
    v = _draw(jvit.SegmenterViT(**cfg), jnp.zeros((1, 64, 64, 3)), 3)
    path = _weights(monkeypatch, tmp_path, v)
    argv = ["-i", str(tmp_path / "in"), "--n-cls", "5", "--image-size", "48",
            "--window-size", "64", "--window-stride", "32", "--d-model", "64", "--n-layers",
            "1", "--dec-layers", "1", "--ann-dir", str(tmp_path / "ann"),
            "--reduce-zero-label"]
    assert _script("segm_inference").main(argv + ["--ckpt", "x", "-o",
                                                  str(tmp_path / "ref")]) == 0
    ref = capsys.readouterr().out
    assert segm_inference.main(argv + ["--ckpt", path, "-o", str(tmp_path / "ours"),
                                       "--device", "cpu"]) == 0
    ours = capsys.readouterr().out
    assert ours.splitlines()[-3:] == ref.splitlines()[-3:] and "mean_iou" in ours
    for name in names:
        a = np.asarray(Image.open(tmp_path / "ours" / name))
        np.testing.assert_array_equal(a, np.asarray(Image.open(tmp_path / "ref" / name)))


@pytest.mark.parametrize("flags", [[], ["--cls"], ["--dec", "--cls"], ["--dec", "--layer-id",
                                                                          "0", "--x-patch",
                                                                          "1"]],
                         ids=["enc_patch", "enc_cls", "dec_cls", "dec_patch"])
def test_show_attn_map_matches_the_script(tmp_path, monkeypatch, capsys, flags):
    narrow = dict(d_model=64, n_layers=2, dec_layers=1)
    monkeypatch.setattr(jvit, "SegmenterViT", functools.partial(jvit.SegmenterViT, **narrow))
    monkeypatch.setattr(pvit, "SegmenterViT", functools.partial(pvit.SegmenterViT, **narrow))
    rng = np.random.default_rng(4)
    _images(str(tmp_path), ["im.jpg"], rng)
    v = _draw(jvit.SegmenterViT(classes=3, image_size=64, patch_size=32),
              jnp.zeros((1, 64, 64, 3)), 5)
    path = _weights(monkeypatch, tmp_path, v)
    argv = ["--n-cls", "3", "--image-size", "70", "--patch-size", "32"] + flags
    assert _script("show_attn_map").main(["x", str(tmp_path / "im.jpg"),
                                          str(tmp_path / "ref")] + argv) == 0
    assert show_attn_map.main([path, str(tmp_path / "im.jpg"), str(tmp_path / "ours"),
                               "--device", "cpu"] + argv) == 0
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "ours")) and names
    for name in names:
        np.testing.assert_array_equal(imread(str(tmp_path / "ours" / name)),
                                      np.asarray(Image.open(tmp_path / "ref" / name)), name)


def test_prepare_seg_dataset_matches_the_script(tmp_path, capsys):
    rng = np.random.default_rng(6)
    ade = tmp_path / "ade"
    for split in ("training", "validation"):
        _images(str(ade / "images" / split), ["x1.jpg", "x2.jpg"], rng)
        os.makedirs(ade / "annotations" / split)
        write_png(str(ade / "annotations" / split / "x1.png"), np.zeros((4, 4), np.uint8))
    cs = tmp_path / "cs"
    for split in ("train", "val"):
        for city in ("aaa", "bbb"):
            _images(str(cs / "leftImg8bit" / split / city), [f"{city}_0_leftImg8bit.png"], rng)
            os.makedirs(cs / "gtFine" / split / city)
            write_png(str(cs / "gtFine" / split / city / f"{city}_0_gtFine_labelIds.png"),
                      rng.integers(0, 40, (52, 70)).astype(np.uint8))
    script = _script("prepare_seg_dataset")
    for name, src in (("ade20k", ade), ("cityscapes", cs)):
        assert script.main([name, str(src), str(tmp_path / f"ref_{name}")]) == 0
        assert prepare_seg_dataset.main([name, str(src), str(tmp_path / f"ours_{name}")]) == 0
        ref_root, our_root = tmp_path / f"ref_{name}", tmp_path / f"ours_{name}"
        ref = sorted(os.path.relpath(os.path.join(d, f), ref_root)
                     for d, _, fs in os.walk(ref_root) for f in fs)
        ours = sorted(os.path.relpath(os.path.join(d, f), our_root)
                      for d, _, fs in os.walk(our_root) for f in fs)
        assert ours == ref and ref
        for f in ref:
            np.testing.assert_array_equal(imread(str(our_root / f)),
                                          np.asarray(Image.open(ref_root / f)), f)
    out = capsys.readouterr().out
    assert out.count("ade20k: 2 pairs") == 2 and out.count("cityscapes: 4 pairs") == 2


def test_export_ckpt_writes_the_runs_checkpoint(tmp_path, monkeypatch, capsys):
    vit = dict(image_size=64, patch_size=32, d_model=64, n_layers=1, dec_layers=1, n_heads=2)

    def build(self):
        return init_from_generator_(SegmenterViT(classes=5, **vit).eval(),
                                    torch.Generator().manual_seed(7))

    monkeypatch.setattr(Runner, "_build_model", build)
    sets = ["method=supervised", "model.arch=vit", "data.train_w=64",
            f"trainer.log_dir={tmp_path}", "trainer.run_name=exp", "model.pretrained=false"]
    runner = Runner(load_config([], {k: v for k, v in (s.split("=") for s in sets)}),
                    device="cpu")
    state = runner._fresh_state()
    runner.ckpt.save(state, 3, {})
    out = str(tmp_path / "exported.ckpt")
    argv = [a for s in sets for a in ("--set", s)] + ["--out", out, "--epoch", "3",
                                                      "--device", "cpu"]
    assert export_ckpt.main(argv) == 0
    assert "supervised/vit Lightning layout" in capsys.readouterr().out
    got = torch.load(out, weights_only=False)
    want = export_lightning_checkpoint("vit", {"model": state.model.state_dict()},
                                       "supervised", epoch=3)
    assert got["epoch"] == 3 and got["state_dict"].keys() == want["state_dict"].keys()
    for k, v in want["state_dict"].items():
        assert torch.equal(got["state_dict"][k], v), k
    back = load_torch_file(out)
    assert (back["arch"], back["method_family"]) == ("vit", "supervised")
    for k, v in state.model.state_dict().items():
        assert torch.equal(back["roles"]["model"][k], v), k
