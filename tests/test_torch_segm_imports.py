"""Every module of the port's Segmenter stack imports in a fresh
interpreter without JAX, the JAX package, cv2 or PIL: none of them lands
in ``sys.modules``."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "floodseg_tpu_torch.segm", "floodseg_tpu_torch.segm.attn", "floodseg_tpu_torch.segm.catalog",
    "floodseg_tpu_torch.segm.data", "floodseg_tpu_torch.segm.inference",
    "floodseg_tpu_torch.segm.logger", "floodseg_tpu_torch.segm.pipeline",
    "floodseg_tpu_torch.segm.train", "floodseg_tpu_torch.models.lightning_export",
    "floodseg_tpu_torch.cli.export_ckpt", "floodseg_tpu_torch.cli.prepare_seg_dataset",
    "floodseg_tpu_torch.cli.segm_accuracy", "floodseg_tpu_torch.cli.segm_inference",
    "floodseg_tpu_torch.cli.show_attn_map",
]
BANNED = ("jax", "jaxlib", "flax", "floodseg_tpu", "cv2", "PIL")


def test_new_modules_import_without_jax_cv2_or_pil():
    code = "\n".join([
        "import importlib, sys",
        f"for m in {MODULES!r}:",
        "    importlib.import_module(m)",
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {BANNED!r})",
        "print('BANNED', bad)",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BANNED []" in out.stdout, out.stdout
