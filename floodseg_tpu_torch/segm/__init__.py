"""The standalone Segmenter stack (counterpart of floodseg_tpu/segm/): the
trainer (``train``), the folder and named datasets with the mmseg
pipelines (``data``, ``pipeline``, ``catalog``), sliding-window inference
and evaluation (``inference``), attention maps (``attn``) and console
metric logging (``logger``).
"""

from floodseg_tpu_torch.segm.attn import attention_maps
from floodseg_tpu_torch.segm.data import SegFolderDataset
from floodseg_tpu_torch.segm.inference import sliding_inference

__all__ = ["sliding_inference", "SegFolderDataset", "attention_maps"]
