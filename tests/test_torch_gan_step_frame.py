"""The s4GAN single-frame ``gan`` train step (floodseg_tpu_torch/train/gan.py)
against the JAX package's ``make_gan_train_step`` (with
``single_frame_g_forward`` and ``gt_norm_by_labeled_max``), jitted under
``jax.enable_x64``, on the CPU: two steps from one initial state, then the
single-frame eval step, on the narrow Segmenter ViT generator of
tests/test_torch_train_vit.py at 64 px and a discriminator at ndf 64, both
float64. Every dropout takes flax's mask for its call: the step key splits
into r_l, r_u, r_d1..r_d4; the generator applies the whole model with r_l
(r_u), D draws with r_d1..r_d4. Set-up, ``threshold_st`` and tolerances:
tests/torch_gan_fixtures.py; the ``flow_gan`` step and ``run_gan_fit``:
tests/test_torch_gan_step.py. Split from that file so that the two JAX
compiles run on two workers.
"""

import pytest

from torch_gan_fixtures import (  # noqa: F401 (the tests run on this file's trajectory)
    test_gan_eval_counts_match_jax,
    test_gan_step_losses_match_jax,
    test_gan_step_updates_match_jax,
    trajectory_of,
)


@pytest.fixture(scope="module")
def trajectory():
    return trajectory_of("gan")
