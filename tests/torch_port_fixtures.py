"""Shared set-up for the port's parity tests (tests/test_torch_*.py).

A JAX PSPNet-50 initialised from PRNGKey(0), with every BatchNorm's scale,
bias, running mean and running variance replaced by seeded numpy values so
that no BN is the identity, carried into the port through the weight
bridge (floodseg_tpu_torch/models/convert.py).
"""

import jax
import jax.numpy as jnp
import numpy as np

from floodseg_tpu.models import build_model as jax_build_model
from floodseg_tpu_torch.models import build_model, load_jax_variables


def _perturb_bn(params, stats, rng):
    """Replace every BN's (scale, bias) and (mean, var) in place."""
    for name, sub in params.items():
        if not isinstance(sub, dict):
            continue
        if "scale" in sub and "bias" in sub:
            c = sub["scale"].shape[0]
            sub["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            sub["bias"] = rng.normal(0.0, 0.1, c).astype(np.float32)
            stats[name]["mean"] = rng.normal(0.0, 0.1, c).astype(np.float32)
            stats[name]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        else:
            _perturb_bn(sub, stats.get(name, {}), rng)


def _to_dict(tree):
    if hasattr(tree, "items"):
        return {k: _to_dict(v) for k, v in tree.items()}
    return np.asarray(tree)


def pspnet50_pair(size: int = 65, seed: int = 0, classes: int = 5):
    """(jax_model, variables as numpy dicts, port PSPNet-50 with the same
    weights), both float32 and without the aux head."""
    jm = jax_build_model("pspnet", classes=classes, layers=50, with_aux=False)
    x0 = jnp.zeros((1, size, size, 3), jnp.float32)
    variables = _to_dict(jax.device_get(jax.jit(
        lambda: jm.init({"params": jax.random.PRNGKey(0)}, x0, train=False))()))
    _perturb_bn(variables["params"], variables["batch_stats"],
                np.random.default_rng(seed))
    port = load_jax_variables(
        build_model("pspnet", classes=classes, layers=50, with_aux=False),
        variables)
    return jm, variables, port
