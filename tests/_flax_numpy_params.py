"""Random parameters in a flax model's tree, drawn with numpy, for the
port's parity tests of the PDE zoo and its scorer.

Shapes come from ``jax.eval_shape`` of the model's ``init``, which
compiles nothing: flax's eager ``init`` of a modern U-Net compiles a
truncated normal per kernel shape, tens of seconds on the CPU.
"""
import jax
import numpy as np


def random_params(jmod, x, seed=1):
    """LeCun-scaled kernels, spectral weights of unit gain per mode,
    non-trivial biases and GroupNorm scales."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            np.asarray(x))["params"]

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if name.startswith("weights"):
            return (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])
                    ).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


class NumpyInit:
    """A JAX model whose ``init`` returns :func:`random_params`' draw, so a
    JAX trainer or script given it (through a wrapped ``build_model``)
    starts from parameters a test knows without flax's eager init."""

    def __init__(self, model):
        self._model = model

    def __getattr__(self, name):
        return getattr(self._model, name)

    def init(self, rng, x):
        return {"params": random_params(self._model, x)}
