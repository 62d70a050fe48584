"""Random parameters in a flax model's tree, drawn with numpy, for the
port's parity tests (the PDE zoo and its scorer, and the JAX trainers that
the slices' training tests replay).

Shapes come from ``jax.eval_shape`` of the model's ``init``, which
compiles nothing: flax's eager ``init`` of a modern U-Net compiles a
truncated normal per kernel shape, tens of seconds on the CPU.
"""
import jax
import numpy as np


def random_params(jmod, *inputs, seed=1):
    """LeCun-scaled kernels, spectral weights of unit gain per mode,
    non-trivial biases and GroupNorm scales, in the tree that
    ``jmod.init(rng, *inputs)`` makes."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            *map(np.asarray, inputs))["params"]

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

    def init(self, rng, *inputs):
        return {"params": random_params(self._model, *inputs)}


class GivenInit(NumpyInit):
    """A JAX model whose ``init(rng, *inputs)`` is ``init``, for instance
    flax's own init compiled once with ``jax.jit`` (the eager ``init``
    compiles an initializer per kernel shape, tens of seconds on the CPU);
    its variables come as numpy copies, which a JAX trainer that donates
    its state cannot delete."""

    def __init__(self, model, init):
        super().__init__(model)
        self._init = init

    def init(self, rng, *inputs):
        return jax.tree_util.tree_map(np.array, self._init(rng, *inputs))
