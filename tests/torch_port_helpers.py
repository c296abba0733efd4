"""Shared fixtures of the PyTorch-port tests (tests/test_torch_*.py).

JAX's random init of a parameter tree dispatches op by op and is slow on
the CPU, so these tests take the tree's structure from ``jax.eval_shape``
and fill it from numpy with a fixed seed.  The filled tree is then the JAX
side's parameters, and ``metatts_torch.convert`` carries it to the port.
"""

import numpy as np
import pytest
import torch
import jax

from metatts_tpu.models.fastspeech2 import fastspeech2_init


def fill_tree(shapes, seed):
    """Tree of ShapeDtypeStructs -> same tree of numpy arrays: weights
    uniform(+-1/sqrt(fan_in)), biases and norm offsets small, norm scales
    near 1, embedding tables N(0, 1), running variances positive."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", ""))
        shape = tuple(s.shape)
        if name == "w":
            fan = shape[1] * shape[2] if len(shape) == 3 else shape[0]
            return rng.uniform(-1, 1, shape).astype(np.float32) / np.sqrt(fan)
        if name == "table":
            return rng.randn(*shape).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.randn(*shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        return (0.1 * rng.randn(*shape)).astype(np.float32)   # b, bias, mean
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def fs2_params(pcfg, mcfg, acfg, stats, n_speakers, seed=0):
    """(params, state) numpy trees of ``fastspeech2_init``'s structure; the
    pitch/energy bins are the init's own (sorted) constants."""
    shapes = jax.eval_shape(lambda k: fastspeech2_init(
        k, pcfg, mcfg, acfg, stats, n_speakers), jax.random.PRNGKey(0))
    params, state = fill_tree(shapes, seed)
    from metatts_tpu.models.variance_adaptor import _make_bins
    ve = mcfg["variance_embedding"]
    for name in ("pitch", "energy"):
        params["variance_adaptor"][f"{name}_bins"] = _make_bins(
            stats[name][0], stats[name][1], ve["n_bins"],
            ve[f"{name}_quantization"])
    return params, state


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's tensors while a module runs: the
    tests' tensors are tiny, and tier-1 runs several pytest workers on the
    same cores, where each worker's full thread pool oversubscribes them
    (a second-order meta-gradient took 57x its one-process time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
