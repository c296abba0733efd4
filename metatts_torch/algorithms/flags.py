"""cuDNN's settings for the systems' fp32 products and repeatable steps.

* ``fp32_products``: a model computing in float32 turns off TF32 for
  cuDNN's convolutions in the process, once, when its system is built.
* ``step_flags`` / ``repeatable``: every step that differentiates the
  model (``Adaptor.adapt``, the meta, baseline and iMAML steps) runs with
  cuDNN's deterministic algorithms and, for float32 compute, without
  cuDNN, the process's settings restored afterwards.
"""

import contextlib
import functools

import torch


def _fp32(model_cfg):
    return model_cfg.get("compute_dtype", "float32") == "float32"


def fp32_products(model_cfg, device):
    """fp32 compute means fp32 products, as in the JAX package: at
    PyTorch's default flags cuDNN runs fp32 convolutions in TF32, whose
    rounding the second-order meta-gradient amplifies."""
    if device.type == "cuda" and _fp32(model_cfg):
        torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def step_flags(model_cfg):
    """cuDNN's settings for one training or adaptation step of a model with
    config ``model_cfg``, restored afterwards, so that the step repeats
    itself bit for bit on the card: the JAX package's step does, and a
    comparison between two runs or two commits needs it.

    * ``deterministic``: at PyTorch's default cuDNN picks convolution
      algorithms that add with atomics.  On an NVIDIA H100 80GB HBM3 at
      700.00 W two calls of the fp32 meta step at the EER experiment's
      config differed by 1.1e-6 (rel L2); run twice on the same inputs,
      25-26 of its first episode's 425 forward and 80-82 of its 220
      backward convolutions gave other bits.
    * Off for fp32 compute: cuDNN's fp32 algorithms, deterministic ones
      included, round otherwise than a plain sum of products.  On that card
      the first meta step's gradient at the EER config lands 6.253e-4 from
      the CPU's with cuDNN's deterministic algorithms and 7.283e-5 with
      PyTorch's own CUDA convolutions, everything else alike, against a
      bound of 1e-4; the CPU's thread count alone moves it 1.895e-5.

    Narrower than ``torch.use_deterministic_algorithms``, which would also
    need ``CUBLAS_WORKSPACE_CONFIG`` set before the first cuBLAS call: the
    port's steps have no other op without a deterministic formulation (the
    length regulator and the embeddings are products).  Outside a step the
    process's settings are as they were."""
    cudnn = torch.backends.cudnn
    saved = cudnn.enabled, cudnn.deterministic
    cudnn.deterministic = True
    if _fp32(model_cfg):
        cudnn.enabled = False
    try:
        yield
    finally:
        cudnn.enabled, cudnn.deterministic = saved


def repeatable(method):
    """A method of an object with a model config ``mcfg`` run under
    ``step_flags`` (looked up at each call)."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with step_flags(self.mcfg):
            return method(self, *args, **kwargs)
    return run
