"""Which kernel runs each device stage: the one place that decides.

The choice depends only on what the code can observe: the platform of
the device the arrays live on and the padded model length.

* MSV (stage 1, every profile x target pair): on ``gpu`` the CUDA kernel
  (:mod:`.msv_cuda`) for models up to :data:`.msv_cuda.MAX_MP`, the XLA
  scan (:func:`.batch._msv_kernel`) beyond it and on every other
  platform.
* Forward and Viterbi (stages 2 and 3, bias and Forward survivors only,
  a few per cent of pairs): the XLA scans everywhere.
* nhmmer's batched subwindow gates run on the device only on ``gpu``;
  elsewhere the native host cascade is faster than the XLA scans.
"""

from __future__ import annotations

import jax

from . import msv_cuda

__all__ = ["msv_kernel_name", "msv", "platform_of", "use_device_gates"]


def platform_of(device=None) -> str:
    """Platform (``"gpu"``, ``"cpu"``, ...) of ``device``, or of JAX's
    default device inside the current ``jax.default_device`` scope."""
    if device is None:
        device = jax.config.jax_default_device
    if device is None:
        return jax.default_backend()
    if isinstance(device, str):
        return device
    return device.platform


def msv_kernel_name(platform: str, Mp: int) -> str:
    """``"cuda"`` or ``"scan"`` for an MSV call at padded length ``Mp``."""
    if platform == "gpu" and Mp <= msv_cuda.MAX_MP:
        return "cuda"
    return "scan"


def msv(pb, dev, platform: str = None):
    """Stage-1 MSV of a profile stack against a bucket: device arrays
    ``(xJ - base)`` [P, B] f32 and overflow [P, B] bool."""
    if msv_kernel_name(platform or platform_of(), pb.Mp) == "cuda":
        return msv_cuda.msv(pb, dev)
    from .batch import _msv_kernel
    return _msv_kernel(
        dev.codes, dev.mask_f,
        *pb.device("msv_cost", "msv_bias", "msv_tec", "msv_tbm"), dev.tjb)


def use_device_gates(platform: str) -> bool:
    """Whether nhmmer gates its subwindow batches on the device."""
    return platform == "gpu"
