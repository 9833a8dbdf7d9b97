"""The quantized MSV filter as a CUDA kernel (``csrc/msv_cuda.cu``).

One warp per (profile, target) pair walks the target's own residues with
the model striped across the warp in packed saturating uint8 cells; the
profile's cost table sits in shared memory.  Outputs are bit-identical to
:func:`pyhmmer_tpu.ops.batch._msv_kernel`: ``(xJ - base)`` as float32 and
the overflow flag, both ``[P, B]``.

The shared library is compiled with ``nvcc`` from the source in the
repository at first use, into ``build/`` at the root of the checkout
(listed in ``.gitignore``); ``python -m pyhmmer_tpu.ops.msv_cuda`` builds
it ahead of time.  A failed build raises: there is no silent fallback to
the scan.  The packing of cost tables and scalars below is plain NumPy and
is tested on the CPU.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np

import jax
import jax.numpy as jnp

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "csrc", "msv_cuda.cu")
BUILD_DIR = os.path.normpath(os.path.join(_HERE, "..", "..", "build"))
_LIB = os.path.join(BUILD_DIR, "libmsv_cuda.so")
_TARGET = "pyhmmer_msv_u8"

#: 32-bit words per lane the kernel is instantiated for (4 model
#: positions per word, 32 lanes per warp: 128 positions per word count)
Q_LADDER = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 32)
#: largest padded model length the kernel takes; longer models run the scan
MAX_MP = 128 * Q_LADDER[-1]

_lock = threading.Lock()
_registered = False


def words_per_lane(Mp: int) -> int:
    """Smallest instantiated word count covering ``Mp`` model positions."""
    need = -(-Mp // 128)
    for q in Q_LADDER:
        if q >= need:
            return q
    raise ValueError(f"model length {Mp} exceeds the CUDA MSV limit "
                     f"{MAX_MP}")


def pack_costs(cost: np.ndarray, Q: int) -> np.ndarray:
    """Pack uint8 costs ``[P, Kp, Mp]`` (values 0..255) into the kernel's
    ``[P, Kp, Q, 32]`` uint32 layout: lane ``l`` owns model positions
    ``4*Q*l .. 4*Q*(l+1)-1``; word ``q`` of lane ``l`` holds positions
    ``4*(Q*l + q) + j`` in byte ``j``.  Positions past ``Mp`` cost 255,
    which pins their cells to 0 like the scan's padding."""
    P, Kp, Mp = cost.shape
    width = 128 * Q
    if Mp > width:
        raise ValueError(f"Mp={Mp} does not fit {Q} words per lane")
    full = np.full((P, Kp, width), 255, dtype=np.uint8)
    full[:, :, :Mp] = cost
    # [P, Kp, lane, q, byte] -> [P, Kp, q, lane] little-endian words
    w = np.ascontiguousarray(full.reshape(P, Kp, 32, Q, 4)).view("<u4")
    return np.ascontiguousarray(w[..., 0].transpose(0, 1, 3, 2))


def unpack_costs(words: np.ndarray, Mp: int) -> np.ndarray:
    """Inverse of :func:`pack_costs` (for tests)."""
    P, Kp, Q, _ = words.shape
    b = np.ascontiguousarray(words.transpose(0, 1, 3, 2)).astype("<u4")
    return b.view(np.uint8).reshape(P, Kp, 128 * Q)[:, :, :Mp]


def profile_tensors(pb) -> dict:
    """Kernel operands for a ``ProfileBatch`` (cached on it): packed costs
    and per-profile ``(bias, tec, tbm, 0)`` int32 scalars."""
    t = pb._device_cache.get("msv_cuda")
    if t is None:
        Q = words_per_lane(pb.Mp)
        cost = pack_costs(pb.msv_cost.astype(np.uint8), Q)
        scal = np.zeros((pb.P, 4), dtype=np.int32)
        scal[:, 0] = pb.msv_bias
        scal[:, 1] = pb.msv_tec
        scal[:, 2] = pb.msv_tbm
        t = {"cost": jnp.asarray(cost), "scal": jnp.asarray(scal)}
        pb._device_cache["msv_cuda"] = t
    return t


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA MSV kernel needs the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build(force: bool = False) -> str:
    """Compile ``csrc/msv_cuda.cu`` into ``build/libmsv_cuda.so`` unless an
    up-to-date library exists.  Returns its path; raises on failure."""
    if (not force and os.path.exists(_LIB)
            and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
        return _LIB
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = _LIB + f".{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed building the CUDA MSV kernel:\n"
                           + proc.stderr[-4000:])
    os.replace(tmp, _LIB)
    return _LIB


def register() -> None:
    """Build (if needed) and register the FFI target with JAX."""
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.CDLL(build())
        jax.ffi.register_ffi_target(
            _TARGET, jax.ffi.pycapsule(lib.PyhmmerMsvU8), platform="CUDA")
        _registered = True


@jax.jit
def _msv_call(codes, lens, tjb, cost, scal):
    P, B = cost.shape[0], codes.shape[0]
    dx, ovf = jax.ffi.ffi_call(
        _TARGET,
        (jax.ShapeDtypeStruct((P, B), jnp.float32),
         jax.ShapeDtypeStruct((P, B), jnp.int32)))(
            codes, lens, tjb, cost, scal)
    return dx, ovf != 0


def msv(pb, dev):
    """CUDA MSV for one profile stack x one sequence bucket: returns
    device ``(xJ - base)`` [P, B] f32 and the overflow flag [P, B] bool."""
    register()
    t = profile_tensors(pb)
    codes, lens, tjb = dev.msv_operands()
    return _msv_call(codes, lens, tjb, t["cost"], t["scal"])


if __name__ == "__main__":
    print(build(force=True))
