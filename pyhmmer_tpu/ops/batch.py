"""Batched JAX kernels: the XLA compute path of the filter cascade.

Design (see SURVEY.md §7): the reference's per-sequence SIMD loops
(``impl_sse/*``) become DP scans batched over ``[P, B]`` = (profiles x
target sequences) with the model dimension padded.  The sequential
dependency runs over target length L (a ``lax.scan``); all per-row work
is elementwise ``[P, B, M]`` math.  Emission scores are looked up with an
exact gather (``jnp.take``), never a matrix product, so no float32 score
is rounded by reduced-precision matrix units.  The DD prefix chain inside
a row uses an associative scan over the model dimension (log-space
``logaddexp`` for Forward, max-plus for Viterbi).

Conventions:
* sequences come packed as ``codes[B, Lmax]`` uint8 + ``lengths[B]``
  (padding = nonresidue code -> -inf match scores / max MSV cost)
* profile tensors are stacked ``[P, ...]`` and M-padded with ``NEGMASS``
* float32 on device; ``NEGMASS = -1e30`` is the -inf stand-in
"""

from __future__ import annotations

import os
import numpy as np
from typing import Mapping, Optional, Sequence

import jax
import jax.numpy as jnp

#: the persistent compile cache's fixed place inside the checkout (the
#: path is part of the cache key, so it must not move between runs)
CACHE_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "build",
    "jax_cache"))


def compile_cache_dir(environ: Mapping[str, str] = os.environ
                      ) -> Optional[str]:
    """Where this package puts JAX's persistent compile cache: nowhere
    when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX then uses that
    directory itself), else :data:`CACHE_DIR`."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CACHE_DIR


_cache = compile_cache_dir()
if _cache is not None:
    jax.config.update("jax_compilation_cache_dir", _cache)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from .quantize import quantize_msv

NEGMASS = -1e30


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# profile tensor packing
# ---------------------------------------------------------------------------

class ProfileBatch:
    """Device-ready tensors for a stack of configured profiles sharing one
    padded model length ``Mp``.  Length-dependent parts (length model,
    tjb) are supplied at call time."""

    def __init__(self, profiles: Sequence, Mp: Optional[int] = None,
                 pad_to: int = 64):
        self.profiles = list(profiles)
        P = len(self.profiles)
        Kp = self.profiles[0].alphabet.Kp
        M_max = max(p.M for p in self.profiles)
        self.Mp = Mp or round_up(M_max, pad_to)
        Mp_ = self.Mp
        self.P = P
        self.Kp = Kp
        self.M = np.array([p.M for p in self.profiles], dtype=np.int32)

        def padded(field, width, fill):
            out = np.full((P, width), fill, dtype=np.float32)
            for i, p in enumerate(self.profiles):
                v = np.maximum(getattr(p, field), NEGMASS)
                out[i, : len(v)] = v
            return out

        # transitions, source-node indexed 0..M-1, padded with NEGMASS
        self.tMM = padded("tMM", Mp_, NEGMASS)
        self.tIM = padded("tIM", Mp_, NEGMASS)
        self.tDM = padded("tDM", Mp_, NEGMASS)
        self.tMD = padded("tMD", Mp_, NEGMASS)
        # DD run costs padded with 0 so the prefix-scan cumsum stays finite
        # (padded D states are masked out of E via kmask instead)
        self.tDD = padded("tDD", Mp_, 0.0)
        for i, p in enumerate(self.profiles):
            self.tDD[i, p.M:] = 0.0
        self.tBM = padded("tBM", Mp_, NEGMASS)
        self.tMI = padded("tMI", Mp_ + 1, NEGMASS)
        self.tII = padded("tII", Mp_ + 1, NEGMASS)
        #: per-profile validity of model slots (slot s = state s+1)
        self.kmask = np.zeros((P, Mp_), dtype=bool)
        for i, p in enumerate(self.profiles):
            self.kmask[i, : p.M] = True

        # emissions [P, Kp, Mp] for k=1..Mp
        self.msc = np.full((P, Kp, Mp_), NEGMASS, dtype=np.float32)
        self.isc = np.full((P, Kp, Mp_), NEGMASS, dtype=np.float32)
        for i, p in enumerate(self.profiles):
            self.msc[i, :, : p.M] = np.maximum(p.msc[:, 1:], NEGMASS)
            self.isc[i, :, : p.M] = np.maximum(p.isc[:, 1:], NEGMASS)

        # E->J / E->C
        self.xE = np.stack([np.maximum(p.xE, NEGMASS)
                            for p in self.profiles]).astype(np.float32)

        # quantized MSV tensors
        quants = [quantize_msv(p) for p in self.profiles]
        self.msv_cost = np.full((P, Kp, Mp_), 255.0, dtype=np.float32)
        for i, q in enumerate(quants):
            self.msv_cost[i, :, : q.M] = q.cost
        self.msv_bias = np.array([q.bias_b for q in quants], dtype=np.float32)
        self.msv_tec = np.array([q.tec_b for q in quants], dtype=np.float32)
        self.msv_tbm = np.array([q.tbm_b for q in quants], dtype=np.float32)
        self.scale_b = quants[0].scale_b

        self._device_cache: dict = {}

# (continued) ProfileBatch device-cache accessor
def _pb_device(self, *names):
    out = []
    for n in names:
        if n not in self._device_cache:
            self._device_cache[n] = jnp.asarray(getattr(self, n))
        out.append(self._device_cache[n])
    return tuple(out)


ProfileBatch.device = _pb_device


# ---------------------------------------------------------------------------
# batched quantized MSV
# ---------------------------------------------------------------------------

@jax.jit
def _msv_kernel(codes, mask, cost, bias_b, tec_b, tbm_b, tjb_b):
    """codes [B, Lmax] int32, mask [B, Lmax] f32 (1=valid);
    cost [P, Kp, Mp]; bias/tec/tbm [P]; tjb [B].
    Returns (xJ - base) [P, B] f32 and overflow [P, B] bool."""
    P, _, Mp = cost.shape
    B, Lmax = codes.shape
    base = jnp.float32(190.0)
    bias = bias_b[:, None]            # [P, 1]
    tec = tec_b[:, None]
    tbm = tbm_b[:, None]
    tjb = tjb_b[None, :]              # [1, B]

    def step(carry, xs):
        mpv, xJ, xB, ovf = carry
        x, valid = xs                 # [B], [B]
        c = jnp.take(cost, x, axis=1, mode="clip")              # [P,B,Mp]
        xBv = jnp.maximum(xB - tbm, 0.0)                        # [P,B]
        sv = jnp.concatenate(
            [xBv[:, :, None],
             jnp.maximum(mpv[:, :, :-1], xBv[:, :, None])], axis=2)
        sv = jnp.minimum(sv + bias[:, :, None], 255.0)
        sv = jnp.maximum(sv - c, 0.0)
        xE = sv.max(axis=2)                                     # [P,B]
        n_ovf = ovf | (valid[None, :] & (xE >= 255.0 - bias))
        n_xJ = jnp.maximum(xJ, xE - tec)
        n_xB = jnp.maximum(base, n_xJ) - tjb
        vm = valid[None, :]
        xJ = jnp.where(vm, n_xJ, xJ)
        xB = jnp.where(vm, n_xB, xB)
        mpv = jnp.where(vm[:, :, None], sv, mpv)
        return (mpv, xJ, xB, n_ovf), None

    mpv0 = jnp.zeros((P, B, Mp), jnp.float32)
    xJ0 = jnp.zeros((P, B), jnp.float32)
    xB0 = jnp.broadcast_to(jnp.maximum(base - tjb, 0.0), (P, B))
    ovf0 = jnp.zeros((P, B), bool)
    (mpv, xJ, xB, ovf), _ = jax.lax.scan(
        step, (mpv0, xJ0, xB0, ovf0),
        (codes.T, mask.T.astype(bool)))
    return xJ - base, ovf


class SeqDevice:
    """Device-resident packed sequences for one bucket, uploaded once and
    shared by every profile chunk searched against it."""

    def __init__(self, codes: np.ndarray, lengths: np.ndarray):
        self.B, self.Lmax = codes.shape
        self.lengths = lengths
        L = np.maximum(lengths.astype(np.float64), 1.0)
        mask = (np.arange(self.Lmax)[None, :] < lengths[:, None])
        self._codes_host = codes
        self.codes = jnp.asarray(codes, jnp.int32)
        self.mask_f = jnp.asarray(mask, jnp.float32)
        self.mask_b = jnp.asarray(mask, bool)
        pmove = 3.0 / (L + 3.0)
        self.loop = jnp.asarray(np.log(1.0 - pmove), jnp.float32)
        self.move = jnp.asarray(np.log(pmove), jnp.float32)
        # host-side per-lane constants shared by every profile chunk
        # that gates against this bucket
        self.nullsc_host = (L * np.log(L / (L + 1.0))
                            + np.log(1.0 / (L + 1.0)))
        from .quantize import tjb_units
        self.tjbu_host = tjb_units(np.maximum(lengths, 1))
        self.tjb = jnp.asarray(self.tjbu_host, jnp.float32)
        self._msv_operands = None

    def msv_operands(self):
        """``(codes uint8 [B, Lmax], lengths int32 [B], tjb int32 [B])``
        for the CUDA MSV kernel (uploaded on first use)."""
        if self._msv_operands is None:
            self._msv_operands = (
                jnp.asarray(self._codes_host, jnp.uint8),
                jnp.asarray(self.lengths, jnp.int32),
                jnp.asarray(self.tjbu_host, jnp.int32))
        return self._msv_operands


def msv_scores(pb: ProfileBatch, codes: np.ndarray, lengths: np.ndarray,
               dev: "SeqDevice" = None):
    """Quantized MSV scores in nats for every (profile, sequence) pair,
    through the MSV kernel :func:`ops.kernels.msv` picks for the device.

    Returns ``usc[P, B]`` float64 (inf where the uint8 DP overflowed,
    i.e. certainly passing)."""
    from . import kernels
    dev = dev or SeqDevice(codes, lengths)
    dx, ovf = kernels.msv(pb, dev)
    usc = ((np.asarray(dx, np.float64) - dev.tjbu_host[None, :])
           / pb.scale_b - 3.0)
    usc[np.asarray(ovf)] = np.inf
    return usc


# ---------------------------------------------------------------------------
# batched Viterbi (float semantics)
# ---------------------------------------------------------------------------

@jax.jit
def _viterbi_kernel(codes, mask, msc, isc, tMM, tIM, tDM, tMD, tDD, tBM,
                    tMI, tII, kmask, xEj, xEc, loop, move):
    """Batched multihit local Viterbi.  Returns score [P, B] in nats.
    Slot convention: slot s <-> model state k = s+1; transition arrays are
    source-node indexed (t[j] = node j -> state j+1)."""
    P, _, Mp = msc.shape
    B, Lmax = codes.shape
    negcol = jnp.full((P, B, 1), NEGMASS, jnp.float32)
    # cdd[s] = sum tDD[1..s] = DD-run cost reaching state s+1 from state 1
    cdd = jnp.concatenate(
        [jnp.zeros((P, 1), jnp.float32),
         jnp.cumsum(tDD[:, 1:], axis=1)], axis=1)        # [P, Mp]
    # a-term transition: tMD[t+1] (node t+1 -> D_{t+2})
    tMD_sh = jnp.concatenate(
        [tMD[:, 1:], jnp.full((P, 1), NEGMASS, jnp.float32)], axis=1)
    kmaskf = jnp.where(kmask, 0.0, NEGMASS)[:, None, :]  # [P,1,Mp]

    def shift(row):
        return jnp.concatenate([negcol, row[:, :, :-1]], axis=2)

    def step(carry, xs):
        mrow, irow, drow, xN, xB, xJ, xC = carry
        x, valid = xs
        ms = jnp.take(msc, x, axis=1, mode="clip")              # [P,B,Mp]
        iscr = jnp.take(isc, x, axis=1, mode="clip")
        new_m = ms + jnp.maximum(
            jnp.maximum(shift(mrow) + tMM[:, None, :],
                        shift(irow) + tIM[:, None, :]),
            jnp.maximum(shift(drow) + tDM[:, None, :],
                        xB[:, :, None] + tBM[:, None, :]))
        new_i = iscr + jnp.maximum(mrow + tMI[:, None, 1: Mp + 1],
                                   irow + tII[:, None, 1: Mp + 1])
        # a[t] = m(state t+1) + tMD[t+1] - cdd_state[t+2]
        a = new_m + tMD_sh[:, None, :] - jnp.concatenate(
            [cdd[:, 1:], cdd[:, -1:]], axis=1)[:, None, :]
        acc = jax.lax.cummax(a, axis=2)
        new_d = jnp.concatenate(
            [negcol, acc[:, :, :-1] + cdd[:, None, 1:]], axis=2)
        new_d = jnp.maximum(new_d + kmaskf, NEGMASS)
        xE = jnp.maximum(new_m.max(axis=2), new_d.max(axis=2))
        n_xJ = jnp.maximum(xJ + loop[None, :], xE + xEj)
        n_xC = jnp.maximum(xC + loop[None, :], xE + xEc)
        n_xN = xN + loop[None, :]
        n_xB = jnp.maximum(n_xN + move[None, :], n_xJ + move[None, :])
        vm = valid[None, :]
        vm3 = vm[:, :, None]
        return (jnp.where(vm3, new_m, mrow), jnp.where(vm3, new_i, irow),
                jnp.where(vm3, new_d, drow), jnp.where(vm, n_xN, xN),
                jnp.where(vm, n_xB, xB), jnp.where(vm, n_xJ, xJ),
                jnp.where(vm, n_xC, xC)), None

    neg = jnp.full((P, B, Mp), NEGMASS, jnp.float32)
    xN0 = jnp.zeros((P, B), jnp.float32)
    xB0 = jnp.broadcast_to(move[None, :], (P, B))
    negs = jnp.full((P, B), NEGMASS, jnp.float32)
    (m, i_, d, xN, xB, xJ, xC), _ = jax.lax.scan(
        step, (neg, neg, neg, xN0, xB0, negs, negs),
        (codes.T, mask.T))
    return xC + move[None, :]


def viterbi_scores(pb: ProfileBatch, codes: np.ndarray,
                   lengths: np.ndarray,
                   dev: "SeqDevice" = None) -> np.ndarray:
    """Viterbi scores in nats for all (profile, sequence) pairs [P, B]."""
    dev = dev or SeqDevice(codes, lengths)
    xEj = np.float32(np.log(0.5))
    out = _viterbi_kernel(
        dev.codes, dev.mask_b,
        *pb.device("msc", "isc", "tMM", "tIM", "tDM", "tMD", "tDD", "tBM",
                   "tMI", "tII", "kmask"),
        xEj, xEj, dev.loop, dev.move)
    return np.asarray(out, np.float64)


# ---------------------------------------------------------------------------
# batched Forward (score only)
# ---------------------------------------------------------------------------

def _lse(a, b):
    return jnp.logaddexp(a, b)


@jax.jit
def _forward_kernel(codes, mask, msc, isc, tMM, tIM, tDM, tMD, tDD, tBM,
                    tMI, tII, kmask, xEj, xEc, loop, move):
    """Batched multihit local Forward; returns score [P, B] nats."""
    P, _, Mp = msc.shape
    B, Lmax = codes.shape
    negcol = jnp.full((P, B, 1), NEGMASS, jnp.float32)
    cdd = jnp.concatenate(
        [jnp.zeros((P, 1), jnp.float32),
         jnp.cumsum(tDD[:, 1:], axis=1)], axis=1)
    tMD_sh = jnp.concatenate(
        [tMD[:, 1:], jnp.full((P, 1), NEGMASS, jnp.float32)], axis=1)
    cdd_sh = jnp.concatenate([cdd[:, 1:], cdd[:, -1:]], axis=1)
    kmaskf = jnp.where(kmask, 0.0, NEGMASS)[:, None, :]

    def shift(row):
        return jnp.concatenate([negcol, row[:, :, :-1]], axis=2)

    def step(carry, xs):
        mrow, irow, drow, xN, xB, xJ, xC = carry
        x, valid = xs
        ms = jnp.take(msc, x, axis=1, mode="clip")              # [P,B,Mp]
        iscr = jnp.take(isc, x, axis=1, mode="clip")
        new_m = ms + _lse(
            _lse(shift(mrow) + tMM[:, None, :],
                 shift(irow) + tIM[:, None, :]),
            _lse(shift(drow) + tDM[:, None, :],
                 xB[:, :, None] + tBM[:, None, :]))
        new_i = iscr + _lse(mrow + tMI[:, None, 1: Mp + 1],
                            irow + tII[:, None, 1: Mp + 1])
        a = new_m + tMD_sh[:, None, :] - cdd_sh[:, None, :]
        acc = jax.lax.associative_scan(jnp.logaddexp, a, axis=2)
        new_d = jnp.concatenate(
            [negcol, acc[:, :, :-1] + cdd[:, None, 1:]], axis=2)
        new_d = jnp.maximum(new_d + kmaskf, NEGMASS)
        xE = _lse(jax.nn.logsumexp(new_m, axis=2),
                  jax.nn.logsumexp(new_d, axis=2))
        n_xJ = _lse(xJ + loop[None, :], xE + xEj)
        n_xC = _lse(xC + loop[None, :], xE + xEc)
        n_xN = xN + loop[None, :]
        n_xB = _lse(n_xN + move[None, :], n_xJ + move[None, :])
        vm = valid[None, :]
        vm3 = vm[:, :, None]
        return (jnp.where(vm3, new_m, mrow), jnp.where(vm3, new_i, irow),
                jnp.where(vm3, new_d, drow), jnp.where(vm, n_xN, xN),
                jnp.where(vm, n_xB, xB), jnp.where(vm, n_xJ, xJ),
                jnp.where(vm, n_xC, xC)), None

    neg = jnp.full((P, B, Mp), NEGMASS, jnp.float32)
    xN0 = jnp.zeros((P, B), jnp.float32)
    xB0 = jnp.broadcast_to(move[None, :], (P, B))
    negs = jnp.full((P, B), NEGMASS, jnp.float32)
    (m, i_, d, xN, xB, xJ, xC), _ = jax.lax.scan(
        step, (neg, neg, neg, xN0, xB0, negs, negs),
        (codes.T, mask.T))
    return xC + move[None, :]


def forward_scores(pb: ProfileBatch, codes: np.ndarray,
                   lengths: np.ndarray,
                   dev: "SeqDevice" = None) -> np.ndarray:
    """Forward scores in nats for all (profile, sequence) pairs [P, B]."""
    dev = dev or SeqDevice(codes, lengths)
    xEj = np.float32(np.log(0.5))
    out = _forward_kernel(
        dev.codes, dev.mask_b,
        *pb.device("msc", "isc", "tMM", "tIM", "tDM", "tMD", "tDD", "tBM",
                   "tMI", "tII", "kmask"),
        xEj, xEj, dev.loop, dev.move)
    return np.asarray(out, np.float64)
