"""The batched search engine: device filter cascade + host domain machinery.

This is the batched replacement for the reference's thread-parallel
search loops (``hmmer/_base.py`` dispatchers + per-target ``p7_Pipeline``
calls): instead of one comparison at a time per CPU thread, the engine
runs the filter cascade for *stacks of profiles x buckets of sequences* in
single device kernels (`pyhmmer_tpu.ops.batch`), compacts survivors on the
host, and hands the rare Forward survivors to the exact float64 domain
postprocessing (`plan7.domaindef`) so the reported numbers are identical
to the sequential oracle pipeline.

Enqueues are asynchronous and a device->host fetch blocks, so the cascade
is organized into *stages*: every (profile chunk x sequence bucket) kernel
for a stage is enqueued back-to-back, the stage's outputs are concatenated
on device, and one fetch brings the whole stage back.  Survivor gathers
between stages happen on device (indexed by a small uploaded row vector),
never by re-uploading sequence data.  Which kernel runs each stage is
decided in :mod:`pyhmmer_tpu.ops.kernels`.
"""

from __future__ import annotations

import math
import os
import numpy as np
from typing import Iterable, List, Optional, Sequence

import jax.numpy as jnp

from .easel.alphabet import Alphabet
from .easel.sequence import DigitalSequence, DigitalSequenceBlock
from .plan7.hmm import HMM
from .plan7.background import Background
from .plan7.profile import Profile
from .plan7.pipeline import (Pipeline, F2_SKIP_SLACK, F3_SLACK, LOG2,
                             MAX_TARGET_LENGTH)
from .plan7.evalues import gumbel_surv, exp_surv
from .plan7.results import TopHits
from .ops import reference as refops
from .ops import batch as B

__all__ = ["SearchEngine"]

#: max profiles stacked per kernel call: each (chunk, bucket) pair is one
#: kernel execution, so wider chunks divide the fixed per-launch cost;
#: 64 keeps compile shapes bounded (P is padded to a multiple of 8)
DEFAULT_P_MAX = int(os.environ.get("PYHMMER_TPU_P_MAX", "64"))
#: target area (B * Lmax) per sequence bucket
DEFAULT_BUCKET_AREA = 1 << 18

#: speculative host-routing threshold: bias survivors with quantized-MSV
#: P-value at or below this skip the device Forward prefilter and go
#: straight to the host domaindef pool (see the routing loop)
SPECULATE_P1B = float(os.environ.get("PYHMMER_TPU_SPEC_P1B", "1e-6"))


class _Buckets:
    """Length-bucketed packing of a target block.

    One bucket per ladder level (Lmax = 512 * 4^k), so each stage runs one
    kernel per (chunk, level) and the stage-2 survivors of a whole level
    share one Forward call.  A bucket's code matrix is only as wide as its
    longest target rounded up to a power of two (the scans run over every
    column).  Lane counts are padded up a power-of-two ladder so kernel
    shapes (and thus XLA compilations) are bounded across databases; the
    per-level lane cap bounds device codes memory for very long levels.
    """

    def __init__(self, block: DigitalSequenceBlock, area: int = DEFAULT_BUCKET_AREA):
        lengths = np.array([len(s) for s in block], dtype=np.int64)
        fill = block.alphabet.nonresidue_code
        self.buckets = []   # (indices[B], codes[B, Lmax], lengths[B], dev)
        L0 = int(os.environ.get("PYHMMER_TPU_L0", "512"))
        if L0 == 512:
            ladder = [512, 2048, 8192, 131072]
        else:
            ladder = sorted({L0, 4096, 16384, 131072})
        for li, Lmax in enumerate(ladder):
            lo = 0 if li == 0 else ladder[li - 1]
            sel = np.where((lengths > lo if li else lengths >= 1)
                           & (lengths <= Lmax))[0]
            if len(sel) == 0:
                continue
            # length-sorted lanes: neighbouring warps of the CUDA MSV
            # kernel then walk similar lengths
            sel = sel[np.argsort(lengths[sel], kind="stable")]
            # lane cap bounds the bucket's HBM codes footprint; one
            # launch per chunk matters more than per-bucket area, so
            # the cap is generous (a 4096-wide x 4096-long bucket is
            # ~67 MB of int32 codes)
            Bcap = max(64, (1 << 24) // Lmax)
            for s0 in range(0, len(sel), Bcap):
                idx = sel[s0: s0 + Bcap]
                Bp = _pad_b(len(idx))
                Lw = min(Lmax, max(ladder[0], 1 << int(
                    lengths[idx].max() - 1).bit_length()))
                codes = np.full((Bp, Lw), fill, dtype=np.uint8)
                blens = np.zeros(Bp, dtype=np.int64)
                for r, s in enumerate(idx):
                    seq = block[int(s)].sequence
                    codes[r, : len(seq)] = seq
                    blens[r] = len(seq)
                self.buckets.append(
                    [idx.astype(np.int64), codes, blens, None])


def _pad_b(n: int) -> int:
    """Pad a batch size up a small ladder to bound compilation count."""
    for b in (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096):
        if n <= b:
            return b
    return B.round_up(n, 4096)


def _fetch_all(parts: List) -> List[np.ndarray]:
    """Fetch many device arrays in a single device->host transfer (one
    blocking synchronization instead of one per array)."""
    if not parts:
        return []
    if len(parts) == 1:
        return [np.asarray(parts[0])]
    flats = [p.ravel() for p in parts]
    buf = np.asarray(jnp.concatenate(flats))
    out, off = [], 0
    for p in parts:
        n = int(np.prod(p.shape))
        out.append(buf[off: off + n].reshape(p.shape))
        off += n
    return out


import jax as _jax

from .ops import kernels as _kernels


@_jax.jit
def _gather_rows_dev_impl(dev_codes, dev_mask, dev_loop, dev_move, ridx):
    """Device-side gather of survivor rows from a bucket (-1 = padding).
    Returns (codes, mask, loop, move) device arrays."""
    valid = ridx >= 0
    r = jnp.maximum(ridx, 0)
    codes = jnp.take(dev_codes, r, axis=0)
    mask = jnp.take(dev_mask, r, axis=0) & valid[:, None]
    loop = jnp.take(dev_loop, r)
    move = jnp.take(dev_move, r)
    return codes, mask, loop, move


def _gather_rows_dev(dev: "B.SeqDevice", ridx_dev):
    return _gather_rows_dev_impl(dev.codes, dev.mask_b, dev.loop,
                                 dev.move, ridx_dev)


class _ChunkState:
    """Per-chunk (stack of <= p_max same-Mp profiles) search state.

    The expensive model-side artifacts (configured profiles, the
    device-resident ``ProfileBatch`` with its quantized/odds tensors,
    native C-ABI tensor caches) are memoized on the engine keyed by the
    query HMM identities, so repeated searches over the same queries --
    the serving pattern -- pay only for pipelines and TopHits."""

    def __init__(self, engine: "SearchEngine", queries, chunk, Mp):
        bg = engine.background
        self.chunk = chunk

        # keyed by object identity; the cached value holds references to
        # the exact HMM objects, so a key can never alias a freed id --
        # the identity check below turns any violation into a rebuild
        # instead of a stale-tensor search
        key = (tuple(id(queries[qi]) for qi in chunk), Mp)
        cached = engine._model_cache.get(key)
        if cached is not None and any(
                h is not queries[qi] for h, qi in zip(cached[0], chunk)):
            cached = None
        if cached is None:
            profs, profs_uni = [], []
            for qi in chunk:
                hmm = queries[qi]
                profs.append(Profile(hmm.M, hmm.alphabet).configure(
                    hmm, bg, 400, multihit=True))
                profs_uni.append(Profile(hmm.M, hmm.alphabet).configure(
                    hmm, bg, 400, multihit=False))
            # pad the profile stack to a multiple of 8 so kernel P-shapes
            # are shared across chunks without pow2 blowup (padded
            # profiles are wasted work).  Tiny groups (long-tail Pfam
            # models) pad to 4 instead: at 3 real profiles the jump to 8
            # wastes more device time than the extra compile shape costs
            n_ch = len(chunk)
            Ppad = 4 if n_ch <= 4 else ((n_ch + 7) // 8) * 8
            profs_padded = profs + [profs[0]] * (Ppad - len(chunk))
            pb = B.ProfileBatch(profs_padded, Mp=Mp)
            ev = np.stack([p.evparam.astype(np.float64) for p in profs])
            from .ops import native as _native
            for p in profs:
                _native.prewarm(p)
            cached = (list(queries[qi] for qi in chunk),  # keep refs alive
                      profs, profs_uni, pb, ev)
            engine._model_cache[key] = cached
        _, self.profs, self.profs_uni, self.pb, self.ev = cached

        self.pipelines = []
        for pi, qi in enumerate(chunk):
            hmm = queries[qi]
            pli = Pipeline(engine.alphabet, bg.copy(), **engine.options)
            pli.nmodels = 1
            pli.nnodes = hmm.M
            pli.background.set_filter(hmm.M, self.profs[pi].compo)
            if pli.bit_cutoffs_mode is not None:
                idx = {"gathering": 0, "trusted": 2,
                       "noise": 4}[pli.bit_cutoffs_mode]
                c = hmm.cutoffs
                if c[idx] <= -99998.0:
                    raise ValueError(
                        f"model {hmm.name!r} has no "
                        f"{pli.bit_cutoffs_mode} cutoffs")
                pli.bit_cutoffs = (float(c[idx]), float(c[idx + 1]))
            self.pipelines.append(pli)

        self.Preal = len(chunk)
        self.F1 = np.array([pli.F1 for pli in self.pipelines])[:, None]
        self.F2 = np.array([pli.F2 for pli in self.pipelines])[:, None]
        self.F3 = np.array([pli.F3 for pli in self.pipelines])[:, None]
        # threshold form of the dense gates: P(delta/LOG2) <= F
        # <=> delta >= LOG2 * invsurv(F) -- a compare instead of a
        # dense double-transcendental gumbel_surv per (pair).  Monotone-
        # exact up to float rounding at the (measure-zero) boundary.
        from .plan7.evalues import gumbel_invsurv
        ev = self.ev
        self.thr1 = (LOG2 * gumbel_invsurv(
            self.F1[:, 0], ev[:, 0], ev[:, 1]))[:, None]

        self.tophits = []
        for pi, qi in enumerate(chunk):
            th = TopHits()
            th.query_name = self.profs[pi].name
            th.query_accession = self.profs[pi].accession
            th.query_length = self.profs[pi].M
            self.tophits.append(th)


class SearchEngine:
    """Batched hmmsearch over many queries and one target block."""

    def __init__(self, alphabet: Alphabet, background: Optional[Background] = None,
                 p_max: int = DEFAULT_P_MAX, device=None,
                 shared_executor=None, **pipeline_options):
        self.alphabet = alphabet
        self.background = background or Background(alphabet)
        self.p_max = p_max
        #: optional jax.Device this engine's buffers/kernels are pinned
        #: to -- the data-parallel shard placement used by
        #: ``parallel.mesh.sharded_search`` (one engine per device; the
        #: async dispatch overlaps execution across chips)
        self.device = device
        #: optional caller-owned ThreadPoolExecutor for the native
        #: postprocessing jobs.  When several engines run concurrently on
        #: one host (``parallel.mesh.sharded_search``) they must share
        #: one core-count pool -- per-engine pools would oversubscribe
        #: the host and measurably inflate every native phase.
        self.shared_executor = shared_executor
        self.options = pipeline_options
        # persistent across searches: configured-model artifacts keyed by
        # query identity, packed target buckets keyed by block identity
        self._model_cache: dict = {}
        self._buckets_cache: Optional[tuple] = None
        #: kernel that ran each device stage in the last search
        #: (MSV: a sorted list of the kernel names used across chunks)
        self.last_kernels: dict = {}

    # -- device-side stage kernels (return device arrays, no fetch) --------

    def _msv_dev(self, pb, dev):
        """Stage-1 device arrays ``(xJ - base, overflow)`` [P, B] f32."""
        platform = _kernels.platform_of(self.device)
        self.last_kernels.setdefault("msv", set()).add(
            _kernels.msv_kernel_name(platform, pb.Mp))
        dx, ovf = _kernels.msv(pb, dev, platform)
        return dx, ovf.astype(jnp.float32)

    def _bias_host(self, st, pi, codes, lengths, cols):
        """Bias-filter log scores (no null term) for one profile over the
        selected survivor rows of a bucket -- exact f64 on the host (the
        reference runs the bias filter only on MSV survivors, ~2% of
        targets, so this is off the device critical path entirely)."""
        from .ops import native as _native
        e1 = st.pipelines[pi].background.filter_odds_table()
        out = _native.bias_filter_rows(e1, codes, lengths, cols)
        if out is None:                      # no native library: per-seq
            bgf = st.pipelines[pi].background
            out = np.empty(len(cols))
            for j, b in enumerate(cols):
                Lb = int(lengths[b])
                dsq = codes[b, :Lb]
                p1 = Lb / (Lb + 1.0)
                out[j] = (bgf.filter_score(dsq)
                          - Lb * np.log(p1) - np.log(1.0 - p1))
        return out

    def _forward_dev(self, pb, dev, ridx_dev):
        """Forward scores [P, Bp] for the gathered survivor rows
        ``ridx_dev`` (a device int32 row, -1 padded, uploaded once per
        job by the caller)."""
        from .ops.batch import _forward_kernel
        codes, mask, loop, move = _gather_rows_dev(dev, ridx_dev)
        xEj = np.float32(np.log(0.5))
        return _forward_kernel(
            codes, mask,
            *pb.device("msc", "isc", "tMM", "tIM", "tDM", "tMD", "tDD",
                       "tBM", "tMI", "tII", "kmask"),
            xEj, xEj, loop, move)

    def _viterbi_dev(self, pb, dev, ridx_dev):
        from .ops.batch import _viterbi_kernel
        codes, mask, loop, move = _gather_rows_dev(dev, ridx_dev)
        xEj = np.float32(np.log(0.5))
        return _viterbi_kernel(
            codes, mask,
            *pb.device("msc", "isc", "tMM", "tIM", "tDM", "tMD", "tDD",
                       "tBM", "tMI", "tII", "kmask"),
            xEj, xEj, loop, move)

    # -- driver -------------------------------------------------------------

    def search(self, queries: Sequence[HMM], targets: DigitalSequenceBlock,
               callback=None) -> List[TopHits]:
        """Run hmmsearch for every query HMM; returns one TopHits each,
        in input order, identical to the sequential pipeline's output."""
        if self.device is not None:
            with _jax.default_device(self.device):
                return self._search_impl(queries, targets, callback)
        return self._search_impl(queries, targets, callback)

    def _search_impl(self, queries: Sequence[HMM],
                     targets: DigitalSequenceBlock,
                     callback=None) -> List[TopHits]:
        queries = list(queries)
        bkey = (id(targets), len(targets))
        if self._buckets_cache is not None and self._buckets_cache[0] == bkey:
            buckets = self._buckets_cache[2]
        else:
            buckets = _Buckets(targets)
            # hold a reference to the block so id() stays unique
            self._buckets_cache = (bkey, targets, buckets)
        results: List[Optional[TopHits]] = [None] * len(queries)

        # group queries by padded model length so they share kernel shapes.
        # 32-granular padding: padded model positions are paid work in
        # every kernel, so finer groups trade a few extra kernel shapes
        # for fewer dead cells on typical Pfam length mixes
        groups: dict = {}
        for qi, hmm in enumerate(queries):
            if hmm.alphabet != self.alphabet:
                raise ValueError("alphabet mismatch between query and engine")
            Mp = B.round_up(hmm.M, 32)
            groups.setdefault(Mp, []).append(qi)
        # coalesce small groups at 128 granularity: a 3-profile group
        # pays the same fixed kernel-launch cost as a 64-profile one,
        # so long-tail model lengths merge upward (extra Mp padding)
        # until the launch cost stops dominating
        gran = int(os.environ.get("PYHMMER_TPU_COALESCE", "128"))
        coalesced: dict = {}
        for Mp, qidx in groups.items():
            key = Mp if len(qidx) >= 32 or gran <= 32 else \
                B.round_up(Mp, gran)
            coalesced.setdefault(key, []).extend(qidx)

        states: List[_ChunkState] = []
        for Mp, qidx in sorted(coalesced.items()):
            for c0 in range(0, len(qidx), self.p_max):
                states.append(_ChunkState(self, queries,
                                          qidx[c0: c0 + self.p_max], Mp))

        for bucket in buckets.buckets:
            idx, codes, lengths, dev = bucket
            if dev is None:
                bucket[3] = B.SeqDevice(codes, lengths)

        # ---- globally staged execution ----
        # Every (profile chunk x sequence bucket) kernel for a stage is
        # enqueued before ANY result is fetched, so the whole workload
        # pays a handful of blocking device->host syncs instead of three
        # per chunk.  Forward survivors
        # that skip the Viterbi gate are submitted to the GIL-releasing
        # native domain-definition pool as soon as the Forward stage
        # lands, overlapping host postprocessing with the remaining
        # device work (the batched analog of the reference's worker
        # threads, hmmer/_base.py).  Exact-score gate re-checks and Hit
        # construction happen serially at the end.
        from .ops import native as _native
        import concurrent.futures as _cf
        import time as _time
        _timing = os.environ.get("PYHMMER_TPU_TIMING")
        _t0 = _time.time()
        _tmark = {}

        def _mark(name):
            _tmark[name] = _time.time() - _t0
        native_ok = _native.available()
        self.last_kernels = {"forward": "scan", "viterbi": "scan"}
        # routing knobs re-read per search so tests can force every pair
        # through the full device cascade (spec <= -1 disables
        # speculation entirely; host-budget scale 0 disables the sparse
        # host path)
        _spec_p1b = float(os.environ.get("PYHMMER_TPU_SPEC_P1B",
                                         str(SPECULATE_P1B)))
        _hb_scale = float(os.environ.get("PYHMMER_TPU_HOST_BUDGET", "1"))
        # worker count == core count: the native calls release the GIL
        # and keep the cores saturated; oversubscribing measurably slows
        # the postprocessing phases
        nthreads = int(os.environ.get("PYHMMER_TPU_THREADS", "0")) or \
            max(2, os.cpu_count() or 2)
        own_executor = False
        if not native_ok:
            executor = None
        elif self.shared_executor is not None:
            executor = self.shared_executor
        else:
            executor = _cf.ThreadPoolExecutor(nthreads)
            own_executor = True
        pending = []   # (job tuple, future | None)

        def _run_domaindef(job):
            """Worker-thread body: optional native Viterbi F2 gate (for
            host-routed sparse pairs that skipped the device Viterbi),
            then native domaindef (GIL released during the C calls) +
            exact-score F3 gate + Hit construction.  The returned Hit is
            appended serially by the collect loop."""
            (ci, bi, pi, tgt, b, seed, fwd_min, filtersc_b, nullsc_b,
             vit_min) = job
            st = states[ci]
            pli = st.pipelines[pi]
            sq = targets[tgt]
            if vit_min is not None and np.isfinite(vit_min):
                v = _native.viterbi_score(st.profs[pi], sq.sequence)
                if v is None:
                    return None                  # caller falls back
                if v < vit_min:
                    return ("gated_vit",)
            out = _native.domaindef(st.profs[pi], sq.sequence,
                                    pli.null2, seed, fwd_min=fwd_min)
            if out is None:
                return None                      # caller falls back
            fwdsc, res = out
            if fwdsc < fwd_min:
                return ("gated", fwdsc)
            hit = pli._build_hit(st.profs[pi], sq, st.tophits[pi],
                                 fwdsc, nullsc_b, res)
            return ("hit", hit)

        def _submit(ci, bi, pi, pass_row, fcols, idx, vit_min_row=None,
                    spec=False):
            st = states[ci]
            pli = st.pipelines[pi]
            c = ctx[(ci, bi)]
            ev = st.ev[pi]
            F3s = pli.F3 * F3_SLACK
            # exp_surv((fwdsc - filtersc)/LOG2) <= F3s  <=>  fwdsc >= min
            gate_off = (LOG2 * (ev[4] - math.log(F3s) / ev[5])
                        if F3s < 1.0 else -np.inf)
            for col in np.where(pass_row)[0]:
                b = int(fcols[col])
                seed = (pli.seed if pli.do_reseeding
                        else int(pli._rng.integers(0, 2**62)))
                filtersc_b = float(c["filtersc"][pi, b])
                nullsc_b = float(c["nullsc"][b])
                vit_min = (None if vit_min_row is None
                           else float(vit_min_row[col]))
                job = (ci, bi, pi, int(idx[b]), b, seed,
                       filtersc_b + gate_off, filtersc_b, nullsc_b,
                       vit_min)
                fut = (executor.submit(_run_domaindef, job)
                       if executor is not None else None)
                pending.append((job, fut, spec))

        ctx: dict = {}

        # -- stage 1 (device): MSV for every chunk x bucket --
        s1_parts = []
        s1_pairs = []   # (ci, bi, part_offset)
        for ci, st in enumerate(states):
            for bi, bucket in enumerate(buckets.buckets):
                dev = bucket[3]
                s1_pairs.append((ci, bi, len(s1_parts)))
                s1_parts.extend(self._msv_dev(st.pb, dev))
        _mark("s1_enqueued")

        # -- stage 1 (host): MSV gate, then the exact bias filter on the
        # survivors only (reference cascade order, p7_pipeline.c).  The
        # per-profile bias batches run on the worker pool (the native
        # batch call releases the GIL), overlapping the numpy gating of
        # the remaining (chunk, bucket) pairs. --
        s2_jobs = []
        s1_host_jobs = []   # (npairs1, ci, bi, args, fut)

        def _bias_stage(st, codes, lengths, pass1, nullsc, usc):
            """Worker body: exact bias filter for every profile's MSV
            survivors in one (chunk, bucket)."""
            filtersc = np.full_like(usc, np.nan)
            P1b = np.full_like(usc, np.inf)
            pass2 = np.zeros_like(pass1)
            for pi, pli in enumerate(st.pipelines):
                cols = np.where(pass1[pi])[0]
                if len(cols) == 0:
                    continue
                if pli.bias_filter:
                    logsc = self._bias_host(st, pi, codes, lengths, cols)
                    filtersc[pi, cols] = logsc + nullsc[cols]
                else:
                    filtersc[pi, cols] = nullsc[cols]
                P1b[pi, cols] = gumbel_surv(
                    (usc[pi, cols] - filtersc[pi, cols]) / LOG2,
                    st.ev[pi, 0], st.ev[pi, 1])
                pass2[pi, cols] = P1b[pi, cols] <= pli.F1
            return filtersc, P1b, pass2

        for st in states:
            # prewarm the per-pipeline odds tables serially (idempotent
            # cached property; avoids racy first-builds on the pool)
            for pli in st.pipelines:
                if pli.bias_filter:
                    pli.background.filter_odds_table()

        def _gate_pair(ci, bi, dx_raw, ovf_raw):
            st = states[ci]
            idx, codes, lengths, dev = buckets.buckets[bi]
            Preal = st.Preal
            dx = dx_raw[:Preal].astype(np.float64)
            ovf = ovf_raw[:Preal]

            nres = int(lengths.sum())
            nseq_real = int((lengths > 0).sum())
            for pli in st.pipelines:
                pli.nseqs += nseq_real
                pli.nres += nres

            valid_b = lengths > 0
            nullsc = dev.nullsc_host                      # [B]
            usc = (dx - dev.tjbu_host[None, :]) / st.pb.scale_b - 3.0
            usc[ovf > 0] = np.inf

            # MSV gate in threshold form (delta >= thr <=> P1 <= F1)
            pass1 = (usc - nullsc[None, :] >= st.thr1) & valid_b[None, :]
            for pi, pli in enumerate(st.pipelines):
                pli.n_past_msv += int(pass1[pi].sum())
            if not pass1.any():
                return
            args = (st, codes, lengths, pass1, nullsc, usc)
            fut = (executor.submit(_bias_stage, *args)
                   if executor is not None else None)
            s1_host_jobs.append((int(pass1.sum()), ci, bi, args, fut))

        # fetch the MSV stage in two halves so the first half's host
        # gating (and its bias batches on the pool) overlaps the second
        # half's device kernels
        nh = (len(s1_pairs) + 1) // 2
        for lo, hi in ((0, nh), (nh, len(s1_pairs))):
            if lo >= hi:
                continue
            p_lo = s1_pairs[lo][2]
            p_hi = (s1_pairs[hi][2] if hi < len(s1_pairs)
                    else len(s1_parts))
            arrs = _fetch_all(s1_parts[p_lo: p_hi])
            if lo == 0:
                _mark("s1_fetched")
            for (ci, bi, off) in s1_pairs[lo:hi]:
                _gate_pair(ci, bi, arrs[off - p_lo], arrs[off - p_lo + 1])

        # gate + route in descending survivor count so the densest
        # Forward kernels are enqueued (and later fetched) first -- their
        # domaindef jobs reach the host pool earliest
        s1_host_jobs.sort(key=lambda j: -j[0])
        s2_parts = []
        for npairs1, ci, bi, args, fut in s1_host_jobs:
            st = states[ci]
            idx, codes, lengths, dev = buckets.buckets[bi]
            filtersc, P1b, pass2 = (fut.result() if fut is not None
                                    else _bias_stage(*args))
            nullsc = args[4]
            for pi, pli in enumerate(st.pipelines):
                pli.n_past_bias += int(pass2[pi].sum())
            if not pass2.any():
                continue
            bsel = np.where(pass2.any(axis=0))[0]
            ctx[(ci, bi)] = dict(filtersc=filtersc, nullsc=nullsc,
                                 pass2=pass2, P1b=P1b, bsel=bsel)
            # sparse jobs skip the device cascade entirely: a scan's cost
            # grows with Lmax x P regardless of how many lanes hold
            # survivors, so when only a handful of pairs survive, the native
            # host path (Viterbi gate + domaindef with its exact
            # fwd_min bail) is cheaper AND overlaps the device work
            # of the dense buckets
            npairs = int(pass2.sum())
            Lmax_b = codes.shape[1]
            host_budget = native_ok and npairs <= _hb_scale * max(
                4, int(6e-4 * Lmax_b * st.pb.P))
            if host_budget:
                for pi, pli in enumerate(st.pipelines):
                    cols = np.where(pass2[pi])[0]
                    if len(cols) == 0:
                        continue
                    ev = st.ev[pi]
                    skip = P1b[pi, cols] <= pli.F2 * F2_SKIP_SLACK
                    pli.n_past_vit += int(skip.sum())
                    vmin = (filtersc[pi, cols]
                            + LOG2 * (ev[2]
                                      - np.log(pli.F2) / ev[3]))
                    vit_min_row = np.where(skip, -np.inf, vmin)
                    _submit(ci, bi, pi,
                            np.ones(len(cols), dtype=bool),
                            cols, idx, vit_min_row)
                continue
            # speculative host routing of near-certain hits: a pair whose
            # quantized-MSV P-value is far below the skip-Viterbi gate
            # will almost surely reach domaindef, so its job starts on
            # the host pool NOW instead of waiting for the device Forward
            # fetch.  Outcome-identical to the device path: the pair
            # skips Viterbi legitimately (P1b <= F2 * F2_SKIP_SLACK) and
            # the device Forward is only a prefilter -- the exact-f64
            # Forward inside the job applies the reference F3 gate either
            # way.  Mis-speculations cost one fwd_min-bailed parser pass.
            if native_ok:
                spec = pass2 & (P1b <= np.minimum(
                    st.F2 * F2_SKIP_SLACK, _spec_p1b))
                if spec.any():
                    c = ctx[(ci, bi)]
                    _tmark["nspec"] = _tmark.get("nspec", 0) + int(
                        spec.sum())
                    for pi, pli in enumerate(st.pipelines):
                        cols = np.where(spec[pi])[0]
                        if len(cols) == 0:
                            continue
                        pli.n_past_vit += len(cols)
                        _submit(ci, bi, pi,
                                np.ones(len(cols), dtype=bool), cols, idx,
                                spec=True)
                    pass2 = pass2 & ~spec
                    c["pass2"] = pass2
                    if not pass2.any():
                        continue
                    c["bsel"] = np.where(pass2.any(axis=0))[0]
            # enqueue this job's Forward kernel immediately: device work
            # starts while later bias batches are still being gated
            c = ctx[(ci, bi)]
            n = len(c["bsel"])
            Bp = max(128, _pad_b(n))
            ridx = np.full(Bp, -1, dtype=np.int32)
            ridx[:n] = c["bsel"]
            fsc_dev = self._forward_dev(st.pb, buckets.buckets[bi][3],
                                        jnp.asarray(ridx))
            c["nsel"] = n
            s2_parts.append(fsc_dev)
            s2_jobs.append((ci, bi))

        # -- stage 2 (device): Forward over bias survivors --
        # All Forward kernels are enqueued back to back and the stage
        # comes back in a few concatenated fetches.  (Cascade order
        # note: Forward runs on the bias survivors and the strict-F2
        # Viterbi gate is applied afterwards only where P1b did not
        # already skip it -- the gate predicates are independent, so the
        # surviving set is identical to the reference order.)
        s3_jobs = []
        s3_parts = []

        def _stage2_host(j, fsc_raw):
            cj, bi = s2_jobs[j]
            st = states[cj]
            c = ctx[(cj, bi)]
            Preal = st.Preal
            bsel, nsel = c["bsel"], c["nsel"]
            c["fcols"] = bsel
            fsc = fsc_raw[:Preal, :nsel].astype(np.float64)
            P3 = exp_surv((fsc - c["filtersc"][:, bsel]) / LOG2,
                          st.ev[:, 4:5], st.ev[:, 5:6])
            # extra 1.5x device-side margin: the f32 device Forward
            # wobbles a few millibits, so borderline targets must still
            # reach the exact float64 re-check (which applies the real
            # F3 * F3_SLACK gate)
            pass_fwd = c["pass2"][:, bsel] & (P3 <= st.F3
                                              * F3_SLACK * 1.5)
            skip_vit = c["P1b"][:, bsel] <= st.F2 * F2_SKIP_SLACK
            need_vit = pass_fwd & ~skip_vit
            c["pass_fwd"] = pass_fwd
            c["need_vit"] = need_vit
            for pi, pli in enumerate(st.pipelines):
                pli.n_past_vit += int((c["pass2"][pi, bsel]
                                       & skip_vit[pi]).sum())
            if need_vit.any():
                # enqueue the Viterbi kernel for this job immediately
                vcols = np.where(need_vit.any(axis=0))[0]
                c["vcols"] = vcols
                rows = bsel[vcols]
                n = len(rows)
                Bp = max(128, _pad_b(n))
                ridx = np.full(Bp, -1, dtype=np.int32)
                ridx[:n] = rows
                vsc_dev = self._viterbi_dev(st.pb, buckets.buckets[bi][3],
                                            jnp.asarray(ridx))
                c["nv"] = n
                s3_jobs.append((cj, bi))
                s3_parts.append(vsc_dev)
            idx = buckets.buckets[bi][0]
            for pi in range(Preal):
                _submit(cj, bi, pi, pass_fwd[pi] & ~need_vit[pi],
                        bsel, idx)

        # fetch in a few groups: each group's survivors reach the host
        # worker pool while the remaining Forward kernels are still
        # computing on device
        ngroup = max(1, (len(s2_parts) + 3) // 4)
        _mark("s1_host_done")
        _tmark["n_s2_jobs"] = len(s2_jobs)
        _tmark["s2_lanes"] = sum(len(ctx[j]["bsel"]) for j in s2_jobs)
        for g0 in range(0, len(s2_parts), ngroup):
            group_np = _fetch_all(s2_parts[g0: g0 + ngroup])
            for dj, fsc_raw in enumerate(group_np):
                _stage2_host(g0 + dj, fsc_raw)
        _mark("s2_done")
        _tmark["n_s3_jobs"] = len(s3_jobs)
        s3_np = _fetch_all(s3_parts)
        _mark("s3_fetched")

        # -- stage 3 (host): Viterbi gate on the leftover columns --
        for j, (cj, bi) in enumerate(s3_jobs):
            st = states[cj]
            c = ctx[(cj, bi)]
            Preal = st.Preal
            bsel, vcols = c["bsel"], c["vcols"]
            vsc = s3_np[j][:Preal, : c["nv"]].astype(np.float64)
            P2 = gumbel_surv(
                (vsc - c["filtersc"][:, bsel][:, vcols]) / LOG2,
                st.ev[:, 2:3], st.ev[:, 3:4])
            keep = P2 <= st.F2
            c["pass_fwd"][:, vcols] &= (~c["need_vit"][:, vcols]) | keep
            for pi, pli in enumerate(st.pipelines):
                pli.n_past_vit += int((c["need_vit"][pi, vcols]
                                       & keep[pi]).sum())
            idx = buckets.buckets[bi][0]
            survived = c["pass_fwd"][:, vcols] & c["need_vit"][:, vcols]
            for pi in range(Preal):
                _submit(cj, bi, pi, survived[pi], bsel[vcols], idx)
        _mark("s3_host_done")

        # ---- collect: serial append of worker-built hits (deterministic
        # insertion order = deterministic tie-breaking in sort) ----
        for job, fut, spec_job in pending:
            (ci, bi, pi, tgt, b, seed, fwd_min, filtersc_b, nullsc_b,
             vit_min) = job
            st = states[ci]
            pli = st.pipelines[pi]
            vit_gated_here = vit_min is not None and np.isfinite(vit_min)
            out = fut.result() if fut is not None else None
            if spec_job and out is not None:
                key = "nspec_hit" if out[0] == "hit" else "nspec_gated"
                _tmark[key] = _tmark.get(key, 0) + 1
            if out is None:
                # pure-Python fallback (no native library)
                sq = targets[tgt]
                Lb = int(buckets.buckets[bi][2][b])
                pli.background.set_length(Lb)
                st.profs[pi].reconfig_length(Lb)
                st.profs_uni[pi].reconfig_length(Lb)
                if vit_gated_here:
                    v = refops.viterbi_score(st.profs[pi], sq.sequence)
                    if v < vit_min:
                        continue
                    pli.n_past_vit += 1
                fwd = refops.forward(st.profs[pi], sq.sequence)
                Px = float(exp_surv((fwd.score - filtersc_b) / LOG2,
                                    st.ev[pi, 4], st.ev[pi, 5]))
                if Px > pli.F3 * F3_SLACK:
                    continue
                pli.n_past_fwd += 1
                pli._finish_target(st.profs[pi], st.profs_uni[pi], sq,
                                   st.tophits[pi], fwd, nullsc_b)
                continue
            if out[0] == "gated_vit":
                continue
            if vit_gated_here:
                pli.n_past_vit += 1
            if out[0] == "gated":
                continue
            pli.n_past_fwd += 1
            hit = out[1]
            if hit is not None:
                st.tophits[pi].hits.append(hit)
        if executor is not None and own_executor:
            executor.shutdown()
        _mark("collect_done")
        _tmark["npending"] = len(pending)
        #: per-search stage timing (seconds since search start), kept for
        #: diagnostics / the bench stage breakdown
        self.last_timing = dict(_tmark)
        self.last_kernels["msv"] = sorted(self.last_kernels.get("msv", ()))
        if _timing:
            import sys as _sys
            print("# engine timing: " + " ".join(
                f"{k}={v:.3f}" for k, v in _tmark.items())
                + f" npending={len(pending)}", file=_sys.stderr)

        # ---- finalize ----
        for st in states:
            for pi, qi in enumerate(st.chunk):
                pli = st.pipelines[pi]
                if pli.Z_setby == "ntargets":
                    pli.Z = float(pli.nseqs)
                th = st.tophits[pi]
                th._take_accounting(pli)
                th.bit_cutoffs = pli.bit_cutoffs
                th.sort_by_key()
                th.threshold()
                results[qi] = th
                if callback is not None:
                    callback(queries[qi], len(queries))
        return results  # type: ignore[return-value]
