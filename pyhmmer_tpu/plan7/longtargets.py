"""The long-targets (nhmmer) comparison pipeline.

Mirrors ``pyhmmer.plan7.LongTargetsPipeline`` (reference
``src/pyhmmer/plan7.pyx:6690-7546``; C semantics of
``p7_Pipeline_LongTarget``): arbitrarily long DNA/RNA targets are scanned
as overlapping windows of width ``W = block_length`` (262,144) with
``C = max_length`` residues of context carried between windows
(``plan7.pyx:7385``), on both strands via reverse complement
(``plan7.pyx:7421-7435``).  Inside a window, a quantized SSV diagonal scan
seeds candidate subwindows (``p7_MSVFilter_longtarget`` +
``p7_pli_ExtendAndMergeWindows`` roles), each subwindow runs the
bias/Viterbi/Forward gates and posterior-heuristic envelope definition,
and every surviving envelope becomes its own hit (nhmmer reports
envelopes, not domains).  E-values are computed over total searched
residues: ``lnP += log(res_count / max_length)``
(``p7_tophits_ComputeNhmmerEvalues``; ``plan7.pyx:7170-7177``), duplicate
hits from overlapping windows are removed keeping the best E-value
(``p7_tophits_RemoveDuplicates``, ``plan7.pyx:7184``).

Device note: window x strand cascade stages batch the same way the
standard engine batches target sequences; the sequential driver here is
the oracle the batched path must agree with.
"""

from __future__ import annotations

import math
import os as _os
import numpy as np
from typing import Iterable, List, Optional, Union

from ..easel.alphabet import Alphabet
from ..easel.sequence import DigitalSequence, DigitalSequenceBlock
from .hmm import HMM
from .background import Background
from .profile import Profile
from .evalues import gumbel_surv, gumbel_invsurv, exp_surv, exp_logsurv
from .results import TopHits, Hit, Domain, F_REPORTED, F_INCLUDED
from .pipeline import Pipeline, LOG2, F3_SLACK
from . import domaindef as dd
from ..ops import reference as ref
from ..ops import kernels, native
from ..ops.quantize import quantize_msv

__all__ = ["LongTargetsPipeline", "compute_max_length"]

DEFAULT_LONG_F1 = 0.02
DEFAULT_LONG_F2 = 3e-3
DEFAULT_LONG_F3 = 3e-5
DEFAULT_LONG_B1 = 100
DEFAULT_LONG_B2 = 240
DEFAULT_LONG_B3 = 1000
DEFAULT_BLOCK_LENGTH = 0x40000
#: p7_DEFAULT_WINDOW_BETA (p7_builder tail mass for max_length)
DEFAULT_WINDOW_BETA = 1e-7


def compute_max_length(hmm: HMM, beta: float = DEFAULT_WINDOW_BETA) -> int:
    """Length cap for model-emitted alignments: the ``1 - beta`` quantile
    of the core-model emitted-length distribution
    (``p7_Builder_MaxLength`` role).

    The distribution is computed exactly by dynamic programming over the
    core transitions: match states emit one residue, deletes none, and
    the geometric insert runs between nodes are IIR length convolutions.
    """
    M = hmm.M
    t = np.asarray(hmm.t, dtype=np.float64)          # [(M+1), 7]
    tMM, tMI, tMD, tIM, tII, tDM, tDD = (t[:, i] for i in range(7))
    Lmax = max(4 * M + 256, 1024)
    try:
        from scipy.signal import lfilter
    except Exception:                                # pragma: no cover
        lfilter = None
    am = np.zeros(Lmax)
    ad = np.zeros(Lmax)
    am[0] = 1.0
    for k in range(M):
        direct = am * tMM[k] + ad * tDM[k]
        if lfilter is not None:
            ins = lfilter([tMI[k] * tIM[k]], [1.0, -tII[k]],
                          np.concatenate(([0.0], am[:-1])))
        else:                                        # pragma: no cover
            ins = np.zeros(Lmax)
            acc = 0.0
            for l in range(1, Lmax):
                acc = acc * tII[k] + am[l - 1] * tMI[k] * tIM[k]
                ins[l] = acc
        pre = direct + ins
        nm = np.concatenate(([0.0], pre[:-1]))       # M_{k+1} emits 1
        nd = am * tMD[k] + ad * tDD[k]
        am, ad = nm, nd
    dist = am + ad
    tail = np.cumsum(dist[::-1])[::-1]
    over = np.where(tail < beta)[0]
    return int(over[0]) if len(over) else Lmax


def _resolve_max_length(query, window_length: Optional[int],
                        window_beta: float) -> int:
    if window_length is not None:
        return int(window_length)
    if isinstance(query, HMM):
        if (query.max_length is not None and query.max_length > 0
                and window_beta == DEFAULT_WINDOW_BETA):
            return int(query.max_length)
        return compute_max_length(query, window_beta)
    raise TypeError(
        "cannot use a Profile/OptimizedProfile query without max_length set")


class LongTargetsPipeline(Pipeline):
    """An HMMER3 pipeline tuned for long (DNA/RNA) targets."""

    def __init__(
        self,
        alphabet: Alphabet,
        background: Optional[Background] = None,
        *,
        F1: float = DEFAULT_LONG_F1,
        F2: float = DEFAULT_LONG_F2,
        F3: float = DEFAULT_LONG_F3,
        strand: Optional[str] = None,
        B1: int = DEFAULT_LONG_B1,
        B2: int = DEFAULT_LONG_B2,
        B3: int = DEFAULT_LONG_B3,
        block_length: int = DEFAULT_BLOCK_LENGTH,
        window_length: Optional[int] = None,
        window_beta: Optional[float] = None,
        **kwargs,
    ):
        if not alphabet.is_nucleic():
            raise ValueError(
                "expected a nucleotide alphabet for a long-targets pipeline")
        if strand not in (None, "watson", "crick"):
            raise ValueError(f"invalid strand: {strand!r}")
        if window_length is not None and window_length < 4:
            raise ValueError("window_length must be >= 4")
        if window_beta is not None and not (0.0 < window_beta < 1.0):
            raise ValueError("window_beta must be between 0 and 1")
        super().__init__(alphabet, background, F1=F1, F2=F2, F3=F3, **kwargs)
        self.long_targets = True
        self.strand = strand
        self.B1, self.B2, self.B3 = B1, B2, B3
        self.block_length = block_length
        self.window_length = window_length
        self.window_beta = (DEFAULT_WINDOW_BETA if window_beta is None
                            else window_beta)

    # ------------------------------------------------------------------

    def search_hmm(self, query: HMM,
                   sequences: Iterable[DigitalSequence]) -> TopHits:
        """Run nhmmer for one query HMM over long target sequences
        (``LongTargetsPipeline.search_hmm``, ``plan7.pyx:7053-7200``)."""
        if query.alphabet != self.alphabet:
            raise ValueError("alphabet mismatch between query and pipeline")
        max_length = _resolve_max_length(query, self.window_length,
                                         self.window_beta)
        prof, prof_uni = self._new_model(query)
        hits = TopHits()
        hits._mode = "search"
        hits.query_name = prof.name
        hits.query_accession = prof.accession
        hits.query_length = query.M

        W = self.block_length
        C = max_length
        if W <= C:
            raise ValueError("block_length must be greater than max_length")

        self.nseqs = 0
        from ..easel.seqfile import SequenceFile as _SeqFile
        if isinstance(sequences, _SeqFile):
            # file-streamed genome windows (esl_sqio_ReadWindow role,
            # plan7.pyx:7494-7539): windows are read off disk one at a
            # time, so peak memory is ~W + C residues per record
            # regardless of chromosome size.  Hit target lengths are
            # patched once the record's true length is known.
            records = self._streamed_records(sequences, W, C)
        else:
            records = self._inmemory_records(sequences, W, C)
        pend: List[dict] = []
        for t, (sq, win_iter, final_len) in enumerate(records):
            nh0 = len(hits.hits)
            for i, win, n_prov in win_iter:
                wn = len(win)
                Cw = 0 if i == 0 else min(C, wn)
                Ww = wn - Cw
                self.nres += wn
                if self.strand != "crick":
                    self.nres -= Cw
                    self._collect_subwindows(prof, win, i + 1, n_prov,
                                             "+", t, sq, max_length, pend)
                else:
                    self.nres -= wn
                if self.strand != "watson":
                    rc = self.alphabet.complement_map[win][::-1]
                    self._collect_subwindows(prof, rc, i + wn, n_prov,
                                             "-", t, sq, max_length, pend)
                    self.nres += Ww
                if len(pend) >= 256:
                    self._flush_subwindows(prof, prof_uni, max_length,
                                           hits, pend)
                    pend = []
            # flush at record end so per-record length patching sees
            # every hit of this record
            if pend:
                self._flush_subwindows(prof, prof_uni, max_length, hits,
                                       pend)
                pend = []
            n = final_len()
            for h in hits.hits[nh0:]:
                h.length = n
                for d in h.domains:
                    if d.alignment is not None:
                        d.alignment.target_length = n
            self.nseqs += 1

        # E-values over total residues (p7_tophits_ComputeNhmmerEvalues)
        if self.Z_setby == "option":
            res_count = int(1_000_000 * self.Z)
            if self.strand is None:
                res_count *= 2
        else:
            res_count = self.nres
        shift = math.log(max(res_count, 1) / float(max_length))
        for h in hits.hits:
            h.lnP += shift
            for d in h.domains:
                d.lnP += shift
        hits.Z = 1.0   # long-target evalue = exp(lnP) directly
        hits.domZ = 1.0
        hits.sort_by_seqidx()
        _remove_duplicates(hits)
        hits._take_accounting(self)
        hits.Z = hits.domZ = 1.0
        hits.Z_setby = hits.domZ_setby = "option"
        hits.long_targets = True
        hits.bit_cutoffs = self.bit_cutoffs
        hits.sort_by_key()
        hits.threshold()
        return hits

    def _inmemory_records(self, sequences, W: int, C: int):
        """Window iteration over in-memory digital sequences: yields
        ``(sq, window_iter, final_len)`` with windows
        ``(i, codes, provisional_len)`` -- the in-RAM analog of the
        streamed reader, identical window boundaries."""
        for sq in sequences:
            if sq.alphabet != self.alphabet:
                raise ValueError("alphabet mismatch in target sequences")
            n = len(sq)

            def win_iter(sq=sq, n=n):
                i = 0
                while i < n:
                    rem = n - i
                    Cw = 0 if i == 0 else min(C, rem)
                    Ww = min(W, rem - Cw)
                    yield i, sq.sequence[i: i + Cw + Ww], n
                    i += W - C

            yield sq, win_iter(), (lambda n=n: n)

    def _streamed_records(self, seqfile, W: int, C: int):
        """File-streamed genome windows: reads each record's residues in
        bounded chunks (``SequenceFile.records_chunked``) and yields the
        same window boundaries as :meth:`_inmemory_records` without ever
        materializing a full chromosome.  The provisional length passed
        with each window is the residue count seen so far; the caller
        patches hit/alignment lengths via ``final_len()`` once the record
        is exhausted."""
        import numpy as _np
        if seqfile.digital and seqfile.alphabet != self.alphabet:
            raise ValueError("alphabet mismatch in target sequence file")
        for header, chunks in seqfile.records_chunked():
            state = {"n": 0}

            def win_iter(chunks=chunks, state=state):
                buf = _np.empty(0, dtype=_np.uint8)
                i = 0
                ended = False
                while True:
                    while not ended and len(buf) < W + C:
                        nxt = next(chunks, None)
                        if nxt is None:
                            ended = True
                            break
                        arr = self.alphabet.encode(nxt)
                        buf = (arr if len(buf) == 0
                               else _np.concatenate([buf, arr]))
                    rem = len(buf)
                    state["n"] = i + rem
                    if rem <= 0:
                        break
                    Cw = 0 if i == 0 else min(C, rem)
                    Ww = min(W, rem - Cw)
                    yield i, buf[: Cw + Ww], i + rem
                    step = W - C
                    if ended and rem <= step:
                        break
                    i += step
                    buf = buf[step:]

            yield header, win_iter(), (lambda state=state: state["n"])

    def search_seq(self, query: DigitalSequence,
                   sequences: Iterable[DigitalSequence],
                   builder=None) -> TopHits:
        from .builder import Builder
        builder = builder or Builder(
            self.alphabet, window_length=self.window_length,
            window_beta=self.window_beta)
        hmm, _, _ = builder.build(query, self.background)
        return self.search_hmm(hmm, sequences)

    def search_msa(self, query, sequences: Iterable[DigitalSequence],
                   builder=None) -> TopHits:
        from .builder import Builder
        builder = builder or Builder(
            self.alphabet, window_length=self.window_length,
            window_beta=self.window_beta)
        hmm, _, _ = builder.build_msa(query, self.background)
        return self.search_hmm(hmm, sequences)

    def scan_seq(self, query, hmms):
        raise TypeError(
            "cannot run a database scan with a long-targets pipeline")

    # ------------------------------------------------------------------

    def _collect_subwindows(self, prof: Profile, wdsq: np.ndarray,
                            win_start: int, orig_len: int, strand: str,
                            seqidx: int, sq: DigitalSequence,
                            max_length: int, pend: List[dict]) -> None:
        """SSV-seed one window of one strand and append the merged
        candidate subwindows to ``pend`` (gated later in a batch).

        ``win_start``: 1-based coordinate (on the original strand) of the
        window's first residue for '+', or of the residue *preceding* the
        window's first (i.e. the highest original coordinate) for '-'.
        """
        L = len(wdsq)
        if L == 0:
            return

        # --- SSV seeding over the whole window --------------------------
        # The MSV Gumbel calibration does not length-normalize for DNA at
        # window scale (a random max_length window always "passes" F1), so
        # the seed threshold is calibrated directly against the null: the
        # smallest quantized diagonal score whose crossing rate on
        # background-i.i.d. sequence is F1 per max_length residues.
        q = quantize_msv(prof)
        ml = float(max_length)
        tjb_b = int(q.tjb_b(ml))
        xBv = max(0, q.base_b - tjb_b - q.tbm_b)
        thresh_q = self._seed_threshold(prof, q, xBv, max_length)
        seeds = _ssv_seed_positions(q, wdsq, xBv, max(thresh_q, 1))
        if len(seeds) == 0:
            return
        self.n_past_msv += 1

        # --- extend seeds by max_length and merge into subwindows -------
        subs: List[List[int]] = []
        for p in seeds:
            a = max(1, int(p) - max_length + 1)
            b = min(L, int(p) + max_length - 1)
            if subs and a <= subs[-1][1] + 1:
                subs[-1][1] = max(subs[-1][1], b)
            else:
                subs.append([a, b])
        for a, b in subs:
            pend.append(dict(sub=np.ascontiguousarray(wdsq[a - 1: b]),
                             a=a, win_start=win_start, orig_len=orig_len,
                             strand=strand, seqidx=seqidx, sq=sq))

    #: margin (nats) for the f32 device Viterbi/Forward prefilters: lanes
    #: within this much of a gate threshold are re-checked with the exact
    #: host kernels, so the surviving set is identical to the host path
    DEVICE_GATE_MARGIN = 1.0

    def _flush_subwindows(self, prof: Profile, prof_uni: Profile,
                          max_length: int, hits: TopHits,
                          pend: List[dict]) -> None:
        """Gate a batch of candidate subwindows and run the envelope
        machinery on the survivors.

        With enough candidates the MSV scores come from the batched device
        kernel (uint8-quantized DP is integer-exact on device, so the gate
        is identical to the host path) and the f32 device Viterbi/Forward
        run as margin-checked prefilters in front of the exact host
        kernels -- the batched analog of the reference's per-window SIMD
        filters (SURVEY 2.6 sequence-length parallelism).  Small batches,
        and platforms where the batched gates do not pay
        (:func:`ops.kernels.use_device_gates`), take the host path."""
        ev = prof.evparam.astype(np.float64)
        bg = self.background

        n = len(pend)
        usc_batch = vit_pre = fwd_pre = None
        dev_env = _os.environ.get("PYHMMER_TPU_NHMMER_DEVICE", "auto")
        if dev_env == "force" or (dev_env != "0" and n >= 4
                                  and kernels.use_device_gates(
                                      kernels.platform_of())):
            usc_batch, vit_pre, fwd_pre = self._device_gates(prof, pend)

        for j, job in enumerate(pend):
            sub = job["sub"]
            Ls = len(sub)
            bg.set_length(Ls)
            prof.reconfig_length(Ls)
            prof_uni.reconfig_length(Ls)
            nullsc = bg.null_one(Ls)

            # bias filter (window-composition HMM; long-target pipelines
            # always apply it against the same F1 threshold)
            if self.bias_filter:
                filtersc = bg.filter_score(sub)
            else:
                filtersc = nullsc
            if usc_batch is not None:
                usc = float(usc_batch[j])
            elif native.available():
                usc = native.msv_quant(quantize_msv(prof), sub)
            else:
                usc = ref.msv_score_quantized(prof, sub)
            P = float(gumbel_surv((usc - filtersc) / LOG2, ev[0], ev[1]))
            if P > self.F1:
                continue
            self.n_past_bias += 1

            # Viterbi gate (f32 device prefilter with margin, exact
            # host kernel for anything near or past the threshold)
            if P > self.F2:
                vmin = filtersc + LOG2 * (ev[2] - math.log(self.F2) / ev[3])
                if (vit_pre is not None
                        and vit_pre[j] < vmin - self.DEVICE_GATE_MARGIN):
                    continue
                if native.available():
                    vfsc = native.viterbi_score(prof, sub)
                else:
                    vfsc = ref.viterbi_score(prof, sub)
                P = float(gumbel_surv((vfsc - filtersc) / LOG2, ev[2],
                                      ev[3]))
                if P > self.F2:
                    continue
            self.n_past_vit += 1

            # Forward gate (same prefilter pattern).  P <= F3 is
            # equivalent to fwdsc >= fmin, so the native domain-definition
            # driver applies the gate itself via fwd_min (bailing after
            # its exact Forward) and the full envelope machinery runs in
            # C++ -- the python define_domains path is the oracle
            # fallback only.
            fmin = filtersc + LOG2 * (ev[4] - math.log(self.F3) / ev[5])
            if (fwd_pre is not None
                    and fwd_pre[j] < fmin - self.DEVICE_GATE_MARGIN):
                continue
            res = None
            if native.available():
                seed = (self.seed if self.do_reseeding
                        else int(self._rng.integers(0, 2**62)))
                out = native.domaindef(prof, sub, self.null2, seed,
                                       fwd_min=fmin)
            else:
                out = None
            if out is not None:
                fwdsc, res = out
                if fwdsc < fmin:
                    continue
                self.n_past_fwd += 1
            else:
                # pure-python fallback (no native library)
                fwd = ref.forward(prof, sub)
                P = float(exp_surv((fwd.score - filtersc) / LOG2,
                                   ev[4], ev[5]))
                if P > self.F3:
                    continue
                self.n_past_fwd += 1
                if self.do_reseeding:
                    self._rng = np.random.default_rng(self.seed)
                bck = ref.backward(prof, sub)
                res = dd.define_domains(prof, prof_uni, sub, fwd, bck,
                                        do_null2=self.null2,
                                        rng=self._rng)
            for d in res.domains:
                self._make_longtarget_hit(
                    prof, prof_uni, job["sq"], d, sub, job["a"], Ls,
                    job["win_start"], job["orig_len"], job["strand"],
                    job["seqidx"], max_length, nullsc, hits, res)

    def _device_gates(self, prof: Profile, pend: List[dict]):
        """Batched device filter scores for a set of subwindows: exact
        quantized MSV [n] (the kernel :mod:`ops.kernels` picks) plus f32
        Viterbi/Forward prefilter scores [n] from the XLA scans."""
        from ..ops import batch as B
        from ..engine import _fetch_all, _pad_b

        key = getattr(prof, "_lt_device_cache", None)
        if key is None or key[0] != prof.M:
            profs = [prof] * 8
            pb = B.ProfileBatch(profs, Mp=B.round_up(prof.M, 32))
            prof._lt_device_cache = (prof.M, pb)
        else:
            pb = key[1]

        n = len(pend)
        lens = np.zeros(_pad_b(n), dtype=np.int64)
        lens[:n] = [len(j["sub"]) for j in pend]
        # power-of-two widths and the engine's batch ladder bound the
        # number of compiled shapes across subwindow mixes
        Lmax = 1 << max(6, int(lens.max() - 1).bit_length())
        codes = np.full((len(lens), Lmax), self.alphabet.nonresidue_code,
                        dtype=np.uint8)
        for r, j in enumerate(pend):
            codes[r, : lens[r]] = j["sub"]
        dev = B.SeqDevice(codes, lens)
        usc = B.msv_scores(pb, codes, lens, dev)[0]
        xEj = np.float32(math.log(0.5))
        args = pb.device("msc", "isc", "tMM", "tIM", "tDM", "tMD", "tDD",
                         "tBM", "tMI", "tII", "kmask")
        vit_d = B._viterbi_kernel(dev.codes, dev.mask_b, *args, xEj, xEj,
                                  dev.loop, dev.move)
        fwd_d = B._forward_kernel(dev.codes, dev.mask_b, *args, xEj, xEj,
                                  dev.loop, dev.move)
        vit_s, fwd_s = _fetch_all([vit_d, fwd_d])
        return (np.asarray(usc, np.float64)[:n],
                np.asarray(vit_s, np.float64)[0, :n],
                np.asarray(fwd_s, np.float64)[0, :n])

    def _make_longtarget_hit(self, prof, prof_uni, sq, d, sub, sub_start,
                             window_len, win_start, orig_len, strand, seqidx,
                             max_length, nullsc_win, hits, res) -> None:
        """Build one hit from one envelope (nhmmer hit-per-envelope
        semantics with the window->envelope length-model renormalization
        of ``p7_pipeline.c`` long-target postprocessing)."""
        env_len = d.jenv - d.ienv + 1
        ali_len = d.jali - d.iali + 1 if d.jali >= d.iali else 0
        if ali_len < 2:
            return
        wl = float(window_len)
        eml = float(max(env_len, max_length))
        ev = prof.evparam.astype(np.float64)

        bitscore = d.envsc
        # renormalize the unihit length model from window_len to
        # max(env_len, max_length)
        bitscore -= 2 * math.log(2.0 / (wl + 2.0))
        bitscore -= (env_len - ali_len) * math.log(wl / (wl + 2.0))
        bitscore += 2 * math.log(2.0 / (eml + 2.0))
        bitscore += (eml - ali_len) * math.log(eml / (eml + 2.0))
        nullsc = eml * math.log(eml / (eml + 1.0)) + math.log(1.0 / (eml + 1.0))

        if self.null2:
            dombias = self._composition_bias(
                prof_uni, sub[d.ienv - 1: d.jenv], d.envsc)
        else:
            dombias = 0.0
        score = (bitscore - (nullsc + dombias)) / LOG2
        lnP = float(exp_logsurv(score, ev[4], ev[5]))

        # map envelope/alignment coordinates back to original-strand
        # coordinates: positions are 1-based within the subwindow, the
        # subwindow starts at `sub_start` within the (possibly
        # reverse-complemented) window, and the window anchors at
        # `win_start` on the original strand
        def orig(pos_in_sub: int) -> int:
            pos_in_win = sub_start - 1 + pos_in_sub
            if strand == "+":
                return win_start + pos_in_win - 1
            return win_start - pos_in_win + 1

        ienv, jenv = orig(d.ienv), orig(d.jenv)
        iali, jali = orig(d.iali), orig(d.jali)

        hit = Hit(hits, sq.name, sq.accession or None,
                  sq.description or None, orig_len,
                  score=float(score), pre_score=float(
                      (bitscore - nullsc) / LOG2),
                  sum_score=float(score), lnP=lnP,
                  nexpected=res.nexpected, nregions=res.nregions,
                  nclustered=res.nclustered, noverlaps=res.noverlaps,
                  nenvelopes=res.nenvelopes)
        ali = self._make_alignment(prof, _SubseqView(sq, sub), d)
        ali.target_from = iali
        ali.target_to = jali
        ali.target_length = orig_len
        dom = Domain(hit, ienv, jenv, iali, jali,
                     score=float(score), bias=float(dombias),
                     correction=float(d.domcorrection),
                     envelope_score=float(bitscore), oasc=d.oasc,
                     lnP=lnP, alignment=ali)
        hit.domains.append(dom)
        hit.best_domain_idx = 0
        hits.hits.append(hit)

    def _seed_threshold(self, prof: Profile, q, xBv: int,
                        max_length: int) -> int:
        """Calibrate the SSV seed threshold for one profile: binary-search
        the smallest quantized diagonal score whose crossing count on a
        fixed background-sampled sequence is at most ``F1 * N /
        max_length`` (i.e. noise seeds at the F1 rate per max_length
        window).  Cached on the profile."""
        cache = getattr(prof, "_ssv_seed_thresh", None)
        if cache is None:
            cache = prof._ssv_seed_thresh = {}
        key = (max_length, self.F1)
        if key in cache:
            return cache[key]
        K = self.alphabet.K
        f = self.background.residue_frequencies[:K]
        rng = np.random.default_rng(4242)
        N = 1 << 18
        sample = rng.choice(K, size=N, p=f / f.sum()).astype(np.uint8)
        target = self.F1 * N / float(max_length)
        lo, hi = xBv + 1, 256
        while lo < hi:
            mid = (lo + hi) // 2
            c = len(_ssv_seed_positions(q, sample, xBv, mid))
            if c <= target:
                hi = mid
            else:
                lo = mid + 1
        cache[key] = lo
        return lo

    def _composition_bias(self, prof_uni: Profile, env: np.ndarray,
                          envsc: float) -> float:
        """Biased-composition correction for one envelope: the drop in the
        envelope Forward score when the match emission odds are rescored
        against a background set to the envelope's own residue composition
        (the long-target replacement for the protein pipeline's null2;
        always >= 0)."""
        K = self.alphabet.K
        valid = env[env < K]
        if len(valid) == 0:
            return 0.0
        cnt = np.bincount(valid, minlength=K).astype(np.float64)
        f0 = self.background.residue_frequencies[:K]
        fprime = cnt / cnt.sum()
        if np.any(fprime <= 0.0):
            fprime = (cnt + 1.0) / (cnt.sum() + K)
        adj = np.log(f0 / fprime)
        prof2 = prof_uni.copy()
        prof2.msc[:K, :] = prof_uni.msc[:K, :] + adj[:, None]
        envsc2 = ref.forward(prof2, env).score
        return max(0.0, float(envsc - envsc2))


class _SubseqView:
    """Minimal sequence view over a subwindow for alignment display."""

    __slots__ = ("name", "accession", "description", "sequence")

    def __init__(self, sq, sub):
        self.name = sq.name
        self.accession = sq.accession
        self.description = sq.description
        self.sequence = sub

    def __len__(self):
        return len(self.sequence)


def _ssv_seed_positions(q, dsq: np.ndarray, xBv: int,
                        thresh: int) -> np.ndarray:
    """Positions where the quantized SSV diagonal max crosses ``thresh``
    (native kernel; NumPy fallback)."""
    from ..ops import native
    if native.available():
        return native.ssv_seed(q, dsq, xBv, thresh)
    M = q.M
    cost = q.cost
    entry = min(xBv + q.bias_b, 255)
    mpv = np.zeros(M, dtype=np.int32)
    out = []
    for i in range(1, len(dsq) + 1):
        c = cost[dsq[i - 1]]
        sv = np.empty(M, dtype=np.int32)
        sv[0] = entry
        np.minimum(np.maximum(mpv[:-1], xBv) + q.bias_b, 255, out=sv[1:])
        sv = np.maximum(sv - c, 0)
        if int(sv.max()) >= thresh:
            out.append(i)
            sv[:] = 0
        mpv = sv
    return np.asarray(out, dtype=np.int64)


def _remove_duplicates(hits: TopHits) -> None:
    """Drop duplicate hits arising from overlapping windows: same target,
    same strand, overlapping alignment coordinates -> keep the best
    E-value (``p7_tophits_RemoveDuplicates`` semantics).  Requires hits
    sorted by seqidx."""
    kept: List[Hit] = []
    for h in hits.hits:
        d = h.domains[h.best_domain_idx]
        lo, hi = sorted((d.ali_from, d.ali_to))
        st = "+" if d.ali_from <= d.ali_to else "-"
        dup = None
        for k in kept:
            if k.name != h.name:
                continue
            kd = k.domains[k.best_domain_idx]
            klo, khi = sorted((kd.ali_from, kd.ali_to))
            kst = "+" if kd.ali_from <= kd.ali_to else "-"
            if kst != st:
                continue
            if min(hi, khi) - max(lo, klo) >= 0:
                dup = k
                break
        if dup is None:
            kept.append(h)
        elif h.lnP < dup.lnP:
            kept[kept.index(dup)] = h
    hits.hits = kept
