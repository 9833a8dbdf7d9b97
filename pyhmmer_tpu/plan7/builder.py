"""Model construction: the hmmbuild/phmmer engine.

Mirrors ``pyhmmer.plan7.Builder`` (reference ``src/pyhmmer/plan7.pyx:
605-1150``; C semantics of ``p7_builder.c``/``seqmodel.c``/``eweight.c``):

* ``build(seq, bg)``      -- single-sequence query models (phmmer):
  substitution-matrix conditional probabilities + popen/pextend gap costs
  (``p7_SingleBuilder``/``p7_Seqmodel``)
* ``build_msa(msa, bg)``  -- MSA models (hmmbuild): fast/hand
  architecture, PB sequence weighting, entropy-weighted effective
  sequence number, Dirichlet-prior parameter estimation (``p7_Builder``)
* E-value calibration by simulation (``p7_Lambda``/``p7_MSVMu``/
  ``p7_ViterbiMu``/``p7_Tau``): random background sequences are scored
  with the batched kernels and Gumbel/exponential-tail parameters fitted
  on host -- embarrassingly parallel on the device.
"""

from __future__ import annotations

import math
import numpy as np
from typing import Optional, Tuple

from ..easel.alphabet import Alphabet
from ..easel.sequence import DigitalSequence
from .hmm import HMM, HMMFlags, Transitions as T
from .background import Background
from .profile import Profile

__all__ = ["Builder"]

# BLOSUM62 in half-bit units, row/col order ACDEFGHIKLMNPQRSTVWY
_BLOSUM62 = """
 4  0 -2 -1 -2  0 -2 -1 -1 -1 -1 -2 -1 -1 -1  1  0  0 -3 -2
 0  9 -3 -4 -2 -3 -3 -1 -3 -1 -1 -3 -3 -3 -3 -1 -1 -1 -2 -2
-2 -3  6  2 -3 -1 -1 -3 -1 -4 -3  1 -1  0 -2  0 -1 -3 -4 -3
-1 -4  2  5 -3 -2  0 -3  1 -3 -2  0 -1  2  0  0 -1 -2 -3 -2
-2 -2 -3 -3  6 -3 -1  0 -3  0  0 -3 -4 -3 -3 -2 -2 -1  1  3
 0 -3 -1 -2 -3  6 -2 -4 -2 -4 -3  0 -2 -2 -2  0 -2 -3 -2 -3
-2 -3 -1  0 -1 -2  8 -3 -1 -3 -2  1 -2  0  0 -1 -2 -3 -2  2
-1 -1 -3 -3  0 -4 -3  4 -3  2  1 -3 -3 -3 -3 -2 -1  3 -3 -1
-1 -3 -1  1 -3 -2 -1 -3  5 -2 -1  0 -1  1  2  0 -1 -2 -3 -2
-1 -1 -4 -3  0 -4 -3  2 -2  4  2 -3 -3 -2 -2 -2 -1  1 -2 -1
-1 -1 -3 -2  0 -3 -2  1 -1  2  5 -2 -2  0 -1 -1 -1  1 -1 -1
-2 -3  1  0 -3  0  1 -3  0 -3 -2  6 -2  0  0  1  0 -3 -4 -2
-1 -3 -1 -1 -4 -2 -2 -3 -1 -3 -2 -2  7 -1 -2 -1 -1 -2 -4 -3
-1 -3  0  2 -3 -2  0 -3  1 -2  0  0 -1  5  1  0 -1 -2 -2 -1
-1 -3 -2  0 -3 -2  0 -3  2 -2 -1  0 -2  1  5 -1 -1 -3 -3 -2
 1 -1  0  0 -2  0 -1 -2  0 -2 -1  1 -1  0 -1  4  1 -2 -3 -2
 0 -1 -1 -1 -2 -2 -2 -1 -1 -1 -1  0 -1 -1 -1  1  5  0 -2 -2
 0 -1 -3 -2 -1 -3 -3  3 -2  1  1 -3 -2 -2 -3 -2  0  4 -3 -1
-3 -2 -4 -3  1 -2 -2 -3 -3 -2 -1 -4 -4 -2 -3 -3 -2 -3 11  2
-2 -2 -3 -2  3 -3  2 -1 -2 -1 -1 -2 -3 -1 -2 -2 -2 -1  2  7
"""


def _parse_matrix(text: str) -> np.ndarray:
    rows = [[float(x) for x in line.split()]
            for line in text.strip().splitlines()]
    return np.array(rows)


_MATRICES = {"BLOSUM62": _parse_matrix(_BLOSUM62)}


def probify_matrix(S: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Solve the implicit probabilistic basis of a score matrix
    (``esl_scorematrix_ProbifyGivenBG``): find lambda with
    ``sum_ab f_a f_b exp(lambda s_ab) = 1``, return conditional
    probabilities ``p(b|a) = f_b exp(lambda s_ab)``."""
    def Z(lam):
        return float((f[:, None] * f[None, :] * np.exp(lam * S)).sum())
    lo, hi = 1e-6, 10.0
    while Z(hi) < 1.0:
        hi *= 2
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if Z(mid) < 1.0:
            lo = mid
        else:
            hi = mid
    lam = 0.5 * (lo + hi)
    cond = f[None, :] * np.exp(lam * S)
    cond /= cond.sum(axis=1, keepdims=True)
    return cond


class Builder:
    """Profile HMM construction engine."""

    def __init__(
        self,
        alphabet: Alphabet,
        *,
        architecture: str = "fast",
        weighting: str = "pb",
        effective_number="entropy",
        prior_scheme: str = "alphabet",
        symfrac: float = 0.5,
        fragthresh: float = 0.5,
        wid: float = 0.62,
        esigma: float = 45.0,
        eid: float = 0.62,
        ere: Optional[float] = None,
        popen: Optional[float] = None,
        pextend: Optional[float] = None,
        score_matrix: Optional[str] = None,
        window_length: Optional[int] = None,
        window_beta: Optional[float] = None,
        seed: int = 42,
        EmL: int = 200, EmN: int = 200,
        EvL: int = 200, EvN: int = 200,
        EfL: int = 100, EfN: int = 200, Eft: float = 0.04,
    ):
        if architecture not in ("fast", "hand"):
            raise ValueError(f"invalid architecture: {architecture!r}")
        if weighting not in ("pb", "gsc", "blosum", "none", "given"):
            raise ValueError(f"invalid weighting: {weighting!r}")
        self.alphabet = alphabet
        self.architecture = architecture
        self.weighting = weighting
        self.effective_number = effective_number
        self.prior_scheme = prior_scheme
        self.symfrac = symfrac
        self.fragthresh = fragthresh
        self.wid = wid
        self.esigma = esigma
        self.eid = eid
        # entropy targets (p7_ETARGET_*)
        if ere is not None:
            self.ere = ere
        elif alphabet.is_nucleic():
            self.ere = 0.62   # p7_ETARGET_DNA
        else:
            self.ere = 0.59   # p7_ETARGET_AMINO
        self.popen = popen if popen is not None else (
            0.03125 if alphabet.is_nucleic() else 0.02)
        self.pextend = pextend if pextend is not None else (
            0.75 if alphabet.is_nucleic() else 0.4)
        self.score_matrix = score_matrix or (
            "DNA1" if alphabet.is_nucleic() else "BLOSUM62")
        self.window_length = window_length
        self.window_beta = window_beta if window_beta is not None else 1e-7
        self.seed = seed
        self.EmL, self.EmN = EmL, EmN
        self.EvL, self.EvN = EvL, EvN
        self.EfL, self.EfN, self.Eft = EfL, EfN, Eft
        self.randomness = np.random.default_rng(seed)

    def copy(self) -> "Builder":
        """A fresh Builder carrying every configuration option (the app
        layer calls this once per query; dropping options here silently
        discards user settings -- reference ``Builder.copy``,
        plan7.pyx:1093-1118)."""
        return Builder(
            self.alphabet, architecture=self.architecture,
            weighting=self.weighting,
            effective_number=self.effective_number,
            prior_scheme=self.prior_scheme,
            symfrac=self.symfrac, fragthresh=self.fragthresh,
            wid=self.wid, esigma=self.esigma, eid=self.eid,
            ere=self.ere, popen=self.popen, pextend=self.pextend,
            score_matrix=self.score_matrix,
            window_length=self.window_length,
            window_beta=self.window_beta, seed=self.seed,
            EmL=self.EmL, EmN=self.EmN, EvL=self.EvL, EvN=self.EvN,
            EfL=self.EfL, EfN=self.EfN, Eft=self.Eft)

    # --- single sequence (phmmer) ------------------------------------------

    def build(self, sequence: DigitalSequence, background: Background
              ) -> Tuple[HMM, "Profile", "Profile"]:
        """Build a query model from one sequence (``p7_SingleBuilder``)."""
        if sequence.alphabet != self.alphabet:
            raise ValueError("alphabet mismatch")
        dsq = sequence.sequence
        K = self.alphabet.K
        keep = dsq < K                    # canonical residues only
        core = dsq[keep]
        M = len(core)
        if M == 0:
            raise ValueError("cannot build a model from an empty sequence")
        if self.alphabet.is_amino():
            S = _MATRICES[self.score_matrix.upper()]
        else:
            # simple DNA identity-ish matrix
            S = np.full((K, K), -3.0)
            np.fill_diagonal(S, 1.0)
        cond = probify_matrix(S, background.residue_frequencies)

        hmm = HMM(self.alphabet, M, name=sequence.name)
        hmm.accession = sequence.accession or None
        hmm.description = sequence.description or None
        hmm.mat[1:] = cond[core]
        hmm.ins[:] = background.residue_frequencies
        # transitions from popen/pextend (p7_Seqmodel)
        hmm.t[:, T.MM] = 1.0 - 2.0 * self.popen
        hmm.t[:, T.MI] = self.popen
        hmm.t[:, T.MD] = self.popen
        hmm.t[:, T.IM] = 1.0 - self.pextend
        hmm.t[:, T.II] = self.pextend
        hmm.t[:, T.DM] = 1.0 - self.pextend
        hmm.t[:, T.DD] = self.pextend
        hmm.t[M, T.MM] = 1.0 - self.popen   # last node: no D_{M+1}
        hmm.t[M, T.MD] = 0.0
        hmm.t[M, T.DM] = 1.0
        hmm.t[M, T.DD] = 0.0
        hmm.mat[0] = 0.0
        hmm.mat[0, 0] = 1.0
        hmm.nseq = 1
        hmm.eff_nseq = 1.0
        hmm.checksum = None
        hmm.set_consensus()
        hmm.set_composition()
        self.calibrate(hmm, background)
        prof = Profile(M, self.alphabet).configure(hmm, background, 400)
        return hmm, prof, prof

    # --- MSA (hmmbuild) -----------------------------------------------------

    def build_msa(self, msa, background: Background
                  ) -> Tuple[HMM, "Profile", "Profile"]:
        """Build a model from a multiple alignment (``p7_Builder``,
        reference ``plan7.pyx:1016-1092``; C pipeline: relative weights ->
        fragment marking -> Fast/Handmodelmaker fake traces + doctoring ->
        trace counting -> effective sequence number -> mixture-Dirichlet
        parameter estimation -> calibration).

        Golden anchor: rebuilding ``tests/data/msa/LuxC.sto`` with
        defaults reproduces ``tests/data/hmms/txt/LuxC.hmm`` (M=400,
        EFFN~1.99, mat/ins/t at file precision) --
        ``tests/test_builder_golden.py``."""
        from .priors import for_alphabet, parameter_estimation
        alphabet = self.alphabet
        K = alphabet.K
        ali = np.ascontiguousarray(msa.codes)        # [nseq, alen] uint8
        nseq, alen = ali.shape
        if nseq == 0 or alen == 0:
            raise ValueError("cannot build a model from an empty MSA")
        gap = alphabet.gap_code
        nonres = alphabet.nonresidue_code
        misscode = alphabet.missing_code
        residue = (ali != gap) & (ali != nonres) & (ali != misscode)

        # -- relative sequence weights ----------------------------------
        if self.weighting == "given":
            weights = (np.asarray(msa.weights, dtype=np.float64)
                       if msa.weights is not None else np.ones(nseq))
        elif self.weighting == "pb":
            weights = _pb_weights(ali, K, gap)
        elif self.weighting == "gsc":
            weights = _gsc_weights(ali, K)
        elif self.weighting == "blosum":
            weights = _blosum_weights(ali, K, self.wid)
        else:                                        # "none"
            weights = np.ones(nseq)

        # -- fragment marking (esl_msa_MarkFragments): leading/trailing
        # cells outside the aligned span become missing data, so
        # fragments contribute no flanking delete transitions ----------
        missing = ~residue & (ali == misscode)
        span_lo = np.full(nseq, 0)
        span_hi = np.full(nseq, alen - 1)
        for i in range(nseq):
            idx = np.flatnonzero(residue[i])
            if len(idx) == 0:
                missing[i, :] = True
                continue
            span_lo[i], span_hi[i] = idx[0], idx[-1]
            if (idx[-1] - idx[0] + 1) < self.fragthresh * alen:
                missing[i, : idx[0]] = True
                missing[i, idx[-1] + 1:] = True

        # -- architecture: consensus column assignment ------------------
        if self.architecture == "hand":
            if msa.reference is None:
                raise ValueError("hand architecture requires an RF line")
            rf = np.frombuffer(msa.reference, dtype="S1")
            cons_cols = np.array([c not in (b".", b"-", b"~", b" ")
                                  for c in rf])
            if len(cons_cols) != alen:
                raise ValueError("RF line length != alignment length")
        else:
            # p7_Fastmodelmaker: weighted residue fraction >= symfrac,
            # missing cells excluded from numerator AND denominator
            use = ~missing
            r = (weights[:, None] * (residue & use)).sum(axis=0)
            totw = (weights[:, None] * use).sum(axis=0)
            with np.errstate(invalid="ignore"):
                cons_cols = (r > 0) & (r / np.maximum(totw, 1e-30)
                                       >= self.symfrac)
        M = int(cons_cols.sum())
        if M == 0:
            raise ValueError("no consensus columns in alignment")
        cons_idx = np.flatnonzero(cons_cols)
        col_of = np.full(alen, -1)
        col_of[cons_idx] = np.arange(1, M + 1)

        # -- fake traces + doctoring + weighted counting ----------------
        mat = np.zeros((M + 1, K))
        ins = np.zeros((M + 1, K))
        t = np.zeros((M + 1, 7))
        degen = alphabet.degen
        dcount = degen.sum(axis=1)
        for s in range(nseq):
            ev = _fake_trace(ali[s], missing[s], col_of, residue[s])
            ev = _trace_doctor(ev)
            _count_trace(ev, float(weights[s]), M, K,
                         degen, dcount, mat, ins, t)

        # -- effective sequence number ----------------------------------
        prior = for_alphabet(alphabet, self.prior_scheme)
        eff = float(nseq)
        expnt = None
        if isinstance(self.effective_number, (int, float)):
            eff = float(self.effective_number)
        elif self.effective_number == "entropy":
            etarget = max(
                self.ere,
                (self.esigma
                 - math.log2(2.0 / (M * (M + 1)))) / M)   # J5/36 formula
            eff = _entropy_weight_prior(mat[1:], float(nseq),
                                        background, prior, etarget)
        elif self.effective_number == "clust":
            eff = float(len(_single_linkage_clusters(ali, K, self.eid)))
        elif self.effective_number == "exp":
            etarget = max(
                self.ere,
                (self.esigma
                 - math.log2(2.0 / (M * (M + 1)))) / M)
            expnt = _entropy_exponent(mat[1:], background, prior, etarget)
        # "none" keeps eff = nseq

        if expnt is not None:
            # p7_hmm_ScaleExponential: each count row's total n -> n^exp
            for block in (mat, ins, t[:, 0:3], t[:, 3:5], t[:, 5:7]):
                _scale_exponential(block, expnt)
            eff = float(mat[1:].sum(axis=1).mean()) if M else 1.0
        else:
            scale = eff / nseq
            mat *= scale
            ins *= scale
            t *= scale

        # -- parameter estimation (mixture Dirichlet posterior means) ---
        hmm = HMM(self.alphabet, M, name=msa.name or b"aligned-model")
        hmm.mat[:] = mat
        hmm.ins[:] = ins
        hmm.t[:] = t
        parameter_estimation(hmm, prior)

        # -- annotation -------------------------------------------------
        hmm.map = np.zeros(M + 1, dtype=np.int32)
        hmm.map[1:] = cons_idx + 1                   # 1-based columns
        hmm.flags |= HMMFlags.MAP
        hmm.nseq = nseq
        hmm.eff_nseq = eff
        try:
            hmm.checksum = msa.checksum()
        except (AttributeError, TypeError):
            hmm.checksum = None
        hmm.set_consensus()
        hmm.set_composition()
        self.calibrate(hmm, background)
        prof = Profile(M, self.alphabet).configure(hmm, background, 400)
        return hmm, prof, prof

    # --- calibration ---------------------------------------------------------

    def calibrate(self, hmm: HMM, background: Background) -> None:
        """Determine E-value parameters by simulation (``p7_Calibrate``,
        ``evalues.c`` role):

        * lambda from the model's mean match relative entropy
          (``p7_Lambda``: ``log 2 + 1.44 / (M * H)``);
        * MSV / Viterbi Gumbel mu by ML location fits with that fixed
          lambda (``p7_MSVMu`` / ``p7_ViterbiMu`` +
          ``esl_gumbel_FitCompleteLoc``) over ``EmN`` / ``EvN`` random
          background sequences -- scored with the QUANTIZED MSV filter
          like the reference (the vectorized filters are what hmmbuild
          calibrates);
        * Forward tau from the ML exponential fit of the highest-``Eft``
          score tail (``p7_Tau`` + ``esl_exp_FitComplete``), shifted so
          the full-distribution survival matches:
          ``tau = mu_tail + log(Eft) / lambda``.

        The random-sequence scoring is batched through the engine's
        device kernels (``ops.batch``), a handful of kernel launches per
        model; reported mu/tau carry the usual
        +-0.1..0.5-bit simulation sampling noise vs a reference
        hmmbuild run (different RNG streams; pinned by
        ``tests/test_calibration.py``)."""
        from ..ops import batch as OB
        from .fitting import gumbel_fit_complete_loc, exp_fit_complete

        lam = math.log(2.0) + 1.44 / (hmm.M * max(
            hmm.mean_match_relative_entropy(), 0.1))
        rng = np.random.default_rng(self.seed)
        f = np.asarray(background.residue_frequencies, dtype=np.float64)
        fprob = f / f.sum()
        prof = Profile(hmm.M, hmm.alphabet).configure(hmm, background,
                                                      self.EmL)
        pb = OB.ProfileBatch([prof], Mp=OB.round_up(hmm.M, 32))

        def sample_batch(L, N):
            codes = rng.choice(len(fprob), size=(N, L),
                               p=fprob).astype(np.uint8)
            lengths = np.full(N, L, dtype=np.int64)
            nullsc = background.null_one(L)
            return codes, lengths, nullsc

        LOG2 = math.log(2.0)
        codes, lens, nullsc = sample_batch(self.EmL, self.EmN)
        msv = (OB.msv_scores(pb, codes, lens)[0] - nullsc) / LOG2
        mmu = gumbel_fit_complete_loc(msv, lam)

        # ViterbiFilter semantics: the int16 filter approximates the
        # NN/CC/JJ loop costs as ZERO and subtracts a 3.0-nat constant
        # (same convention as the quantized MSV filter).  Calibrating
        # with the true length model instead leaves vmu ~0.5 bits high
        # vs a reference hmmbuild (validated on the bundled LuxC:
        # VF-semantics vmu lands on the reference value to within
        # simulation noise).
        import jax.numpy as _jnp
        codes, lens, nullsc = sample_batch(self.EvL, self.EvN)
        devv = OB.SeqDevice(codes, lens)
        xEj = np.float32(math.log(0.5))
        vout = OB._viterbi_kernel(
            devv.codes, devv.mask_b,
            *pb.device("msc", "isc", "tMM", "tIM", "tDM", "tMD", "tDD",
                       "tBM", "tMI", "tII", "kmask"),
            xEj, xEj, _jnp.zeros_like(devv.loop), devv.move)
        vit = (np.asarray(vout, np.float64)[0] - 3.0 - nullsc) / LOG2
        vmu = gumbel_fit_complete_loc(vit, lam)

        codes, lens, nullsc = sample_batch(self.EfL, self.EfN)
        # tau scoring goes through HMMER's FLogsum 16k-entry table
        # (logsum.c, init at plan7.pyx:9655): the truncated-index lookup
        # overestimates every logsum by up to 1/500 nat, and a real
        # hmmbuild's tau carries that accumulated offset -- an exact
        # logsumexp Forward here calibrates tau a few tenths of a bit
        # low (round-4 verdict #6; validated on the bundled LuxC
        # evparams, tests/test_calibration.py).
        from ..ops import native as _native
        if _native.available():
            prof_f = Profile(hmm.M, hmm.alphabet).configure(
                hmm, background, self.EfL)
            fwd = np.array([
                _native.forward_flogsum(prof_f, codes[i])
                for i in range(len(codes))])
            fwd = (fwd - nullsc) / LOG2
        else:
            fwd = (OB.forward_scores(pb, codes, lens)[0] - nullsc) / LOG2
        srt = np.sort(fwd)[::-1]
        ntail = max(2, int(round(self.Eft * len(srt))))
        mu_tail, _tail_lam = exp_fit_complete(srt[:ntail])
        # HMMER convention: the survival function uses the calibrated
        # lambda, not the tail's own ML rate; tau shifts the location so
        # the tail carries exactly Eft of the mass
        tau = mu_tail + math.log(self.Eft) / lam
        hmm.evparam[:] = [mmu, lam, vmu, lam, tau, lam]
        hmm.flags |= HMMFlags.STATS

    # properties matching the reference API
    @property
    def seed_value(self):
        return self.seed


def _pb_weights(ali: np.ndarray, K: int, gap: int,
                symfrac: float = 0.5, fragthresh: float = 0.5
                ) -> np.ndarray:
    """Position-based (Henikoff) sequence weights over CONSENSUS columns
    (``esl_msaweight_PB``, Easel >= 0.47 scheme: fragments marked by the
    span rule, consensus = columns whose unweighted residue fraction
    reaches ``symfrac`` with fragment flanks excluded, then classic PB
    contributions summed over those columns only; normalized to mean 1).
    Validated against a reference LuxC.hmm rebuild
    (tests/test_builder_golden.py) -- whole-alignment PB gives visibly
    different weights."""
    nseq, alen = ali.shape
    residue = ali != gap
    flank = np.zeros_like(residue)
    for i in range(nseq):
        idx = np.flatnonzero(residue[i])
        if len(idx) == 0:
            flank[i, :] = True
        elif (idx[-1] - idx[0] + 1) < fragthresh * alen:
            flank[i, : idx[0]] = True
            flank[i, idx[-1] + 1:] = True
    use = ~flank
    r = (residue & use).sum(axis=0)
    tot = use.sum(axis=0)
    cons = (r > 0) & (r / np.maximum(tot, 1) >= symfrac)

    w = np.zeros(nseq)
    for a in np.flatnonzero(cons):
        col = ali[:, a]
        res = col < K
        if not res.any():
            continue
        vals, counts = np.unique(col[res], return_counts=True)
        nr = len(vals)
        contrib = np.zeros(nseq)
        for v, c in zip(vals, counts):
            contrib[col == v] = 1.0 / (nr * c)
        w += contrib
    if w.sum() == 0:
        return np.ones(nseq)
    w *= nseq / w.sum()
    return w


# ---------------------------------------------------------------------------
# Fake traces from an MSA (build.c fake_tracebacks / trace_doctor /
# p7_trace_Count semantics)
# ---------------------------------------------------------------------------

def _fake_trace(row: np.ndarray, missing: np.ndarray, col_of: np.ndarray,
                residue: np.ndarray) -> list:
    """Core-model state path implied by one aligned sequence: a list of
    ``(state, k, code)`` with state in 'MDI' (``build.c
    fake_tracebacks``).  Missing cells (fragment flanks) emit nothing --
    their transitions are simply absent, reproducing the reference's
    skip-over-X counting."""
    ev = []
    node = 0
    for a in range(len(row)):
        if missing[a]:
            kk = col_of[a]
            if kk > 0:
                node = kk           # track position through missing flank
            continue
        kk = col_of[a]
        if kk > 0:
            ev.append(("M" if residue[a] else "D", kk, int(row[a])))
            node = kk
        elif residue[a]:
            ev.append(("I", node, int(row[a])))
    return ev


def _trace_doctor(ev: list) -> list:
    """Remove the Plan7-illegal D->I and I->D transitions (``build.c
    trace_doctor``): a D,I pair collapses to M at the D's node carrying
    the I's residue; an I,D pair collapses to M at the D's node."""
    out = []
    z = 0
    n = len(ev)
    while z < n:
        if z + 1 < n and ev[z][0] == "D" and ev[z + 1][0] == "I":
            out.append(("M", ev[z][1], ev[z + 1][2]))
            z += 2
        elif z + 1 < n and ev[z][0] == "I" and ev[z + 1][0] == "D":
            out.append(("M", ev[z + 1][1], ev[z][2]))
            z += 2
        else:
            out.append(ev[z])
            z += 1
    return out


def _count_trace(ev: list, w: float, M: int, K: int,
                 degen: np.ndarray, dcount: np.ndarray,
                 mat: np.ndarray, ins: np.ndarray, t: np.ndarray) -> None:
    """Weighted emission/transition counting for one doctored trace
    (``p7_trace_Count``): B->entry and exit->E are only counted at
    nodes 1/M (wing-retracted fragment entries/exits contribute
    nothing); degenerate residues distribute their weight evenly over
    member canonicals (``esl_abc_FCount``)."""
    if not ev:
        return

    def emit(ctr, k, code):
        if code < K:
            ctr[k, code] += w
        elif dcount[code] > 0:
            ctr[k, degen[code]] += w / dcount[code]

    # entry from B (= M0)
    s0, k0, c0 = ev[0]
    if s0 == "M" and k0 == 1:
        t[0, T.MM] += w
    elif s0 == "D" and k0 == 1:
        t[0, T.MD] += w
    elif s0 == "I" and k0 == 0:
        t[0, T.MI] += w
    # else: wing-retracted entry (fragment), not counted

    prev = None
    for e in ev:
        s, k, c = e
        if s == "M":
            emit(mat, k, c)
        elif s == "I":
            emit(ins, k, c)
        if prev is not None:
            ps, pk, _ = prev
            if ps == "M":
                if s == "M":
                    t[pk, T.MM] += w
                elif s == "D":
                    t[pk, T.MD] += w
                else:
                    t[pk, T.MI] += w
            elif ps == "I":
                if s == "M":
                    t[pk, T.IM] += w
                else:
                    t[pk, T.II] += w
            else:
                if s == "M":
                    t[pk, T.DM] += w
                else:
                    t[pk, T.DD] += w
        prev = e
    # exit to E
    sl, kl, _ = ev[-1]
    if kl == M:
        if sl == "M":
            t[M, T.MM] += w
        elif sl == "D":
            t[M, T.DM] += w
    # else: wing-retracted exit, not counted


# ---------------------------------------------------------------------------
# Relative weighting schemes (esl_msaweight_{PB,GSC,BLOSUM})
# ---------------------------------------------------------------------------

def _pairwise_identity(ali: np.ndarray, K: int) -> np.ndarray:
    """Fractional pairwise identity matrix (``esl_dst_XPairId``:
    identical canonical pairs / min(rlen_i, rlen_j))."""
    nseq = ali.shape[0]
    canon = ali < K
    rlen = canon.sum(axis=1)
    pid = np.zeros((nseq, nseq))
    for i in range(nseq):
        both = canon[i][None, :] & canon
        nid = ((ali == ali[i][None, :]) & both).sum(axis=1)
        denom = np.minimum(rlen[i], rlen)
        with np.errstate(invalid="ignore"):
            pid[i] = np.where(denom > 0, nid / np.maximum(denom, 1), 0.0)
    return pid


def _single_linkage_clusters(ali: np.ndarray, K: int,
                             maxid: float) -> list:
    """Single-linkage clusters linking pairs with identity > maxid
    (``esl_msacluster_SingleLinkage``); returns a list of index lists."""
    nseq = ali.shape[0]
    pid = _pairwise_identity(ali, K)
    parent = list(range(nseq))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i in range(nseq):
        for j in range(i + 1, nseq):
            if pid[i, j] > maxid:
                parent[find(i)] = find(j)
    groups: dict = {}
    for i in range(nseq):
        groups.setdefault(find(i), []).append(i)
    return list(groups.values())


def _blosum_weights(ali: np.ndarray, K: int, wid: float) -> np.ndarray:
    """BLOSUM relative weights (``esl_msaweight_BLOSUM``): cluster by
    single linkage at identity > wid; each sequence weighs
    1/cluster_size; normalized to mean 1."""
    nseq = ali.shape[0]
    w = np.ones(nseq)
    for grp in _single_linkage_clusters(ali, K, wid):
        for i in grp:
            w[i] = 1.0 / len(grp)
    w *= nseq / w.sum()
    return w


def _gsc_weights(ali: np.ndarray, K: int) -> np.ndarray:
    """Gerstein/Sonnhammer/Chothia tree weights (``esl_msaweight_GSC``):
    UPGMA tree on pairwise-difference distances; each branch length is
    shared equally by the leaves below it; normalized to mean 1."""
    nseq = ali.shape[0]
    if nseq <= 2:
        return np.ones(nseq)
    pid = _pairwise_identity(ali, K)
    dist = 1.0 - pid

    # UPGMA with size-weighted average-linkage distance updates
    active = {i: [i] for i in range(nseq)}          # cluster -> leaves
    height = {i: 0.0 for i in range(nseq)}
    d = {(i, j): float(dist[i, j])
         for i in range(nseq) for j in range(i + 1, nseq)}
    w = np.zeros(nseq)
    nxt = nseq
    while len(active) > 1:
        (a, b), dm = min(d.items(), key=lambda kv: kv[1])
        h = dm / 2.0
        # the branch above each child spans (h - child_height); GSC
        # splits it evenly across the child's leaves
        for child in (a, b):
            blen = max(h - height[child], 0.0)
            leaves = active[child]
            for leaf in leaves:
                w[leaf] += blen / len(leaves)
        na, nb = len(active[a]), len(active[b])
        merged = active.pop(a) + active.pop(b)
        newd = {}
        for (x, y), v in d.items():
            if x in (a, b) or y in (a, b):
                continue
            newd[(x, y)] = v
        for other in active:
            da = d[(min(a, other), max(a, other))]
            db = d[(min(b, other), max(b, other))]
            newd[(min(other, nxt), max(other, nxt))] = (
                (na * da + nb * db) / (na + nb))
        active[nxt] = merged
        height[nxt] = h
        d = newd
        nxt += 1
    if w.sum() <= 0:
        return np.ones(nseq)
    w *= nseq / w.sum()
    return w


# ---------------------------------------------------------------------------
# Effective sequence number (eweight.c)
# ---------------------------------------------------------------------------

def _mean_match_re(counts_scaled: np.ndarray, background: Background,
                   prior) -> float:
    """Mean match relative entropy after parameterizing scaled counts
    (``p7_MeanMatchRelativeEntropy`` inside the eweight objective)."""
    from .priors import match_posterior
    p = match_posterior(counts_scaled, prior)
    f = background.residue_frequencies
    with np.errstate(divide="ignore", invalid="ignore"):
        kl = np.where(p > 0, p * np.log2(p / f), 0.0)
    return float(kl.sum(axis=1).mean())


def _entropy_weight_prior(counts: np.ndarray, nseq: float,
                          background: Background, prior,
                          etarget: float) -> float:
    """``p7_EntropyWeight``: bisect Neff in (0, nseq] so the mean match
    relative entropy of the prior-parameterized model hits ``etarget``
    (absolute tolerance 0.01, matching the reference rootfinder
    setting); Neff = nseq when already at/below target."""
    def f(neff):
        return _mean_match_re(counts * (neff / nseq),
                              background, prior) - etarget

    if f(nseq) <= 0.0:
        return float(nseq)
    # esl_root_Bisection convention: narrow until the bracket is inside
    # the absolute tolerance, return the FINAL MIDPOINT (reproduces the
    # reference's exact Neff grid values, e.g. LuxC EFFN 1.989990 =
    # midpoint of [1.986816, 1.993164] from (0, 13])
    lo, hi = 0.0, float(nseq)
    while hi - lo > 0.01:
        x = 0.5 * (lo + hi)
        if f(x) > 0.0:
            hi = x
        else:
            lo = x
    return 0.5 * (lo + hi)


def _entropy_exponent(counts: np.ndarray, background: Background,
                      prior, etarget: float) -> float:
    """``p7_EntropyWeight_exp``: bisect the exponent x in (0, 1] so that
    exponentially rescaled counts (row total n -> n^x) hit the relative
    entropy target."""
    def f(x):
        c = counts.copy()
        _scale_exponential(c, x)
        return _mean_match_re(c, background, prior) - etarget

    if f(1.0) <= 0.0:
        return 1.0
    lo, hi = 0.0, 1.0
    while (hi - lo) / 2.0 > 1e-3:
        x = 0.5 * (lo + hi)
        if f(x) > 0.0:
            hi = x
        else:
            lo = x
    return 0.5 * (lo + hi)


def _scale_exponential(block: np.ndarray, expnt: float) -> None:
    """``p7_hmm_ScaleExponential`` on one count block: rescale each row
    so its total n becomes n^expnt (rows with n<=0 untouched)."""
    n = block.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        fac = np.where(n > 0, n ** (expnt - 1.0), 1.0)
    block *= fac
