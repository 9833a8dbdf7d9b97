"""NumPy oracle implementations of the Plan7 dynamic programs.

These are the *reference semantics* for the device kernels (the role the
``generic_*.c`` implementations play in HMMER -- see SURVEY.md §2.5).  All
computations are float64 log-space with ``-inf`` represented as a large
negative finite value (``NEGMASS``) so that no NaN special-casing is needed
-- the same convention the JAX kernels use in float32.

DP conventions (local multihit "implicit model"):

* rows ``i = 1..L`` are target residues, columns ``k = 1..M`` model nodes
* specials per row: N, B, E, C, J
* E collects from every ``M_k`` (exit prob 1 in local mode) and from
  ``D_M``/``M_M`` at the last node
* the DD chain within a row is a prefix scan (log-space or max-plus)
"""

from __future__ import annotations

import numpy as np
from dataclasses import dataclass
from typing import Optional, Tuple

NEGMASS = -1e30  # effective -infinity


def _clamp(a: np.ndarray) -> np.ndarray:
    """Replace -inf by NEGMASS."""
    return np.where(np.isfinite(a), a, NEGMASS)


def _lse(*arrays) -> np.ndarray:
    out = arrays[0]
    for a in arrays[1:]:
        out = np.logaddexp(out, a)
    return out


def _dd_chain_logsum(m_row: np.ndarray, tMD: np.ndarray, tDD: np.ndarray) -> np.ndarray:
    """Log-space DD prefix scan.

    Given the current row's match scores ``m_row[1..M]`` and transitions,
    returns ``D[1..M]`` where ``D[k] = LSE_{j<k}( M[j] + tMD[j] +
    sum_{m=j+1}^{k-1} tDD[m] )`` -- i.e. delete states fed by any earlier
    match through a run of DD transitions.  O(M) via cumulative logaddexp.
    """
    M = len(tMD)
    # c[k] = sum of tDD[1..k-1]  (cost of the DD run ending at node k)
    c = np.zeros(M + 1)
    c[2:] = np.cumsum(tDD[1:M])
    # entries: a[j] = M[j] + tMD[j] - c[j+1]  for j = 1..M-1
    a = np.full(M + 1, NEGMASS)
    a[1:M] = m_row[1:M] + tMD[1:M] - c[2: M + 1]
    acc = np.logaddexp.accumulate(a[: M])  # acc[j] = LSE(a[1..j])
    D = np.full(M + 1, NEGMASS)
    D[2:] = acc[1:] + c[2:]
    return np.maximum(D, NEGMASS)


def _dd_chain_max(m_row: np.ndarray, tMD: np.ndarray, tDD: np.ndarray) -> np.ndarray:
    """Max-plus version of the DD prefix scan (for Viterbi)."""
    M = len(tMD)
    c = np.zeros(M + 1)
    c[2:] = np.cumsum(tDD[1:M])
    a = np.full(M + 1, NEGMASS)
    a[1:M] = m_row[1:M] + tMD[1:M] - c[2: M + 1]
    acc = np.maximum.accumulate(a[: M])
    D = np.full(M + 1, NEGMASS)
    D[2:] = acc[1:] + c[2:]
    return np.maximum(D, NEGMASS)


@dataclass
class ParserResult:
    """Special-state rows of a Forward/Backward pass (the 'parser' output)."""
    score: float                 # total score in nats
    xN: np.ndarray               # [L+1]
    xB: np.ndarray
    xE: np.ndarray
    xC: np.ndarray
    xJ: np.ndarray


@dataclass
class MatrixResult(ParserResult):
    M: np.ndarray = None         # [L+1, M+1]
    I: np.ndarray = None
    D: np.ndarray = None


def _prep(prof, dsq):
    M = prof.M
    L = len(dsq)
    msc = _clamp(prof.msc)            # [Kp, M+1]
    isc = _clamp(prof.isc)
    tr = {
        "BM": _clamp(prof.tBM), "MM": _clamp(prof.tMM), "IM": _clamp(prof.tIM),
        "DM": _clamp(prof.tDM), "MD": _clamp(prof.tMD), "DD": _clamp(prof.tDD),
        "MI": _clamp(prof.tMI), "II": _clamp(prof.tII),
    }
    x = {
        "E": _clamp(prof.xE), "N": _clamp(prof.xN),
        "J": _clamp(prof.xJ), "C": _clamp(prof.xC),
    }
    return M, L, msc, isc, tr, x


def forward(prof, dsq: np.ndarray, keep_matrix: bool = False):
    """Forward algorithm; returns parser specials (and matrices if asked).

    Equivalent to ``p7_ForwardParser`` / ``p7_GForward`` in exact log space
    (no FLogsum table approximation; cf. SURVEY.md §7 hard part 2).
    Dispatches to the native C++ kernels when available.
    """
    from . import native
    if native.available():
        return native.fwdbck(prof, dsq, keep_matrix, backward=False)
    return _forward_np(prof, dsq, keep_matrix)


def _forward_np(prof, dsq: np.ndarray, keep_matrix: bool = False):
    Mn, L, msc, isc, tr, x = _prep(prof, dsq)
    xN = np.full(L + 1, NEGMASS); xB = np.full(L + 1, NEGMASS)
    xE = np.full(L + 1, NEGMASS); xC = np.full(L + 1, NEGMASS)
    xJ = np.full(L + 1, NEGMASS)
    xN[0] = 0.0
    xB[0] = x["N"][1]  # N->B move
    mrow = np.full(Mn + 1, NEGMASS)
    irow = np.full(Mn + 1, NEGMASS)
    drow = np.full(Mn + 1, NEGMASS)
    if keep_matrix:
        Mm = np.full((L + 1, Mn + 1), NEGMASS)
        Im = np.full((L + 1, Mn + 1), NEGMASS)
        Dm = np.full((L + 1, Mn + 1), NEGMASS)

    for i in range(1, L + 1):
        xi = dsq[i - 1]
        ms = msc[xi]
        new_m = np.full(Mn + 1, NEGMASS)
        # into M_k: from M/I/D_{k-1} and B
        new_m[1:] = ms[1:] + _lse(
            mrow[:Mn] + tr["MM"],
            irow[:Mn] + tr["IM"],
            drow[:Mn] + tr["DM"],
            xB[i - 1] + tr["BM"],
        )
        new_i = np.full(Mn + 1, NEGMASS)
        new_i[1:Mn] = isc[xi][1:Mn] + _lse(
            mrow[1:Mn] + tr["MI"][1:Mn],
            irow[1:Mn] + tr["II"][1:Mn],
        )
        new_d = _dd_chain_logsum(new_m, tr["MD"], tr["DD"])
        # E: every M_k and D_k exits free in local mode
        xE[i] = _lse(
            np.logaddexp.reduce(new_m[1:]),
            np.logaddexp.reduce(new_d[1:]),
        )
        xJ[i] = np.logaddexp(xJ[i - 1] + x["J"][0], xE[i] + x["E"][0])
        xC[i] = np.logaddexp(xC[i - 1] + x["C"][0], xE[i] + x["E"][1])
        xN[i] = xN[i - 1] + x["N"][0]
        xB[i] = np.logaddexp(xN[i] + x["N"][1], xJ[i] + x["J"][1])
        mrow, irow, drow = new_m, new_i, new_d
        if keep_matrix:
            Mm[i], Im[i], Dm[i] = new_m, new_i, new_d

    score = xC[L] + x["C"][1]
    if keep_matrix:
        return MatrixResult(score, xN, xB, xE, xC, xJ, Mm, Im, Dm)
    return ParserResult(score, xN, xB, xE, xC, xJ)


def _dd_chain_logsum_rev(src_row: np.ndarray, tDD: np.ndarray) -> np.ndarray:
    """Reversed log-space DD prefix scan for Backward.

    ``src_row[j]`` is the value entering the chain at state j (E exit or
    M-entry at j+1); returns ``D[k] = LSE_{j>=k}(src[j] +
    sum_{m=k}^{j-1} tDD[m])`` for k = 1..M.  O(M) via cumulative
    logaddexp on ``src[j] + c[j]`` scanned right-to-left, where
    ``c[k] = sum tDD[1..k-1]``.
    """
    M = len(tDD)
    c = np.zeros(M + 1)
    c[2:] = np.cumsum(tDD[1:M])
    a = np.full(M + 1, NEGMASS)
    a[1:] = src_row[1:] + c[1:]
    acc = np.logaddexp.accumulate(a[::-1])[::-1]   # acc[k] = LSE(a[k..M])
    D = np.full(M + 1, NEGMASS)
    D[1:] = np.maximum(acc[1:] - c[1:], NEGMASS)
    return D


def backward(prof, dsq: np.ndarray, keep_matrix: bool = False):
    """Backward algorithm (``p7_BackwardParser`` / ``p7_GBackward``).
    Dispatches to the native C++ kernels when available."""
    from . import native
    if native.available():
        return native.fwdbck(prof, dsq, keep_matrix, backward=True)
    return _backward_np(prof, dsq, keep_matrix)


def _backward_np(prof, dsq: np.ndarray, keep_matrix: bool = False):
    Mn, L, msc, isc, tr, x = _prep(prof, dsq)
    xN = np.full(L + 1, NEGMASS); xB = np.full(L + 1, NEGMASS)
    xE = np.full(L + 1, NEGMASS); xC = np.full(L + 1, NEGMASS)
    xJ = np.full(L + 1, NEGMASS)
    if keep_matrix:
        Mm = np.full((L + 1, Mn + 1), NEGMASS)
        Im = np.full((L + 1, Mn + 1), NEGMASS)
        Dm = np.full((L + 1, Mn + 1), NEGMASS)

    # init row L
    xC[L] = x["C"][1]
    xE[L] = xC[L] + x["E"][1]
    irow = np.full(Mn + 1, NEGMASS)
    # D(L,k): exits to E directly (all k, local mode) or down the DD chain
    src = np.full(Mn + 1, xE[L])
    drow = _dd_chain_logsum_rev(src, tr["DD"])
    mrow = np.full(Mn + 1, NEGMASS)
    mrow[1:] = xE[L]
    mrow[1:Mn] = np.logaddexp(mrow[1:Mn], drow[2:] + tr["MD"][1:])
    if keep_matrix:
        Mm[L], Im[L], Dm[L] = mrow, irow, drow

    for i in range(L - 1, -1, -1):
        xnext = dsq[i]  # residue i+1 (0-based index i)
        ms = msc[xnext]
        iscore = isc[xnext]
        # B(i) = sum_k M(i+1,k) + tBM[k-1] + msc(i+1,k)
        xB[i] = np.logaddexp.reduce(mrow[1:] + tr["BM"] + ms[1:])
        xJ[i] = np.logaddexp(xJ[i + 1] + x["J"][0], xB[i] + x["J"][1])
        xC[i] = xC[i + 1] + x["C"][0]
        xN[i] = np.logaddexp(xN[i + 1] + x["N"][0], xB[i] + x["N"][1])
        xE[i] = np.logaddexp(xJ[i] + x["E"][0], xC[i] + x["E"][1])

        new_i = np.full(Mn + 1, NEGMASS)
        # I(i,k) = M(i+1,k+1)+tIM[k]+ms[k+1]  |  I(i+1,k)+tII[k]+isc[k]
        new_i[1:Mn] = np.logaddexp(
            mrow[2:] + tr["IM"][1:] + ms[2:],
            irow[1:Mn] + tr["II"][1:Mn] + iscore[1:Mn],
        )
        # D chain sources: E exit at any k, or M-entry M(i+1,j+1)+tDM[j]
        src = np.full(Mn + 1, xE[i])
        src[1:Mn] = np.logaddexp(src[1:Mn],
                                 mrow[2:] + tr["DM"][1:] + ms[2:])
        new_d = _dd_chain_logsum_rev(src, tr["DD"])
        # M(i,k) = M(i+1,k+1)+tMM | I(i+1,k)+tMI+isc | D(i,k+1)+tMD | E
        new_m = np.full(Mn + 1, NEGMASS)
        new_m[1:] = xE[i]
        new_m[1:Mn] = _lse(
            new_m[1:Mn],
            mrow[2:] + tr["MM"][1:] + ms[2:],
            irow[1:Mn] + tr["MI"][1:Mn] + iscore[1:Mn],
            new_d[2:] + tr["MD"][1:],
        )
        mrow, irow, drow = new_m, new_i, new_d
        if keep_matrix:
            Mm[i], Im[i], Dm[i] = new_m, new_i, new_d

    score = xN[0]
    if keep_matrix:
        return MatrixResult(score, xN, xB, xE, xC, xJ, Mm, Im, Dm)
    return ParserResult(score, xN, xB, xE, xC, xJ)


def viterbi_score(prof, dsq: np.ndarray) -> float:
    """Viterbi score in nats (``p7_ViterbiFilter`` float semantics)."""
    Mn, L, msc, isc, tr, x = _prep(prof, dsq)
    xN = 0.0
    xB = x["N"][1]
    xJ = xC = NEGMASS
    mrow = np.full(Mn + 1, NEGMASS)
    irow = np.full(Mn + 1, NEGMASS)
    drow = np.full(Mn + 1, NEGMASS)
    for i in range(1, L + 1):
        xi = dsq[i - 1]
        ms = msc[xi]
        new_m = np.full(Mn + 1, NEGMASS)
        new_m[1:] = ms[1:] + np.maximum.reduce([
            mrow[:Mn] + tr["MM"],
            irow[:Mn] + tr["IM"],
            drow[:Mn] + tr["DM"],
            xB + tr["BM"],
        ])
        new_i = np.full(Mn + 1, NEGMASS)
        new_i[1:Mn] = isc[xi][1:Mn] + np.maximum(
            mrow[1:Mn] + tr["MI"][1:Mn],
            irow[1:Mn] + tr["II"][1:Mn],
        )
        new_d = _dd_chain_max(new_m, tr["MD"], tr["DD"])
        xE = max(new_m[1:].max(), new_d[1:].max())
        xJ = max(xJ + x["J"][0], xE + x["E"][0])
        xC = max(xC + x["C"][0], xE + x["E"][1])
        xN = xN + x["N"][0]
        xB = max(xN + x["N"][1], xJ + x["J"][1])
        mrow, irow, drow = new_m, new_i, new_d
    return xC + x["C"][1]


def msv_score(prof, dsq: np.ndarray, nu: float = 2.0) -> float:
    """MSV (multiple segment Viterbi) score in nats, float-exact
    (``p7_GMSV`` semantics; the int8 filter approximates this)."""
    Mn = prof.M
    L = len(dsq)
    msc = _clamp(prof.msc)
    tloop = np.log(L / (L + 3.0))
    tmove = np.log(3.0 / (L + 3.0))
    tbmk = np.log(2.0 / (Mn * (Mn + 1.0)))
    tec = np.log(1.0 / nu)
    xN, xB, xJ, xC = 0.0, tmove, NEGMASS, NEGMASS
    mrow = np.full(Mn + 1, NEGMASS)
    for i in range(1, L + 1):
        ms = msc[dsq[i - 1]]
        new_m = np.full(Mn + 1, NEGMASS)
        new_m[1:] = ms[1:] + np.maximum(
            np.concatenate(([NEGMASS], mrow[1:Mn])),
            xB + tbmk,
        )
        xE = new_m[1:].max()
        xJ = max(xJ + tloop, xE + tec)
        xC = max(xC + tloop, xE + tec)
        xN = xN + tloop
        xB = max(xN + tmove, xJ + tmove)
        mrow = new_m
    return xC + tmove


def msv_score_quantized(prof, dsq: np.ndarray) -> float:
    """MSV filter score with HMMER's uint8 quantization semantics
    (``p7_MSVFilter``/``mf_conversion``): emission scores rounded to
    1/3-bit units with a saturating bias trick, NN/CC/JJ loop costs
    approximated as zero in the DP and restored as a constant -3 nats in
    the final score.  Gate decisions (F1, Viterbi-skip) must reproduce the
    quantized scores or hit sets drift (SURVEY.md §7 hard part 1).
    """
    from .quantize import quantize_msv
    Mn = prof.M
    L = len(dsq)
    q = quantize_msv(prof)
    cost, bias_b, base_b, scale_b = q.cost, q.bias_b, q.base_b, q.scale_b
    tjb_b = int(q.tjb_b(L))
    tec_b, tbm_b = q.tec_b, q.tbm_b

    xJ = 0
    xB = max(0, base_b - tjb_b)
    mpv = np.zeros(Mn, dtype=np.int32)
    for i in range(1, L + 1):
        xBv = max(0, xB - tbm_b)
        sv = np.empty(Mn, dtype=np.int32)
        sv[0] = xBv
        np.maximum(mpv[:-1], xBv, out=sv[1:])
        sv = np.minimum(sv + bias_b, 255)          # saturating add
        sv = np.maximum(sv - cost[dsq[i - 1]], 0)  # saturating sub
        xE = int(sv.max())
        if xE >= 255 - bias_b:
            return np.inf   # overflow: certainly passes the filter
        xJ = max(xJ, xE - tec_b)
        xB = max(base_b, xJ) - tjb_b   # N->B / J->B move cost, every row
        mpv = sv
    # final C->T move (one more tjb charge), then the constant restores
    # the ignored NN/CC/JJ loop costs (~ L log L/(L+3) -> -3 nats) --
    # p7_MSVFilter's return convention.  Without the final move the score
    # is inflated by ~4.6 nats and the calibrated MSV Gumbel (STATS MSV)
    # admits ~85% of random targets through the F1=0.02 gate.
    return (float(xJ) - float(tjb_b) - float(base_b)) / scale_b - 3.0


def ssv_score(prof, dsq: np.ndarray) -> float:
    """SSV (single ungapped segment) score in nats (``p7_SSVFilter`` float
    semantics): best single diagonal run, flanked by the length model."""
    Mn = prof.M
    L = len(dsq)
    msc = _clamp(prof.msc)
    tmove = np.log(3.0 / (L + 3.0))
    tbmk = np.log(2.0 / (Mn * (Mn + 1.0)))
    best = NEGMASS
    mrow = np.full(Mn + 1, NEGMASS)
    for i in range(1, L + 1):
        ms = msc[dsq[i - 1]]
        new_m = np.full(Mn + 1, NEGMASS)
        new_m[1:] = ms[1:] + np.maximum(
            np.concatenate(([NEGMASS], mrow[1:Mn])), tbmk)
        best = max(best, new_m[1:].max())
        mrow = new_m
    # B and E..C transitions: start tmove (N->B), end tmove (C->T), tec=log(1/2)?
    # SSV uses the single-hit wing: score = best + tmove (entry) + tmove (exit)
    return best + 2 * tmove + np.log(0.5)


def decode_specials(fwd: ParserResult, bck: ParserResult, prof, L: int):
    """Domain posteriors from parser specials (``p7_DomainDecoding``).

    Returns ``(btot, etot, mocc)`` arrays of length ``L+1``: cumulative
    expected B/E usage and per-row model occupancy.
    """
    totsc = fwd.score
    xNl = _clamp(prof.xN)[0]
    xJl = _clamp(prof.xJ)[0]
    xCl = _clamp(prof.xC)[0]
    btot = np.zeros(L + 1)
    etot = np.zeros(L + 1)
    mocc = np.zeros(L + 1)
    pB = np.exp(fwd.xB[:L] + bck.xB[:L] - totsc)          # B at rows 0..L-1
    pE = np.exp(fwd.xE[1:] + bck.xE[1:] - totsc)          # E at rows 1..L
    btot[1:] = np.cumsum(pB)
    etot[1:] = np.cumsum(pE)
    pN = np.exp(fwd.xN[:L] + xNl + bck.xN[1:] - totsc)
    pJ = np.exp(fwd.xJ[:L] + xJl + bck.xJ[1:] - totsc)
    pC = np.exp(fwd.xC[:L] + xCl + bck.xC[1:] - totsc)
    mocc[1:] = 1.0 - (pN + pJ + pC)
    return btot, etot, mocc


def posterior_matrices(fwd: MatrixResult, bck: MatrixResult, prof,
                       dsq: np.ndarray):
    """Full posterior decoding (``p7_Decoding``): per-cell probabilities.

    Returns dict with ``M``, ``I`` ``[L+1, M+1]`` and per-row specials
    ``N``, ``J``, ``C`` (emit-on-transition posteriors).
    """
    L = len(dsq)
    totsc = fwd.score
    ppM = np.exp(fwd.M + bck.M - totsc)
    ppM[0] = 0.0
    ppI = np.exp(fwd.I + bck.I - totsc)
    ppI[0] = 0.0
    xNl = _clamp(prof.xN)[0]
    xJl = _clamp(prof.xJ)[0]
    xCl = _clamp(prof.xC)[0]
    ppN = np.zeros(L + 1)
    ppJ = np.zeros(L + 1)
    ppC = np.zeros(L + 1)
    ppN[1:] = np.exp(fwd.xN[:L] + xNl + bck.xN[1:] - totsc)
    ppJ[1:] = np.exp(fwd.xJ[:L] + xJl + bck.xJ[1:] - totsc)
    ppC[1:] = np.exp(fwd.xC[:L] + xCl + bck.xC[1:] - totsc)
    return {"M": ppM, "I": ppI, "N": ppN, "J": ppJ, "C": ppC}
