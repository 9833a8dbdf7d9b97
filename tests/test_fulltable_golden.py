"""Full-table golden parity: the ENTIRE reported table vs the reference.

Unlike ``test_pipeline_golden`` (which searches only pre-selected golden
sequences), these tests run hmmsearch over the whole bundled proteome and
compare the complete reported table line-by-line against the reference's
``--tblout`` goldens (the reference's own strategy:
tests/test_hmmer.py:109-158).  This pins the known PARITY gap #1
extras — any change to gates/filters that adds or removes a reported hit
fails here instead of shipping silently.
"""

import os

import pytest

from pyhmmer_tpu.plan7 import HMMFile
from pyhmmer_tpu.easel import SequenceFile
from pyhmmer_tpu import hmmer


#: Known weak extra hits admitted by the calibrated 2-state bias filter
#: (PARITY_NOTES gap #1; recalibrated round 2: 6 extras / 0 missing is
#: this filter family's optimum).  Keyed by query name.
KNOWN_EXTRAS = {
    "2-Hacid_dh_C": {"938293.PRJEB85.HG003685_215"},
    "Proteusin_Epimerase_RRE": {
        "938293.PRJEB85.HG003685_209",
        "938293.PRJEB85.HG003686_3",
    },
    "Other_Sactipeptide_rSAM_RRE": {"938293.PRJEB85.HG003686_564"},
    "Ranthipeptide_rSAM_RRE": {
        "938293.PRJEB85.HG003685_62",
        "938293.PRJEB85.HG003690_265",
    },
}

#: Hits whose scores carry stochastic-ensemble RNG wobble (PARITY_NOTES
#: gaps #2/#3): clustered multidomain regions where the trace-ensemble
#: null2 depends on the RNG stream.  Score tolerance is relaxed for these.
WOBBLE_TOL = 1.1


def _parse_tbl(path):
    rows = {}
    for line in open(path):
        if line.startswith("#"):
            continue
        c = line.split()
        rows.setdefault(c[2], []).append(
            (c[0], float(c[4]), float(c[5]), float(c[6])))
    return rows


def _run_and_check(ref, hmmpath, tblpath):
    with HMMFile(hmmpath) as f:
        hmms = list(f)
    with SequenceFile(os.path.join(
            ref, "seqs", "938293.PRJEB85.HG003687.faa"),
            digital=True) as f:
        targets = f.read_block()
    golden = _parse_tbl(tblpath)
    results = list(hmmer.hmmsearch(hmms, targets))
    n_strict = 0
    for hmm, th in zip(hmms, results):
        qn = hmm.name.decode()
        gold = golden.get(qn, [])
        mine = {h.name.decode(): (h.evalue, h.score, h.bias)
                for h in th.reported}
        missing = set(g[0] for g in gold) - set(mine)
        assert not missing, f"{qn}: golden hits missing: {sorted(missing)}"
        extra = set(mine) - set(g[0] for g in gold)
        unknown = extra - KNOWN_EXTRAS.get(qn, set())
        assert not unknown, f"{qn}: unexpected extra hits: {sorted(unknown)}"
        for name, _ev, score, bias in gold:
            msc, mbias = mine[name][1], mine[name][2]
            assert abs(msc - score) <= WOBBLE_TOL, (
                f"{qn}/{name}: score {msc} vs golden {score}")
            if abs(msc - score) <= 0.1 and abs(mbias - bias) <= 0.1:
                n_strict += 1
    return n_strict


def test_fulltable_pf02826(data_dir):
    n_strict = _run_and_check(
        data_dir, os.path.join(data_dir, "hmms", "txt", "PF02826.hmm"),
        os.path.join(data_dir, "tables", "PF02826.tbl"))
    # all but the RNG-wobble rows must match score AND bias to 0.1 bits
    assert n_strict >= 19


def test_fulltable_rrefam(data_dir):
    n_strict = _run_and_check(
        data_dir, os.path.join(data_dir, "hmms", "txt", "RREFam.hmm"),
        os.path.join(data_dir, "tables", "RREFam.tbl"))
    assert n_strict >= 8
