"""nhmmer's batched device gates (``LongTargetsPipeline._device_gates``)
on seeded inputs.

On the CPU the gates run only when forced (``PYHMMER_TPU_NHMMER_DEVICE=
force``); they then take the XLA scans, so the gate code in
``plan7/longtargets.py`` runs here, including batches whose size is not a
power of two.  Also validates the f32 prefilter margin: the device
Viterbi/Forward scores must sit far inside ``DEVICE_GATE_MARGIN`` of the
exact host kernels, otherwise the margin scheme could silently drop true
hits.
"""
import numpy as np
import pytest

from pyhmmer_tpu import synthetic
from pyhmmer_tpu.plan7.profile import Profile
from pyhmmer_tpu.plan7.longtargets import LongTargetsPipeline
from pyhmmer_tpu.ops import native, reference as refops
from pyhmmer_tpu.ops.quantize import quantize_msv


@pytest.fixture(scope="module")
def dna():
    return synthetic.dna_workload(genome_len=120_000, M=120, copies=4,
                                  seed=3)


def _make_pend(alphabet, rng, n, lmin=40, lmax=220):
    pend = []
    for i in range(n):
        L = int(rng.integers(lmin, lmax + 1))
        sub = rng.integers(0, alphabet.K, L).astype(np.uint8)
        pend.append(dict(sub=sub, a=1, win_start=0, orig_len=L,
                         strand="+", seqidx=0, sq=None))
    return pend


def test_device_gates_exact_msv_and_margin(dna):
    """300 subwindows (padded up the batch ladder): MSV must be
    integer-exact vs the native host kernel; the f32 Viterbi/Forward
    prefilter scores must sit well inside DEVICE_GATE_MARGIN of the
    exact host scores."""
    hmm, _ = dna
    alphabet = hmm.alphabet
    pli = LongTargetsPipeline(alphabet)
    prof = Profile(hmm.M, alphabet).configure(
        hmm, pli.background, 400, multihit=True)
    rng = np.random.default_rng(11)
    pend = _make_pend(alphabet, rng, 300)

    usc, vit, fwd = pli._device_gates(prof, pend)
    assert usc.shape == (300,) and vit.shape == (300,) and fwd.shape == (300,)

    q = quantize_msv(prof)
    margin = LongTargetsPipeline.DEVICE_GATE_MARGIN
    worst_v = worst_f = 0.0
    for j in (0, 1, 17, 63, 128, 255, 256, 280, 299):
        sub = pend[j]["sub"]
        u_host = native.msv_quant(q, sub)
        if u_host is None:
            u_host = refops.msv_score_quantized(prof, sub)
        assert usc[j] == pytest.approx(u_host, abs=1e-9), j
        prof.reconfig_length(len(sub))
        v_host = refops.viterbi_score(prof, sub)
        f_host = refops.forward(prof, sub).score
        worst_v = max(worst_v, abs(vit[j] - v_host))
        worst_f = max(worst_f, abs(fwd[j] - f_host))
    assert worst_v < 0.05 * margin, worst_v
    assert worst_f < 0.05 * margin, worst_f


def test_nhmmer_forced_device_hit_parity(dna, monkeypatch):
    """End-to-end: the seeded genome searched with the device gates forced
    on reports exactly the same hits as the host path, on both strands."""
    hmm, genome = dna

    def run():
        return LongTargetsPipeline(hmm.alphabet).search_hmm(hmm, genome)

    monkeypatch.setenv("PYHMMER_TPU_NHMMER_DEVICE", "0")
    host_hits = run()
    monkeypatch.setenv("PYHMMER_TPU_NHMMER_DEVICE", "force")
    calls = []
    orig = LongTargetsPipeline._device_gates
    monkeypatch.setattr(LongTargetsPipeline, "_device_gates",
                        lambda self, p, pend: calls.append(len(pend))
                        or orig(self, p, pend))
    dev_hits = run()

    key = lambda h: (h.name, h.best_domain.ali_from, h.best_domain.ali_to,
                     round(h.score, 6))
    assert calls, "the device gates did not run"
    assert sorted(map(key, dev_hits)) == sorted(map(key, host_hits))
    strands = {h.best_domain.ali_from < h.best_domain.ali_to
               for h in host_hits.reported}
    assert len(host_hits.reported) >= 2 and strands == {True, False}
