"""Batched JAX kernels vs the float64 oracle."""
import numpy as np
import pytest

from pyhmmer_tpu.plan7 import HMMFile
from pyhmmer_tpu.plan7.background import Background
from pyhmmer_tpu.plan7.profile import Profile
from pyhmmer_tpu.easel.seqfile import SequenceFile
from pyhmmer_tpu.easel.sequence import DigitalSequenceBlock
from pyhmmer_tpu.ops import reference as ref
from pyhmmer_tpu.ops import batch as B


@pytest.fixture(scope="module")
def setup(data_dir):
    with HMMFile(data_dir / "hmms" / "txt" / "PF02826.hmm") as f:
        h1 = f.read()
    with HMMFile(data_dir / "hmms" / "txt" / "Thioesterase.hmm") as f:
        h2 = f.read()
    bg = Background(h1.alphabet)
    with SequenceFile(data_dir / "seqs" / "938293.PRJEB85.HG003687.faa",
                      digital=True) as f:
        seqs = list(f)[:16]
    block = DigitalSequenceBlock(h1.alphabet, seqs)
    codes, lengths = block.packed(pad_to=64)
    profs = [Profile(h.M, h.alphabet).configure(h, bg, 400) for h in (h1, h2)]
    pb = B.ProfileBatch(profs)
    return (h1, h2), bg, seqs, profs, pb, codes, lengths


def _oracle(h, bg, sq, fn):
    prof = Profile(h.M, h.alphabet).configure(h, bg, len(sq))
    return fn(prof, sq.sequence)


def test_msv_exact(setup):
    hmms, bg, seqs, profs, pb, codes, lengths = setup
    usc = B.msv_scores(pb, codes, lengths)
    for pi, h in enumerate(hmms):
        for bi, sq in enumerate(seqs):
            u0 = _oracle(h, bg, sq, ref.msv_score_quantized)
            if np.isinf(u0):
                assert np.isinf(usc[pi, bi])
            else:
                assert abs(u0 - usc[pi, bi]) < 1e-6

def test_viterbi_close(setup):
    hmms, bg, seqs, profs, pb, codes, lengths = setup
    vit = B.viterbi_scores(pb, codes, lengths)
    for pi, h in enumerate(hmms):
        for bi, sq in enumerate(seqs):
            v0 = _oracle(h, bg, sq, ref.viterbi_score)
            assert abs(v0 - vit[pi, bi]) < 0.05


def test_forward_close(setup):
    hmms, bg, seqs, profs, pb, codes, lengths = setup
    fwd = B.forward_scores(pb, codes, lengths)
    for pi, h in enumerate(hmms):
        for bi, sq in enumerate(seqs):
            f0 = _oracle(h, bg, sq, lambda p, d: ref.forward(p, d).score)
            assert abs(f0 - fwd[pi, bi]) < 0.05
