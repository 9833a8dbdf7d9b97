"""Multi-host runtime: record serialization round trip + degenerate run.

The real multi-process path needs one JAX process per host
(``multihost.initialize``); CI exercises the full record codec on real
search output (every field the merge contract consumes) and the
single-process degenerate path of ``multihost_search`` (the dryrun
shape).  The collective itself (``process_allgather``) is a no-op at
process_count()==1 by construction.
"""
import numpy as np
import pytest

from pyhmmer_tpu import synthetic
from pyhmmer_tpu.easel.sequence import DigitalSequenceBlock
from pyhmmer_tpu.engine import SearchEngine
from pyhmmer_tpu.parallel import multihost


@pytest.fixture(scope="module")
def search_result():
    hmms, targets = synthetic.small_workload(200)
    th = SearchEngine(hmms[0].alphabet).search(hmms, targets)[0]
    return hmms, targets, th


def _rows(th):
    return [(h.name, round(h.score, 9), round(h.pre_score, 9),
             round(h.sum_score, 9), round(h.lnP, 9), h.reported,
             h.included, len(h.domains),
             [(d.env_from, d.env_to, d.ali_from, d.ali_to,
               round(d.score, 5), round(d.lnP, 9), d.reported,
               d.included) for d in h.domains])
            for h in th.hits]


def test_record_roundtrip(search_result):
    _, _, th = search_result
    buf = multihost.encode_tophits(th)
    assert buf.dtype == np.uint8
    back = multihost.decode_tophits(buf)
    assert _rows(back) == _rows(th)
    for attr in ("Z", "domZ", "Z_setby", "domZ_setby", "nmodels",
                 "nseqs", "nres", "n_past_msv", "n_past_bias",
                 "n_past_vit", "n_past_fwd", "query_name",
                 "query_length"):
        assert getattr(back, attr) == getattr(th, attr), attr
    # alignments survive (display path after a cross-host merge)
    h0 = back.hits[0]
    d0 = h0.domains[h0.best_domain_idx]
    o0 = th.hits[0].domains[th.hits[0].best_domain_idx]
    assert d0.alignment.hmm_sequence == o0.alignment.hmm_sequence
    assert d0.alignment.target_sequence == o0.alignment.target_sequence


def test_roundtripped_merge_identical(search_result):
    """Merging round-tripped partials must equal merging the originals
    (what every non-local rank does with allgathered records)."""
    hmms, targets, th = search_result
    # split the block in two and search each half
    half = len(targets) // 2
    a = DigitalSequenceBlock(targets.alphabet, list(targets)[:half])
    b = DigitalSequenceBlock(targets.alphabet, list(targets)[half:])
    eng = SearchEngine(hmms[0].alphabet)
    pa = eng.search(hmms, a)[0]
    pb = eng.search(hmms, b)[0]
    direct = pa.merge(pb)
    via_wire = multihost.decode_tophits(
        multihost.encode_tophits(pa)).merge(
        multihost.decode_tophits(multihost.encode_tophits(pb)))
    assert _rows(via_wire) == _rows(direct)
    assert via_wire.Z == direct.Z


def test_degenerate_single_process(search_result):
    hmms, targets, th = search_result
    out = multihost.multihost_search(hmms, targets)
    got = [(h.name, round(h.score, 6)) for h in out[0] if h.reported]
    want = [(h.name, round(h.score, 6)) for h in th if h.reported]
    assert got == want
    assert multihost.initialize() == 1     # no-op without NPROC
    assert multihost.allgather_bytes(
        np.arange(5, dtype=np.uint8))[0].tolist() == [0, 1, 2, 3, 4]


def test_two_process_multihost(tmp_path):
    """The real nproc>1 branch, actually executed: two subprocesses
    initialize jax.distributed on a localhost coordinator (CPU
    platform), each searches its residue-balanced shard, the partials
    are allgathered over the collective fabric and merged -- every rank
    must produce the identical reported table, equal to the
    single-process search."""
    import json
    import socket
    import subprocess
    import sys as _sys

    ntargets = 200
    hmms, targets = synthetic.small_workload(ntargets)
    single = SearchEngine(hmms[0].alphabet).search(hmms, targets)
    want = [[h.name.decode(), round(h.score, 9), round(h.evalue, 12),
             h.included] for h in single[0].reported]
    assert want, "workload must produce hits"

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    import os as _os
    worker = _os.path.join(_os.path.dirname(__file__),
                           "_multihost_worker.py")
    outs = [tmp_path / f"rank{p}.json" for p in range(2)]
    procs = [subprocess.Popen(
        [_sys.executable, worker, str(p), "2", str(port),
         str(ntargets), str(outs[p])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for p in range(2)]
    for p, proc in enumerate(procs):
        try:
            _, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert proc.returncode == 0, (p, err.decode()[-2000:])

    for p in range(2):
        rows = json.loads(outs[p].read_text())
        got, acct = rows[0], rows[1]
        assert got == want, (p, got[:3], want[:3])
        # merged accounting: summed auto-Z equals the full target count
        assert acct[0] == float(ntargets) and acct[1] == ntargets
