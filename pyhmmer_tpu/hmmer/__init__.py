"""Application layer: the HMMER tool suite as Python functions.

Mirrors ``pyhmmer.hmmer`` (reference ``src/pyhmmer/hmmer/``):
``hmmsearch``, ``hmmscan``, ``phmmer``, ``jackhmmer``, ``hmmalign``,
``hmmpress`` and ``nhmmer``.

Device note: where the reference dispatches one query per CPU thread
(``hmmer/_base.py:344-495``), these functions hand the whole query set to
the batched :class:`~pyhmmer_tpu.engine.SearchEngine`, which stacks
profiles and target buckets into device kernels.  The ``cpus`` argument
is accepted for API compatibility and ignored (device parallelism is
controlled by the engine / sharding configuration).
"""

from __future__ import annotations

import os
import typing
from typing import Iterable, Iterator, Optional, Union

from ..easel.alphabet import Alphabet
from ..easel.sequence import DigitalSequence, DigitalSequenceBlock
from ..easel.msa import DigitalMSA
from ..easel.seqfile import SequenceFile
from ..plan7.hmm import HMM
from ..plan7.hmmfile import HMMFile, write_hmm_binary
from ..plan7.background import Background
from ..plan7.builder import Builder
from ..plan7.pipeline import Pipeline
from ..plan7.results import TopHits
from ..plan7.optimized import (OptimizedProfile, OptimizedProfileBlock,
                               HMMPressedFile)
from ..plan7.iteration import IterationResult
from ..plan7.tracealign import TraceAligner

__all__ = ["hmmsearch", "hmmscan", "phmmer", "jackhmmer", "hmmalign",
           "hmmpress", "nhmmer"]

#: ``backend`` values of :func:`hmmsearch` / :func:`hmmscan`: the batched
#: device engine, or the sequential float64 oracle pipeline
BACKENDS = ("device", "oracle")


def _check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    return backend


def _target_block(sequences, alphabet: Optional[Alphabet] = None
                  ) -> DigitalSequenceBlock:
    if isinstance(sequences, DigitalSequenceBlock):
        return sequences
    if isinstance(sequences, SequenceFile):
        if not sequences.digital:
            raise ValueError("expected digital mode SequenceFile")
        return sequences.read_block()
    seqs = list(sequences)
    if not seqs:
        raise ValueError("no target sequences")
    return DigitalSequenceBlock(seqs[0].alphabet, seqs)


def _query_list(queries):
    if isinstance(queries, (HMM,)):
        return [queries]
    if isinstance(queries, HMMFile):
        return list(queries)
    return list(queries)


def hmmsearch(queries, sequences, *, cpus: int = 0, callback=None,
              backend: str = "device", block_residues: Optional[int] = None,
              engine=None, **options) -> Iterator[TopHits]:
    """Search HMM profile(s) against a sequence database
    (``pyhmmer.hmmsearch``, reference ``hmmer/_hmmsearch.py:294-436``).

    Yields one :class:`TopHits` per query, in query order.

    When ``sequences`` is a digital :class:`SequenceFile`, the database
    is consumed in bounded blocks (``block_residues`` residues each,
    default 16M) and per-block results are merged -- peak memory is
    independent of database size, like the reference's streamed worker
    loop (``hmmer/_hmmsearch.py:81-90``).

    A caller-provided ``engine`` (a :class:`~pyhmmer_tpu.engine.SearchEngine`
    built with the pipeline options) keeps its configured-model and
    target-bucket caches across calls, the serving pattern.

    Example:
        >>> from pyhmmer_tpu import synthetic
        >>> hmms, targets = synthetic.doctest_workload()
        >>> th = next(hmmsearch(hmms, targets))
        >>> oracle = next(hmmsearch(hmms, targets, backend="oracle"))
        >>> [h.name for h in th.reported] == [h.name for h in oracle.reported]
        True
        >>> len(th.reported) > 0
        True
    """
    _check_backend(backend)
    queries = _query_list(queries)
    if not queries:
        return iter(())
    alphabet = queries[0].alphabet
    if isinstance(sequences, SequenceFile) and backend != "oracle":
        return _hmmsearch_streamed(queries, sequences, alphabet, callback,
                                   block_residues or (1 << 24), options,
                                   engine)
    block = _target_block(sequences)
    if backend == "oracle":
        def gen():
            for q in queries:
                pli = Pipeline(alphabet, **options)
                th = pli.search_hmm(q, block)
                if callback is not None:
                    callback(q, len(queries))
                yield th
        return gen()
    from ..engine import SearchEngine
    eng = engine or SearchEngine(alphabet, **options)
    results = eng.search(queries, block, callback=callback)
    return iter(results)


def _hmmsearch_streamed(queries, seqfile: SequenceFile, alphabet,
                        callback, block_residues: int, options, engine=None):
    """Blockwise hmmsearch over a streamed target file: one engine (the
    configured-model cache persists across blocks), one merge per query
    at the end (``TopHits.merge`` sums auto-Z accounting)."""
    if not seqfile.digital:
        raise ValueError("expected digital mode SequenceFile")
    from ..engine import SearchEngine
    eng = engine or SearchEngine(alphabet, **options)
    partials = None
    while True:
        block = seqfile.read_block(residues=block_residues)
        if len(block) == 0:
            break
        results = eng.search(queries, block)
        if partials is None:
            partials = [[th] for th in results]
        else:
            for acc, th in zip(partials, results):
                acc.append(th)
    if partials is None:
        # empty database: one well-formed empty TopHits per query
        empty = eng.search(queries, DigitalSequenceBlock(alphabet))
        partials = [[th] for th in empty]
    merged = []
    for q, parts in zip(queries, partials):
        th = parts[0].merge(*parts[1:]) if len(parts) > 1 else parts[0]
        merged.append(th)
        if callback is not None:
            callback(q, len(queries))
    return iter(merged)


def hmmscan(queries, profiles, *, cpus: int = 0, callback=None,
            background=None, engine=None, **options) -> Iterator[TopHits]:
    """Scan sequence(s) against a profile database
    (``pyhmmer.hmmscan``, reference ``hmmer/_hmmscan.py:91-230``).

    E-values use Z = number of profiles (``plan7.pyx:5211-5215``).

    Example:
        >>> from pyhmmer_tpu import synthetic
        >>> models, targets = synthetic.doctest_workload()
        >>> seqs = targets[:8]
        >>> results = list(hmmscan(seqs, models))
        >>> len(results) == len(seqs)
        True
        >>> results[0].Z == float(len(models))   # Z = number of models
        True
    """
    from ..plan7.profile import Profile as _Profile
    if isinstance(queries, DigitalSequence):
        queries = [queries]
    queries = list(queries)
    # normalize profile inputs to HMMs.  The reference's primary hmmscan
    # input is a pressed DB / OptimizedProfileBlock (_hmmscan.py:190-215);
    # our optimized profiles keep a reference to their core model
    # (Profile.configure) and a pressed DB's optimized profiles are
    # reconstructed from its .h3m member internally, so every input kind
    # normalizes to HMMs without relying on any filename convention.
    hmms = []
    for p in profiles:
        if isinstance(p, HMM):
            hmms.append(p)
        elif isinstance(p, (OptimizedProfile, _Profile)):
            prof = p.profile if isinstance(p, OptimizedProfile) else p
            hmm = getattr(prof, "_hmm", None)
            if hmm is None:
                raise TypeError(
                    "optimized profile does not carry its core model; "
                    "load profiles from a pressed database or HMM file")
            hmms.append(hmm)
        else:
            hmms.append(p)
    if not queries:
        return iter(())
    alphabet = queries[0].alphabet

    backend = _check_backend(options.pop("backend", "device"))
    if backend != "oracle":
        # engine-backed scan: a scan is the transpose of a search (the
        # reference shares p7_Pipeline between the two; only Z differs,
        # plan7.pyx:5211-5215), so run the batched engine with the
        # profile DB as queries and the scan queries as targets, then
        # re-key each hit by its model.  Model-specific bit cutoffs
        # (GA/TC/NC) are per-pipeline in the engine's chunk state, so
        # cutoff scans route through the engine too; the per-model
        # reported/included flags are preserved on the re-keyed hits.
        return iter(_scan_via_engine(hmms, queries, alphabet, background,
                                     callback, options, engine))

    def gen():
        for q in queries:
            pli = Pipeline(alphabet, background, **options)
            th = pli.scan_seq(q, hmms)
            if callback is not None:
                callback(q, len(queries))
            yield th
    return gen()


def _scan_via_engine(hmms, queries, alphabet, background, callback,
                     options, engine=None):
    import copy as _copy
    from ..engine import SearchEngine
    from ..easel.sequence import DigitalSequenceBlock
    from ..plan7.results import TopHits, Hit

    block = DigitalSequenceBlock(alphabet, queries)
    # a caller-provided engine keeps its configured-model and bucket
    # caches across calls -- the serving pattern (one resident profile
    # DB, many query batches), mirroring the reference's prefetched
    # OptimizedProfileBlock reuse (hmmer/_hmmscan.py:190-215)
    eng = engine or SearchEngine(alphabet, background, **options)
    per_hmm = eng.search(hmms, block)
    cutoff_mode = options.get("bit_cutoffs") is not None

    # index per-model results by target-sequence name
    by_seq = []   # [mi] -> {seq name: Hit}
    for th in per_hmm:
        by_seq.append({h.name: h for h in th})

    # threshold params are uniform by construction (one options dict
    # drives every per-model search); enforce it once so a future
    # per-model option cannot silently inherit model 0's thresholds
    # (round-3 advisor note)
    _THRESH_ATTRS = ("E", "domE", "T", "domT", "incE", "incdomE",
                     "incT", "incdomT", "domZ", "domZ_setby")
    if per_hmm:
        check = ["E", "domE", "T", "domT", "incE", "incdomE", "incT",
                 "incdomT", "domZ_setby"]
        if per_hmm[0].domZ_setby == "option":
            check.append("domZ")   # auto domZ legitimately varies
        for attr in check:
            v0 = getattr(per_hmm[0], attr)
            for other in per_hmm[1:]:
                if getattr(other, attr) != v0:
                    raise ValueError(
                        f"non-uniform per-model threshold {attr!r} in "
                        "hmmscan transpose; per-model options are not "
                        "supported by the engine route")

    out = []
    nres_db = sum(h.M for h in hmms)
    for q in queries:
        th = TopHits()
        th._mode = "scan"
        th.query_name = q.name
        th.query_accession = q.accession or None
        th.query_length = len(q)
        # scan accounting: targets are models (plan7.pyx:5211-5215)
        th.nmodels = len(hmms)
        th.nnodes = nres_db
        th.nseqs = 1
        th.nres = len(q)
        th.Z = float(len(hmms))
        th.Z_setby = "ntargets"
        src = per_hmm[0] if per_hmm else None
        if src is not None:
            for attr in _THRESH_ATTRS:
                setattr(th, attr, getattr(src, attr))
        for mi, hmm in enumerate(hmms):
            h = by_seq[mi].get(q.name)
            if h is None:
                continue
            nh = Hit(th, hmm.name, hmm.accession or None,
                     hmm.description or None, hmm.M,
                     score=h.score, pre_score=h.pre_score,
                     sum_score=h.sum_score, lnP=h.lnP,
                     nexpected=h.nexpected, nregions=h.nregions,
                     nclustered=h.nclustered, noverlaps=h.noverlaps,
                     nenvelopes=h.nenvelopes)
            for d in h.domains:
                nd = _copy.copy(d)
                nd.hit = nh
                nh.domains.append(nd)
            nh.best_domain_idx = h.best_domain_idx
            if cutoff_mode:
                # each model's search already applied ITS OWN GA/TC/NC
                # thresholds; carry the flags over (a single uniform
                # re-threshold would apply one model's cutoffs to all)
                nh.reported = h.reported
                nh.included = h.included
                for nd, d in zip(nh.domains, h.domains):
                    nd.flags = d.flags
            th.hits.append(nh)
        th.sort_by_key()
        if cutoff_mode:
            if th.domZ_setby == "ntargets":
                th.domZ = float(sum(1 for h in th.hits if h.reported))
        else:
            th.threshold()
        out.append(th)
        if callback is not None:
            callback(q, len(queries))
    return out


def phmmer(queries, sequences, *, cpus: int = 0, callback=None,
           builder: Optional[Builder] = None, **options
           ) -> Iterator[TopHits]:
    """Search query sequence(s) against a sequence database
    (``pyhmmer.phmmer``, reference ``hmmer/_phmmer.py:106-202``).

    Example:
        >>> from pyhmmer_tpu import synthetic
        >>> _, seqs = synthetic.doctest_workload()
        >>> th = next(phmmer(seqs[0], seqs))
        >>> th.reported[0].name == seqs[0].name   # best hit = the query
        True
    """
    if isinstance(queries, (DigitalSequence, DigitalMSA)):
        queries = [queries]
    queries = list(queries)
    if not queries:
        return iter(())
    alphabet = queries[0].alphabet
    block = _target_block(sequences)
    bg = Background(alphabet)
    bld = builder or Builder(alphabet)
    hmms = []
    for q in queries:
        if isinstance(q, DigitalMSA):
            hmm, _, _ = bld.copy().build_msa(q, bg)
        else:
            hmm, _, _ = bld.copy().build(q, bg)
        hmms.append(hmm)
    from ..engine import SearchEngine
    eng = SearchEngine(alphabet, **options)
    return iter(eng.search(hmms, block, callback=callback))


def jackhmmer(queries, sequences, *, max_iterations: int = 5,
              select_hits=None, checkpoints: bool = False,
              cpus: int = 0, callback=None,
              builder: Optional[Builder] = None, **options):
    """Iterative profile search (``pyhmmer.jackhmmer``, reference
    ``hmmer/_jackhmmer.py:268-399``).  Default inclusion thresholds
    incE = incdomE = 0.001; ``hand`` architecture builder."""
    if isinstance(queries, DigitalSequence):
        queries = [queries]
    queries = list(queries)
    if not queries:
        return iter(())
    alphabet = queries[0].alphabet
    block = _target_block(sequences)
    options.setdefault("incE", 0.001)
    options.setdefault("incdomE", 0.001)
    bld = builder or Builder(alphabet, architecture="hand")

    from ..engine import SearchEngine

    def run_one(q):
        pli = Pipeline(alphabet, **options)
        search = pli.iterate_seq(q, block, builder=bld.copy(),
                                 select_hits=select_hits)
        # per-round searches go through the batched device engine (new
        # engine per query: the model changes every iteration, so the
        # engine's profile cache would only churn across queries).  Tiny
        # target sets stay on the sequential oracle -- identical results,
        # and the engine's staging overhead only pays off with real
        # batches
        if len(block) >= 64:
            search.engine = SearchEngine(alphabet, **options)
        results = []
        last = None
        for _ in range(max_iterations):
            try:
                last = next(search)
            except StopIteration:
                break
            results.append(last)
            if last.converged:
                break
        return results if checkpoints else last

    def gen():
        for q in queries:
            out = run_one(q)
            if callback is not None:
                callback(q, len(queries))
            yield out
    return gen()


def hmmalign(hmm: HMM, sequences, *, trim: bool = False,
             digitize: bool = False, all_consensus_cols: bool = True,
             cpus: int = 0):
    """Align sequences to an HMM (``pyhmmer.hmmalign``, reference
    ``hmmer/_hmmalign.py:27-102``)."""
    seqs = list(sequences)
    aligner = TraceAligner()
    traces = aligner.compute_traces(hmm, seqs)
    return aligner.align_traces(hmm, seqs, traces, trim=trim,
                                digitize=digitize,
                                all_consensus_cols=all_consensus_cols)


def hmmpress(hmms, output: Union[str, os.PathLike]) -> int:
    """Press HMMs into a database (``pyhmmer.hmmpress``, reference
    ``hmmer/_hmmpress.py:10-70``): writes ``.h3m`` (binary models),
    ``.h3i`` (SSI index by name, aliased by accession), and the
    ``.h3f``/``.h3p`` vectorized-profile members in the REFERENCE byte
    layout (``p7_oprofile_Write``; byte-validated against the bundled
    golden dbs in ``tests/test_pressed_write.py``), so HMMER and the
    reference pyhmmer can consume this engine's pressed output
    directly."""
    from ..easel.ssi import SSIWriter
    from ..ops.quantize import quantize_msv
    from ..plan7.profile import Profile
    from ..plan7.pressed import write_h3f_record, write_h3p_record

    base = os.fspath(output)
    n = 0
    with open(base + ".h3m", "wb") as fm, \
         open(base + ".h3f", "wb") as ff, \
         open(base + ".h3p", "wb") as fp, \
         SSIWriter(base + ".h3i") as ssi:
        fd = ssi.add_file(os.path.basename(base) + ".h3m")
        for hmm in hmms:
            moff = fm.tell()
            foff = ff.tell()
            poff = fp.tell()
            write_hmm_binary(hmm, fm)
            bg = Background(hmm.alphabet)
            prof = Profile(hmm.M, hmm.alphabet).configure(hmm, bg, 400)
            q = quantize_msv(prof)
            write_h3f_record(ff, hmm, quant=q,
                             offs=(moff, foff, poff))
            write_h3p_record(fp, hmm, prof=prof)
            ssi.add_key(hmm.name, fd, moff, foff, hmm.M)
            if hmm.accession:
                ssi.add_alias(hmm.accession, hmm.name)
            n += 1
    return n


def nhmmer(queries, sequences, *, cpus: int = 0, callback=None,
           builder: Optional[Builder] = None, **options
           ) -> Iterator[TopHits]:
    """Search DNA/RNA queries against long nucleotide targets with the
    long-targets pipeline (``pyhmmer.nhmmer``, reference
    ``hmmer/_nhmmer.py:140-243``).  Queries may be `HMM`,
    `DigitalSequence`, or `DigitalMSA` objects (sequence/MSA queries are
    built into HMMs with nhmmer's window parameters)."""
    from ..plan7.longtargets import LongTargetsPipeline
    from ..easel.msa import DigitalMSA as _DMSA
    if isinstance(queries, (HMM, DigitalSequence, _DMSA)):
        queries = [queries]
    queries = list(queries)
    if not queries:
        return iter(())
    alphabet = getattr(queries[0], "alphabet", None)
    # a digital SequenceFile streams genome windows off disk inside the
    # long-targets pipeline (peak RSS ~ one window per record); anything
    # else is materialized as a block
    if isinstance(sequences, SequenceFile) and sequences.digital:
        block = sequences
    else:
        block = _target_block(sequences)
    window_length = options.get("window_length")
    window_beta = options.get("window_beta")

    def run():
        for qi, q in enumerate(queries):
            pli = LongTargetsPipeline(block.alphabet, **options)
            if isinstance(q, HMM):
                th = pli.search_hmm(q, block)
            elif isinstance(q, _DMSA):
                bld = (builder or Builder(
                    block.alphabet, window_length=window_length,
                    window_beta=window_beta)).copy()
                th = pli.search_msa(q, block, builder=bld)
            else:
                bld = (builder or Builder(
                    block.alphabet, window_length=window_length,
                    window_beta=window_beta)).copy()
                th = pli.search_seq(q, block, builder=bld)
            if callback is not None:
                callback(q, len(queries))
            yield th

    return run()
