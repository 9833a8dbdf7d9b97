"""Multi-host (multi-process) distributed search runtime.

The multi-process analog of the reference's hmmpgmd master/worker service
(``/root/reference/src/pyhmmer/daemon.pyx:64-592`` client; ``hmmdmstr.c``
/ ``hmmdwrkr.c`` / ``cachedb_shard.c`` server roles, SURVEY.md section 5
distributed-comms contract): instead of a TCP master sharding a cached
sequence DB across worker processes and merging their serialized
``P7_HIT`` streams, each JAX process searches its own residue-balanced
target shard on its local devices and the partial ``TopHits`` are
exchanged as fixed-width uint8 record arrays over the JAX collective
fabric (``process_allgather`` rides ICI/DCN), then combined with the
exact ``TopHits.merge`` contract (concatenate, sum auto-Z,
re-threshold; ``plan7.pyx:8860-8964``).

The hit records reuse the hmmpgmd wire codec (``pyhmmer_tpu.daemon``):
one length-prefixed stats block + the serialized hit stream, padded to
the global maximum so every process contributes the same-shape array --
deterministic merge order (by process index) keeps N-process output
byte-identical to the 1-process search.

Launch recipe (one process per host)::

    # host 0 (coordinator):
    PYHMMER_TPU_COORD=host0:8476 PYHMMER_TPU_NPROC=4 PYHMMER_TPU_PROC=0 \
        python my_search.py
    # host k:
    PYHMMER_TPU_COORD=host0:8476 PYHMMER_TPU_NPROC=4 PYHMMER_TPU_PROC=k \
        python my_search.py

where ``my_search.py`` calls::

    from pyhmmer_tpu.parallel import multihost
    multihost.initialize()                  # no-op when NPROC is unset/1
    hits = multihost.multihost_search(queries, local_full_targets)

Every process loads (or streams) the same target file; the shard split
is deterministic, so no data movement happens before the hit exchange.
Degenerate single-process runs need no initialization and return
exactly ``SearchEngine.search`` + threshold, which is what
``__graft_entry__.dryrun_multichip`` exercises.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["initialize", "encode_tophits", "decode_tophits",
           "allgather_bytes", "multihost_search"]

_MAGIC = b"PTH1"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> int:
    """Initialize ``jax.distributed`` from arguments or the
    ``PYHMMER_TPU_COORD`` / ``PYHMMER_TPU_NPROC`` / ``PYHMMER_TPU_PROC``
    environment (no-op for a single process).  Returns the process
    count."""
    import jax

    num = num_processes if num_processes is not None else int(
        os.environ.get("PYHMMER_TPU_NPROC", "1"))
    if num <= 1:
        return 1
    coord = coordinator_address or os.environ.get("PYHMMER_TPU_COORD")
    pid = process_id if process_id is not None else int(
        os.environ.get("PYHMMER_TPU_PROC", "0"))
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=num, process_id=pid)
    return num


def encode_tophits(th) -> np.ndarray:
    """Serialize a partial ``TopHits`` (hits + the accounting the merge
    contract needs) into a flat uint8 record array."""
    from ..daemon import _serialize_hit

    setby = {"ntargets": 0, "option": 1, "fixed": 2}
    hit_blobs = [_serialize_hit(h, dp=True) for h in th.hits]
    head = _MAGIC + struct.pack(
        ">2d2B4q8q",
        float(th.Z), float(th.domZ),
        setby.get(th.Z_setby, 0), setby.get(th.domZ_setby, 0),
        int(th.nmodels), int(th.nseqs), int(th.nres), int(th.nnodes),
        int(th.n_past_msv), int(th.n_past_bias), int(th.n_past_vit),
        int(th.n_past_fwd), int(th.query_length or 0), len(hit_blobs),
        0, 0,
    )
    qn = th.query_name or b""
    qa = th.query_accession or b""
    head += struct.pack(">2I", len(qn), len(qa)) + qn + qa
    payload = head + b"".join(hit_blobs)
    return np.frombuffer(payload, dtype=np.uint8).copy()


def decode_tophits(buf: np.ndarray):
    """Inverse of :func:`encode_tophits`; returns a ``TopHits`` whose
    hits/flags/accounting round-trip exactly."""
    from ..daemon import _Reader, _deserialize_hit
    from ..plan7.results import TopHits

    raw = bytes(np.asarray(buf, dtype=np.uint8).tobytes())
    if raw[:4] != _MAGIC:
        raise ValueError("bad multihost TopHits record")
    r = _Reader(raw[4:])
    (Z, domZ, z_setby, domz_setby, nmodels, nseqs, nres, nnodes,
     n_past_msv, n_past_bias, n_past_vit, n_past_fwd, qlen, nhits,
     _r0, _r1) = r.take(">2d2B4q8q")
    nqn, nqa = r.take(">2I")
    qn = r.buf[r.pos: r.pos + nqn]
    qa = r.buf[r.pos + nqn: r.pos + nqn + nqa]
    r.pos += nqn + nqa

    th = TopHits()
    setby = {0: "ntargets", 1: "option", 2: "fixed"}
    th.Z, th.domZ = Z, domZ
    th.Z_setby = setby[z_setby]
    th.domZ_setby = setby[domz_setby]
    th.nmodels, th.nseqs, th.nres, th.nnodes = (nmodels, nseqs, nres,
                                                nnodes)
    th.n_past_msv, th.n_past_bias = n_past_msv, n_past_bias
    th.n_past_vit, th.n_past_fwd = n_past_vit, n_past_fwd
    th.query_name = qn or None
    th.query_accession = qa or None
    th.query_length = qlen or None
    for _ in range(nhits):
        th.hits.append(_deserialize_hit(th, r, dp=True))
    return th


def allgather_bytes(payload: np.ndarray) -> List[np.ndarray]:
    """Exchange one uint8 array per process; returns every process's
    payload in process order.  Arrays are padded to the global max
    length (fixed width across the collective) and sliced back after
    the gather.  Single-process: identity."""
    import jax

    if jax.process_count() == 1:
        return [np.asarray(payload, dtype=np.uint8)]
    from jax.experimental import multihost_utils

    n = np.asarray(payload, dtype=np.uint8)
    lengths = multihost_utils.process_allgather(
        np.array([n.size], dtype=np.int64))
    lengths = np.asarray(lengths).reshape(-1)
    width = int(lengths.max())
    padded = np.zeros(width, dtype=np.uint8)
    padded[: n.size] = n
    gathered = np.asarray(multihost_utils.process_allgather(padded))
    return [gathered[i, : int(lengths[i])]
            for i in range(gathered.shape[0])]


def multihost_search(queries, targets, engine=None, **options):
    """Distributed hmmsearch: this process searches its residue-balanced
    target shard, partial hits are allgathered as fixed-width records,
    and every process returns the identical merged ``TopHits`` list.

    ``targets`` is the FULL target block (every process computes the
    same deterministic shard split).  Degenerate on one process:
    equivalent to ``SearchEngine.search``."""
    import jax

    from ..easel.sequence import DigitalSequenceBlock
    from ..engine import SearchEngine
    from .mesh import residue_balanced_chunks

    queries = list(queries)
    if not queries:
        return []
    nproc = jax.process_count()
    pid = jax.process_index()
    if engine is None:
        engine = SearchEngine(queries[0].alphabet, **options)

    if nproc == 1:
        return engine.search(queries, targets)

    chunks = residue_balanced_chunks(targets, nproc)
    while len(chunks) < nproc:           # more processes than targets
        chunks.append([])
    local = DigitalSequenceBlock(targets.alphabet,
                                 (targets[i] for i in chunks[pid]))
    partials = engine.search(queries, local)

    merged = []
    for qi in range(len(queries)):
        blobs = allgather_bytes(encode_tophits(partials[qi]))
        parts = [decode_tophits(b) for b in blobs]
        # deterministic merge order = process order; local partial is
        # replaced by its own round-tripped copy so every process merges
        # identical inputs (byte-identical output on all ranks)
        merged.append(parts[0].merge(*parts[1:]))
    return merged
