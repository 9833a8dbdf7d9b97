"""Multi-chip sharded search.

The device-parallel analog of the reference's distribution mechanisms
(SURVEY.md §2.6): the ``_ReverseSEARCHDispatcher``'s residue-balanced
target chunks become a *data*-sharded sequence batch; hmmscan's profile
database sharding becomes a *model*-sharded profile stack; the hmmpgmd
master/worker hit merge becomes an XLA cross-device reduction + host-side
``TopHits.merge`` (sum auto-Z, re-threshold -- ``plan7.pyx:8860-8964``).

Because every (profile, sequence) pair is independent, the cascade
kernels shard cleanly over a ``("model", "data")`` mesh with zero
communication until the merge step; XLA inserts the collectives for the
reduction outputs automatically from the sharding annotations.
"""

from __future__ import annotations

import numpy as np
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import batch as B

__all__ = ["make_mesh", "ShardedCascade", "sharded_search",
           "sharded_nhmmer", "residue_balanced_chunks"]


def make_mesh(n_model: int = 1, n_data: Optional[int] = None,
              devices=None) -> Mesh:
    """Build a ("model", "data") mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_data is None:
        n_data = n // n_model
    arr = np.array(devices[: n_model * n_data]).reshape(n_model, n_data)
    return Mesh(arr, ("model", "data"))


def _pad_to(x: np.ndarray, axis: int, mult: int, fill) -> np.ndarray:
    n = x.shape[axis]
    target = ((n + mult - 1) // mult) * mult
    if target == n:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - n)
    return np.pad(x, pad, constant_values=fill)


class ShardedCascade:
    """Run the filter cascade with profiles sharded over the ``model``
    axis and target sequences sharded over the ``data`` axis."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n_model = mesh.shape["model"]
        self.n_data = mesh.shape["data"]

    def _shard(self, arr, spec):
        return jax.device_put(jnp.asarray(arr),
                              NamedSharding(self.mesh, spec))

    def msv(self, pb: "B.ProfileBatch", codes: np.ndarray,
            lengths: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
        """Sharded quantized MSV over all (profile, sequence) pairs.

        Returns ``(usc[P, B] nats, overflow[P, B], n_pass)`` where
        ``n_pass`` is produced by a cross-device reduction (the collective
        the hit-merge contract rides on).
        """
        P_, Breal = pb.P, codes.shape[0]
        codes_p = _pad_to(codes, 0, self.n_data, 0)
        lengths_p = _pad_to(lengths, 0, self.n_data, 0)
        mask = (np.arange(codes_p.shape[1])[None, :] < lengths_p[:, None])
        scale = pb.scale_b
        tjb = np.minimum(255, np.rint(-scale * np.log(
            3.0 / (np.maximum(lengths_p, 1).astype(np.float64) + 3.0))))

        cost = self._shard(_pad_to(pb.msv_cost, 0, self.n_model, 255.0),
                           P("model", None, None))
        bias = self._shard(_pad_to(pb.msv_bias, 0, self.n_model, 0.0),
                           P("model"))
        tec = self._shard(_pad_to(pb.msv_tec, 0, self.n_model, 0.0),
                          P("model"))
        tbm = self._shard(_pad_to(pb.msv_tbm, 0, self.n_model, 0.0),
                          P("model"))
        codes_d = self._shard(codes_p.astype(np.int32), P("data", None))
        mask_d = self._shard(mask.astype(np.float32), P("data", None))
        tjb_d = self._shard(tjb.astype(np.float32), P("data"))

        dx, ovf = B._msv_kernel(codes_d, mask_d, cost, bias, tec, tbm,
                                tjb_d)
        # cross-device reduction: number of passing pairs (replicated out)
        n_pass = int(jnp.sum((dx > 0) & ~ovf))
        usc = ((np.asarray(dx, np.float64)[:P_, :Breal]
                - tjb[None, :Breal]) / scale - 3.0)
        ovf_np = np.asarray(ovf)[:P_, :Breal]
        usc[ovf_np] = np.inf
        return usc, ovf_np, n_pass

    def forward(self, pb: "B.ProfileBatch", codes: np.ndarray,
                lengths: np.ndarray) -> np.ndarray:
        """Sharded Forward scores [P, B] in nats."""
        P_, Breal = pb.P, codes.shape[0]
        codes_p = _pad_to(codes, 0, self.n_data, 0)
        lengths_p = np.maximum(_pad_to(lengths, 0, self.n_data, 0), 0)
        Lf = np.maximum(lengths_p, 1).astype(np.float64)
        pmove = 3.0 / (Lf + 3.0)
        mask = (np.arange(codes_p.shape[1])[None, :] < lengths_p[:, None])

        def sp(name, arr, spec):
            return self._shard(arr, spec)

        args = dict(
            msc=sp("msc", _pad_to(pb.msc, 0, self.n_model, B.NEGMASS),
                   P("model", None, None)),
            isc=sp("isc", _pad_to(pb.isc, 0, self.n_model, B.NEGMASS),
                   P("model", None, None)),
        )
        tr = {}
        for nm in ("tMM", "tIM", "tDM", "tMD", "tDD", "tBM", "tMI", "tII"):
            fill = 0.0 if nm == "tDD" else B.NEGMASS
            tr[nm] = sp(nm, _pad_to(getattr(pb, nm), 0, self.n_model, fill),
                        P("model", None))
        kmask = sp("kmask", _pad_to(pb.kmask, 0, self.n_model, False),
                   P("model", None))
        out = B._forward_kernel(
            self._shard(codes_p.astype(np.int32), P("data", None)),
            self._shard(mask, P("data", None)),
            args["msc"], args["isc"], tr["tMM"], tr["tIM"], tr["tDM"],
            tr["tMD"], tr["tDD"], tr["tBM"], tr["tMI"], tr["tII"], kmask,
            np.float32(np.log(0.5)), np.float32(np.log(0.5)),
            self._shard(np.log(1.0 - pmove).astype(np.float32), P("data")),
            self._shard(np.log(pmove).astype(np.float32), P("data")))
        return np.asarray(out, np.float64)[:P_, :Breal]


def residue_balanced_chunks(targets, n_chunks: int):
    """Split a target block into ~residue-balanced contiguous chunks
    (the reference's ``_ReverseSEARCHDispatcher`` splitting rule,
    ``hmmer/_hmmsearch.py:115-289``).  Returns a list of index lists."""
    lengths = np.array([len(s) for s in targets], dtype=np.int64)
    total = int(lengths.sum())
    per = max(1, total // max(1, n_chunks))
    chunks, cur, acc = [], [], 0
    for i, ln in enumerate(lengths):
        cur.append(i)
        acc += int(ln)
        if acc >= per and len(chunks) < n_chunks - 1:
            chunks.append(cur)
            cur, acc = [], 0
    if cur:
        chunks.append(cur)
    return chunks


def sharded_search(queries, targets, n_shards: Optional[int] = None,
                   engine_factory=None, devices=None,
                   concurrent: bool = True, **options):
    """Data-parallel hmmsearch over the device set: targets split
    residue-balanced into ``n_shards`` chunks, one ``SearchEngine`` per
    chunk PINNED to its own device (``jax.default_device``), partial
    ``TopHits`` merged with the reference's contract (concatenate, sum
    auto-Z, re-threshold -- ``TopHits.merge``).

    Shards run on one **thread per shard** (the device analog of the
    reference's concurrent target-parallel workers,
    ``hmmer/_hmmsearch.py:115-289``): each engine's device dispatch is
    asynchronous and its blocking fetches plus the native domaindef pool
    release the GIL, so shard k+1's device cascade genuinely overlaps
    shard k's host postprocessing instead of waiting for its full
    search to return.  The merged output is hit-for-hit identical to a
    single-shot search (pinned by ``tests/test_apps.py`` on the virtual
    8-device CPU mesh and by ``__graft_entry__.dryrun_multichip``).

    Per-shard wall times and the achieved overlap factor
    ``sum(per-shard wall) / total wall`` are left in
    ``sharded_search.last_stats`` after each call.

    Returns one merged ``TopHits`` per query, in query order.
    """
    import concurrent.futures as _cf
    import time as _time

    from ..easel.sequence import DigitalSequenceBlock
    from ..engine import SearchEngine

    queries = list(queries)
    if not queries:
        return []
    devices = list(devices) if devices is not None else jax.devices()
    n_shards = n_shards or max(1, len(devices))
    chunks = residue_balanced_chunks(targets, n_shards)
    alphabet = queries[0].alphabet
    # one host-wide native worker pool shared by every shard engine
    # (per-engine pools would oversubscribe the host cores)
    import os as _os
    shared_pool = _cf.ThreadPoolExecutor(
        int(_os.environ.get("PYHMMER_TPU_THREADS", "0"))
        or max(2, _os.cpu_count() or 2))
    if engine_factory is None:
        def engine_factory(device):
            return SearchEngine(alphabet, device=device,
                                shared_executor=shared_pool, **options)

    # engines + shard blocks built up front (model-cache warm-up happens
    # inside each engine's first search, on its own thread)
    shard_jobs = []
    for si, chunk in enumerate(chunks):
        block = DigitalSequenceBlock(targets.alphabet,
                                     (targets[i] for i in chunk))
        shard_jobs.append((engine_factory(devices[si % len(devices)]),
                           block))

    walls = [0.0] * len(shard_jobs)

    def _run(si):
        eng, block = shard_jobs[si]
        t0 = _time.time()
        out = eng.search(queries, block)
        walls[si] = _time.time() - t0
        return out

    t_total = _time.time()
    if concurrent and len(shard_jobs) > 1:
        with _cf.ThreadPoolExecutor(len(shard_jobs)) as ex:
            partials = list(ex.map(_run, range(len(shard_jobs))))
    else:
        partials = [_run(si) for si in range(len(shard_jobs))]
    total_wall = _time.time() - t_total
    shared_pool.shutdown()

    sharded_search.last_stats = {
        "n_shards": len(shard_jobs),
        "shard_walls": [round(w, 4) for w in walls],
        "total_wall": round(total_wall, 4),
        "overlap_factor": round(sum(walls) / max(total_wall, 1e-9), 3),
    }

    merged = []
    for qi in range(len(queries)):
        first = partials[0][qi]
        merged.append(first.merge(*(p[qi] for p in partials[1:])))
    return merged


def sharded_nhmmer(query, targets, n_shards: Optional[int] = None,
                   devices=None, concurrent: bool = True, **options):
    """Sequence-length-parallel nhmmer: the reference's window dimension
    (``LongTargetsPipeline`` windows, SURVEY.md section 2.6
    sequence-parallel row) sharded across devices.

    Long targets are cut into residue-balanced contiguous slices with a
    ``max_length``-residue halo (any reportable hit fits entirely inside
    one slice, the same guarantee the in-pipeline W/C window overlap
    provides); one pipeline per shard runs on its own thread pinned to
    its own device; per-slice hit coordinates are shifted back to
    global positions and cross-slice duplicates from the halo are
    removed with the best-E-value rule (``p7_tophits_RemoveDuplicates``)
    exactly like cross-window duplicates inside one pipeline.  E-values
    are computed against the GLOBAL residue count (each shard gets the
    total as a manual Z), so the merged output matches the single-shot
    search.

    Returns one merged ``TopHits`` for the query.
    """
    import concurrent.futures as _cf

    from ..easel.sequence import DigitalSequence, DigitalSequenceBlock
    from ..plan7.longtargets import (LongTargetsPipeline,
                                     compute_max_length,
                                     _remove_duplicates)
    from ..plan7.results import TopHits

    targets = list(targets)
    devices = list(devices) if devices is not None else jax.devices()
    n_shards = n_shards or max(1, len(devices))
    C = options.get("window_length") or compute_max_length(
        query, options.get("window_beta") or 7e-5)
    total = sum(len(s) for s in targets)
    stride = max(C + 1, -(-total // n_shards))

    # build per-shard slice lists [(global_start0, full_len, sub)] --
    # slices overlap by C residues so boundary hits appear (and are
    # deduplicated) in exactly one or two shards.  Each slice's global
    # offset rides in its name ("name//offset") so hits map back
    # unambiguously; the original name is restored after the shift.
    shards = [[] for _ in range(n_shards)]
    si = 0
    for t, sq in enumerate(targets):
        L = len(sq)
        a = 0
        while a < L:
            b = min(L, a + stride + C)
            sub = DigitalSequence(
                sq.alphabet, name=sq.name + b"//%d" % a,
                accession=sq.accession, description=sq.description,
                sequence=sq.sequence[a: b])
            shards[si % n_shards].append((a, L, sub))
            si += 1
            if b >= L:
                break
            a += stride

    # each shard computes E-values over the GLOBAL residue count
    opts = dict(options)
    opts["Z"] = total / 1e6

    def _run(k):
        chunk = shards[k]
        if not chunk:
            return None
        pli = LongTargetsPipeline(query.alphabet, **opts)
        block = DigitalSequenceBlock(query.alphabet,
                                     [e[2] for e in chunk])
        with jax.default_device(devices[k % len(devices)]):
            th = pli.search_hmm(query, block)
        return (chunk, th, pli)

    if concurrent and n_shards > 1:
        with _cf.ThreadPoolExecutor(n_shards) as ex:
            runs = list(ex.map(_run, range(n_shards)))
    else:
        runs = [_run(k) for k in range(n_shards)]

    merged = TopHits()
    merged.query_name = query.name
    merged.query_accession = query.accession or None
    merged.query_length = query.M
    merged._mode = "search"
    merged.long_targets = True
    by_tag = {e[2].name: (e[0], e[1]) for sh in shards for e in sh}
    first = True
    for run in runs:
        if run is None:
            continue
        chunk, th, pli = run
        for h in th.hits:
            a0, Lfull = by_tag[h.name]
            h.name = h.name.rsplit(b"//", 1)[0]
            h.length = Lfull
            for d in h.domains:
                d.env_from += a0
                d.env_to += a0
                d.ali_from += a0
                d.ali_to += a0
                if d.alignment is not None:
                    d.alignment.target_from += a0
                    d.alignment.target_to += a0
                    d.alignment.target_length = Lfull
                    d.alignment.target_name = h.name
            h.hits = merged
            merged.hits.append(h)
        if first:
            merged._take_accounting(pli)
            first = False
        else:
            merged.nseqs += pli.nseqs
            merged.nres += pli.nres
            merged.n_past_msv += pli.n_past_msv
            merged.n_past_bias += pli.n_past_bias
            merged.n_past_vit += pli.n_past_vit
            merged.n_past_fwd += pli.n_past_fwd
        merged.bit_cutoffs = pli.bit_cutoffs
    merged.nseqs = len(targets)
    merged.Z = merged.domZ = 1.0
    merged.Z_setby = merged.domZ_setby = "option"
    merged.sort_by_seqidx()
    _remove_duplicates(merged)
    merged.sort_by_key()
    merged.threshold()
    return merged
