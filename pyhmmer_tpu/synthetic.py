"""Seeded synthetic search workloads.

The workloads are generated from a seed at the shapes of the pyhmmer
benchmark (``BASELINE.md``: Pfam profile HMMs against the 4,489 proteins
of the *E. coli* proteome), so nothing has to be downloaded:

* **queries** are profile HMMs built by :class:`plan7.builder.Builder`
  (with calibrated E-value parameters) from seeded protein families, one
  alignment of mutated members per family, with model lengths drawn from
  a Pfam-like mix (:data:`PFAM_LENGTH_MIX`);
* **targets** have background composition and heavy-tailed lengths, with
  at least one target on every level of the engine's length ladder, and
  some carry planted, mutated members of the query families (so hits,
  domain definition and null2 do real work);
* the **DNA** workload is one nucleotide family model and a genome with
  planted copies on both strands, for nhmmer.

Example:
    >>> from pyhmmer_tpu import synthetic
    >>> hmms, targets = synthetic.doctest_workload()
    >>> len(hmms), len(targets)
    (2, 48)
    >>> all(h.evparam[0] != 0 for h in hmms)     # calibrated
    True
"""

from __future__ import annotations

import functools
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np

from .easel.alphabet import Alphabet
from .easel.msa import DigitalMSA
from .easel.sequence import DigitalSequence, DigitalSequenceBlock
from .plan7.background import Background
from .plan7.builder import Builder
from .plan7.hmm import HMM

__all__ = ["PFAM_LENGTH_MIX", "LADDER_LENGTHS", "model_lengths",
           "make_family", "mutate", "build_queries", "make_targets",
           "protein_workload", "dna_workload", "small_workload",
           "doctest_workload"]

#: Pfam-like model-length mix, ``(lo, hi, weight)`` node-count bins: the
#: replication weights of the benchmark's length-varied query stack,
#: skewed toward short models with a thin tail past 768 nodes
PFAM_LENGTH_MIX = ((50, 110, 20), (110, 160, 13), (160, 280, 10),
                   (280, 480, 7), (480, 650, 4), (650, 1100, 3))

#: one target length per level of the engine's bucket ladder above the
#: first (512 < L <= 2048, 2048 < L <= 8192, L > 8192)
LADDER_LENGTHS = (1500, 4000, 9000)


def model_lengths(n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` model lengths from :data:`PFAM_LENGTH_MIX`; the longest bin
    is always represented once ``n >= len(PFAM_LENGTH_MIX)``."""
    w = np.array([b[2] for b in PFAM_LENGTH_MIX], dtype=np.float64)
    bins = rng.choice(len(w), size=n, p=w / w.sum())
    if n >= len(w):
        bins[: len(w)] = np.arange(len(w))      # every bin at least once
    lo = np.array([PFAM_LENGTH_MIX[b][0] for b in bins])
    hi = np.array([PFAM_LENGTH_MIX[b][1] for b in bins])
    return rng.integers(lo, hi)


def _background(alphabet: Alphabet) -> np.ndarray:
    f = np.asarray(Background(alphabet).residue_frequencies, np.float64)
    return f / f.sum()


def mutate(seq: np.ndarray, rng: np.random.Generator, freqs: np.ndarray,
           sub: float, indel: float = 0.0) -> np.ndarray:
    """A mutated copy of ``seq``: each residue is replaced by a background
    draw with probability ``sub``; with probability ``indel`` each
    position is deleted, and with the same probability 1-3 background
    residues are inserted after it."""
    K = len(freqs)
    out = seq.copy()
    hit = rng.random(len(out)) < sub
    out[hit] = rng.choice(K, size=int(hit.sum()), p=freqs)
    if indel <= 0:
        return out
    keep = rng.random(len(out)) >= indel
    ins = rng.random(len(out)) < indel
    parts = []
    for i in np.flatnonzero(keep | ins):
        if keep[i]:
            parts.append(out[i: i + 1])
        if ins[i]:
            parts.append(rng.choice(K, size=int(rng.integers(1, 4)),
                                    p=freqs).astype(np.uint8))
    return np.concatenate(parts) if parts else out[:0]


def make_family(alphabet: Alphabet, M: int, rng: np.random.Generator,
                name: bytes, nseq: int = 10, sub: float = 0.3,
                gap: float = 0.05) -> Tuple[np.ndarray, DigitalMSA]:
    """A protein family: a background-drawn consensus of ``M`` residues
    and an alignment of ``nseq`` members (substitutions and gapped
    deletions, one column per consensus position)."""
    freqs = _background(alphabet)
    cons = rng.choice(len(freqs), size=M, p=freqs).astype(np.uint8)
    rows = []
    for i in range(nseq):
        row = mutate(cons, rng, freqs, sub)
        row[rng.random(M) < gap] = alphabet.gap_code
        rows.append(DigitalSequence(alphabet, name=name + b"/%d" % i,
                                    sequence=row))
    return cons, DigitalMSA(alphabet, name=name, sequences=rows)


def build_queries(alphabet: Alphabet, lengths: Sequence[int],
                  rng: np.random.Generator) -> Tuple[List[HMM], list]:
    """One calibrated HMM per family; returns ``(hmms, consensi)``.

    The families are drawn serially from ``rng``; the builds (each with
    its own seeded builder) run on a thread pool, since calibration
    spends most of its time in native and device calls that release the
    GIL.  The result does not depend on the thread count."""
    bg = Background(alphabet)
    builder = Builder(alphabet)
    fams = [make_family(alphabet, int(M), rng, b"synfam%04d" % fi)
            for fi, M in enumerate(lengths)]

    def build(fi):
        hmm, _, _ = builder.copy().build_msa(fams[fi][1], bg)
        hmm.name = b"synfam%04d" % fi
        hmm.accession = b"SYN%05d.1" % fi
        hmm.description = b"synthetic family %d" % fi
        return hmm

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        hmms = list(pool.map(build, range(len(fams))))
    return hmms, [f[0] for f in fams]


def make_targets(alphabet: Alphabet, n: int, consensi: Sequence[np.ndarray],
                 rng: np.random.Generator, plant_frac: float = 0.15,
                 ladder: bool = True) -> DigitalSequenceBlock:
    """``n`` proteome-like targets: log-normal lengths (median ~270, like
    a bacterial proteome), one target per :data:`LADDER_LENGTHS` entry
    when ``ladder``, and a planted mutated family member (substitutions
    at 20-50 %, small indels) in about ``plant_frac`` of them."""
    freqs = _background(alphabet)
    lengths = np.clip(np.rint(rng.lognormal(np.log(270.0), 0.6, n)),
                      40, 2000).astype(np.int64)
    if ladder:
        lengths[: len(LADDER_LENGTHS)] = LADDER_LENGTHS
    seqs = []
    bgall = rng.choice(len(freqs), size=int(lengths.sum()) + n * 64,
                       p=freqs).astype(np.uint8)
    off = 0
    for i, L in enumerate(lengths):
        if consensi and rng.random() < plant_frac:
            cons = consensi[int(rng.integers(len(consensi)))]
            dom = mutate(cons, rng, freqs, float(rng.uniform(0.2, 0.5)),
                         indel=0.02)
            L = max(int(L), len(dom) + 20)
            if off + L > len(bgall):
                bgall = np.concatenate([bgall, rng.choice(
                    len(freqs), size=L, p=freqs).astype(np.uint8)])
            seq = bgall[off: off + L].copy()
            at = int(rng.integers(0, L - len(dom) + 1))
            seq[at: at + len(dom)] = dom
        else:
            if off + L > len(bgall):
                bgall = np.concatenate([bgall, rng.choice(
                    len(freqs), size=L, p=freqs).astype(np.uint8)])
            seq = bgall[off: off + L].copy()
        off += L
        seqs.append(DigitalSequence(alphabet, name=b"synprot%05d" % i,
                                    description=b"synthetic protein",
                                    sequence=seq))
    order = rng.permutation(n)
    return DigitalSequenceBlock(alphabet, [seqs[i] for i in order])


def protein_workload(n_queries: int = 400, n_targets: int = 4489,
                     seed: int = 0) -> Tuple[List[HMM], DigitalSequenceBlock]:
    """The Pfam x proteome workload: ``n_queries`` built HMMs (Pfam has
    18,259) against ``n_targets`` proteins (the *E. coli* proteome has
    4,489)."""
    rng = np.random.default_rng(seed)
    alphabet = Alphabet.amino()
    hmms, consensi = build_queries(alphabet, model_lengths(n_queries, rng),
                                   rng)
    targets = make_targets(alphabet, n_targets, consensi, rng)
    return hmms, targets


def dna_workload(genome_len: int = 2_000_000, M: int = 300, copies: int = 8,
                 seed: int = 0) -> Tuple[HMM, DigitalSequenceBlock]:
    """One nucleotide family model and a random genome of ``genome_len``
    bases with ``copies`` planted members (10 % substitutions), every
    other one reverse-complemented so both strands carry hits."""
    rng = np.random.default_rng(seed)
    alphabet = Alphabet.dna()
    name = b"syndna"
    cons, msa = make_family(alphabet, M, rng, name, sub=0.15)
    hmm, _, _ = Builder(alphabet).build_msa(msa, Background(alphabet))
    hmm.name = name
    freqs = _background(alphabet)
    genome = rng.choice(len(freqs), size=genome_len, p=freqs).astype(
        np.uint8)
    comp = np.array([3, 2, 1, 0], dtype=np.uint8)     # ACGT -> TGCA
    stride = genome_len // (copies + 1)
    for c in range(copies):
        dom = mutate(cons, rng, freqs, 0.10)
        if c % 2:
            dom = comp[dom[::-1]].astype(np.uint8)
        at = (c + 1) * stride - len(dom) // 2
        genome[at: at + len(dom)] = dom
    chrom = DigitalSequence(alphabet, name=b"synchr",
                            description=b"synthetic genome",
                            sequence=genome)
    return hmm, DigitalSequenceBlock(alphabet, [chrom])


def small_workload(n_targets: int = 200, lengths: Sequence[int] = (80, 130),
                   seed: int = 11, plant_frac: float = 0.2
                   ) -> Tuple[List[HMM], DigitalSequenceBlock]:
    """A few built queries against ``n_targets`` short targets, about
    ``plant_frac`` of them carrying a planted family member (for tests
    and multi-process checks: every process that calls it with the same
    arguments gets the same workload)."""
    rng = np.random.default_rng(seed)
    alphabet = Alphabet.amino()
    hmms, consensi = build_queries(alphabet, lengths, rng)
    targets = make_targets(alphabet, n_targets, consensi, rng,
                           plant_frac=plant_frac, ladder=False)
    return hmms, targets


@functools.lru_cache(maxsize=None)
def doctest_workload() -> Tuple[List[HMM], DigitalSequenceBlock]:
    """The fixed workload of the examples: 2 queries against 48 targets,
    about a third of them carrying a planted family member.  Cached: every
    caller gets the same objects, so callers must not modify them."""
    return small_workload(48, (60, 90), seed=7, plant_frac=0.35)
