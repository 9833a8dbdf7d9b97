"""Search results: Alignment, Domain, Hit, TopHits.

Mirrors the object model of ``pyhmmer.plan7`` (reference
``src/pyhmmer/plan7.pyx``: ``Alignment`` :228-425, ``Domain`` :1440-1687,
``Hit`` :1849-2234, ``TopHits`` :8000-8965) including the merge/threshold
semantics the distributed layer relies on (``TopHits.merge``,
``plan7.pyx:8860-8964``: concatenate, sum auto-Z, re-threshold).
"""

from __future__ import annotations

import math
import numpy as np
from typing import List, Optional, TYPE_CHECKING

from .evalues import exp_logsurv
from .views import Domains

LOG2 = math.log(2.0)

# hit flags (p7_hitflags_e)
F_INCLUDED = 1 << 0
F_REPORTED = 1 << 1
F_NEW = 1 << 2
F_DROPPED = 1 << 3
F_DUPLICATE = 1 << 4


class Alignment:
    """An alignment of one domain to the profile (``P7_ALIDISPLAY`` view)."""

    __slots__ = (
        "hmm_name", "hmm_accession", "hmm_from", "hmm_to", "hmm_sequence",
        "target_name", "target_from", "target_to", "target_sequence",
        "identity_sequence", "posterior_probabilities", "hmm_length",
        "target_length",
    )

    def __init__(self, **kw):
        for s in self.__slots__:
            setattr(self, s, kw.get(s))

    def __len__(self) -> int:
        return len(self.hmm_sequence or "")


class Domain:
    """One domain of a hit (``P7_DOMAIN`` view,
    ``include/libhmmer/p7_domain.pxd:10-27``)."""

    __slots__ = (
        "hit", "env_from", "env_to", "ali_from", "ali_to", "score", "bias",
        "correction", "envelope_score", "oasc", "lnP", "alignment", "flags",
    )

    def __init__(self, hit, env_from, env_to, ali_from, ali_to, score, bias,
                 correction, envelope_score, oasc, lnP, alignment):
        self.hit = hit
        self.env_from = env_from
        self.env_to = env_to
        self.ali_from = ali_from
        self.ali_to = ali_to
        self.score = score                       # bits
        # constructor takes nats (pipeline internals); the public
        # attributes are in bits like the reference's properties
        # (``plan7.pyx:1535-1555``: dombias/domcorrection/envsc * LOG2R)
        self.bias = bias / LOG2
        self.correction = correction / LOG2
        self.envelope_score = envelope_score / LOG2
        self.oasc = oasc
        self.lnP = lnP
        self.alignment = alignment
        self.flags = 0

    @property
    def included(self) -> bool:
        return bool(self.flags & F_INCLUDED)

    @property
    def reported(self) -> bool:
        return bool(self.flags & F_REPORTED)

    @property
    def pvalue(self) -> float:
        return math.exp(self.lnP)

    @property
    def c_evalue(self) -> float:
        """Conditional E-value (within reported targets; uses domZ)."""
        return math.exp(self.lnP) * self.hit.hits.domZ

    @property
    def i_evalue(self) -> float:
        """Independent E-value (uses Z)."""
        return math.exp(self.lnP) * self.hit.hits.Z


class Hit:
    """One target hit (``P7_HIT`` view, ``include/libhmmer/p7_hit.pxd``)."""

    def __init__(self, hits, name: bytes, accession: Optional[bytes],
                 description: Optional[bytes], length: int,
                 score: float, pre_score: float, sum_score: float,
                 lnP: float, nexpected: float, nregions: int,
                 nclustered: int, noverlaps: int, nenvelopes: int):
        self.hits = hits
        self.name = name
        self.accession = accession
        self.description = description
        self.length = length
        self.score = score
        self.pre_score = pre_score
        self.sum_score = sum_score
        self.lnP = lnP
        self.nexpected = nexpected
        self.nregions = nregions
        self.nclustered = nclustered
        self.noverlaps = noverlaps
        self.nenvelopes = nenvelopes
        self.domains: Domains = Domains(self)
        self.best_domain_idx = 0
        self.flags = F_NEW

    @property
    def bias(self) -> float:
        return self.pre_score - self.score

    @property
    def pvalue(self) -> float:
        return math.exp(self.lnP)

    @property
    def evalue(self) -> float:
        return math.exp(self.lnP) * self.hits.Z

    @property
    def best_domain(self) -> Domain:
        return self.domains[self.best_domain_idx]

    # --- flags ---------------------------------------------------------------

    @property
    def included(self) -> bool:
        return bool(self.flags & F_INCLUDED)

    @included.setter
    def included(self, v: bool):
        self.flags = (self.flags | F_INCLUDED) if v else (self.flags & ~F_INCLUDED)

    @property
    def reported(self) -> bool:
        return bool(self.flags & F_REPORTED)

    @reported.setter
    def reported(self, v: bool):
        self.flags = (self.flags | F_REPORTED) if v else (self.flags & ~F_REPORTED)

    @property
    def dropped(self) -> bool:
        return bool(self.flags & F_DROPPED)

    @property
    def duplicate(self) -> bool:
        return bool(self.flags & F_DUPLICATE)

    @property
    def ndom(self) -> int:
        return len(self.domains)

    @property
    def nreported(self) -> int:
        return sum(1 for d in self.domains if d.reported)

    @property
    def nincluded(self) -> int:
        return sum(1 for d in self.domains if d.included)


class TopHits:
    """Collection of hits + pipeline accounting for E-values/thresholds.

    Example:
        >>> import io
        >>> from pyhmmer_tpu import hmmer, synthetic
        >>> hmms, targets = synthetic.doctest_workload()
        >>> ta = next(hmmer.hmmsearch(hmms[1], targets[:24]))
        >>> tb = next(hmmer.hmmsearch(hmms[1], targets[24:]))
        >>> merged = ta.merge(tb)     # sums auto-Z, re-thresholds
        >>> merged.Z, len(merged.reported)
        (48.0, 8)
        >>> out = io.StringIO()
        >>> merged.write(out, format="targets")   # --tblout format
        >>> out.getvalue().startswith("#")
        True
    """

    def __init__(self, pipeline=None):
        self.hits: List[Hit] = []
        # snapshot of pipeline accounting + thresholds (plan7.pxd:415-421)
        self.Z: float = 0.0
        self.domZ: float = 0.0
        self.Z_setby: str = "ntargets"   # 'ntargets' | 'option'
        self.domZ_setby: str = "ntargets"
        self.E = 10.0
        self.domE = 10.0
        self.T = None
        self.domT = None
        self.incE = 0.01
        self.incdomE = 0.01
        self.incT = None
        self.incdomT = None
        self.bit_cutoffs = None
        self.long_targets = False
        # accounting counters (p7_pipeline.pxd:88-101)
        self.nmodels = 0
        self.nseqs = 0
        self.nres = 0
        self.nnodes = 0
        self.n_past_msv = 0
        self.n_past_bias = 0
        self.n_past_vit = 0
        self.n_past_fwd = 0
        self.query_name: Optional[bytes] = None
        self.query_accession: Optional[bytes] = None
        self.query_length: int = 0
        if pipeline is not None:
            self._take_accounting(pipeline)

    def _take_accounting(self, pli):
        for attr in ("Z", "domZ", "Z_setby", "domZ_setby", "E", "domE", "T",
                     "domT", "incE", "incdomE", "incT", "incdomT",
                     "bit_cutoffs", "long_targets", "nmodels", "nseqs",
                     "nres", "nnodes", "n_past_msv", "n_past_bias",
                     "n_past_vit", "n_past_fwd"):
            setattr(self, attr, getattr(pli, attr))

    # --- container protocol ---------------------------------------------------

    def __len__(self) -> int:
        return len(self.hits)

    def __iter__(self):
        return iter(self.hits)

    def __getitem__(self, i):
        return self.hits[i]

    @property
    def searched_models(self) -> int:
        return self.nmodels

    @property
    def searched_sequences(self) -> int:
        return self.nseqs

    @property
    def searched_residues(self) -> int:
        return self.nres

    @property
    def searched_nodes(self) -> int:
        return self.nnodes

    @property
    def reported(self):
        return [h for h in self.hits if h.reported]

    @property
    def included(self):
        return [h for h in self.hits if h.included]

    # --- sorting / thresholding ------------------------------------------------

    @property
    def mode(self) -> str:
        """``"search"`` or ``"scan"`` (reference ``TopHits.mode``)."""
        return getattr(self, "_mode", "search")

    @property
    def query(self):
        """The query object this collection was produced from (HMM /
        sequence / MSA), when the caller recorded it."""
        return getattr(self, "_query", None)

    @query.setter
    def query(self, v):
        self._query = v

    @property
    def query_name(self):
        return self._query_name

    @query_name.setter
    def query_name(self, v):
        self._query_name = v

    @property
    def strand(self):
        """Strand searched for long-target (nhmmer) results, else None."""
        return getattr(self, "_strand", None)

    @property
    def block_length(self):
        """Window block length used by the long-targets pipeline."""
        return getattr(self, "_block_length", None)

    def copy(self) -> "TopHits":
        """A deep copy of the hit collection (reference
        ``TopHits.copy``)."""
        import copy as _copy
        return _copy.deepcopy(self)

    @property
    def is_sorted(self) -> bool:
        return getattr(self, "_sortkey", None) is not None

    def sort(self, by: str = "key") -> None:
        """Sort hits in place by ``"key"`` (sort key = score) or
        ``"seqidx"`` (reference ``TopHits.sort``)."""
        if by == "key":
            self.sort_by_key()
        elif by == "seqidx":
            self.sort_by_seqidx()
        else:
            raise ValueError(f"invalid sort key: {by!r}")

    def sort_by_key(self) -> None:
        """Sort by bit score descending, ties by name (``p7_tophits_SortBySortkey``)."""
        self.hits.sort(key=lambda h: (-h.score, h.name))
        self._sortkey = "key"

    def sort_by_seqidx(self) -> None:
        self.hits.sort(key=lambda h: (h.name, -h.score))
        self._sortkey = "seqidx"

    def _hit_is_reportable(self, h: Hit) -> bool:
        if self.bit_cutoffs is not None:
            t = self._model_cutoff(0)
            return t is not None and h.score >= t
        if self.T is not None:
            return h.score >= self.T
        return h.evalue <= self.E

    def _hit_is_includable(self, h: Hit) -> bool:
        if self.bit_cutoffs is not None:
            t = self._model_cutoff(0)
            return t is not None and h.score >= t
        if self.incT is not None:
            return h.score >= self.incT
        return h.evalue <= self.incE

    def _dom_is_reportable(self, d: Domain) -> bool:
        if self.bit_cutoffs is not None:
            t = self._model_cutoff(1)
            return t is not None and d.score >= t
        if self.domT is not None:
            return d.score >= self.domT
        return d.c_evalue <= self.domE

    def _dom_is_includable(self, d: Domain) -> bool:
        if self.bit_cutoffs is not None:
            t = self._model_cutoff(1)
            return t is not None and d.score >= t
        if self.incdomT is not None:
            return d.score >= self.incdomT
        return d.c_evalue <= self.incdomE

    def _model_cutoff(self, which: int):
        # bit_cutoffs mode: (seq_cutoff, dom_cutoff) recorded at query time
        if isinstance(self.bit_cutoffs, tuple):
            return self.bit_cutoffs[which]
        return None

    def threshold(self, pipeline=None) -> None:
        """Apply reporting/inclusion thresholds (``p7_tophits_Threshold``)."""
        if self.Z_setby == "ntargets":
            self.Z = float(self.nseqs if not self._z_by_models() else self.nmodels)
        for h in self.hits:
            h.reported = self._hit_is_reportable(h)
            h.included = self._hit_is_includable(h)
        if self.domZ_setby == "ntargets":
            self.domZ = float(sum(1 for h in self.hits if h.reported))
        for h in self.hits:
            if h.reported:
                for d in h.domains:
                    d.flags = 0
                    if self._dom_is_reportable(d):
                        d.flags |= F_REPORTED
                    if h.included and self._dom_is_includable(d):
                        d.flags |= F_INCLUDED
            else:
                for d in h.domains:
                    d.flags = 0

    _mode = "search"

    def _z_by_models(self) -> bool:
        return self._mode == "scan"

    # --- merging (distributed contract; plan7.pyx:8860-8964) -------------------

    def merge(self, *others: "TopHits") -> "TopHits":
        """Merge several runs over target chunks: concatenate hits, sum
        automatically-set Z/domZ, clear flags, re-threshold."""
        out = TopHits()
        out._take_accounting(self)
        out._mode = self._mode
        out.query_name = self.query_name
        out.query_accession = self.query_accession
        out.query_length = self.query_length
        out.hits = list(self.hits)
        for o in others:
            if (o.query_name != self.query_name or
                    o.query_length != self.query_length):
                raise ValueError("cannot merge hits from different queries")
            out.hits.extend(o.hits)
            out.nmodels = max(out.nmodels, o.nmodels)
            out.nseqs += o.nseqs
            out.nres += o.nres
            out.n_past_msv += o.n_past_msv
            out.n_past_bias += o.n_past_bias
            out.n_past_vit += o.n_past_vit
            out.n_past_fwd += o.n_past_fwd
            if out.Z_setby == "ntargets":
                # auto-Z: partial searches each counted their own
                # targets; the merged search's Z is the sum
                # (p7_pipeline_Merge, plan7.pyx:8860-8964)
                out.Z += o.Z
            elif o.Z != out.Z:
                raise ValueError("cannot merge hits with different Z")
        for h in out.hits:
            h.hits = out
            h.flags &= ~(F_REPORTED | F_INCLUDED)
        out.sort_by_key()
        out.threshold()
        return out

    def compare_ranking(self, ranking: dict) -> int:
        """Update a name->included map, return # of newly included hits
        (``p7_tophits_CompareRanking`` semantics for jackhmmer)."""
        new = 0
        for h in self.hits:
            if h.included:
                if h.name not in ranking:
                    h.flags |= F_NEW
                    new += 1
                else:
                    h.flags &= ~F_NEW
        for h in self.hits:
            if h.included:
                ranking[h.name] = True
        return new

    # --- output -----------------------------------------------------------------

    def write(self, fh, format: str = "targets", header: bool = True) -> None:
        from .output import write_targets, write_domains, write_pfam
        if format == "targets":
            write_targets(self, fh, header)
        elif format == "domains":
            write_domains(self, fh, header)
        elif format == "pfam":
            write_pfam(self, fh, header)
        else:
            raise ValueError(f"invalid format: {format!r}")

    def to_msa(self, alphabet, sequences=None, traces=None, trim=False,
               digitize=False, all_consensus_cols=False):
        from .tracealign import tophits_to_msa
        return tophits_to_msa(self, alphabet, sequences, traces, trim,
                              digitize, all_consensus_cols)
