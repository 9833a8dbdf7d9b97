"""Sequence file parsing (FASTA + EMBL/GenBank subset).

Mirrors ``pyhmmer.easel.SequenceFile`` (reference ``src/pyhmmer/easel.pyx:
8850-9672``): format guessing, text/digital mode, ``read``/``read_block``
with ``sequences``/``residues`` caps, ``rewind``, and a static ``parse``
for in-memory buffers.  Pure Python -- file I/O is never the bottleneck for
the batched pipeline, which consumes packed blocks.
"""

from __future__ import annotations

import io
import os
import gzip
import numpy as np
from typing import Iterator, List, Optional, Union

from .alphabet import Alphabet, AMINO, DNA, RNA  # noqa: F401  (DNA/RNA are singleton classes)
from .sequence import (
    DigitalSequence,
    DigitalSequenceBlock,
    TextSequence,
    TextSequenceBlock,
)

__all__ = ["SequenceFile", "guess_alphabet_text"]


def guess_alphabet_text(seq: str) -> Optional[Alphabet]:
    """Guess the alphabet of a text sequence, Easel-style.

    Based on residue composition (``esl_abc_GuessAlphabet`` semantics): if
    it only contains ACGTUN-ish symbols it is nucleic, otherwise amino.
    """
    counts = {}
    for c in seq[:4000].upper():
        if c.isalpha() or c == "*":
            counts[c] = counts.get(c, 0) + 1
    total = sum(counts.values())
    if total == 0:
        return None
    dna_chars = sum(counts.get(c, 0) for c in "ACGTN")
    rna_chars = sum(counts.get(c, 0) for c in "ACGUN")
    if dna_chars >= 0.98 * total or rna_chars >= 0.98 * total:
        if counts.get("U", 0) > counts.get("T", 0):
            return RNA()
        return DNA()
    return AMINO


def _parse_fasta(text: str) -> Iterator[TextSequence]:
    """Parse FASTA records from a string."""
    return _parse_fasta_lines(text.splitlines())


def _parse_fasta_lines(lines) -> Iterator[TextSequence]:
    """Parse FASTA records from an iterable of lines (streamed: only one
    record is materialized at a time)."""
    name = None
    desc = ""
    chunks: List[str] = []
    for line in lines:
        line = line.rstrip("\n")
        if line.startswith(">"):
            if name is not None:
                yield TextSequence(
                    name=name.encode(), description=desc.encode(),
                    sequence="".join(chunks),
                )
            header = line[1:].strip()
            if " " in header:
                name, desc = header.split(" ", 1)
                desc = desc.strip()
            else:
                name, desc = header, ""
            chunks = []
        elif line and name is not None:
            chunks.append("".join(line.split()))
    if name is not None:
        yield TextSequence(
            name=name.encode(), description=desc.encode(),
            sequence="".join(chunks),
        )


def _parse_embl_like(lines, fmt: str) -> Iterator[TextSequence]:
    """Minimal EMBL / GenBank / UniProt flat-file sequence extraction
    from an iterable of lines (streamed)."""
    if isinstance(lines, str):
        lines = lines.splitlines()
    name = b""
    desc = b""
    acc = b""
    in_seq = False
    chunks: List[str] = []

    def flush():
        nonlocal name, desc, acc, chunks, in_seq
        if chunks or name:
            yield TextSequence(name=name, description=desc, accession=acc,
                               sequence="".join(chunks))
        name, desc, acc, chunks, in_seq = b"", b"", b"", [], False

    for line in lines:
        line = line.rstrip("\n")
        if fmt in ("embl", "uniprot"):
            if line.startswith("ID"):
                parts = line[2:].strip().split(";")[0].split()
                name = parts[0].encode() if parts else b""
            elif line.startswith("AC") and not acc:
                acc = line[2:].strip().rstrip(";").split(";")[0].strip().encode()
            elif line.startswith("DE") and not desc:
                desc = line[2:].strip().encode()
            elif line.startswith("SQ"):
                in_seq = True
            elif line.startswith("//"):
                yield from flush()
            elif in_seq:
                chunks.append("".join(c for c in line if c.isalpha()))
        else:  # genbank / ddbj
            if line.startswith("LOCUS"):
                parts = line.split()
                name = parts[1].encode() if len(parts) > 1 else b""
            elif line.startswith("ACCESSION") and not acc:
                parts = line.split()
                acc = parts[1].encode() if len(parts) > 1 else b""
            elif line.startswith("DEFINITION") and not desc:
                desc = line[len("DEFINITION"):].strip().encode()
            elif line.startswith("ORIGIN"):
                in_seq = True
            elif line.startswith("//"):
                yield from flush()
            elif in_seq:
                chunks.append("".join(c for c in line if c.isalpha()))
    if name or chunks:
        yield from flush()


_MSA_FORMATS = {"stockholm", "pfam", "afa", "a2m", "clustal", "clustallike",
                "selex", "psiblast", "phylip", "phylips"}


class SequenceFile:
    """Iterative reader over a sequence file.

    Supports ``format`` in {fasta, embl, genbank, ddbj, uniprot,
    daemon, ncbi} plus every MSA format (delegated to
    :class:`~pyhmmer_tpu.easel.msafile.MSAFile`, matching reference
    behavior ``easel.pyx:158-169``).  ``daemon`` is the hmmpgmd
    cached-database layout (header line + FASTA records); ``ncbi``
    reads BLAST v4 protein volumes (pass the basename or the ``.pin``
    path; see :mod:`pyhmmer_tpu.easel.ncbi` for the supported subset).
    The reference's ``fmindex`` format is not implemented (explicitly
    out of scope, SURVEY.md FM-index row).  ``digital=True`` yields
    :class:`DigitalSequence`.
    """

    def __init__(
        self,
        file: Union[str, os.PathLike, io.IOBase],
        format: Optional[str] = None,
        *,
        digital: bool = False,
        alphabet: Optional[Alphabet] = None,
    ):
        self._close = False
        # streamed by design: a path input is NEVER slurped -- records
        # (and genome windows) are parsed from a line iterator, so peak
        # RSS is bounded by the largest single record read (or the
        # window size for read_window), not the database size
        # (reference workers likewise re-open/stream target files,
        # hmmer/_hmmsearch.py:81-90)
        self._path: Optional[str] = None
        if isinstance(file, (str, os.PathLike)):
            path = os.fspath(file)
            if format and format.lower() == "ncbi":
                # binary BLAST volume: the basename itself need not
                # exist, its .pin member must
                from . import ncbi as _ncbi
                base = _ncbi._basename(path)
                if not os.path.exists(base + ".pin"):
                    raise FileNotFoundError(base + ".pin")
                self._path = base
                self.name = base
            elif not os.path.exists(path):
                raise FileNotFoundError(path)
            else:
                self._path = path
                self.name: Optional[str] = path
        else:
            data = file.read()
            if isinstance(data, bytes):
                data = data.decode("ascii", errors="replace")
            self._textbuf = data
            self.name = getattr(file, "name", None)

        self.format = format.lower() if format else self._guess_format()
        self.digital = digital
        self.alphabet = alphabet
        self._iter: Optional[Iterator] = None
        self._closed = False
        if digital and alphabet is None:
            self.alphabet = self.guess_alphabet()
            if self.alphabet is None:
                raise ValueError("could not guess alphabet for digital mode")

    # --- streamed line access -----------------------------------------------

    def _open_lines(self):
        """A fresh line iterator over the underlying data (never slurps
        path inputs)."""
        if self._path is not None:
            if self._path.endswith(".gz"):
                return gzip.open(self._path, "rt")
            return open(self._path, "r")
        return io.StringIO(self._textbuf)

    def _full_text(self) -> str:
        """Full contents -- only used for the MSA-format delegation,
        whose parsers are whole-document by nature."""
        if self._path is not None:
            with self._open_lines() as fh:
                return fh.read()
        return self._textbuf

    # --- format/alphabet guessing -----------------------------------------

    def _guess_format(self) -> str:
        with self._open_lines() as fh:
            for line in fh:
                s = line.strip()
                if not s:
                    continue
                if s.startswith(">"):
                    return "fasta"
                if s.startswith("# STOCKHOLM"):
                    return "stockholm"
                if s.startswith("CLUSTAL"):
                    return "clustal"
                if s.startswith("ID "):
                    return "embl"
                if s.startswith("LOCUS"):
                    return "genbank"
                break
        raise ValueError("could not determine sequence file format")

    def guess_alphabet(self) -> Optional[Alphabet]:
        for seq in self._records():
            return guess_alphabet_text(seq.sequence)
        return None

    # --- iteration ---------------------------------------------------------

    def _records(self) -> Iterator[TextSequence]:
        if self.format == "fasta":
            fh = self._open_lines()
            try:
                yield from _parse_fasta_lines(fh)
            finally:
                fh.close()
        elif self.format in ("daemon", "hmmpgmd"):
            # hmmpgmd cached-database format (cachedb.c; reference
            # format list easel.pyx:158-169): one '#'-prefixed header
            # line with residue/sequence counts, then FASTA records
            fh = self._open_lines()
            try:
                first = fh.readline()
                if not first.startswith("#"):
                    raise ValueError(
                        "daemon format requires a '#' header line")
                yield from _parse_fasta_lines(fh)
            finally:
                fh.close()
        elif self.format in ("embl", "genbank", "ddbj", "uniprot"):
            fh = self._open_lines()
            try:
                yield from _parse_embl_like(fh, self.format)
            finally:
                fh.close()
        elif self.format == "ncbi":
            from .ncbi import iter_protein_db
            if self._path is None:
                raise ValueError("ncbi format requires a path input")
            for name, desc, seq in iter_protein_db(self._path):
                yield TextSequence(name=name, description=desc,
                                   sequence=seq)
        elif self.format in _MSA_FORMATS:
            from .msafile import MSAFile
            with MSAFile(io.StringIO(self._full_text()),
                         format=self.format) as mf:
                for msa in mf:
                    for seq in msa.sequences_as_unaligned():
                        yield seq
        else:
            raise ValueError(f"unsupported sequence format: {self.format}")

    def read(self) -> Optional[Union[TextSequence, DigitalSequence]]:
        if self._closed:
            raise ValueError("I/O operation on closed file")
        if self._iter is None:
            self._iter = self._records()
        try:
            seq = next(self._iter)
        except StopIteration:
            return None
        if self.digital:
            return seq.digitize(self.alphabet)
        return seq

    def readinto(self, seq) -> Optional[object]:
        """Read the next sequence into an existing ``Sequence`` object,
        returning it (or None at EOF) -- reference ``SequenceFile.readinto``
        (``easel.pyx:8850-9672``).  This package has no preallocated C
        buffers, so this copies the parsed record's fields into ``seq``."""
        nxt = self.read()
        if nxt is None:
            return None
        seq.name = nxt.name
        seq.accession = nxt.accession
        seq.description = nxt.description
        seq.sequence = nxt.sequence
        return seq

    def read_block(self, sequences: Optional[int] = None,
                   residues: Optional[int] = None):
        """Read up to ``sequences`` seqs / ``residues`` residues into a block."""
        if self.digital:
            block = DigitalSequenceBlock(self.alphabet)
        else:
            block = TextSequenceBlock()
        n_res = 0
        while True:
            if sequences is not None and len(block) >= sequences:
                break
            if residues is not None and n_res >= residues:
                break
            seq = self.read()
            if seq is None:
                break
            block.append(seq)
            n_res += len(seq)
        return block

    def rewind(self) -> None:
        self._iter = None

    # --- streamed / windowed access ------------------------------------------

    def records_chunked(self, chunk_residues: int = 1 << 20):
        """Yield ``(header, chunk_iter)`` per record, where ``header`` is a
        residue-less :class:`TextSequence` (name/description only) and
        ``chunk_iter`` yields successive residue strings of up to
        ``chunk_residues`` characters.  FASTA records stream straight off
        the file, so peak memory is one chunk -- the primitive behind
        genome-window reads (``esl_sqio_ReadWindow`` role).  Other formats
        fall back to one whole-record chunk.

        The chunk iterator of a record MUST be exhausted before advancing
        to the next record."""
        if self.format != "fasta":
            for seq in self._records():
                yield (TextSequence(name=seq.name,
                                    description=seq.description,
                                    accession=seq.accession, sequence=""),
                       iter([seq.sequence]))
            return
        fh = self._open_lines()
        try:
            # one-item lookahead: the residue chunker must SEE the next
            # record's ">" header to stop, without consuming it -- the
            # outer loop then reads the same line as the next header
            # (reference pattern: pyhmmer.utils.peekable in the app
            # layer's streamed readers)
            from ..utils import peekable
            lines = peekable(fh)

            def chunks():
                buf: List[str] = []
                n = 0
                while True:
                    try:
                        line = lines.peek()
                    except StopIteration:
                        break
                    if line.startswith(">"):
                        break
                    next(lines)
                    piece = "".join(line.split())
                    if piece:
                        buf.append(piece)
                        n += len(piece)
                    if n >= chunk_residues:
                        yield "".join(buf)
                        buf, n = [], 0
                if buf:
                    yield "".join(buf)

            while True:
                header_line = None
                for line in lines:
                    if line.startswith(">"):
                        header_line = line
                        break
                if header_line is None:
                    break
                header = header_line[1:].strip()
                if " " in header:
                    name, desc = header.split(" ", 1)
                    desc = desc.strip()
                else:
                    name, desc = header, ""
                it = chunks()
                yield (TextSequence(name=name.encode(),
                                    description=desc.encode(),
                                    sequence=""), it)
                # drain any unread residue chunks of this record
                for _ in it:
                    pass
        finally:
            fh.close()

    def __iter__(self):
        return self

    def __next__(self):
        seq = self.read()
        if seq is None:
            raise StopIteration
        return seq

    # --- context management -------------------------------------------------

    def close(self) -> None:
        self._closed = True

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self) -> "SequenceFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --- static helpers -----------------------------------------------------

    @staticmethod
    def parse(buffer: bytes, format: str = "fasta",
              *, digital: bool = False, alphabet: Optional[Alphabet] = None):
        """Parse sequences from an in-memory buffer (ref ``easel.pyx:9060``)."""
        return SequenceFile(io.BytesIO(buffer), format=format,
                            digital=digital, alphabet=alphabet)
