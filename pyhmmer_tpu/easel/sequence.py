"""Sequence objects and blocks.

Mirrors ``pyhmmer.easel.Sequence``/``TextSequence``/``DigitalSequence`` and the
``SequenceBlock`` containers (reference ``src/pyhmmer/easel.pyx:7119-8816``),
re-designed for the batched device layout: a ``DigitalSequenceBlock`` can emit a
packed ``[B, Lmax]`` uint8 code matrix plus a length vector, which is the
input format of every batched kernel.
"""

from __future__ import annotations

import numpy as np
from typing import Iterable, Iterator, List, Optional, Sequence as TySequence

from .alphabet import Alphabet

__all__ = [
    "Sequence",
    "TextSequence",
    "DigitalSequence",
    "SequenceBlock",
    "TextSequenceBlock",
    "DigitalSequenceBlock",
]


class Sequence:
    """Abstract base: named sequence with metadata."""

    __slots__ = ("name", "description", "accession", "source",
                 "taxonomy_id", "_residue_markups")

    def __init__(
        self,
        name: bytes = b"",
        description: bytes = b"",
        accession: bytes = b"",
        source: bytes = b"",
        taxonomy_id: Optional[int] = None,
    ):
        self.name = bytes(name)
        self.description = bytes(description)
        self.accession = bytes(accession)
        self.source = bytes(source)
        self.taxonomy_id = taxonomy_id
        self._residue_markups: dict = {}

    def __len__(self) -> int:
        raise NotImplementedError

    @property
    def residue_markups(self) -> dict:
        """`dict`: extra per-residue markup lines (reference
        ``Sequence.residue_markups``, ``easel.pyx:7276``)."""
        return self._residue_markups

    @residue_markups.setter
    def residue_markups(self, xr: dict) -> None:
        n = len(self)
        for tag, val in xr.items():
            if len(val) != n:
                raise ValueError(
                    f"residue markup {tag!r} has length {len(val)}, "
                    f"expected {n}")
        self._residue_markups = dict(xr)

    def checksum(self) -> int:
        """A 32-bit checksum of the residues (CRC-based; stable across
        text/digital forms of the same sequence)."""
        import zlib
        if isinstance(getattr(self, "sequence", None), str):
            data = self.sequence.upper().encode("ascii")
        else:
            data = np.ascontiguousarray(self.sequence).tobytes()
        return zlib.crc32(data) & 0xFFFFFFFF

    def clear(self) -> None:
        """Reinitialize the sequence (``esl_sq_Reuse`` semantics)."""
        self.name = b""
        self.description = b""
        self.accession = b""
        self.source = b""
        self.taxonomy_id = None
        self._residue_markups = {}
        if isinstance(getattr(self, "sequence", None), str):
            self.sequence = ""
        elif getattr(self, "sequence", None) is not None:
            self.sequence = np.zeros(0, dtype=np.uint8)

    def write(self, fh) -> None:
        """Write the sequence to a binary file handle in FASTA format
        (reference ``Sequence.write``, ``easel.pyx:8016-8056``)."""
        text = self.sequence if isinstance(getattr(self, "sequence", None), str) \
            else self.textize().sequence
        header = b">" + (self.name or b"")
        if self.description:
            header += b" " + self.description
        fh.write(header + b"\n")
        data = text.encode("ascii")
        for i in range(0, len(data), 60):
            fh.write(data[i : i + 60] + b"\n")

    def _meta(self) -> dict:
        return dict(
            name=self.name,
            description=self.description,
            accession=self.accession,
            source=self.source,
            taxonomy_id=self.taxonomy_id,
        )


class TextSequence(Sequence):
    """A sequence stored as text characters."""

    __slots__ = ("sequence",)

    def __init__(self, name: bytes = b"", description: bytes = b"",
                 accession: bytes = b"", sequence: str = "",
                 source: bytes = b"", taxonomy_id: Optional[int] = None):
        super().__init__(name, description, accession, source, taxonomy_id)
        self.sequence = sequence

    def __len__(self) -> int:
        return len(self.sequence)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, TextSequence)
            and other.name == self.name
            and other.sequence == self.sequence
        )

    def copy(self) -> "TextSequence":
        return TextSequence(sequence=self.sequence, **self._meta())

    def digitize(self, alphabet: Alphabet) -> "DigitalSequence":
        """Encode into a :class:`DigitalSequence`.

        Example:
            >>> from pyhmmer_tpu.easel.alphabet import Alphabet
            >>> s = TextSequence(name=b"seq1", sequence="ACGT")
            >>> d = s.digitize(Alphabet.dna())
            >>> [int(c) for c in d.sequence], d.name
            ([0, 1, 2, 3], b'seq1')
            >>> d.textize().sequence
            'ACGT'
        """
        return DigitalSequence(
            alphabet, sequence=alphabet.encode(self.sequence), **self._meta()
        )

    def reverse_complement(self, inplace: bool = False) -> "TextSequence":
        # text-level revcomp via DNA mapping (keeps case)
        table = str.maketrans(
            "ACGTUacgtuRYMKSWHBVDNrymkswhbvdn",
            "TGCAAtgcaaYRKMSWDVBHNyrkmswdvbhn",
        )
        rc = self.sequence.translate(table)[::-1]
        if inplace:
            self.sequence = rc
            return self
        return TextSequence(sequence=rc, **self._meta())

    @classmethod
    def sample(cls, alphabet: Alphabet, max_length: int,
               randomness=None) -> "TextSequence":
        """Sample a random sequence of length at most ``max_length``
        (reference ``TextSequence.sample``, ``easel.pyx:7438``)."""
        return DigitalSequence.sample(
            alphabet, max_length, randomness).textize()


class DigitalSequence(Sequence):
    """A digitally-encoded sequence: uint8 codes, *no* sentinels.

    The reference stores Easel digital sequences with sentinel bytes at
    ``[0]`` and ``[n+1]`` (see window copy ``plan7.pyx:7396-7397``); this
    layout instead keeps raw codes and tracks lengths explicitly.
    """

    __slots__ = ("alphabet", "sequence")

    def __init__(self, alphabet: Alphabet, name: bytes = b"",
                 description: bytes = b"", accession: bytes = b"",
                 sequence: Optional[np.ndarray] = None,
                 source: bytes = b"", taxonomy_id: Optional[int] = None):
        super().__init__(name, description, accession, source, taxonomy_id)
        self.alphabet = alphabet
        if sequence is None:
            sequence = np.zeros(0, dtype=np.uint8)
        self.sequence = np.asarray(sequence, dtype=np.uint8)

    def __len__(self) -> int:
        return len(self.sequence)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, DigitalSequence)
            and other.name == self.name
            and other.alphabet == self.alphabet
            and np.array_equal(other.sequence, self.sequence)
        )

    def copy(self) -> "DigitalSequence":
        return DigitalSequence(self.alphabet, sequence=self.sequence.copy(),
                               **self._meta())

    def textize(self) -> TextSequence:
        return TextSequence(sequence=self.alphabet.decode(self.sequence),
                            **self._meta())

    def reverse_complement(self, inplace: bool = False) -> "DigitalSequence":
        cm = self.alphabet.complement_map
        if cm is None:
            raise ValueError(f"cannot reverse-complement {self.alphabet.name}")
        rc = cm[self.sequence][::-1].copy()
        if inplace:
            self.sequence = rc
            return self
        return DigitalSequence(self.alphabet, sequence=rc, **self._meta())

    def translate(self, genetic_code=None) -> "DigitalSequence":
        """Translate a coding nucleotide sequence to protein
        (``DigitalSequence.translate``)."""
        from .gencode import GeneticCode
        gc = genetic_code or GeneticCode(nucleotide_alphabet=self.alphabet)
        return gc.translate_sequence(self)

    @classmethod
    def sample(cls, alphabet: Alphabet, max_length: int,
               randomness=None) -> "DigitalSequence":
        """Sample a random digital sequence of length at most
        ``max_length`` (reference ``DigitalSequence.sample``)."""
        from .random import Randomness
        if randomness is None or isinstance(randomness, int):
            randomness = Randomness(randomness or 0)
        n = 1 + randomness._rng.randint(0, max(1, max_length))
        codes = randomness._rng.randint(0, alphabet.K, n).astype(np.uint8)
        return cls(alphabet, name=b"random", sequence=codes)


class SequenceBlock:
    """List-like container of sequences (reference ``easel.pyx:8110-8816``)."""

    _item_type = Sequence

    def __init__(self, iterable: Iterable[Sequence] = ()):
        self._seqs: List[Sequence] = []
        for s in iterable:
            self.append(s)

    def append(self, seq: Sequence) -> None:
        if not isinstance(seq, self._item_type):
            raise TypeError(
                f"expected {self._item_type.__name__}, got {type(seq).__name__}"
            )
        self._seqs.append(seq)

    def extend(self, seqs: Iterable[Sequence]) -> None:
        for s in seqs:
            self.append(s)

    def clear(self) -> None:
        self._seqs.clear()

    def pop(self, index: int = -1) -> Sequence:
        return self._seqs.pop(index)

    def remove(self, seq: Sequence) -> None:
        self._seqs.remove(seq)

    def index(self, seq: Sequence) -> int:
        return self._seqs.index(seq)

    def insert(self, index: int, seq: Sequence) -> None:
        if not isinstance(seq, self._item_type):
            raise TypeError(type(seq).__name__)
        self._seqs.insert(index, seq)

    def __len__(self) -> int:
        return len(self._seqs)

    def __iter__(self) -> Iterator[Sequence]:
        return iter(self._seqs)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return type(self)._from_list(self._seqs[i], *self._slice_args())
        return self._seqs[i]

    def _slice_args(self):
        return ()

    @classmethod
    def _from_list(cls, seqs, *args):
        block = cls.__new__(cls)
        block._seqs = list(seqs)
        return block

    def largest(self) -> Sequence:
        """Return the largest sequence in the block."""
        if not self._seqs:
            raise ValueError("empty block")
        return max(self._seqs, key=len)

    def total_length(self) -> int:
        return sum(len(s) for s in self._seqs)

    def __repr__(self) -> str:
        return f"<{type(self).__name__} of {len(self)} sequences>"

    def copy(self) -> "SequenceBlock":
        """A shallow copy of the block (reference
        ``SequenceBlock.copy``, ``easel.pyx:8401``)."""
        return type(self)._from_list(list(self._seqs), *self._slice_args())

    def write(self, fh) -> None:
        """Write every sequence to a binary file handle in FASTA format."""
        for s in self._seqs:
            s.write(fh)

    @property
    def indexed(self) -> bool:
        """`bool`: whether a name index is currently built for the block
        (the reference keeps a lazy `KeyHash`; ours builds on demand)."""
        return getattr(self, "_indexed", None) is not None

    def _name_index(self):
        idx = getattr(self, "_indexed", None)
        if idx is None:
            idx = {s.name: i for i, s in enumerate(self._seqs)}
            self._indexed = idx
        return idx


class TextSequenceBlock(SequenceBlock):
    _item_type = TextSequence

    def digitize(self, alphabet: Alphabet) -> "DigitalSequenceBlock":
        return DigitalSequenceBlock(alphabet, (s.digitize(alphabet) for s in self))


class DigitalSequenceBlock(SequenceBlock):
    """Block of digital sequences sharing an alphabet.

    Provides :meth:`packed` which produces the ``[B, Lmax]`` padded code
    matrix + length vector layout the batched device kernels consume.
    """

    _item_type = DigitalSequence

    def __init__(self, alphabet: Alphabet, iterable: Iterable[DigitalSequence] = ()):
        self.alphabet = alphabet
        super().__init__(iterable)

    def append(self, seq: DigitalSequence) -> None:  # type: ignore[override]
        if not isinstance(seq, DigitalSequence):
            raise TypeError(type(seq).__name__)
        if seq.alphabet != self.alphabet:
            raise ValueError("alphabet mismatch")
        self._seqs.append(seq)

    def _slice_args(self):
        return (self.alphabet,)

    @classmethod
    def _from_list(cls, seqs, alphabet):
        block = cls.__new__(cls)
        block.alphabet = alphabet
        block._seqs = list(seqs)
        return block

    def textize(self) -> TextSequenceBlock:
        return TextSequenceBlock(s.textize() for s in self)

    def translate(self, genetic_code=None) -> "DigitalSequenceBlock":
        from .gencode import GeneticCode
        gc = genetic_code or GeneticCode()
        from .alphabet import AMINO
        return DigitalSequenceBlock(AMINO, (gc.translate_sequence(s) for s in self))

    # --- device batch layout ------------------------------------------------

    def packed(self, pad_to: int = 1, fill: Optional[int] = None):
        """Pack into ``(codes[B, Lmax], lengths[B])``.

        ``Lmax`` is rounded up to a multiple of ``pad_to``; padding positions
        are filled with the alphabet's nonresidue code (score ``-inf`` in any
        match state), so padded tails can never contribute to alignments.
        """
        B = len(self._seqs)
        fill_code = self.alphabet.nonresidue_code if fill is None else fill
        lengths = np.array([len(s) for s in self._seqs], dtype=np.int32)
        lmax = int(lengths.max()) if B else 0
        lmax = ((lmax + pad_to - 1) // pad_to) * pad_to if lmax else pad_to
        codes = np.full((B, lmax), fill_code, dtype=np.uint8)
        for i, s in enumerate(self._seqs):
            codes[i, : len(s)] = s.sequence
        return codes, lengths
