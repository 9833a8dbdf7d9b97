"""HMMER model file I/O: HMMER3 ASCII (3/a..3/f), binary ``.h3m``, HMMER2.

Mirrors ``pyhmmer.plan7.HMMFile`` (reference ``src/pyhmmer/plan7.pyx:
3447-3841``); format detection by leading magic (``plan7.pyx:201-218``).
Values in ASCII files are negative natural logs of probabilities with ``*``
denoting probability zero.
"""

from __future__ import annotations

import io
import os
import struct
import numpy as np
from typing import BinaryIO, Iterator, List, Optional, Union

from ..easel.alphabet import Alphabet
from .hmm import HMM, HMMFlags, EV_UNSET

__all__ = ["HMMFile", "write_hmm_ascii", "write_hmm_binary"]

# binary magics, little-endian uint32 (p7_hmmfile.c conventions)
V3A_MAGIC = 0xE8EDEDB5
V3B_MAGIC = 0xE8EDEDB6
V3C_MAGIC = 0xE8EDEDB7
V3D_MAGIC = 0xE8EDEDB8
V3E_MAGIC = 0xE8EDEDB9
V3F_MAGIC = 0xE8EDEDBA
MAGIC_TO_FORMAT = {
    V3A_MAGIC: "3/a", V3B_MAGIC: "3/b", V3C_MAGIC: "3/c",
    V3D_MAGIC: "3/d", V3E_MAGIC: "3/e", V3F_MAGIC: "3/f",
}
FORMAT_TO_MAGIC = {v: k for k, v in MAGIC_TO_FORMAT.items()}

_ALPH_NAMES = {"amino": "amino", "dna": "dna", "rna": "rna",
               "nucleic": "dna", "custom": None}


def _logprob(tok: str) -> float:
    """Parse a -ln(p) token; '*' means p = 0."""
    if tok == "*":
        return np.inf
    return float(tok)


def _prob(tok: str) -> float:
    return 0.0 if tok == "*" else float(np.exp(-float(tok)))


class HMMFile:
    """Iterator over the HMMs in a file (path or binary file object).

    Reads HMMER3 ASCII (``HMMER3/a``..``f``), HMMER2 ASCII, and binary
    ``.h3m``; see :meth:`optimized_profiles` for pressed databases.

    Example:
        >>> import os, tempfile
        >>> from pyhmmer_tpu import hmmer, synthetic
        >>> hmms, _ = synthetic.doctest_workload()
        >>> path = os.path.join(tempfile.mkdtemp(), "synthetic.hmm")
        >>> with open(path, "wb") as fh:
        ...     for h in hmms:
        ...         h.write(fh)
        >>> with HMMFile(path) as f:
        ...     hmm = f.read()
        >>> hmm.name, hmm.M
        (b'synfam0000', 60)
        >>> hmmer.hmmpress(hmms, path)
        2
        >>> with HMMFile(path) as f:
        ...     f.is_pressed()
        True
    """

    def __init__(self, file: Union[str, os.PathLike, BinaryIO],
                 db: bool = True):
        if isinstance(file, (str, os.PathLike)):
            self._path: Optional[str] = os.fspath(file)
            self._fh: BinaryIO = open(self._path, "rb")
            self._close = True
        else:
            self._path = getattr(file, "name", None)
            self._fh = file
            self._close = False
        self._closed = False

        magic = self._fh.read(16)
        self._fh.seek(-len(magic), io.SEEK_CUR) if magic else None
        if len(magic) < 4:
            raise EOFError("premature end of file")
        (magic_u32,) = struct.unpack("<I", magic[:4])
        if magic_u32 in MAGIC_TO_FORMAT:
            self._binary = True
            self.format = MAGIC_TO_FORMAT[magic_u32]
            self._iter = self._iter_binary()
        elif magic[:4] in (b"HMME", b"# ST"):
            self._binary = False
            self._iter = self._iter_ascii()
            if magic.startswith(b"HMMER2.0"):
                self.format = "2.0"
            elif magic.startswith(b"HMMER3/") and len(magic) > 7:
                self.format = "3/" + chr(magic[7])
            else:
                self.format = None  # set on first record
        else:
            raise ValueError(f"unrecognized HMM file magic: {magic!r}")

    # --- public API ---------------------------------------------------------

    def read(self) -> Optional[HMM]:
        try:
            return next(self._iter)
        except StopIteration:
            return None

    def __iter__(self) -> Iterator[HMM]:
        return self._iter

    def __next__(self) -> HMM:
        return next(self._iter)

    def rewind(self) -> None:
        self._fh.seek(0)
        self._iter = self._iter_binary() if self._binary else self._iter_ascii()

    def close(self) -> None:
        if not self._closed:
            if self._close:
                self._fh.close()
            self._closed = True

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def name(self) -> Optional[str]:
        return self._path

    def __enter__(self) -> "HMMFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def is_pressed(self) -> bool:
        """Whether an ``.h3p``-pressed database accompanies this file."""
        if self._path is None:
            return False
        return all(os.path.exists(self._path + ext)
                   for ext in (".h3m", ".h3f", ".h3i", ".h3p"))

    def optimized_profiles(self):
        from .optimized import HMMPressedFile
        if not self.is_pressed():
            raise ValueError("HMM file does not have associated pressed files")
        return HMMPressedFile(self._path)

    # --- ASCII parsing ------------------------------------------------------

    def _iter_ascii(self) -> Iterator[HMM]:
        text = self._fh.read().decode("ascii", errors="replace")
        lines = text.splitlines()
        i = 0
        n = len(lines)
        while i < n:
            while i < n and not lines[i].strip():
                i += 1
            if i >= n:
                return
            header = lines[i]
            if header.startswith("HMMER3/"):
                fmt = "3/" + header[7]
                if self.format is None:
                    self.format = fmt
                hmm, i = _parse_ascii_record(lines, i, fmt)
                yield hmm
            elif header.startswith("HMMER2.0"):
                if self.format is None:
                    self.format = "2.0"
                hmm, i = _parse_hmmer2_record(lines, i)
                yield hmm
            else:
                raise ValueError(f"bad HMM header line: {header!r}")

    # --- binary parsing -----------------------------------------------------

    def _iter_binary(self) -> Iterator[HMM]:
        while True:
            magic_bytes = self._fh.read(4)
            if len(magic_bytes) < 4:
                return
            (magic,) = struct.unpack("<I", magic_bytes)
            if magic not in MAGIC_TO_FORMAT:
                raise ValueError(f"bad binary HMM magic: {magic:#x}")
            yield read_hmm_binary_body(self._fh, MAGIC_TO_FORMAT[magic])


# ---------------------------------------------------------------------------
# HMMER3 ASCII record
# ---------------------------------------------------------------------------

def _parse_ascii_record(lines: List[str], i: int, fmt: str):
    hdr: dict = {}
    fields_f = fmt >= "3/f"
    fields_e = fmt >= "3/e"
    i += 1
    stats = {}
    cutoffs = {}
    while i < len(lines):
        line = lines[i]
        tag = line[:5].strip()
        val = line[5:].strip() if len(line) > 5 else ""
        i += 1
        if tag == "HMM":
            break
        hdr[tag] = val
        if tag == "STATS":
            parts = val.split()
            stats[parts[1]] = (float(parts[2]), float(parts[3]))
        elif tag in ("GA", "TC", "NC"):
            parts = val.rstrip(";").split()
            cutoffs[tag] = (float(parts[0]), float(parts[1]))

    M = int(hdr["LENG"])
    alphabet = Alphabet.from_name(hdr["ALPH"])
    K = alphabet.K
    hmm = HMM(alphabet, M, name=hdr.get("NAME", "").encode())
    if "ACC" in hdr:
        hmm.accession = hdr["ACC"].encode()
        hmm.flags |= HMMFlags.ACC
    if "DESC" in hdr:
        hmm.description = hdr["DESC"].encode()
        hmm.flags |= HMMFlags.DESC
    if "NSEQ" in hdr:
        hmm.nseq = int(hdr["NSEQ"])
    if "EFFN" in hdr:
        hmm.eff_nseq = float(hdr["EFFN"])
    if "CKSUM" in hdr:
        hmm.checksum = int(hdr["CKSUM"])
        hmm.flags |= HMMFlags.CHKSUM
    if "DATE" in hdr:
        hmm.creation_time = hdr["DATE"]
    if "MAXL" in hdr:
        hmm.max_length = int(hdr["MAXL"])
    com = [v for k, v in hdr.items() if k == "COM"]
    if com:
        hmm.command_line = "\n".join(c.split("] ", 1)[-1] for c in com)
    if "MSV" in stats:
        hmm.evparam[0:2] = stats["MSV"]
        hmm.evparam[2:4] = stats["VITERBI"]
        hmm.evparam[4:6] = stats["FORWARD"]
        hmm.flags |= HMMFlags.STATS
    if "GA" in cutoffs:
        hmm.gathering = cutoffs["GA"]
    if "TC" in cutoffs:
        hmm.trusted = cutoffs["TC"]
    if "NC" in cutoffs:
        hmm.noise = cutoffs["NC"]

    has_rf = hdr.get("RF", "no") == "yes"
    has_mm = hdr.get("MM", "no") == "yes"
    has_cons = hdr.get("CONS", "no") == "yes"
    has_cs = hdr.get("CS", "no") == "yes"
    has_map = hdr.get("MAP", "no") == "yes"
    if has_rf:
        hmm.flags |= HMMFlags.RF
    if has_mm:
        hmm.flags |= HMMFlags.MMASK
    if has_cons:
        hmm.flags |= HMMFlags.CONS
    if has_cs:
        hmm.flags |= HMMFlags.CS
    if has_map:
        hmm.flags |= HMMFlags.MAP

    # skip the transition header line ("m->m m->i ...")
    i += 1

    # optional COMPO line
    toks = lines[i].split()
    if toks and toks[0] == "COMPO":
        hmm.composition = np.array(
            [_prob(t) for t in toks[1:K + 1]], dtype=np.float32)
        hmm.flags |= HMMFlags.COMPO
        i += 1
        toks = lines[i].split()

    # node 0: insert emissions then transitions
    hmm.ins[0] = [_prob(t) for t in toks[:K]]
    i += 1
    hmm.t[0] = [_prob(t) for t in lines[i].split()[:7]]
    i += 1

    rf = [" "]
    mm = [" "]
    cons = [" "]
    cs = [" "]
    ca = [" "]
    mapv = [0]
    for k in range(1, M + 1):
        toks = lines[i].split()
        if int(toks[0]) != k:
            raise ValueError(f"expected node {k}, got {toks[0]!r}")
        hmm.mat[k] = [_prob(t) for t in toks[1:K + 1]]
        ann = toks[K + 1:]
        j = 0
        if has_map:
            mapv.append(0 if ann[j] == "-" else int(ann[j])); j += 1
        else:
            j += 1  # column present as '-' even when MAP off
        if fields_e:
            cons.append(ann[j] if has_cons else " "); j += 1
        rf.append(ann[j] if has_rf else " "); j += 1
        if fields_f:
            mm.append(ann[j] if has_mm else " "); j += 1
        cs.append(ann[j] if has_cs and j < len(ann) else " ")
        i += 1
        hmm.ins[k] = [_prob(t) for t in lines[i].split()[:K]]
        i += 1
        hmm.t[k] = [_prob(t) for t in lines[i].split()[:7]]
        i += 1

    if has_map:
        hmm.map = np.array(mapv, dtype=np.int32)
    if has_rf:
        hmm.reference = "".join(rf).encode()
    if has_mm:
        hmm.model_mask = "".join(mm).encode()
    if has_cons:
        hmm.consensus = "".join(cons).encode()
    if has_cs:
        hmm.consensus_structure = "".join(cs).encode()

    # trailing '//'
    while i < len(lines) and lines[i].strip() != "//":
        i += 1
    return hmm, i + 1


# ---------------------------------------------------------------------------
# HMMER2 ASCII
# ---------------------------------------------------------------------------

def _h2_prob(tok: str, null: float = 1.0) -> float:
    """HMMER2 integer score -> probability: sc = 1000*log2(p/null),
    '*' = probability zero (HMMER2's Prob2Score/Score2Prob contract)."""
    if tok == "*":
        return 0.0
    return null * 2.0 ** (float(tok) / 1000.0)


def _parse_hmmer2_record(lines: List[str], i: int):
    """Parse one ``HMMER2.0`` ASCII record into a core :class:`HMM`.

    Reference behavior: ``p7_hmmfile.c:read_asc20hmm`` (HMMER 3.4) via
    ``plan7.pyx:3498-3591``; fixtures in ``tests/data/hmms/txt2``.  HMMER2
    scores are ``round(1000 * log2(p / null))`` with ``*`` meaning zero;
    emissions are relative to the NULE null model, transitions to 1.
    The HMMER2 model has no I0/IM/DM-row-0 states and no tM->{M,I,D} at
    node M, so those take the HMMER3 conventions (lossy roundtrip, as in
    the reference)."""
    hdr_tags = {}
    coms: List[str] = []
    nule: Optional[List[str]] = None
    cutoffs = {}
    i += 1
    while i < len(lines):
        line = lines[i]
        tag = line[:5].strip()
        val = line[5:].strip() if len(line) > 5 else ""
        i += 1
        if tag == "HMM":
            break
        if tag == "COM":
            coms.append(val)
        elif tag == "NULE":
            nule = val.split()
        elif tag in ("GA", "TC", "NC"):
            parts = val.rstrip(";").split()
            cutoffs[tag] = (float(parts[0]), float(parts[1]))
        else:
            hdr_tags[tag] = val
    if "LENG" not in hdr_tags:
        raise ValueError("HMMER2 record missing LENG")
    M = int(hdr_tags["LENG"])
    alph = hdr_tags.get("ALPH", "Amino").lower()
    alphabet = Alphabet.from_name(
        "amino" if alph.startswith("a") else "dna")
    K = alphabet.K
    if nule is None or len(nule) < K:
        raise ValueError("HMMER2 record missing NULE line")
    null = np.array([2.0 ** (float(t) / 1000.0) / K for t in nule[:K]],
                    dtype=np.float64)

    hmm = HMM(alphabet, M, name=hdr_tags.get("NAME", "").encode())
    if "ACC" in hdr_tags:
        hmm.accession = hdr_tags["ACC"].encode()
        hmm.flags |= HMMFlags.ACC
    if "DESC" in hdr_tags:
        hmm.description = hdr_tags["DESC"].encode()
        hmm.flags |= HMMFlags.DESC
    if "NSEQ" in hdr_tags:
        hmm.nseq = int(hdr_tags["NSEQ"])
    if "DATE" in hdr_tags:
        hmm.creation_time = hdr_tags["DATE"]
    if coms:
        hmm.command_line = "\n".join(coms)
    if "GA" in cutoffs:
        hmm.gathering = cutoffs["GA"]
    if "TC" in cutoffs:
        hmm.trusted = cutoffs["TC"]
    if "NC" in cutoffs:
        hmm.noise = cutoffs["NC"]
    has_map = hdr_tags.get("MAP", "no") == "yes"
    has_rf = hdr_tags.get("RF", "no") == "yes"
    has_cs = hdr_tags.get("CS", "no") == "yes"

    # skip transition-name header line; then the B-state line
    # (t0: B->M1, B->I0, B->D1)
    i += 1
    toks = lines[i].split()
    hmm.t[0, 0:3] = [_h2_prob(t) for t in toks[:3]]
    hmm.t[0, 3] = 1.0   # I0 transitions: HMMER3 node-0 convention
    hmm.t[0, 4] = 0.0
    hmm.t[0, 5] = 1.0   # D0 row convention
    hmm.t[0, 6] = 0.0
    hmm.ins[0] = null
    i += 1

    rf = [" "]
    cs = [" "]
    mapv = [0]
    for k in range(1, M + 1):
        toks = lines[i].split()
        if int(toks[0]) != k:
            raise ValueError(f"expected HMMER2 node {k}, got {toks[0]!r}")
        hmm.mat[k] = [_h2_prob(t, null[x])
                      for x, t in enumerate(toks[1: K + 1])]
        if has_map and len(toks) > K + 1:
            mapv.append(int(toks[K + 1]))
        else:
            mapv.append(0)
        i += 1
        # insert line: leading RF char column, then K scores
        toks = lines[i].split()
        rf.append(toks[0] if has_rf and toks[0] != "-" else " ")
        ins_toks = toks[1: K + 1]
        if k < M and any(t != "*" for t in ins_toks):
            hmm.ins[k] = [_h2_prob(t, null[x])
                          for x, t in enumerate(ins_toks)]
        else:
            hmm.ins[k] = null   # no I_M in HMMER2; use background
        i += 1
        # transition line: leading CS char column, then 9 scores
        # (m->m m->i m->d i->m i->i d->m d->d b->m m->e)
        toks = lines[i].split()
        cs.append(toks[0] if has_cs and toks[0] != "-" else " ")
        tr = toks[1:10]
        if k < M:
            hmm.t[k] = [_h2_prob(t) for t in tr[:7]]
        else:
            # node M: M->E == 1 in HMMER2; HMMER3 core conventions
            hmm.t[M] = [1.0, 0.0, 0.0, 1.0, 0.0, 1.0, 0.0]
        i += 1

    if has_map:
        hmm.map = np.array(mapv, dtype=np.int32)
        hmm.flags |= HMMFlags.MAP
    if has_rf:
        hmm.reference = "".join(rf).encode()
        hmm.flags |= HMMFlags.RF
    if has_cs:
        hmm.consensus_structure = "".join(cs).encode()
        hmm.flags |= HMMFlags.CS

    hmm.renormalize()
    hmm.set_consensus()

    while i < len(lines) and lines[i].strip() != "//":
        i += 1
    return hmm, i + 1


# ---------------------------------------------------------------------------
# binary .h3m
# ---------------------------------------------------------------------------

def _read_string(fh: BinaryIO) -> Optional[str]:
    (n,) = struct.unpack("<i", fh.read(4))
    if n == 0:
        return None
    data = fh.read(n)
    return data.rstrip(b"\x00").decode("ascii", errors="replace")


def _write_string(fh: BinaryIO, s: Optional[Union[str, bytes]]) -> None:
    if s is None or s == b"" or s == "":
        fh.write(struct.pack("<i", 0))
        return
    data = s.encode("ascii") if isinstance(s, str) else bytes(s)
    data += b"\x00"
    fh.write(struct.pack("<i", len(data)))
    fh.write(data)


def read_hmm_binary_body(fh: BinaryIO, fmt: str = "3/f") -> HMM:
    """Read one binary HMM record (after the magic).

    Layout (reverse-engineered against the paired ASCII models in the
    reference test data; matches ``p7_hmmfile.c:write_bin30hmm``):
    flags, M, alphatype; mat[1..M]; ins[0..M]; t[0..M]; then optional
    flag-gated metadata fields.
    """
    flags, M, alph_type = struct.unpack("<iii", fh.read(12))
    alphabet = Alphabet.from_type(alph_type)
    K = alphabet.K
    hmm = HMM(alphabet, M)
    hmm.flags = flags

    def floats(n):
        return np.frombuffer(fh.read(4 * n), dtype="<f4").astype(np.float32)

    hmm.mat[1:] = floats(M * K).reshape(M, K)
    hmm.ins[0:] = floats((M + 1) * K).reshape(M + 1, K)
    hmm.t[0:] = floats((M + 1) * 7).reshape(M + 1, 7)

    def _ann(n: int) -> bytes:
        """Annotation lines are fixed-size char arrays (no length prefix)."""
        return fh.read(n).rstrip(b"\x00")

    name = _read_string(fh)
    hmm.name = (name or "").rstrip("\x00").encode()
    if flags & HMMFlags.ACC:
        hmm.accession = (_read_string(fh) or "").rstrip("\x00").encode()
    if flags & HMMFlags.DESC:
        hmm.description = (_read_string(fh) or "").rstrip("\x00").encode()
    if flags & HMMFlags.RF:
        hmm.reference = _ann(M + 2)
    if fmt >= "3/f" and flags & HMMFlags.MMASK:
        hmm.model_mask = _ann(M + 2)
    if fmt >= "3/e" and flags & HMMFlags.CONS:
        hmm.consensus = _ann(M + 2)
    if flags & HMMFlags.CS:
        hmm.consensus_structure = _ann(M + 2)
    if flags & HMMFlags.CA:
        hmm.consensus_accessibility = _ann(M + 2)
    cmd = _read_string(fh)
    if cmd is not None:
        hmm.command_line = cmd.rstrip("\x00")
    (hmm.nseq,) = struct.unpack("<i", fh.read(4))
    (hmm.eff_nseq,) = struct.unpack("<f", fh.read(4))
    if fmt >= "3/c":
        (hmm.max_length,) = struct.unpack("<i", fh.read(4))
    ctime = _read_string(fh)
    if ctime is not None:
        hmm.creation_time = ctime.rstrip("\x00")
    if flags & HMMFlags.MAP:
        hmm.map = np.frombuffer(
            fh.read(4 * (M + 1)), dtype="<i4").astype(np.int32)
    (hmm.checksum,) = struct.unpack("<I", fh.read(4))
    if not (flags & HMMFlags.CHKSUM):
        hmm.checksum = None
    # evparam and cutoffs are written unconditionally (unset = -99999)
    hmm.evparam[:] = struct.unpack("<6f", fh.read(24))
    hmm.cutoffs[:] = struct.unpack("<6f", fh.read(24))
    if fmt >= "3/e" and flags & HMMFlags.COMPO:
        hmm.composition = floats(K)
    return hmm


def write_hmm_binary(hmm: HMM, fh: BinaryIO, fmt: str = "3/f") -> None:
    """Write one binary HMM record, byte-compatible with ``.h3m``."""
    fh.write(struct.pack("<I", FORMAT_TO_MAGIC[fmt]))
    fh.write(struct.pack("<iii", hmm.flags, hmm.M, hmm.alphabet.type))
    fh.write(hmm.mat[1:].astype("<f4").tobytes())
    fh.write(hmm.ins.astype("<f4").tobytes())
    fh.write(hmm.t.astype("<f4").tobytes())
    _write_string(fh, hmm.name)
    if hmm.flags & HMMFlags.ACC:
        _write_string(fh, hmm.accession)
    if hmm.flags & HMMFlags.DESC:
        _write_string(fh, hmm.description)
    def _write_ann(s: Optional[bytes]) -> None:
        data = (s or b"").ljust(hmm.M + 2, b"\x00")[: hmm.M + 1] + b"\x00"
        fh.write(data)

    if hmm.flags & HMMFlags.RF:
        _write_ann(hmm.reference)
    if fmt >= "3/f" and hmm.flags & HMMFlags.MMASK:
        _write_ann(hmm.model_mask)
    if fmt >= "3/e" and hmm.flags & HMMFlags.CONS:
        _write_ann(hmm.consensus)
    if hmm.flags & HMMFlags.CS:
        _write_ann(hmm.consensus_structure)
    if hmm.flags & HMMFlags.CA:
        _write_ann(hmm.consensus_accessibility)
    _write_string(fh, hmm.command_line)
    fh.write(struct.pack("<i", hmm.nseq if hmm.nseq is not None else -1))
    fh.write(struct.pack(
        "<f", hmm.eff_nseq if hmm.eff_nseq is not None else -1.0))
    if fmt >= "3/c":
        fh.write(struct.pack(
            "<i", hmm.max_length if hmm.max_length is not None else -1))
    _write_string(fh, hmm.creation_time)
    if hmm.flags & HMMFlags.MAP and hmm.map is not None:
        fh.write(hmm.map.astype("<i4").tobytes())
    fh.write(struct.pack("<I", hmm.checksum or 0))
    fh.write(hmm.evparam.astype("<f4").tobytes())
    fh.write(hmm.cutoffs.astype("<f4").tobytes())
    if fmt >= "3/e" and hmm.flags & HMMFlags.COMPO and hmm.composition is not None:
        fh.write(hmm.composition.astype("<f4").tobytes())


# ---------------------------------------------------------------------------
# ASCII writer (HMMER3/f)
# ---------------------------------------------------------------------------

def _fmt_prob(p: float) -> str:
    if p == 0.0:
        return "        *"
    return f"  {-np.log(p):.5f}"


def write_hmm_ascii(hmm: HMM, fh) -> None:
    """Write HMMER3/f ASCII format (``p7_hmmfile_WriteASCII`` equivalent)."""
    w = fh.write
    binary_out = isinstance(fh, (io.BufferedIOBase, io.RawIOBase)) or (
        hasattr(fh, "mode") and "b" in getattr(fh, "mode", ""))
    if binary_out:
        import codecs
        fh = codecs.getwriter("ascii")(fh)
        w = fh.write
    K, M = hmm.alphabet.K, hmm.M
    w("HMMER3/f [i1.0 | pyhmmer-tpu]\n")
    w(f"NAME  {hmm.name.decode()}\n")
    if hmm.flags & HMMFlags.ACC and hmm.accession:
        w(f"ACC   {hmm.accession.decode()}\n")
    if hmm.flags & HMMFlags.DESC and hmm.description:
        w(f"DESC  {hmm.description.decode()}\n")
    w(f"LENG  {M}\n")
    if hmm.max_length is not None:
        w(f"MAXL  {hmm.max_length}\n")
    w(f"ALPH  {hmm.alphabet.name}\n")
    w(f"RF    {'yes' if hmm.flags & HMMFlags.RF else 'no'}\n")
    w(f"MM    {'yes' if hmm.flags & HMMFlags.MMASK else 'no'}\n")
    w(f"CONS  {'yes' if hmm.flags & HMMFlags.CONS else 'no'}\n")
    w(f"CS    {'yes' if hmm.flags & HMMFlags.CS else 'no'}\n")
    w(f"MAP   {'yes' if hmm.flags & HMMFlags.MAP else 'no'}\n")
    if hmm.creation_time:
        w(f"DATE  {hmm.creation_time}\n")
    if hmm.command_line:
        for n, cmd in enumerate(hmm.command_line.split("\n"), 1):
            w(f"COM   [{n}] {cmd}\n")
    if hmm.nseq is not None:
        w(f"NSEQ  {hmm.nseq}\n")
    if hmm.eff_nseq is not None:
        w(f"EFFN  {hmm.eff_nseq:f}\n")
    if hmm.flags & HMMFlags.CHKSUM:
        w(f"CKSUM {hmm.checksum}\n")
    if hmm.flags & HMMFlags.GA:
        w(f"GA    {hmm.cutoffs[0]:.2f} {hmm.cutoffs[1]:.2f}\n")
    if hmm.flags & HMMFlags.TC:
        w(f"TC    {hmm.cutoffs[2]:.2f} {hmm.cutoffs[3]:.2f}\n")
    if hmm.flags & HMMFlags.NC:
        w(f"NC    {hmm.cutoffs[4]:.2f} {hmm.cutoffs[5]:.2f}\n")
    if hmm.flags & HMMFlags.STATS:
        e = hmm.evparam
        w(f"STATS LOCAL MSV      {e[0]:8.4f} {e[1]:8.5f}\n")
        w(f"STATS LOCAL VITERBI  {e[2]:8.4f} {e[3]:8.5f}\n")
        w(f"STATS LOCAL FORWARD  {e[4]:8.4f} {e[5]:8.5f}\n")
    syms = hmm.alphabet.symbols[:K]
    w("HMM     " + "".join(f"     {s}    " for s in syms).rstrip() + "   \n")
    w("        " + "".join(f"   {s}  " for s in
                           ("m->m", "m->i", "m->d", "i->m", "i->i", "d->m", "d->d")) + "\n")
    if hmm.flags & HMMFlags.COMPO and hmm.composition is not None:
        w("  COMPO " + "".join(_fmt_prob(p) for p in hmm.composition) + "\n")
    w("        " + "".join(_fmt_prob(p) for p in hmm.ins[0]) + "\n")
    w("        " + "".join(_fmt_prob(p) for p in hmm.t[0]) + "\n")
    for k in range(1, M + 1):
        mapc = (str(int(hmm.map[k])) if hmm.flags & HMMFlags.MAP and
                hmm.map is not None else "-")
        cons = (chr(hmm.consensus[k]) if hmm.flags & HMMFlags.CONS and
                hmm.consensus else "-")
        rf = (chr(hmm.reference[k]) if hmm.flags & HMMFlags.RF and
              hmm.reference else "-")
        mm = (chr(hmm.model_mask[k]) if hmm.flags & HMMFlags.MMASK and
              hmm.model_mask else "-")
        cs = (chr(hmm.consensus_structure[k]) if hmm.flags & HMMFlags.CS and
              hmm.consensus_structure else "-")
        w(f"{k:7d} " + "".join(_fmt_prob(p) for p in hmm.mat[k]))
        w(f" {mapc:>6s} {cons} {rf} {mm} {cs}\n")
        w("        " + "".join(_fmt_prob(p) for p in hmm.ins[k]) + "\n")
        w("        " + "".join(_fmt_prob(p) for p in hmm.t[k]) + "\n")
    w("//\n")
