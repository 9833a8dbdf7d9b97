"""pyhmmer_tpu — an accelerator-batched profile HMM search engine.

A from-scratch reimplementation of the capability surface of
`pyhmmer <https://github.com/althonos/pyhmmer>`_ (HMMER3) built for a
GPU: batched JAX DP kernels over [profiles x sequences],
pjit/shard_map data parallelism over device meshes, and pure-Python
bio I/O.  See SURVEY.md for the reference blueprint.
"""

__version__ = "0.1.0"

from . import easel
from . import errors
from . import plan7
from . import daemon
from .hmmer import (
    hmmsearch,
    hmmscan,
    phmmer,
    nhmmer,
    jackhmmer,
    hmmalign,
    hmmpress,
)

__all__ = [
    "easel", "errors", "plan7", "hmmer", "daemon",
    "hmmsearch", "hmmscan", "phmmer", "nhmmer", "jackhmmer",
    "hmmalign", "hmmpress", "__version__",
]
