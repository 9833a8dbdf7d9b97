"""Executable API spec: run every public docstring example
(the reference's ``tests/test_doctest.py`` pattern -- docstring
examples double as an API contract)."""
import doctest

import pytest

MODULES = [
    "pyhmmer_tpu.easel.alphabet",
    "pyhmmer_tpu.easel.containers",
    "pyhmmer_tpu.easel.sequence",
    "pyhmmer_tpu.plan7.hmm",
    "pyhmmer_tpu.plan7.background",
    "pyhmmer_tpu.plan7.fitting",
    "pyhmmer_tpu.plan7.evalues",
    "pyhmmer_tpu.utils",
    "pyhmmer_tpu.synthetic",
    # user-facing API: the app layer, pipeline, results, model I/O,
    # pressed DBs, and the daemon all carry executable examples on the
    # seeded workloads of pyhmmer_tpu.synthetic
    "pyhmmer_tpu.hmmer",
    "pyhmmer_tpu.plan7.pipeline",
    "pyhmmer_tpu.plan7.results",
    "pyhmmer_tpu.plan7.hmmfile",
    "pyhmmer_tpu.plan7.pressed",
    "pyhmmer_tpu.daemon",
]


@pytest.mark.parametrize("modname", MODULES)
def test_doctests(modname):
    import importlib

    mod = importlib.import_module(modname)
    results = doctest.testmod(
        mod, verbose=False,
        optionflags=doctest.ELLIPSIS | doctest.NORMALIZE_WHITESPACE)
    assert results.attempted > 0 or modname in (
        "pyhmmer_tpu.plan7.evalues",), f"no doctests in {modname}"
    assert results.failed == 0
