"""Subprocess body for the 2-process multihost test.

Usage: python _multihost_worker.py <pid> <nproc> <port> <ntargets> <out>

Initializes ``jax.distributed`` against a localhost coordinator on the
CPU platform, runs ``multihost_search`` over its residue-balanced shard
of the seeded ``synthetic.small_workload(ntargets)``, and writes the merged reported rows as JSON.
Every rank must produce the identical merged table
(tests/test_multihost.py compares them to the single-process output).
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

pid, nproc, port, ntargets = (int(a) for a in sys.argv[1:5])
out_path = sys.argv[5]

import jax

jax.config.update("jax_platforms", "cpu")

from pyhmmer_tpu.parallel import multihost

multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                     num_processes=nproc, process_id=pid)
assert jax.process_count() == nproc, jax.process_count()

from pyhmmer_tpu import synthetic

hmms, targets = synthetic.small_workload(ntargets)

merged = multihost.multihost_search(hmms, targets)
rows = []
for th in merged:
    rows.append([[h.name.decode(), round(h.score, 9),
                  round(h.evalue, 12), h.included]
                 for h in th.reported])
    rows.append([th.Z, th.nseqs, th.n_past_msv, th.n_past_fwd])
with open(out_path, "w") as f:
    json.dump(rows, f)
