"""nhmmer windowed-search throughput on the accelerator.

Workload: the bundled bmyD DNA model scanned over a synthetic 8 Mb
genome (random background with planted bmyD consensus copies), both
strands -- the long-targets pipeline streams 256 Kb windows, SSV-seeds
subwindows, and gates them through the batched device kernels
(plan7/longtargets._flush_subwindows).

Prints ONE JSON line: {"metric", "value", "unit", "windows", "hits"}.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

DATA = "/root/reference/src/pyhmmer/tests/data"
GENOME_MB = float(os.environ.get("BENCH_NHMMER_MB", "8"))


def build_genome(hmm, n_bases: int, n_hits: int = 0):
    """Random background with sparse planted (mutated) consensus copies;
    spacing >> 2*max_length so subwindows stay independent."""
    if not n_hits:
        n_hits = max(4, int(n_bases / 1e6) * 2)
    rng = np.random.default_rng(11)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    cons = np.argmax(hmm.mat[1:], axis=1).astype(np.uint8)
    parts = []
    per = n_bases // (n_hits + 1)
    for i in range(n_hits):
        parts.append(lut[rng.integers(0, 4, per)])
        copy = cons.copy()
        idx = rng.choice(len(copy), size=len(copy) // 10, replace=False)
        copy[idx] = rng.integers(0, 4, len(idx)).astype(np.uint8)
        parts.append(lut[copy])
    parts.append(lut[rng.integers(0, 4, per)])
    return np.concatenate(parts).tobytes().decode("ascii")


def main():
    t_start = time.time()
    from pyhmmer_tpu.plan7 import HMMFile
    from pyhmmer_tpu.easel import SequenceFile
    from pyhmmer_tpu import hmmer
    import io

    with HMMFile(os.path.join(DATA, "hmms", "txt", "bmyD.hmm")) as f:
        bmyd = f.read()
    genome = build_genome(bmyd, int(GENOME_MB * 1e6))
    fasta = f">synth_chr planted bmyD copies\n{genome}\n"

    def run():
        with SequenceFile(io.StringIO(fasta), format="fasta", digital=True,
                          alphabet=bmyd.alphabet) as sf:
            return list(hmmer.nhmmer(bmyd, sf))[0]

    th = run()   # warmup (compiles kernel shapes)
    times = []
    for _ in range(int(os.environ.get("BENCH_RUNS", "3"))):
        t0 = time.time()
        th = run()
        times.append(time.time() - t0)
    dt = min(times)
    nres = len(genome)
    print(json.dumps({
        "metric": "nhmmer_tpu_residues_per_s",
        "value": round(2 * nres / dt, 1),   # both strands
        "unit": "strand*residues/s",
        "windows": -(-nres // 262144),
        "hits": len(th.reported),
    }))
    print(f"# {nres} residues x 2 strands; runs "
          f"{['%.2f' % t for t in times]}s, best {dt:.2f}s; "
          f"{len(th.reported)} hits (total wall {time.time()-t_start:.1f}s)",
          file=sys.stderr)


if __name__ == "__main__":
    main()
