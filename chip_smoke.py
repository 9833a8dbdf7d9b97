#!/usr/bin/env python3
"""Start-up check of pyhmmer_tpu on an NVIDIA GPU.

Drives ``pyhmmer_tpu.hmmer.hmmsearch`` once at full width on a seeded
Pfam x proteome workload (``pyhmmer_tpu.synthetic``: built, calibrated
profile HMMs with a Pfam-like length mix against 4,489 proteome-like
targets), checks every device kernel of that path against its reference,
checks the hits against the float64 oracle pipeline, and runs nhmmer's
device gates against its host gates on a seeded genome.

    python chip_smoke.py              # one GPU, every phase
    python chip_smoke.py --multi      # parallel.mesh.sharded_search on 4
                                      # GPUs against the 1-GPU search

Earlier lines report each phase; the last line is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Any failed phase exits non-zero without that line, and so does a run
where JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

#: Pfam v33.1 (the pyhmmer benchmark's query database, BASELINE.md)
PFAM_MODELS = 18259
ECOLI_PROTEINS = 4489


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """``name, power limit`` of every card, from a child that stays off
    JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(ln.strip() for ln in out.stdout.splitlines()
                     if ln.strip())


class CompileCounter:
    """Counts XLA backend compilations while active."""

    def __init__(self):
        import jax.monitoring
        self.n = 0
        self.on = False
        jax.monitoring.register_event_duration_secs_listener(self._event)

    def _event(self, name, _dur, **_kw):
        if self.on and name == "/jax/core/compile/backend_compile_duration":
            self.n += 1

    @contextlib.contextmanager
    def count(self):
        self.n, self.on = 0, True
        try:
            yield self
        finally:
            self.on = False


@contextlib.contextmanager
def msv_recorder(forced: str = None):
    """Record every stage-1 MSV output by (profile stack, bucket); with
    ``forced`` set, run that MSV kernel regardless of the platform."""
    from pyhmmer_tpu.ops import kernels
    orig_msv, orig_name = kernels.msv, kernels.msv_kernel_name
    rec = {}

    def msv(pb, dev, platform=None):
        out = orig_msv(pb, dev, platform)
        rec[(id(pb), id(dev))] = (pb, dev, out)
        return out

    kernels.msv = msv
    if forced:
        kernels.msv_kernel_name = lambda platform, Mp: forced
    try:
        yield rec
    finally:
        kernels.msv, kernels.msv_kernel_name = orig_msv, orig_name


def hit_rows(th):
    return [(h.name, h.included, h.score) for h in th.reported]


def same_hits(a, b, tol: float = 1e-3) -> bool:
    ra, rb = hit_rows(a), hit_rows(b)
    return (len(ra) == len(rb)
            and all(x[0] == y[0] and x[1] == y[1] and abs(x[2] - y[2]) <= tol
                    for x, y in zip(ra, rb)))


def timed_search(hmmer, hmms, targets, engine, counter, label):
    """One hmmsearch through the caller's engine; logs its wall time,
    compilations and the engine's stage marks (seconds since start)."""
    import jax
    with counter.count():
        t0 = time.perf_counter()
        res = list(hmmer.hmmsearch(hmms, targets, engine=engine))
        jax.effects_barrier()
        dt = time.perf_counter() - t0
    marks = " ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in engine.last_timing.items())
    log(f"{label}: {dt:.3f} s, {counter.n} compilations, "
        f"{sum(len(th.reported) for th in res)} reported hits; {marks}")
    return res, dt, counter.n


def check_msv(rec_cuda, rec_scan, native, quantize_msv, rng):
    """CUDA MSV bit-exact against the scan for every (stack, bucket), and
    against the native host kernel on sampled and overflowing pairs."""
    from pyhmmer_tpu.ops.quantize import tjb_units
    assert rec_cuda.keys() == rec_scan.keys(), "stage-1 calls differ"
    groups, n_native, n_ovf = set(), 0, 0
    for key, (pb, dev, (dx, ovf)) in rec_cuda.items():
        sdx, sovf = rec_scan[key][2]
        dx, ovf = np.asarray(dx), np.asarray(ovf)
        assert np.array_equal(dx, np.asarray(sdx)), ("MSV dx", pb.Mp)
        assert np.array_equal(ovf, np.asarray(sovf)), ("MSV ovf", pb.Mp)
        groups.add((pb.Mp, dev.Lmax))
        P = len({id(p) for p in pb.profiles})
        lens = dev.lengths
        usc = ((dx.astype(np.float64) - tjb_units(np.maximum(lens, 1)))
               / pb.scale_b - 3.0)
        usc[ovf] = np.inf
        real = np.flatnonzero(lens > 0)
        pairs = [(int(p), int(b)) for p, b in zip(*np.nonzero(ovf[:P]))
                 if lens[b] > 0][:8]
        n_ovf += len(pairs)
        pairs += [(int(rng.integers(P)), int(rng.choice(real)))
                  for _ in range(8)]
        codes = dev._codes_host
        for p, b in pairs:
            want = native.msv_quant(quantize_msv(pb.profiles[p]),
                                    codes[b, : lens[b]])
            assert want == usc[p, b] or abs(want - usc[p, b]) < 1e-9, (
                "MSV vs native", pb.Mp, p, b, want, usc[p, b])
            n_native += 1
    return groups, n_native, n_ovf


def time_stage1(rec, rounds: int = 2):
    """Stage-1 time of each MSV kernel over every recorded (stack,
    bucket) call: host clock around each call up to its result, in turns
    cuda, scan, cuda, scan."""
    import jax
    from pyhmmer_tpu.ops import msv_cuda
    from pyhmmer_tpu.ops.batch import _msv_kernel
    calls = [(pb, dev) for pb, dev, _ in rec.values()]

    def scan(pb, dev):
        return _msv_kernel(
            dev.codes, dev.mask_f,
            *pb.device("msv_cost", "msv_bias", "msv_tec", "msv_tbm"),
            dev.tjb)

    times = []
    for _ in range(rounds):
        for name, fn in (("cuda", msv_cuda.msv), ("scan", scan)):
            t = 0.0
            for pb, dev in calls:
                t0 = time.perf_counter()
                jax.block_until_ready(fn(pb, dev))
                t += time.perf_counter() - t0
            times.append((name, t))
    return len(calls), times


def check_scans(engine, rng, tol: float = 0.05):
    """Forward and Viterbi scans against the float64 reference on sampled
    pairs of every Mp group (bucket 0, the engine's own shapes)."""
    import jax.numpy as jnp
    from pyhmmer_tpu.ops import reference as ref
    states = {}
    for cached in engine._model_cache.values():
        pb = cached[3]
        states.setdefault(pb.Mp, pb)
    bucket = engine._buckets_cache[2].buckets[0]
    idx, codes, lens, dev = bucket
    worst_f = worst_v = 0.0
    npairs = 0
    t_call = t_done = 0.0
    for Mp, pb in sorted(states.items()):
        rows = rng.choice(np.flatnonzero(lens > 0), size=4, replace=False)
        ridx = np.full(128, -1, dtype=np.int32)
        ridx[: len(rows)] = rows
        t0 = time.perf_counter()
        fwd = engine._forward_dev(pb, dev, jnp.asarray(ridx))
        t1 = time.perf_counter()
        fwd = np.asarray(fwd)
        t_call += t1 - t0
        t_done += time.perf_counter() - t0
        vit = np.asarray(engine._viterbi_dev(pb, dev, jnp.asarray(ridx)))
        for p in range(min(2, pb.P)):
            prof = pb.profiles[p].copy()
            for j, b in enumerate(rows):
                dsq = codes[b, : lens[b]]
                prof.reconfig_length(len(dsq))
                f64 = ref.forward(prof, dsq).score
                v64 = ref.viterbi_score(prof, dsq)
                worst_f = max(worst_f, abs(f64 - fwd[p, j]))
                worst_v = max(worst_v, abs(v64 - vit[p, j]))
                npairs += 1
    assert worst_f < tol and worst_v < tol, (worst_f, worst_v)
    log(f"Forward scan on bucket 0 (Lmax {dev.Lmax}): the call returned "
        f"after {t_call:.3f} s of {t_done:.3f} s to the result, over "
        f"{len(states)} calls")
    return len(states), npairs, worst_f, worst_v


def oracle_queries(hmms, n: int):
    """``n`` queries spread over the model-length range (the longest
    included), so every Mp group of the workload is sampled."""
    order = np.argsort([h.M for h in hmms], kind="stable")
    pick = np.unique(np.linspace(0, len(order) - 1, n).round().astype(int))
    return [int(order[i]) for i in pick]


def phase_nhmmer(args, hmmer):
    import pyhmmer_tpu.plan7.longtargets as LT
    from pyhmmer_tpu import synthetic
    hmm, genome = synthetic.dna_workload(args.genome, seed=args.seed)
    calls = {"n": 0}
    orig = LT.LongTargetsPipeline._device_gates

    def gates(self, prof, pend):
        calls["n"] += 1
        return orig(self, prof, pend)

    LT.LongTargetsPipeline._device_gates = gates
    try:
        t0 = time.perf_counter()
        dev_th = next(hmmer.nhmmer(hmm, genome))
        t_dev = time.perf_counter() - t0
    finally:
        LT.LongTargetsPipeline._device_gates = orig
    os.environ["PYHMMER_TPU_NHMMER_DEVICE"] = "0"
    try:
        t0 = time.perf_counter()
        host_th = next(hmmer.nhmmer(hmm, genome))
        t_host = time.perf_counter() - t0
    finally:
        del os.environ["PYHMMER_TPU_NHMMER_DEVICE"]

    def key(h):
        d = h.best_domain
        return (h.name, d.ali_from, d.ali_to, round(h.score, 6))
    assert calls["n"] > 0, "nhmmer device gates never ran"
    assert len(host_th.reported) > 0, "no nhmmer hits planted"
    assert sorted(map(key, dev_th)) == sorted(map(key, host_th)), \
        "nhmmer device-gate hits differ from host-gate hits"
    log(f"nhmmer: M={hmm.M} genome={len(genome[0])} nt x 2 strands; "
        f"{calls['n']} device-gate batches; {len(dev_th.reported)} "
        f"reported hits == host gates; device {t_dev:.3f} s, host "
        f"{t_host:.3f} s (first device call includes compilation)")


def run_single(args, jax, dev0):
    from pyhmmer_tpu import hmmer, synthetic
    from pyhmmer_tpu.engine import SearchEngine
    from pyhmmer_tpu.ops import kernels, msv_cuda, native
    from pyhmmer_tpu.ops.quantize import quantize_msv

    assert native.available(), "native host library did not build/load"
    log("native host library: loaded")
    t0 = time.perf_counter()
    msv_cuda.register()
    log(f"CUDA MSV library: built and registered in "
        f"{time.perf_counter() - t0:.3f} s (set-up)")

    t0 = time.perf_counter()
    hmms, targets = synthetic.protein_workload(args.queries, args.targets,
                                               seed=args.seed)
    Ms = np.array([h.M for h in hmms])
    Ls = np.array([len(s) for s in targets])
    log(f"workload (seed {args.seed}): {len(hmms)} queries (cut from "
        f"Pfam's {PFAM_MODELS}; M {Ms.min()}..{Ms.max()}, mean "
        f"{Ms.mean():.1f}, {int((Ms > 768).sum())} above 768) x "
        f"{len(targets)} targets (E. coli has {ECOLI_PROTEINS}; L "
        f"{Ls.min()}..{Ls.max()}, {int(Ls.sum())} residues); built in "
        f"{time.perf_counter() - t0:.3f} s (set-up)")

    counter = CompileCounter()
    eng = SearchEngine(hmms[0].alphabet)
    with msv_recorder() as rec_cuda:
        res, _, _ = timed_search(hmmer, hmms, targets, eng,
                                           counter, "cold hmmsearch "
                                           "(set-up)")
    kern = dict(eng.last_kernels)
    log(f"kernels: msv={','.join(kern['msv'])} forward={kern['forward']} "
        f"viterbi={kern['viterbi']} (Mp groups "
        f"{sorted({pb.Mp for pb, _, _ in rec_cuda.values()})})")
    assert "cuda" in kern["msv"], "CUDA MSV kernel did not run"
    res, t_warm, n_warm = timed_search(hmmer, hmms, targets, eng, counter,
                                       "warm hmmsearch, CUDA MSV")
    assert n_warm == 0, f"{n_warm} compilations in the warm search"
    assert sum(len(th.reported) for th in res) > 0, "no hits reported"

    # the MSV kernel A/B in turns: cuda, scan, scan, cuda
    with msv_recorder(forced="scan") as rec_scan:
        timed_search(hmmer, hmms, targets, eng, counter,
                     "cold hmmsearch, XLA-scan MSV (set-up)")
        res_scan, t_scan, _ = timed_search(hmmer, hmms, targets, eng,
                                           counter, "warm hmmsearch, "
                                           "XLA-scan MSV")
        _, t_scan2, _ = timed_search(hmmer, hmms, targets, eng, counter,
                                     "warm hmmsearch, XLA-scan MSV")
    _, t_warm2, _ = timed_search(hmmer, hmms, targets, eng, counter,
                                 "warm hmmsearch, CUDA MSV")
    for a, b in zip(res, res_scan):
        assert same_hits(a, b, 0.0), "scan-MSV hits differ from CUDA-MSV"
    log(f"MSV A/B (warm hmmsearch, s): cuda {t_warm:.3f}, scan "
        f"{t_scan:.3f}, scan {t_scan2:.3f}, cuda {t_warm2:.3f}")

    rng = np.random.default_rng(args.seed)
    groups, n_nat, n_ovf = check_msv(rec_cuda, rec_scan, native,
                                     quantize_msv, rng)
    log(f"check MSV: CUDA == XLA scan bit-exact on {len(rec_cuda)} "
        f"(stack, bucket) calls over {len(groups)} (Mp, Lmax) groups; "
        f"== native on {n_nat} pairs ({n_ovf} overflowing)")
    ncalls, times = time_stage1(rec_cuda)
    log(f"stage-1 MSV kernel time over {ncalls} calls (s): "
        + ", ".join(f"{n} {t:.4f}" for n, t in times))
    ngroups, npairs, wf, wv = check_scans(eng, rng)
    log(f"check Forward/Viterbi scans (float32, exact-gather emissions) "
        f"vs float64 reference: {npairs} pairs over {ngroups} Mp groups, "
        f"max |err| forward {wf:.2e} viterbi {wv:.2e} nats (tol 0.05)")

    qi = oracle_queries(hmms, args.oracle)
    t0 = time.perf_counter()
    oracle = list(hmmer.hmmsearch([hmms[i] for i in qi], targets,
                                  backend="oracle"))
    t_or = time.perf_counter() - t0
    for i, th in zip(qi, oracle):
        assert same_hits(res[i], th), f"hits differ from oracle for {i}"
    log(f"check hmmsearch vs oracle: {len(qi)} queries (M "
        f"{sorted(int(hmms[i].M) for i in qi)}) x {len(targets)} targets, "
        f"{sum(len(t.reported) for t in oracle)} reported hits identical "
        f"(names, included flags, scores within 1e-3 bits); oracle "
        f"{t_or:.3f} s")

    phase_nhmmer(args, hmmer)
    stats = dev0.memory_stats() or {}
    log(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")


def run_multi(args, jax, devs):
    from pyhmmer_tpu import synthetic
    from pyhmmer_tpu.engine import SearchEngine
    from pyhmmer_tpu.parallel.mesh import sharded_search
    assert len(devs) >= 4, f"--multi needs 4 GPUs, found {len(devs)}"
    devs = devs[:4]
    t0 = time.perf_counter()
    hmms, targets = synthetic.protein_workload(args.queries, args.targets,
                                               seed=args.seed)
    log(f"workload (seed {args.seed}): {len(hmms)} queries x "
        f"{len(targets)} targets, built in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    single = SearchEngine(hmms[0].alphabet, device=devs[0]).search(
        hmms, targets)
    t_single = time.perf_counter() - t0
    engines = []

    def factory(device):
        eng = SearchEngine(hmms[0].alphabet, device=device)
        engines.append(eng)
        return eng

    t0 = time.perf_counter()
    merged = sharded_search(hmms, targets, devices=devs,
                            engine_factory=factory)
    t_multi = time.perf_counter() - t0
    for eng in engines:
        want = {eng.device}
        for bucket in eng._buckets_cache[2].buckets:
            sdev = bucket[3]
            for x in (sdev.codes, sdev.mask_b,
                      *(sdev._msv_operands or ())):
                assert x.devices() == want, ("bucket array off its card",
                                             x.devices(), want)
        for cached in eng._model_cache.values():
            for x in cached[3]._device_cache.values():
                for y in (x.values() if isinstance(x, dict) else [x]):
                    assert y.devices() == want, ("profile array off its "
                                                 "card", y.devices(), want)
    log(f"placement: every bucket and profile array of shard k lives on "
        f"{[str(d) for d in devs]}[k]")
    nrep = 0
    for a, b in zip(single, merged):
        assert same_hits(a, b, 0.0), "sharded hits differ from 1-card"
        assert a.Z == b.Z
        nrep += len(a.reported)
    stats = sharded_search.last_stats
    log(f"sharded_search on 4 cards: {nrep} reported hits identical to "
        f"1 card; 1-card cold {t_single:.3f} s, 4-card cold "
        f"{t_multi:.3f} s, shard walls {stats['shard_walls']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queries", type=int, default=None,
                    help="query models (default 400; 32 with --multi)")
    ap.add_argument("--targets", type=int, default=ECOLI_PROTEINS)
    ap.add_argument("--oracle", type=int, default=16,
                    help="queries checked against the oracle pipeline")
    ap.add_argument("--genome", type=int, default=2_000_000,
                    help="nhmmer genome length in nucleotides")
    ap.add_argument("--multi", action="store_true",
                    help="sharded_search on 4 GPUs vs 1 GPU, nothing else")
    args = ap.parse_args(argv)
    if args.queries is None:
        args.queries = 32 if args.multi else 400

    log(f"card: {card_line()}")
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX found {devs}", file=sys.stderr)
        return 2
    log(f"jax {jax.__version__}: {devs} platform={devs[0].platform} "
        f"kind={devs[0].device_kind}")
    if args.multi:
        run_multi(args, jax, devs)
    else:
        run_single(args, jax, devs[0])
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
