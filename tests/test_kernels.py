"""The device stages on seeded inputs: the XLA scans against the native
and float64 references, the CUDA MSV wrapper's packing and the choice of
kernel, the engine against the oracle, and the compile-cache rule."""
import numpy as np
import pytest

from pyhmmer_tpu import hmmer, synthetic
from pyhmmer_tpu.easel.alphabet import Alphabet
from pyhmmer_tpu.engine import SearchEngine, _Buckets
from pyhmmer_tpu.ops import batch as B, kernels, msv_cuda, native
from pyhmmer_tpu.ops import reference as ref
from pyhmmer_tpu.ops.quantize import quantize_msv
from pyhmmer_tpu.plan7.background import Background
from pyhmmer_tpu.plan7.hmm import HMM
from pyhmmer_tpu.plan7.profile import Profile

MS = (40, 150, 300)


@pytest.fixture(scope="module")
def stacks():
    """Profile stacks in three Mp groups (sampled models), and a bucket
    of random targets plus each group's consensus, which overflows."""
    rng = np.random.default_rng(5)
    alph = Alphabet.amino()
    bg = Background(alph)
    out = []
    for M in MS:
        profs = [Profile(M, alph).configure(HMM.sample(alph, M, rng), bg,
                                            400) for _ in range(3)]
        pb = B.ProfileBatch(profs, Mp=B.round_up(M, 32))
        lens = rng.integers(1, 200, 12)
        codes = np.full((12, 256), alph.nonresidue_code, np.uint8)
        for i, L in enumerate(lens):
            codes[i, :L] = rng.integers(0, alph.K, L)
        cons = np.argmax(profs[0].msc[: alph.K, 1:], axis=0)[:256]
        codes[0, : len(cons)] = cons
        lens[0] = len(cons)
        lens[-1] = 0                              # an empty padding lane
        out.append((pb, codes, lens))
    return out


@pytest.mark.parametrize("gi", range(len(MS)))
def test_msv_scan_exact(stacks, gi):
    """The gather-based XLA MSV equals the native uint8 kernel and the
    NumPy reference on every pair, overflow included."""
    pb, codes, lens = stacks[gi]
    usc = B.msv_scores(pb, codes, lens)
    n_inf = 0
    for p in range(3):
        q = quantize_msv(pb.profiles[p])
        for b in range(len(lens) - 1):
            dsq = codes[b, : lens[b]]
            want = native.msv_quant(q, dsq)
            assert want == ref.msv_score_quantized(pb.profiles[p], dsq)
            assert want == usc[p, b] or abs(want - usc[p, b]) < 1e-9
            n_inf += np.isinf(want)
    assert n_inf >= 1                             # overflow rows covered


@pytest.mark.parametrize("gi", range(len(MS)))
@pytest.mark.parametrize("which", ["forward", "viterbi"])
def test_dp_scans_vs_float64(stacks, gi, which):
    """The float32 Forward/Viterbi scans stay within 0.05 nats of the
    float64 reference."""
    pb, codes, lens = stacks[gi]
    fn = B.forward_scores if which == "forward" else B.viterbi_scores
    got = fn(pb, codes, lens)
    for p in range(3):
        prof = pb.profiles[p].copy()
        for b in range(1, len(lens) - 1):
            dsq = codes[b, : lens[b]]
            prof.reconfig_length(len(dsq))
            want = (ref.forward(prof, dsq).score if which == "forward"
                    else ref.viterbi_score(prof, dsq))
            assert abs(want - got[p, b]) < 0.05, (p, b, want, got[p, b])


@pytest.mark.parametrize("Mp", [32, 128, 129, 300, 1024, 4096])
def test_cuda_cost_packing(Mp):
    """Cost words: lane l, word q, byte j holds model position
    4*(Q*l + q) + j; positions past Mp cost 255; the packing inverts."""
    rng = np.random.default_rng(Mp)
    cost = rng.integers(0, 256, (2, 29, Mp)).astype(np.uint8)
    Q = msv_cuda.words_per_lane(Mp)
    assert Q in msv_cuda.Q_LADDER and 128 * Q >= Mp
    assert Q == msv_cuda.Q_LADDER[0] or 128 * msv_cuda.Q_LADDER[
        msv_cuda.Q_LADDER.index(Q) - 1] < Mp
    w = msv_cuda.pack_costs(cost, Q)
    assert w.shape == (2, 29, Q, 32) and w.dtype == np.uint32
    assert np.array_equal(msv_cuda.unpack_costs(w, Mp), cost)
    for (p, x, l, q, j) in [(0, 0, 0, 0, 0), (1, 28, 31, Q - 1, 3),
                            (1, 5, 7, Q // 2, 1)]:
        pos = 4 * (Q * l + q) + j
        byte = (int(w[p, x, q, l]) >> (8 * j)) & 255
        assert byte == (cost[p, x, pos] if pos < Mp else 255)


def test_cuda_profile_operands(stacks):
    """Scalars are HMMER's (bias, tec, tbm) per profile and the packed
    table unpacks to the scan's cost tensor."""
    pb = stacks[1][0]
    t = msv_cuda.profile_tensors(pb)
    scal = np.asarray(t["scal"])
    for p in range(pb.P):
        q = quantize_msv(pb.profiles[p])
        assert tuple(scal[p, :3]) == (q.bias_b, q.tec_b, q.tbm_b)
    cost = msv_cuda.unpack_costs(np.asarray(t["cost"]), pb.Mp)
    assert np.array_equal(cost, pb.msv_cost.astype(np.uint8))
    with pytest.raises(ValueError):
        msv_cuda.words_per_lane(msv_cuda.MAX_MP + 1)


def test_kernel_choice():
    assert kernels.msv_kernel_name("gpu", 128) == "cuda"
    assert kernels.msv_kernel_name("gpu", msv_cuda.MAX_MP) == "cuda"
    assert kernels.msv_kernel_name("gpu", msv_cuda.MAX_MP + 32) == "scan"
    assert kernels.msv_kernel_name("cpu", 128) == "scan"
    assert kernels.use_device_gates("gpu")
    assert not kernels.use_device_gates("cpu")
    assert kernels.platform_of() == "cpu"


def test_compile_cache_rule():
    assert B.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x"}) is None
    assert B.compile_cache_dir({}) == B.CACHE_DIR
    assert B.CACHE_DIR.endswith("build/jax_cache")


def test_bucket_widths():
    """Each bucket's code matrix is as wide as its longest target rounded
    up to a power of two (at least 512), capped by its ladder level."""
    alph = Alphabet.amino()
    rng = np.random.default_rng(0)
    block = synthetic.make_targets(alph, 40, [], rng, ladder=True)
    widths = {int(b[1].shape[1]): int(b[2].max())
              for b in _Buckets(block).buckets}
    assert sorted(widths) == [512, 2048, 4096, 16384]
    for w, longest in widths.items():
        assert longest <= w and (w == 512 or longest > w // 2)


@pytest.fixture(scope="module")
def small_workload():
    rng = np.random.default_rng(3)
    alph = Alphabet.amino()
    hmms, consensi = synthetic.build_queries(alph, (70, 140, 260), rng)
    targets = synthetic.make_targets(alph, 120, consensi, rng,
                                     plant_frac=0.3, ladder=False)
    return hmms, targets


def test_engine_matches_oracle(small_workload):
    """Hit-for-hit: the engine's reported names, included flags and
    scores equal the sequential float64 oracle pipeline's."""
    hmms, targets = small_workload
    eng = SearchEngine(hmms[0].alphabet)
    got = eng.search(hmms, targets)
    assert eng.last_kernels == {"msv": ["scan"], "forward": "scan",
                                "viterbi": "scan"}
    want = list(hmmer.hmmsearch(hmms, targets, backend="oracle"))
    nrep = 0
    for g, w in zip(got, want):
        gr = [(h.name, h.included, round(h.score, 3)) for h in g.reported]
        wr = [(h.name, h.included, round(h.score, 3)) for h in w.reported]
        assert gr == wr
        nrep += len(wr)
    assert nrep >= 5


def test_backend_names(small_workload):
    hmms, targets = small_workload
    with pytest.raises(ValueError, match="unknown backend"):
        hmmer.hmmsearch(hmms, targets, backend="bogus")
    with pytest.raises(ValueError, match="unknown backend"):
        hmmer.hmmscan(targets[:2], hmms, backend="bogus")


@pytest.mark.gpu
def test_cuda_msv_matches_scan(stacks, gpu_device):
    """The CUDA kernel is bit-exact against the XLA scan (on the GPU;
    ``chip_smoke.py`` runs the same check at full width)."""
    import jax
    for pb, codes, lens in stacks:
        with jax.default_device(gpu_device):
            dev = B.SeqDevice(codes, lens)
            dx, ovf = msv_cuda.msv(pb, dev)
            sdx, sovf = B._msv_kernel(
                dev.codes, dev.mask_f,
                *pb.device("msv_cost", "msv_bias", "msv_tec", "msv_tbm"),
                dev.tjb)
        assert np.array_equal(np.asarray(dx), np.asarray(sdx))
        assert np.array_equal(np.asarray(ovf), np.asarray(sovf))
