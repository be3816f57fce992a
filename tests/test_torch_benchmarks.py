"""The port's benchmarks module on the CPU: the problems it builds against
miniprot_tpu's (the genic generator) and against the JAX package's host
C engine (each problem the rates time gives miniprot_tpu.native's
scores, ends and CIGARs when run through the port's plain versions),
and its record keys against miniprot_tpu.benchmarks'.  The rates
themselves are the card's: on the CPU only their keys and signs are
held."""
import math
import pathlib

import numpy as np
import pytest

from miniprot_tpu import benchmarks as jbench
from miniprot_tpu import native as jnative
from miniprot_tpu import options as jopt
from miniprot_tpu.align import DpEnv as JDpEnv
from miniprot_tpu.native import DPF_CIGAR, DPF_EXT_RIGHT
from miniprot_tpu_torch import benchmarks as tbench
from miniprot_tpu_torch.kernels import nasw_cigar_scan as csk
from miniprot_tpu_torch.kernels import nasw_cigar_striped as cst

AA = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
PORT = pathlib.Path(__file__).resolve().parents[1] / "miniprot_tpu_torch"


def _host_kw(xdrop=None):
    """miniprot_tpu's DP arguments at the default options."""
    o = jopt.MapOpt()
    kw = dict(JDpEnv(o).kw, io=o.io)
    if xdrop is not None:
        kw["xdrop"] = xdrop
    return kw


@pytest.mark.parametrize("seed", [1, 5, 9])
@pytest.mark.parametrize("NL,AL", [(2048, 32), (8192, 128)])
def test_genic_nt_equals_jax(seed, NL, AL):
    nt, aa = tbench._genic_nt(np.random.default_rng(seed), NL, AL)
    jnt, jaa = jbench._genic_nt(np.random.default_rng(seed), NL, AL)
    assert nt.dtype == jnt.dtype and aa.dtype == jaa.dtype
    assert nt.tobytes() == jnt.tobytes() and aa.tobytes() == jaa.tobytes()
    assert len(nt) == NL and len(aa) == AL


def test_ext_bench_problems_match_host_engine():
    """The CPU bench's ext batch (al 64 x nl 264, x-drop off) through K7's
    and K1's plain versions: each problem's score and ends equal
    miniprot_tpu.native.dp16's right extension."""
    batch, probs = tbench.ext_batch(64, 264, 32, "cpu")
    got = batch.collect(batch.launch(batch.stage()))
    kw = _host_kw(xdrop=1 << 28)
    for (nt, aa), r in zip(probs, got):
        sc, ntl, aal, _ = jnative.dp16(nt, AA[aa], flag=DPF_EXT_RIGHT, **kw)
        assert r == (sc, ntl, aal)


@pytest.mark.parametrize("cls,W,NL,genic", [
    (csk.RawScanCigarBatch, 16, 256, False),      # the CPU bench's shape
    (csk.SmallScanCigarBatch, 32, 512, False),
    (csk.RawScanCigarBatch, 128, 512, False),
    (csk.RawScanCigarBatch, 128, 512, True),
    (cst.SmallCigarBatch, 32, 512, False),
    (cst.RawCigarBatch, 128, 512, False)],
    ids=["scan16", "scan_small", "scan", "scan_genic", "striped_small",
         "striped"])
def test_cigar_bench_problems_match_host_engine(cls, W, NL, genic):
    """Each CIGAR class the bench times, its problems built as the bench
    builds them (at CPU sizes), through the plain versions of K7, the DP
    and its walk: the walk's states decoded by miniprot_tpu.native.
    cigar_from_states and the batch's own collect() both give dp16's
    score and CIGAR."""
    batch, probs = tbench.cigar_batch(cls, W, NL, 8, "cpu",
                                      np.random.default_rng(5), genic)
    handles = batch.launch(batch.stage())
    arrays = [t.numpy() for t in handles]
    got = batch.collect(handles)
    kw = _host_kw()
    for b, ((nt, aa), r) in enumerate(zip(probs, got)):
        sc, _, _, cig = jnative.dp16(nt, AA[aa], flag=DPF_CIGAR, **kw)
        if issubclass(cls, csk.RawScanCigarBatch):
            states, counts, fi, fj, score = arrays
            exp = np.repeat(states[b], counts[b].view(np.uint16))
        else:
            states, fi, fj, score = arrays
            exp = states[b]
        walked = jnative.cigar_from_states(exp.astype(np.uint8),
                                           int(fi[b]), int(fj[b]))
        assert int(score[b]) == sc and np.array_equal(walked, cig)
        assert r[0] == sc and np.array_equal(r[1], cig)


def test_cigar_host_rates_have_jax_keys():
    got = tbench.measure_cigar_host_gcups()
    assert set(got) == set(jbench.measure_cigar_host_gcups())
    assert all(math.isfinite(v) and v > 0 for v in got.values())


def test_measures_on_cpu_give_jax_off_tpu_keys():
    """miniprot_tpu.benchmarks' off-TPU branches: measure_ext_gcups fills
    ext_gcups_reps and ext_gcups_spread; measure_cigar_gcups gives the
    two device keys (one shape) and the host keys."""
    detail: dict = {}
    v = tbench.measure_ext_gcups(detail, device="cpu")
    assert set(detail) == {"ext_gcups_reps", "ext_gcups_spread"}
    assert math.isfinite(v) and v > 0 and detail["ext_gcups_reps"] == [v]
    assert detail["ext_gcups_spread"] == 0
    cig = tbench.measure_cigar_gcups(device="cpu")
    assert set(cig) == {"cigar_gcups_device_small", "cigar_gcups_device",
                        "cigar_gcups_host_small", "cigar_gcups_host"}
    assert all(math.isfinite(x) and x > 0 for x in cig.values())


def test_bench_record_on_cpu_names_its_device_and_has_no_peak_share():
    rec = tbench.run_bench_op("ext", device="cpu")
    assert rec["device"] == "cpu" and rec["value"] > 0
    assert not any("share" in k for k in rec)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_unknown_bench_kind_raises(device):
    with pytest.raises(ValueError, match="unknown bench kind"):
        tbench.run_bench_op("x", device=device)


def test_port_carries_no_tpu_peak_constant():
    """The TPU's per-cell VPU op counts and lane-op peak stay in the JAX
    package; the port's peak shares use its H100 rates."""
    names = ("VPU_PEAK_LANE_OPS", "EXT_OPS_PER_CELL", "CIG_SCAN_OPS_PER_CELL",
             "vpu_util")
    for path in PORT.rglob("*.py"):
        src = path.read_text()
        assert not any(n in src for n in names), path
    assert tbench.INT16_OPS_PER_S == 4 * tbench.INT32_OPS_PER_S
