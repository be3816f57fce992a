"""The human splice model (-j 2) through the port's map on the CPU.

A small workload shaped like the GRCh38 x zebrafish deployment (a
distant homolog at mut_rate 0.30, non-canonical and poly-Y introns,
frameshifts, both strands), made by the benchmark's frozen generator:
the port's map_file(device="cpu"), the GPU engine on the kernels' plain
PyTorch versions, writes at sp_model 2 the bytes of
miniprot_tpu.pipeline.map_file(use_tpu=False) and, protein by protein,
those of the benchmark's frozen reference (portbench.refmap), whose own
-j 1 output differs, so a port that ignored sp_model would fail here.
The engine's host-cell and region counters (map_file(stats=)
``host_cells_by_reason``, ``dp_regions``) are held against counts made
here, on the inline host route (one thread) and the workers' (two)."""

import io

import numpy as np
import pytest
import torch

from miniprot_tpu import index as jidx
from miniprot_tpu import options as jopt
from miniprot_tpu import pipeline as jpipe
from miniprot_tpu_torch import align as talign
from miniprot_tpu_torch import device as tdev
from miniprot_tpu_torch import index as tidx
from miniprot_tpu_torch import native as tnative
from miniprot_tpu_torch import options as topt
from miniprot_tpu_torch import pipeline as tpipe
from portbench import check as pcheck
from portbench import workgen
from portbench.refmap import index as ridx
from portbench.refmap import options as ropt
from portbench.refmap.run import map_gff

WORKLOAD = dict(contigs=[["c1", 100_000], ["c2", 100_000]], total_genes=12,
                protein_len={"median": 300, "sigma": 0.5, "min_aa": 50},
                max_exons=6, max_intron=1500, mut_rate=0.30, rev_frac=0.4,
                fs_frac=0.1, tandem_frac=0.0, satellites_per_ctg=0,
                splice_classes=0.3)


def _opts(mod, sp_model):
    """--gff -j <sp_model> -G 4k (bw = max_intron = 4000: the plain
    kernels' time grows with the windows' rows)."""
    o = mod.MapOpt()
    o.flag |= mod.F_GFF
    o.bw = o.max_intron = 4000
    o.sp_model = sp_model
    o.check()
    return o


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain kernels run many small tensor ops: one thread each,
    since the suite's other workers hold the other cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    d = tmp_path_factory.mktemp("mammal_splice")
    fa, faa = str(d / "g.fa"), str(d / "q.faa")
    n = workgen.make_workload(fa, faa, seed=2**31 + 18, **WORKLOAD)
    assert n >= 12
    return fa, faa


@pytest.fixture(scope="module")
def reference(workload):
    """{sp_model: {protein: normalised output}} of the frozen reference."""
    fa, faa = workload
    prots = pcheck.read_fasta(faa)
    mi = ridx.Index.build(fa, ropt.IdxOpt())
    return {j: {k: pcheck.normalise(v)
                for k, v in map_gff(mi, _opts(ropt, j), prots).items()}
            for j in (1, 2)}


@pytest.fixture(scope="module")
def jax_gff(workload):
    fa, faa = workload
    buf = io.StringIO()
    jpipe.map_file(jidx.Index.build(fa, jopt.IdxOpt()), faa, _opts(jopt, 2),
                   n_threads=1, out=buf, use_tpu=False)
    return buf.getvalue()


@pytest.fixture(scope="module")
def port_runs(workload):
    """{n_threads: run} of the port's map at -j 2, each made once: its
    output and stats, and what was counted here while it ran."""
    fa, faa = workload
    mi = tidx.Index.build(fa, topt.IdxOpt())
    # the native engine's one-shot x4 probe runs DPs of its own: before
    # the counting starts
    tnative._x4_pays(talign.DpEnv(_opts(topt, 2)).ctx)
    runs: dict = {}

    def get(n_threads):
        if n_threads not in runs:
            runs[n_threads] = _port_map(mi, faa, n_threads)
        return runs[n_threads]
    return get


def _port_map(mi, faa, n_threads):
    """The port's map with the engine's routing, the native host DPs and
    the regions' DP generators observed from outside the counters."""
    mp = pytest.MonkeyPatch()
    routed: dict = {}      # reason -> sum(nl * al) of the jobs routed
    native = [0]           # sum(nl * al) of every native host DP
    regions = [0]

    def routing(real):
        def launch(self, jobs):
            pending, host = real(self, jobs)
            for reason, idxs in host.items():
                routed[reason] = routed.get(reason, 0) + sum(
                    len(jobs[i].nsq) * len(jobs[i].asq) for i in idxs)
            return pending, host
        return launch

    real_dp, real_many = tnative.Dp16Ctx.dp, tnative.Dp16Ctx.dp_many

    def dp(self, nsq, asq, *a, **kw):
        native[0] += len(nsq) * len(asq)
        return real_dp(self, nsq, asq, *a, **kw)

    def dp_many(self, jobs, use_x4, sel=None):
        s = np.arange(jobs.n) if sel is None else sel
        native[0] += int(np.dot(jobs.nl[s].astype(np.int64), jobs.al[s]))
        return real_many(self, jobs, use_x4, sel)

    real_steps = talign.align_region_steps

    def steps(*a, **kw):
        regions[0] += 1
        return real_steps(*a, **kw)

    try:
        for name in ("_launch_ext", "_launch_cig"):
            mp.setattr(tdev.GpuExtEngine, name,
                       routing(getattr(tdev.GpuExtEngine, name)))
        mp.setattr(tnative.Dp16Ctx, "dp", dp)
        mp.setattr(tnative.Dp16Ctx, "dp_many", dp_many)
        mp.setattr(talign, "align_region_steps", steps)
        buf, stats = io.StringIO(), {}
        tpipe.map_file(mi, faa, _opts(topt, 2), n_threads=n_threads,
                       out=buf, device="cpu", stats=stats)
    finally:
        mp.undo()
    return dict(gff=buf.getvalue(), stats=stats, routed=routed,
                native=native[0], regions=regions[0])


def test_reference_splice_model_changes_the_output(reference):
    """The reference's -j 2 output differs from its -j 1 output, so the
    comparisons below can tell a port that ignores sp_model."""
    j1, j2 = reference[1], reference[2]
    assert set(j1) == set(j2) and len(j2) >= 12
    assert sum(j1[k] != j2[k] for k in j2) >= 1


@pytest.mark.parametrize("n_threads", [1, 2])
def test_port_j2_matches_the_jax_package(port_runs, jax_gff, n_threads):
    run = port_runs(n_threads)
    assert run["gff"] == jax_gff
    assert run["gff"].count("\tmRNA\t") >= 8
    # the DPs went through the engine: ext and CIGAR batches launched
    assert run["stats"]["batches"]["ext"] > 0
    assert run["stats"]["n_device"] > 0


@pytest.mark.parametrize("n_threads", [1, 2])
def test_port_j2_matches_the_reference(port_runs, reference, n_threads):
    got = pcheck.split_blocks(port_runs(n_threads)["gff"])
    assert pcheck.count_differing(reference[2], [got]) == (0, [])


@pytest.mark.parametrize("n_threads", [1, 2])
def test_host_cells_by_reason_counts_each_routed_job_once(port_runs,
                                                          n_threads):
    run = port_runs(n_threads)
    st = run["stats"]
    assert st["host_reasons"], "no DP was routed to the host"
    assert set(st["host_reasons"]) <= set(run["routed"])
    assert st["host_cells_by_reason"] == run["routed"]
    # every host DP the native engine ran during the map, counted once
    assert sum(st["host_cells_by_reason"].values()) == run["native"]
    assert st["host_offthread"] == (st["n_host"] if n_threads > 1 else 0)


@pytest.mark.parametrize("n_threads", [1, 2])
def test_dp_regions_counts_the_regions_aligned(port_runs, n_threads):
    run = port_runs(n_threads)
    assert run["stats"]["dp_regions"] == run["regions"] > 0
