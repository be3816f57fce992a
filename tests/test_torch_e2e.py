"""The whole slice on the CPU: the port's map_file(device="cpu") — the
GPU engine on the kernels' plain PyTorch versions — is byte-identical
to miniprot_tpu.pipeline.map_file(use_tpu=False) on a testgen genome,
and state carried from the JAX package (index arrays, options, a dumped
.mpi file) maps to the same bytes."""
import ctypes as ct
import dataclasses
import io

import numpy as np
import pytest

from miniprot_tpu import index as jidx
from miniprot_tpu import native as jnative
from miniprot_tpu import options as jopt
from miniprot_tpu import pipeline as jpipe
from miniprot_tpu_torch import convert
from miniprot_tpu_torch import index as tidx
from miniprot_tpu_torch import options as topt
from miniprot_tpu_torch import pipeline as tpipe
from miniprot_tpu_torch.options import F_GFF, F_GTF, F_SHOW_RESIDUE


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    from miniprot_tpu_torch.testgen import make_workload
    d = tmp_path_factory.mktemp("e2e")
    fa, faa = str(d / "g.fa"), str(d / "q.faa")
    make_workload(fa, faa, genome_len=300_000, n_genes=10, seed=7, n_ctg=2,
                  max_intron=1500, rev_frac=0.5)
    # a splice-score track: random donor/acceptor sites on both strands
    rng = np.random.default_rng(3)
    spsc = str(d / "sites.tsv")
    with open(spsc, "w") as f:
        for ctg in ("ctg1", "ctg2"):
            for _ in range(400):
                f.write(f"{ctg}\t{int(rng.integers(1, 149_000))}\t"
                        f"{'+-'[rng.integers(0, 2)]}\t{'DA'[rng.integers(0, 2)]}"
                        f"\t{int(rng.integers(-12, 13))}\n")
    return fa, faa, spsc, d


def _opts(mod, flag, spsc_mi=None, spsc=None):
    """-G 4k (bw = max_intron = 4000) plus an output flag; with a splice
    track, the CLI's mp_set_spsc logic (index.c:239-248)."""
    o = mod.MapOpt()
    o.flag |= flag
    o.bw = o.max_intron = 4000
    if spsc is not None:
        o.io += 10
        o.io_end += 10
        max_sc = min((o.io + 1) // 2 - 1, o.io - o.go, o.sp_max_bonus)
        spsc_mi.nt.read_spsc(spsc, max_sc)
    return o


def _jax_map(mi, faa, o):
    buf = io.StringIO()
    jpipe.map_file(mi, faa, o, n_threads=1, out=buf, use_tpu=False)
    return buf.getvalue()


def _port_map(mi, faa, o, device):
    buf = io.StringIO()
    stats: dict = {}
    tpipe.map_file(mi, faa, o, n_threads=1, out=buf, device=device,
                   stats=stats)
    return buf.getvalue(), stats


@pytest.mark.parametrize("mode", ["paf", "gff_aln", "gtf", "spsc", "go0",
                                  "striped"])
def test_port_cpu_engine_byte_identical(workload, mode, monkeypatch):
    """go0 is -O 0 (every CIGAR job on the striped kernel: the scan
    kernel needs go >= 1), held against the JAX host engine on its
    8-lane extension path (the reference's: its AVX-512 wide path
    departs from it at go == 0, ROADMAP Queue C); striped is
    MINIPROT_TPU_CIG_IMPL=striped."""
    fa, faa, spsc, _ = workload
    flag = {"paf": 0, "gff_aln": F_GFF | F_SHOW_RESIDUE, "gtf": F_GTF,
            "spsc": F_GFF, "go0": F_GFF, "striped": 0}[mode]
    if mode == "striped":
        monkeypatch.setenv("MINIPROT_TPU_CIG_IMPL", "striped")
    jmi = jidx.Index.build(fa, jopt.IdxOpt())
    tmi = tidx.Index.build(fa, topt.IdxOpt())
    sp = spsc if mode == "spsc" else None
    from miniprot_tpu_torch.sysutil import profiler
    profiler.host_cells, profiler.cells_device = {}, 0
    jo, to = _opts(jopt, flag, jmi, sp), _opts(topt, flag, tmi, sp)
    if mode == "go0":
        jo.go = to.go = 0
        monkeypatch.setattr(ct.c_int32.in_dll(jnative._lib, "mx_no_wide_ext"),
                            "value", 1)
    want = _jax_map(jmi, faa, jo)
    got, stats = _port_map(tmi, faa, to, "cpu")
    assert got == want
    assert got.count("\n") >= 10
    # the ext class and both CIGAR classes went through the device engine
    cig = "_striped" if mode in ("go0", "striped") else ""
    assert stats["batches"]["ext"] > 0, stats
    assert stats["batches"]["cig" + cig] > 0, stats
    assert stats["batches"]["cig_small" + cig] > 0, stats
    assert stats["device_fraction"] >= 0.90, stats


def test_jax_index_arrays_and_options_carry_over(workload):
    fa, faa, _, _ = workload
    jmi = jidx.Index.build(fa, jopt.IdxOpt())
    jo = _opts(jopt, F_GFF)
    tmi = convert.index_from_arrays(convert.index_arrays(jmi),
                                    dataclasses.asdict(jmi.opt))
    to = convert.mapopt_from_fields(dataclasses.asdict(jo))
    assert np.array_equal(to.mat, jo.mat) and to.bw == 4000
    got, _ = _port_map(tmi, faa, to, None)
    assert got == _jax_map(jmi, faa, jo)


def test_jax_dumped_mpi_restores_in_port(workload):
    fa, faa, _, d = workload
    jmi = jidx.Index.build(fa, jopt.IdxOpt())
    path = str(d / "jax.mpi")
    jmi.dump(path)
    tmi = tidx.Index.restore(path)
    assert np.array_equal(np.asarray(tmi.kb), jmi.kb)
    got, _ = _port_map(tmi, faa, _opts(topt, 0), None)
    assert got == _jax_map(jmi, faa, _opts(jopt, 0))


def test_port_cli_host_engine_matches_jax_cli(workload, tmp_path):
    """python -m miniprot_tpu_torch.cli --no-gpu writes the JAX CLI's
    --no-tpu bytes."""
    from miniprot_tpu import cli as jcli
    from miniprot_tpu_torch import cli as tcli
    fa, faa, _, _ = workload
    outs = []
    for main, flag in ((jcli.main, "--no-tpu"), (tcli.main, "--no-gpu")):
        out = str(tmp_path / f"{flag}.gff")
        assert main([flag, "-G4k", "--gff", "-t1", "-o", out, fa, faa]) == 0
        outs.append(open(out).read())
    assert outs[0] == outs[1] and outs[0].startswith("##gff-version 3")
