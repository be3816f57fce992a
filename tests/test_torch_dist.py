"""The port's mesh layer (miniprot_tpu_torch.parallel.dist) and entry
points (miniprot_tpu_torch.entry) on the CPU, mirroring tests/test_dist.py
and tests/test_multiprocess.py: four gloo ranks (a 2 x 2 grid, one
process each) run the count and gather steps, batched_dp_sharded, the
dry run and mesh_map_queries; each result is held against the JAX
package's function on the 2 x 2 virtual CPU mesh (the same seeded
inputs, exact) or against the single-process map."""
import io
import pickle
import sys

import numpy as np
import pytest
from test_torch_runner import _run_all

from miniprot_tpu_torch import entry
from miniprot_tpu_torch.parallel import dist

N_G, N_Q = 2, 2


def _step_inputs():
    """A seeded bucket table (512 buckets) and 8 queries x 16 seeds; seed
    0 of query 1 is the table's hottest bucket, query 2 keeps no seed."""
    rng = np.random.default_rng(7)
    n_bucket = 512
    counts = rng.integers(0, 6, n_bucket)
    counts[77] = 40
    ki = np.zeros(n_bucket, np.int64)
    np.cumsum(counts[:-1], out=ki[1:])
    kb = rng.integers(1, 10**6, int(counts.sum())).astype(np.uint32)
    hashes = rng.integers(0, n_bucket, (8, 16)).astype(np.int64)
    hashes[1, 0] = 77
    keep = (rng.random((8, 16)) < 0.8).astype(np.int8)
    keep[2] = 0
    ki_ext = np.concatenate([ki, [len(kb)]])
    occ = np.where(keep != 0, ki_ext[hashes + 1] - ki_ext[hashes], 0)
    a_cap = dist._pow2_at_least(int(occ.sum(axis=1).max()))
    return ki, kb, hashes, keep, a_cap


RANK = r"""
import datetime, io, pickle, sys
import numpy as np
import torch
import torch.distributed as tdist
sys.path.insert(0, "tests")
from test_torch_dist import N_G, N_Q, _step_inputs
from miniprot_tpu_torch import entry
from miniprot_tpu_torch.bseq import read_fastx
from miniprot_tpu_torch.index import Index
from miniprot_tpu_torch.options import IdxOpt, MapOpt
from miniprot_tpu_torch.parallel import dist
from miniprot_tpu_torch.pipeline import _emit_query

rank, init, wd = int(sys.argv[1]), sys.argv[2], sys.argv[3]
tdist.init_process_group("gloo", init_method=init, world_size=N_G * N_Q,
                         rank=rank, timeout=datetime.timedelta(seconds=60))
try:
    mesh = dist.make_mesh(N_G, N_Q)
    assert (mesh.g, mesh.q) == divmod(rank, N_Q)
    ki, kb, hashes, keep, a_cap = _step_inputs()
    ki_l, kb_l = dist.shard_index_tables(mesh, ki, kb)
    bq = len(hashes) // N_Q
    rows = slice(mesh.q * bq, (mesh.q + 1) * bq)
    h = torch.from_numpy(hashes[rows])
    kig = torch.from_numpy(ki_l[mesh.g])
    kbg = torch.from_numpy(kb_l[mesh.g].astype(np.int64))
    cnt = dist.sharded_seed_count_step(mesh)(h, kig)
    blocks, seed_of, tot = dist.sharded_anchor_gather_step(mesh, a_cap)(
        h, torch.from_numpy(keep[rows]), kig, kbg)

    fn, args = entry.entry("cpu")
    sharded = dist.batched_dp_sharded(mesh, fn)(*args)
    dist.dryrun(N_G * N_Q)

    mi = Index.load(wd + "/g.mpi", IdxOpt())
    opt = MapOpt()
    recs = list(read_fastx(wd + "/q.faa"))
    seqs = [np.frombuffer(r.seq, np.uint8) for r in recs]
    stats = {}
    # a tiny chunk budget makes pass 2 run more than one chunk
    regs = dist.mesh_map_queries(mesh, mi, seqs, opt, engine=None,
                                 chunk_elems=1 << 10, stats=stats)
    buf = io.StringIO()
    idc = [0]
    for rec, seq, r in zip(recs, seqs, regs):
        _emit_query(mi, opt, rec.name, seq, r, idc, buf)
    with open(f"{wd}/rank{rank}.pkl", "wb") as f:
        pickle.dump({"cnt": cnt.numpy(), "blocks": blocks.numpy(),
                     "seed_of": seed_of.numpy(), "tot": tot.numpy(),
                     "sharded": sharded.numpy(), "mesh_out": buf.getvalue(),
                     "stats": stats}, f)
finally:
    tdist.destroy_process_group()
print("RANK-OK", rank, flush=True)
"""


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """One 2 x 2 gloo world over test_dist.py:155's 400 kb workload:
    every rank's results, and the workload's paths."""
    from miniprot_tpu_torch.index import Index
    from miniprot_tpu_torch.options import IdxOpt
    from miniprot_tpu_torch.testgen import make_workload
    wd = tmp_path_factory.mktemp("grid")
    fa, faa = str(wd / "g.fa"), str(wd / "q.faa")
    make_workload(fa, faa, genome_len=400_000, n_genes=10, seed=17, n_ctg=2,
                  max_intron=4000, rev_frac=0.5)
    Index.build(fa, IdxOpt()).dump(str(wd / "g.mpi"))
    init = "file://" + str(wd / "store")
    outs = _run_all([[sys.executable, "-c", RANK, str(r), init, str(wd)]
                     for r in range(N_G * N_Q)])
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0 and f"RANK-OK {r}" in out, (out, err[-3000:])
    ranks = []
    for r in range(N_G * N_Q):
        with open(wd / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, fa, faa


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX package's count and gather steps on a 2 x 2 virtual CPU
    mesh over _step_inputs()."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from miniprot_tpu.parallel import dist as jdist
    ki, kb, hashes, keep, a_cap = _step_inputs()
    mesh = jdist.make_mesh(N_G, N_Q)
    ki_l, kb_l = jdist.shard_index_tables(mesh, ki, kb)
    with mesh:
        h = jax.device_put(hashes, NamedSharding(mesh, P("q", None)))
        kp = jax.device_put(keep, NamedSharding(mesh, P("q", None)))
        kil = jax.device_put(ki_l, NamedSharding(mesh, P("g", None)))
        kbl = jax.device_put(kb_l, NamedSharding(mesh, P("g", None)))
        cnt = np.asarray(jdist.sharded_seed_count_step(mesh)(h, kil, kbl))
        out = jdist.sharded_anchor_gather_step(mesh, a_cap)(h, kp, kil, kbl)
    return cnt, [np.asarray(o) for o in out]


@pytest.fixture(scope="module")
def entry_out():
    """entry("cpu")'s result: K7 + K1's plain versions on the entry
    batch, computed once for the tests that read it."""
    fn, args = entry.entry("cpu")
    return fn(*args).numpy()


@pytest.mark.parametrize("n_g", [1, 2, 4])
def test_shard_index_tables_match_jax(n_g):
    from miniprot_tpu.parallel import dist as jdist
    ki, kb, _, _, _ = _step_inputs()
    mesh = dist.Mesh(n_g, 1, 0, None, None, None)
    got = dist.shard_index_tables(mesh, ki, kb)
    want = jdist.shard_index_tables(jdist.make_mesh(n_g, 1), ki, kb)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _rows(rank):
    bq = 8 // N_Q
    q = rank % N_Q
    return slice(q * bq, (q + 1) * bq)


def test_count_step_matches_jax(grid, jax_steps):
    """Pass 1 on every rank: its q-slice of the occupancies merged over
    "g", equal to the JAX step's, and to the host lookup."""
    ranks, _, _ = grid
    cnt, _ = jax_steps
    ki, kb, hashes, _, _ = _step_inputs()
    ki_ext = np.concatenate([ki, [len(kb)]])
    assert np.array_equal(cnt, ki_ext[hashes + 1] - ki_ext[hashes])
    for r, res in enumerate(ranks):
        assert np.array_equal(res["cnt"], cnt[_rows(r)]), r


def test_gather_step_matches_jax(grid, jax_steps):
    """Pass 2 on every rank: blocks, seed_of and tot of its q-slice
    equal the JAX step's, slot for slot (the hot bucket gathered whole,
    the masked query empty)."""
    ranks, _, _ = grid
    _, (blocks, seed_of, tot) = jax_steps
    assert tot[2].sum() == 0 and (tot[1] > 0).any()
    for r, res in enumerate(ranks):
        rows = _rows(r)
        assert np.array_equal(res["blocks"], blocks[rows]), r
        assert np.array_equal(res["seed_of"], seed_of[rows]), r
        assert np.array_equal(res["tot"], tot[rows]), r


def test_batched_dp_sharded_matches_unsharded(grid, entry_out):
    """K7 + K1's plain versions (entry()'s batch) sharded over the 4
    ranks, 32 problems each, equal one unsharded call on every rank."""
    ranks, _, _ = grid
    for res in ranks:
        assert np.array_equal(res["sharded"], entry_out)


def test_mesh_map_matches_jax_and_map_file(grid):
    """mesh_map_queries on the 2 x 2 gloo grid (default max_occ, pass 2
    in several chunks) is byte-identical on every rank to the JAX
    package's mesh_map_queries on the 2 x 2 virtual mesh and to the
    port's map_file."""
    from miniprot_tpu import index as jidx
    from miniprot_tpu import options as jopt
    from miniprot_tpu import pipeline as jpipe
    from miniprot_tpu.bseq import read_fastx
    from miniprot_tpu.parallel import dist as jdist
    from miniprot_tpu_torch.index import Index
    from miniprot_tpu_torch.options import IdxOpt, MapOpt
    from miniprot_tpu_torch.pipeline import map_file
    ranks, fa, faa = grid
    assert ranks[0]["stats"]["chunks"] > 1
    jmi = jidx.Index.build(fa, jopt.IdxOpt())
    jo = jopt.MapOpt()
    recs = list(read_fastx(faa))
    seqs = [np.frombuffer(r.seq, np.uint8) for r in recs]
    jregs = jdist.mesh_map_queries(jdist.make_mesh(N_G, N_Q), jmi, seqs, jo,
                                   chunk_elems=1 << 10)
    buf = io.StringIO()
    idc = [0]
    for rec, seq, regs in zip(recs, seqs, jregs):
        jpipe._emit_query(jmi, jo, rec.name, seq, regs, idc, buf)
    want = buf.getvalue()
    assert want.count("\n") >= 10
    local = io.StringIO()
    map_file(Index.build(fa, IdxOpt()), faa, MapOpt(), 1, out=local,
             device=None)
    assert local.getvalue() == want
    for res in ranks:
        assert res["mesh_out"] == want


_DRYRUN = ("import sys; from miniprot_tpu_torch.entry import "
           "dryrun_multichip; dryrun_multichip(int(sys.argv[1]), 'cpu'); "
           "print('DRYRUN-OK')")


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_gloo(n):
    """dryrun_multichip(n, device="cpu"): n gloo ranks map the dry-run
    workload on the grid, byte-identical to map_query on rank 0."""
    ((rc, out, err),) = _run_all([[sys.executable, "-c", _DRYRUN, str(n)]])
    assert rc == 0 and "DRYRUN-OK" in out, err[-3000:]


def test_mesh_engine_path_and_engine_error(tmp_path, monkeypatch):
    """A one-rank gloo world in this process: mesh_map_queries with a
    GpuExtEngine on the kernels' plain versions (pre_align on the
    gathered anchors, the align round through pump_align_generators),
    given or built by default on the mesh's device, gives the host map's
    bytes; an engine whose launch raises makes it raise; a grid of
    another size than the world is refused."""
    import datetime

    import torch.distributed as tdist

    from miniprot_tpu_torch import device as tdev
    from miniprot_tpu_torch.bseq import read_fastx
    from miniprot_tpu_torch.index import Index
    from miniprot_tpu_torch.mapper import map_query
    from miniprot_tpu_torch.options import IdxOpt, MapOpt
    from miniprot_tpu_torch.pipeline import _emit_query
    from miniprot_tpu_torch.testgen import make_workload

    with pytest.raises(RuntimeError, match="process group"):
        dist.make_mesh(1, 1)
    fa, faa = str(tmp_path / "g.fa"), str(tmp_path / "q.faa")
    make_workload(fa, faa, genome_len=24_000, n_genes=1, seed=9, n_ctg=1,
                  max_intron=900, max_exons=3, rev_frac=0.0)
    mi = Index.build(fa, IdxOpt())
    opt = MapOpt()
    opt.max_ext = 1100   # keeps the plain kernels' rectangles small
    recs = list(read_fastx(faa))
    seqs = [np.frombuffer(r.seq, np.uint8) for r in recs]

    def emit(all_regs):
        buf = io.StringIO()
        idc = [0]
        for rec, seq, regs in zip(recs, seqs, all_regs):
            _emit_query(mi, opt, rec.name, seq, regs, idc, buf)
        return buf.getvalue()

    tdist.init_process_group(
        "gloo", init_method="file://" + str(tmp_path / "store"),
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        with pytest.raises(ValueError, match="world size"):
            dist.make_mesh(2, 1)
        mesh = dist.make_mesh(1, 1)
        engine = tdev.GpuExtEngine(opt, "cpu")
        stats = {}
        got = dist.mesh_map_queries(mesh, mi, seqs, opt, engine=engine,
                                    stats=stats)
        assert engine.n_device > 0
        # device ms come from CUDA events only: none on the CPU
        assert stats["count_step_ms"] is None is stats["gather_step_ms"]
        want = emit([map_query(mi, s, opt) for s in seqs])
        assert emit(got) == want and want.count("\n") >= 1

        built = []
        init = tdev.GpuExtEngine.__init__

        def spy(self, *a, **kw):
            init(self, *a, **kw)
            built.append(self)

        monkeypatch.setattr(tdev.GpuExtEngine, "__init__", spy)
        assert emit(dist.mesh_map_queries(mesh, mi, seqs, opt)) == want
        assert [e.device for e in built] == [mesh.device]
        assert built[0].n_device > 0

        def launch(self, batch):
            raise RuntimeError("mp_scan_cigar: CUDA error 700")

        monkeypatch.setattr(tdev.GpuExtEngine, "_launch", launch)
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            dist.mesh_map_queries(mesh, mi, seqs, opt,
                                  engine=tdev.GpuExtEngine(opt, "cpu"))
    finally:
        tdist.destroy_process_group()


def test_entry_matches_host_engine_and_needs_a_card(entry_out):
    """entry(device="cpu") (K7 + K1's plain versions at the JAX entry's
    shape, al 64 x 264 rows x 128 problems) gives, for every problem,
    the (score, ends) of the JAX package's host C engine on the same
    problem and direction, and so does the port's entry_reference (what
    the card's entry() is held to); entry() asks for the card and raises
    without one."""
    from miniprot_tpu import options as jopt
    from miniprot_tpu.align import DpEnv as JDpEnv
    from miniprot_tpu.native import DPF_EXT_LEFT, DPF_EXT_RIGHT
    from miniprot_tpu_torch import kernels
    jo = jopt.MapOpt()
    jenv = JDpEnv(jo)
    want = [tuple(jenv.dp(nsq, asq, DPF_EXT_LEFT if left else DPF_EXT_RIGHT,
                          io=jo.io)[:3])
            for nsq, asq, left in entry._problems()]
    assert entry_out.shape == (entry.N_PROBLEMS, 3)
    got = [(int(s), int(i) + 1, int(j) + 1) for s, i, j in entry_out]
    assert got == want
    assert entry.entry_reference() == want
    assert any(left for _, _, left in entry._problems())
    assert max(s for s, _, _ in got) > 100   # homologous problems
    if not kernels.on_gpu_backend():
        with pytest.raises(RuntimeError, match="compute capability"):
            entry.entry()
        with pytest.raises(RuntimeError, match="compute capability"):
            entry.dryrun_multichip(1)
