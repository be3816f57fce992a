"""Entry points of the port: one launch of the flagship DP, and a real
mapping batch on a grid of ranks (the counterparts of the JAX package's
top-level entry points, ``entry`` and ``dryrun_multichip``).

entry() returns the batched splice/frameshift-aware extension DP, the
compute core of the aligner: K7 (the device prep of a raw batch) then
K1, through a RawExtBatch at the JAX entry's shape.

dryrun_multichip(n) starts n ranks (one process each, on torch.
distributed), forms the 2-D grid (index-sharded "g" axis x
query-data-parallel "q" axis), maps a small synthetic workload with
parallel.dist.mesh_map_queries (the seed->anchor gather on the ranks'
devices, chain/refine on the host, the alignment rounds' DPs on the
ranks' cards, or on the host engine on the CPU), and requires output
byte-identical to a per-query map_query run.

    python -m miniprot_tpu_torch.entry [--cpu]
"""

from __future__ import annotations

import numpy as np

# the JAX entry's shape: proteins of al 64, one ROW_CHUNK of genome
# rows, one 128-lane batch of problems; K1 takes them in its narrowest
# width, 128 (the engine's first al bucket)
AL, NL, N_PROBLEMS = 64, 264, 128
AL_PAD = 128


def _problems() -> list:
    """The entry batch's problems, from np.random.default_rng(0): each a
    protein of AL residues spelled in codons with 10% of them
    substituted, then random bases up to NL (testgen.text_homolog), and
    a random direction: [(nucleotide bytes, protein bytes, extends
    left)]."""
    from .testgen import text_homolog
    rng = np.random.default_rng(0)
    return [(*text_homolog(rng, AL, NL), bool(rng.integers(0, 2)))
            for _ in range(N_PROBLEMS)]


def _scoring():
    """MapOpt() scores the JAX entry's scalars (go 11, ge 1, fs 23,
    xdrop 100, end bonus 5; BLOSUM62 with stop 23) and its DpEnv."""
    from .align import DpEnv
    from .options import MapOpt
    opt = MapOpt()
    return opt, DpEnv(opt)


def entry(device="cuda"):
    """Return (fn, args): ``fn(*args)`` launches K7 + K1 on the entry
    batch (``args``: its inputs staged on ``device``) and returns the
    (N_PROBLEMS, 3) result tensor (score, genome end, query end) without
    waiting for the card.  ``device="cuda"`` raises without an sm_90
    card; "cpu" runs the kernels' plain versions."""
    from . import tables
    from .kernels import nasw_ext as ne
    opt, env = _scoring()
    T = tables.get_tables()
    batch = ne.RawExtBatch(
        AL_PAD, NL, opt.mat, (opt.go, opt.ge, opt.fs, opt.io, opt.xdrop,
                          opt.end_bonus, opt.ie_coef),
        sp=env.sp, device=device, capacity=N_PROBLEMS)
    for nsq, asq, left in _problems():
        nt4, aa = T.nt4[nsq], T.aa20[asq]
        if left:
            nt4, aa = nt4[::-1], aa[::-1]
        batch.add_raw(nt4, aa, io=opt.io, ext_left=left)

    def fn(*staged):
        return batch.launch(staged)

    return fn, batch.stage()


def entry_reference() -> list:
    """The host C engine's (score, genome end + 1, query end + 1) for
    every entry problem: what entry()'s result rows are held to (the
    result tensor holds the ends as 0-based positions)."""
    from .native import DPF_EXT_LEFT, DPF_EXT_RIGHT
    opt, env = _scoring()
    return [tuple(env.dp(nsq, asq, DPF_EXT_LEFT if left else DPF_EXT_RIGHT,
                         io=opt.io)[:3])
            for nsq, asq, left in _problems()]


# the dry run's workload (the JAX dryrun's)
DRYRUN_WORKLOAD = dict(genome_len=120_000, n_genes=6, seed=5, n_ctg=2,
                       max_intron=2500, rev_frac=0.5)
INIT_TIMEOUT_S = 60


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Execute one REAL sharded mapping batch on an n-rank grid.

    Builds a small synthetic genome + protein workload, indexes it,
    starts ``n_devices`` ranks (torch.multiprocessing.spawn), each on
    NCCL with card ``rank % device_count`` for device="cuda" (raises
    when there are fewer cards than ranks, or none of sm_90), or on
    gloo for device="cpu"; runs the mesh map (index hash-sharded on
    "g", queries on "q", the default MapOpt; the two lookup passes on
    the rank's device; the alignment rounds' DPs on an engine on the
    rank's card, or with device="cpu" on the host C engine, as the JAX
    dry run maps them) and requires, on rank 0, the
    emitted output byte-identical to the per-query map_query run, with
    at least 6 lines.  A rank's error raises here."""
    import os
    import tempfile

    import torch
    import torch.multiprocessing as tmp

    from .index import Index
    from .kernels import resolve_device
    from .options import IdxOpt
    from .testgen import make_workload

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}): "
                           f"{torch.cuda.device_count()} card(s), NCCL "
                           "needs one per rank")
    with tempfile.TemporaryDirectory() as td:
        fa, faa = os.path.join(td, "g.fa"), os.path.join(td, "q.faa")
        make_workload(fa, faa, **DRYRUN_WORKLOAD)
        mpi = os.path.join(td, "g.mpi")
        Index.build(fa, IdxOpt()).dump(mpi)
        init = "file://" + os.path.join(td, "store")
        tmp.spawn(_dryrun_rank, args=(n_devices, dev.type, mpi, faa, init),
                  nprocs=n_devices, join=True)


def _dryrun_rank(rank: int, n: int, dev_type: str, mpi: str, faa: str,
                 init: str) -> None:
    """One rank of dryrun_multichip."""
    import datetime
    import io

    import torch
    import torch.distributed as tdist

    from .bseq import read_fastx
    from .index import Index
    from .mapper import map_query
    from .options import IdxOpt, MapOpt
    from .parallel import dist
    from .pipeline import _emit_query

    if dev_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    tdist.init_process_group(
        "nccl" if dev_type == "cuda" else "gloo", init_method=init,
        world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    try:
        n_g = 2 if n % 2 == 0 else 1
        mesh = dist.make_mesh(n_g, n // n_g)
        mi = Index.load(mpi, IdxOpt())
        # DEFAULT options: max_occ=20000 (options.c:44); the two-pass
        # gather needs no candidate-cap override
        opt = MapOpt()
        recs = list(read_fastx(faa))
        seqs = [np.frombuffer(r.seq, np.uint8) for r in recs]
        mesh_regs = dist.mesh_map_queries(
            mesh, mi, seqs, opt, engine="mesh" if dev_type == "cuda" else None)
        if rank != 0:
            return

        def emit(all_regs):
            buf = io.StringIO()
            idc = [0]
            for rec, seq, regs in zip(recs, seqs, all_regs):
                _emit_query(mi, opt, rec.name, seq, regs, idc, buf)
            return buf.getvalue()

        got = emit(mesh_regs)
        want = emit([map_query(mi, s, opt) for s in seqs])
        if got != want:
            raise RuntimeError("mesh mapping diverged from the per-query "
                               "map_query run")
        if got.count("\n") < 6:
            raise RuntimeError("dryrun workload failed to map")
    finally:
        tdist.destroy_process_group()


if __name__ == "__main__":
    import sys

    import torch
    dev = "cpu" if "--cpu" in sys.argv[1:] else "cuda"
    fn, args = entry(dev)
    out = fn(*args)
    if dev == "cuda":
        torch.cuda.synchronize()
    print("entry OK:", tuple(out.shape))
    dryrun_multichip(1, dev)
    print("dryrun_multichip(1) OK")
