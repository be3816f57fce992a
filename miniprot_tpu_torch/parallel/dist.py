"""Distributed mapping over a (g, q) grid of torch.distributed ranks
(port of miniprot_tpu.parallel.dist).

The reference tool is shared-memory pthreads only (kthread.c); its two
constructs map to multi-process parallelism as:

  kt_for over queries        -> data-parallel query sharding ("q" axis)
  (no analog: index too big) -> genome index sharded by hash ranges
                                ("g" axis), the tensor-parallel analog

The JAX package runs one controller over a Mesh(g, q) of devices; the
port is SPMD: one process per rank, world size n_g * n_q, and rank r
sits at (g, q) = divmod(r, n_q).  A mapping step:

  1. queries are sharded along "q" and replicated along "g"; the k-mer
     bucket table (ki/kb) is sharded along "g" by hash range and
     replicated along "q".
  2. each (g, q) rank looks up its hash range for its queries: pass 1
     counts every (query, seed) bucket's occupancy (all_reduce over
     "g"), the host applies the reference's max_occ rule, and pass 2
     compacts every hit of the kept seeds (all_gather over "g"), so
     every query's full candidate set lands on its "q" ranks.
  3. chain/refine/align run on the host (and the alignment DPs on the
     rank's engine) for a round-robin share of the "q" slice per "g"
     peer, so no query is mapped twice.
  4. the per-query results are gathered over the world in input order.

Every rank must call the collectives here in the same order with equal
shapes: the sizes the JAX package takes from its single global view (K,
the padded query count, a_cap, the pass-2 chunk count) are agreed on
with an all_reduce(MAX) over the world first.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as tdist


class Mesh:
    """This rank's place on the (g, q) grid of the process group: the
    grid's ``shape``, the rank's ``g`` and ``q``, the group of the ranks
    that share its q (the "g" axis: ``g_group``) and of those that share
    its g (the "q" axis: ``q_group``), and the ``device`` its tensors
    live on (the rank's current card on NCCL, the CPU on gloo)."""

    def __init__(self, n_g: int, n_q: int, rank: int, g_group, q_group,
                 device: torch.device):
        self.shape = {"g": n_g, "q": n_q}
        self.rank = rank
        self.g, self.q = divmod(rank, n_q)
        self.g_group = g_group
        self.q_group = q_group
        self.device = device


def make_mesh(n_g: int, n_q: int) -> Mesh:
    """The (g, q) grid over the initialized process group, whose world
    size must be n_g * n_q.  Every rank creates every axis group, in the
    same order (torch.distributed.new_group is collective), and keeps
    its own two."""
    if not (tdist.is_available() and tdist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized torch.distributed "
                           "process group (one process per rank)")
    world = tdist.get_world_size()
    if world != n_g * n_q:
        raise ValueError(f"a {n_g}x{n_q} mesh needs world size {n_g * n_q}, "
                         f"the process group has {world}")
    rank = tdist.get_rank()
    g, q = divmod(rank, n_q)
    g_groups = [tdist.new_group([gg * n_q + qq for gg in range(n_g)])
                for qq in range(n_q)]
    q_groups = [tdist.new_group([gg * n_q + qq for qq in range(n_q)])
                for gg in range(n_g)]
    if tdist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return Mesh(n_g, n_q, rank, g_groups[q], q_groups[g], device)


def shard_index_tables(mesh: Mesh, ki: np.ndarray, kb: np.ndarray):
    """Split the bucket table by hash range along the "g" axis.

    Returns per-"g" (ki_local, kb_local) host arrays stacked on axis 0;
    kb slices are padded to a common length."""
    n_g = mesh.shape["g"]
    n_bucket = len(ki)
    per = n_bucket // n_g
    ki_ext = np.concatenate([ki, [len(kb)]]).astype(np.int64)
    slices = []
    max_len = 0
    for g in range(n_g):
        lo, hi = g * per, (g + 1) * per if g < n_g - 1 else n_bucket
        st, en = int(ki_ext[lo]), int(ki_ext[hi])
        slices.append((ki_ext[lo:hi + 1] - st, kb[st:en]))
        max_len = max(max_len, en - st)
    ki_l = np.stack([np.pad(s[0][:per], (0, 1), constant_values=len(s[1]))
                     for s in slices])
    kb_l = np.stack([np.pad(s[1], (0, max_len - len(s[1]))) for s in slices])
    return ki_l, kb_l


def _all_gather(t: torch.Tensor, n: int, group=None) -> list:
    parts = [torch.empty_like(t) for _ in range(n)]
    tdist.all_gather(parts, t.contiguous(), group=group)
    return parts


def _agree_max(mesh: Mesh, vals) -> list[int]:
    """Each value's maximum over the world (all_reduce MAX)."""
    t = torch.tensor([int(v) for v in vals], dtype=torch.int64,
                     device=mesh.device)
    tdist.all_reduce(t, op=tdist.ReduceOp.MAX)
    return [int(v) for v in t.tolist()]


def _local_lookup(mesh: Mesh, hashes, ki, keep=None):
    """This "g" rank's bucket start and occupancy of every (query, seed)
    hash it owns (0 for the rest, and for seeds ``keep`` drops)."""
    n_local = ki.shape[0] - 1
    local = hashes - mesh.g * n_local
    own = (local >= 0) & (local < n_local)
    if keep is not None:
        own &= keep != 0
    idx = local.clamp(0, n_local - 1)
    st = torch.where(own, ki[idx], 0)
    cnt = torch.where(own, ki[idx + 1] - ki[idx], 0)
    return st, cnt


def sharded_seed_count_step(mesh: Mesh):
    """Pass 1: ``step(hashes, ki)`` takes this rank's q-slice of query
    hashes (Bq, K) and its "g" row of the bucket offsets (per + 1,) and
    returns every (query, seed) bucket's occupancy (Bq, K), merged over
    the "g" axis (all_reduce SUM): the count the host's boxplot max_occ
    rule reads."""

    def step(hashes: torch.Tensor, ki: torch.Tensor) -> torch.Tensor:
        _, cnt = _local_lookup(mesh, hashes, ki)
        tdist.all_reduce(cnt, op=tdist.ReduceOp.SUM, group=mesh.g_group)
        return cnt

    return step


def sharded_anchor_gather_step(mesh: Mesh, a_cap: int):
    """Pass 2: ``step(hashes, keep, ki, kb)`` (this rank's q-slice of
    hashes (Bq, K) and its keep mask, its "g" rows of the bucket table)
    COMPACTS every hit of the kept (query, seed) pairs this rank owns
    into a_cap slots per query (slot -> seed by a cumsum and a
    searchsorted, the rank within the seed giving the kb position), then
    all_gathers over "g" so every query's full candidate set lands on
    its "q" ranks.  No per-seed cap: a_cap bounds a query's TOTAL hits
    on one rank, which pass 1 lets the host size exactly.

    Returns (blocks, seed_of, tot):
      blocks  (Bq, n_g, a_cap) int64 block ids, compacted per "g" rank
      seed_of (Bq, n_g, a_cap) int32 seed index of each slot (-1 = pad)
      tot     (Bq, n_g)        int32 slots used by that "g" rank"""
    n_g = mesh.shape["g"]

    def step(hashes, keep, ki, kb):
        K = hashes.shape[1]
        st, cnt = _local_lookup(mesh, hashes, ki, keep)
        csum = cnt.cumsum(dim=1)                    # (Bq, K) inclusive
        tot = csum[:, -1]
        j = torch.arange(a_cap, device=hashes.device)
        jj = j.expand(hashes.shape[0], a_cap).contiguous()
        # slot j belongs to the first seed whose inclusive cumsum
        # exceeds j; within-seed rank r = j - exclusive cumsum
        sc = torch.searchsorted(csum, jj, right=True).clamp(0, K - 1)
        prev = torch.where(sc > 0, csum.gather(1, (sc - 1).clamp(min=0)),
                           0)
        pos = st.gather(1, sc) + (jj - prev)
        validj = jj < tot[:, None]
        blocks = torch.where(validj, kb[pos.clamp(0, kb.shape[0] - 1)], 0)
        seed_of = torch.where(validj, sc, -1).to(torch.int32)
        blocks = torch.stack(_all_gather(blocks, n_g, mesh.g_group), dim=1)
        seed_of = torch.stack(_all_gather(seed_of, n_g, mesh.g_group), dim=1)
        tot = torch.stack(_all_gather(tot.to(torch.int32), n_g,
                                      mesh.g_group), dim=1)
        return blocks, seed_of, tot

    return step


def batched_dp_sharded(mesh: Mesh, dp_call):
    """Wrap a batched DP callable so its problem axis (axis 0 of every
    argument) is sharded over the whole grid (both axes data parallel):
    rank r runs ``dp_call`` on the r-th contiguous slice and the results
    are all_gathered back in rank order.  The problem count must divide
    by the world size, as the JAX shard_map requires."""
    world = mesh.shape["g"] * mesh.shape["q"]

    def step(*arrays):
        n = arrays[0].shape[0]
        if n % world or any(a.shape[0] != n for a in arrays):
            raise ValueError(f"batched_dp_sharded: {n} problems (on every "
                             f"argument) must divide by {world} ranks")
        per = n // world
        r0 = mesh.rank * per
        out = dp_call(*(a[r0:r0 + per] for a in arrays))
        return torch.cat(_all_gather(out, world))

    return step


def dryrun(n_devices: int) -> None:
    """One tiny sharded lookup step on every rank of an n-rank process
    group: the toy bucket table sharded on "g", queries on "q", the
    all_reduce merge over "g", checked against a host lookup."""
    n_g = 1
    for f in (2, 3, 5, 7):
        while n_devices % (n_g * f) == 0 and n_g * f <= max(1, n_devices // 2):
            n_g *= f
        break
    n_q = n_devices // n_g
    mesh = make_mesh(n_g, n_q)

    # toy index: 1024 buckets, ~4 entries each
    rng = np.random.default_rng(0)
    n_bucket = 1024
    counts = rng.integers(0, 8, n_bucket)
    ki = np.zeros(n_bucket, np.int64)
    np.cumsum(counts[:-1], out=ki[1:])
    kb = rng.integers(0, 10**6, int(counts.sum())).astype(np.uint32)
    ki_l, _ = shard_index_tables(mesh, ki, kb)

    hashes = rng.integers(0, n_bucket, (8 * n_q, 16)).astype(np.int64)
    mine = hashes[8 * mesh.q:8 * (mesh.q + 1)]
    step = sharded_seed_count_step(mesh)
    out = step(torch.from_numpy(mine).to(mesh.device),
               torch.from_numpy(ki_l[mesh.g]).to(mesh.device))
    # cross-check against a host lookup
    ki_ext = np.concatenate([ki, [len(kb)]])
    np.testing.assert_array_equal(out.cpu().numpy(),
                                  ki_ext[mine + 1] - ki_ext[mine])


# ---------------------------------------------------------------------------
# Integrated mesh mapping: the sharded seed->anchor gather feeding the
# exact host chain/refine/align rounds.
# ---------------------------------------------------------------------------


def _boxplot_max_occ(occ: np.ndarray, cap: int) -> int:
    """mp_cal_max_occ (map.c:126-141) from an occupancy vector."""
    from .. import native
    n = len(occ)
    if n < 8:
        return cap
    cnt = occ.astype(np.uint64).copy()
    native.sort_u64(cnt)
    q25 = int(cnt[int(n * 0.25 + 0.499)])
    q75 = int(cnt[int(n * 0.75 + 0.499)])
    return min(int(q75 + (q75 - q25) * 1.5 + 10.0), cap)


def _pow2_at_least(n: int, lo: int = 64) -> int:
    v = lo
    while v < n:
        v <<= 1
    return v


def _mark(dev: torch.device):
    """A CUDA event recorded on ``dev``'s current stream (None off the
    card): the start of a step's device time."""
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _elapsed_ms(start) -> float | None:
    """Device ms from ``start`` (a _mark) to now on the same stream; the
    collectives' streams are joined to it, so their time is inside."""
    if start is None:
        return None
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def mesh_map_queries(mesh: Mesh, mi, seqs, opt, *, engine="mesh",
                     chunk_elems: int = 1 << 25, stats: dict | None = None
                     ) -> list:
    """Map a batch of proteins with the seed->anchor stage sharded on the
    grid (index by hash range on "g", queries on "q", candidates
    assembled by all_gather over "g") and the exact chain/refine rounds
    on the host.  Byte-identical to per-query map_query at ANY max_occ:
    pass 1 merges exact per-seed occupancies, the host applies the
    reference's boxplot max_occ rule, and pass 2 gathers every hit of
    every kept seed with no per-seed cap.

    Every rank calls it with the same ``seqs`` (a list of np.uint8
    protein arrays) and gets the per-query region lists of all of them,
    in input order.

    engine: "mesh" (the default) builds a device.GpuExtEngine on the
    rank's device, ``mesh.device`` (its card on NCCL, the kernels' plain
    versions on gloo); the alignment round's DPs then batch onto its
    kernels (pump_align_generators).  A GpuExtEngine given here is used
    as it is; None runs the host DP engine (map_query).  An engine error
    raises.

    chunk_elems bounds the pass-2 buffer (queries per chunk x n_g x
    a_cap over the grid) so one pathological batch cannot exhaust a
    device's memory.

    stats: when given, receives K, a_cap, the pass-2 chunk count and
    its query rows per chunk on this rank, the hits pass 2 gathered
    here, each step's device ms on the card (CUDA events around the
    step's own ops and collectives, summed over pass 2's chunks; None
    off the card), and each step's seconds on the host clock (from its
    inputs' upload to its results' arrival in host memory)."""
    import time

    from .. import native
    from ..align import DpEnv
    from ..mapper import map_query
    from ..sketch import sketch_prot

    n_g = mesh.shape["g"]
    n_q = mesh.shape["q"]
    dev = mesh.device
    io = mi.opt
    env = DpEnv(opt)

    # this rank's q-slice of the padded query rows; every rank of the
    # world must agree on the padded count and on K
    NQ = max(len(seqs), 1)
    NQ_pad = -(-NQ // n_q) * n_q
    Bq = NQ_pad // n_q
    q0 = mesh.q * Bq
    mine = range(q0, min(q0 + Bq, len(seqs)))
    sds = {}
    for qi in mine:
        sd = sketch_prot(seqs[qi], io.kmer, io.mod_bit)
        native.sort_u64(sd)
        sds[qi] = sd
    K_local = _pow2_at_least(max((len(s) for s in sds.values()), default=1)
                             or 1, 16)
    K, NQ_pad_all = _agree_max(mesh, (K_local, NQ_pad))
    if NQ_pad_all != NQ_pad:
        raise ValueError("mesh_map_queries: every rank must be given the "
                         f"same queries ({NQ_pad} padded rows here, "
                         f"{NQ_pad_all} on another rank)")
    hashes = np.zeros((Bq, K), np.int64)
    nseed = np.zeros(Bq, np.int64)
    for qi, sd in sds.items():
        hashes[qi - q0, :len(sd)] = (sd >> np.uint64(32)).astype(np.int64)
        nseed[qi - q0] = len(sd)

    ki = np.asarray(mi.ki, np.int64)   # per-bucket start offsets
    kb = np.asarray(mi.kb, np.uint32)
    ki_l, kb_l = shard_index_tables(mesh, ki, kb)
    per = len(ki) // n_g
    ki_g = torch.from_numpy(ki_l[mesh.g]).to(dev)
    kb_g = torch.from_numpy(kb_l[mesh.g].astype(np.int64)).to(dev)

    # ---- pass 1: exact per-(query, seed) occupancies (summed over "g")
    t0 = time.perf_counter()
    count_step = sharded_seed_count_step(mesh)
    hashes_d = torch.from_numpy(hashes).to(dev)
    ev = _mark(dev)
    cnt = count_step(hashes_d, ki_g)
    ms_count = _elapsed_ms(ev)
    cnt = cnt.cpu().numpy()
    t_count = time.perf_counter() - t0

    # host: boxplot max_occ per query -> keep mask; exact per-(query,
    # shard) totals size the pass-2 buffer
    keep = np.zeros((Bq, K), np.int8)
    for r in range(Bq):
        ns = int(nseed[r])
        if ns == 0:
            continue
        occ = cnt[r, :ns]
        max_occ = _boxplot_max_occ(occ, opt.max_occ) if ns >= 8 \
            else opt.max_occ
        keep[r, :ns] = occ <= max_occ
    g_of = np.minimum(hashes // max(per, 1), n_g - 1)
    kept_cnt = np.where(keep != 0, cnt, 0)
    tot_max = max((int(np.where(g_of == g, kept_cnt, 0).sum(axis=1).max())
                   for g in range(n_g)), default=0)
    (tot_max,) = _agree_max(mesh, (tot_max,))
    a_cap = _pow2_at_least(tot_max or 1)

    # ---- pass 2: compacted variable gather, in chunks of the q-slice;
    # every rank runs the same number of chunks
    nq_budget = max(chunk_elems // max(n_g * a_cap, 1), 1)
    nq_chunk = max(min(nq_budget, NQ_pad) // n_q * n_q, n_q)
    rows = nq_chunk // n_q
    n_chunks = -(-Bq // rows)
    gather_step = sharded_anchor_gather_step(mesh, a_cap)
    anchors: dict[int, np.ndarray] = {}
    t_gather = 0.0
    ms_gather = None if dev.type != "cuda" else 0.0
    hits = 0
    for c in range(n_chunks):
        r0 = c * rows
        hc, kc = hashes[r0:r0 + rows], keep[r0:r0 + rows]
        if len(hc) < rows:   # ragged tail still fills the step
            pad = rows - len(hc)
            hc = np.pad(hc, ((0, pad), (0, 0)))
            kc = np.pad(kc, ((0, pad), (0, 0)))
        t0 = time.perf_counter()
        hc_d, kc_d = torch.from_numpy(hc).to(dev), torch.from_numpy(kc).to(dev)
        ev = _mark(dev)
        blocks, seed_of, tot = gather_step(hc_d, kc_d, ki_g, kb_g)
        if ev is not None:
            ms_gather += _elapsed_ms(ev)
        blocks = blocks.cpu().numpy()
        seed_of = seed_of.cpu().numpy()
        tot = tot.cpu().numpy()
        t_gather += time.perf_counter() - t0
        hits += int(tot.sum())
        for rc in range(rows):
            qi = q0 + r0 + rc
            if qi not in sds:
                continue
            if (tot[rc] > a_cap).any():
                raise RuntimeError("mesh_map_queries: pass-2 cap undersized")
            qpos = (sds[qi] & np.uint64(0xFFFFFFFF)).astype(np.uint64)
            parts = []
            for g in range(n_g):
                t = int(tot[rc, g])
                if t == 0:
                    continue
                bl = blocks[rc, g, :t].astype(np.uint64)
                sl = seed_of[rc, g, :t]
                parts.append((bl << np.uint64(32)) | qpos[sl])
            anchors[qi] = (np.concatenate(parts) if parts
                           else np.empty(0, np.uint64))
    if stats is not None:
        stats.update(K=K, a_cap=a_cap, chunks=n_chunks, rows=rows,
                     hits=hits, count_step_ms=ms_count,
                     gather_step_ms=ms_gather, count_step_s=t_count,
                     gather_step_s=t_gather)

    # the q-slice's host work, round-robin over its n_g peers
    todo = [qi for k, qi in enumerate(mine) if k % n_g == mesh.g]
    if engine is None:
        done = [(qi, map_query(mi, seqs[qi], opt, env=env,
                               anchors=anchors[qi])) for qi in todo]
    else:
        # seed/chain/refine on the host from the gathered anchors, then
        # the alignment round batched onto the engine's kernels
        from ..align import align_region_steps
        from ..device import GpuExtEngine, pump_align_generators
        from ..mapper import finish_align, pre_align

        if engine == "mesh":
            engine = GpuExtEngine(opt, device=dev)

        per_query = []
        gens = []
        for qi in todo:
            seq = seqs[qi]
            regs, ext = pre_align(mi, seq, opt, anchors=anchors[qi])
            per_query.append((qi, regs))
            for r, (el, er) in zip(regs, ext):
                gens.append(align_region_steps(env, opt, mi, len(seq), seq,
                                               r, el, er))
        pump_align_generators(gens, engine)
        done = [(qi, finish_align(mi, opt, regs)) for qi, regs in per_query]

    gathered: list = [None] * tdist.get_world_size()
    tdist.all_gather_object(gathered, done)
    out: list = [None] * len(seqs)
    for part in gathered:
        for qi, regs in part:
            out[qi] = regs
    return out
