"""Kernel benchmark measurements on the card (port of
miniprot_tpu.benchmarks), and the H100 rates and per-cell operation
counts that bound times and peak shares are computed from.

On the card (the default) a rate comes from K launches of one batch
queued back to back on one stream between two CUDA events: the batch's
inputs are staged on the card once (its ``stage()``), each ``launch()``
runs what the engine runs for that batch (K7's prep of the raw windows,
then the DP kernel and, for a CIGAR batch, its walk), and no host sync
falls inside the window.  So the rate is the card's, not the upload's.
``device="cpu"`` runs the kernels' plain PyTorch versions at small
sizes, for the tests; its rates are the CPU's and say nothing of the
card.

Not ported from the JAX module: ``cigar_gcups_device_small_unstacked``,
the al <= 32 class without SUB=4's four-problem lane interleave.  That
interleave is a TPU lane layout the port does not carry (an al <= 32
problem is one warp here), so there is no stacked and unstacked form to
compare.  Nor are the TPU's per-cell VPU op counts and lane-op peak:
the peak shares here use the H100 rates below.
"""

from __future__ import annotations

import time

import numpy as np

# H100 SXM peaks used for bound times and peak shares: HBM3 bandwidth
# (NVIDIA data sheet); the int32 rate of the CUDA cores, 132 SMs x 64
# int32 lanes x 1.98 GHz boost (Hopper architecture white paper); and
# the int16 rate: two int16 lanes per int32 lane (int16x2), with a DPX
# fused add+max counted as two operations per lane, so 4x the int32
# rate.
MEM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
INT16_OPS_PER_S = 4 * INT32_OPS_PER_S
# operations per DP cell that the recurrence needs, counted from the host
# engine's saturating-int16 inner loops (native/mpnative.c) without any
# scan overhead: K1 (dp16_ext_w) 1 match add, I 4, D 4, A 5, B 5, C 4,
# four frameshift moves 8, row max 1 = 32; K2 (the NS_F_CIGAR loop) the
# same 31 without the row max, 5 extend bits x 2 (compare, or), 9
# state selects x 2 (compare, select), 1 or, and the lazy-F pass over
# the row (compare-or, max, decay) 4 = 64.  Both fit int16 (K1 under
# ext_fits_int16), so both are held to the int16 rate.
K1_OPS_PER_CELL = 32
K2_OPS_PER_CELL = 64
# K4 (the striped form of the same NS_F_CIGAR loop) is held to K2's 64,
# at the int16 rate for B4 and the int32 rate for B4'.  K6 per window
# (codon slot): 3 base tests, codon index 4, table lookups 2, sense 1,
# run bookkeeping 4 = 14; and for a window whose run passes the length
# tests (ending >= k, total >= -L), k-mer roll 3, hash 13, keep test 2
# = 18 more.  No other window needs its hash: the index keeps nothing
# of it.  (Counting the 18 for every window, 32 in all, is the most the
# inputs could need.)
SKETCH_OPS_PER_WINDOW = 14
SKETCH_OPS_PER_RUN_WINDOW = 18
# the device prep of a raw batch (K7; plain: _prep_seq_device +
# _logpen_device) per genome row of a problem, counted from the
# recurrences of the problem's own direction (the plain version computes
# both and selects): the codon 13 int32 operations (4 range tests, 3
# ands, 2 shifts, 2 ors, the table read, a select), the donor track 23
# (7 base tests, 7 ands/ors, 5 site-type selects, score read and select,
# the row-range test and select), the acceptor track 25 (the same and
# the poly-Y sum), the folds 4: 64 in all; an ext batch's log penalty
# adds 4 (x = row - 3 al and the threshold count advanced along the
# rows).  An earlier count, 160, took both directions, and K7 ran below
# the bound it gave on an H100.  A row reads its nt4 code (1
# byte) and writes nas (1), D and A (4 + 4) and an ext batch's
# log-penalty row (4)
PREP_OPS_PER_ROW = 64
PREP_LOGPEN_OPS_PER_ROW = 4

# launches per timed window on the card, and windows per ext reading
CARD_ITERS = 20
CIGAR_CARD_ITERS = 12
EXT_REPS = 3
# JAX's 10240-row extension problem lands in this nl bucket of the port
EXT_BENCH_NL = 10240


def _scoring(xdrop=None):
    """(MapOpt, its DpEnv, the batches' option scalars) at the defaults;
    ``xdrop`` replaces the x-drop."""
    from .align import DpEnv
    from .options import MapOpt
    opt = MapOpt()
    if xdrop is not None:
        opt.xdrop = xdrop
    return opt, DpEnv(opt), (opt.go, opt.ge, opt.fs, opt.io, opt.xdrop,
                             opt.end_bonus, opt.ie_coef)


def ext_batch(al: int, nl: int, n: int, device, seed: int = 1):
    """The extension benchmark's batch: n right extensions of random
    nt4 windows of nl rows against random queries of al residues (codes
    from np.random.default_rng(seed)), x-drop off (1 << 28) so that
    every row is computed.  Returns (batch, [(nt4, aa20), ...])."""
    from .kernels import nasw_ext as nk
    opt, env, scal = _scoring(xdrop=1 << 28)
    rng = np.random.default_rng(seed)
    batch = nk.RawExtBatch(al, nl, opt.mat, scal, sp=env.sp, device=device,
                           capacity=n)
    probs = []
    for _ in range(n):
        nt = rng.integers(0, 4, nl).astype(np.uint8)
        aa = rng.integers(0, 20, al).astype(np.uint8)
        batch.add_raw(nt, aa, io=opt.io)
        probs.append((nt, aa))
    return batch, probs


def _genic_nt(rng, NL, AL):
    """A gap-patch-shaped problem: coding flanks matching the query
    around one long GT..AG intron — the content class the alignment
    stage's big CIGAR rectangles actually carry (align.c:62-80)."""
    from . import tables
    T = tables.get_tables(1)
    n_aa = AL
    half = (n_aa // 2) * 3
    pre = rng.integers(0, 4, half).astype(np.uint8)
    suf = rng.integers(0, 4, n_aa * 3 - half).astype(np.uint8)
    ilen = NL - len(pre) - len(suf)
    intron = rng.integers(0, 4, ilen).astype(np.uint8)
    intron[0], intron[1] = 2, 3          # GT
    intron[-2], intron[-1] = 0, 2        # AG
    nt = np.concatenate([pre, intron, suf])
    cod = pre.reshape(-1, 3)
    aa1 = T.codon[(cod[:, 0] << 4) | (cod[:, 1] << 2) | cod[:, 2]]
    cod = suf.reshape(-1, 3)
    aa2 = T.codon[(cod[:, 0] << 4) | (cod[:, 1] << 2) | cod[:, 2]]
    aa = np.concatenate([aa1, aa2]).astype(np.uint8)
    aa[aa > 19] = 0                      # stops/X -> A (keep it coding)
    return nt, aa


def cigar_batch(cls, W: int, NL: int, n: int, device, rng, genic=False):
    """A CIGAR benchmark batch of class ``cls`` (a raw scan or striped
    batch) at class width W: n problems of NL random nt4 rows against W
    random residues, or with ``genic`` _genic_nt's intron-containing
    problems.  Returns (batch, [(nt4, aa20), ...])."""
    opt, env, scal = _scoring()
    batch = cls(W, NL, opt.mat, scal, sp=env.sp, device=device, capacity=n)
    probs = []
    for _ in range(n):
        if genic:
            nt, aa = _genic_nt(rng, NL, W)
        else:
            nt = rng.integers(0, 4, NL).astype(np.uint8)
            aa = rng.integers(0, 20, W).astype(np.uint8)
        batch.add_raw(nt, aa, io=opt.io)
        probs.append((nt, aa))
    return batch, probs


def _rates(batch, cells: int, iters: int, reps: int) -> list[float]:
    """GCUPS of ``iters`` launches of ``batch`` on inputs staged once,
    ``reps`` times: on the card between two CUDA events on the launch
    stream (after a warm-up launch and a sync), on the CPU by the host
    clock (the plain versions run synchronously)."""
    import torch
    staged = batch.stage()
    batch.launch(staged)                 # warm-up (builds the library)
    on_card = batch.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(batch.device)
    rates = []
    for _ in range(reps):
        if on_card:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(iters):
                batch.launch(staged)
            t1.record()
            t1.synchronize()
            dt = t0.elapsed_time(t1) / 1e3
        else:
            c0 = time.perf_counter()
            for _ in range(iters):
                batch.launch(staged)
            dt = time.perf_counter() - c0
        rates.append(cells * iters / dt / 1e9)
    return rates


def measure_ext_gcups(detail: dict | None = None, device="cuda") -> float:
    """GCUPS of the extension DP (K7 then K1, a RawExtBatch's launch())
    at al 512 and the port's nl bucket for a 10240-row window, at the
    engine's capacity for that bucket, x-drop off: CARD_ITERS launches
    per window, EXT_REPS windows, the median returned; ``detail`` gets
    every reading (``ext_gcups_reps``, sorted) and their spread
    (``ext_gcups_spread``), unrounded.  Cells: padded al x padded nl x
    problems x launches.  On the CPU: al 64 x nl 264, one window of 2
    launches."""
    from .device import NL_BUCKETS, ext_capacity
    from .kernels import nasw_ext as nk
    from .kernels import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        al, iters, reps = 512, CARD_ITERS, EXT_REPS
        nl = next(b for b in NL_BUCKETS if b >= EXT_BENCH_NL)
        n = ext_capacity(nl)
    else:
        al, nl, n, iters, reps = 64, 264, nk.B_LANES, 2, 1
    batch, _ = ext_batch(al, nl, n, dev)
    rates = sorted(_rates(batch, al * nl * n, iters, reps))
    if detail is not None:
        detail["ext_gcups_reps"] = rates
        detail["ext_gcups_spread"] = rates[-1] - rates[0]
    return rates[len(rates) // 2]


def measure_cigar_gcups(device="cuda") -> dict:
    """GCUPS of the CIGAR path, K7 + the DP kernel + its walk (what the
    engine launches for one raw CIGAR batch), at the engine's capacity
    for each shape (device.cig_capacity), CIGAR_CARD_ITERS launches:

    - cigar_gcups_device_small: SmallScanCigarBatch (K2 al <= 32 + K3),
      32 x 2048;
    - cigar_gcups_device: RawScanCigarBatch (K2 W=128 + K3), 128 x 8192;
    - cigar_gcups_device_genic: the same shape with _genic_nt problems;
    - cigar_gcups_striped_small / cigar_gcups_striped: SmallCigarBatch /
      RawCigarBatch (K4's int16 form + K5) at the same two shapes;
    - cigar_peak_share: cigar_gcups_device x K2_OPS_PER_CELL over
      INT16_OPS_PER_S;

    and the host engine's rates (measure_cigar_host_gcups).  Random
    content is the conservative number (it fragments the walk's runs).
    On the CPU: RawScanCigarBatch at 16 x 256, one launch, under both
    cigar_gcups_device keys."""
    from .device import CIG_TB_FRACTION, _memory_bytes, cig_capacity
    from .kernels import nasw_cigar_scan as csk
    from .kernels import nasw_cigar_striped as cst
    from .kernels import resolve_device
    dev = resolve_device(device)
    rng = np.random.default_rng(5)

    def rate(cls, W, NL, iters, n, genic=False):
        batch, _ = cigar_batch(cls, W, NL, n, dev, rng, genic)
        return _rates(batch, NL * W * n, iters, 1)[0]

    out = {}
    if dev.type == "cuda":
        tb_cap = int(_memory_bytes(dev) * CIG_TB_FRACTION)
        for key, cls, W, NL, genic in (
                ("cigar_gcups_device_small", csk.SmallScanCigarBatch, 32,
                 2048, False),
                ("cigar_gcups_device", csk.RawScanCigarBatch, 128, 8192,
                 False),
                ("cigar_gcups_device_genic", csk.RawScanCigarBatch, 128,
                 8192, True),
                ("cigar_gcups_striped_small", cst.SmallCigarBatch, 32, 2048,
                 False),
                ("cigar_gcups_striped", cst.RawCigarBatch, 128, 8192,
                 False)):
            out[key] = rate(cls, W, NL, CIGAR_CARD_ITERS,
                            cig_capacity(cls, NL, W, tb_cap), genic)
        out["cigar_peak_share"] = (out["cigar_gcups_device"] * 1e9
                                   * K2_OPS_PER_CELL / INT16_OPS_PER_S)
    else:
        r = rate(csk.RawScanCigarBatch, 16, 256, 1,
                 csk.RawScanCigarBatch.CAPACITY)
        out["cigar_gcups_device_small"] = out["cigar_gcups_device"] = r
    out.update(measure_cigar_host_gcups())
    return out


def measure_cigar_host_gcups() -> dict:
    """One-core host-engine rate at the SAME two CIGAR shape classes,
    the other half of the per-class device-vs-host routing data
    (device.CIG_MIN_NL).  Uses the production host path
    (DpEnv.dp -> native striped C kernel, traceback mode)."""
    from .align import DpEnv
    from .native import DPF_CIGAR
    from .options import MapOpt

    env = DpEnv(MapOpt())
    rng = np.random.default_rng(9)
    nt = np.frombuffer(b"ACGT", np.uint8)
    aa = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
    out = {}
    for key, al, nl, n in (("cigar_gcups_host_small", 32, 2048, 24),
                           ("cigar_gcups_host", 128, 8192, 12)):
        probs = [(nt[rng.integers(0, 4, nl)], aa[rng.integers(0, 20, al)])
                 for _ in range(n)]
        env.dp(*probs[0], DPF_CIGAR)   # warm (tables, scratch slots)
        t0 = time.perf_counter()
        for nsq, asq in probs:
            env.dp(nsq, asq, DPF_CIGAR)
        dt = time.perf_counter() - t0
        out[key] = nl * al * n / dt / 1e9
    return out


def run_bench_op(kind: str, device="cuda") -> dict:
    """One benchmark record: ``"ext"`` (measure_ext_gcups' readings,
    ``value`` and, on the card, ``ext_peak_share``: value x
    K1_OPS_PER_CELL over INT16_OPS_PER_S) or ``"cigar"``
    (measure_cigar_gcups), each with ``device``, the name of the device
    it ran on."""
    if kind not in ("ext", "cigar"):
        raise ValueError(f"unknown bench kind {kind!r}")
    import torch

    from .kernels import resolve_device
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if kind == "cigar":
        return dict(measure_cigar_gcups(dev), device=name)
    detail: dict = {}
    v = measure_ext_gcups(detail, dev)
    detail["value"] = v
    if dev.type == "cuda":
        detail["ext_peak_share"] = v * 1e9 * K1_OPS_PER_CELL / INT16_OPS_PER_S
    detail["device"] = name
    return detail
