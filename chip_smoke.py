#!/usr/bin/env python3
"""Smoke run of the PyTorch port (miniprot_tpu_torch) on one NVIDIA
Hopper card: builds the CUDA kernels from this checkout, holds each one
against its plain PyTorch version and the host C engine at main-path
shapes, times it, then maps a whole-genome-scale synthetic workload on
the card and on the host engine and requires byte-identical output.

    python3 chip_smoke.py [--genome-mb 200] [--proteins 2000] [--threads N]
    python3 chip_smoke.py --maps-only [--pre-chunk N[,N...]] [--package DIR]
    python3 chip_smoke.py --index-only [--package DIR]

The second form runs only the e2e workload's three GPU maps (at each
--pre-chunk), each with its stage split (pre_align, pre_align_wait,
align_rounds, launch(), decode), the wait on the card, flush rounds
and launches; the third only its
--gpu-sketch index build, twice, with the build's stage split (fetch,
sketch, bb_add, bb_finish) and K6's time on the first strand.
--package DIR runs the miniprot_tpu_torch of another checkout (a parent
commit's unpacked tree), so two trees compare in one call.

Phases (any failure exits non-zero and prints no result):
  1. the card: nvidia-smi name and power limit; CUDA and sm_90 required
  2. build: nvcc for sm_90a, the -Xptxas -v register and spill lines,
     and per K1-K5 and K7 instantiation its registers, spill bytes and
     count of DPX instructions, named-barrier waits and local
     loads/stores in the SASS (cuobjdump; a spill in K4's B4 or B4'
     forms or in K5 fails the run); the SASS that Hopper's packed int16
     intrinsics compile to
  3. kernels: K7 track_prep (the device prep of a raw batch) at K1's
     four batches and at the engine's W=128 / nl 4096 / 512 and W=32 /
     nl 2048 / 512 scan batches, exact against its plain version (torch
     ops) on every element; one launch() of every raw batch family under
     torch.cuda.set_sync_debug_mode("error") (no stream
     synchronization); K1 ext_dp (al 128/512/1024, and at go 0), K2
     scan_cigar_dp (al<=512 and al<=32 classes, and W=128 at the
     engine's 512-problem batch), K2 also timed in every geometry
     (warps per problem) it has; K1's device time per problem in a
     67.6 kb bucket at 128 problems against 512 / 1024; K3 run_walk, K4
     striped_cigar_dp (W 128/512/32 at K2's shapes, each width at go 0
     and at go 11 but W=128 at go 0 only, and W=128 at go 11 at the
     engine's 512-problem batch, with K2's time at the same shape
     beside it) and its int32 form
     striped_cigar_dp32 (B4', the library's gs32b DP: W=512 / nl 2048
     at go 11 and at go 0, each with scores past 32767, W=128 / nl 1024
     and W=1024 / nl 4096, each with nl >= 3 al), K5 cell_walk, K6
     sketch_orf (the index's packed entries, in order, at strand lengths
     around a tile and at -L past its halo; one launch under
     torch.cuda.set_sync_debug_mode("error")) — exact equality with the
     plain versions on the card and with the host engine (native.dp16 /
     dp32 / sketch_nt4); time, cells, GCUPS, bound; one flush_begin of
     a round of ext and scan jobs (launches, collect wave, host DPs)
     under torch.cuda.set_sync_debug_mode("error"), its results equal
     to the host engine's; the bench records of
     miniprot_tpu_torch.benchmarks (run_bench_op "ext" and "cigar": the
     rates of K7 + K1 and of each CIGAR class's K7 + DP + walk, their
     readings, spread and peak shares)
  4. end to end: testgen's 200 Mb x 2000-protein workload mapped with
     the GPU engine and the host engine, byte-identical, device cell
     fraction >= 0.90, every kernel of the path launched; the GPU map
     again at PRE_CHUNK 0 (pre_align for the whole batch before the
     first round: no overlap); then the GPU
     map on the striped route (MINIPROT_TPU_CIG_IMPL=striped) against
     the same host output, the -O 0 map on both engines, the map with
     route_probe=True (its cache in a temporary directory; the choice
     and both probe times; a second map that reads a decisive outcome
     from the cache), MapServer on the card answering two disjoint
     subsets of the proteins and an empty request (each reply equal to
     map_file of its subset), cli.main --profile-trace on the first
     subset on the default and the striped route (output equal to the
     host engine's, a device event in the trace for every kernel that
     was launched, K3's, K5's and K7's device-only ms per launch), and
     the index built with the device sketch against the host index
     (with its stage split); [shards]: the CLI with --shards 2
     --shard-id {0,1} --spool-dir as two concurrent processes on the
     card over the dumped index and every protein, PAF then GFF, shard
     0's output equal to map_file's, each shard's wall, proteins/s, DP
     split, peak planes in flight and seconds before its first launch
     (interpreter and imports, CUDA context, library load, index load,
     engine construction); [daemon]: python -m miniprot_tpu_torch.daemon
     --warm on the card (seconds to ready, warm seconds and shapes), one
     CLI client through MINIPROT_TPU_DAEMON_SOCK over every protein
     (PAF byte-identical to the host engine's, proteins/s beside the
     direct map, seconds to its first launch by part), then --shards 4
     as four concurrent clients (shard 0's output equal to map_file's),
     no client initializing CUDA or launching a kernel itself, the
     daemon's launches of K7, K1, K2 and K3 (its ping before and after
     each run), its peak planes in flight at or under its cap, one
     "bench ext" through it, --stop and its exit 0; [mesh]:
     parallel.dist.mesh_map_queries on a
     1 x 1 NCCL grid with a GpuExtEngine on the card over the first 500
     proteins, equal to map_file's output, the two lookup steps' seconds
     against their byte bounds.  Each run
     sets the launch counts to 0 just before it and reads them after;
     the kernels' device time per run (CUDA events around each launch),
     launches and problems per launch per (kind, width, nl bucket),
     the DPs the engine ran on the host, by reason, with their host
     seconds, and the map's stages, wait on the card and flush rounds
  5. entry points: entry() (K7 + K1 at the JAX entry's shape) equal to
     its plain version and the host engine, timed; dryrun_multichip(1)
     (one NCCL rank, output equal to map_query's)
  6. the last line: {"ok": true, "device": {...}}

The lines before the last carry a {"kernels": [...]} JSON object and
the nvidia-smi card line.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

# the H100 rates and operation counts bound_ms is computed from
from miniprot_tpu_torch.benchmarks import (INT16_OPS_PER_S,
                                           INT32_OPS_PER_S, K1_OPS_PER_CELL,
                                           K2_OPS_PER_CELL, MEM_BYTES_PER_S,
                                           PREP_LOGPEN_OPS_PER_ROW,
                                           PREP_OPS_PER_ROW,
                                           SKETCH_OPS_PER_RUN_WINDOW,
                                           SKETCH_OPS_PER_WINDOW)

SRC = "miniprot_tpu_torch/kernels/csrc/"
# contigs of the e2e workload: each is genome_mb / N_CTG long, the
# strand length the device sketch sees
N_CTG = 4


CUDA_BIN = "/usr/local/cuda/bin/"
# the multi-process paths (the [shards], [mesh] and [daemon] phases)
# that launch K7, K1, K2 and K3 besides the single-process maps
PARALLEL_PATHS = ("shards PAF", "shards GFF", "mesh", "daemon",
                  "daemon shards")
# a SASS instruction line of cuobjdump: its address, an optional guard
# predicate, the opcode with its modifiers
SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Za-z0-9_.]*)")


def sass_functions(path: str) -> dict:
    """{function: [opcode, ...]} of a cubin or shared library, NOPs left
    out (cuobjdump from the CUDA toolkit; the run fails without it)."""
    exe = CUDA_BIN + "cuobjdump"
    if not os.path.exists(exe):
        fail(f"{exe} not found: the SASS cannot be checked")
    r = subprocess.run([exe, "-sass", path], capture_output=True, text=True,
                       timeout=300)
    if r.returncode != 0:
        fail(f"cuobjdump -sass {path}: {r.stderr.strip()}")
    fn, ops = None, {}
    for ln in r.stdout.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
            ops[fn] = []
        elif fn is not None:
            m = SASS_OP.search(ln)
            if m and m.group(1) != "NOP":
                ops[fn].append(m.group(1))
    return ops


# kernels that must not spill: K4's B4 and B4' forms and K5 (their
# -Xptxas -v spill bytes and their SASS local loads and stores are
# checked)
NO_SPILL = ("striped_cigar_kernel", "striped32_kernel", "cell_walk_kernel")


def ptxas_spills(log: str) -> dict:
    """{function: (registers, spill store bytes, spill load bytes)} from
    nvcc's -Xptxas -v output."""
    out, fn, spill = {}, None, (0, 0)
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and fn:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            out[fn] = (int(m.group(1)), *spill)
            fn, spill = None, (0, 0)
    return out


def sass_counts(so: str, log: str) -> None:
    """Print, per K1-K5 and K7 instantiation in the built library, how
    many of its SASS instructions are Hopper DPX forms (VIADDMNMX: add
    then max/min; VIMNMX3: three-way max/min), named-barrier waits and
    local-memory loads and stores (LDL/STL: register spills), beside its
    registers and spill bytes; fail on a spill in NO_SPILL."""
    want = ("VIADDMNMX", "VIMNMX3", "BAR.SYNC", "LDL", "STL")
    regs = ptxas_spills(log)
    seen = set()
    for fn, ops in sass_functions(so).items():
        if not any(k in fn for k in ("ext_dp", "scan_cigar", "striped",
                                     "cell_walk", "run_walk", "track_prep")):
            continue
        base = [o[:8] if o.startswith("BAR.") else o.split(".")[0]
                for o in ops]
        r, st_b, ld_b = regs.get(fn, (None, None, None))
        print(f"[sass] {fn}: " + ", ".join(f"{op} {base.count(op)}"
                                           for op in want)
              + f"; {r} registers, spill stores {st_b} B, loads {ld_b} B")
        if any(k in fn for k in NO_SPILL):
            seen.add(next(k for k in NO_SPILL if k in fn))
            if r is None or st_b or ld_b or base.count("LDL") \
                    or base.count("STL"):
                fail(f"{fn} spills or has no ptxas line")
    if seen != set(NO_SPILL):
        fail(f"no SASS for {set(NO_SPILL) - seen}")


# Hopper's packed int16 intrinsics beside the int32 forms the kernels
# use, each alone in a kernel that loads its operands and stores the
# result; the baseline kernels compute x ^ y (^ z), one LOP3
INT16X2_PROBES = (
    ("base2", 2, "x ^ y"),
    ("base3", 3, "x ^ y ^ z"),
    ("__vaddss2", 2, "__vaddss2(x, y)"),
    ("__vsubss2", 2, "__vsubss2(x, y)"),
    ("__vmaxs2", 2, "__vmaxs2(x, y)"),
    ("__vimax3_s16x2", 3, "__vimax3_s16x2(x, y, z)"),
    ("__viaddmax_s16x2", 3, "__viaddmax_s16x2(x, y, z)"),
    ("__vibmax_s16x2", 2, "vibmax(x, y)"),
    ("sat16(x + y) on int32", 2, "(unsigned)min(max((int)x + (int)y, -32768), 32767)"),
    ("__viaddmax_s32", 3, "(unsigned)__viaddmax_s32((int)x, (int)y, (int)z)"),
    ("__vimax3_s32", 3, "(unsigned)__vimax3_s32((int)x, (int)y, (int)z)"),
)


def sass_int16x2_probe() -> None:
    """Compile INT16X2_PROBES for sm_90a and print the SASS each
    intrinsic takes: the instructions its kernel has beyond its
    baseline's, with the baseline's LOP3 taken out."""
    from collections import Counter

    from miniprot_tpu_torch.native.build import BUILD_DIR
    os.makedirs(BUILD_DIR, exist_ok=True)
    src = ["// vibmax: the max and which operand won, per half",
           "__device__ __forceinline__ unsigned vibmax(unsigned x, unsigned y) {",
           "  bool hi, lo;",
           "  const unsigned m = __vibmax_s16x2(x, y, &hi, &lo);",
           "  return m ^ ((unsigned)hi << 31) ^ ((unsigned)lo << 15);",
           "}"]
    for k, (_, _, expr) in enumerate(INT16X2_PROBES):
        src.append(f'extern "C" __global__ void probe{k}(const unsigned* a, '
                   "const unsigned* b, const unsigned* c, unsigned* o) {\n"
                   "  const int i = threadIdx.x;\n"
                   "  const unsigned x = a[i], y = b[i], z = c[i];\n"
                   f"  o[i] = {expr};\n}}")
    cu = os.path.join(BUILD_DIR, "int16x2_probe.cu")
    cubin = cu[:-3] + ".cubin"
    with open(cu, "w") as f:
        f.write("\n".join(src) + "\n")
    r = subprocess.run([CUDA_BIN + "nvcc", "-cubin", "-arch=sm_90a", "-O3",
                        cu, "-o", cubin], capture_output=True, text=True,
                       timeout=300)
    if r.returncode != 0:
        fail(f"int16x2 probe: nvcc failed:\n{r.stdout}{r.stderr}")
    ops = {fn: Counter(v) for fn, v in sass_functions(cubin).items()}
    # the loads, the store and the addressing around each probe
    frame = {a: ops[f"probe{a - 2}"] - Counter(["LOP3.LUT"]) for a in (2, 3)}
    for k, (name, arity, _) in enumerate(INT16X2_PROBES[2:], start=2):
        extra = ops[f"probe{k}"] - frame[arity]
        print(f"[sass int16x2] {name}: {sum(extra.values())} instructions "
              f"({', '.join(f'{o} {n}' for o, n in sorted(extra.items()))})")


def fail(msg: str) -> None:
    sys.stderr.write(f"chip_smoke: FAIL: {msg}\n")
    sys.exit(1)


def bound(nbytes: float, ops: float, rate: float) -> tuple[float, str]:
    """(ms, what binds): the larger of bytes over the memory rate and
    operations over ``rate``."""
    tb, to = nbytes / MEM_BYTES_PER_S, ops / rate
    return (1e3 * max(tb, to), "bytes" if tb >= to else "operations")


def _geo(geo: dict) -> str:
    return ", ".join(f"{w}: {ms:.3f}" for w, ms in geo.items())


def time_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean device ms of fn() over reps calls, CUDA events, warmed up."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def scoring():
    from miniprot_tpu_torch import tables
    from miniprot_tpu_torch.align import DpEnv
    from miniprot_tpu_torch.options import MapOpt
    opt = MapOpt()
    env = DpEnv(opt)
    scal = (opt.go, opt.ge, opt.fs, opt.io, opt.xdrop, opt.end_bonus,
            opt.ie_coef)
    T = tables.get_tables(1)
    kw = dict(mat=opt.mat, nt4=T.nt4, aa20=T.aa20, codon=T.codon, sp=env.sp,
              sp_null_bonus=opt.sp_null_bonus, go=opt.go, ge=opt.ge,
              io=opt.io, fs=opt.fs, xdrop=opt.xdrop,
              end_bonus=opt.end_bonus, ie_coef=opt.ie_coef)
    return opt, env, scal, T, kw


def _same_results(a, b) -> bool:
    """Two collect() result lists equal (None, ints, CIGAR arrays)."""
    import numpy as np
    return len(a) == len(b) and all(
        (x is None) == (y is None) and (x is None or (
            len(x) == len(y) and all(np.array_equal(u, v)
                                     for u, v in zip(x, y))))
        for x, y in zip(a, b))


def check_no_sync(batch, want):
    """One launch() of a raw batch under torch.cuda.set_sync_debug_mode(
    "error"), where a stream synchronization (a blocking copy to the
    card) raises; its results must equal ``want``."""
    import torch
    name = type(batch).__name__
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = batch.launch()
    except RuntimeError as e:
        fail(f"{name}.launch() synchronizes the stream: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not _same_results(batch.collect(handle), want):
        fail(f"{name}.launch() under sync debug mode: other results")
    print(f"[sync] {name}.launch() ({batch.n} problems): no stream "
          "synchronization", flush=True)


def phase_prep(tag, raw, kw):
    """K7 on one raw batch's inputs (nt8, left, iov, nlv; kw: the rest
    of prep_tracks' arguments): exact against its plain version on the
    card (the torch ops) on every element, each timed.  Returns its
    kernels-line entry, the tracks under "tracks"; its launches are
    those of all three maps (every raw batch runs it)."""
    import torch

    from miniprot_tpu_torch.kernels import nasw_ext as ne
    nt8, left, iov, nlv = raw
    n, RD = nt8.shape
    R = kw["n_rows"]
    ext = kw.get("als") is not None

    def plain():
        lf = torch.zeros(n, dtype=torch.int8, device=nt8.device) \
            if left is None else left
        out = ne._prep_seq_device(nt8, lf, iov, nlv, sp=kw["sp"],
                                  codon=kw["codon"], n_rows=R)
        if not ext:
            return out
        return (*out, ne._logpen_device(kw["als"], kw["thr"], R, nt8.device))

    got = ne.prep_tracks(*raw, **kw)
    want = plain()
    torch.cuda.synchronize()
    if len(got) != len(want) or not all(torch.equal(a, b)
                                        for a, b in zip(got, want)):
        fail(f"track_prep {tag}: kernel != plain version")
    ms = time_ms(lambda: ne.prep_tracks(*raw, **kw), reps=10)
    plain_ms = time_ms(plain, reps=5)
    ops = PREP_OPS_PER_ROW + (PREP_LOGPEN_OPS_PER_ROW if ext else 0)
    bms, by = bound(n * RD + n * R * (1 + (4 if ext else 0)) + 8 * n * RD,
                    n * R * ops, INT32_OPS_PER_S)
    print(f"[K7 track_prep] {tag}: exact vs plain on every element; "
          f"{ms:.4f} ms; plain (_prep_seq_device"
          f"{' + _logpen_device' if ext else ''}, torch ops) {plain_ms:.3f} "
          f"ms; bound {bms:.4f} ms ({by})", flush=True)
    return dict(name=f"track_prep[{tag}]", route="cuda",
                source=SRC + "track_prep.cu",
                replaces="miniprot_tpu/kernels/nasw_pallas.py:638",
                counter="track_prep",
                paths=("default", "striped route", "-O 0", *PARALLEL_PATHS),
                max_abs_err=0,
                ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=None, tracks=got)


def phase_ext(al_pad, nl_pad, n, seed, go=None):
    """K1 at one bucket; go=0 takes its 8-lane lazy-F form."""
    import numpy as np
    import torch

    from miniprot_tpu_torch import native
    from miniprot_tpu_torch.kernels import nasw_ext as ne
    from miniprot_tpu_torch.native import DPF_EXT_LEFT, DPF_EXT_RIGHT
    from miniprot_tpu_torch.testgen import text_homolog
    opt, env, scal, T, kw = scoring()
    if go is not None:
        scal = (go,) + scal[1:]
        kw = dict(kw, go=go)
    tag = f"al={al_pad},nl={nl_pad}" + ("" if go is None else f",go={go}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    batch = ne.RawExtBatch(al_pad, nl_pad, opt.mat, scal, sp=env.sp,
                           device=dev, capacity=n)
    cases = []
    for _ in range(n):
        al = int(rng.integers(al_pad // 2, al_pad + 1))
        nl = int(rng.integers(nl_pad // 2, nl_pad + 1))
        nsq, asq = text_homolog(rng, al, nl)
        left = bool(rng.integers(0, 2))
        nt4, aas = T.nt4[nsq], T.aa20[asq]
        if left:
            nt4, aas = nt4[::-1], aas[::-1]
        batch.add_raw(nt4, aas, io=opt.io, ext_left=left)
        cases.append((nsq, asq, left))
    thr = ne._logpen_thresholds(float(np.float32(opt.ie_coef)), batch.nl)
    als = ne._upload(batch.als[:n], dev)
    nlv = ne._upload(batch.nlv[:n], dev)
    raw = (ne._upload(batch.nt[:n], dev), ne._upload(batch.leftb[:n], dev),
           ne._upload(batch.iov[:n], dev), nlv)
    k7 = phase_prep(f"ext {tag},n={n}", raw, dict(
        sp=batch.sp, codon=T.codon, n_rows=batch.nl, als=als, thr=thr))
    nas, D, A, logpen = k7.pop("tracks")
    args = (nas, D, A, logpen, nlv, als, ne._upload(batch.prof[:n], dev),
            ne._opts(batch))
    got = ne.ext_dp(*args)
    rows = torch.zeros(n, dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    want = ne.ext_dp_plain(*args, rows_done=rows)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    if not torch.equal(got, want):
        fail(f"ext_dp {tag}: kernel != plain version")
    res = batch.collect(got)
    for (nsq, asq, left), r in zip(cases, res):
        ref = native.dp16(nsq, asq, flag=DPF_EXT_LEFT if left
                          else DPF_EXT_RIGHT, **kw)[:3]
        if tuple(ref) != r:
            fail(f"ext_dp {tag}: {r} != host engine {tuple(ref)}")
    check_no_sync(batch, res)
    ms = time_ms(lambda: ne.ext_dp(*args), reps=10)
    row_sum = int(rows.sum())
    cells = row_sum * al_pad
    nbytes = row_sum * (1 + 4 + 4 + 4 + 4) + n * (22 * al_pad + 12)
    bms, by = bound(nbytes, cells * K1_OPS_PER_CELL, INT16_OPS_PER_S)
    print(f"[K1 ext_dp] {tag} n={n}: exact vs plain and "
          f"host engine; {ms:.3f} ms, {cells} cells ({row_sum} rows run), "
          f"{cells / ms / 1e6:.2f} GCUPS; plain {plain_ms:.1f} ms; "
          f"bound {bms:.4f} ms ({by}); {ne.EXT_WARPS[al_pad]} warps per "
          "problem", flush=True)
    return [dict(name=f"ext_dp[{tag}]", route="cuda",
                 source=SRC + "ext_dp.cu",
                 replaces="miniprot_tpu/kernels/nasw_pallas.py:89",
                 counter="ext_dp",
                 paths=("default", "striped route", *PARALLEL_PATHS)
                 if go is None
                 else ("-O 0",), max_abs_err=0, ms=ms, plain_ms=plain_ms,
                 bound_ms=bms, bound_by=by, library_ms=None), k7]


def probe_ext_capacity(al_pad, nl_pad, ns, seed):
    """K1's device time per problem at one bucket for several problem
    counts (the first n of the same problems): whether launches larger
    than device.ext_capacity gives would pay.  Timing only: exactness
    is the K1 phases' job."""
    import numpy as np
    import torch

    from miniprot_tpu_torch.kernels import nasw_ext as ne
    from miniprot_tpu_torch.testgen import text_homolog
    opt, env, scal, T, kw = scoring()
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    N = max(ns)
    batch = ne.RawExtBatch(al_pad, nl_pad, opt.mat, scal, sp=env.sp,
                           device=dev, capacity=N)
    for _ in range(N):
        al = int(rng.integers(al_pad // 2, al_pad + 1))
        nl = int(rng.integers(nl_pad // 2, nl_pad + 1))
        nsq, asq = text_homolog(rng, al, nl)
        batch.add_raw(T.nt4[nsq], T.aa20[asq], io=opt.io)
    thr = ne._logpen_thresholds(float(np.float32(opt.ie_coef)), batch.nl)
    als = ne._upload(batch.als, dev)
    nlv = ne._upload(batch.nlv, dev)
    nas, D, A, logpen = ne.prep_tracks(
        ne._upload(batch.nt, dev), ne._upload(batch.leftb, dev),
        ne._upload(batch.iov, dev), nlv, sp=batch.sp, codon=T.codon,
        n_rows=batch.nl, als=als, thr=thr)
    prof = ne._upload(batch.prof, dev)
    parts = []
    for n in ns:
        args = (nas[:n], D[:n], A[:n], logpen[:n], nlv[:n], als[:n],
                prof[:n], ne._opts(batch))
        ms = time_ms(lambda: ne.ext_dp(*args), reps=3)
        parts.append(f"{n} problems {ms:.3f} ms ({1e3 * ms / n:.2f} us per "
                     "problem)")
    print(f"[K1 capacity] al={al_pad} nl={nl_pad}: " + ", ".join(parts),
          flush=True)


def phase_scan(W, nl_pad, n, seed, prep=False):
    """K2 and K3 on n problems of class width W (n may exceed the
    class's own capacity: the engine's cig_capacity sizes real
    launches); prep: K7 on the batch's raw tracks too."""
    import numpy as np
    import torch

    from miniprot_tpu_torch import native
    from miniprot_tpu_torch.kernels import nasw_cigar_scan as sk
    from miniprot_tpu_torch.kernels import nasw_ext as ne
    from miniprot_tpu_torch.native import DPF_CIGAR
    from miniprot_tpu_torch.testgen import text_homolog
    opt, env, scal, T, kw = scoring()
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    cls = sk.SmallScanCigarBatch if W <= sk.SMALL_W else sk.RawScanCigarBatch
    batch = cls(W, nl_pad, opt.mat, scal, sp=env.sp, device=dev, capacity=n)
    cases = []
    al_lo = 1 if W <= sk.SMALL_W else W // 4 + 1
    for _ in range(n):
        al = int(rng.integers(al_lo, W + 1))
        nl = int(rng.integers(nl_pad // 2, nl_pad + 1))
        nsq, asq = text_homolog(rng, al, nl)
        batch.add_raw(T.nt4[nsq], T.aa20[asq], io=opt.io)
        cases.append((nsq, asq))
    R = batch._rows()
    nlv, alv = batch._lens()
    tag = f"W={W},nl={nl_pad}" + ("" if n == cls.CAPACITY else f",n={n}")
    if prep:
        k7 = phase_prep(f"scan W={W},nl={nl_pad},n={n}", (
            ne._upload(batch.nt[:n, :R + 8], dev), None,
            ne._upload(batch.iov[:n], dev), nlv), dict(
            sp=batch.sp, codon=T.codon, n_rows=R))
        tracks = k7.pop("tracks")
    else:
        tracks = batch._tracks()
    args = (*tracks, nlv, alv, ne._upload(batch.prof[:n], dev),
            (batch.go, batch.ge, batch.fs), R)
    tb, hint, score = sk.scan_cigar_dp(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tb_p, hint_p, score_p = sk.scan_cigar_dp_plain(*args)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    valid = sk.valid_rows(nlv, R)
    if not (torch.equal(torch.where(valid, tb, 0), tb_p)
            and torch.equal(torch.where(valid, hint, 0), hint_p)
            and torch.equal(score, score_p)):
        fail(f"scan_cigar_dp W={W} nl={nl_pad}: kernel != plain version")
    rounds = batch.rounds()
    walk = sk.run_walk(tb, hint, nlv, alv, rounds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    walk_p = sk.run_walk_plain(tb, hint, nlv, alv, rounds)
    torch.cuda.synchronize()
    walk_plain_ms = 1e3 * (time.perf_counter() - t0)
    if not all(torch.equal(a, b) for a, b in zip(walk, walk_p)):
        fail(f"run_walk W={W}: kernel != plain version")
    res = batch.collect((*walk, score))
    for (nsq, asq), r in zip(cases, res):
        rsc, _, _, rcig = native.dp16(nsq, asq, flag=DPF_CIGAR, **kw)
        if r is not None and (r[0] != rsc or not np.array_equal(r[1], rcig)):
            fail(f"scan_cigar_dp W={W}: result != host engine")
    if sum(r is None for r in res) > n // 10:
        fail(f"run_walk W={W}: too many walks hit the round cap")
    check_no_sync(batch, res)
    ms = time_ms(lambda: sk.scan_cigar_dp(*args), reps=5)
    geo = {w: time_ms(lambda: sk.scan_cigar_dp(*args, warps=w), reps=3)
           for w in sk.SCAN_GEOMETRIES[W]}
    walk_ms = time_ms(lambda: sk.run_walk(tb, hint, nlv, alv, rounds),
                      reps=10)
    rows = int((nlv.clamp(min=2) - 2).sum())
    cells = rows * W
    nbytes = 4 * cells + rows * (1 + 8) + n * (22 * W + 12)
    bms, by = bound(nbytes, cells * K2_OPS_PER_CELL, INT16_OPS_PER_S)
    steps = int((walk[0] != 15).sum())
    wbytes = steps * 7 + n * 16
    wbms, wby = bound(wbytes, steps * 12, INT32_OPS_PER_S)
    small = W <= sk.SMALL_W
    print(f"[K2 scan_cigar_dp] W={W} nl={nl_pad} n={n}: exact vs plain and "
          f"host engine; {ms:.3f} ms ({1e3 * ms / n:.2f} us per problem), "
          f"{cells} cells, {cells / ms / 1e6:.2f} GCUPS; plain "
          f"{plain_ms:.1f} ms; bound {bms:.4f} ms ({by}); ms by warps per "
          f"problem {_geo(geo)} (default {sk.scan_warps(W, n)})", flush=True)
    print(f"[K3 run_walk] W={W} n={n}: exact vs plain; {walk_ms:.3f} ms for "
          f"{steps} rounds; plain {walk_plain_ms:.1f} ms; bound "
          f"{wbms:.5f} ms ({wby})", flush=True)
    k2 = "scan_cigar_dp_small" if small else "scan_cigar_dp"
    return ([k7] if prep else []) + [dict(name=f"{k2}[{tag}]", route="cuda",
                 source=SRC + "scan_cigar.cu",
                 replaces="miniprot_tpu/kernels/nasw_cigar_scan.py:111",
                 counter=k2, paths=("default", *PARALLEL_PATHS),
                 max_abs_err=0, ms=ms,
                 plain_ms=plain_ms, shape=(W, nl_pad, n),
                 bound_ms=bms, bound_by=by, library_ms=None),
            dict(name=f"run_walk[{tag}]", route="cuda",
                 source=SRC + "run_walk.cu",
                 replaces="miniprot_tpu/kernels/nasw_cigar_scan.py:458",
                 counter="run_walk", paths=("default", *PARALLEL_PATHS),
                 max_abs_err=0,
                 ms=walk_ms,
                 plain_ms=walk_plain_ms, bound_ms=wbms, bound_by=wby,
                 library_ms=None)]


def _striped_inputs(batch):
    """K4's arguments as a batch launch builds them on its device."""
    import torch

    from miniprot_tpu_torch.kernels import nasw_ext as ne
    n, dev = batch.n, batch.device
    nlv, alv = batch._lens()
    args = (*batch._tracks(), nlv, alv, ne._upload(batch.aas[:n], dev),
            torch.from_numpy(batch.mat).to(dev),
            (batch.go, batch.ge, batch.fs), batch._rows())
    return args, nlv, alv


def _striped_cells(batch, vl):
    """(rows, cells) the striped DP computes for a batch: each problem's
    rows 2..nl-1 times its own stripes x vl lanes."""
    rows = sum(max(nl - 2, 0) for nl, _ in batch.dims)
    cells = sum(max(nl - 2, 0) * -(-al // vl) * vl for nl, al in batch.dims)
    return rows, cells


def phase_striped(W, nl_pad, n, seed, go, k2_ms):
    """K4 and K5 on n problems of class width W; k2_ms: K2's device ms
    per (W, nl bucket, problems) in this run, the yardstick of K4 at the
    same shape."""
    import numpy as np
    import torch

    from miniprot_tpu_torch import native
    from miniprot_tpu_torch.kernels import nasw_cigar_striped as st
    from miniprot_tpu_torch.native import DPF_CIGAR
    from miniprot_tpu_torch.testgen import text_homolog
    opt, env, scal, T, kw = scoring()
    scal = (go,) + scal[1:]
    kw = dict(kw, go=go)
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    cls = st.SmallCigarBatch if W <= 32 else st.RawCigarBatch
    batch = cls(W, nl_pad, opt.mat, scal, sp=env.sp, device=dev, capacity=n)
    cases = []
    al_lo = 1 if W <= 32 else W // 4 + 1
    for _ in range(n):
        al = int(rng.integers(al_lo, W + 1))
        nl = int(rng.integers(nl_pad // 2, nl_pad + 1))
        nsq, asq = text_homolog(rng, al, nl)
        batch.add_raw(T.nt4[nsq], T.aa20[asq], io=opt.io)
        cases.append((nsq, asq))
    args, nlv, alv = _striped_inputs(batch)
    tb, score = st.striped_cigar_dp(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tb_p, score_p = st.striped_cigar_dp_plain(*args)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    valid = st.valid_cells(nlv, alv, tb.shape[1], W)
    if not (torch.equal(torch.where(valid, tb, 0), tb_p)
            and torch.equal(score, score_p)):
        fail(f"striped_cigar_dp W={W} nl={nl_pad} go={go}: kernel != plain")
    steps = batch.steps()
    walk = st.cell_walk(tb, nlv, alv, steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    walk_p = st.cell_walk_plain(tb, nlv, alv, steps)
    torch.cuda.synchronize()
    walk_plain_ms = 1e3 * (time.perf_counter() - t0)
    if not all(torch.equal(a, b) for a, b in zip(walk, walk_p)):
        fail(f"cell_walk W={W}: kernel != plain version")
    res = batch.collect((*walk, score))
    for (nsq, asq), r in zip(cases, res):
        rsc, _, _, rcig = native.dp16(nsq, asq, flag=DPF_CIGAR, **kw)
        if r[0] != rsc or not np.array_equal(r[1], rcig):
            fail(f"striped_cigar_dp W={W} go={go}: result != host engine")
    check_no_sync(batch, res)
    ms = time_ms(lambda: st.striped_cigar_dp(*args), reps=5)
    walk_ms = time_ms(lambda: st.cell_walk(tb, nlv, alv, steps), reps=10)
    rows, cells = _striped_cells(batch, st.VL)
    nbytes = 2 * cells + rows * (1 + 8) + n * (W + 8) + 22 * 22
    bms, by = bound(nbytes, cells * K2_OPS_PER_CELL, INT16_OPS_PER_S)
    used = int((walk[0] != 15).sum())
    wbms, wby = bound(used * 3 + n * 16, used * 12, INT32_OPS_PER_S)
    tag = f"W={W},nl={nl_pad},go={go}" + ("" if n == cls.CAPACITY
                                           else f",n={n}")
    paths = ("-O 0",) if go == 0 else ("striped route",)
    k2 = k2_ms.get((W, nl_pad, n))
    beside = ("" if k2 is None else f"; K2 at this shape in this run "
              f"{k2:.3f} ms (K4 / K2 = {ms / k2:.3f})")
    print(f"[K4 striped_cigar_dp] {tag} n={n}: exact vs plain and host "
          f"engine; {ms:.3f} ms ({1e3 * ms / n:.2f} us per problem), "
          f"{cells} cells, {cells / ms / 1e6:.2f} GCUPS; plain "
          f"{plain_ms:.1f} ms; bound {bms:.4f} ms ({by}); "
          f"{st.STRIPED_WARPS[W]} warps per problem{beside}", flush=True)
    print(f"[K5 cell_walk] {tag} n={n}: exact vs plain; {walk_ms:.3f} ms "
          f"for {used} steps; plain {walk_plain_ms:.1f} ms; bound "
          f"{wbms:.5f} ms ({wby})", flush=True)
    return [dict(name=f"striped_cigar_dp[{tag}]", route="cuda",
                 source=SRC + "striped_cigar.cu",
                 replaces="miniprot_tpu/kernels/nasw_cigar_pallas.py:74",
                 counter="striped_cigar_dp", paths=paths, max_abs_err=0,
                 ms=ms,
                 plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                 library_ms=None),
            dict(name=f"cell_walk[{tag}]", route="cuda",
                 source=SRC + "cell_walk.cu",
                 replaces="miniprot_tpu/kernels/nasw_cigar_pallas.py:421",
                 counter="cell_walk", paths=paths, max_abs_err=0,
                 ms=walk_ms,
                 plain_ms=walk_plain_ms, bound_ms=wbms, bound_by=wby,
                 library_ms=None)]


def phase_dp32(W, nl_pad, n, seed, go=None):
    """B4' (gs32b) on a matrix with 127 on the diagonal and al in [W/2,
    W], nl >= 3 al: at W >= 512 homologs (every 4th one exact) score past
    the int16 range, which an int8 matrix cannot reach at al <= 128.
    go=0 takes its go == 0 instantiation.  Its launches are counted
    here: the mapper never runs it."""
    import numpy as np
    import torch

    from miniprot_tpu_torch import kernels, native
    from miniprot_tpu_torch.kernels import nasw_cigar_striped as st
    from miniprot_tpu_torch.kernels.nasw_ext import prep_problem
    from miniprot_tpu_torch.native import DPF_CIGAR
    from miniprot_tpu_torch.testgen import text_homolog
    opt, env, scal, T, kw = scoring()
    go = opt.go if go is None else go
    scal = (go,) + scal[1:]
    hot = opt.mat.copy()
    hot[np.arange(20), np.arange(20)] = 127
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    tag = f"W={W},nl={nl_pad},go={go}"
    kernels.reset_launch_counts()
    batch = st.Dp32Batch(W, nl_pad, hot, scal, device=dev, capacity=n)
    cases = []
    for k in range(n):
        al = int(rng.integers(W // 2, W + 1))
        nl = int(rng.integers(3 * al, nl_pad + 1))
        nsq, asq = text_homolog(rng, al, nl, 0.0 if k % 4 == 0 else 0.1)
        nas, aas, d, a = prep_problem(nsq, asq, sp=env.sp,
                                      sp_null_bonus=opt.sp_null_bonus,
                                      io=opt.io, ext_left=False)
        batch.add(nas, aas, d, a, io=opt.io)
        cases.append((nsq, asq))
    args, nlv, alv = _striped_inputs(batch)
    tb, score = st.striped_cigar_dp32(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tb_p, score_p = st.striped_cigar_dp32_plain(*args)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    valid = st.valid_cells(nlv, alv, tb.shape[1], W, st.VL32)
    if not (torch.equal(torch.where(valid, tb, 0), tb_p)
            and torch.equal(score, score_p)):
        fail(f"striped_cigar_dp32 {tag}: kernel != plain version")
    res = batch.collect((tb, score))
    for (nsq, asq), r in zip(cases, res):
        rsc, rcig = native.dp32(nsq, asq, flag=DPF_CIGAR, mat=hot, nt4=T.nt4,
                                aa20=T.aa20, codon=T.codon, sp=env.sp,
                                sp_null_bonus=opt.sp_null_bonus, go=go,
                                ge=opt.ge, io=opt.io, fs=opt.fs)
        if r[0] != rsc or not np.array_equal(r[1], rcig):
            fail(f"striped_cigar_dp32 {tag}: result != host engine dp32")
    over = sum(r[0] > 32767 for r in res)
    if W >= 512 and over < n // 8:
        fail(f"striped_cigar_dp32 {tag}: only {over} scores past 32767")
    launches = kernels.launch_counts()["striped_cigar_dp32"]
    ms = time_ms(lambda: st.striped_cigar_dp32(*args), reps=3)
    rows, cells = _striped_cells(batch, st.VL32)
    nbytes = 2 * cells + rows * (1 + 8) + n * (W + 8) + 22 * 22
    bms, by = bound(nbytes, cells * K2_OPS_PER_CELL, INT32_OPS_PER_S)
    top = max(r[0] for r in res)
    print(f"[K4 striped_cigar_dp32] {tag} n={n}: exact vs plain "
          f"and host dp32, {over} scores > 32767 (max {top}); {ms:.3f} ms, "
          f"{cells} cells, {cells / ms / 1e6:.2f} GCUPS; plain "
          f"{plain_ms:.1f} ms; bound {bms:.4f} ms ({by}); "
          f"{st.DP32_WARPS[st.dp32_class(W)]} warps per problem; {launches} "
          f"launches in this phase", flush=True)
    return dict(name=f"striped_cigar_dp32[{tag}] (library DP, "
                "off the mapper: launches counted in its own phase)",
                route="cuda", source=SRC + "striped_cigar.cu",
                replaces="miniprot_tpu/kernels/nasw_cigar_pallas.py:74",
                launches=launches, launches_by_path={"own phase": launches},
                max_abs_err=0, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=None)


def sketch_bound(seq, kept, min_aa_len, kmer):
    """K6's bound on a strand (a uint8 tensor) with ``kept`` entries:
    (ms, what binds, windows whose run passes the length tests (from the
    plain version's sense slots and run lengths), windows, the
    operations' ms were every window hashed)."""
    from miniprot_tpu_torch.kernels import sketch_gpu as sg
    sense, _ = sg.sense_codes(seq)
    run_windows = 0
    for p in (0, 1, 2):
        if sense[p::3].shape[0] >= kmer:
            ending, total = sg._run_lengths(sense[p::3])
            run_windows += int(((ending[kmer - 1:] >= kmer)
                                & (total[kmer - 1:] >= min_aa_len)).sum())
    n = len(seq)
    windows = sg._frames(n, kmer)[1]
    bms, by = bound(n + 8 * kept, SKETCH_OPS_PER_WINDOW * windows
                    + SKETCH_OPS_PER_RUN_WINDOW * run_windows,
                    INT32_OPS_PER_S)
    most = 1e3 * (SKETCH_OPS_PER_WINDOW + SKETCH_OPS_PER_RUN_WINDOW) \
        * windows / INT32_OPS_PER_S
    return bms, by, run_windows, windows, most


def phase_sketch(seed, strand_bp):
    """K6 on random strands of 5 bp, of one tile (3 TILE_SLOTS bases)
    +- 1, of 1,000,003 bp and of ``strand_bp``, the e2e workload's
    contig length (the index build sketches each contig and its reverse
    complement whole), and on a 2 Mb strand of long ORFs at -L 30 and
    -L 2000 (runs past the staged halo and past a tile): the entries in
    order against the plain version on the card, and sorted against the
    host sketch_nt4, through sketch_entries and sketch_nt4_device; one
    launch under torch.cuda.set_sync_debug_mode("error"); timed at
    strand_bp."""
    import numpy as np
    import torch

    from miniprot_tpu_torch import kernels
    from miniprot_tpu_torch.kernels import sketch_gpu as sg
    from miniprot_tpu_torch.options import IdxOpt
    from miniprot_tpu_torch.sketch import sketch_nt4
    from miniprot_tpu_torch.testgen import orf_strand
    o = IdxOpt()
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)

    def random_strand(n):
        return rng.choice(np.arange(5, dtype=np.uint8), n,
                          p=[.24, .24, .24, .24, .04])

    tile = 3 * sg.TILE_SLOTS
    cases = [(random_strand(n), o.min_aa_len)
             for n in (5, tile - 1, tile, tile + 1, 1_000_003)]
    orfs = orf_strand(rng, 2_000_000, 3000)
    cases += [(orfs, 30), (orfs, 2000), (random_strand(strand_bp),
                                          o.min_aa_len)]
    for seq, mal in cases:
        n, args = len(seq), (mal, o.kmer, o.mod_bit, o.bbit, 77)
        sd = torch.from_numpy(seq).to(dev)
        got = sg.sketch_entries(sd, *args)
        if not torch.equal(got, sg.sketch_entries_plain(sd, *args)):
            fail(f"sketch_orf n={n} -L {mal}: kernel != plain version")
        want = np.sort(sketch_nt4(seq, *args))
        if not np.array_equal(np.sort(got.cpu().numpy().view(np.uint64)),
                              want):
            fail(f"sketch_orf n={n} -L {mal}: entries != host sketch_nt4")
        if not np.array_equal(np.sort(sg.sketch_nt4_device(
                seq, *args, device=dev)), want):
            fail(f"sketch_orf n={n} -L {mal}: sketch_nt4_device != host "
                 "sketch_nt4")
        print(f"[K6 sketch_orf] n={n} -L {mal}: {len(want)} entries, "
              "exact vs plain (in order) and host sketch_nt4", flush=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run = sg.sketch_launch(sd, *args)
    except RuntimeError as e:
        fail(f"sketch_launch synchronizes the stream: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not torch.equal(torch.cat(run.regions()), got):
        fail("sketch_launch under sync debug mode: other entries")
    print("[sync] sketch_launch: no stream synchronization", flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sg.sketch_entries_plain(sd, *args)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    reps = 20
    with kernels.timed_launches() as kernel_ms:
        ms = time_ms(lambda: sg.sketch_launch(sd, *args), reps=reps)
    t0 = time.perf_counter()
    for _ in range(3):
        sg.sketch_nt4_device(seq, *args, device=dev)
    wall_ms = 1e3 * (time.perf_counter() - t0) / 3
    kept = len(got)
    bms, by, run_windows, windows, most = sketch_bound(sd, kept, mal, o.kmer)
    print(f"[K6 sketch_orf] strand of {n} bp: {ms:.4f} ms a launch (status "
          f"fill + kernel; the kernel alone "
          f"{kernel_ms['mp_sketch_orf'] / (reps + 1):.4f}), "
          f"{n / ms / 1e6:.2f} Gbp/s, {kept} of {windows} windows kept, "
          f"{run_windows} pass the run tests; "
          f"sketch_nt4_device (upload, launch, count read, pull-back) "
          f"{wall_ms:.2f} ms host wall; plain {plain_ms:.1f} ms; bound "
          f"{bms:.4f} ms ({by}; bytes {1e3 * (n + 8 * kept) / MEM_BYTES_PER_S:.4f})"
          f", {ms / bms:.2f}x; with every window hashed {most:.4f} ms "
          f"({ms / most:.2f}x)",
          flush=True)
    return dict(name=f"sketch_orf[{n} bp]", route="cuda",
                source=SRC + "sketch_orf.cu",
                replaces="miniprot_tpu/kernels/sketch_jax.py:52",
                counter="sketch_orf", paths=("index",), max_abs_err=0, ms=ms,
                plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=None)


INDEX_STAGES = ("fetch_s", "sketch_s", "bb_add_s", "bb_finish_s")


def index_build(fa):
    """Index.build of ``fa`` with the device sketch, launch counts set to
    0 just before it; returns (index, wall s, stage s from the build's
    ``stats``, launches)."""
    from miniprot_tpu_torch import kernels
    from miniprot_tpu_torch.index import Index
    from miniprot_tpu_torch.options import IdxOpt
    stages: dict = {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    mi = Index.build(fa, IdxOpt(), sketch_device="cuda", stats=stages)
    wall = time.perf_counter() - t0
    return mi, wall, stages, kernels.launch_counts()


def _stages_line(wall, stages):
    return (f"{wall:.3f} s: " + ", ".join(
        f"{k[:-2]} {stages[k]:.3f}" for k in INDEX_STAGES)
        + f", the rest (FASTA parse, offsets, allocation) "
        f"{wall - sum(stages[k] for k in INDEX_STAGES):.3f}")


def phase_index(genome_mb, n_prot, reps=2):
    """The e2e workload's --gpu-sketch index build alone (no kernel
    phases, no maps), after one warm-up sketch, ``reps`` times with its
    stage split, and K6's device ms on the workload's first strand: the
    comparison of two trees (--package) in one call."""
    import numpy as np
    import torch

    from miniprot_tpu_torch.genome import NtDB
    from miniprot_tpu_torch.kernels import sketch_gpu as sg
    from miniprot_tpu_torch.options import IdxOpt
    from miniprot_tpu_torch.testgen import make_workload
    sg.sketch_nt4_device(np.zeros(100_000, np.uint8), 30, 6, 1, 8, 0,
                         device="cuda")
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as d:
        fa, faa = os.path.join(d, "g.fa"), os.path.join(d, "q.faa")
        make_workload(fa, faa, genome_len=genome_mb * 1_000_000,
                      n_genes=n_prot, seed=11, n_ctg=N_CTG,
                      max_intron=20_000, rev_frac=0.5, fs_frac=0.1)
        for r in range(reps):
            mi, wall, stages, launches = index_build(fa)
            print(f"[index run {r + 1}] --gpu-sketch build "
                  f"({len(mi.kb)} kmer-block pairs, "
                  f"{launches['sketch_orf']} sketch_orf launches) "
                  + _stages_line(wall, stages), flush=True)
        o = IdxOpt()
        sd = torch.from_numpy(NtDB.from_fasta(fa).get(0, 0, -1, False)).cuda()
        args = (sd, o.min_aa_len, o.kmer, o.mod_bit, o.bbit, 0)
        ms = time_ms(lambda: sg.sketch_launch(*args), reps=20)
        kept = len(sg.sketch_entries(*args))
        bms, by, run_windows, windows, _ = sketch_bound(
            sd, kept, o.min_aa_len, o.kmer)
        print(f"[index] K6 on the first strand ({len(sd)} bp): {ms:.4f} ms "
              f"a launch; {kept} kept, {run_windows} of {windows} windows "
              f"pass the run tests; bound {bms:.4f} ms ({by}), "
              f"{ms / bms:.2f}x", flush=True)


@contextlib.contextmanager
def _pre_chunk(n):
    """pipeline.PRE_CHUNK set to ``n`` inside the block (None: left as
    it is)."""
    from miniprot_tpu_torch import pipeline
    old = pipeline.PRE_CHUNK
    if n is not None:
        pipeline.PRE_CHUNK = n
    try:
        yield pipeline.PRE_CHUNK
    finally:
        pipeline.PRE_CHUNK = old


def _map(mi, faa, opt, device, threads, need=(), pre_chunk=None,
         route_probe=False):
    """One map_file run with the launch counts set to 0 just before it
    and read just after; fails unless every kernel in ``need`` was
    launched (and, for the host engine, unless none was)."""
    from miniprot_tpu_torch import kernels
    from miniprot_tpu_torch.pipeline import map_file
    from miniprot_tpu_torch.sysutil import profiler
    with _pre_chunk(pre_chunk) as chunk:
        profiler.reset()
        kernels.reset_launch_counts()
        buf, stats = io.StringIO(), {}
        with kernels.timed_launches() as kernel_ms:
            t0 = time.perf_counter()
            n = map_file(mi, faa, opt, n_threads=threads, out=buf,
                         device=device, stats=stats, route_probe=route_probe)
            wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
    run = dict(out=buf.getvalue(), wall=wall, n=n, stats=stats,
               launches=launches, kernel_ms=kernel_ms,
               stages=dict(profiler.stages), pre_chunk=chunk,
               exposed=profiler.device_exposed_s,
               rounds=profiler.flush_rounds)
    if device is None and any(launches.values()):
        fail(f"the host engine run launched kernels: {launches}")
    for k in need:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the main path")
    if device is not None and not route_probe \
            and stats["device_fraction"] < 0.90:
        fail(f"device cell fraction {stats['device_fraction']:.4f} < 0.90")
    return run


def _stage_line(run) -> str:
    """The GPU map's host stages, the driving thread's wait on the card,
    its flush rounds and launches per kind."""
    st, stats = run["stages"], run["stats"]
    per_kind: dict = {}
    for key, (t, _) in stats["bucket_problems"].items():
        c = per_kind.setdefault(key[0], [0, 0])
        c[0] += stats["bucket_batches"][key]
        c[1] += t
    return (f"PRE_CHUNK {run['pre_chunk']}; pre_align "
            f"{st.get('pre_align', 0):.3f}, pre_align_wait "
            f"{st.get('pre_align_wait', 0):.3f}, align_rounds "
            f"{st.get('align_rounds', 0):.3f}, finish_align "
            f"{st.get('finish_align', 0):.3f}, emit {st.get('emit', 0):.3f}, "
            f"pool start {st.get('pool_start', 0):.3f} s; inside the "
            f"batches' launch() {stats['launch_s']:.3f} s, decode "
            f"{stats['decode_s']:.3f} s; exposed wait "
            f"{run['exposed']:.3f} s; "
            f"{run['rounds']} flush rounds; launches / mean "
            "problems per launch: " + ", ".join(
                f"{k} {n} / {t / n:.1f}"
                for k, (n, t) in sorted(per_kind.items())))


def _report(tag, gpu, host, threads):
    """Print one GPU map beside the host engine's run of the same map."""
    stats = gpu["stats"]
    lines = gpu["out"].count("\n")
    print(f"[e2e {tag}] byte-identical ({lines} lines); GPU engine "
          f"{gpu['n'] / gpu['wall']:.2f} proteins/s ({gpu['wall']:.2f} s), "
          f"host engine {host['n'] / host['wall']:.2f} proteins/s "
          f"({host['wall']:.2f} s), {threads} threads; device cell fraction "
          f"{stats['device_fraction']:.4f}; DP calls {stats['n_device']} "
          f"device / {stats['n_host']} host; batches {stats['batches']}; "
          f"launches { {k: v for k, v in gpu['launches'].items() if v} }",
          flush=True)
    print(f"[e2e {tag}] batches per bucket (kind, width, nl bucket): "
          + ", ".join(f"{k}x{w}x{b} {v}" for (k, w, b), v
                      in sorted(stats["bucket_batches"].items())),
          flush=True)
    launches = stats["bucket_batches"]
    print(f"[e2e {tag}] problems per launch (kind, width, nl bucket: "
          "launches, mean / max problems): " + ", ".join(
              f"{k}x{w}x{b} {launches[(k, w, b)]}, "
              f"{t / launches[(k, w, b)]:.1f} / {m}"
              for (k, w, b), (t, m) in sorted(
                  stats["bucket_problems"].items())), flush=True)
    print(f"[e2e {tag}] host-routed DPs by reason: "
          f"{dict(sorted(stats['host_reasons'].items()))}; host s running "
          f"them in flush_begin {stats['host_dp_s']:.3f}", flush=True)
    busy = sum(gpu["kernel_ms"].values()) / 1e3
    print(f"[e2e {tag}] kernel device time in the GPU map: "
          + ", ".join(f"{k} {v:.1f} ms"
                      for k, v in sorted(gpu["kernel_ms"].items()))
          + f"; {busy:.3f} s of {gpu['wall']:.2f} s "
          f"(kernel busy share {busy / gpu['wall']:.4f}); K7 device "
          f"{gpu['kernel_ms'].get('mp_track_prep', 0.0):.1f} ms",
          flush=True)
    print(f"[e2e {tag}] GPU map stages (host wall s): " + _stage_line(gpu),
          flush=True)


def phase_flush_no_sync(seed):
    """One flush_begin of a real round (K7, K1, K2 and K3 launches, the
    collect wave's copies and events, the host DPs) under
    torch.cuda.set_sync_debug_mode("error"); flush_end's results equal
    the host engine's."""
    import numpy as np
    import torch

    from miniprot_tpu_torch.device import GpuExtEngine
    from miniprot_tpu_torch.native import (DPF_CIGAR, DPF_EXT_LEFT,
                                           DPF_EXT_RIGHT)
    from miniprot_tpu_torch.testgen import submit_round
    opt, env, _, _, _ = scoring()
    engine = GpuExtEngine(opt, "cuda")
    rng = np.random.default_rng(seed)
    submit_round(engine, rng, 64, 128)
    engine.flush()                 # warm the allocators
    ext, cig = submit_round(engine, rng, 64, 128)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fl = engine.flush_begin()
    except RuntimeError as e:
        fail(f"flush_begin synchronizes the stream: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    res = engine.flush_end(fl)
    for (ns, aa, left), r in zip(ext, res):
        sc, ntl, aal, _ = env.dp(ns, aa,
                                 DPF_EXT_LEFT if left else DPF_EXT_RIGHT)
        if r != (sc, ntl, aal):
            fail("flush under sync debug mode: an ext result differs from "
                 "the host engine's")
    for (ns, aa), r in zip(cig, res[-1]):
        sc, _, _, c = env.dp(ns, aa, DPF_CIGAR)
        if r[0] != sc or not np.array_equal(r[1], c):
            fail("flush under sync debug mode: a CIGAR differs from the "
                 "host engine's")
    print(f"[sync] flush_begin of {len(ext)} ext + {len(cig)} CIGAR jobs "
          f"(batches {engine.batches}): no stream synchronization; "
          "flush_end equal to the host engine", flush=True)


def _subsets(mi, faa, d, threads):
    """Two disjoint subsets of the workload's proteins (150 each at most)
    written to ``d``: [(path, map_file output on the host engine)]."""
    from miniprot_tpu_torch.bseq import read_fastx
    from miniprot_tpu_torch.options import MapOpt
    recs = list(read_fastx(faa))
    k = min(150, len(recs) // 2)
    want = []
    for j, sub in enumerate((recs[:k], recs[k:2 * k])):
        fn = os.path.join(d, f"sub{j}.faa")
        with open(fn, "wb") as f:
            f.write(b"".join(b">" + r.name.encode() + b"\n" + r.seq + b"\n"
                             for r in sub))
        want.append((fn, _map(mi, fn, MapOpt(), None, threads)["out"]))
    return want


def phase_server(mi, want, threads):
    """MapServer on 127.0.0.1:0 on the card answers two disjoint subsets
    of the workload's proteins (``want``: _subsets') and an empty
    request; each reply equals map_file of the same subset on the host
    engine.  Returns the kernel launches of the three requests."""
    import threading

    from miniprot_tpu_torch import kernels, server
    from miniprot_tpu_torch.options import MapOpt
    opt = MapOpt()
    srv = server.MapServer(("127.0.0.1", 0), mi, opt, threads, "cuda")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        host, port = srv.server_address
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got = [server.query(host, port, open(fn, "rb").read())
               for fn, _ in want]
        empty = server.query(host, port, b"")
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(60)
    for k, (g, (_, w)) in enumerate(zip(got, want)):
        if g.decode() != w or not w:
            fail(f"server reply {k + 1} differs from map_file of its subset")
    if empty != b"":
        fail("server: an empty request got a reply")
    for k in ("track_prep", "ext_dp", "scan_cigar_dp", "run_walk"):
        if launches[k] <= 0:
            fail(f"server: kernel {k} was not launched by the requests")
    print(f"[server] MapServer on the card, {threads} threads: replies to "
          f"two subsets of {_n_records(want[0][0])} + "
          f"{_n_records(want[1][0])} proteins byte-identical "
          f"to map_file on the host engine, the empty request empty; "
          f"{wall:.2f} s for the three; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    return launches


def _n_records(fn) -> int:
    with open(fn, "rb") as f:
        return f.read().count(b">")


def phase_bench():
    """miniprot_tpu_torch.benchmarks on the card: run_bench_op("ext") and
    ("cigar"), each record with its readings, spread and peak share;
    every rate finite and above 0."""
    import math

    from miniprot_tpu_torch.benchmarks import run_bench_op
    for kind in ("ext", "cigar"):
        t0 = time.perf_counter()
        rec = run_bench_op(kind)
        nums = [(k, x) for k, v in rec.items() if k != "device"
                for x in (v if isinstance(v, list) else [v])]
        if any(not math.isfinite(x) or x < 0
               or (x == 0 and k != "ext_gcups_spread") for k, x in nums):
            fail(f"bench {kind}: a rate is not finite and positive: {rec}")
        print(f"[bench {kind}] {json.dumps(rec)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)


def phase_route(mi, faa, host_out, d, threads, need):
    """map_file(route_probe=True) of the e2e workload on the card, the
    route cache in ``d``: byte-identical to the host engine's output, the
    choice and both probe times printed; when the outcome was decisive
    (cached), a second map that reads the cache instead of probing, also
    byte-identical.  Returns the first map's launches."""
    from miniprot_tpu_torch import pipeline
    from miniprot_tpu_torch.options import MapOpt
    cache = os.path.join(d, "route.json")
    old = pipeline._route_cache_path
    pipeline._route_cache_path = lambda: cache
    try:
        first = _map(mi, faa, MapOpt(), "cuda", threads, need,
                     route_probe=True)
        decisive = os.path.exists(cache)
        second = (_map(mi, faa, MapOpt(), "cuda", threads, route_probe=True)
                  if decisive else None)
    finally:
        pipeline._route_cache_path = old
    st = first["stats"]
    if first["out"] != host_out:
        fail("route-probe map output differs from the host engine's")
    if "route_probe_device_s" not in st:
        fail(f"route-probe map ran no probe: {st.get('route_choice')}")
    t_dev, t_host = st["route_probe_device_s"], st["route_probe_host_s"]
    verdict = "decisive, cached" if decisive else "near tie, not cached"
    print(f"[route] probe on the e2e workload: device block "
          f"{t_dev:.3f} s, host block {t_host:.3f} s -> {st['route_choice']} "
          f"engine ({verdict}); byte-identical to the host engine; map {first['wall']:.2f} s "
          f"({first['n'] / first['wall']:.2f} proteins/s); launches "
          f"{ {k: v for k, v in first['launches'].items() if v} }",
          flush=True)
    if second is not None:
        if second["out"] != host_out:
            fail("cached-route map output differs from the host engine's")
        if not second["stats"].get("route_cached"):
            fail("the second route-probe map did not read the cache")
        print(f"[route] second map read the cache "
              f"({second['stats']['route_choice']} engine): byte-identical; "
              f"{second['wall']:.2f} s "
              f"({second['n'] / second['wall']:.2f} proteins/s)", flush=True)
    return first["launches"]


# the kernels whose device-only time per launch the trace phase prints
TRACE_TIMES = ("run_walk_kernel", "cell_walk_kernel", "track_prep_kernel")


def _cli_map(mpi, faa, want, d, threads, impl=None, trace_dir=None):
    """cli.main on ``faa`` against the dumped index ``mpi`` (on the
    striped route when ``impl``; with --profile-trace=``trace_dir``
    when given), its output required to equal ``want``, the launch
    counts set to 0 just before it: (wall s, launches)."""
    from miniprot_tpu_torch import cli, kernels
    out = os.path.join(d, "cli_out.paf")
    argv = [mpi, faa, "-t", str(threads), "-o", out]
    if trace_dir is not None:
        argv.append(f"--profile-trace={trace_dir}")
    if impl:
        os.environ["MINIPROT_TPU_CIG_IMPL"] = impl
    kernels.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("MINIPROT_TPU_CIG_IMPL", None)
    launches = kernels.launch_counts()
    if rc != 0:
        fail(f"cli.main {' '.join(argv[4:])}: returned {rc}")
    with open(out) as f:
        if f.read() != want:
            fail(f"cli.main {' '.join(argv[4:])}: output differs from the "
                 "host engine's")
    return wall, launches


def phase_trace(mpi, faa, want, d, threads):
    """cli.main with --profile-trace on ``faa`` (a subset of the
    workload, its host-engine output ``want``) against the dumped index
    ``mpi``: after one run without the trace, on the default route (the
    profiler's first start in this process), the striped route and the
    default route again.  Each output byte-identical, and a device event
    in the trace for every kernel whose launch count went up; prints
    each kernel's events against its launches, K3's, K5's and K7's
    device-only ms per launch, and each run's wall beside the untraced
    one.  Returns {"trace " + route: launches}."""
    from miniprot_tpu_torch import kernels
    plain, _ = _cli_map(mpi, faa, want, d, threads)
    print(f"[trace] cli.main on {_n_records(faa)} proteins without "
          f"--profile-trace: {plain:.2f} s", flush=True)
    runs = {}
    for k, (tag, impl) in enumerate((("default", None),
                                     ("striped route", "striped"),
                                     ("default again", None))):
        tdir = os.path.join(d, f"trace{k}")
        wall, launches = _cli_map(mpi, faa, want, d, threads, impl, tdir)
        path = os.path.join(tdir, "trace.json")
        times = kernels.trace_kernel_times(path)
        per_fn: dict = {}
        for c, v in launches.items():
            if v:
                fn = kernels.KERNEL_FUNCTIONS[c]
                per_fn[fn] = per_fn.get(fn, 0) + v
        for fn in per_fn:
            if times.get(fn, (0, 0.0))[0] <= 0:
                fail(f"trace {tag}: no device event for {fn}, launched "
                     f"{per_fn[fn]} times")
        print(f"[trace {tag}] {os.path.getsize(path)} bytes, cli.main "
              f"{wall:.2f} s (untraced {plain:.2f}), byte-identical; device "
              "events / launches, device ms: " + ", ".join(
                  f"{fn} {times[fn][0]} / {n}, {times[fn][1]:.3f}"
                  for fn, n in sorted(per_fn.items()))
              + "; device-only ms per launch: " + ", ".join(
                  f"{fn} {times[fn][1] / times[fn][0]:.4f}"
                  for fn in TRACE_TIMES if fn in times), flush=True)
        runs[f"trace {tag}"] = launches
    return runs


# one CLI process of the [shards] and [daemon] phases: cli.main with,
# in mode "direct", the CUDA context and the kernel library set up first
# (each timed; a "daemon" client has neither), the index load and the
# engine's construction timed inside, the launch counts from 0, the
# seconds from the parent's spawn to the first flush_begin (the first
# launch), the engine's counters (pipeline._engine_stats) and whether
# the process initialized CUDA, written to a JSON file
CLIENT_RUN = r"""
import json, sys, time
out_json, t_spawn, mode = sys.argv[1], float(sys.argv[2]), sys.argv[3]
import torch
rec = {"torch_s": time.time() - t_spawn, "context_s": 0.0, "library_s": 0.0}
from miniprot_tpu_torch import cli, device, kernels, pipeline
rec["start_s"] = time.time() - t_spawn
if mode == "direct":
    t0 = time.time()
    torch.cuda.init()
    torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    rec["context_s"] = time.time() - t0
    t0 = time.time()
    kernels.lib()
    rec["library_s"] = time.time() - t0
load0 = cli.Index.load
init0 = device.GpuExtEngine.__init__
flush0 = device.GpuExtEngine.flush_begin
stats0 = pipeline._engine_stats


def load(*a, **k):
    t0 = time.time()
    mi = load0(*a, **k)
    rec["index_load_s"] = time.time() - t0
    return mi


def init(self, *a, **k):
    t0 = time.time()
    init0(self, *a, **k)
    rec["engine_s"] = time.time() - t0


def flush_begin(self):
    rec.setdefault("first_launch_s", time.time() - t_spawn)
    return flush0(self)


def engine_stats(engine, stats):
    st = {} if stats is None else stats
    stats0(engine, st)
    rec.update({k: v for k, v in st.items() if k in (
        "n_device", "n_host", "peak_pending_tb", "launch_s", "decode_s",
        "daemon", "daemon_batches", "daemon_launches", "daemon_wait_s",
        "daemon_peak_pending_tb", "daemon_pending_cap")})


cli.Index.load = load
device.GpuExtEngine.__init__ = init
device.GpuExtEngine.flush_begin = flush_begin
pipeline._engine_stats = engine_stats
kernels.reset_launch_counts()
t0 = time.time()
rc = cli.main(sys.argv[4:])
rec.update(rc=rc, wall_s=time.time() - t0, launches=kernels.launch_counts(),
           cuda_initialized=torch.cuda.is_initialized())
with open(out_json, "w") as f:
    json.dump(rec, f)
"""


def _run_clients(tag, mode, argvs, d, env=None):
    """CLIENT_RUN in ``mode`` once per argv of ``argvs``, all started
    together; fails unless each exits 0.  Returns their records."""
    jsons = [os.path.join(d, f"{tag.replace(' ', '_')}{i}.json")
             for i in range(len(argvs))]
    procs = [subprocess.Popen(
        [sys.executable, "-c", CLIENT_RUN, js, repr(time.time()), mode,
         *argv], cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for js, argv in zip(jsons, argvs)]
    try:
        errs = [p.communicate(timeout=600)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    recs = []
    for i, (p, err, js) in enumerate(zip(procs, errs, jsons)):
        if p.returncode != 0:
            fail(f"{tag}: process {i} exited {p.returncode}: {err[-2000:]}")
        with open(js) as f:
            recs.append(json.load(f))
    return recs


def _start_line(rec) -> str:
    """A client's seconds from spawn to its first launch, by part."""
    rest = (rec["first_launch_s"] - rec["start_s"] - rec["context_s"]
            - rec["library_s"] - rec["index_load_s"] - rec["engine_s"])
    return (f"{rec['first_launch_s']:.2f} s from spawn to the first "
            f"launch: interpreter and import torch {rec['torch_s']:.2f}, "
            f"the package's imports {rec['start_s'] - rec['torch_s']:.2f}, "
            f"CUDA context {rec['context_s']:.2f}, library load "
            f"{rec['library_s']:.3f}, index load {rec['index_load_s']:.3f} "
            f"(mapped), engine construction {rec['engine_s']:.3f}, the rest "
            f"(the first chunk's pre_align) {rest:.2f}")


N_SHARDS = 2


def phase_shards(mi, mpi, faa, want_paf, d, threads):
    """The CLI with --shards 2 --shard-id {0,1} --spool-dir as two
    concurrent processes on the card, against the dumped index ``mpi``
    and every protein of ``faa``: PAF, then GFF (two-phase ids), shard
    0's output byte-identical to map_file's (``want_paf``; the GFF map
    on the host engine here).  Prints each shard's wall, proteins/s,
    DP split, peak planes and the seconds before its first launch with
    their parts.  Returns ({"shards PAF" | "shards GFF": launches of
    both shards}, [each shard's record])."""
    import torch

    from miniprot_tpu_torch.options import F_GFF, MapOpt
    ogff = MapOpt()
    ogff.flag |= F_GFF
    want = {"PAF": want_paf,
            "GFF": _map(mi, faa, ogff, None, threads)["out"]}
    n_prot = _n_records(faa)
    # the cache of this process's earlier phases is not the shards' to
    # compete with
    torch.cuda.empty_cache()
    runs, recs = {}, []
    for mode, flags in (("PAF", []), ("GFF", ["--gff"])):
        spool = os.path.join(d, f"spool_{mode}")
        out = os.path.join(d, f"shards.{mode.lower()}")
        mode_recs = _run_clients(f"shards {mode}", "direct", [
            [*flags, "--shards", str(N_SHARDS), "--shard-id", str(i),
             "--spool-dir", spool, *(["-o", out] if i == 0 else []), mpi,
             faa] for i in range(N_SHARDS)], d)
        with open(out) as f:
            if f.read() != want[mode]:
                fail(f"shards {mode}: shard 0's output differs from "
                     "map_file's")
        launches: dict = {}
        for i, rec in enumerate(mode_recs):
            rec.update(mode=mode, shard=i)
            recs.append(rec)
            for k, v in rec["launches"].items():
                launches[k] = launches.get(k, 0) + v
            n_mine = len(range(i, n_prot, N_SHARDS))
            print(f"[shards {mode}] shard {i}: {n_mine} proteins in "
                  f"{rec['wall_s']:.2f} s of cli.main "
                  f"({n_mine / rec['wall_s']:.2f} proteins/s); DP split "
                  f"{rec['n_device']} device / {rec['n_host']} host; peak "
                  f"planes in flight {rec['peak_pending_tb']} bytes; "
                  + _start_line(rec), flush=True)
        for k in ("track_prep", "ext_dp", "scan_cigar_dp", "run_walk"):
            if launches[k] <= 0:
                fail(f"shards {mode}: kernel {k} was not launched")
        print(f"[shards {mode}] {N_SHARDS} processes on one card: shard 0's "
              f"output byte-identical to map_file's ({n_prot} proteins, "
              f"{want[mode].count(chr(10))} lines); launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        runs[f"shards {mode}"] = launches
    return runs, recs


N_DAEMON_SHARDS = 4


def _launch_delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()}


def phase_daemon(mpi, faa, want, gpu, d, threads):
    """The device daemon on the card (python -m miniprot_tpu_torch.daemon
    --warm on a private socket) and CLI processes attached to it through
    MINIPROT_TPU_DAEMON_SOCK, against the dumped index ``mpi`` and every
    protein of ``faa``: one client (PAF, byte-identical to the host
    engine's ``want``, its proteins/s beside ``gpu``, this run's direct
    map), then --shards 4 as four concurrent clients (shard 0's merged
    output equal to ``want``).  No client may initialize CUDA or launch a
    kernel itself; the daemon's launch counts (read from its ping before
    and after each run) must show K7, K1, K2 and K3, and its peak planes
    in flight must stay at or under its cap.  Then one "bench ext"
    through the daemon, and --stop, after which the daemon exits 0.
    Returns {"daemon" | "daemon shards": the daemon's launches}."""
    import shutil

    from miniprot_tpu_torch.daemon import DaemonClient
    here = os.path.dirname(os.path.abspath(__file__))
    n_prot = _n_records(faa)
    # a short directory: a unix socket's path is limited to 107 bytes
    sdir = tempfile.mkdtemp(prefix="mpd-")
    sock = os.path.join(sdir, "d.sock")
    log = os.path.join(d, "daemon.err")
    env = dict(os.environ, MINIPROT_TPU_DAEMON_SOCK=sock)
    env.pop("MINIPROT_TPU_DAEMON", None)
    t0 = time.time()
    with open(log, "w") as lf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "miniprot_tpu_torch.daemon", "--socket",
             sock, "--warm"], cwd=here, stdout=subprocess.DEVNULL,
            stderr=lf)
    c = None
    try:
        while c is None:
            if proc.poll() is not None:
                with open(log) as f:
                    fail(f"[daemon] exited {proc.returncode} before serving: "
                         f"{f.read()[-2000:]}")
            if time.time() - t0 > 300:
                fail("[daemon] no answer 300 s after its start")
            try:
                c = DaemonClient.connect(sock, timeout=10)
            except ConnectionError:
                time.sleep(0.1)
        ready = time.time() - t0
        info = c.info
        print(f"[daemon] {info['name']} (sm_{info['capability'][0]}"
              f"{info['capability'][1]}, {info['memory']} bytes): ready "
              f"{ready:.2f} s after its spawn, of which warm "
              f"{info['warm']['s']:.2f} s for {len(info['warm']['shapes'])} "
              f"shapes ({', '.join(info['warm']['shapes'])}); plane cap "
              f"{info['pending_cap']} bytes in flight, {info['batch_cap']} a "
              "batch", flush=True)
        runs = {}
        before = c.ping()["launches"]
        out1 = os.path.join(d, "daemon_client.paf")
        (rec,) = _run_clients("daemon client", "daemon", [
            [mpi, faa, "-t", str(threads), "-o", out1]], d, env)
        runs["daemon"] = _launch_delta(before, c.ping()["launches"])
        with open(out1) as f:
            if f.read() != want:
                fail("daemon: the client's output differs from the host "
                     "engine's")
        recs = [rec]
        print(f"[daemon] one client, cli.main over {n_prot} proteins: "
              f"byte-identical to the host engine ({want.count(chr(10))} "
              f"lines); {n_prot / rec['wall_s']:.2f} proteins/s "
              f"({rec['wall_s']:.2f} s of cli.main, the index load "
              f"included) beside this run's direct GPU map "
              f"{gpu['n'] / gpu['wall']:.2f} proteins/s ({gpu['wall']:.2f} s "
              f"of map_file); DP split {rec['n_device']} device / "
              f"{rec['n_host']} host; {rec['daemon_batches']} batches "
              f"through the daemon, {rec['launch_s']:.3f} s in their "
              f"launch RPCs, the daemon's wait on them in collects "
              f"{rec['daemon_wait_s']:.3f} s; torch.cuda.is_initialized() "
              f"{rec['cuda_initialized']}; " + _start_line(rec), flush=True)
        spool = os.path.join(d, "spool_daemon")
        out4 = os.path.join(d, "daemon_shards.paf")
        before = c.ping()["launches"]
        shard_recs = _run_clients("daemon shards", "daemon", [
            ["--shards", str(N_DAEMON_SHARDS), "--shard-id", str(i),
             "--spool-dir", spool, *(["-o", out4] if i == 0 else []), mpi,
             faa] for i in range(N_DAEMON_SHARDS)], d, env)
        runs["daemon shards"] = _launch_delta(before, c.ping()["launches"])
        with open(out4) as f:
            if f.read() != want:
                fail("daemon shards: shard 0's output differs from "
                     "map_file's")
        recs += shard_recs
        for i, r in enumerate(shard_recs):
            n_mine = len(range(i, n_prot, N_DAEMON_SHARDS))
            print(f"[daemon shards] shard {i}: {n_mine} proteins in "
                  f"{r['wall_s']:.2f} s of cli.main "
                  f"({n_mine / r['wall_s']:.2f} proteins/s); DP split "
                  f"{r['n_device']} device / {r['n_host']} host; "
                  f"torch.cuda.is_initialized() {r['cuda_initialized']}; "
                  + _start_line(r), flush=True)
        for r in recs:
            if r["cuda_initialized"] or any(r["launches"].values()) \
                    or not r["daemon"]:
                fail(f"daemon: a client initialized CUDA, launched a "
                     f"kernel or did not attach: {r}")
        info = c.ping()
        total = {k: runs["daemon"][k] + runs["daemon shards"][k]
                 for k in runs["daemon"]}
        for k in ("track_prep", "ext_dp", "scan_cigar_dp", "run_walk"):
            if total[k] <= 0:
                fail(f"daemon: kernel {k} was not launched by the daemon")
        if not 0 < info["peak_tb"] <= info["pending_cap"]:
            fail(f"daemon: peak planes in flight {info['peak_tb']} against "
                 f"the cap {info['pending_cap']}")
        print(f"[daemon] {N_DAEMON_SHARDS} --shards clients: shard 0's output "
              f"byte-identical to map_file's; the daemon launched "
              f"{ {k: v for k, v in total.items() if v} } for the five "
              f"clients ({info['launched']} batches, {info['collect_ops']} "
              f"collects); peak planes in flight {info['peak_tb']} bytes "
              f"under the cap {info['pending_cap']}; {info['budget_waits']} "
              "batches waited for room", flush=True)
        b = c.bench("ext")
        print(f"[daemon] bench ext through the daemon on {b['device']}: "
              f"{b['value']:.2f} GCUPS (readings {b['ext_gcups_reps']}, "
              f"peak share {b['ext_peak_share']:.4f})", flush=True)
        c.close()
        c = None
        r = subprocess.run([sys.executable, "-m", "miniprot_tpu_torch.daemon",
                            "--socket", sock, "--stop"], cwd=here,
                           capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            fail(f"daemon --stop exited {r.returncode}: {r.stderr[-2000:]}")
        rc = proc.wait(timeout=120)
        if rc != 0:
            with open(log) as f:
                fail(f"the daemon exited {rc} after --stop: "
                     f"{f.read()[-2000:]}")
        print(f"[daemon] stopped: --stop exited 0, the daemon {rc}",
              flush=True)
    finally:
        if c is not None:
            c.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(sdir, ignore_errors=True)
    return runs


MESH_PROTEINS = 500


def phase_mesh(mi, faa, d, threads):
    """mesh_map_queries on a 1 x 1 NCCL grid (world size 1, a file://
    store) with a GpuExtEngine on the card, over the whole index and the
    first MESH_PROTEINS proteins (the rank's pre_align is serial),
    twice: the first map also sets up the NCCL communicators, the
    second's output must be byte-identical to map_file's on those
    proteins, and its two steps' device ms (CUDA events around each
    step) are printed against their byte bounds, beside their seconds
    on the host clock (upload, step and copy back), with K, a_cap and
    the pass-2 chunks.  Returns the second map's launches."""
    import datetime

    import numpy as np
    import torch.distributed as tdist

    from miniprot_tpu_torch import kernels
    from miniprot_tpu_torch.bseq import read_fastx
    from miniprot_tpu_torch.device import GpuExtEngine
    from miniprot_tpu_torch.options import MapOpt
    from miniprot_tpu_torch.parallel import dist
    from miniprot_tpu_torch.pipeline import _emit_query
    recs = list(read_fastx(faa))[:MESH_PROTEINS]
    fn = os.path.join(d, "mesh.faa")
    with open(fn, "wb") as f:
        f.write(b"".join(b">" + r.name.encode() + b"\n" + r.seq + b"\n"
                         for r in recs))
    opt = MapOpt()
    want = _map(mi, fn, opt, None, threads)["out"]
    seqs = [np.frombuffer(r.seq, np.uint8) for r in recs]
    tdist.init_process_group(
        "nccl", init_method="file://" + os.path.join(d, "mesh_store"),
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = dist.make_mesh(1, 1)
        # the first map also sets up the axis groups' NCCL communicators
        # (on their first collective); the second is the one reported
        cold: dict = {}
        t0 = time.perf_counter()
        dist.mesh_map_queries(mesh, mi, seqs, opt, engine=GpuExtEngine(opt),
                              stats=cold)
        cold_wall = time.perf_counter() - t0
        engine = GpuExtEngine(opt)
        st: dict = {}
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        regs = dist.mesh_map_queries(mesh, mi, seqs, opt, engine=engine,
                                     stats=st)
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        tdist.destroy_process_group()
    buf = io.StringIO()
    idc = [0]
    for rec, seq, r in zip(recs, seqs, regs):
        _emit_query(mi, opt, rec.name, seq, r, idc, buf)
    if buf.getvalue() != want:
        fail("mesh: mesh_map_queries output differs from map_file's")
    for k in ("track_prep", "ext_dp", "scan_cigar_dp", "run_walk"):
        if launches[k] <= 0:
            fail(f"mesh: kernel {k} was not launched")
    # bytes each step must move: pass 1 reads the hashes and two bucket
    # offsets per hash and writes the counts (int64); pass 2 reads the
    # hashes, the keep mask, two offsets per hash and one kb entry per
    # hit, and writes blocks (int64), seed_of (int32) per slot and tot
    # (int32) per query
    K, a_cap, rows, chunks = st["K"], st["a_cap"], st["rows"], st["chunks"]
    nq = rows * chunks
    count_b = len(seqs) * K * (8 + 16 + 8)
    gather_b = (nq * K * (8 + 1 + 16) + st["hits"] * 8
                + nq * a_cap * (8 + 4) + nq * 4)
    cb, _ = bound(count_b, 0, 1)
    gb, _ = bound(gather_b, 0, 1)
    print(f"[mesh] mesh_map_queries on a 1 x 1 NCCL grid, GpuExtEngine on "
          f"the card: {len(seqs)} proteins byte-identical to map_file "
          f"({want.count(chr(10))} lines) in {wall:.2f} s; pass 1 (count "
          f"step) device {st['count_step_ms']:.4f} ms, bound {cb:.4f} ms "
          f"(bytes), {st['count_step_ms'] / cb:.1f}x; pass 2 (gather step) "
          f"device {st['gather_step_ms']:.4f} ms over {chunks} chunk(s) of "
          f"{rows} queries, bound {gb:.4f} ms (bytes; {st['hits']} hits), "
          f"{st['gather_step_ms'] / gb:.1f}x; host clock (upload, step, "
          f"copy back) {1e3 * st['count_step_s']:.3f} ms and "
          f"{1e3 * st['gather_step_s']:.3f} ms; K {K}, a_cap {a_cap}; DP "
          f"split {engine.n_device} device / {engine.n_host} host; launches "
          f"{ {k: v for k, v in launches.items() if v} }; the first map "
          f"{cold_wall:.2f} s, its count step device "
          f"{cold['count_step_ms']:.4f} ms and gather step device "
          f"{cold['gather_step_ms']:.4f} ms", flush=True)
    return launches


def phase_entry():
    """entry() on the card equal to its plain version and to the host C
    engine, timed; then dryrun_multichip(1) (one NCCL rank)."""
    import torch

    from miniprot_tpu_torch import entry
    fn, args = entry.entry()
    got = fn(*args)
    torch.cuda.synchronize()
    pfn, pargs = entry.entry("cpu")
    t0 = time.perf_counter()
    want = pfn(*pargs)
    plain_ms = 1e3 * (time.perf_counter() - t0)
    if not torch.equal(got.cpu(), want):
        fail("entry: the card's result differs from the plain version's")
    rows = [(int(s), int(i) + 1, int(j) + 1) for s, i, j in got.tolist()]
    if rows != entry.entry_reference():
        fail("entry: the card's result differs from the host engine's")
    ms = time_ms(lambda: fn(*args), reps=20)
    t0 = time.perf_counter()
    entry.dryrun_multichip(1)
    dry = time.perf_counter() - t0
    print(f"[entry] entry() K7 + K1 at al {entry.AL} (width "
          f"{entry.AL_PAD}) x {entry.NL} rows x "
          f"{entry.N_PROBLEMS} problems: exact vs plain and host engine; "
          f"{ms:.4f} ms a launch (plain {plain_ms:.1f} ms on the CPU); "
          f"dryrun_multichip(1) on NCCL byte-identical to map_query in "
          f"{dry:.2f} s (its rank's spawn included)", flush=True)


def phase_e2e(genome_mb, n_prot, threads):
    """The default map (PRE_CHUNK at its default, and again at 0), the
    striped-route map and the -O 0 map on both engines, the route-probe
    map, the server, the traced CLI maps and the index built with the
    device sketch.  Returns each path's launch counts: {"default" |
    "PRE_CHUNK 0" | "striped route" | "-O 0" | "route probe" | "server"
    | "trace <route>" | "index": {kernel: launches}}."""
    import numpy as np

    from miniprot_tpu_torch.index import Index
    from miniprot_tpu_torch.options import IdxOpt, MapOpt
    from miniprot_tpu_torch.sysutil import profiler
    from miniprot_tpu_torch.testgen import make_workload
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as d:
        fa, faa = os.path.join(d, "g.fa"), os.path.join(d, "q.faa")
        t0 = time.perf_counter()
        make_workload(fa, faa, genome_len=genome_mb * 1_000_000,
                      n_genes=n_prot, seed=11, n_ctg=N_CTG,
                      max_intron=20_000,
                      rev_frac=0.5, fs_frac=0.1)
        t1 = time.perf_counter()
        mi = Index.build(fa, IdxOpt(), n_threads=threads)
        t2 = time.perf_counter()
        print(f"[e2e] workload {genome_mb} Mb x {n_prot} proteins: "
              f"generated {t1 - t0:.1f} s, index {t2 - t1:.1f} s", flush=True)
        profiler.enabled = True
        k123 = ("track_prep", "ext_dp", "scan_cigar_dp",
                "scan_cigar_dp_small", "run_walk")
        k45 = ("track_prep", "ext_dp", "striped_cigar_dp", "cell_walk")
        gpu = _map(mi, faa, MapOpt(), "cuda", threads, k123)
        host = _map(mi, faa, MapOpt(), None, threads)
        whole = _map(mi, faa, MapOpt(), "cuda", threads, k123, 0)
        os.environ["MINIPROT_TPU_CIG_IMPL"] = "striped"
        try:
            striped = _map(mi, faa, MapOpt(), "cuda", threads, k45)
        finally:
            del os.environ["MINIPROT_TPU_CIG_IMPL"]
        o0 = MapOpt()
        o0.go = 0
        gpu0 = _map(mi, faa, o0, "cuda", threads, k45)
        host0 = _map(mi, faa, o0, None, threads)
        route_launches = phase_route(mi, faa, host["out"], d, threads, k123)
        profiler.enabled = False
        subsets = _subsets(mi, faa, d, threads)
        srv_launches = phase_server(mi, subsets, threads)
        mpi = os.path.join(d, "g.mpi")
        mi.dump(mpi)
        trace_launches = phase_trace(mpi, *subsets[0], d, threads)
        shard_runs, _ = phase_shards(mi, mpi, faa, host["out"], d, threads)
        daemon_runs = phase_daemon(mpi, faa, host["out"], gpu, d, threads)
        mesh_launches = phase_mesh(mi, faa, d, threads)
        mi_gpu, sk_wall, sk_stages, sk_launches = index_build(fa)
    if gpu["out"] != host["out"]:
        fail("GPU engine output differs from the host engine's")
    if gpu["out"].count("\n") < n_prot // 2:
        fail(f"too few output lines: {gpu['out'].count(chr(10))}")
    _report("default", gpu, host, threads)
    if whole["out"] != host["out"]:
        fail("GPU output at PRE_CHUNK 0 differs from the host engine's")
    _report("PRE_CHUNK 0", whole, host, threads)
    if striped["out"] != host["out"]:
        fail("striped-route GPU output differs from the host engine's")
    _report("striped route", striped, host, threads)
    if gpu0["out"] != host0["out"]:
        fail("-O 0 GPU output differs from the host engine's")
    if gpu0["out"].count("\n") < n_prot // 2:
        fail(f"too few -O 0 output lines: {gpu0['out'].count(chr(10))}")
    _report("-O 0", gpu0, host0, threads)
    if not (np.array_equal(mi_gpu.ki, mi.ki) and np.array_equal(mi_gpu.kb,
                                                                mi.kb)):
        fail("the index built with the device sketch differs from the host "
             "index")
    if sk_launches["sketch_orf"] <= 0:
        fail("kernel sketch_orf was not launched by the index build")
    print(f"[e2e index] --gpu-sketch build equal to the host build "
          f"({len(mi.kb)} kmer-block pairs): {sk_wall:.2f} s on the card "
          f"(one process, {sk_launches['sketch_orf']} sketch_orf launches) "
          f"vs {t2 - t1:.1f} s host ({threads} processes); card build "
          + _stages_line(sk_wall, sk_stages), flush=True)
    return {"default": gpu["launches"], "PRE_CHUNK 0": whole["launches"],
            "striped route": striped["launches"], "-O 0": gpu0["launches"],
            "route probe": route_launches, "server": srv_launches,
            **trace_launches, **shard_runs, **daemon_runs,
            "mesh": mesh_launches,
            "index": sk_launches}


def phase_maps(genome_mb, n_prot, threads, pre_chunks):
    """The e2e workload's three GPU maps alone (no host maps, no kernel
    phases), at each PRE_CHUNK of ``pre_chunks``, each with its
    proteins/s, stage split, exposed wait, flush rounds and the
    kernels' device time: the comparison of two trees
    (--package) in one call."""
    from miniprot_tpu_torch.index import Index
    from miniprot_tpu_torch.options import IdxOpt, MapOpt
    from miniprot_tpu_torch.sysutil import profiler
    from miniprot_tpu_torch.testgen import make_workload
    o0 = MapOpt()
    o0.go = 0
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as d:
        fa, faa = os.path.join(d, "g.fa"), os.path.join(d, "q.faa")
        make_workload(fa, faa, genome_len=genome_mb * 1_000_000,
                      n_genes=n_prot, seed=11, n_ctg=N_CTG,
                      max_intron=20_000, rev_frac=0.5, fs_frac=0.1)
        mi = Index.build(fa, IdxOpt(), n_threads=threads)
        # warm-up, not reported: the kernel library's build and the
        # first map's allocations
        _map(mi, faa, MapOpt(), "cuda", threads)
        profiler.enabled = True
        for chunk in pre_chunks:
            for tag, opt, impl in (("default", MapOpt(), None),
                                   ("striped route", MapOpt(), "striped"),
                                   ("-O 0", o0, None)):
                if impl:
                    os.environ["MINIPROT_TPU_CIG_IMPL"] = impl
                try:
                    run = _map(mi, faa, opt, "cuda", threads,
                               pre_chunk=chunk)
                finally:
                    os.environ.pop("MINIPROT_TPU_CIG_IMPL", None)
                busy = sum(run["kernel_ms"].values()) / 1e3
                print(f"[maps {tag}] {run['n'] / run['wall']:.2f} "
                      f"proteins/s ({run['wall']:.2f} s); "
                      + _stage_line(run)
                      + f"; kernels {busy:.3f} s (busy share "
                      f"{busy / run['wall']:.4f}): " + ", ".join(
                          f"{k} {v:.1f} ms"
                          for k, v in sorted(run["kernel_ms"].items())),
                      flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome-mb", type=int, default=200)
    ap.add_argument("--proteins", type=int, default=2000)
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--maps-only", action="store_true",
                    help="only the e2e workload's three GPU maps, each with "
                    "its host seconds inside the batches' launch()")
    ap.add_argument("--index-only", action="store_true",
                    help="only the e2e workload's --gpu-sketch index build, "
                    "twice, each with its stage split")
    ap.add_argument("--pre-chunk", default=None, metavar="N[,N...]",
                    help="with --maps-only: map at each of these PRE_CHUNK "
                    "values (default: the tree's own)")
    ap.add_argument("--package", metavar="DIR",
                    help="import miniprot_tpu_torch from DIR (another "
                    "checkout, e.g. a parent commit's) instead of this one")
    args = ap.parse_args()
    if args.package:
        # the rates above come from this checkout, the rest from DIR
        for m in [m for m in sys.modules
                  if m.split(".")[0] == "miniprot_tpu_torch"]:
            del sys.modules[m]
        sys.path.insert(0, os.path.abspath(args.package))
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if torch.cuda.get_device_capability(0) < (9, 0):
        fail(f"{torch.cuda.get_device_name(0)} is below sm_90")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card_line = (smi.stdout.strip().splitlines() or ["unknown"])[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[card] {card_line}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; {kind} x{count}", flush=True)

    from miniprot_tpu_torch import kernels
    from miniprot_tpu_torch.sysutil import disable_numpy_thp
    disable_numpy_thp()
    if args.maps_only:
        print(f"[maps] miniprot_tpu_torch from "
              f"{os.path.dirname(os.path.dirname(kernels.__file__))}",
              flush=True)
        phase_maps(args.genome_mb, args.proteins, args.threads,
                   [int(v) for v in args.pre_chunk.split(",")]
                   if args.pre_chunk else [None])
        print(f"[done] {time.perf_counter() - t_start:.1f} s")
        return
    if args.index_only:
        print(f"[index] miniprot_tpu_torch from "
              f"{os.path.dirname(os.path.dirname(kernels.__file__))}",
              flush=True)
        phase_index(args.genome_mb, args.proteins)
        print(f"[done] {time.perf_counter() - t_start:.1f} s")
        return
    t0 = time.perf_counter()
    kernels.build(force=True)
    print(f"[build] {kernels.SO} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for ln in kernels.BUILD_LOG.splitlines():
        if ln.startswith("==") or "registers" in ln or "spill" in ln \
                or "entry function" in ln:
            print(f"[ptxas] {ln.strip()}")
    sass_counts(kernels.SO, kernels.BUILD_LOG)
    sass_int16x2_probe()

    # K1 and K7 at K1's batches
    entries = [*phase_ext(128, 2112, 128, 1), *phase_ext(512, 8448, 128, 2),
               *phase_ext(1024, 16896, 512, 6),
               *phase_ext(128, 2112, 128, 13, go=0)]
    entries += phase_scan(128, 4096, 128, 3)
    entries += phase_scan(512, 2048, 128, 4)
    entries += phase_scan(32, 2048, 512, 5, prep=True)
    # the engine's scan batch at W=128 / nl 4096 (device.cig_capacity)
    entries += phase_scan(128, 4096, 512, 14, prep=True)
    probe_ext_capacity(1024, 67584, (128, 512), 15)
    probe_ext_capacity(128, 67584, (128, 1024), 16)
    k2_ms = {e.pop("shape"): e["ms"] for e in entries if "shape" in e}
    # each width's go == 0 and go >= 1 instantiation at K2's shape
    entries += phase_striped(128, 4096, 128, 7, 0, k2_ms)
    entries += phase_striped(512, 2048, 128, 8, 11, k2_ms)
    entries += phase_striped(512, 2048, 128, 18, 0, k2_ms)
    entries += phase_striped(32, 2048, 512, 9, 11, k2_ms)
    entries += phase_striped(32, 2048, 512, 19, 0, k2_ms)
    # the engine's striped batch at W=128 / nl 4096 (device.cig_capacity)
    entries += phase_striped(128, 4096, 512, 17, 11, k2_ms)
    # B4': the shape every PR has timed, its go == 0 form, and the
    # narrowest and widest geometries
    entries.append(phase_dp32(512, 2048, 128, 10))
    entries.append(phase_dp32(512, 2048, 128, 20, go=0))
    entries.append(phase_dp32(128, 1024, 128, 21))
    entries.append(phase_dp32(1024, 4096, 128, 22))
    entries.append(phase_sketch(12, args.genome_mb * 1_000_000 // N_CTG))
    phase_flush_no_sync(23)
    phase_bench()
    runs = phase_e2e(args.genome_mb, args.proteins, args.threads)
    phase_entry()
    for e in entries:
        if "counter" in e:
            # launches: the runs of the paths that take this form (K1 at
            # go 0 only in the -O 0 map, K4/K5 at go 11 only on the
            # striped route); launches_by_path: every path's count
            c = e.pop("counter")
            e["launches"] = sum(runs[p][c] for p in e.pop("paths"))
            e["launches_by_path"] = {p: r[c] for p, r in runs.items()
                                     if r.get(c)}
            if e["launches"] <= 0:
                fail(f"{e['name']}: no launch on the path that runs it")
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys}
                                  for e in entries]}))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except BaseException as e:  # any phase failing fails the run
        import traceback
        traceback.print_exc()
        fail(f"{type(e).__name__}: {e}")
