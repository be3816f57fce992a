#!/usr/bin/env python3
"""Smoke run of the PyTorch port (miniprot_tpu_torch) on one NVIDIA
Hopper card: builds the CUDA kernels from this checkout, holds each one
against its plain PyTorch version and the host C engine at main-path
shapes, times it, then maps a whole-genome-scale synthetic workload on
the card and on the host engine and requires byte-identical output.

    python3 chip_smoke.py [--genome-mb 200] [--proteins 2000] [--threads N]

Phases (any failure exits non-zero and prints no result):
  1. the card: nvidia-smi name and power limit; CUDA and sm_90 required
  2. build: nvcc for sm_90a, the -Xptxas -v register and spill lines
  3. kernels: K1 ext_dp (al 128/512/1024), K2 scan_cigar_dp (al<=512
     and al<=32 classes),
     K3 run_walk — exact equality with the plain versions on the card
     and with native.dp16 per problem; time, cells, GCUPS, bound
  4. end to end: testgen's 200 Mb x 2000-protein workload mapped with
     the GPU engine and the host engine, byte-identical, device cell
     fraction >= 0.90, every kernel launched on that run; the kernels'
     device time on that run (CUDA events around each launch)
  5. the last line: {"ok": true, "device": {...}}

The lines before the last carry a {"kernels": [...]} JSON object and
the nvidia-smi card line.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks used for bound_ms: HBM3 bandwidth (NVIDIA data sheet);
# the int32 rate of the CUDA cores, 132 SMs x 64 int32 lanes x 1.98 GHz
# boost (Hopper architecture white paper); and the int16 rate: two int16
# lanes per int32 lane (int16x2), with a DPX fused add+max counted as
# two operations per lane, so 4x the int32 rate.
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
SRC = "miniprot_tpu_torch/kernels/csrc/"


def fail(msg: str) -> None:
    sys.stderr.write(f"chip_smoke: FAIL: {msg}\n")
    sys.exit(1)


def bound(nbytes: float, ops: float, rate: float) -> tuple[float, str]:
    """(ms, what binds): the larger of bytes over the memory rate and
    operations over ``rate``."""
    tb, to = nbytes / MEM_BYTES_PER_S, ops / rate
    return (1e3 * max(tb, to), "bytes" if tb >= to else "operations")


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


def homolog(rng, T, al, nl):
    """(nsq, asq): a protein and a genome window that spells it in
    codons with 10% substituted codons, followed by random sequence."""
    import numpy as np
    asq = rng.choice(np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8), al)
    rev = np.full(22, -1, np.int64)
    for c in range(63, -1, -1):
        rev[T.codon[c]] = c
    cod = rev[T.aa20[asq]]
    mut = rng.random(al) < 0.1
    cod[mut] = rng.integers(0, 64, int(mut.sum()))
    nt4 = np.stack([(cod >> 4) & 3, (cod >> 2) & 3, cod & 3], 1).reshape(-1)
    tail = rng.integers(0, 4, max(0, nl - len(nt4)))
    nt4 = np.concatenate([nt4, tail])[:nl]
    return np.frombuffer(b"ACGT", np.uint8)[nt4].copy(), asq.copy()


def phase_ext(al_pad, nl_pad, n, seed):
    import numpy as np
    import torch

    from miniprot_tpu_torch import native
    from miniprot_tpu_torch.kernels import nasw_ext as ne
    from miniprot_tpu_torch.native import DPF_EXT_LEFT, DPF_EXT_RIGHT
    opt, env, scal, T, kw = scoring()
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    batch = ne.RawExtBatch(al_pad, nl_pad, opt.mat, scal, sp=env.sp,
                           device=dev, capacity=n)
    cases = []
    for _ in range(n):
        al = int(rng.integers(al_pad // 2, al_pad + 1))
        nl = int(rng.integers(nl_pad // 2, nl_pad + 1))
        nsq, asq = homolog(rng, T, al, nl)
        left = bool(rng.integers(0, 2))
        nt4, aas = T.nt4[nsq], T.aa20[asq]
        if left:
            nt4, aas = nt4[::-1], aas[::-1]
        batch.add_raw(nt4, aas, io=opt.io, ext_left=left)
        cases.append((nsq, asq, left))
    thr = ne._logpen_thresholds(float(np.float32(opt.ie_coef)), batch.nl)
    als = ne._upload(batch.als[:n], dev)
    nlv = ne._upload(batch.nlv[:n], dev)
    nas, D, A = ne._prep_seq_device(
        ne._upload(batch.nt[:n], dev), ne._upload(batch.leftb[:n], dev),
        ne._upload(batch.iov[:n], dev), nlv, sp=batch.sp, codon=T.codon,
        n_rows=batch.nl)
    logpen = ne._logpen_device(als, thr, batch.nl, dev)
    args = (nas, D, A, logpen, nlv, als, ne._upload(batch.prof[:n], dev),
            ne._opts(batch))
    got = ne.ext_dp(*args)
    rows = torch.zeros(n, dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    want = ne.ext_dp_plain(*args, rows_done=rows)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    if not torch.equal(got, want):
        fail(f"ext_dp al={al_pad} nl={nl_pad}: kernel != plain version")
    res = batch.collect(got)
    for (nsq, asq, left), r in zip(cases, res):
        ref = native.dp16(nsq, asq, flag=DPF_EXT_LEFT if left
                          else DPF_EXT_RIGHT, **kw)[:3]
        if tuple(ref) != r:
            fail(f"ext_dp al={al_pad}: {r} != host engine {tuple(ref)}")
    ms = time_ms(lambda: ne.ext_dp(*args), reps=10)
    row_sum = int(rows.sum())
    cells = row_sum * al_pad
    nbytes = row_sum * (1 + 4 + 4 + 4 + 4) + n * (22 * al_pad + 12)
    bms, by = bound(nbytes, cells * K1_OPS_PER_CELL, INT16_OPS_PER_S)
    print(f"[K1 ext_dp] al={al_pad} nl={nl_pad} n={n}: exact vs plain and "
          f"host engine; {ms:.3f} ms, {cells} cells ({row_sum} rows run), "
          f"{cells / ms / 1e6:.2f} GCUPS; plain {plain_ms:.1f} ms; "
          f"bound {bms:.4f} ms ({by})", flush=True)
    return dict(name=f"ext_dp[al={al_pad},nl={nl_pad}]", route="cuda",
                source=SRC + "ext_dp.cu",
                replaces="miniprot_tpu/kernels/nasw_pallas.py:89",
                counter="ext_dp", max_abs_err=0, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=None)


def phase_scan(W, nl_pad, n, seed):
    import numpy as np
    import torch

    from miniprot_tpu_torch import native
    from miniprot_tpu_torch.kernels import nasw_cigar_scan as sk
    from miniprot_tpu_torch.kernels import nasw_ext as ne
    from miniprot_tpu_torch.native import DPF_CIGAR
    opt, env, scal, T, kw = scoring()
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    cls = sk.SmallScanCigarBatch if W <= sk.SMALL_W else sk.RawScanCigarBatch
    batch = cls(W, nl_pad, opt.mat, scal, sp=env.sp, device=dev)
    cases = []
    al_lo = 1 if W <= sk.SMALL_W else W // 4 + 1
    for _ in range(n):
        al = int(rng.integers(al_lo, W + 1))
        nl = int(rng.integers(nl_pad // 2, nl_pad + 1))
        nsq, asq = homolog(rng, T, al, nl)
        batch.add_raw(T.nt4[nsq], T.aa20[asq], io=opt.io)
        cases.append((nsq, asq))
    R = batch._rows()
    nlv = ne._upload(batch.nlv[:n], dev)
    alv = ne._upload(batch.alv[:n], dev)
    nas, D, A = ne._prep_seq_device(
        ne._upload(batch.nt[:n, :R + 8], dev),
        torch.zeros(n, dtype=torch.int8, device=dev),
        ne._upload(batch.iov[:n], dev), nlv, sp=batch.sp, codon=T.codon,
        n_rows=R)
    args = (nas, D, A, nlv, alv, ne._upload(batch.prof[:n], dev),
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
    ms = time_ms(lambda: sk.scan_cigar_dp(*args), reps=5)
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
    tag = f"W={W},nl={nl_pad}"
    print(f"[K2 scan_cigar_dp] W={W} nl={nl_pad} n={n}: exact vs plain and "
          f"host engine; {ms:.3f} ms, {cells} cells, "
          f"{cells / ms / 1e6:.2f} GCUPS; plain {plain_ms:.1f} ms; "
          f"bound {bms:.4f} ms ({by})", flush=True)
    print(f"[K3 run_walk] W={W} n={n}: exact vs plain; {walk_ms:.3f} ms for "
          f"{steps} rounds; plain {walk_plain_ms:.1f} ms; bound "
          f"{wbms:.5f} ms ({wby})", flush=True)
    k2 = "scan_cigar_dp_small" if small else "scan_cigar_dp"
    return [dict(name=f"{k2}[{tag}]", route="cuda",
                 source=SRC + "scan_cigar.cu",
                 replaces="miniprot_tpu/kernels/nasw_cigar_scan.py:111",
                 counter=k2, max_abs_err=0, ms=ms, plain_ms=plain_ms,
                 bound_ms=bms, bound_by=by, library_ms=None),
            dict(name=f"run_walk[{tag}]", route="cuda",
                 source=SRC + "run_walk.cu",
                 replaces="miniprot_tpu/kernels/nasw_cigar_scan.py:458",
                 counter="run_walk", max_abs_err=0, ms=walk_ms,
                 plain_ms=walk_plain_ms, bound_ms=wbms, bound_by=wby,
                 library_ms=None)]


def phase_e2e(genome_mb, n_prot, threads):
    from miniprot_tpu_torch import kernels
    from miniprot_tpu_torch.index import Index
    from miniprot_tpu_torch.options import IdxOpt, MapOpt
    from miniprot_tpu_torch.pipeline import map_file
    from miniprot_tpu_torch.sysutil import profiler
    from miniprot_tpu_torch.testgen import make_workload
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as d:
        fa, faa = os.path.join(d, "g.fa"), os.path.join(d, "q.faa")
        t0 = time.perf_counter()
        make_workload(fa, faa, genome_len=genome_mb * 1_000_000,
                      n_genes=n_prot, seed=11, n_ctg=4, max_intron=20_000,
                      rev_frac=0.5, fs_frac=0.1)
        t1 = time.perf_counter()
        mi = Index.build(fa, IdxOpt(), n_threads=threads)
        t2 = time.perf_counter()
        print(f"[e2e] workload {genome_mb} Mb x {n_prot} proteins: "
              f"generated {t1 - t0:.1f} s, index {t2 - t1:.1f} s", flush=True)
        runs = {}
        profiler.enabled = True
        for name, device in (("gpu", "cuda"), ("host", None)):
            profiler.reset()
            kernels.reset_launch_counts()
            buf, stats = io.StringIO(), {}
            with kernels.timed_launches() as kernel_ms:
                t0 = time.perf_counter()
                n = map_file(mi, faa, MapOpt(), n_threads=threads, out=buf,
                             device=device, stats=stats)
                wall = time.perf_counter() - t0
            runs[name] = (buf.getvalue(), wall, n, stats,
                          kernels.launch_counts(), kernel_ms)
            if device is not None:
                stages = dict(profiler.stages)
                blocked = profiler.device_blocked_s
                rounds = profiler.flush_rounds
        profiler.enabled = False
        gpu_out, gpu_wall, n, stats, launches, kernel_ms = runs["gpu"]
        host_out, host_wall, _, _, host_launches, _ = runs["host"]
    if gpu_out != host_out:
        fail("GPU engine output differs from the host engine's")
    if gpu_out.count("\n") < n_prot // 2:
        fail(f"too few output lines: {gpu_out.count(chr(10))}")
    frac = stats["device_fraction"]
    print(f"[e2e] byte-identical PAF ({gpu_out.count(chr(10))} lines); "
          f"GPU engine {n / gpu_wall:.2f} proteins/s ({gpu_wall:.2f} s), "
          f"host engine {n / host_wall:.2f} proteins/s ({host_wall:.2f} s), "
          f"{threads} threads; device cell fraction {frac:.4f}; "
          f"DP calls {stats['n_device']} device / {stats['n_host']} host; "
          f"batches {stats['batches']}; launches {launches}", flush=True)
    print("[e2e] batches per bucket (kind, width, nl bucket): "
          + ", ".join(f"{k}x{w}x{b} {v}" for (k, w, b), v
                      in sorted(stats["bucket_batches"].items())),
          flush=True)
    if any(host_launches.values()):
        fail(f"the host engine run launched kernels: {host_launches}")
    busy = sum(kernel_ms.values()) / 1e3
    print(f"[e2e] K1-K3 device time in the GPU map: "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(kernel_ms.items()))
          + f"; {busy:.3f} s of {gpu_wall:.2f} s "
          f"(kernel busy share {busy / gpu_wall:.4f})", flush=True)
    print("[e2e] GPU map stages (host wall s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(stages.items()))
          + f"; in collects (sync + decode) {blocked:.3f}; "
          f"{rounds} flush rounds", flush=True)
    if frac < 0.90:
        fail(f"device cell fraction {frac:.4f} < 0.90")
    for k, v in launches.items():
        if v <= 0:
            fail(f"kernel {k} was not launched on the main path")
    return launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome-mb", type=int, default=200)
    ap.add_argument("--proteins", type=int, default=2000)
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 1)
    args = ap.parse_args()
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
    t0 = time.perf_counter()
    kernels.build(force=True)
    print(f"[build] {kernels.SO} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for ln in kernels.BUILD_LOG.splitlines():
        if ln.startswith("==") or "registers" in ln or "spill" in ln \
                or "entry function" in ln:
            print(f"[ptxas] {ln.strip()}")

    entries = [phase_ext(128, 2112, 128, 1), phase_ext(512, 8448, 128, 2),
               phase_ext(1024, 16896, 512, 6)]
    entries += phase_scan(128, 4096, 128, 3)
    entries += phase_scan(512, 2048, 128, 4)
    entries += phase_scan(32, 2048, 512, 5)
    launches = phase_e2e(args.genome_mb, args.proteins, args.threads)
    for e in entries:
        e["launches"] = launches[e.pop("counter")]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
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
