"""Command-line interface, flag-compatible with the reference tool.

Mirrors main.c:101-219 (option letters, long options, k/M/G number
suffixes, same defaults and derived-option behavior).  Run it as
``python -m miniprot_tpu_torch.cli``; the alignment DPs run on the CUDA
card unless --no-gpu asks for the host engine.
"""

from __future__ import annotations

import os
import sys

from . import MP_VERSION, tables
from .index import Index
from .options import (f32,
                      F_GFF, F_GTF, F_NO_ALIGN, F_NO_CS, F_NO_PAF,
                      F_NO_PRE_CHAIN, F_SHOW_RESIDUE, F_SHOW_TRANS,
                      F_SHOW_UNMAP, IdxOpt, MapOpt)
from .pipeline import map_file


def parse_num(s: str) -> int:
    """k/M/G-suffixed number (mp_parse_num, main.c:36-51)."""
    mult = 1.0
    t = s
    for suf, m in (("G", 1e9), ("g", 1e9), ("M", 1e6), ("m", 1e6), ("K", 1e3), ("k", 1e3)):
        if suf in t:
            idx = t.index(suf)
            t = t[:idx]
            mult = m
            break
    return int(float(t) * mult + 0.499)


USAGE = """Usage: python -m miniprot_tpu_torch.cli [options] <ref.fa> <query.faa> [...]
Options:
  Indexing:
    -k INT       k-mer size [6]
    -M INT       modimisers bit (sample rate = 1/2**M) [1]
    -L INT       min ORF length to index [30]
    -T INT       NCBI translation table (1 through 33) [1]
    -b INT       bits per block [8]
    -d FILE      save index to FILE []
  Mapping:
    -S           no splicing (applying -G1k -J1k -e1k)
    -c NUM       max k-mer occurrence [20000]
    -G NUM       max intron size; override -I [200k]
    -I           set max intron size to 3.6*sqrt(refLen)
    -w FLOAT     weight of log gap penalty [0.75]
    -n NUM       minimum number of syncmers in a chain [3]
    -m NUM       min chaining score [0]
    -l INT       k-mer size for the second round of chaining [5]
    -e NUM       max extension for 2nd round of chaining and alignment [10000]
    -p FLOAT     min secondary-to-primary score ratio [0.7]
    -N NUM       consider at most INT secondary alignments [30]
  Alignment:
    -O INT       gap open penalty [11]
    -E INT       gap extension (a k-long gap costs O+k*E) [1]
    -J INT       intron open penalty [29]
    -F INT       penalty for frameshifts or in-frame stop codons [23]
    -C FLOAT     weight of splice penalty; 0 to ignore splice signals [1]
    -B INT       bonus score for alignment reaching query ends [5]
    -j INT       splice model: 2=vertebrate/insect, 1=general, 0=none [1]
    --spsc=FILE  splice score file in format "ctg offset +|- D|A score" []
    --spsc0=INT  splice score for sites not in --spsc [-7]
  Input/output:
    -t INT       number of threads [4]
    --gff        output in the GFF3 format
    --gtf        basic GTF output without detailed alignment
    --aln        output residue alignment
    --trans      output translated protein sequences (skipping frameshift)
    -P STR       prefix for IDs in GFF3 [MP]
    -u           print unmapped query proteins in PAF
    --outn=NUM   output up to min{NUM,-N} alignments per query [1000]
    --outs=FLOAT output if score at least FLOAT*bestScore [0.99]
    --outc=FLOAT output if at least FLOAT fraction of query is aligned [0.1]
    -K NUM       query batch size [2M]
  GPU-build extensions:
    --gpu        alignment DPs on the CUDA card (the default; fails when
                 no card of compute capability >= 9.0 is present); when
                 a device daemon (python -m miniprot_tpu_torch.daemon)
                 answers at its socket, the DPs go to it and this process
                 never touches the card (MINIPROT_TPU_DAEMON=0: do not
                 use it; MINIPROT_TPU_DAEMON_SOCK names another socket)
    --no-gpu     host engine only
    --gpu-sketch index-build sketching on the CUDA card (equal to the
                 host sketch; fails when no sm_90 card is present)
    --profile    to stderr: each stage's and span's host seconds
                 ([P::name]), the DP cells on the host and the card, the
                 launched problems per DP recurrence, kernel launch counts
    --profile-trace=DIR  write a torch.profiler Chrome trace of the map
                 to DIR/trace.json: host operations, the profiler's
                 spans (map, pump.*, engine.*, ...) as ranges and, on
                 the card, every kernel launch with its device time
    --route-probe  measure the GPU engine against the host engine on the
                 first mini-batch (split A/B, each query mapped once)
                 and keep the faster; a decisive outcome is cached for
                 6h in ~/.cache/miniprot_tpu_torch/route.json
    -o FILE      write output to FILE instead of stdout
    --resume     with -o: checkpoint after each mini-batch and resume an
                 interrupted run from the last complete batch
  Multi-host (data-parallel shards over a shared --spool-dir):
    --shards INT     total number of shard processes [1]
    --shard-id INT   this process's shard index (0 emits the merge) [0]
    --spool-dir DIR  shared directory for shard spools; an existing
                 complete spool is a checkpoint (that shard is skipped),
                 so use a fresh DIR when inputs or options change
"""

_LONG_OPTS = {
    "gpu", "no-gpu", "gpu-sketch", "gff", "gff-only", "gtf", "aln", "trans",
    "no-cs", "no-pre-chain",
    "version", "no-kalloc", "profile", "dbg-qname", "dbg-no-refine",
    "dbg-aflt", "dbg-anchor", "dbg-chain", "resume", "route-probe",
}
_LONG_OPTS_ARG = {
    "xdrop", "outn", "gff-delim", "J2", "outs", "max-skip", "max-intron-out",
    "outc", "ie-coef", "spsc", "spsc0", "spsc-max", "profile-trace",
    "shards", "shard-id", "spool-dir",
}
_SHORT_ARG = "kMLslbTtdcnmKpNOEJCFGegBPwjo"


class _Trace:
    """--profile-trace: a torch.profiler session around the map, written
    as a Chrome trace, with the port's profiler spans turned on so the
    trace holds them.  With a device engine it traces the card too
    (CUDA activity, CUPTI) and write() requires a device event for every
    kernel the map launched; a trace that cannot be started, written
    or that lacks a launched kernel raises with the reason."""

    def __init__(self, trace_dir: str, device):
        from torch.profiler import (ProfilerActivity, profile,
                                    supported_activities)

        from . import kernels, sysutil
        acts = [ProfilerActivity.CPU]
        if device is not None:
            if ProfilerActivity.CUDA not in supported_activities():
                raise RuntimeError(
                    "--profile-trace: this torch build cannot trace the card "
                    "(no CUDA activity in torch.profiler."
                    "supported_activities())")
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        self.path = os.path.join(trace_dir, "trace.json")
        self.before = kernels.launch_counts()
        self.prof = profile(activities=acts)
        self.prof.start()
        self.spans_were = sysutil.profiler.enabled
        sysutil.profiler.enabled = True

    def stop(self) -> None:
        from . import sysutil
        sysutil.profiler.enabled = self.spans_were
        self.prof.stop()

    def write(self) -> None:
        from . import kernels, sysutil
        self.prof.export_chrome_trace(self.path)
        after = kernels.launch_counts()
        launched = {kernels.KERNEL_FUNCTIONS[k] for k, v in after.items()
                    if v > self.before[k]}
        times = kernels.trace_kernel_times(self.path)
        missing = sorted(launched - set(times))
        if missing:
            raise RuntimeError(
                f"--profile-trace: {self.path} holds no device event for "
                f"{', '.join(missing)}, which the map launched")
        sysutil.log("main", "profile trace %s: %s", self.path, "; ".join(
            f"{fn} {n} launches, {ms:.3f} ms on the device"
            for fn, (n, ms) in sorted(times.items())) or "no kernel")


def main(argv: list[str] | None = None) -> int:
    """CLI entry point; returns an exit code."""
    return _run(sys.argv[1:] if argv is None else argv)


def load_for_server(argv: list[str]) -> tuple | int:
    """Parse options and load the index like the CLI, but stop before
    mapping: returns (index, mapopt, n_threads, device) for
    miniprot_tpu_torch.server (device "cuda", or None with --no-gpu),
    or an int exit code on a usage error."""
    return _run(argv, server_parse=True)


def _run(argv: list[str], server_parse: bool = False):
    from .sysutil import disable_numpy_thp
    disable_numpy_thp()
    device = None if "--no-gpu" in argv else "cuda"
    io = IdxOpt()
    mo = MapOpt()
    n_threads = 4
    fn_idx = None
    fn_spsc = None
    fn_out = None
    resume = False
    route_probe = False
    trace_dir = None
    n_shards = 1
    shard_id = 0
    spool_dir = None
    set_I = set_G = keep_io = 0
    pos: list[str] = []
    dbg: dict = {}

    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg == "--":
            pos.extend(argv[i + 1:])
            break
        if arg.startswith("--"):
            body = arg[2:]
            key, _, val = body.partition("=")
            if key in _LONG_OPTS_ARG and not val:
                i += 1
                val = argv[i] if i < len(argv) else ""
            if key == "gff":
                mo.flag |= F_GFF
            elif key == "gff-only":
                mo.flag |= F_GFF | F_NO_PAF
            elif key == "gtf":
                mo.flag |= F_GTF
            elif key == "aln":
                mo.flag |= F_SHOW_RESIDUE
            elif key == "trans":
                mo.flag |= F_SHOW_TRANS
            elif key == "no-cs":
                mo.flag |= F_NO_CS
            elif key == "resume":
                resume = True
            elif key == "route-probe":
                route_probe = True
            elif key == "profile-trace":
                trace_dir = val
            elif key == "no-pre-chain":
                mo.flag |= F_NO_PRE_CHAIN
            elif key == "xdrop":
                mo.xdrop = int(val)
            elif key == "outn":
                mo.out_n = parse_num(val)
            elif key == "outs":
                mo.out_sim = f32(val)
            elif key == "outc":
                mo.out_cov = f32(val)
            elif key == "gff-delim":
                mo.gff_delim = ord(val[0])
            elif key == "J2":
                mo.io_end = int(val)
                keep_io = 1
            elif key == "max-skip":
                mo.max_chn_max_skip = parse_num(val)
            elif key == "max-intron-out":
                mo.max_intron_flank = (parse_num(val) + 1) // 2
            elif key == "ie-coef":
                mo.ie_coef = f32(val)
            elif key == "spsc":
                fn_spsc = val
            elif key == "spsc0":
                s = int(val)
                mo.sp_null_bonus = s if s < 0 else -s
            elif key == "spsc-max":
                mo.sp_max_bonus = int(val)
            elif key == "shards":
                n_shards = int(val)
            elif key == "shard-id":
                shard_id = int(val)
            elif key == "spool-dir":
                spool_dir = val
            elif key == "version":
                print(MP_VERSION)
                return 0
            elif key == "dbg-no-refine":
                dbg["no_refine"] = True
            elif key == "dbg-qname":
                dbg["qname"] = True
            elif key == "dbg-anchor":
                dbg["anchor"] = True
            elif key == "dbg-chain":
                dbg["chain"] = True
            elif key == "dbg-aflt":
                dbg["more_dp"] = True
            elif key == "gpu-sketch":
                dbg["gpu_sketch"] = True
            elif key == "profile":
                from . import sysutil
                sysutil.profiler.enabled = True
            elif key in _LONG_OPTS:
                pass  # accepted no-ops (--no-kalloc etc.)
            else:
                from . import sysutil
                sysutil.warn("unrecognized option: %s", arg)
            i += 1
            continue
        if arg.startswith("-") and len(arg) > 1:
            c = arg[1]
            if c in _SHORT_ARG:
                val = arg[2:] if len(arg) > 2 else argv[i + 1]
                if len(arg) == 2:
                    i += 1
            else:
                val = ""
            if c == "k":
                io.kmer = int(val)
            elif c == "M":
                io.mod_bit = int(val)
            elif c == "L":
                io.min_aa_len = int(val)
            elif c == "b":
                io.bbit = int(val)
            elif c == "T":
                io.trans_code = int(val)
            elif c == "d":
                fn_idx = val
            elif c == "t":
                n_threads = int(val)
            elif c == "l":
                mo.kmer2 = int(val)
            elif c == "c":
                mo.max_occ = parse_num(val)
            elif c == "G":
                mo.bw = mo.max_intron = parse_num(val)
                set_G = 1
            elif c == "I":
                set_I = 1
            elif c == "n":
                mo.min_chn_cnt = parse_num(val)
            elif c == "m":
                mo.min_chn_sc = parse_num(val)
            elif c == "K":
                mo.mini_batch_size = parse_num(val)
            elif c == "p":
                mo.pri_ratio = f32(val)
            elif c == "N":
                mo.best_n = parse_num(val)
            elif c == "S":
                mo.set_no_splice()
                set_G = 1
            elif c == "A":
                mo.flag |= F_NO_ALIGN
            elif c == "O":
                mo.go = int(val)
            elif c == "E":
                mo.ge = int(val)
            elif c == "J":
                mo.io = int(val)
                keep_io = 1
            elif c == "C":
                mo.sp_scale = f32(val)
            elif c == "F":
                mo.set_fs(int(val))
            elif c == "B":
                mo.end_bonus = int(val)
            elif c == "e":
                mo.max_ext = parse_num(val)
            elif c == "o":
                fn_out = val
            elif c == "P":
                mo.gff_prefix = val
            elif c == "u":
                mo.flag |= F_SHOW_UNMAP
            elif c == "w":
                mo.chn_coef_log = f32(val)
            elif c == "j":
                mo.sp_model = int(val)
            elif c == "g":
                mo.max_gap = parse_num(val)
            elif c == "s":
                print("Option '-s' is deprecated.", file=sys.stderr)
            else:
                from . import sysutil
                sysutil.warn("unrecognized option: %s", arg)
            i += 1
            continue
        pos.append(arg)
        i += 1

    try:
        mo.check()
    except ValueError as ex:
        from . import sysutil
        sysutil.error("%s", ex)
        return 1
    if route_probe and device is None:
        from . import sysutil
        sysutil.error("--route-probe measures the GPU engine against the "
                      "host engine: it cannot be used with --no-gpu")
        return 1
    sharded = n_shards > 1 or spool_dir is not None
    if server_parse and (route_probe or trace_dir is not None or sharded):
        from . import sysutil
        sysutil.error("--route-probe, --profile-trace and --shards apply "
                      "to a map run, not to the server")
        return 1
    if sharded and (route_probe or trace_dir is not None):
        from . import sysutil
        sysutil.error("--route-probe and --profile-trace apply to a "
                      "single-process map, not to --shards")
        return 1
    if not pos or (len(pos) == 1 and fn_idx is None and not server_parse):
        sys.stderr.write(USAGE)
        return 1
    try:
        tables.get_tables(io.trans_code)
    except ValueError:
        from . import sysutil
        sysutil.error("failed to find translation table %d", io.trans_code)
        return 1

    mi = Index.load(pos[0], io, n_threads=n_threads,
                    sketch_device="cuda" if dbg.get("gpu_sketch") else None)
    if set_I and not set_G:
        mo.set_max_intron(mi.nt.l_seq)
    if fn_idx is not None:
        mi.dump(fn_idx)
    if fn_spsc is not None:
        # mp_set_spsc (index.c:239-248)
        if not keep_io:
            mo.io += 10
            mo.io_end += 10
        max_sc = (mo.io + 1) // 2 - 1
        max_sc = min(max_sc, mo.io - mo.go, mo.sp_max_bonus)
        mi.nt.read_spsc(fn_spsc, max_sc)
    if len(pos) > 1:
        from . import sysutil
        sysutil.log("main", mi.print_stat(mo.max_occ))
    if server_parse:  # miniprot_tpu_torch.server: the loaded state
        return mi, mo, n_threads, device
    out = sys.stdout
    ckpt = None
    if sharded:
        # multi-process data-parallel run (parallel/runner.py): each
        # shard is an independent CLI process over a shared --spool-dir
        # mapping on the same device as a plain run; the shard-0 process
        # performs the ordered k-way merge emit.
        from . import sysutil
        if spool_dir is None:
            sysutil.error("--shards requires --spool-dir")
            return 1
        if not 0 <= shard_id < n_shards:
            sysutil.error("--shard-id must be in [0, --shards)")
            return 1
        if len(pos) != 2:
            sysutil.error("--shards supports exactly one query file")
            return 1
        if resume:
            sysutil.error("--shards uses spool files as checkpoints; "
                          "rerun failed shards instead of --resume")
            return 1
        os.makedirs(spool_dir, exist_ok=True)
        if fn_out is not None and shard_id == 0:
            out = open(fn_out, "w")
        from .parallel.runner import map_file_multihost
        try:
            map_file_multihost(mi, pos[1], mo, shard_id, n_shards,
                               spool_dir, out, resume=True, device=device,
                               n_threads=n_threads)
        finally:
            if out is not sys.stdout:
                out.close()
        sysutil.log("main", "Real time: %.3f sec; CPU: %.3f sec; "
                    "Peak RSS: %.3f GB", sysutil.realtime(),
                    sysutil.cputime(), sysutil.peakrss_gb())
        sysutil.profiler.report()
        return 0
    if resume and fn_out is None:
        from . import sysutil
        sysutil.error("--resume requires -o FILE")
        return 1
    if resume and len(pos) > 2:
        from . import sysutil
        sysutil.error("--resume supports a single query file")
        return 1
    if fn_out is not None:
        mode = "r+" if resume and os.path.exists(fn_out) else "w"
        out = open(fn_out, mode)
        if resume:
            ckpt = fn_out + ".ckpt"
            if mode == "w" and os.path.exists(ckpt):
                os.remove(ckpt)  # stale journal without its output file
    trace = None
    if trace_dir is not None:
        trace = _Trace(trace_dir, device)
    try:
        for fn in pos[1:]:
            map_file(mi, fn, mo, n_threads, out=out, device=device, dbg=dbg,
                     ckpt=ckpt, route_probe=route_probe)
    finally:
        if out is not sys.stdout:
            out.close()
        if trace is not None:
            trace.stop()
    if trace is not None:
        trace.write()
    from . import sysutil
    from . import MP_VERSION as _V
    sysutil.log("main", "Version: %s (miniprot_tpu_torch %s)", _V,
                __import__("miniprot_tpu_torch").__version__)
    sysutil.log("main", "CMD: python -m miniprot_tpu_torch.cli %s",
                " ".join(argv))
    sysutil.log("main", "Real time: %.3f sec; CPU: %.3f sec; Peak RSS: %.3f GB",
                sysutil.realtime(), sysutil.cputime(), sysutil.peakrss_gb())
    sysutil.profiler.report()
    return 0


if __name__ == "__main__":
    sys.exit(main())
