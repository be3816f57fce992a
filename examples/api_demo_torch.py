"""Minimal API consumer of the PyTorch port (the GPU variant of
examples/api_demo.py): each mini-batch of queries is mapped with its
alignment DPs batched onto the CUDA kernels (a GpuExtEngine and
pipeline.map_batch_gpu), and every region is printed with the same
fields as the JAX demo.

Usage: python examples/api_demo_torch.py [--cpu] genome.fa[.gz]|index.mpi proteins.faa[.gz]

--cpu runs the same engine on the kernels' plain PyTorch versions.
"""

import os
import sys

try:
    import miniprot_tpu_torch  # noqa: F401  (installed package)
except ModuleNotFoundError:  # running from a source checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from miniprot_tpu_torch.align import DpEnv
from miniprot_tpu_torch.bseq import BatchReader
from miniprot_tpu_torch.device import GpuExtEngine
from miniprot_tpu_torch.index import Index
from miniprot_tpu_torch.options import IdxOpt, MapOpt
from miniprot_tpu_torch.pipeline import map_batch_gpu


def main() -> int:
    args = sys.argv[1:]
    device = "cuda"
    if args[:1] == ["--cpu"]:
        device, args = "cpu", args[1:]
    if len(args) < 2:
        print(__doc__.strip(), file=sys.stderr)
        return 1
    idx = Index.load(args[0], IdxOpt())
    opt = MapOpt()
    engine = GpuExtEngine(opt, device)
    env = DpEnv(opt)
    reader = BatchReader(args[1])
    while True:
        batch = reader.read_batch(opt.mini_batch_size)
        if not batch:
            break
        for rec, _, regs in map_batch_gpu(idx, opt, env, engine, batch):
            for r in regs:
                ctg = idx.nt.ctg[r.vid >> 1]
                print(rec.name, len(rec.seq), r.qs, r.qe, "+-"[r.vid & 1],
                      ctg.name, r.vs, r.ve, r.p.dp_max if r.p else r.chn_sc,
                      sep="\t")
    return 0


if __name__ == "__main__":
    sys.exit(main())
