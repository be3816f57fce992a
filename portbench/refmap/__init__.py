"""The benchmark's plain reference: a frozen copy of the port's host
path (index build, seed, chain, refine, the host C DP engine, format),
changed only in its imports and trimmed to what a map on the host needs.

It imports nothing of the port, of the JAX package or of JAX, and
takes nothing the port made: it reads the generated FASTA files and
builds its own index.  Later changes to the port's host front are held
against this copy, so it stays as it is.
"""
