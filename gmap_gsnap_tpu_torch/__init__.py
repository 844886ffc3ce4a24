"""gmap_gsnap_tpu_torch: the PyTorch + CUDA port of gmap_gsnap_tpu.

The JAX package ``gmap_gsnap_tpu`` is the reference; this package
mirrors its layout and is held to its exact outputs.  It imports
``torch`` and never ``jax``, and nothing of the JAX package: the
host-only modules it needs from there (``io``, ``db``, ``utils.dna``,
``native``, ``align.rescue``, the maxent tables under ``data/``) are
copied here.

Layer map:
  utils/    device choice and seeding (counterpart of utils/jaxenv.py),
            DNA coding, synthetic genomes and reads
  kernels/  build + ctypes binding of the hand-written CUDA kernels
  csrc/     the CUDA C++ sources (sm_90a)
  ops/      genome words, the mismatch kernel, maxent, the banded
            dynamic programming of GMAP's junctions
  align/    GSNAP seed -> vote -> verify -> indels/splices -> rank ->
            pair, the GMAP engine and its rescue lanes, and the host
            runner (FASTQ -> SAM)
  db/       database loader and device containers, the IIT reader and
            writer, known splice sites, the SNP-tolerant index and the
            cmet/atoi converted indexes
  io/       FASTA/FASTQ input, SAM output
  native/   C host loops (gamma offsets, SAM lines), built with cc
  cli/      ``python -m gmap_gsnap_tpu_torch.cli.gsnap``, ``cli.cmetindex``,
            ``cli.atoiindex``
  convert   JAX-package state (as numpy arrays) -> port containers

GSNAP single-end and paired-end, standard, cmet-stranded and
atoi-stranded mode, ``-N 0`` / ``-N 1``, known splice sites (``-s``) and
SNP-tolerant alignment (``-v``), with the default GMAP rescue lanes,
exist so far; ROADMAP.md lists what is still to be ported.
"""

__version__ = "0.1.0"
