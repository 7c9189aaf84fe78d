"""ema_tpu — a JAX linked-read alignment engine for NVIDIA GPUs.

A from-scratch reimplementation of the capabilities of EMA
(https://github.com/arshajii/ema): barcode counting and Hamming-2 correction,
FM-index seeding, banded Smith-Waterman extension, and the barcode-cloud
latent-variable EM model for rescoring candidate alignments of linked reads
(10x Chromium, haplotagging, TELL-seq, DBS, CPT-seq, TruSeq SLR).

Architecture (batched, not a port):
  - host C++ (``ema_tpu.native``): suffix-array construction (SA-IS), SMEM
    seeding, banded alignment traceback -> CIGAR, hot string codecs.
  - JAX/XLA on the device: batched banded Smith-Waterman scoring, FM-index
    rank queries / seeding / locate, and the batched cloud EM.
  - jax.sharding / shard_map over a device mesh for scale-out (the reference
    scales by GNU-parallel over bucket files; we shard read batches over
    devices and barcode buckets over hosts).

See SURVEY.md at the repo root for the structural analysis of the reference
this build follows.
"""

__version__ = "0.1.0"
