"""scalce_tpu_torch — the PyTorch + CUDA port of ``scalce_tpu``.

A FASTQ codec: reads are reordered by a locally-consistent core k-mer,
each sequence is coded as a delta against aligned predecessors, and
qualities go through a context-modelled interleaved rANS coder.
Single-end or paired-end (``_1``/``_2`` triplets in pair sync), lossless
or with a lossy quality map, short reads or long (minimizer order on the
host), on one host or several.  Every payload byte equals what
``scalce_tpu`` writes for the same input and Config, so triplets
cross-decode between the two packages.

Layout (counterparts of ``scalce_tpu``'s subpackages):
  ops/        plain torch ops and the kernel wrappers (K1 core_rank,
              K2 hist, K3 rans_encode, K4 rans_decode, K5
              rans_encode_flat, K6 histogram)
  csrc/       the hand-written CUDA kernels (sm_90a), built at first use
  models/     rANS table normalization, the lossy quality map
  streams/    sequence and quality payload codecs
  pipeline/   block encoder/decoder and the compress/decompress drivers
  parallel/   data parallelism over the devices of one host, and over
              hosts (torch.distributed, the ordered merge)
  io/, native/, container, config, utils/
              host modules: copies of the reference's (FASTQ I/O, the
              native C library, the file container, Config, synthetic
              data)
  convert     arrays across the two packages
  cli         ``python -m scalce_tpu_torch``

Importing this package imports neither jax nor anything of
``scalce_tpu``: the host modules it shares with the reference (FASTQ
I/O, container, Config, native library, names codec, synthetic data)
are its own copies.  The device is always explicit: ``"cuda"`` with no
card raises.
"""


def compress(cfg, device):
    """Compress as described by a :class:`scalce_tpu_torch.config.Config`
    on ``device`` (``"cuda"``, ``"cuda:N"`` or ``"cpu"``)."""
    from scalce_tpu_torch.pipeline import driver
    return driver.compress(cfg, device)


def decompress(cfg, device):
    """Decompress as described by a Config on ``device``."""
    from scalce_tpu_torch.pipeline import driver
    return driver.decompress(cfg, device)


__all__ = ["compress", "decompress"]
