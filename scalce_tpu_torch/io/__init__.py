# Copy of scalce_tpu/io/__init__.py (only the imports differ).
"""Host-side I/O: FASTQ parse/write and generic byte-stream backends."""

from scalce_tpu_torch.io.fastq import (  # noqa: F401
    ReadBlock,
    iter_blocks,
    iter_paired_blocks,
    write_fastq_records,
    BASE_TO_CODE,
    CODE_TO_BASE,
)
from scalce_tpu_torch.io.backend import compress_bytes, decompress_bytes  # noqa: F401
