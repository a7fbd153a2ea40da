"""phyngsc_tpu — GPU-accelerated FASTQ compression framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of pcdslab/PHYNGSC
(hybrid MPI+OpenMP DSRC-v1-style FASTQ compressor). See
DESIGN.md for the architecture and SURVEY.md for the reference component map.
"""

from phyngsc_tpu.config import CodecConfig

__version__ = "0.1.0"

__all__ = ["CodecConfig", "__version__"]
