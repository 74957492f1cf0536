"""PyTorch / CUDA port of the image-sequence registration pipeline.

The JAX package ``imagesequenceregistrationfor6dposeestimationlabeling_tpu``
is the reference; this package mirrors its layout module by module.  Plain
tensor code is PyTorch; the Pallas TPU kernels are hand-written CUDA C++
kernels for Hopper (``ops/csrc``), each beside a plain PyTorch version that
the CPU path and the tests use.

The package imports no module of the reference: it keeps its own copies of
the config dataclasses (``config``), the artifact reader and writer
(``pipeline.artifacts``) and marching tetrahedra (``ops.mcubes`` with its
C++ library in ``native``), which the tests hold equal to the reference's.
Entry points run on the card unless the caller passes a device
(``device.resolve``).
"""

__version__ = "0.1.0"
