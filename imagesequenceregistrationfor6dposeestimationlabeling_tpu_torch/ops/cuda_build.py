"""Builds the package's CUDA kernels (``ops/csrc``) at first use.

One ``torch.utils.cpp_extension.load`` call compiles every kernel for
``sm_90a`` into ``.kernel_build/`` at the repository root (git-ignored).
The binding file includes only pybind11 and passes raw device pointers:
the Python wrappers check device, dtype, shape and contiguity, allocate
the outputs and hand over ``data_ptr()`` and the current stream of the
inputs' device, and launch under that device (``launch``), so a kernel runs on
any card of a mesh whatever the current device is.  Keeping
PyTorch's headers out of every source keeps the build to seconds.  The
``.cu`` files include only CUDA's and c10's CUDA error headers.

Nothing is built or imported while this module is imported.
"""

from __future__ import annotations

import contextlib
import functools
import os

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(_HERE, "csrc", f) for f in ("bindings.cpp", "density.cu", "nn_min.cu", "corr_argmax.cu",
                                                        "bundle_loss.cu", "field_color.cu", "field_tc.cu")]
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), ".kernel_build")
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17"]


@functools.lru_cache(maxsize=1)
def kernels():
    """The compiled extension module (built on the first call)."""
    from torch.utils.cpp_extension import load

    os.makedirs(BUILD_DIR, exist_ok=True)
    return load(
        name="isr_torch_kernels",
        sources=SOURCES,
        build_directory=BUILD_DIR,
        extra_cflags=["-O2", "-std=c++17"],
        extra_cuda_cflags=CUDA_FLAGS,
        verbose=False,
    )


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device`` as an integer handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def count(wrapper, device, name: str | None = None) -> None:
    """One launch of ``wrapper``'s kernel on ``device``: its total
    (``wrapper.launches``), its count per device index
    (``wrapper.per_device``) and per launch name (``wrapper.by_name``: a
    wrapper whose kernel has variants launches each under its own name)."""
    wrapper.launches += 1
    wrapper.per_device[device.index] = wrapper.per_device.get(device.index, 0) + 1
    if name is not None:
        wrapper.by_name[name] = wrapper.by_name.get(name, 0) + 1


@contextlib.contextmanager
def launch(wrapper, name: str, device):
    """The context of one launch of ``wrapper``'s kernel for tensors on
    ``device``: that device current, for the launch itself and for the
    launcher's attribute calls (dynamic shared memory limits are set per
    device); the program's span ``kernel.<name>`` around the launch; and
    the launch counted (``count``, under ``name`` too) once it returns."""
    import torch

    from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.utils import profiling

    with torch.cuda.device(device), profiling.span("kernel." + name):
        yield
    count(wrapper, device, name)


def reset(wrapper) -> None:
    """Set ``wrapper``'s launch counts to 0."""
    wrapper.launches = 0
    wrapper.per_device = {}
    wrapper.by_name = {}


def check(t, name: str, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` CUDA tensor of ``shape``
    on ``device`` (None in ``shape`` matches any size)."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
