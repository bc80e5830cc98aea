"""``repro_torch`` — the PyTorch/CUDA port of the HALOC-AxA system.

A second package beside the JAX reference ``repro``: the same adder
family, fixed-point engine and image-processing pipelines, written in
PyTorch, with every Pallas kernel of the ported path replaced by a
hand-written CUDA kernel for Hopper (``sm_90a``), each beside its plain
PyTorch version.  It imports ``torch``, numpy and scipy only — never jax
and nothing of ``repro``.

Entry points run on the card by default (``backend="cuda"`` on
``torch.device("cuda")``); ask for the CPU with ``backend="torch",
device="cpu"``.

    from repro_torch.imgproc import compile_pipeline, synthetic_batch

    pipe = compile_pipeline(("gaussian_blur", "sharpen", "downsample2x"),
                            kind="haloc_axa")
    out = pipe(synthetic_batch(4, 1024))      # uint8 tensor on the card
"""

from repro_torch.ax import (  # noqa: F401
    AxEngine,
    FilterStage,
    get_backend,
    make_engine,
    register_adder,
)
from repro_torch.core.specs import AdderSpec  # noqa: F401
from repro_torch.numerics.fixed_point import FixedPointFormat  # noqa: F401
