"""``repro_torch.imgproc`` — the batched approximate image-processing
workloads on the port's engines (the port of ``repro.imgproc``): eight
operators whose every addition routes through an approximate adder, the
plan compiler (``requant="stage"`` or ``"fused"``), the halo-aware tile
streamer, the workload registry, the corpus runner and the hardened
double-buffered stream executor (``run_streaming``).

    from repro_torch.imgproc import compile_pipeline, run_corpus

    pipe = compile_pipeline(("gaussian_blur", "sharpen", "downsample2x"))
    out = pipe(batch)                         # on the card, uint8 tensor
    rows = run_corpus(backend="torch", device="cpu")
"""

from __future__ import annotations

from repro_torch.imgproc.corpus import (  # noqa: F401
    CorpusResult,
    StreamResult,
    clear_golden_cache,
    format_table,
    run_corpus,
    run_streaming,
    synthetic_batch,
)
from repro_torch.imgproc.ops import (  # noqa: F401
    IMAGE_N_BITS,
    OPERATORS,
    ImageOp,
    QForm,
    blend,
    box_blur,
    brightness,
    downsample2x,
    gaussian_blur,
    get_operator,
    img_add,
    make_image_engine,
    operator_names,
    register_operator,
    sharpen,
    sobel,
)
from repro_torch.imgproc.plan import (  # noqa: F401
    PIPELINES,
    REQUANT_MODES,
    CompiledPipeline,
    compile_pipeline,
    fused_psnr_gate,
    run_pipeline,
)
from repro_torch.imgproc.tiles import (  # noqa: F401
    compile_tiled,
    run_tiled,
)
from repro_torch.imgproc.workloads import (  # noqa: F401
    WORKLOADS,
    Workload,
    get_workload,
    register_workload,
    workload_names,
)
