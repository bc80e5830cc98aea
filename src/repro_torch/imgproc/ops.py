"""Batched approximate image operators on the port's engines (the port of
``repro.imgproc.ops``).

Each operator is the fixed-point dataflow an image-processing ASIC built
from the paper's adders would run: pixels are quantized to a Q16.f
format (the paper's Fig-4 instance N=16, m=8, k=4), filter taps are
applied as *exact* integer multiplies, and **every addition** routes
through one :class:`~repro_torch.ax.engine.AxEngine` dispatch via the
fused multi-operand ``accumulate_signed`` / ``scaled_add`` /
``filter_chain`` primitives (one CUDA kernel launch per separable chain
on the ``"cuda"`` backend).

Operators accept ``(..., H, W)`` images in [0, 255] (uint8 arrays or
tensors); leading batch dims are free — the batch is written out, no
``vmap``.  They return uint8 tensors on the engine's device.  Ideal
float references live in :mod:`repro_torch.imgproc.reference`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.ax.backends import FilterStage
from repro_torch.ax.engine import AxEngine, make_engine
from repro_torch.core.specs import AdderSpec
from repro_torch.imgproc import reference
from repro_torch.numerics.fixed_point import FixedPointFormat, quantize

#: Default image datapath width: the paper's N=16 (m=8, k=4) instance.
IMAGE_N_BITS = 16

_F_ADD = 6     # Q16.6: |a + b| <= 510        -> 510 * 64  = 32640 < 2^15
_F_SEP = 3     # Q16.3: 3x3 box sum <= 2295   -> 2295 * 8  = 18360 < 2^15
_F_SOBEL = 2   # Q16.2: |smoothed diff| <= 2040 -> 2040 * 4 * 2 = 16320
_F_DOWN = 4    # Q16.4: 2x2 sum <= 1020       -> 1020 * 16 = 16320 < 2^15
_F_BRIGHT = 2  # Q16.2: coarse split so the LSM error is not sub-LSB
_ALPHA_BITS = 6


def make_image_engine(kind: Union[str, AdderSpec] = "haloc_axa",
                      backend=None, fast: bool = False,
                      n_bits: int = IMAGE_N_BITS,
                      strategy: Optional[str] = None,
                      device=None, fault=None) -> AxEngine:
    """Engine for the image datapath (on the card unless ``device`` and
    ``backend`` say otherwise).

    A bare kind name gets the paper's scaled partition at ``n_bits``
    (m = n/2, k = m/2 — the Fig-4 example at N=16).  The format's
    fractional split is re-derived per operator, so only the width
    matters here.  ``fault`` injects a hardware defect
    (:class:`repro_torch.resilience.faults.FaultSpec`) into every adder
    output bus, validated against the datapath width."""
    if isinstance(kind, AdderSpec):
        n_bits = kind.n_bits
    if not (2 <= n_bits <= 30):
        raise ValueError(
            f"the imgproc datapath runs in int32 fixed-point containers "
            f"and needs n_bits <= 30; got N={n_bits}")
    return make_engine(kind, fmt=FixedPointFormat(n_bits, 0),
                       backend=backend, fast=fast, strategy=strategy,
                       device=device, fault=fault)


def _with_frac(ax: AxEngine, frac_bits: int) -> AxEngine:
    """The cached engine with the operator's Q-format split (the injected
    fault, when present, rides along: each operator's engine runs the
    same defective hardware)."""
    return make_engine(ax.spec,
                       fmt=FixedPointFormat(ax.spec.n_bits, frac_bits),
                       backend=ax.backend, strategy=ax.strategy,
                       device=ax.device, fault=ax.fault)


def _q(img, e: AxEngine) -> torch.Tensor:
    return quantize(e.tensor(img), e.fmt)


# ----------------------------------------------------------- registry --

@dataclasses.dataclass(frozen=True)
class QForm:
    """The raw Q-domain form of an operator: ``fn(q, ax, **kw) -> q_out``.

    Input: signed int32 containers at ``in_frac`` fractional bits holding
    pixel values in [0, 255].  Output: signed int32 containers at
    ``out_frac`` fractional bits, NOT yet saturated.  ``halo`` is the
    spatial receptive-field radius in input pixels and ``down`` the
    integer output downscale factor (the tile streamer's geometry).
    ``exact`` records whether the float operator is EXACTLY quantize ->
    fn -> round/clip (true for every built-in operator).
    """

    fn: Callable
    in_frac: int
    out_frac: int
    halo: int = 0
    down: int = 1
    exact: bool = True


@dataclasses.dataclass(frozen=True)
class ImageOp:
    """One registered operator: the approximate implementation paired
    with its ideal float reference and its raw Q-domain form."""

    name: str
    fn: Callable
    reference: Callable
    n_inputs: int = 1
    qform: Optional[QForm] = None


OPERATORS: Dict[str, ImageOp] = {}


def register_operator(name: str, reference_fn: Callable, n_inputs: int = 1,
                      qform: Optional[QForm] = None):
    """Decorator pairing an approximate operator with its reference
    (and optionally its raw Q-domain form)."""

    def deco(fn: Callable) -> Callable:
        if name in OPERATORS:
            raise ValueError(f"operator {name!r} already registered")
        OPERATORS[name] = ImageOp(name, fn, reference_fn, n_inputs, qform)
        return fn

    return deco


def get_operator(name: str) -> ImageOp:
    try:
        return OPERATORS[name]
    except KeyError:
        raise KeyError(f"unknown operator {name!r}; registered: "
                       f"{sorted(OPERATORS)}") from None


def operator_names() -> Tuple[str, ...]:
    return tuple(sorted(OPERATORS))


# ---------------------------------------------------------- operators --

def _finish_q(v: torch.Tensor, frac_bits: int) -> torch.Tensor:
    """Round half up from ``frac_bits`` and saturate to uint8."""
    if frac_bits:
        v = (v + (1 << (frac_bits - 1))) >> frac_bits
    return torch.clamp(v, 0, 255).to(torch.uint8)


#: Extra fractional bits carried by box_blur's integer /9 quotient (see
#: the reference's ``_BOX_NORM_BITS``: the integer form is bit-identical
#: to the float32 /9.0 normalization).
_BOX_NORM_BITS = 7


def _box_blur_q(q, ax: AxEngine):
    """Headroom: 9 * 255 * 2^3 = 18360 < 2^15, so both passes accumulate
    unnormalized; the /9 normalization is one exact rounded integer
    division at the end, v * 128 < 2^22."""
    e = _with_frac(ax, _F_SEP)
    v = e.filter_chain(q, (FilterStage(-1, (-1, 0, 1), (1, 1, 1)),
                           FilterStage(-2, (-1, 0, 1), (1, 1, 1))))
    return torch.div((v << _BOX_NORM_BITS) + 4, 9, rounding_mode="floor")


@register_operator("box_blur", reference.box_blur,
                   qform=QForm(_box_blur_q, _F_SEP,
                               _F_SEP + _BOX_NORM_BITS, halo=1))
def box_blur(img, ax: AxEngine):
    """3x3 box blur, separable: ONE two-stage filter chain."""
    e = _with_frac(ax, _F_SEP)
    return _finish_q(_box_blur_q(_q(img, e), ax), _F_SEP + _BOX_NORM_BITS)


def _gauss3(e: AxEngine, q):
    """Separable 3x3 binomial core: two (1, 2, 1)/4 weighted passes with
    exact rounding shifts as ONE filter chain."""
    return e.filter_chain(q, (FilterStage(-1, (-1, 0, 1), (1, 2, 1), 2),
                              FilterStage(-2, (-1, 0, 1), (1, 2, 1), 2)))


def _gaussian_blur_q(q, ax: AxEngine):
    return _gauss3(_with_frac(ax, _F_SEP), q)


@register_operator("gaussian_blur", reference.gaussian_blur,
                   qform=QForm(_gaussian_blur_q, _F_SEP, _F_SEP, halo=1))
def gaussian_blur(img, ax: AxEngine):
    """3x3 binomial (Gaussian) blur: separable (1, 2, 1)/4 passes."""
    e = _with_frac(ax, _F_SEP)
    return _finish_q(_gaussian_blur_q(_q(img, e), ax), _F_SEP)


def _sharpen_q(q, ax: AxEngine, amount: int = 1):
    """Unsharp mask core: ``(1 + amount) * img - amount * blur`` as one
    weighted approximate pair-add on top of the Gaussian pyramid."""
    if not 0 <= amount <= 15:
        raise ValueError(f"amount must be in [0, 15] (Q16.{_F_SEP} "
                         f"headroom); got {amount}")
    e = _with_frac(ax, _F_SEP)
    return e.scaled_add(q, _gauss3(e, q), 1 + amount, -amount)


@register_operator("sharpen", reference.sharpen,
                   qform=QForm(_sharpen_q, _F_SEP, _F_SEP, halo=1))
def sharpen(img, ax: AxEngine, amount: int = 1):
    """Unsharp mask: ``(1 + amount) * img - amount * blur``."""
    e = _with_frac(ax, _F_SEP)
    return _finish_q(_sharpen_q(_q(img, e), ax, amount), _F_SEP)


def _sobel_q(q, ax: AxEngine):
    """Sobel core; the |Gx| + |Gy| magnitude's Q-form output is declared
    at ``_F_SOBEL + 2`` fractional bits (the /4 is absorbed into the
    scale contract)."""
    e = _with_frac(ax, _F_SOBEL)
    gx = e.filter_chain(q, (FilterStage(-2, (-1, 0, 1), (1, 2, 1)),
                            FilterStage(-1, (1, -1), (1, -1))))
    gy = e.filter_chain(q, (FilterStage(-1, (-1, 0, 1), (1, 2, 1)),
                            FilterStage(-2, (1, -1), (1, -1))))
    return e.scaled_add(torch.abs(gx), torch.abs(gy))


@register_operator("sobel", reference.sobel,
                   qform=QForm(_sobel_q, _F_SOBEL, _F_SOBEL + 2, halo=1))
def sobel(img, ax: AxEngine):
    """Sobel edge magnitude |Gx| + |Gy| (the L1 merge is itself an
    approximate add), each gradient one two-stage filter chain."""
    e = _with_frac(ax, _F_SOBEL)
    return _finish_q(_sobel_q(_q(img, e), ax), _F_SOBEL + 2)


def _img_add_q(qa, qb, ax: AxEngine):
    return _with_frac(ax, _F_ADD).scaled_add(qa, qb)


@register_operator("add", reference.img_add, n_inputs=2,
                   qform=QForm(_img_add_q, _F_ADD, _F_ADD))
def img_add(a, b, ax: AxEngine):
    """Saturating image add: one approximate add per pixel."""
    e = _with_frac(ax, _F_ADD)
    return _finish_q(_img_add_q(_q(a, e), _q(b, e), ax), _F_ADD)


def _blend_q(qa, qb, ax: AxEngine, alpha: float = 0.5):
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f"alpha must be in [0, 1] (the weighted sum "
                         f"must fit the 16-bit datapath); got {alpha}")
    e = _with_frac(ax, 0)
    wa = int(round(alpha * (1 << _ALPHA_BITS)))
    return e.scaled_add(qa, qb, wa, (1 << _ALPHA_BITS) - wa,
                        shift=_ALPHA_BITS)


@register_operator("blend", reference.blend, n_inputs=2,
                   qform=QForm(_blend_q, 0, 0))
def blend(a, b, ax: AxEngine, alpha: float = 0.5):
    """Alpha blend with a 6-bit quantized alpha: one weighted
    approximate pair-add, then an exact rounding shift."""
    e = _with_frac(ax, 0)
    return _finish_q(_blend_q(_q(a, e), _q(b, e), ax, alpha), 0)


def _brightness_q(q, ax: AxEngine, delta: float = 37.0):
    """Runs at Q16.2 so the adder families stay distinguishable."""
    if not -255.0 <= delta <= 255.0:
        raise ValueError(f"delta must be in [-255, 255]; got {delta}")
    e = _with_frac(ax, _F_BRIGHT)
    qd = torch.full_like(q, int(round(delta * e.fmt.scale)))
    return e.scaled_add(q, qd)


@register_operator("brightness", reference.brightness,
                   qform=QForm(_brightness_q, _F_BRIGHT, _F_BRIGHT))
def brightness(img, ax: AxEngine, delta: float = 37.0):
    """Brightness adjust: one approximate add of a constant plane."""
    e = _with_frac(ax, _F_BRIGHT)
    return _finish_q(_brightness_q(_q(img, e), ax, delta), _F_BRIGHT)


def _downsample2x_q(q, ax: AxEngine):
    """2x box core: the four phase planes of each 2x2 quad are one fused
    4-term accumulation with an exact /4 rounding shift (odd H/W are
    cropped first)."""
    e = _with_frac(ax, _F_DOWN)
    h = q.shape[-2] & ~1
    w = q.shape[-1] & ~1
    q = q[..., :h, :w]
    return e.accumulate_signed((q[..., 0::2, 0::2], q[..., 0::2, 1::2],
                                q[..., 1::2, 0::2], q[..., 1::2, 1::2]),
                               shift=2)


@register_operator("downsample2x", reference.downsample2x,
                   qform=QForm(_downsample2x_q, _F_DOWN, _F_DOWN, down=2))
def downsample2x(img, ax: AxEngine):
    """2x box downsampling through one 4-term accumulation."""
    e = _with_frac(ax, _F_DOWN)
    return _finish_q(_downsample2x_q(_q(img, e), ax), _F_DOWN)
