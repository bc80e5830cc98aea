"""The port's eight image operators against the reference's, bit for bit:
every Table-1 kind x every operator on ``synthetic_batch(4, 64)``
(reference on its ``"jax"`` backend, port on ``"torch"`` on the CPU),
plus operator options and ragged/odd image sizes."""

import numpy as np
import pytest
import torch

from repro.core.specs import TABLE1_KINDS
from repro.imgproc import get_workload as get_workload_j
from repro.imgproc import synthetic_batch as synthetic_batch_j
from repro_torch.imgproc import OPERATORS, get_workload, make_image_engine
from repro_torch.imgproc import synthetic_batch

BATCH = synthetic_batch(4, 64)
CPU = dict(backend="torch", device="cpu")


def test_synthetic_batch_is_the_reference_batch():
    np.testing.assert_array_equal(BATCH, synthetic_batch_j(4, 64))
    np.testing.assert_array_equal(synthetic_batch(2, 33, seed=5),
                                  synthetic_batch_j(2, 33, seed=5))


@pytest.mark.parametrize("kind", TABLE1_KINDS + ("eta",))
def test_every_operator_matches_reference(kind):
    assert len(OPERATORS) == 8
    for name in sorted(OPERATORS):
        want = get_workload_j(name).run(BATCH, kind=kind, backend="jax")
        got = get_workload(name).run(BATCH, kind=kind, **CPU)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"{kind} {name}")


@pytest.mark.parametrize("name,kw", [
    ("blend", {"alpha": 0.25}), ("blend", {"alpha": 0.7}),
    ("brightness", {"delta": -20.5}), ("brightness", {"delta": 2.5}),
    ("sharpen", {"amount": 3}),
])
def test_operator_options_match_reference(name, kw):
    for kind in ("haloc_axa", "oloca"):
        want = get_workload_j(name).run(BATCH[:2], kind=kind,
                                        backend="numpy", **kw)
        got = get_workload(name).run(BATCH[:2], kind=kind, **CPU, **kw)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(3, 33, 45), (1, 1, 1), (2, 2, 3),
                                   (1, 5, 1)])
def test_odd_sizes_match_reference(shape):
    rng = np.random.default_rng(sum(shape))
    imgs = rng.integers(0, 256, shape).astype(np.uint8)
    for name in sorted(OPERATORS):
        want = get_workload_j(name).run(imgs, kind="haloc_axa",
                                        backend="numpy")
        got = get_workload(name).run(imgs, kind="haloc_axa", **CPU)
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_operators_take_tensors_and_return_uint8_on_the_engine_device():
    ax = make_image_engine("haloc_axa", **CPU)
    out = OPERATORS["gaussian_blur"].fn(torch.as_tensor(BATCH), ax)
    assert out.dtype == torch.uint8 and out.device.type == "cpu"
    np.testing.assert_array_equal(
        out.numpy(), get_workload("gaussian_blur").run(BATCH, **CPU))
    with pytest.raises(ValueError, match="n_bits <= 30"):
        make_image_engine("haloc_axa", n_bits=32, **CPU)
    with pytest.raises(ValueError, match="amount"):
        get_workload("sharpen").run(BATCH[:1], amount=16, **CPU)
