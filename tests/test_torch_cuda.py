"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU and ``nvcc``; without them every test here skips.
The file imports nothing of JAX, so on a host without JAX it runs alone:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch import _cuda
from nnstreamer_tpu_torch.ops.preprocess import (normalize_frame,
                                                 normalize_frame_reference)

pytestmark = pytest.mark.cuda

#: the main path's frame, odd and ragged sizes, a 1080p frame
SHAPES = [(224, 224, 3), (1,), (7, 13, 3), (1025,), (3, 1000),
          (1080, 1920, 3)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_normalize_frame_is_bit_exact(card, shape, dtype):
    frame = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, shape, np.uint8)).to(card)
    before = _cuda.launches["normalize_frame"]
    got = normalize_frame(frame, 1.0 / 127.5, -1.0, dtype)
    torch.cuda.synchronize()
    assert _cuda.launches["normalize_frame"] == before + 1
    want = normalize_frame_reference(frame, 1.0 / 127.5, -1.0, dtype)
    assert got.dtype == dtype and got.shape == frame.shape
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))


def test_normalize_frame_unaligned_input(card):
    """A view that starts one byte into its storage takes the scalar
    path and still matches."""
    base = torch.arange(1 + 4096, dtype=torch.int64).to(torch.uint8).to(card)
    frame = base[1:]
    got = normalize_frame(frame, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    want = normalize_frame_reference(frame, dtype=torch.bfloat16)
    assert torch.equal(got.float(), want.float())


def test_normalize_frame_refuses_what_it_does_not_take(card):
    with pytest.raises(TypeError, match="uint8"):
        normalize_frame(torch.zeros(8, device=card))
    with pytest.raises(TypeError, match="output dtype"):
        normalize_frame(torch.zeros(8, dtype=torch.uint8, device=card),
                        dtype=torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        normalize_frame(torch.zeros(8, 8, dtype=torch.uint8,
                                    device=card).t())
