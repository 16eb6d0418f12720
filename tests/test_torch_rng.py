"""The port's counter RNG is bit-equal to the reference's (numpy path)."""

import numpy as np
import pytest
import torch

from pathtrace_tpu.core import rng as ref
from pathtrace_tpu_torch.core import rng

# iteration and pixel values around 2^31 and at 2^32-1, where int32/u32
# handling would differ if the port got the wrap wrong
ITS = [0, 1, 2, 7, 5000, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 2, 2**32 - 1]
PIXELS = [0, 1, 799, 800, 12345, 639999, 2**24 + 3, 2**31 - 1, 2**31,
          2**32 - 1]
DEPTHS = list(range(10))
SLOTS = sorted({v for k, v in vars(ref.Draw).items() if not k.startswith("_")})


def _grid():
    it, pix, dep, draw = np.meshgrid(ITS, PIXELS, DEPTHS, SLOTS,
                                     indexing="ij")
    return [a.astype(np.uint32).ravel() for a in (it, pix, dep, draw)]


def _port_args(arrs):
    return [torch.as_tensor(a.astype(np.int64)) for a in arrs]


def test_hash_bit_equal():
    arrs = _grid()
    want = ref.hash_u32(*arrs, xp=np)
    got = rng.hash_u32(*_port_args(arrs))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_uniform_bit_equal():
    arrs = _grid()
    want = ref.uniform(*arrs, xp=np)
    got = rng.uniform(*_port_args(arrs)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() >= 0.0 and got.max() < 1.0


@pytest.mark.parametrize("it", [1, 2**31, 2**32 - 1])
def test_int_counters_match_tensor_counters(it):
    # a Python-int counter (kept on the host) gives the same bits as a
    # tensor one, and ints beyond u32 wrap mod 2^32
    pix = torch.arange(0, 4096, 7)
    a = rng.uniform(it, pix, 3, ref.Draw.LOBE)
    b = rng.uniform(torch.full_like(pix, it), pix, torch.full_like(pix, 3),
                    torch.full_like(pix, ref.Draw.LOBE))
    c = rng.uniform(it + 2**32, pix, 3, ref.Draw.LOBE)
    assert torch.equal(a, b) and torch.equal(a, c)


def test_draw_slots_match():
    names = {k for k in vars(ref.Draw) if not k.startswith("_")}
    assert names == {k for k in vars(rng.Draw) if not k.startswith("_")}
    for k in names:
        assert getattr(rng.Draw, k) == getattr(ref.Draw, k), k
