"""``utils/consts.py``: a constant is made once per (value, dtype,
device), equals what ``torch.as_tensor`` makes, and is usable by autograd
wherever it was first made."""

import numpy as np
import torch

from d3human_tpu_torch.utils.consts import const


def test_const_is_made_once_and_equals_as_tensor():
    a = const((1.0, -1.0, -1.0), "cpu")
    assert const((1.0, -1.0, -1.0), "cpu") is a
    assert torch.equal(a, torch.as_tensor((1.0, -1.0, -1.0)))
    b = const((1.0, -1.0, -1.0), "cpu", torch.float64)
    assert b is not a and b.dtype == torch.float64
    table = np.asarray([[0, 1], [2, 3]], np.int32)
    t = const(table, "cpu")
    assert const(table, "cpu") is t
    assert t.dtype == torch.int32 and torch.equal(t, torch.as_tensor(table))


def test_const_first_made_in_inference_mode_serves_autograd():
    with torch.inference_mode():
        const((2.0, 3.0), "cpu", torch.float32)
    w = const((2.0, 3.0), "cpu", torch.float32)
    x = torch.ones(2, requires_grad=True)
    (x * w).sum().backward()
    assert torch.equal(x.grad, torch.tensor([2.0, 3.0]))
