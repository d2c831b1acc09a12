"""The count functions against hand-worked small shapes."""

import pytest

from hzbench.counts import Work, bound_seconds, element_apply, peaks, structured_combine


def test_element_apply_residual_hand_count():
    # x 2x3 f32 (24 B), coeff 2x2 (16), dense stack 2x3x3 (72), b and out
    # 2x3 each (48): 160 B. Operations: 2 per stack nonzero and element
    # (2 * 2 * 5), 2 per piece and entry (2 * 2 * 6), 1 per entry (6).
    w = element_apply.work(E=2, n=3, P=2, itemsize=4, residual=True, stack_nnz=5)
    assert w == Work(160.0, 50.0)


def test_element_apply_apply_half_and_mask():
    # x in bfloat16 (2 B): 12; coeff 16; stack 72; out 24; mask 6
    w = element_apply.work(E=2, n=3, P=2, itemsize=4, x_itemsize=2, mask=True, stack_nnz=5)
    assert w.bytes == 12 + 16 + 72 + 24 + 6
    assert w.flops == 2 * 2 * 5 + 2 * 2 * 6
    # no nonzero count: the dense product's, an upper bound
    assert element_apply.work(E=1, n=2, P=1, itemsize=8).flops == 2 * 4 + 2 * 2


def test_structured_combine_hand_count():
    assert structured_combine.work(E=2, n=3, itemsize=8) == Work(96.0, 6.0)
    assert structured_combine.work(E=2, n=3, itemsize=4, mask=True) == Work(54.0, 6.0)


def test_bound_names_the_larger_time():
    t, kind = bound_seconds(Work(3.35e12, 1.0), "float32")
    assert kind == "bytes" and t == pytest.approx(1.0)
    t, kind = bound_seconds(Work(1.0, 34e12), "float64")
    assert kind == "flops" and t == pytest.approx(1.0)
    assert peaks.flops_per_s("float32") == 67e12


def test_describe_reads_a_call():
    import torch

    x = torch.zeros(5, 4, dtype=torch.float32)
    coeff = torch.zeros(5, 3)
    stack = torch.zeros(3, 4, 4)
    stack[0, 1, 2] = 1.0
    d = element_apply.describe(x, coeff, stack, b=x)
    args = element_apply.resolve(d, {})
    assert args["stack_nnz"] == 1 and args["residual"] and args["E"] == 5 and args["n"] == 4
    assert structured_combine.describe(x, None, constrain=True) == dict(
        E=5, n=4, itemsize=4, mask=False)
