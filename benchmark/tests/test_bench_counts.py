"""The yardstick's operation and byte counts against hand-worked values at
the cells' shapes."""

import pytest

import counts
from counts import pfcn_pmf

PFCN = {"n_users": 6041, "n_items": 3630, "embedding_size": 64, "filter_mode": "sm",
        "attributes": {"gender": 2, "age": 7, "occupation": 21},
        "dis_hidden_size_list": [128, 256, 128, 128, 64, 32]}


@pytest.mark.parametrize("B, want_s, bound", [
    # bytes: 2 B x (2,097,152 + 128) x 128 + 8 B x 128 x 10 = 536,913,920 B
    (128, 536_913_920 / 3.35e12, "bytes"),
    # operations: 2 x 1024 x 2,097,152 x 128 = 549,755,813,888 at 989 TFLOP/s
    (1024, 549_755_813_888 / 989e12, "operations"),
])
def test_topk_call_at_the_retrieval_cell(B, want_s, bound):
    assert counts.topk_call_s(B, 2_097_152, 128, 10) == pytest.approx(want_s, rel=1e-12)


def test_catalog_step_is_bound_by_adam_bytes():
    # 6 x 4 B x 402,653,184 parameters + 3 x 65,536 rows x 128 x 4 B
    want = (9_663_676_416 + 100_663_296) / 3.35e12
    params = (1_048_576 + 2_097_152) * 128
    got = counts.least_s(2.0 * 2 * 65_536 * 128 * 2,
                         counts.gather_bytes(3 * 65_536, 128) + counts.adam_bytes(params))
    assert got == pytest.approx(want, rel=1e-12)


def test_pfcn_filter_step_over_three_attributes():
    # filter [64, 128, 64]: 2 x 2048 x 16,384 = 67,108,864 a pass, 6 passes;
    # discriminators: 2 x 2048 x (100,384 + 100,576 + 101,024) a pass, 2 passes;
    # the two scores: 2 x 2 x 2048 x 64 x 2 = 1,048,576
    flops = 1_048_576 + 6 * 67_108_864 + 2 * 2 * 2048 * 301_984
    assert pfcn_pmf.step_s(PFCN, 2048, "filter", ("gender", "age", "occupation")) == \
        pytest.approx(flops / 67e12, rel=1e-12)


def test_pfcn_dis_step_over_one_attribute():
    flops = 67_108_864 + 2 * 2 * 2048 * 100_384
    assert pfcn_pmf.step_s(PFCN, 2048, "dis", ("gender",)) == pytest.approx(flops / 67e12,
                                                                           rel=1e-12)


def test_parameter_counts():
    # filter: (64·128 + 128 + 256) + (128·64 + 64 + 128) = 16,960, seven filters
    assert pfcn_pmf.filter_group_params(PFCN) == 9671 * 64 + 7 * 16_960
    assert counts.mlp_params([64, 128, 64]) == 16_960
    assert counts.adam_bytes(10) == 240.0
