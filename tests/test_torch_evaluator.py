"""The port's metrics against the JAX package's on the same payloads.

Both evaluators read a ``DataStruct`` holding the same numpy arrays, as the
trainers hand them over after a full-sort evaluation: ``rec.topk`` (the hit
matrix and each user's positive count), ``rec.items`` and the train-side
item statistics. The metric dicts must be identical (both round to
``metric_decimal_place``).
"""

from collections import Counter

import numpy as np
import pytest

from recbole_fairrec_tpu.evaluator import DataStruct as JaxDataStruct
from recbole_fairrec_tpu.evaluator import Evaluator as JaxEvaluator

from recbole_fairrec_tpu_torch.evaluator import DataStruct, Evaluator

TOPK_METRICS = ["NDCG", "Recall", "Hit", "MRR", "Precision", "MAP"]
ITEM_METRICS = ["GiniIndex", "PopularityPercentage", "ItemCoverage",
                "AveragePopularity", "ShannonEntropy", "TailPercentage"]


def _payload(seed, n_users=57, n_items=120, k=10):
    rng = np.random.RandomState(seed)
    pos_len = rng.randint(1, 15, n_users)
    hits = (rng.rand(n_users, k) < 0.2).astype(np.int64)
    hits = np.minimum(hits, (np.arange(k)[None, :] < pos_len[:, None]).astype(np.int64))
    rec_topk = np.concatenate([hits, pos_len[:, None]], axis=1)
    rec_items = np.stack([rng.choice(np.arange(1, n_items), k, replace=False)
                          for _ in range(n_users)])
    train_items = rng.randint(1, n_items, 4000)
    return {
        "rec.topk": rec_topk,
        "rec.items": rec_items,
        "data.num_items": n_items,
        "data.count_items": Counter(train_items.tolist()),
    }


def _evaluate(evaluator_cls, struct_cls, config, payload):
    struct = struct_cls()
    for key, value in payload.items():
        struct.set(key, value)
    return dict(evaluator_cls(config).evaluate(struct))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("metric", TOPK_METRICS + ITEM_METRICS)
def test_metric_equal_on_same_payload(metric, seed):
    config = {"metrics": [metric], "topk": [5, 10], "metric_decimal_place": 4,
              "popularity_ratio": 0.1, "tail_ratio": 0.1}
    payload = _payload(seed)
    ours = _evaluate(Evaluator, DataStruct, config, payload)
    ref = _evaluate(JaxEvaluator, JaxDataStruct, config, payload)
    assert ours == ref
    assert len(ours) >= 1


def test_serving_metric_set_equal():
    """The metric set the serving path and the tests use, in one evaluator."""
    config = {"metrics": ["NDCG", "Recall", "Hit", "MRR", "GiniIndex", "PopularityPercentage"],
              "topk": [10], "metric_decimal_place": 4, "popularity_ratio": 0.1}
    payload = _payload(3)
    ours = _evaluate(Evaluator, DataStruct, config, payload)
    assert ours == _evaluate(JaxEvaluator, JaxDataStruct, config, payload)
    assert list(ours) == ["ndcg@10", "recall@10", "hit@10", "mrr@10", "giniindex@10",
                          "popularitypercentage@10"]
