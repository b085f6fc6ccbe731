"""The last of the JAX package's public surface in the port, against the
JAX package on the CPU: ``UserDataLoader`` (and ``_get_AE_dataloader``,
which names it), ``SeqSampler``, ``KGSampler``, ``get_flops_estimate`` and
``get_environment_info``.

Both packages draw from numpy's global generator; each case seeds it alike
before each side, so the batches and the negatives must be equal, element
for element.
"""

import numpy as np
import pytest

import recbole_fairrec_tpu.data as jax_data
import recbole_fairrec_tpu.sampler as jax_sampler
import recbole_fairrec_tpu.utils as jax_utils
from recbole_fairrec_tpu.config import Config as JaxConfig
from recbole_fairrec_tpu.data.utils import _get_AE_dataloader as jax_get_AE_dataloader
from recbole_fairrec_tpu.utils.common import get_flops_estimate as jax_get_flops_estimate

import recbole_fairrec_tpu_torch.data as port_data
import recbole_fairrec_tpu_torch.sampler as port_sampler
import recbole_fairrec_tpu_torch.utils as port_utils
from recbole_fairrec_tpu_torch.config import Config
from recbole_fairrec_tpu_torch.data.utils import _get_AE_dataloader
from recbole_fairrec_tpu_torch.utils.common import get_flops_estimate
from torch_jax_native_cache import private_jax_native_cache  # noqa: F401 (autouse fixture)


def _config_dict(data_path, **kw):
    return {
        "data_path": str(data_path),
        "load_col": {"inter": ["user_id", "item_id", "rating"], "user": ["user_id", "gender"]},
        "neg_sampling": {"uniform": 1},
        **kw,
    }


def _datasets(data_path, **kw):
    cd = _config_dict(data_path, **kw)
    jc = JaxConfig(model="FOCF", dataset="tiny", config_dict=cd)
    pc = Config(model="FOCF", dataset="tiny", config_dict={**cd, "use_gpu": False})
    return (jc, jax_data.Dataset(jc)), (pc, port_data.Dataset(pc))


@pytest.mark.parametrize("batch_size", [7, 64])
def test_user_dataloader_matches_jax(tiny_data_path, batch_size):
    """tests/test_interaction_dataloader.py::test_user_dataloader on both
    packages: every user id once per pass, shuffled by numpy; two passes
    from one seed give the same batches in both."""
    (jc, jds), (pc, pds) = _datasets(tiny_data_path, train_batch_size=batch_size)
    passes = []
    for loader_cls, config, ds in ((jax_data.UserDataLoader, jc, jds),
                                   (port_data.UserDataLoader, pc, pds)):
        np.random.seed(11)
        loader = loader_cls(config, ds, None, shuffle=True)
        passes.append([[np.asarray(b["user_id"]) for b in loader] for _ in range(2)])
    (j0, j1), (p0, p1) = passes
    for ref, got in ((j0, p0), (j1, p1)):
        assert len(got) == len(ref) == -(-pds.user_num // batch_size)
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(b, a)
    seen = np.concatenate(p0)
    assert sorted(seen.tolist()) == list(range(pds.user_num))
    assert not np.array_equal(np.concatenate(p0), np.concatenate(p1))  # reshuffled


def test_user_dataloader_shuffles_even_when_asked_not_to(tiny_data_path):
    (jc, jds), (pc, pds) = _datasets(tiny_data_path)
    assert jax_data.UserDataLoader(jc, jds, None, shuffle=False).shuffle is True
    assert port_data.UserDataLoader(pc, pds, None, shuffle=False).shuffle is True


@pytest.mark.parametrize("phase", ["train", "valid", "test"])
def test_ae_dataloader_choice_matches_jax(tiny_data_path, phase):
    (jc, _), (pc, _) = _datasets(tiny_data_path)
    assert _get_AE_dataloader(pc, phase).__name__ == jax_get_AE_dataloader(jc, phase).__name__
    if phase == "train":
        assert _get_AE_dataloader(pc, phase) is port_data.UserDataLoader


@pytest.mark.parametrize("distribution", ["uniform", "popularity"])
def test_seq_sampler_matches_jax(tiny_data_path, distribution):
    """tests/test_sampler.py::test_seq_sampler_positionwise on both
    packages: the same negatives, none equal to its position's item."""
    (jc, jds), (pc, pds) = _datasets(tiny_data_path)
    out = []
    for mod, ds in ((jax_sampler, jds), (port_sampler, pds)):
        s = mod.SeqSampler(ds, distribution)
        pos = np.asarray(ds.inter_feat["item_id"])[:50]
        np.random.seed(4)
        out.append((pos, s.sample_neg_sequence(pos)))
    (jpos, jneg), (ppos, pneg) = out
    np.testing.assert_array_equal(ppos, jpos)
    np.testing.assert_array_equal(pneg, jneg)
    assert pneg.dtype == np.int64 and pneg.shape == ppos.shape
    assert (pneg != ppos).all() and pneg.min() >= 1


class _KG:
    head_entity_field = "head_id"
    tail_entity_field = "tail_id"
    head_entities = [1, 1, 2, 3, 3, 3]
    tail_entities = [2, 3, 4, 1, 4, 5]
    entity_num = 30


@pytest.mark.parametrize("heads,num", [([1, 3, 1, 2], 4), ([3, 3, 3], 2), ([2], 5)])
def test_kg_sampler_matches_jax(heads, num):
    """tests/test_sampler.py::test_kg_sampler_excludes_known_tails on both
    packages (a batch of one repeated head takes the single-key path)."""
    out = []
    for mod in (jax_sampler, port_sampler):
        s = mod.KGSampler(_KG(), "uniform")
        np.random.seed(2)
        out.append(s.sample_by_entity_ids(np.array(heads), num=num))
    ref, neg = out
    np.testing.assert_array_equal(neg, ref)
    assert len(neg) == len(heads) * num and neg.min() >= 1
    known = set(zip(_KG.head_entities, _KG.tail_entities))
    assert not any((h, t) in known for h, t in zip(np.tile(heads, num).tolist(), neg.tolist()))


def test_kg_sampler_head_without_triples_matches_jax():
    """A head with no known triple constrains nothing: any tail in [1,
    entity_num) is drawn, the same in both packages."""
    out = []
    for mod in (jax_sampler, port_sampler):
        s = mod.KGSampler(_KG(), "uniform")
        np.random.seed(6)
        out.append(s.sample_by_entity_ids(np.array([7, 1]), num=3))
    np.testing.assert_array_equal(out[1], out[0])
    assert out[1].min() >= 1 and out[1].max() < _KG.entity_num


def test_surface_exports_match_jax():
    """Every name the JAX package exports from ``data``, ``sampler`` and
    ``utils`` the port exports too."""
    for jax_mod, port_mod in ((jax_data, port_data), (jax_sampler, port_sampler),
                              (jax_utils, port_utils)):
        assert set(jax_mod.__all__) <= set(port_mod.__all__), jax_mod.__name__


@pytest.mark.parametrize("n_params", [0, 1, 123_456_789])
def test_flops_estimate_matches_jax(n_params):
    assert get_flops_estimate(n_params) == jax_get_flops_estimate(n_params)


def test_environment_info_has_the_jax_keys():
    """The same keys as the JAX package's summary; here (no card, no
    process group) the CPU as one device in a world of one, as JAX reports
    its CPU backend."""
    info = port_utils.get_environment_info()
    ref = jax_utils.get_environment_info()
    assert set(info) == set(ref)
    assert info["backend"] == ref["backend"] == "cpu"
    assert info["n_devices"] == len(info["devices"]) == 1
    assert info["process_count"] == ref["process_count"] == 1
