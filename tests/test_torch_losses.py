"""``models/losses.py`` of the port against the JAX package's, function by
function: the same numpy inputs (seeded) go through both, and the values and
the gradients with respect to every floating input must agree within
rtol 1e-6 (atol 1e-7 for entries near 0). ``bce_elementwise`` is also held
to the JAX backward formula at probabilities of exactly 0 and 1, where
autodiff through the clamped logs would give NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbole_fairrec_tpu.models import losses as jax_losses

from recbole_fairrec_tpu_torch.models import losses

RTOL, ATOL = 1e-6, 1e-7


def _rng():
    return np.random.RandomState(11)


def _f32(a):
    return np.asarray(a, dtype=np.float32)


def _cases():
    r = _rng()
    B, d, C = 37, 6, 5
    prob = _f32(r.uniform(0.02, 0.98, (B, 1)))
    target = _f32(r.randint(0, 2, (B, 1)))
    embs = [_f32(r.randn(B, d)), _f32(r.randn(B, d) * 2), _f32(r.randn(B, d) * 0.3)]
    return {
        # name: (function name, float args (differentiated), other args, kwargs)
        "bpr": ("bpr_loss", [_f32(r.randn(B) * 3), _f32(r.randn(B) * 3)], [], {}),
        "mse": ("mse_loss", [_f32(r.randn(B)), _f32(r.randn(B))], [], {}),
        "bce_elementwise": ("bce_elementwise", [prob], [target], {}),
        "bce": ("bce_loss", [prob], [target], {}),
        "cross_entropy": ("cross_entropy_loss", [_f32(r.randn(B, C) * 2)],
                          [r.randint(0, C, B).astype(np.int32)], {}),
        "smooth_l1": ("smooth_l1_loss", [_f32(r.randn(B) * 2), _f32(r.randn(B))], [], {}),
        "masked_smooth_l1": ("masked_smooth_l1_loss", [_f32(r.randn(B) * 2), _f32(r.randn(B))],
                             [_f32(r.randint(0, 2, B))], {}),
        "masked_smooth_l1_empty_mask": ("masked_smooth_l1_loss",
                                        [_f32(r.randn(B)), _f32(r.randn(B))],
                                        [np.zeros(B, np.float32)], {}),
        "reg": ("reg_loss", embs, [], {"as_list": True}),
        "emb": ("emb_loss", embs, [], {"as_list": True}),
        "emb_pow": ("emb_loss", embs, [], {"as_list": True, "require_pow": True}),
        "emb_norm3_pow": ("emb_loss", embs, [], {"as_list": True, "norm": 3, "require_pow": True}),
        "emb_margin": ("emb_margin_loss", embs, [], {"as_list": True, "margin": 4.0}),
    }


CASES = _cases()


def _call(fn, floats, others, kwargs):
    kwargs = dict(kwargs)
    if kwargs.pop("as_list", False):
        return fn(list(floats), *others, **kwargs)
    return fn(*floats, *others, **kwargs)


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_value_and_gradient_match_jax(name):
    fn_name, floats, others, kwargs = CASES[name]

    def jax_total(*fl):
        return jnp.sum(_call(getattr(jax_losses, fn_name), fl, [jnp.asarray(o) for o in others],
                             kwargs))

    ref_value = _call(getattr(jax_losses, fn_name), [jnp.asarray(f) for f in floats],
                      [jnp.asarray(o) for o in others], kwargs)
    ref_grads = jax.grad(jax_total, argnums=tuple(range(len(floats))))(
        *[jnp.asarray(f) for f in floats]
    )

    t_floats = [torch.tensor(f, requires_grad=True) for f in floats]
    t_others = [torch.as_tensor(o) for o in others]
    value = _call(getattr(losses, fn_name), t_floats, t_others, kwargs)
    value.sum().backward()

    np.testing.assert_allclose(value.detach().numpy(), np.asarray(ref_value), rtol=RTOL, atol=ATOL)
    for t, g in zip(t_floats, ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("p", [0.0, 1e-30, 0.5, 1.0])
@pytest.mark.parametrize("t", [0.0, 1.0])
def test_bce_elementwise_at_saturation(p, t):
    """Forward: the log terms are clamped at −100 (finite at p = 0 and 1).
    Backward: (p − t) / max(p(1 − p), 1e-12), the JAX package's custom
    gradient, finite everywhere."""
    prob = torch.tensor([p], dtype=torch.float32, requires_grad=True)
    target = torch.tensor([t], dtype=torch.float32)
    out = losses.bce_elementwise(prob, target)
    out.sum().backward()

    ref_out = jax_losses.bce_elementwise(jnp.float32(p), jnp.float32(t))
    ref_grad = jax.grad(lambda q: jax_losses.bce_elementwise(q, jnp.float32(t)))(jnp.float32(p))
    assert np.isfinite(out.item()) and np.isfinite(prob.grad.item())
    np.testing.assert_allclose(out.item(), float(ref_out), rtol=RTOL)
    np.testing.assert_allclose(prob.grad.item(), float(ref_grad), rtol=RTOL)
    p32 = np.float32(p)
    formula = (p32 - np.float32(t)) / max(p32 * (np.float32(1) - p32), np.float32(1e-12))
    np.testing.assert_allclose(prob.grad.item(), formula, rtol=RTOL)


def test_bce_through_sigmoid_is_finite_at_saturation():
    """The chain through a saturated sigmoid (p exactly 1.0 in float32) gives
    a zero gradient, not NaN, as in the JAX package."""
    logits = torch.tensor([40.0, -200.0, 0.3], requires_grad=True)
    target = torch.tensor([0.0, 1.0, 1.0])
    losses.bce_loss(torch.sigmoid(logits), target).backward()
    ref = jax.grad(
        lambda x: jax_losses.bce_loss(jax.nn.sigmoid(x), jnp.asarray(target.numpy()))
    )(jnp.asarray(logits.detach().numpy()))
    assert torch.isfinite(logits.grad).all()
    np.testing.assert_allclose(logits.grad.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_bce_elementwise_broadcast_target_gradient_shape():
    prob = torch.full((4, 1), 0.3, requires_grad=True)
    target = torch.tensor([[0.0, 1.0, 1.0]])
    losses.bce_elementwise(prob, target).sum().backward()
    assert prob.grad.shape == prob.shape
