"""recboard_tpu_torch's seeded dropout mask (K7's plain version, the path CPU
tensors take) beside recboard_tpu's ``dropout``: the cases of
tests/test_ops.py's ``test_dropout_cpu_fallback_semantics`` hold for both.
The two draw different bits (a hash of the seed here, jax.random there),
so they are compared by what a mask must be: the identity when
deterministic or at rate 0, the zero share within 0.02 of the rate at
(400, 64), kept values exactly 1 / (1 - rate), and the gradient equal to the
mask. The threshold clamps at rate -> 1 as JAX's min(round(rate * 2**32),
2**32 - 1).

The CUDA kernel runs only on the card: ``chip_smoke.py`` holds it against
this plain version there, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recboard_tpu.ops.dropout import dropout as dropout_jax
from recboard_tpu_torch.ops import dropout as Dr
from recboard_tpu_torch.ops.attention import _threshold


def _seed(value):
    return torch.tensor([value], dtype=torch.int32)


def test_identity_when_deterministic_or_rate_0():
    x = torch.ones((400, 64))
    g = torch.Generator().manual_seed(0)
    assert Dr.dropout(x, 0.2, g, deterministic=True) is x
    assert Dr.dropout(x, 0.0, g) is x
    xj, key = jnp.ones((400, 64)), jax.random.PRNGKey(0)
    np.testing.assert_array_equal(dropout_jax(xj, 0.2, key, deterministic=True), xj)
    np.testing.assert_array_equal(dropout_jax(xj, 0.0, key), xj)


def test_zero_share_kept_values_and_gradient_match_jax_semantics():
    x = torch.ones((400, 64), requires_grad=True)
    y = Dr.dropout(x, 0.25, torch.Generator().manual_seed(0))
    y.sum().backward()
    yj = np.asarray(dropout_jax(jnp.ones((400, 64)), 0.25, jax.random.PRNGKey(0)))
    for out in (y.detach().numpy(), yj):
        assert abs((out == 0).mean() - 0.25) < 0.02
        np.testing.assert_allclose(np.unique(out[out != 0]), [1.0 / 0.75], rtol=1e-6)
    # the gradient flows through the kept positions only, scaled: the mask
    np.testing.assert_array_equal(x.grad.numpy(), y.detach().numpy())


@pytest.mark.parametrize("shape,rate", [((400, 64), 0.25), ((7, 13, 11), 0.5), ((1000,), 0.1)])
def test_mask_is_a_function_of_the_seed(shape, rate):
    a = Dr.dropout_mask(_seed(12345), shape, rate)
    assert a.shape == shape and a.dtype == torch.float32
    assert torch.equal(a, Dr.dropout_mask(_seed(12345), shape, rate))
    assert not torch.equal(a, Dr.dropout_mask(_seed(12346), shape, rate))
    assert torch.equal(a, Dr.dropout_mask_reference(_seed(12345), shape, rate))
    values = set(torch.unique(a).tolist())
    assert values == {0.0, float(np.float32(1.0 / (1.0 - rate)))}


def test_masks_of_two_seeds_are_not_shifted_copies():
    """The hash keys the counter twice, so a second seed's mask is no
    window of the first's stream."""
    a = Dr.dropout_mask(_seed(1), (4096,), 0.5).bool()
    b = Dr.dropout_mask(_seed(2), (4096,), 0.5).bool()
    agree = [float((a[k:] == b[: 4096 - k]).float().mean()) for k in range(0, 2048, 7)]
    agree += [float((b[k:] == a[: 4096 - k]).float().mean()) for k in range(0, 2048, 7)]
    assert max(agree) < 0.6


def test_threshold_clamps_as_jax_at_rate_near_1():
    rate = 1.0 - 1e-11  # round(rate * 2**32) = 2**32
    assert int(round(rate * 2**32)) == 2**32
    assert _threshold(rate) == 2**32 - 1 == min(int(round(rate * 2**32)), 2**32 - 1)
    assert _threshold(0.0) == 0 and _threshold(0.5) == 2**31
    mask = Dr.dropout_mask(_seed(3), (50_000,), rate)
    assert (mask == 0).float().mean() > 0.999  # only bits of 2**32 - 1 are kept


def test_kernel_wrapper_takes_cpu_seeds_only_through_the_plain_version():
    """A CPU seed takes the plain version and counts no launch; a seed that
    is not a one-element int32 tensor raises."""
    Dr.dropout_mask(_seed(0), (8, 8), 0.5)
    assert Dr.dropout_mask.launches == 0
    with pytest.raises(ValueError, match="one-element int32"):
        Dr.dropout_mask(torch.tensor([0, 1], dtype=torch.int32), (8,), 0.5)
    with pytest.raises(ValueError, match="one-element int32"):
        Dr.dropout_mask(torch.tensor([0]), (8,), 0.5)
