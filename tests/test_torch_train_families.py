"""The moe, ssm and hybrid families' training loss and its gradients in
the port (``Model.loss_fn``) against the JAX package's
``jax.value_and_grad`` of its ``loss_fn`` on the same weights, as
``test_torch_train_models.py`` holds the dense families.

Reduced granite-moe (4 experts, top-2) in both dispatch modes (the loss
adds the aux loss, its mean over the layers times 0.01), mamba2 (chunk 8,
48 positions) and recurrentgemma (one (rec, rec, attn) superblock and
two tail layers; the scan's emulated exp carries exp's gradient).  In
f32 the loss agrees within 1e-5 relative and every leaf's gradient
within 1e-4 of its largest |g|; in bf16 within 2e-2 against the
reference under ``strict_jit``, plus, per leaf, the reference's own
disagreement between its two compilations (``_torch_ref.
assert_grads_match``).  ``remat`` changes no bit.  The MoE FFN's
gradients with drops and the SSD's where its decay overflows are in
``test_torch_train_models.py``.
"""
import pytest

from _torch_ref import (assert_grads_match, assert_loss_matches,
                        assert_remat_changes_no_bit, loss_grad_runs)

CASES = {"moe-gather": ("granite-moe-3b-a800m", "gather"),
         "moe-scatter": ("granite-moe-3b-a800m", "scatter"),
         "ssm": ("mamba2-130m", None),
         "hybrid": ("recurrentgemma-9b", None)}
DTYPES = ("f32", "bf16")


@pytest.fixture(scope="module")
def runs():
    """(case, dtype) -> both packages' loss and gradients, each computed
    once for the module."""
    cache: dict = {}

    def get(case: str, dt: str) -> dict:
        if (case, dt) not in cache:
            arch, mode = CASES[case]
            cache[case, dt] = loss_grad_runs(arch, dt, mode)
        return cache[case, dt]
    return get


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_loss_matches_reference(runs, case, dt):
    assert_loss_matches(runs(case, dt), dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_grads_match_reference(runs, case, dt):
    assert_grads_match(runs(case, dt), dt)


@pytest.mark.parametrize("case", list(CASES))
def test_remat_changes_no_bit(runs, case):
    assert_remat_changes_no_bit(runs(case, "f32"))
