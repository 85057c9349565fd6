"""The dry run's count of each family's gradient (the train step's
``value_and_grad``, every layer recomputed in the backward) against the
reference's ``hlo_cost`` of ``jax.grad`` of its jitted ``loss_fn`` on the
same reduced config.  Two families differ, each by a count pinned here
and explained under ROADMAP "Reference gaps"."""
import pytest

from tests.test_torch_dryrun import FAMILIES, port_dot_flops, ref_dot_flops

# port minus reference at (batch 1, 16 tokens); 0 where they are equal
GAPS = {
    # the backward of the MoE combine einsum toward the expert outputs
    # contracts a dimension of 1 (an outer product): torch runs it as a
    # bmm, XLA rewrites it into a broadcast multiply; 2 tokens x d_model
    # x top_k x 2 a token, a layer: 2 x 16 x 64 x 2 x 2 layers
    "moe": 2 * 16 * 64 * 2 * 2,
    # the reference's scan differentiates one body for every chunk, so it
    # also computes the cotangents of the last chunk's state update, which
    # nothing reads, and toward the zero initial state; the port's chunk
    # loop is unrolled eagerly and autograd skips both (2 layers)
    "ssm": -2 * 102_400,
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_grad_dot_flops_match_reference(family):
    arch = FAMILIES[family]
    got = port_dot_flops(arch, 1, 16, "grad")
    want = ref_dot_flops(arch, 1, 16, "grad")
    assert got - want == GAPS.get(family, 0), (got, want)
