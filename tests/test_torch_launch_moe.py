"""The port's launch steps against the reference's for the MoE family
(Granite-MoE-3B-A800M, Qwen3-MoE-235B-A22B) at their smoke configs in
f32, on the CPU, with ``test_torch_launch_steps.py``'s helpers and
tolerances.

The plan is ``tp`` with no FSDP, sequence parallelism or remat on the
reference's 1x1 mesh: its local ``dp`` plan fails for the MoE family
(``test_torch_launch_cli.py`` pins that).  On that mesh the reference's
expert-parallel layer (``moe_mlp_ep``) computes what the port's
``moe_mlp_dense`` does, so 3 train steps (and Granite's with 2
microbatches, the reference's ``lax.scan`` path), the prefill and the
serve steps agree within the dense family's tolerances.
"""
import pytest

import torch_cpu  # noqa: F401
from test_torch_launch_steps import run_prefill_and_serve, run_train

MOE_ARCHS = ["granite_moe_3b_a800m", "qwen3_moe_235b_a22b"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_step_matches_reference_over_3_steps(arch):
    run_train(arch)


def test_train_step_with_2_microbatches_matches_reference():
    run_train("granite_moe_3b_a800m", micro=2)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_serve_steps_match_reference(arch):
    run_prefill_and_serve(arch)
