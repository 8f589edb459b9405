"""The port's launch steps against the reference's for the left-padded
recurrent families (Zamba2-1.2B, xLSTM-125M) at their smoke configs in
f32, on the CPU, with ``test_torch_launch_steps.py``'s helpers and
tolerances: 3 train steps, the prefill step (prompts padded on the left,
so every row ends at the width) and two serve steps (``kv_len`` the
width, no ``kv_start``, as the reference's serve step passes none).
"""
import pytest

import torch_cpu  # noqa: F401
from test_torch_launch_steps import run_prefill_and_serve, run_train

ARCHS = ["zamba2_1_2b", "xlstm_125m"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference_over_3_steps(arch):
    run_train(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_serve_steps_match_reference(arch):
    run_prefill_and_serve(arch)
