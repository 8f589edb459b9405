"""The port's launch steps against the reference's for the
vision-language (Phi-3-Vision-4.2B, random ``patch_embeds``) and audio
(Whisper-small, random ``frames``) families at their smoke configs in
f32, on the CPU, with ``test_torch_launch_steps.py``'s helpers and
tolerances (the recurrent families: ``test_torch_launch_recurrent.py``).

* train: the vlm scores ``logits[:, prefill_extra:]`` behind its patch
  rows; Whisper trains only through this step in both packages (it has
  no RL path);
* prefill and serve: the vlm's ``kv_len`` counts its patch rows;
  Whisper's cache holds the cross K/V of the random frames.
"""
import pytest

import torch_cpu  # noqa: F401
from test_torch_launch_steps import run_prefill_and_serve, run_train

ARCHS = ["phi_3_vision_4_2b", "whisper_small"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference_over_3_steps(arch):
    run_train(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_serve_steps_match_reference(arch):
    run_prefill_and_serve(arch)
