"""The port's RL session against the reference's in partial mode (pi_old
stitched across weight syncs), under the ``sorted`` and ``baseline``
policies: ``test_torch_session.py``'s check, at its size and
tolerances.
"""
import pytest

import torch_cpu  # noqa: F401
from test_torch_session import check_session


@pytest.mark.parametrize("policy", ["sorted", "baseline"])
@pytest.mark.parametrize("mode", ["partial"])
def test_tiny_session_matches_reference(mode, policy):
    check_session(mode, policy)
